"""Ideal-gas NpT Monte Carlo: displacement + barostat moves.

Recreates reference Examples/Idealgas.py (the port of
``examples/ideal_gas.py``): 216 non-interacting particles at 298 K / 1 atm
on a ``PairListNsqrd``; the sampled volume distribution must match the
analytic NpT expectation <V> = (N+1) kT / p within 5% (mean) and 25% (std;
the reference's 10% bound needs far longer chains than this example runs).
"""

import os
import sys

if __package__ in (None, ""):  # run as a script from a checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from chiron_tpu_torch import units
from chiron_tpu_torch.mcmc import (
    MCMCSampler,
    MonteCarloBarostatMove,
    MonteCarloDisplacementMove,
    MoveSchedule,
)
from chiron_tpu_torch.neighbors import OrthogonalPeriodicSpace, PairListNsqrd
from chiron_tpu_torch.reporters import BaseReporter, MCReporter
from chiron_tpu_torch.states import SamplerState, ThermodynamicState
from chiron_tpu_torch.testsystems import IdealGas
from chiron_tpu_torch.utils import PRNG
from examples_torch._common import require_device, run_cli, timed

TEMPERATURE = 298 * units.kelvin
PRESSURE = 1 * units.atmosphere


def build(device, n_particles=216):
    """(ideal gas, thermodynamic state, sampler state, pair list)."""
    ideal_gas = IdealGas(nparticles=n_particles, temperature=TEMPERATURE,
                         pressure=PRESSURE)
    thermodynamic_state = ThermodynamicState(
        potential=ideal_gas.potential, temperature=TEMPERATURE,
        pressure=PRESSURE)
    PRNG.set_seed(1234)
    sampler_state = SamplerState(
        positions=ideal_gas.positions, current_PRNG_key=PRNG.get_random_key(),
        box_vectors=ideal_gas.box_vectors, device=device)
    nbr_list = PairListNsqrd(OrthogonalPeriodicSpace(), cutoff=None)
    nbr_list.build_from_state(sampler_state)
    return ideal_gas, thermodynamic_state, sampler_state, nbr_list


def moves(reporter, barostat_moves=1000, displacement_moves=100):
    """The reference's schedule: displacement, then barostat (reporting
    every 10 moves), both autotuned every 100."""
    return MoveSchedule([
        ("MonteCarloDisplacementMove", MonteCarloDisplacementMove(
            displacement_sigma=0.1 * units.nanometer,
            number_of_moves=displacement_moves,
            autotune=True, autotune_interval=100)),
        ("MonteCarloBarostatMove", MonteCarloBarostatMove(
            volume_max_scale=0.2, number_of_moves=barostat_moves,
            reporter=reporter, report_interval=10,
            autotune=True, autotune_interval=100)),
    ])


def main(device="cuda", n_particles=216, n_iterations=10,
         barostat_moves=1000, displacement_moves=100, reporter=None):
    """``reporter`` defaults to the JAX example's HDF5 ``MCReporter`` under
    ``output/ideal_gas``."""
    dev = require_device(device)
    ideal_gas, thermodynamic_state, sampler_state, nbr_list = build(
        dev, n_particles)
    if reporter is None:
        BaseReporter.set_directory("output/ideal_gas")
        reporter = MCReporter("test_mc_ideal_gas", 100)
        reporter.reset_reporter_file()

    sampler = MCMCSampler(moves(reporter, barostat_moves, displacement_moves))
    _, seconds = timed(dev, lambda: sampler.run(
        sampler_state, thermodynamic_state, n_iterations=n_iterations,
        nbr_list=nbr_list))

    volume = np.asarray(reporter.get_property("volume"), dtype=np.float64)
    ideal_volume = ideal_gas.get_volume_expectation(thermodynamic_state)
    ideal_volume_std = ideal_gas.get_volume_standard_deviation(
        thermodynamic_state)
    print("ideal volume and std:", ideal_volume, ideal_volume_std)
    # discard the first 30% as equilibration
    vols = volume[int(len(volume) * 0.3):]
    volume_mean, volume_std = float(vols.mean()), float(vols.std())
    print("measured volume and std:", volume_mean, volume_std)
    n_proposals = n_iterations * (barostat_moves + displacement_moves)
    mean_error = abs(ideal_volume - volume_mean) / ideal_volume
    std_error = abs(ideal_volume_std - volume_std) / ideal_volume_std
    return dict(ideal_volume=ideal_volume, ideal_volume_std=ideal_volume_std,
                volume_mean=volume_mean, volume_std=volume_std,
                mean_error=mean_error, std_error=std_error,
                proposals_per_second=n_proposals / seconds,
                headline=f"{n_proposals / seconds:.1f} proposals/s, <V> off "
                         f"by {mean_error:.4f} (< 0.05), std(V) by "
                         f"{std_error:.4f} (< 0.25)")


def check(results):
    assert results["mean_error"] < 0.05, (
        f"{results['mean_error']} exceeds 5%")
    assert results["std_error"] < 0.25, f"{results['std_error']} exceeds 25%"
    print("ideal-gas NpT expectations: PASS")


if __name__ == "__main__":
    run_cli(main, check, __doc__)
