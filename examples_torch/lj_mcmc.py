"""LJ fluid NpT MCMC: displacement + barostat + Langevin move mix.

Recreates reference Examples/LJ_MCMC.py (the port of
``examples/lj_mcmc.py``): united-atom methane (TraPPE-UA, sigma=3.73 A,
eps/kB=148 K), N=1100 in the 4.275 nm box, T=140 K, p=13 atm, on
``DensePairs``: every proposal's energy and every Langevin step runs K1.
The sampled density must stay in the liquid range.
"""

import math
import os
import sys

if __package__ in (None, ""):  # run as a script from a checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from chiron_tpu_torch import units
from chiron_tpu_torch.mcmc import (
    LangevinDynamicsMove,
    MCMCSampler,
    MonteCarloBarostatMove,
    MonteCarloDisplacementMove,
    MoveSchedule,
)
from chiron_tpu_torch.neighbors import DensePairs, OrthogonalPeriodicSpace
from chiron_tpu_torch.potential import LJPotential
from chiron_tpu_torch.reporters import BaseReporter, MCReporter
from chiron_tpu_torch.states import SamplerState, ThermodynamicState
from chiron_tpu_torch.topology import Topology
from chiron_tpu_torch.utils import PRNG, get_data_file_path
from examples_torch._common import require_device, run_cli, timed

N = 1100
BOX_L = 4.275021399280942  # nm
MASS = 16.04               # amu


def build(device):
    """The reference state point: (potential, thermodynamic state, sampler
    state, pair scheme)."""
    # TraPPE-UA methane (reference Examples/LJ_MCMC.py:10-13)
    sigma = 0.373 * units.nanometer
    kB_K = 0.008314462618  # kJ/mol/K
    epsilon = units.Quantity(148.0 * kB_K, units.kilojoule_per_mole)
    cutoff = 1.4 * units.nanometer

    # the reference state point exactly: 1100 packed methanes in the
    # 4.275 nm cubic box (reference Examples/LJ_MCMC.py:29-42), packed by
    # pack_methane.py (the reference used packmol via mbuild)
    positions = units.Quantity(
        np.load(get_data_file_path("methane_1100_box4p275.npy")),
        units.nanometer)
    box_vectors = units.Quantity(np.diag(np.full(3, BOX_L)), units.nanometer)
    topology = Topology.from_masses(np.full(N, MASS))
    lj = LJPotential(topology, sigma=sigma, epsilon=epsilon, cutoff=cutoff)
    thermodynamic_state = ThermodynamicState(
        potential=lj, temperature=140.0 * units.kelvin,
        pressure=13.00765 * units.atmosphere)

    PRNG.set_seed(1234)
    sampler_state = SamplerState(
        positions=positions, current_PRNG_key=PRNG.get_random_key(),
        box_vectors=box_vectors, device=device)

    # DensePairs: K1 over all pairs -- no neighbor tables, no skin, no
    # capacity tuning; barostat box changes flow through the state
    nbr_list = DensePairs(OrthogonalPeriodicSpace(), cutoff=cutoff)
    nbr_list.build_from_state(sampler_state)
    return lj, thermodynamic_state, sampler_state, nbr_list


def moves(reporter, displacement_moves=100, barostat_moves=20,
          langevin_steps=200):
    """The reference's move schedule; the barostat reports every move."""
    return MoveSchedule([
        ("MonteCarloDisplacementMove", MonteCarloDisplacementMove(
            displacement_sigma=0.01 * units.nanometer,
            number_of_moves=displacement_moves,
            autotune=True, autotune_interval=100)),
        ("MonteCarloBarostatMove", MonteCarloBarostatMove(
            volume_max_scale=0.1, number_of_moves=barostat_moves,
            reporter=reporter, report_interval=1,
            autotune=True, autotune_interval=50)),
        ("LangevinDynamicsMove", LangevinDynamicsMove(
            timestep=1.0 * units.femtoseconds,
            number_of_steps=langevin_steps)),
    ])


def main(device="cuda", n_iterations=5, displacement_moves=100,
         barostat_moves=20, langevin_steps=200, reporter=None):
    """``reporter`` defaults to the JAX example's HDF5 ``MCReporter`` under
    ``output/lj_mcmc``; any object with its ``report``, ``flush_buffer``
    and ``get_property`` will do."""
    dev = require_device(device)
    lj, thermodynamic_state, sampler_state, nbr_list = build(dev)
    if reporter is None:
        BaseReporter.set_directory("output/lj_mcmc")
        reporter = MCReporter("lj_mcmc", 10)
        reporter.reset_reporter_file()
    sampler = MCMCSampler(moves(reporter, displacement_moves, barostat_moves,
                                langevin_steps))
    (final_state, _, final_nbr), seconds = timed(dev, lambda: sampler.run(
        sampler_state, thermodynamic_state, n_iterations=n_iterations,
        nbr_list=nbr_list))

    volume = np.asarray(reporter.get_property("volume"))
    print("sampled volumes (nm^3):", volume[-10:])
    energy = float(lj.compute_energy(final_state.positions, final_nbr))
    print("final energy:", energy, "kJ/mol")
    # liquid methane at 140 K / 13 atm is ~0.37 g/cm^3 (the packed start
    # is 0.375)
    V_mean = float(np.mean(volume[-10:]))
    rho = N * MASS / 6.02214076e23 / (V_mean * 1e-21)  # g/cm^3
    print(f"mean sampled density: {rho:.3f} g/cm^3")
    proposals = n_iterations * (displacement_moves + barostat_moves)
    return dict(energy=energy, density=rho, volumes=volume, seconds=seconds,
                proposals=proposals,
                langevin_steps=n_iterations * langevin_steps,
                headline=f"{proposals} proposals and "
                         f"{n_iterations * langevin_steps} Langevin steps in "
                         f"{seconds:.3f} s, density {rho:.4f} g/cm^3 "
                         f"(0.25-0.50), energy {energy:.3f} kJ/mol")


def check(results):
    assert math.isfinite(results["energy"]), results["energy"]
    # the short NpT chain must keep the sampled density in the liquid range
    assert 0.25 < results["density"] < 0.50, results["density"]


if __name__ == "__main__":
    run_cli(main, check, __doc__)
