"""LJ fluid sampled by a single Monte Carlo displacement move.

Recreates reference Examples/LJ_mcmove.py (the port of
``examples/lj_mcmove.py``): N=1100 LJ fluid at reduced density 0.1, one
``MonteCarloDisplacementMove`` with autotuning; the neighbor list is kept on
the device, its rebuild read on the host once a proposal.
"""

import math
import os
import sys

if __package__ in (None, ""):  # run as a script from a checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chiron_tpu_torch import units
from chiron_tpu_torch.mcmc import MonteCarloDisplacementMove
from chiron_tpu_torch.neighbors import NeighborListNsqrd, OrthogonalPeriodicSpace
from chiron_tpu_torch.reporters import BaseReporter, MCReporter
from chiron_tpu_torch.states import SamplerState, ThermodynamicState
from chiron_tpu_torch.testsystems import LennardJonesFluid
from chiron_tpu_torch.utils import PRNG
from examples_torch._common import require_device, run_cli, timed


def build(device, n=1100):
    """(fluid, sampler state, thermodynamic state, neighbor list)."""
    fluid = LennardJonesFluid(nparticles=n, reduced_density=0.1)
    PRNG.set_seed(1234)
    sampler_state = SamplerState(
        positions=fluid.positions, current_PRNG_key=PRNG.get_random_key(),
        box_vectors=fluid.box_vectors, device=device)
    thermodynamic_state = ThermodynamicState(
        potential=fluid.potential, temperature=300 * units.kelvin)
    nbr_list = NeighborListNsqrd(
        OrthogonalPeriodicSpace(), cutoff=fluid.cutoff,
        skin=0.5 * units.nanometer, n_max_neighbors=180)
    nbr_list.build_from_state(sampler_state)
    return fluid, sampler_state, thermodynamic_state, nbr_list


def displacement_move(reporter, number_of_moves=1000):
    """The reference's move: sigma 0.01 nm, autotuned every 100 proposals,
    a report every 50."""
    return MonteCarloDisplacementMove(
        displacement_sigma=0.01 * units.nanometer,
        number_of_moves=number_of_moves,
        reporter=reporter, report_interval=50,
        autotune=True, autotune_interval=100)


def main(device="cuda", n=1100, number_of_moves=1000, reporter=None):
    """``reporter`` defaults to the JAX example's HDF5 ``MCReporter`` under
    ``output/lj_mcmove``."""
    dev = require_device(device)
    fluid, sampler_state, thermodynamic_state, nbr_list = build(dev, n)
    if reporter is None:
        BaseReporter.set_directory("output/lj_mcmove")
        reporter = MCReporter("lj_mcmove", 10)
        reporter.reset_reporter_file()

    move = displacement_move(reporter, number_of_moves)
    (out_state, _, out_nbr), seconds = timed(dev, lambda: move.update(
        sampler_state, thermodynamic_state, nbr_list))
    acceptance = move.n_accepted / move.n_proposed
    sigma = move.displacement_sigma.value_in_unit_system(units.md_unit_system)
    print(f"acceptance: {move.n_accepted}/{move.n_proposed} "
          f"({acceptance:.2f})")
    print("autotuned sigma:", sigma, "nm")
    energy = float(fluid.potential.compute_energy(out_state.positions,
                                                  out_nbr))
    print("final energy:", energy, "kJ/mol")
    return dict(energy=energy, acceptance=acceptance, sigma=float(sigma),
                proposals_per_second=move.n_proposed / seconds,
                headline=f"{move.n_proposed / seconds:.1f} proposals/s, "
                         f"acceptance {acceptance:.3f}, sigma "
                         f"{float(sigma):.6f} nm")


def check(results):
    assert math.isfinite(results["energy"]), results["energy"]


if __name__ == "__main__":
    run_cli(main, check, __doc__)
