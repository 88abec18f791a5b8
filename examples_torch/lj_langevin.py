"""LJ fluid Langevin MD with a Verlet neighbor list.

Recreates reference Examples/LJ_langevin.py (the port of
``examples/lj_langevin.py``: argon-like parameters, N=1000, reduced density
0.1, cutoff 3 sigma, skin 0.5 nm) through the general API:
``LangevinIntegrator`` on a ``NeighborListNsqrd``, the force the autograd
gradient of the energy, the list's rebuild read on the host once a step.
"""

import math
import os
import sys

if __package__ in (None, ""):  # run as a script from a checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from chiron_tpu_torch import units
from chiron_tpu_torch.integrators import LangevinIntegrator
from chiron_tpu_torch.neighbors import NeighborListNsqrd, OrthogonalPeriodicSpace
from chiron_tpu_torch.reporters import BaseReporter, LangevinDynamicsReporter
from chiron_tpu_torch.states import SamplerState, ThermodynamicState
from chiron_tpu_torch.testsystems import LennardJonesFluid
from chiron_tpu_torch.utils import PRNG
from examples_torch._common import require_device, run_cli, timed

REPORT_INTERVAL = 100


def build(device, n=1000):
    """(fluid, sampler state, thermodynamic state, neighbor list)."""
    lj_fluid = LennardJonesFluid(nparticles=n, reduced_density=0.1)
    PRNG.set_seed(1234)
    sampler_state = SamplerState(
        positions=lj_fluid.positions,
        current_PRNG_key=PRNG.get_random_key(),
        box_vectors=lj_fluid.box_vectors, device=device)
    thermodynamic_state = ThermodynamicState(
        potential=lj_fluid.potential, temperature=300 * units.kelvin)
    nbr_list = NeighborListNsqrd(
        OrthogonalPeriodicSpace(), cutoff=lj_fluid.cutoff,
        skin=0.5 * units.nanometer, n_max_neighbors=180)
    nbr_list.build_from_state(sampler_state)
    return lj_fluid, sampler_state, thermodynamic_state, nbr_list


def main(device="cuda", n=1000, n_steps=1000, reporter=None):
    """``reporter`` defaults to the JAX example's HDF5
    ``LangevinDynamicsReporter`` under ``output/lj_langevin``."""
    dev = require_device(device)
    lj_fluid, sampler_state, thermodynamic_state, nbr_list = build(dev, n)
    if reporter is None:
        BaseReporter.set_directory("output/lj_langevin")
        reporter = LangevinDynamicsReporter("test_lj", 1, lj_fluid.topology)
        reporter.reset_reporter_file()

    integrator = LangevinIntegrator(reporter=reporter,
                                    report_interval=REPORT_INTERVAL)
    init_energy = float(lj_fluid.potential.compute_energy(
        sampler_state.positions, nbr_list))
    print("init_energy:", init_energy)

    (state, _), dt = timed(dev, lambda: integrator.run(
        sampler_state, thermodynamic_state, number_of_steps=n_steps,
        nbr_list=nbr_list))

    reporter.flush_buffer()
    energies = np.asarray(reporter.get_property("potential_energy"),
                          dtype=np.float64).ravel()
    steps = np.asarray(reporter.get_property("step")).ravel()
    print("steps:", steps)
    print("energies:", energies)
    print(f"{n_steps} steps in {dt:.3f}s ({n_steps / dt:.0f} steps/sec)")
    return dict(init_energy=init_energy, energies=energies, steps=steps,
                n_steps=n_steps, steps_per_second=n_steps / dt,
                positions_finite=bool(state.positions.isfinite().all()),
                headline=f"{n_steps / dt:.1f} steps/s, {len(steps)} reports, "
                         f"last energy {energies[-1]:.4f} kJ/mol")


def check(results):
    assert math.isfinite(results["init_energy"]), results["init_energy"]
    assert np.isfinite(results["energies"]).all(), results["energies"]
    # a report after every step whose index is a multiple of the interval
    assert list(results["steps"]) == list(
        range(0, results["n_steps"], REPORT_INTERVAL)), results["steps"]
    assert results["positions_finite"]


if __name__ == "__main__":
    run_cli(main, check, __doc__)
