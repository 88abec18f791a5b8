"""Flagship throughput workload: LJ fluid N=4000 on the culled runner.

The ``bench.py`` configuration as a user-facing program (the port of
``examples/fast_langevin.py``): the dense runner (K1) melts the lattice,
exact at every step; then the culled tile-pair runner -- spatial sort,
tile-level Verlet list, S BAOAB steps from one C call (K3), its drift latch
-- runs production, timed over 5 windows of 2000 steps with
``profiling.Throughput``.  ``check`` holds the latch clean (``runner.check``).
"""

import math
import os
import sys

if __package__ in (None, ""):  # run as a script from a checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chiron_tpu_torch import units
from chiron_tpu_torch.profiling import Throughput
from chiron_tpu_torch.runtime import make_culled_lj_runner, make_fast_lj_runner
from chiron_tpu_torch.testsystems import LennardJonesFluid
from examples_torch._common import require_device, run_cli

TEMPERATURE = 120.0 * units.kelvin
TIMESTEP = 2.0 * units.femtoseconds
SEED = 1234


def build(device, n=4000):
    """(fluid, box, the dense runner, its initial state)."""
    md = units.md_unit_system
    fluid = LennardJonesFluid(nparticles=n, reduced_density=0.8)
    box = fluid.box_vectors.value_in_unit_system(md)
    fast = make_fast_lj_runner(
        potential=fluid.potential, n_particles=n, topology=fluid.topology,
        temperature=TEMPERATURE, timestep=TIMESTEP, device=device)
    fs = fast.init(fluid.positions.value_in_unit_system(md), box, seed=SEED)
    return fluid, box, fast, fs


def main(device="cuda", n=4000, melt_steps=2000, settle_steps=2000,
         windows=5, window_steps=2000):
    dev = require_device(device)
    # equilibrate the lattice melt with the dense runner
    fluid, box, fast, fs = build(dev, n)
    fs = fast.run(fs, melt_steps)

    # production: the culled tile-pair runner
    runner = make_culled_lj_runner(
        potential=fluid.potential, n_particles=n, topology=fluid.topology,
        temperature=TEMPERATURE, timestep=TIMESTEP, device=dev)
    state = runner.init(fast.positions(fs), box, seed=SEED)
    state = runner.run(state, settle_steps)
    energy = float(runner.energy(state))
    print("equilibrated; energy:", energy, "kJ/mol")

    tp = Throughput()
    for _ in range(windows):
        with tp.measure(n_steps=window_steps, sync=True):
            state = runner.run(state, window_steps)
    print(tp.report())
    print(f"throughput: {tp.steps_per_second:.0f} steps/s "
          f"({tp.steps_per_minute / 1e6:.2f}M steps/min)")
    final_energy = float(runner.energy(state))
    return dict(n=n, energy=energy, final_energy=final_energy,
                steps_per_second=tp.steps_per_second, windows=tp.sections,
                runner=runner, state=state,
                headline=f"{tp.steps_per_second:.1f} steps/s over "
                         f"{len(tp.sections)} Throughput windows, energy "
                         f"{final_energy:.3f} kJ/mol")


def check(results):
    assert math.isfinite(results["energy"]), results["energy"]
    assert math.isfinite(results["final_energy"]), results["final_energy"]
    results["runner"].check(results["state"])  # tile-skin invariants held


if __name__ == "__main__":
    run_cli(main, check, __doc__)
