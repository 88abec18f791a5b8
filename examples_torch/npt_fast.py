"""NpT at production speed: Langevin dynamics with the MC barostat on the card.

The reference's NpT workload (Examples/LJ_MCMC.py: methane TraPPE-UA,
140 K, 13 atm) drives one MC proposal at a time from the host; this program
(the port of ``examples/npt_fast.py``) samples the same ensemble -- at the
reference state point (1100 packed methanes, 4.275 nm box; see
``pack_methane.py``) -- with ``runtime.make_npt_lj_runner``: the dense
runner on K1, the right tool at N=1100 where the box is only about 3
cutoffs wide, a volume attempt every 25 steps whose energy comes from the
step's own K1 pass.  Two runs of 20,000 steps, the second timed.
"""

import math
import os
import sys

if __package__ in (None, ""):  # run as a script from a checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from chiron_tpu_torch import units
from chiron_tpu_torch.potential import LJPotential
from chiron_tpu_torch.runtime import make_npt_lj_runner
from chiron_tpu_torch.topology import Topology
from chiron_tpu_torch.utils import get_data_file_path
from examples_torch._common import require_device, run_cli, timed

N = 1100
BOX_L = 4.275021399280942  # nm
MASS = 16.04               # amu
SEED = 2024


def build(device):
    """The methane system, the runner and its initial state."""
    # methane TraPPE-UA parameters, as in the reference's LJ_MCMC example
    topology = Topology.uniform(N, mass=MASS, element="C")
    potential = LJPotential(
        topology, sigma=0.373 * units.nanometer,
        epsilon=0.2941 * units.kilocalories_per_mole,
        cutoff=1.4 * units.nanometer)
    positions = np.load(get_data_file_path("methane_1100_box4p275.npy"))
    box0 = np.eye(3, dtype=np.float32) * BOX_L
    runner = make_npt_lj_runner(
        potential, N, topology=topology,
        temperature=140.0 * units.kelvin,
        pressure=13.00765 * units.atmosphere,
        barostat_interval=25, device=device)
    return runner, runner.init(positions, box0, seed=SEED)


def main(device="cuda", n_steps=20_000):
    dev = require_device(device)
    runner, state = build(dev)
    state = runner.run(state, n_steps)
    state, dt = timed(dev, lambda: runner.run(state, n_steps))
    print(f"{n_steps} NpT steps in {dt:.2f} s -> {n_steps / dt:.0f} steps/s")
    V = float(runner.volume(state))
    rho = N * MASS / 6.02214076e23 / (V * 1e-21)  # g/cm^3
    energy = float(runner.energy(state))
    print(f"volume: {V:.1f} nm^3 (density {rho:.3f} g/cm^3)  "
          f"({int(state.n_proposed)} volume moves, "
          f"{runner.acceptance(state):.0%} accepted, "
          f"scale autotuned to {float(state.vmax_scale):.4f})")
    print(f"potential energy: {energy:.1f} kJ/mol")
    return dict(steps_per_second=n_steps / dt, volume=V, density=rho,
                energy=energy, n_proposed=int(state.n_proposed),
                acceptance=runner.acceptance(state),
                vmax_scale=float(state.vmax_scale), runner=runner,
                state=state,
                headline=f"{n_steps / dt:.1f} steps/s, density {rho:.4f} "
                         f"g/cm^3, {int(state.n_proposed)} volume moves "
                         f"({runner.acceptance(state):.3f} accepted)")


def check(results):
    for key in ("volume", "density", "energy"):
        assert math.isfinite(results[key]), (key, results[key])
    results["runner"].check(results["state"])  # a diverged state raises


if __name__ == "__main__":
    run_cli(main, check, __doc__)
