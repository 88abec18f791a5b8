"""Large-N LJ fluid with the particle axis sharded across processes.

The single-replica scaling story (the port of ``examples/spatial_large_n.py``):
at particle counts where one card's pair stage no longer fits the step
budget, ``make_spatial_lj_runner`` shards contiguous row slabs of the
particle axis across the mesh -- each rank integrates its own slab, takes
its slab's force on K8a (K1's kernel on a slab of rows), and the only
traffic is one all-gather of positions a step.

In one process the mesh is that process alone and no collective runs.  On
several GPUs of one host, start one process a GPU:

    torchrun --nproc_per_node=4 examples_torch/spatial_large_n.py
"""

import math
import os
import sys

if __package__ in (None, ""):  # run as a script from a checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chiron_tpu_torch import units
from chiron_tpu_torch.parallel import (distributed, make_replica_mesh,
                                       make_spatial_lj_runner)
from chiron_tpu_torch.testsystems import LennardJonesFluid
from examples_torch._common import require_device, run_cli, timed


def build(device, n=4096, tm=256):
    """(mesh, runner, initial state)."""
    # under torchrun: one NCCL (gloo on the CPU) process a device, from
    # RANK, WORLD_SIZE and LOCAL_RANK; alone: nothing to do
    distributed.initialize_cluster(device=device)
    mesh = make_replica_mesh(axis_name="spatial", device=device)
    fluid = LennardJonesFluid(nparticles=n, reduced_density=0.8)
    md = units.md_unit_system
    runner = make_spatial_lj_runner(
        mesh, fluid.potential, n,
        temperature=120.0 * units.kelvin,
        timestep=2.0 * units.femtoseconds,
        topology=fluid.topology, tm=tm)
    state = runner.init(fluid.positions.value_in_unit_system(md),
                        fluid.box_vectors.value_in_unit_system(md),
                        seed=2024)
    return mesh, runner, state


def main(device="cuda", n=4096, n_steps=200, tm=256):
    """``n`` scales up on real hardware; ``tm`` is the row tile (at least 128
    on the card)."""
    dev = require_device(device)
    mesh, runner, state = build(dev, n, tm)
    print(f"{mesh.size} rank(s): rows sharded {runner.n_pad} / {mesh.size} "
          f"= {runner.rows_per_dev} per rank (rank {mesh.rank} holds rows "
          f"{runner.off}..{runner.off + runner.rows_per_dev - 1})")
    initial_energy = float(runner.energy(state))

    state = runner.run(state, n_steps)
    state, dt = timed(dev, lambda: runner.run(state, n_steps))
    print(f"{n_steps} steps in {dt:.3f} s -> {n_steps / dt:.1f} steps/s")
    energy = float(runner.energy(state))
    print("potential energy:", energy, "kJ/mol")
    return dict(n=n, world_size=mesh.size, rank=mesh.rank,
                rows_per_rank=runner.rows_per_dev, initial_energy=initial_energy,
                energy=energy, steps_per_second=n_steps / dt,
                positions=runner.positions(state).cpu(), runner=runner,
                state=state,
                headline=f"{n_steps / dt:.1f} steps/s, {mesh.size} rank(s) "
                         f"of {runner.rows_per_dev} rows, energy "
                         f"{energy:.3f} kJ/mol")


def check(results):
    assert math.isfinite(results["energy"]), results["energy"]
    assert results["rows_per_rank"] * results["world_size"] >= results["n"]


if __name__ == "__main__":
    run_cli(main, check, __doc__)
