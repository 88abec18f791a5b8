"""Parallel tempering of an LJ fluid, the replicas on every process's card.

The port of ``examples/parallel_tempering.py``: 8 replicas of a 256-particle
LJ fluid on a temperature ladder, propagated together by
``ParallelTemperingSampler`` on a Verlet neighbor list (one replica at a
time, the list's rebuild read on the host once a step); swaps exchange only
the R potential energies, on the host between iterations.  Then MBAR over
the ladder, with bootstrap error bars.

In one process the mesh is that process alone.  Under
``torchrun --nproc_per_node=k`` each process holds its block of replicas.
"""

import os
import sys

if __package__ in (None, ""):  # run as a script from a checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from chiron_tpu_torch import units
from chiron_tpu_torch.neighbors import NeighborListNsqrd, OrthogonalPeriodicSpace
from chiron_tpu_torch.parallel import (ParallelTemperingSampler, distributed,
                                       make_replica_mesh)
from chiron_tpu_torch.testsystems import LennardJonesFluid
from examples_torch._common import require_device, run_cli, timed


def build(device, n=256):
    """The sampler, initialized: 8 replicas (``8 // processes`` a process,
    at least one) at 120 K x 1.08^i."""
    distributed.initialize_cluster(device=device)
    mesh = make_replica_mesh(device=device)
    n_replicas = mesh.size * max(1, 8 // mesh.size)
    fluid = LennardJonesFluid(nparticles=n, reduced_density=0.4)
    nbr = NeighborListNsqrd(
        OrthogonalPeriodicSpace(), cutoff=fluid.cutoff,
        skin=0.3 * units.nanometer, n_max_neighbors=160)
    temps = [120.0 * 1.08 ** i for i in range(n_replicas)]
    pt = ParallelTemperingSampler(
        potential=fluid.potential,
        temperatures=[t * units.kelvin for t in temps],
        timestep=2.0 * units.femtoseconds, pairs=nbr, mesh=mesh)
    md = units.md_unit_system
    pt.initialize(fluid.positions.value_in_unit_system(md),
                  box_vectors=fluid.box_vectors.value_in_unit_system(md),
                  seed=1234)
    return pt, mesh


def main(device="cuda", n=256, warm_iterations=2, n_iterations=20,
         steps_per_iteration=200):
    dev = require_device(device)
    pt, mesh = build(dev, n)
    pt.run(n_iterations=warm_iterations, steps_per_iteration=steps_per_iteration)
    _, dt = timed(dev, lambda: pt.run(n_iterations=n_iterations,
                                      steps_per_iteration=steps_per_iteration))
    total_steps = n_iterations * steps_per_iteration
    rate = pt.n_replicas * total_steps / dt
    print(f"{pt.n_replicas} replicas on {mesh.size} process(es): "
          f"{total_steps} PT steps in {dt:.2f}s ({rate:.0f} replica-steps/sec)")
    print("swap acceptance:", pt.swap_acceptance_fraction)
    f_k = np.asarray(pt.compute_free_energies())
    print("ladder free energies (kT):", np.round(f_k, 3))
    # error bars via iteration resampling (valid under swap mixing)
    d_f_k = np.asarray(pt.estimator.bootstrap_d_f_k(n_bootstrap=20, seed=0))
    print("bootstrap d f_k (kT):   ", np.round(d_f_k, 3))
    return dict(n_replicas=pt.n_replicas, replica_steps_per_second=rate,
                swap_acceptance=pt.swap_acceptance_fraction, f_k=f_k,
                d_f_k=d_f_k, seconds=dt,
                headline=f"{rate:.1f} replica-steps/s, swap acceptance "
                         f"{pt.swap_acceptance_fraction:.3f}, f_k[-1] "
                         f"{f_k[-1]:.3f} kT")


def check(results):
    assert np.isfinite(results["f_k"]).all() and results["f_k"][0] == 0.0
    assert len(results["f_k"]) == results["n_replicas"]
    assert np.isfinite(results["d_f_k"]).all(), results["d_f_k"]
    assert 0.0 <= results["swap_acceptance"] <= 1.0


if __name__ == "__main__":
    run_cli(main, check, __doc__)
