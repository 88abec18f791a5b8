"""Parallel tempering over 2 ranks against one process, on the CPU.

Two gloo ranks (``torch.multiprocessing.spawn``, a ``FileStore`` under the
test's temporary directory, so no network port) each propagate their block
of R=4 replicas, all-gather U and run the same swap sweep; one process runs
all four.  With the noise on, the dense chain (K1's plain version) and the
harmonic chain give the same positions, U history, ladder and swap counts
bit for bit, on both ranks: a replica's noise depends only on its own key.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from chiron_tpu_torch import units
from chiron_tpu_torch.parallel import (ParallelTemperingSampler, distributed,
                                       make_replica_mesh)
from chiron_tpu_torch.testsystems import HarmonicOscillator, LennardJonesFluid

ITERATIONS, STEPS = 2, 10


def _results(mesh) -> dict:
    md = units.md_unit_system
    fluid = LennardJonesFluid(nparticles=64, reduced_density=0.5)
    dense = ParallelTemperingSampler(
        fluid.potential, [t * units.kelvin for t in (120, 130, 140, 150)],
        mesh=mesh)
    dense.initialize(fluid.positions.value_in_unit_system(md),
                     box_vectors=fluid.box_vectors.value_in_unit_system(md),
                     seed=7)
    ho = HarmonicOscillator(
        k=100.0 * units.kilojoule_per_mole / units.nanometer ** 2)
    harm = ParallelTemperingSampler(
        ho.potential, [300.0 * 1.2 ** i * units.kelvin for i in range(4)],
        timestep=4.0 * units.femtoseconds,
        collision_rate=5.0 / units.picoseconds, mesh=mesh)
    harm.initialize(ho.positions, seed=11)
    out = {"size": mesh.size, "n_local": dense.n_local}
    for name, pt in (("dense", dense), ("harm", harm)):
        pt.run(ITERATIONS, STEPS, seed=3)
        out[name] = dict(
            x=pt.replica_positions(), u=np.stack(pt._u_history),
            kTs=np.asarray(pt.kTs), swaps=(pt.n_accepted_swaps,
                                           pt.n_proposed_swaps),
            keys=list(pt.keys))
    return out


def _rank_main(rank, store_path, out_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, 2)
    assert distributed.initialize_cluster(num_processes=2, process_id=rank,
                                          store=store, device="cpu")
    try:
        mesh = make_replica_mesh(2, device="cpu")
        torch.save(_results(mesh), f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tempering_dist")
    ctx = mp.spawn(_rank_main, args=(str(d / "store"), str(d)), nprocs=2,
                   join=False)
    deadline = time.monotonic() + 120.0
    while not ctx.join(timeout=5.0):  # raises if a rank failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail("the two ranks did not finish within 120 s")
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return ranks, _results(make_replica_mesh(device="cpu"))


@pytest.mark.parametrize("chain", ["dense", "harm"])
def test_two_ranks_equal_one_process_bit_for_bit(runs, chain):
    ranks, one = runs
    assert [r["size"] for r in ranks] == [2, 2] and one["size"] == 1
    assert [r["n_local"] for r in ranks] == [2, 2] and one["n_local"] == 4
    want = one[chain]
    assert want["u"].shape == (ITERATIONS, 4)
    for r in ranks:
        got = r[chain]
        assert np.array_equal(got["x"], want["x"])
        assert np.array_equal(got["u"], want["u"])
        assert np.array_equal(got["kTs"], want["kTs"])
        assert got["swaps"] == want["swaps"] and got["keys"] == want["keys"]
