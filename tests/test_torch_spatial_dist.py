"""Particle-axis sharding at world size 2 against world size 1, on the CPU.

Two gloo ranks (``torch.multiprocessing.spawn``, a ``FileStore`` under the
test's temporary directory, so no network port) run
``make_sharded_lj_force`` and both spatial runners; each rank's results,
which are the global arrays, are held to one process's.  N=250 with tm 8
pads to 256 at both world sizes, so both draw the same noise.
"""

import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from chiron_tpu_torch import units
from chiron_tpu_torch.ops.lj_dense import box_diagonal
from chiron_tpu_torch.parallel import (distributed, make_replica_mesh,
                                       make_sharded_lj_force,
                                       make_spatial_band_lj_runner,
                                       make_spatial_lj_runner)
from chiron_tpu_torch.testsystems import LennardJonesFluid

N, TM, STEPS, SEGMENT = 250, 8, 10, 5


def _results(mesh) -> dict:
    """The sharded force and energy, and STEPS steps of both runners."""
    fluid = LennardJonesFluid(nparticles=N, reduced_density=0.4)
    md = units.md_unit_system
    pos = fluid.positions.value_in_unit_system(md)
    box = fluid.box_vectors.value_in_unit_system(md)
    pot = fluid.potential
    f = make_sharded_lj_force(mesh, N, pot.sigma, pot.epsilon, pot.cutoff,
                              axis_name="spatial", tm=TM)
    p = f.op.pad_positions(pos)
    bd = box_diagonal(box, "cpu")
    F, E = f.force_energy(p, bd)
    kw = dict(temperature=120.0 * units.kelvin,
              timestep=2.0 * units.femtoseconds, topology=fluid.topology,
              tm=TM)
    dense = make_spatial_lj_runner(mesh, pot, N, **kw)
    ds = dense.run(dense.init(pos, box, seed=42), STEPS)
    band = make_spatial_band_lj_runner(mesh, pot, N, segment_steps=SEGMENT,
                                       **kw)
    bs = band.run(band.init(pos, box, seed=3), STEPS)
    return dict(size=mesh.size, n_pad=f.n_pad, F=F, F_only=f(p, bd), E=E,
                dense_x=ds.x, dense_v=ds.v, band_x=bs.x, band_v=bs.v,
                band_w=band.w, band_over=bs.overflowed)


def _rank_main(rank, store_path, out_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, 2)
    assert distributed.initialize_cluster(num_processes=2, process_id=rank,
                                          store=store, device="cpu")
    try:
        mesh = make_replica_mesh(2, axis_name="spatial", device="cpu")
        assert (mesh.rank, mesh.size) == (rank, 2)
        torch.save(_results(mesh), f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("spatial_dist")
    ctx = mp.spawn(_rank_main, args=(str(d / "store"), str(d)), nprocs=2,
                   join=False)
    deadline = time.monotonic() + 120.0
    while not ctx.join(timeout=5.0):  # raises if a rank failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail("the two ranks did not finish within 120 s")
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(2)]
    one = _results(make_replica_mesh(axis_name="spatial", device="cpu"))
    return ranks, one


def _max_abs(a, b):
    return float((a - b).abs().max())


def test_sharded_force_world_size_2_matches_1(runs):
    ranks, one = runs
    assert [r["size"] for r in ranks] == [2, 2] and one["size"] == 1
    assert ranks[0]["n_pad"] == one["n_pad"] == 256
    scale = float(one["F"].abs().max())
    for r in ranks:
        assert r["F"].shape == (3, 256)
        assert _max_abs(r["F"], one["F"]) / scale < 1e-6
        assert torch.equal(r["F_only"], r["F"])
        assert abs(float(r["E"]) - float(one["E"])) / abs(float(one["E"])) < 1e-6
    # every rank holds the same global arrays
    assert torch.equal(ranks[0]["F"], ranks[1]["F"])
    assert torch.equal(ranks[0]["E"], ranks[1]["E"])


def test_spatial_runner_world_size_2_matches_1(runs):
    ranks, one = runs
    for r in ranks:
        assert _max_abs(r["dense_x"], one["dense_x"]) < 1e-6
        assert _max_abs(r["dense_v"], one["dense_v"]) < 1e-4
    assert torch.equal(ranks[0]["dense_x"], ranks[1]["dense_x"])
    assert torch.equal(ranks[0]["dense_v"], ranks[1]["dense_v"])


def test_spatial_band_runner_world_size_2_matches_1(runs):
    ranks, one = runs
    for r in ranks:
        assert r["band_w"] == one["band_w"]
        assert _max_abs(r["band_x"], one["band_x"]) < 1e-6
        assert _max_abs(r["band_v"], one["band_v"]) < 1e-4
        assert not bool(r["band_over"])
    assert torch.equal(ranks[0]["band_x"], ranks[1]["band_x"])


def test_initialize_cluster_is_a_no_op_in_one_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_cluster() is False
    assert not dist.is_initialized()
    assert make_replica_mesh(device="cpu").group is None
    with pytest.raises(ValueError, match="process_id"):
        distributed.initialize_cluster(num_processes=2, device="cpu")
    assert not dist.is_initialized()
