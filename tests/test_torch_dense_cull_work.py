"""``scripts/dense_cull_work.py``, the CPU replica of K1's column-chunk
cull: its constants against the kernel's, the chunks it culls holding no
pair within the cutoff, the shares in lattice order and in the dense
tempering chain's order on a displaced lattice, and ``profiling``'s chunk
counters.  No JAX, no card."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import chiron_tpu_torch.profiling as prof
from chiron_tpu_torch.ops.lj_dense import LJDense

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _dense_cull_work():
    spec = importlib.util.spec_from_file_location(
        "dense_cull_work", ROOT / "scripts" / "dense_cull_work.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


dw = _dense_cull_work()


def test_the_replicas_constants_are_the_kernels():
    text = (ROOT / "chiron_tpu_torch" / "csrc" / "lj_dense.cu").read_text()
    assert f"constexpr int kRows = {dw.CHUNK};" in text
    assert f"constexpr int kChunk = {dw.CHUNK};" in text
    common = (ROOT / "chiron_tpu_torch" / "csrc" / "common.cuh").read_text()
    assert "constexpr float kRaise = 1.002f;" in common
    assert dw.RAISE == np.float32(1.002)


@pytest.mark.parametrize("order", ["given", "sorted"])
def test_a_culled_chunk_holds_no_pair_within_the_cutoff(order):
    """Uniform positions (n 1000 of 1024 lanes) in a 3.2 nm box: every pair
    of lanes within the cutoff, in float64, lies in a tested chunk of its
    row's block, and the sorted order culls some chunks."""
    rng = np.random.default_rng(2)
    L, cutoff, n, n_pad = 3.2, 0.8, 1000, 1024
    x3 = (rng.random((3, n_pad)) * L).astype(np.float32)
    box = np.full(3, L, np.float32)
    if order == "sorted":
        x3 = dw.sorted_lanes(x3[None], box[None], n, cutoff)[0]
    near = dw.tested_chunks(x3, box, cutoff)
    d = x3[:, :, None].astype(np.float64) - x3[:, None, :]
    d -= L * np.round(d / L)
    within = np.sqrt((d * d).sum(0)) < cutoff
    blocks = np.arange(n_pad) // dw.CHUNK
    assert near[blocks[:, None], blocks[None, :]][within].all()
    if order == "sorted":
        assert near.mean() < 0.9
    assert dw.chunk_work(x3, box, n, cutoff)["tested"] == int(near.sum())


def test_the_sorted_lanes_test_a_third_of_the_chunks_where_lattice_order_tests_all():
    """The lj4000 lattice displaced 0.84 nm an axis: in lattice order K1
    tests over 0.9 of its chunks, in the dense chain's order under 0.32."""
    x3, box, n, cutoff = dw.lattice_state(0.84, 3)
    given = dw.chunk_work(x3, box, n, cutoff)
    ordered = dw.chunk_work(dw.sorted_lanes(x3, box, n, cutoff), box, n,
                            cutoff)
    assert given["visited"] == ordered["visited"] == 128 * 128
    assert given["share"] > 0.9
    assert ordered["share"] < 0.32


def test_dense_work_buffer_exists_only_while_recording():
    cpu = torch.device("cpu")
    assert prof.dense_work(cpu) is None
    with prof.recording():
        buf = prof.dense_work(cpu)
        assert buf.dtype == torch.int64 and buf.tolist() == [0, 0]
        assert prof.dense_work(cpu) is buf
        assert prof.cull_work(cpu) is not buf
        buf += torch.tensor([1024, 300])
    assert prof.dense_work(cpu) is None
    # both buffers of the session, each under its own names
    assert prof.counters() == {"chiron.count.dense_chunks_visited": 1024,
                               "chiron.count.dense_chunks_tested": 300,
                               "chiron.count.cull_pairs_tested": 0,
                               "chiron.count.cull_force_lanes": 0}


def test_k1_counts_nothing_on_the_cpu():
    op = LJDense(100, 0.34, 1.0, 1.0, tm=128, tn=128, device="cpu")
    x3r = torch.rand(2, 3, op.n_pad) * 3.0
    box = torch.full((2, 1, 3), 3.0)
    with prof.recording():
        op.force_only_r(x3r, box)
        op.force_energy_r(x3r, box)
    assert prof.counters() == {}
