"""K1's chunk counters on the card (``csrc/lj_dense.cu``): on the lj4000
lattice displaced 0.5 nm an axis, 4 replicas in lattice order and in the
dense tempering chain's order, the chunks visited and tested under
``recording()`` equal ``scripts/dense_cull_work.py``'s replay exactly, and
K1's force and energy with the counter buffer set equal its output with
the pointer null, bit for bit.  The dense tempering chain's CUDA graph
replays its first call's kernels: the same outputs, launches and chunk
counts."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from chiron_tpu_torch import profiling
from chiron_tpu_torch.ops.lj_dense import LJDense, lj_dense_force_energy

pytestmark = pytest.mark.gpu

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _dense_cull_work():
    spec = importlib.util.spec_from_file_location(
        "dense_cull_work", ROOT / "scripts" / "dense_cull_work.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def state():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dw = _dense_cull_work()
    x3, box, n, cutoff = dw.lattice_state(0.5, 11, replicas=4)
    return dw, x3, box, n, cutoff


@pytest.mark.parametrize("order", ["lattice", "sorted"])
def test_k1_counts_the_replicas_chunks_and_keeps_its_bits(state, order):
    dw, x3, box, n, cutoff = state
    if order == "sorted":
        x3 = dw.sorted_lanes(x3, box, n, cutoff)
    dev = torch.device("cuda")
    op = LJDense(n, 0.34, 0.99579, cutoff, tm=512, tn=512, device=dev)
    assert op.n_pad == x3.shape[-1]
    x3r = torch.as_tensor(x3, device=dev)
    box_r = torch.as_tensor(box, device=dev).reshape(-1, 1, 3)
    Fa = op.force_only_r(x3r, box_r)
    Fe, Ee = op.force_energy_r(x3r, box_r)
    f1, e1 = lj_dense_force_energy(x3r[2], box_r[2].reshape(1, 3), n, 0.34,
                                   0.99579, cutoff)
    with profiling.recording():
        Fa_c = op.force_only_r(x3r, box_r)
    got = profiling.counters()
    with profiling.recording():
        Fe_c, Ee_c = op.force_energy_r(x3r, box_r)
        f1_c, e1_c = lj_dense_force_energy(
            x3r[2], box_r[2].reshape(1, 3), n, 0.34, 0.99579, cutoff)
    both = profiling.counters()
    assert torch.equal(Fa_c, Fa) and torch.equal(Fe_c, Fe)
    assert torch.equal(Ee_c, Ee)
    assert torch.equal(f1_c, f1) and torch.equal(e1_c, e1)
    want = dw.chunk_work(x3, box, n, cutoff)
    other = dw.chunk_work(x3, box, n, cutoff, contract=False)
    note = f"card {got}; replica {want}; replica without fma {other}"
    assert got["chiron.count.dense_chunks_visited"] == want["visited"], note
    assert got["chiron.count.dense_chunks_tested"] == want["tested"], note
    one = dw.chunk_work(x3[2], box[2], n, cutoff)
    assert both["chiron.count.dense_chunks_tested"] == (
        want["tested"] + one["tested"])
    assert both["chiron.count.dense_chunks_visited"] == (
        want["visited"] + one["visited"])
    if order == "lattice":
        assert want["share"] > 0.9
    else:
        assert want["share"] < 0.32
    assert np.isfinite(Ee.cpu().numpy()).all()


def test_dense_chain_replays_its_graph_bit_for_bit(state):
    """A shape's first call of the dense chain runs as it is, its second is
    captured into a CUDA graph and replayed, its third replays.  From the
    same inputs (two noise blocks of steps) the three give the same
    positions, velocities and energies bit for bit, count the same
    launches, leave their inputs as they were, and, inside one
    ``recording()`` session, add the same chunks to K1's counters."""
    from chiron_tpu_torch.ops import _build
    from chiron_tpu_torch.parallel.tempering import make_pt_dense_chain_fn

    _, x3, box, n, cutoff = state
    dev = torch.device("cuda")
    op = LJDense(n, 0.34, 0.99579, cutoff, tm=512, tn=512, device=dev)
    R, _, n_pad = x3.shape
    m_lane = torch.ones((1, n_pad), dtype=torch.float32, device=dev)
    m_lane[0, :n] = 39.948
    gen = torch.Generator().manual_seed(3)
    inputs = (torch.as_tensor(x3, device=dev),
              (0.3 * torch.randn(x3.shape, generator=gen)).to(dev),
              torch.as_tensor(box, device=dev).reshape(-1, 1, 3),
              torch.linspace(0.99, 1.12, R, device=dev))
    kept = [t.clone() for t in inputs]
    seeds = [12345 + 7 * r for r in range(R)]
    chain = make_pt_dense_chain_fn(op, m_lane, 0.002, 1.0)

    def call():
        x, v, box_r, kT = inputs
        before = _build.launches.copy()
        x1, v1, _, U, over = chain(x, v, seeds, box_r, None, kT, 100)
        torch.cuda.synchronize()
        return (x1, v1, U), dict(_build.launches - before), over

    runs = [call() for _ in range(3)]
    with profiling.recording():
        totals = []  # the session's counters after each call
        for _ in range(3):
            runs.append(call())
            totals.append(profiling.counters())
    counted = [{k: c1[k] - c0.get(k, 0) for k in c1}
               for c0, c1 in zip([{}] + totals, totals)]
    first, launches, _ = runs[0]
    assert launches["lj_dense_replicas"] == 102
    for outs, got, over in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs, first))
        assert got == launches and not over.any()
    assert counted[0] == counted[1] == counted[2]
    assert counted[0]["chiron.count.dense_chunks_visited"] > 0
    assert all(torch.equal(a, b) for a, b in zip(inputs, kept))
    assert not torch.equal(first[0], inputs[0])
    assert torch.isfinite(first[2]).all()
