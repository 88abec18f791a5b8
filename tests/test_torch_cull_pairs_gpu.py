"""The culled pair pass on the card (``csrc/lj_cull_force.cu``) on
``chip_profile.cull_states``' shapes (the benchmark's N=4000 on the pure-x
key and ``lammps_lj32k`` on 19 slabs, both 128 x 256, and a dense N=700 box
at 16 x 64, a row a lane): K4 and K5 against the plain version, K5's force
equal to K4's bit for bit, a NaN coordinate's force lanes, the rank mask of
general entries against the all-pairs force, and the pair counters against
``scripts/cull_work.py``."""

import importlib.util
import pathlib

import pytest
import torch

from chiron_tpu_torch import profiling
from chiron_tpu_torch.ops import lj_cull as lc
from chiron_tpu_torch.ops.lj_dense import lj_dense_plain

pytestmark = pytest.mark.gpu

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def states():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return _module("chip_profile", "chip_profile.py").cull_states(
        torch.device("cuda"))


def _args(state):
    r, c, lj = state
    md = r.md
    return (c.x, c.box_diag, c.pairs, md.n, md.tm, md.tn, *lj)


def _p99(err, scale):
    flat = err.flatten()
    k = max(1, int(0.01 * flat.numel()))
    return float(torch.topk(flat, k).values[-1]) / scale


@pytest.mark.parametrize("shape", ["lj4000", "lj32k"])
def test_k4_and_k5_at_the_cells_shapes_match_plain(states, shape):
    """Force max abs 0.05 and p99 1e-5 relative, energy 1e-5, the padding
    lanes zero, the fast reciprocal within 1e-4 of the exact one; the list
    holds general and fast entries."""
    a = _args(states[shape])
    n, pairs = a[3], a[2]
    count = int(pairs.count)
    ptr2 = pairs.ptr2[0].long()
    rows = pairs.rows[0, :count].long()
    general = int((torch.arange(count, device=ptr2.device)
                   < ptr2[2 * rows + 1]).sum())
    assert 0 < general < count
    Fk, Ek = lc.culled_force_energy(*a)
    Fp, Ep = lc.row_force_pass_plain(*a, with_energy=True)
    err = (Fk - Fp)[:, :n].abs()
    scale = float(Fp.abs().max())
    assert float(err.max()) < 0.05
    assert _p99(err, scale) < 1e-5
    assert bool((Fk[:, n:] == 0).all())  # the padding lanes, if any
    assert abs(float(Ek) - float(Ep)) / abs(float(Ep)) < 1e-5
    del Fp, err
    Fa, _ = lc.culled_force_pass(*a, approx_recip=True)
    assert float((Fa - Fk).abs().max()) / scale < 1e-4


@pytest.mark.parametrize("shape", ["lj4000", "lj32k", "dense700"])
def test_k5_force_is_k4s_bit_for_bit(states, shape):
    a = _args(states[shape])
    F4, _ = lc.culled_force_pass(*a, approx_recip=False)
    F5, E5 = lc.culled_force_energy(*a)
    assert torch.equal(F4, F5)
    Fa, _ = lc.culled_force_pass(*a, approx_recip=True)
    Fm, Em = lc.culled_force_pass(*a, approx_recip=True, with_energy=True)
    assert torch.equal(Fm, Fa) and torch.equal(Em, E5)
    assert torch.equal(lc.culled_force_pass(*a, approx_recip=True)[0], Fa)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_a_nan_coordinate_reaches_the_plain_versions_force_lanes(states,
                                                                 axis):
    x, box, pairs, n, tm, tn, *lj = _args(states["lj4000"])
    x = x.clone()
    x[axis, n // 3] = float("nan")
    a = (x, box, pairs, n, tm, tn, *lj)
    Fp, _ = lc.row_force_pass_plain(*a)
    Fk, _ = lc.culled_force_pass(*a, approx_recip=False)
    assert bool(torch.isnan(Fp).any())
    assert torch.equal(torch.isnan(Fk), torch.isnan(Fp))
    live = ~torch.isnan(Fp)
    assert float((Fk[live] - Fp[live]).abs().max()) < 0.05


def test_general_entries_leave_out_the_pairs_at_col_le_row(states):
    """On the dense box every diagonal entry is general and holds pairs
    within the cutoff on both sides of its diagonal: the pass's force is
    the all-pairs force (each pair once), not twice it."""
    r, c, (sigma, epsilon, cutoff) = states["dense700"]
    md = r.md
    a = _args(states["dense700"])
    Fk, Ek = lc.culled_force_energy(*a)
    Fd, Ed = lj_dense_plain(c.x, c.box_diag, md.n, sigma, epsilon, cutoff)
    scale = float(Fd.abs().max())
    assert float((Fk - Fd)[:, :md.n].abs().max()) / scale < 1e-4
    assert abs(float(Ek) - float(Ed)) / abs(float(Ed)) < 1e-5


def _replica():
    return _module("cull_work", "scripts/cull_work.py")


@pytest.mark.parametrize("shape", ["lj4000", "lj32k", "dense700"])
def test_the_pair_counters_are_the_cpu_replicas(states, shape):
    """One K4 call under ``recording()`` counts the pairs tested and the LJ
    lanes that ``scripts/cull_work.py`` counts at the same state and list;
    off recording nothing is counted."""
    r, c, lj = states[shape]
    md = r.md
    a = _args(states[shape])
    with profiling.recording():
        lc.culled_force_pass(*a)
    got = profiling.counters()
    lc.culled_force_pass(*a)
    assert profiling.counters() == got
    cw = _replica()
    want = cw.pair_work(c.x, c.box_diag[0], c.pairs, md.n, md.tm, md.tn,
                        lj[0], lj[2])
    other = cw.pair_work(c.x, c.box_diag[0], c.pairs, md.n, md.tm, md.tn,
                         lj[0], lj[2], contract=False)
    note = (f"card {got}; replica {want}; replica without fma "
            f"{other['tested']}, {other['lanes']}")
    assert got["chiron.count.cull_pairs_tested"] == want["tested"], note
    assert got["chiron.count.cull_force_lanes"] == want["lanes"], note
    assert want["within"] <= want["walk_lanes"] <= want["lanes"]


def test_a_segment_counts_every_step(states):
    """K3's segment under ``recording()`` adds each of its S steps' passes:
    about S times one pass's tested pairs."""
    r, c, lj = states["lj4000"]
    md = r.md
    ws = lc.SegmentWorkspace(md, r.capacity)
    with profiling.recording():
        lc.culled_force_pass(*_args(states["lj4000"]))
    one = profiling.counters()["chiron.count.cull_pairs_tested"]
    with profiling.recording():
        md.run_segment(c.x, c.v, c.F, c.box_diag, c.pairs, 5, c.step, 8,
                       workspace=ws)
    seg = profiling.counters()["chiron.count.cull_pairs_tested"]
    assert 7 * one < seg < 9 * one
