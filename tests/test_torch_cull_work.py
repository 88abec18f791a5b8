"""``scripts/cull_work.py``, the CPU replica of the culled pair pass's work:
its float32 fma against exact rationals, its pairs within the cutoff
against the plain pass's mask, the order of its counts, a warp's LJ lanes,
and ``profiling``'s pair counters.  No JAX, no card."""

import importlib.util
import pathlib
from fractions import Fraction

import numpy as np
import pytest
import torch

import chiron_tpu_torch.profiling as prof
import chiron_tpu_torch.units as units
from chiron_tpu_torch.runtime import make_culled_lj_runner
from chiron_tpu_torch.testsystems import LennardJonesFluid

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _cull_work():
    spec = importlib.util.spec_from_file_location(
        "cull_work", ROOT / "scripts" / "cull_work.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cw = _cull_work()


def _exact_fma32(a, b, c):
    """The correctly rounded float32 fma, by exact rationals and a search
    over the float32 neighbours of the float64 estimate."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    est = np.float32(float(exact))
    cands = [np.nextafter(est, np.float32(-np.inf)), est,
             np.nextafter(est, np.float32(np.inf))]
    best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.float32(v).view(np.int32)) & 1))
    return np.float32(best)


@pytest.mark.parametrize("kind", ["random", "ties", "cancel"])
def test_fma32_is_correctly_rounded(kind):
    rng = np.random.default_rng(7)
    n = 2000
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    if kind == "random":
        c = rng.standard_normal(n).astype(np.float32)
    elif kind == "ties":
        # c + a b within 2^-47 of a float32 tie: float64 rounds the sum onto
        # the tie, and a second rounding would break it to even
        c = rng.integers(1 << 23, 1 << 24, n).astype(np.float32)
        a = np.full(n, 1.0 + 2.0 ** -23, dtype=np.float32)
        b = (np.where(rng.random(n) < 0.5, 1.0, -1.0)
             * (0.5 - 2.0 ** -24)).astype(np.float32)
    else:
        c = -(a.astype(np.float64) * b.astype(np.float64)).astype(np.float32)
    got = cw.fma32(a, b, c)
    want = np.array([_exact_fma32(*t) for t in zip(a, b, c)], np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _small_state(n=2000, tm=128, tn=256, seed=4):
    fluid = LennardJonesFluid(nparticles=n, reduced_density=0.8)
    md = units.md_unit_system
    box = fluid.box_vectors.value_in_unit_system(md)
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) * box[0, 0]).astype(np.float32)
    runner = make_culled_lj_runner(
        potential=fluid.potential, n_particles=n, topology=fluid.topology,
        temperature=120.0 * units.kelvin, slack=0.15, tm=tm, tn=tn,
        device="cpu")
    x3, box_diag, pairs, _, _ = runner._start(pos, box, 2)
    return runner.md, x3, box_diag, pairs


def _plain_within(md, x3, box_diag, pairs):
    """The plain pass's mask (``row_force_pass_plain``), counted."""
    count = int(pairs.count)
    tm, tn, n = md.tm, md.tn, md.n
    box = box_diag.reshape(3)
    inv_sigma = 1.0 / md.sigma
    rows, cols = pairs.rows[0, :count].long(), pairs.cols[0, :count].long()
    ptr2 = pairs.ptr2[0].long()
    general = (torch.arange(count) < ptr2[2 * rows + 1])[:, None, None]
    rid = rows[:, None] * tm + torch.arange(tm)
    cid = cols[:, None] * tn + torch.arange(tn)
    Lx, Ly, Lz = box
    rcx = pairs.rowcx[0][rows][:, None]
    xi = x3[0][rid]
    xi = (xi - Lx * torch.floor((xi - rcx) * (1.0 / Lx) + 0.5)) * inv_sigma
    xj = x3[0][cid]
    xj = (xj - Lx * torch.floor((xj - pairs.ccx[0, :count, None])
                                * (1.0 / Lx) + 0.5)) * inv_sigma
    d = [xi[:, :, None] - xj[:, None, :]]
    for a, L in ((1, Ly), (2, Lz)):
        Ls, k = L * inv_sigma, (2.0 * (1.0 / L)) * (1.0 / inv_sigma)
        dd = x3[a][rid][:, :, None] * inv_sigma - x3[a][cid][:, None, :] \
            * inv_sigma
        d.append(dd - Ls * torch.trunc(dd * k))
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    rank = (cid[:, None, :] > rid[:, :, None]) & (cid[:, None, :] < n)
    m = (r2 < (md.cutoff / md.sigma) ** 2) & (rank | ~general)
    return int(m.sum())


@pytest.mark.parametrize("tm,tn", [(128, 256), (64, 128), (256, 256)])
def test_replica_counts_the_plain_pass_pairs_and_orders_its_lanes(tm, tn):
    md, x3, box_diag, pairs = _small_state(tm=tm, tn=tn)
    w = cw.pair_work(x3, box_diag[0], pairs, md.n, tm, tn, md.sigma,
                     md.cutoff)
    assert w["entries"] == int(pairs.count) and w["listed"] == \
        w["entries"] * tm * tn
    # the box cull drops no pair within the cutoff; r^2 with one rounding
    # an op against the plain sum's may move a pair at the cutoff's edge
    assert abs(w["within"] - _plain_within(md, x3, box_diag, pairs)) <= 4
    assert 0 < w["within"] <= w["walk_lanes"] <= w["lanes"] <= w["tested"]
    assert w["tested"] <= w["listed"]
    assert w["lanes_share"] == w["lanes"] / w["tested"]


def test_a_warps_lanes():
    """32 RPT lanes a q step some lane passes in; the walk's rounds are the
    busiest lane's pairs."""
    rpt, nq, kcg = 4, 16, 4
    passed = np.zeros((2, 8, rpt, nq, kcg), dtype=bool)
    passed[1, 0, 0, 3, 1] = passed[1, 0, 2, 3, 1] = True  # one lane, q 3
    passed[1, 5, 1, 9, 0] = True                          # another, q 9
    lanes, walk = cw.warp_lanes(passed)
    assert lanes.tolist() == [0, 2 * 32 * rpt] and walk.tolist() == [0, 64]
    md, x3, box_diag, pairs = _small_state(n=500, tm=16, tn=64)
    w = cw.pair_work(x3, box_diag[0], pairs, md.n, 16, 64, md.sigma,
                     md.cutoff)
    assert w["within"] <= w["walk_lanes"] <= w["lanes"] <= w["tested"]


def test_the_replicas_constants_are_the_kernels():
    csrc = ROOT / "chiron_tpu_torch" / "csrc"
    text = (csrc / "lj_cull_force.cu").read_text()
    assert f"constexpr int kSlice = {cw.SLICE};" in text
    assert f"constexpr int kThreads = {cw.THREADS};" in text
    common = (csrc / "common.cuh").read_text()
    assert "constexpr float kRaise = 1.002f;" in common
    assert cw.RAISE == np.float32(1.002)


def test_cull_work_buffer_exists_only_while_recording():
    cpu = torch.device("cpu")
    assert prof.cull_work(cpu) is None
    with prof.recording():
        buf = prof.cull_work(cpu)
        assert buf.dtype == torch.int64 and buf.tolist() == [0, 0]
        assert prof.cull_work(cpu) is buf
        buf += torch.tensor([640, 64])
    assert prof.cull_work(cpu) is None
    assert prof.counters() == {"chiron.count.cull_pairs_tested": 640,
                               "chiron.count.cull_force_lanes": 64}
    # a new session starts its counters at zero
    with prof.recording():
        with prof.span("chiron.test.segment"):
            again = prof.cull_work(cpu)
            assert again is not buf and again.tolist() == [0, 0]
    assert prof.counters() == {"chiron.count.cull_pairs_tested": 0,
                               "chiron.count.cull_force_lanes": 0}
    with prof.recording():
        with prof.span("chiron.test.no_kernel"):
            pass
    assert prof.counters() == {}


def test_the_culled_wrappers_count_nothing_on_the_cpu():
    md, x3, box_diag, pairs = _small_state(n=500, tm=16, tn=64)
    from chiron_tpu_torch.ops import lj_cull as lc

    with prof.recording():
        lc.culled_force_pass(x3, box_diag, pairs, md.n, 16, 64, md.sigma,
                             md.epsilon, md.cutoff)
    assert prof.counters() == {}
