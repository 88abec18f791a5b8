"""The halo-strip engine (K7) and its runner on the CPU against the JAX
package in interpret mode: the jittered-lattice system of
tests/test_lj_strip.py (N=1000, L=5 nm, TM=8), and the strip runner on
LennardJonesFluid(1000, 0.3); and chip_smoke.py's replica of the CUDA
kernel's candidate ranks against the plain pass's slots."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chiron_tpu.ops.lj_band as jb
import chiron_tpu.ops.lj_strip as js_
import chiron_tpu.runtime as jrt
import chiron_tpu.testsystems as jts
import chiron_tpu.units as ju
import chiron_tpu_torch.ops.lj_band as tb
import chiron_tpu_torch.ops.lj_strip as ts_
import chiron_tpu_torch.runtime as trt
import chiron_tpu_torch.testsystems as tts
import chiron_tpu_torch.units as tu
from chiron_tpu_torch import interop

N = 1000
SIGMA, EPS, CUTOFF = 0.34, 0.99579, 1.02
L = 5.0
TM = 8
MD = dict(masses_lane=np.full(N, 39.9), dt=0.002, gamma=1.0,
          kT=0.008314 * 120, tm=TM, slack=0.2)


def _np(a):
    return np.array(a)


@pytest.fixture(scope="module")
def strip():
    """Both engines on one sorted state, each with its own halo."""
    rng = np.random.default_rng(7)
    n_side = int(np.ceil(N ** (1 / 3)))
    g = (np.arange(n_side) + 0.5) * L / n_side
    xyz = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)[:N]
    xyz = (xyz + rng.normal(0, 0.02, xyz.shape)).astype(np.float32) % L
    jmd = js_.StripLJMD(N, SIGMA, EPS, CUTOFF, **MD)
    tmd = ts_.StripLJMD(N, SIGMA, EPS, CUTOFF, **MD, device="cpu")
    pos3 = np.full((3, jmd.n_pad), np.float32(js_._PAD_X))
    pos3[:, :N] = xyz.T
    box = np.full(3, L, np.float32)
    jx3s, _ = js_.sort_by_key_strip(jnp.asarray(pos3), ())
    tx3s, _ = ts_.sort_by_key_strip(torch.from_numpy(pos3), ())
    valid = np.arange(jmd.n_pad) < N
    W = int(jb.band_width_needed(
        jnp.where(valid, jx3s[0], jnp.float32(3.0e38)), N, CUTOFF + 0.2, L))
    Wt = int(tb.band_width_needed(
        torch.where(torch.from_numpy(valid), tx3s[0], 3.0e38), N,
        CUTOFF + 0.2, L))
    jmd.set_halo(W + TM)
    tmd.set_halo(Wt + TM)
    jbox, tbox = jnp.asarray(box), torch.from_numpy(box)
    return dict(jmd=jmd, tmd=tmd, jx3s=jx3s, tx3s=tx3s, W=W, Wt=Wt,
                jxe=jmd.extend(jx3s, jbox), txe=tmd.extend(tx3s, tbox),
                jbox=jbox, tbox=tbox)


def test_sort_halo_and_extension_equal_jax(strip):
    s = strip
    jmd, tmd = s["jmd"], s["tmd"]
    assert tmd.n_pad == jmd.n_pad == 1024 and tmd.tm == TM
    np.testing.assert_array_equal(s["tx3s"].numpy(), _np(s["jx3s"]))
    assert s["Wt"] == s["W"] and tmd.H == jmd.H
    np.testing.assert_array_equal(s["txe"].numpy(), _np(s["jxe"]))
    np.testing.assert_array_equal(tmd.minv.numpy(), _np(jmd.minv))
    np.testing.assert_array_equal(tmd.sigv.numpy(), _np(jmd.sigv))
    assert (tmd.a, tmd.b) == (float(jmd.a), float(jmd.b))
    # payload rows follow the permutation
    pay = torch.arange(tmd.n_pad, dtype=torch.float32)
    jpay = jnp.arange(jmd.n_pad, dtype=jnp.float32)
    _, (tp,) = ts_.sort_by_key_strip(s["tx3s"].flip(1).contiguous(), (pay,))
    _, (jp,) = js_.sort_by_key_strip(jnp.flip(s["jx3s"], 1), (jpay,))
    np.testing.assert_array_equal(tp.numpy(), _np(jp))


@pytest.mark.parametrize("tm,rounded", [(8, None), (128, 1920)])
def test_set_halo_rounding_and_guard(tm, rounded):
    """H rounds to tm, and the strip to whole 2048-wide sub-blocks once it
    is wider (as in JAX); the wrap guard raises."""
    n = 20000
    kw = dict(MD, masses_lane=np.full(n, 39.9), tm=tm)
    jmd = js_.StripLJMD(n, SIGMA, EPS, CUTOFF, **kw, interpret=True)
    tmd = ts_.StripLJMD(n, SIGMA, EPS, CUTOFF, **kw, device="cpu")
    for H in (1, 100, 1500, 1921, 2100):
        jmd.set_halo(H)
        tmd.set_halo(H)
        assert tmd.H == jmd.H
    if rounded:
        tmd.set_halo(1800)
        assert tmd.H == rounded
    with pytest.raises(ValueError, match="double-counted"):
        tmd.set_halo(tmd.n_pad)


def test_strip_force_and_energy_match_jax(strip):
    s = strip
    Fj, Ej = s["jmd"].force_energy(s["jxe"], s["jbox"], approx_recip=False)
    Ft, Et = s["tmd"].force_energy(s["txe"], s["tbox"])
    Fj = _np(Fj)
    err = np.abs(Ft.numpy() - Fj)
    assert err.max() < 0.05
    assert np.percentile(err[:, :N], 99.0) / np.abs(Fj).max() < 1e-5
    assert np.abs(Ft[:, N:].numpy()).max() == 0.0
    assert abs(float(Et) - float(Ej)) / abs(float(Ej)) < 1e-5
    assert torch.equal(s["tmd"].force(s["txe"], s["tbox"]), Ft)


def test_strip_energy_masks_padding_against_padding(strip):
    """Padding slots hold the sentinel on every axis, so padding against
    padding has r^2 == 0 exactly: the energy masks it before the clamp,
    which would otherwise add (1e4^6 - 1e4^3) a slot."""
    s = strip
    E = s["tmd"].force_energy(s["txe"], s["tbox"])[1]
    assert s["tmd"].n_pad - N > 1 and np.isfinite(float(E))
    assert abs(float(E)) < 1e6


def test_strip_grad_of_energy_is_minus_force(strip):
    s = strip
    tmd = s["tmd"]
    F, _ = tmd.force_energy(s["txe"], s["tbox"])
    p = s["tx3s"].clone().requires_grad_(True)
    tmd.energy_differentiable(p, s["tbox"]).backward()
    assert torch.equal(p.grad, -F)


def _jax_counters(seed, step, n_pad):
    """lj_strip.py:215-237 in numpy uint32."""
    with np.errstate(over="ignore"):
        lane = (np.arange(3, dtype=np.uint32)[:, None] * np.uint32(n_pad)
                + np.arange(n_pad, dtype=np.uint32)[None, :])
        base = (np.uint32(seed) * np.uint32(0x9E3779B9)
                + np.uint32(step) * np.uint32(0x85EBCA6B))
        c1 = (lane * np.uint32(2)) * np.uint32(0x9E3779B9) + base
        c2 = (lane * np.uint32(2) + np.uint32(1)) * np.uint32(0x9E3779B9) + base
    return c1, c2


def _jax_noise(seed, step, n_pad):
    c1, c2 = (jnp.asarray(c) for c in _jax_counters(seed, step, n_pad))

    def mix(z):
        z = z ^ (z >> 16)
        z = z * jnp.uint32(0x85EBCA6B)
        z = z ^ (z >> 13)
        z = z * jnp.uint32(0xC2B2AE35)
        return z ^ (z >> 16)

    u1 = (mix(c1) >> 8).astype(jnp.int32).astype(jnp.float32) / 16777216.0
    u2 = (mix(c2) >> 8).astype(jnp.int32).astype(jnp.float32) / 16777216.0
    u1 = jnp.maximum(u1, 1e-7)
    return jnp.sqrt(-2.0 * jnp.log(u1)) * jnp.cos(2.0 * jnp.pi * u2)


@pytest.mark.parametrize("seed,step", [(11, 0), (11, 1), (0xDEADBEEF, 70001)])
def test_strip_noise_stream_matches_jax(seed, step):
    n_pad = 1024
    c1, c2 = ts_.strip_counters(seed, step, n_pad)
    j1, j2 = _jax_counters(seed, step, n_pad)
    np.testing.assert_array_equal(c1.numpy(), j1.astype(np.int64))
    np.testing.assert_array_equal(c2.numpy(), j2.astype(np.int64))
    noise = ts_.strip_noise_plain(seed, step, n_pad)
    assert np.abs(noise.numpy() - _np(_jax_noise(seed, step, n_pad))).max() < 1e-6


def test_two_step_segment_matches_jax(strip):
    s = strip
    jmd, tmd = s["jmd"], s["tmd"]
    F0 = jmd.force(s["jxe"], s["jbox"], approx_recip=False)
    v0 = jnp.zeros((3, jmd.n_pad), jnp.float32)
    jxe1, jv1, jF1 = jmd.run_segment(s["jxe"], v0, F0, s["jbox"], seed=11,
                                     step_offset=0, n_steps=2,
                                     approx_recip=False)
    txe1, tv1, tF1 = tmd.run_segment(
        s["txe"], torch.from_numpy(_np(v0)), torch.from_numpy(_np(F0)),
        s["tbox"], seed=11, step_offset=0, n_steps=2, approx_recip=False)
    assert np.abs(txe1.numpy() - _np(jxe1))[:, :N].max() < 1e-5
    assert np.abs(tv1.numpy() - _np(jv1))[:, :N].max() < 1e-4
    assert np.abs(tF1.numpy() - _np(jF1))[:, :N].max() < 0.05
    # the halo is the shifted center, after the segment as before it
    H, n_pad = tmd.H, tmd.n_pad
    assert float((txe1[0, n_pad:] - (txe1[0, :H] + L)).abs().max()) < 1e-4
    assert torch.equal(txe1[1:, n_pad:], txe1[1:, :H])
    # the padding stays at the sentinel, unwrapped
    assert float(txe1[:, N:n_pad].min()) > 1e17


def test_baoab_phase_plain_is_one_jax_step(strip):
    """One BAOAB phase of the plain version against the jnp oracle of
    tests/test_lj_strip.py:84 (before its force)."""
    s = strip
    tmd = s["tmd"]
    rng = np.random.default_rng(2)
    w = rng.normal(0, 0.5, (3, tmd.n_pad)).astype(np.float32)
    F = rng.normal(0, 50, (3, tmd.n_pad)).astype(np.float32)
    xe, w1 = ts_.strip_baoab_plain(
        s["txe"], torch.from_numpy(w), torch.from_numpy(F), tmd.minv,
        tmd.sigv, s["tbox"], 5, 9, N, tmd.H, tmd.dt, tmd.a, tmd.b)
    v = w + tmd.dt * F * _np(tmd.minv)
    x = _np(s["tx3s"]) + 0.5 * tmd.dt * v
    v = tmd.a * v + tmd.b * _np(tmd.sigv) * _np(_jax_noise(5, 9, tmd.n_pad))
    x = x + 0.5 * tmd.dt * v
    live = np.arange(tmd.n_pad) < N
    x = np.where(live, x - np.floor(x / L) * L, x)
    assert np.abs(xe[:, :tmd.n_pad].numpy() - x)[:, :N].max() < 1e-5
    assert np.abs(w1.numpy() - v).max() < 1e-4


# ---------------------------------------------------------------------------
# The strip runner
# ---------------------------------------------------------------------------

RUN = dict(tm=TM, segment_steps=4)


def _runner(rt, ts, units, **kw):
    fluid = ts.LennardJonesFluid(nparticles=N, reduced_density=0.3)
    md = units.md_unit_system
    r = rt.make_strip_lj_runner(
        potential=fluid.potential, n_particles=N, topology=fluid.topology,
        temperature=120.0 * units.kelvin, **RUN, **kw)
    return r, fluid.positions.value_in_unit_system(md), \
        fluid.box_vectors.value_in_unit_system(md)


@pytest.fixture(scope="module")
def runners():
    jr, jpos, jbox = _runner(jrt, jts, ju)
    js0 = jr.init(jpos, jbox, seed=3)
    js0 = jr.run(js0, 8)
    js1 = jr.run(js0, 4)
    tr, tpos, tbox = _runner(trt, tts, tu, device="cpu")
    ts0 = tr.init(tpos, tbox, seed=3)
    return jr, js0, js1, tr, ts0


def _strip_carry(js):
    return interop.strip_carry(_np(js.x), _np(js.v), _np(js.F), _np(js.step),
                               _np(js.box_diag), _np(js.overflowed), "cpu")


def test_strip_runner_init_matches_jax(runners):
    jr, _, _, tr, ts0 = runners
    assert tr.md.H == jr.md.H and tr.md.n_pad == jr.md.n_pad
    jpos, jbox = _runner(jrt, jts, ju)[1:]
    js = jr.init(jpos, jbox, seed=3)
    np.testing.assert_array_equal(ts0.x.numpy(), _np(js.x))
    assert np.abs(ts0.F.numpy() - _np(js.F)).max() < 0.05
    assert int(ts0.step[0, 0]) == 0 and not bool(ts0.overflowed)


def test_one_strip_segment_from_a_jax_carry(runners):
    jr, js0, js1, tr, _ = runners
    t1 = tr.segment(_strip_carry(js0), 4)
    assert int(t1.step[0, 0]) == int(js1.step[0, 0]) == 12
    assert np.abs(t1.x.numpy() - _np(js1.x))[:, :N].max() < 1e-5
    assert np.abs(t1.v.numpy() - _np(js1.v))[:, :N].max() < 1e-4
    assert bool(t1.overflowed) == bool(js1.overflowed) is False
    tr.check(t1)
    e_ref = float(jr.energy(js1))
    assert abs(float(tr.energy(t1)) - e_ref) / abs(e_ref) < 1e-5
    # run is whole segments of segment_steps
    t2 = tr.run(_strip_carry(js0), 4)
    for name in ("x", "v", "F", "step", "overflowed"):
        assert torch.equal(getattr(t1, name), getattr(t2, name)), name


def test_strip_latch_matches_the_jax_expression(runners):
    """The segment's latch is the drift kernel's: the top-2 joint drift
    from the sort (JAX's ``_top2_drift``) against the slack, or a live
    coordinate not finite."""
    jr, js0, _, tr, _ = runners
    from chiron_tpu_torch.ops.lj_cull import tile_skin_drift_bad

    x = _np(js0.x)[:, :tr.md.n_pad]
    rng = np.random.default_rng(5)
    box = _np(js0.box_diag).reshape(3, 1)
    valid = np.arange(tr.md.n_pad) < N
    for amp in (0.05, 0.1, 0.2):
        moved = x + rng.normal(0, amp, x.shape).astype(np.float32)
        d = moved - x
        d = d - box * np.round(d / box)
        ref = bool(jrt._top2_drift(jnp.asarray(d), jnp.asarray(valid))
                   > tr.md.slack)
        got = bool(tile_skin_drift_bad(torch.from_numpy(moved),
                                       torch.from_numpy(x), N, tr.md.slack_t,
                                       torch.from_numpy(box.reshape(1, 3))))
        assert got == ref, amp


def test_strip_runner_check_raises_on_latched_carries(runners):
    jr, js0, _, tr, ts0 = runners
    tr.check(ts0)
    bad = dataclasses.replace(ts0, overflowed=torch.ones((), dtype=torch.bool))
    with pytest.raises(RuntimeError, match="strip runner invariant"):
        tr.check(bad)
    # a NaN in a live y coordinate latches at the segment's end, and one in
    # x (the sort key, which the sort may move out of the live lanes) too
    for axis in (1, 0):
        ts = _strip_carry(js0)
        ts.x[axis, 5] = float("nan")
        out = tr.segment(ts, 4)
        assert bool(out.overflowed), axis
        with pytest.raises(RuntimeError, match="strip runner invariant"):
            tr.check(out)
    # mixed masses are refused
    fluid = tts.LennardJonesFluid(nparticles=N, reduced_density=0.3)
    fluid.topology.add_atom("x", "C")
    with pytest.raises(ValueError, match="identical masses"):
        trt.make_strip_lj_runner(potential=fluid.potential,
                                 n_particles=N + 1, topology=fluid.topology,
                                 device="cpu")


# ---------------------------------------------------------------------------
# K7's candidate sets (csrc/lj_strip.cu): each particle meets every pair it
# is in from its own side
# ---------------------------------------------------------------------------


def _chip_smoke():
    """chip_smoke.py (the repo root's script) as a module: its replicas of
    the kernels' index math."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _slot(q, j, n_pad):
    """The (row, extended column) slot of the strip pass that lane q's rank
    j stands for in K7: ahead (j > q) the slot (q, j); behind, (j, q), and
    below rank 0 the row n_pad + j against q's halo copy n_pad + q."""
    ahead, wrapped = j > q, j < 0
    row = torch.where(ahead, q, torch.where(wrapped, j + n_pad, j))
    col = torch.where(ahead, j, torch.where(wrapped, q + n_pad, q))
    return row, col


def _halos(s, tm):
    """(H covering the band the cutoff needs on the fixture's state, the
    padding gap included, rounded up to tm; and 64 ranks narrower, which
    misses pairs of this state)."""
    tmd = s["tmd"]
    valid = torch.arange(tmd.n_pad) < N
    W = int(tb.band_width_needed(torch.where(valid, s["tx3s"][0], 3.0e38), N,
                                 CUTOFF, L))
    full = -(-(W + tmd.n_pad - N) // tm) * tm
    return full, full - 64


def _extend(x3s, H):
    halo = x3s[:, :H].clone()
    halo[0] = halo[0] + L
    return torch.cat([x3s, halo], dim=1)


@pytest.mark.parametrize("tm", [16, 32])
@pytest.mark.parametrize("narrow", [False, True])
def test_kernel_candidates_take_each_plain_pair_from_both_ends(strip, tm,
                                                               narrow):
    """The replica of K7's chunks and rank tests gives, over all particles,
    every slot of ``strip_force_plain``'s pass (row tile against its
    extended columns, the leading triangle out, the halo folded) exactly
    twice: once from the row's end and once from the column's, and nothing
    else; with the halo covering the band and narrower."""
    cs = _chip_smoke()
    n_pad = strip["tmd"].n_pad
    H = _halos(strip, tm)[int(narrow)]
    n_ext = n_pad + H
    q, j, take = cs._strip_candidates(n_pad, tm, H)
    q, j = q[take], j[take]
    row, col = _slot(q, j, n_pad)
    rid, cid, tri = ts_.strip_slots(n_pad, tm, H)
    want = (rid[:, :, None] * n_ext + cid[:, None, :])[:, ~tri]
    want = torch.sort(want.reshape(-1)).values
    got = row * n_ext + col
    keys, counts = torch.unique(got, return_counts=True)
    assert torch.equal(keys, want) and bool((counts == 2).all())
    at_row, at_col = q == row, q == col % n_pad
    assert bool((at_row ^ at_col).all())
    for end in (at_row, at_col):
        assert torch.equal(torch.sort(got[end]).values, want)
    # the wrapped ranks stand for rows below n_pad against halo columns
    assert bool((col[j < 0] >= n_pad).all()) and bool((row < n_pad).all())


@pytest.mark.parametrize("tm", [16, 32])
@pytest.mark.parametrize("narrow", [False, True])
def test_kernel_candidate_sums_equal_the_plain_pass(strip, tm, narrow):
    """Each particle's sum over the replica's candidates, the lane's point
    (its halo copy below rank 0) minus the column, a term where r^2 is below
    the cutoff, equals ``strip_force_plain`` (f64, 1e-9 of the largest
    force), and half the energy sum its energy.  With the halo narrower
    than the band the strip misses pairs: the plain force moves, and the
    sums miss the same pairs."""
    cs = _chip_smoke()
    n_pad = strip["tmd"].n_pad
    full, H = _halos(strip, tm)
    if not narrow:
        H = full
    xe = _extend(strip["tx3s"], H).double()
    box = torch.full((1, 3), L, dtype=torch.float64)
    q, j, take = cs._strip_candidates(n_pad, tm, H)
    q, j = q[take], j[take]
    point = xe[:, torch.where(j < 0, q + n_pad, q)]
    d = point - xe[:, torch.where(j < 0, j + n_pad, j)]
    d[1:] = d[1:] - L * torch.floor(d[1:] / L + 0.5)
    r2 = (d * d).sum(0)
    hit = r2 < CUTOFF * CUTOFF
    sigma2 = SIGMA * SIGMA
    inv = 1.0 / torch.clamp_min(r2, 1e-4 * sigma2)
    i6 = (sigma2 * inv) ** 3
    coef = torch.where(hit, (2.0 * i6 * i6 - i6) * inv, 0.0)
    F = torch.zeros((3, n_pad), dtype=torch.float64)
    F.index_add_(1, q, coef * d)
    F = 24.0 * EPS * F
    E = 0.5 * 4.0 * EPS * torch.where(hit & (r2 > 0), i6 * i6 - i6, 0.0).sum()
    Fp, Ep = ts_.strip_force_plain(xe, box, N, tm, H, SIGMA, EPS, CUTOFF,
                                   with_energy=True)
    scale = float(Fp.abs().max())
    assert float((F - Fp).abs().max()) / scale < 1e-9
    assert abs(float(E) - float(Ep)) / abs(float(Ep)) < 1e-9
    if narrow:
        Ff, _ = ts_.strip_force_plain(_extend(strip["tx3s"], full).double(),
                                      box, N, tm, full, SIGMA, EPS, CUTOFF)
        assert float((Fp - Ff).abs().max()) / scale > 1e-3


def test_strip_visit_replica_matches_a_direct_count(strip):
    """chip_smoke.py's replica of K7's choices against a loop over blocks
    and chunks as the kernel takes them: the chunks skipped by x, and in the
    others the LJ loop's trips and terms."""
    cs = _chip_smoke()
    tm = 32
    n_pad = strip["tmd"].n_pad
    H = _halos(strip, tm)[0]
    xe = _extend(strip["tx3s"], H)
    chunks, skipped, trips, terms = cs._strip_visits(
        xe, torch.full((1, 3), L), tm, H, CUTOFF)
    xs = xe.numpy().astype(np.float32)
    c2 = np.float32(CUTOFF * CUTOFF)
    want = [0, 0, 0, 0]
    for b in range(n_pad // 32):
        q = np.arange(32 * b, 32 * b + 32)
        ts = q - q % tm
        lo, hi = ts - H, ts + tm + H
        base = lo[0] - lo[0] % 32
        for c0 in range(base, hi[-1], 32):
            want[0] += 1
            j = np.arange(c0, c0 + 32)
            cols = xs[:, np.where(j < 0, j + n_pad, j)]
            pts = xs[:, q].copy()
            if c0 < 0:
                pts[0] = np.where(q < H, xs[0, np.minimum(q + n_pad,
                                                          n_pad + H - 1)],
                                  pts[0])
            up = np.float32(pts[0].max() - cols[0].min())
            down = np.float32(pts[0].min() - cols[0].max())
            if (up < 0 and up * up >= c2) or (down > 0 and down * down >= c2):
                want[1] += 1
                continue
            d = pts[:, :, None] - cols[:, None, :]
            d[1:] = d[1:] - L * np.floor(d[1:] / np.float32(L) + 0.5)
            r2 = (d * d).sum(0)
            ok = ((j[None, :] >= lo[:, None]) & (j[None, :] < hi[:, None])
                  & (j[None, :] != q[:, None]))
            hit = ~(r2 >= c2) & ok
            want[2] += int(hit.sum(1).max())
            want[3] += int(hit.sum())
    assert (chunks, skipped, trips, terms) == tuple(want)
    assert 0 < skipped < chunks and terms > 0
