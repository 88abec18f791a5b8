"""The halo-strip engine (K7) and its runner on the CPU against the JAX
package in interpret mode: the jittered-lattice system of
tests/test_lj_strip.py (N=1000, L=5 nm, TM=8), and the strip runner on
LennardJonesFluid(1000, 0.3)."""

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
