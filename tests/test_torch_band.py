"""The band engine (K6) and its runner on the CPU against the JAX package in
interpret mode: random fluids N=1500 and 2000 with tm=64 (as
tests/test_band.py), and the band runner on LennardJonesFluid(1500, 0.3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chiron_tpu.ops.lj_band as jb
import chiron_tpu.runtime as jrt
import chiron_tpu.testsystems as jts
import chiron_tpu.units as ju
import chiron_tpu_torch.ops.lj_band as tb
import chiron_tpu_torch.runtime as trt
import chiron_tpu_torch.testsystems as tts
import chiron_tpu_torch.units as tu
from chiron_tpu.ops.lj_dense import LJDensePallas
from chiron_tpu_torch import interop

SIGMA, EPS, CUTOFF = 0.34, 0.99579, 1.02
TM = 64


def _np(a):
    return np.array(a)


def _fluid(n, rho, seed=0):
    L = (n * SIGMA ** 3 / rho) ** (1 / 3)
    rng = np.random.default_rng(seed)
    return rng.uniform(0, L, (n, 3)).astype(np.float32), L


def _sorted_pair(n, rho, seed=0):
    """The same fluid, padded and sorted by both packages, and both bands
    calibrated on it."""
    x, L = _fluid(n, rho, seed)
    jband = jb.LJBandPallas(n, SIGMA, EPS, CUTOFF, margin=0.15, tm=TM)
    dense = LJDensePallas(n, SIGMA, EPS, CUTOFF, tm=TM, tn=128, triangle=False)
    jpos3 = dense.pad_positions(jnp.asarray(x))
    jpos3s, _ = jb.sort_by_x(jpos3, (), n)
    jband.calibrate(jpos3s, L)
    tband = tb.LJBand(n, SIGMA, EPS, CUTOFF, margin=0.15, tm=TM, device="cpu")
    tpos3 = torch.from_numpy(_np(jpos3))
    tpos3s, _ = tb.sort_by_x(tpos3, (), n)
    tband.calibrate(tpos3s, L)
    box = np.full((1, 3), L, np.float32)
    return jband, jpos3s, tband, tpos3s, box


def test_sort_width_and_calibration_equal_jax():
    n = 1500
    jband, jpos3s, tband, tpos3s, box = _sorted_pair(n, 0.3)
    assert tband.n_pad == jband.n_pad == 1536 and tband.tm == TM
    np.testing.assert_array_equal(tpos3s.numpy(), _np(jpos3s))
    assert tband.w == jband.w
    # the width with the padding keyed 3e38, as the runner asks for it
    live = np.arange(tband.n_pad) < n
    xs = np.where(live, _np(jpos3s)[0], np.float32(3.0e38))
    for reach in (tband.reach, 0.5, 2.0):
        w_t = tb.band_width_needed(torch.from_numpy(xs), n, reach, box[0, 0])
        w_j = jb.band_width_needed(jnp.asarray(xs), n, reach, box[0, 0])
        assert w_t.dtype == torch.int32 and int(w_t) == int(w_j)
    # payloads follow the permutation; ties keep their order (stable)
    rng = np.random.default_rng(4)
    pos = np.zeros((3, 16), np.float32)
    pos[:, :10] = rng.integers(0, 4, (3, 10)).astype(np.float32)
    payload = np.arange(16, dtype=np.float32)
    js, (jp,) = jb.sort_by_x(jnp.asarray(pos), (jnp.asarray(payload),), 10)
    ts, (tp,) = tb.sort_by_x(torch.from_numpy(pos),
                             (torch.from_numpy(payload),), 10)
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    np.testing.assert_array_equal(tp.numpy(), _np(jp))


def test_band_width_needed_ring():
    xs = torch.arange(8, dtype=torch.float32)
    assert int(tb.band_width_needed(xs, 8, 2.1, 8.0)) == 3


@pytest.mark.parametrize("n,rho", [(2000, 0.8), (1500, 0.3)])
def test_band_force_and_energy_match_jax(n, rho):
    jband, jpos3s, tband, tpos3s, box = _sorted_pair(n, rho)
    jbox = jnp.asarray(box)
    tbox = torch.from_numpy(box)
    Fj, Ej = jband.force_energy(jpos3s, jbox, approx_recip=False)
    Ft, Et = tband.force_energy(tpos3s, tbox)
    Fj = _np(Fj)
    err = np.abs(Ft.numpy() - Fj)
    scale = np.abs(Fj).max()
    # random points overlap, so forces reach ~1e17: the error is relative
    # (the runner test below holds a fluid's force to 0.05 absolute)
    assert err.max() / scale < 1e-5
    assert np.percentile(err[:, :n], 99.0) / scale < 1e-5
    assert np.abs(Ft[:, n:].numpy()).max() == 0.0
    assert abs(float(Et) - float(Ej)) / abs(float(Ej)) < 1e-5
    # the force-only call is the same function
    F_only = tband.force(tpos3s, tbox)
    assert torch.equal(F_only, Ft)


def test_band_guards():
    with pytest.raises(ValueError, match="double-count"):
        tb.LJBand(100, SIGMA, EPS, CUTOFF, tm=TM, w=49, device="cpu")
    band = tb.LJBand(1500, SIGMA, EPS, CUTOFF, tm=TM, device="cpu")
    with pytest.raises(RuntimeError, match="calibrate"):
        band.force(torch.zeros(3, band.n_pad), torch.ones(1, 3))
    # a box a few cutoffs wide: the band would span half the ranks
    x, L = _fluid(400, 0.8)
    small = tb.LJBand(400, SIGMA, EPS, CUTOFF, tm=TM, device="cpu")
    pos3 = torch.zeros(3, small.n_pad)
    pos3[:, :400] = torch.from_numpy(x).T
    with pytest.raises(ValueError, match="inapplicable"):
        small.calibrate(tb.sort_by_x(pos3, (), 400)[0], L)
    # on the card the tile is at least 128, as on the TPU
    assert tb.LJBand(1500, SIGMA, EPS, CUTOFF, tm=TM, device="cuda").tm == 128


def test_band_grad_of_energy_is_minus_force():
    n = 1500
    _, _, tband, tpos3s, box = _sorted_pair(n, 0.4)
    tbox = torch.from_numpy(box)
    F, _ = tband.force_energy(tpos3s, tbox)
    p = tpos3s.clone().requires_grad_(True)
    tband.energy_differentiable(p, tbox).backward()
    assert torch.equal(p.grad, -F)


# ---------------------------------------------------------------------------
# The band runner
# ---------------------------------------------------------------------------

N_RUN = 1500


def _runner_setup(rt, ts, units, **kw):
    fluid = ts.LennardJonesFluid(nparticles=N_RUN, reduced_density=0.3)
    md = units.md_unit_system
    r = rt.make_band_lj_runner(
        fluid.potential, n_particles=N_RUN, topology=fluid.topology,
        temperature=120 * units.kelvin, timestep=2.0 * units.femtoseconds,
        tm=TM, **kw)
    return r, fluid.positions.value_in_unit_system(md), \
        fluid.box_vectors.value_in_unit_system(md)


@pytest.fixture(scope="module")
def band_runners():
    jr, jpos, jbox = _runner_setup(jrt, jts, ju)
    js = jr.run(jr.init(jpos, jbox, seed=3), 20)  # off the lattice
    tr, tpos, tbox = _runner_setup(trt, tts, tu, device="cpu")
    ts0 = tr.init(tpos, tbox, seed=3)
    return jr, js, tr, ts0


def test_band_runner_init_matches_jax(band_runners):
    jr, _, tr, ts0 = band_runners
    assert tr.band.w == jr.band.w and tr.n_pad == jr.band.n_pad
    assert tr.dense.n_pad == jr.dense.n_pad
    js0 = jr.init(*_runner_setup(jrt, jts, ju)[1:], seed=3)
    np.testing.assert_array_equal(ts0.x.numpy(), _np(js0.x))
    np.testing.assert_array_equal(ts0.ref_x.numpy(), _np(js0.ref_x))
    # the lattice puts pairs at the cutoff: one flip moves a force by ~0.033
    assert np.abs(ts0.F.numpy() - _np(js0.F)).max() < 0.05
    assert ts0.v.shape == (3, tr.n_pad) and float(ts0.v[:, N_RUN:].abs().max()) > 0


def _band_carry(js):
    return interop.band_carry(_np(js.x), _np(js.v), _np(js.F), _np(js.ref_x),
                              _np(js.box_diag), _np(js.overflowed), "cpu")


def test_five_band_steps_with_jax_noise_across_a_resort(band_runners):
    """Five steps from one state with JAX's threefry noise injected; an
    offset anchor forces the re-sort on the first step."""
    jr, js, tr, _ = band_runners
    margin = jr.band.margin
    js = dataclasses.replace(js, ref_x=js.ref_x.at[7].add(-2.0 * margin))
    ts = _band_carry(js)
    key = js.key
    for _ in range(5):
        key, sub = jax.random.split(key)
        noise = jax.random.normal(sub, js.x.shape, dtype=js.x.dtype)
        ts = tr.step(ts, torch.from_numpy(_np(noise)))
    js5 = jr.run(js, 5)
    # the re-sort happened, in both, with the same permutation (the
    # velocities below would differ by far more than 1e-4 otherwise)
    assert not np.array_equal(_np(js5.ref_x), _np(js.ref_x))
    assert np.abs(ts.ref_x.numpy() - _np(js5.ref_x)).max() < 1e-5
    assert np.abs(ts.x.numpy() - _np(js5.x)).max() < 1e-5
    assert np.abs(ts.v.numpy() - _np(js5.v)).max() < 1e-4
    assert bool(ts.overflowed) == bool(js5.overflowed) is False
    tr.check(ts)
    e_ref = float(jr.energy(js5))
    assert abs(float(tr.energy(ts)) - e_ref) / abs(e_ref) < 1e-5
    e_band = float(tr.band.force_energy(ts.x, ts.box_diag)[1])
    assert abs(e_band - e_ref) / abs(e_ref) < 1e-5


def test_band_step_without_drift_keeps_order(band_runners):
    """Without a stale lane the order and anchor stay as they were."""
    jr, js, tr, _ = band_runners
    ts = _band_carry(js)
    noise = torch.zeros_like(ts.x)
    t1 = tr.step(ts, noise)
    assert torch.equal(t1.ref_x, ts.ref_x)
    assert not bool(t1.overflowed)


def test_band_runner_check_raises_on_a_latched_carry(band_runners):
    _, js, tr, ts0 = band_runners
    tr.check(ts0)
    bad = dataclasses.replace(ts0, overflowed=torch.ones((), dtype=torch.bool))
    with pytest.raises(RuntimeError, match="band runner invariant"):
        tr.check(bad)
    # an overflow at a re-sort latches: a band too narrow for the data
    ts = _band_carry(dataclasses.replace(
        js, ref_x=js.ref_x.at[0].add(-2.0 * tr.band.margin)))
    w = tr.band.w
    try:
        tr.band.w = 8
        out = tr.step(ts, torch.zeros_like(ts.x))
    finally:
        tr.band.w = w
    assert bool(out.overflowed)


def test_band_runner_latches_a_nan_the_jax_runner_does_not(band_runners):
    """A NaN x coordinate at lane 7 after 5 steps, then 5 more steps: the
    port latches it before the sort and ``check()`` raises; the JAX runner,
    as the reference stands (chiron_tpu/runtime.py:283-306), lets the NaN
    spread through the live lanes with ``overflowed`` clear and its
    ``check()`` passing."""
    jr, _, tr, ts0 = band_runners
    ts = tr.run(ts0, 5)
    ts.x[0, 7] = float("nan")
    ts = tr.run(ts, 5)
    assert bool(ts.overflowed)
    with pytest.raises(RuntimeError, match="band runner invariant"):
        tr.check(ts)
    js = jr.run(jr.init(*_runner_setup(jrt, jts, ju)[1:], seed=3), 5)
    js = dataclasses.replace(js, x=js.x.at[0, 7].set(jnp.nan))
    js = jr.run(js, 5)
    assert not bool(js.overflowed)
    assert not np.isfinite(_np(js.x)[:, :N_RUN]).all()
    jr.check(js)


def test_band_runner_run_draws_from_the_generator(band_runners):
    _, _, tr, ts0 = band_runners
    a = tr.run(ts0, 3)
    assert a.x.shape == ts0.x.shape and torch.isfinite(a.x).all()
    assert tr.positions(a).shape == (N_RUN, 3)
    assert tr.velocities(a).shape == (N_RUN, 3)
    # the mass guard
    fluid = tts.LennardJonesFluid(nparticles=N_RUN, reduced_density=0.3)
    fluid.topology.add_atom("x", "C")
    with pytest.raises(ValueError, match="identical masses"):
        trt.make_band_lj_runner(fluid.potential, n_particles=N_RUN + 1,
                                topology=fluid.topology, device="cpu")


def _chip_smoke():
    """chip_smoke.py (the repo root's script) as a module: its replicas of
    the kernels' choices are held here to direct counts."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _wrapped_sorted(n, n_pad, rho=0.3, seed=0):
    x, L = _fluid(n, rho, seed)
    pos3 = torch.zeros((3, n_pad))
    pos3[:, :n] = torch.from_numpy(x.T)
    return tb.sort_by_x(pos3, (), n)[0], L


def test_band_force_takes_skip_and_runs_plain_on_cpu():
    """``skip`` only steers the kernel: on a CPU tensor both settings run
    the plain version."""
    n, w = 600, 200
    pos3s, L = _wrapped_sorted(n, 640)
    box = torch.full((3,), L)
    args = (pos3s, box, n, w, SIGMA, EPS, CUTOFF, TM)
    plain = tb.band_force_plain(*args)[0]
    assert torch.equal(tb.band_force(*args, skip=False), plain)
    assert torch.equal(tb.band_force(*args), plain)
    assert torch.equal(tb.band_force_energy(*args, skip=False)[0], plain)


def test_band_vote_replica_matches_a_direct_count():
    """chip_smoke.py's replica of K6's choices against a loop over visits,
    warps and slots as the kernel takes them: the visits skipped by x, the
    interior ones, and the warp steps (rows 32 v + 16 h + u, h = 0, 1,
    against columns 16 j .. 16 j + 15) that fire in the visits taken."""
    cs = _chip_smoke()
    n, n_pad, tm, w = 600, 640, 64, 200
    x, L = _wrapped_sorted(n, n_pad)
    box = torch.full((1, 3), L)
    kinds, fired, steps, out = cs._band_votes(x, box, n, CUTOFF, w, tm)

    xs = x.numpy().astype(np.float32)
    n_tiles, rpt = n_pad // tm, tm // 16
    nbt = tb.n_band_tiles(w, tm, n_tiles)
    c2, half = CUTOFF * CUTOFF, 0.5 * L
    want = {"apart": 0, "interior": 0, "edge": 0}
    want_fired = want_steps = 0
    for i in range(n_tiles):
        rows = np.arange(i * tm, (i + 1) * tm)
        for k in range(nbt):
            c0 = ((i + k) % n_tiles) * tm
            cols = np.arange(c0, c0 + tm)
            dlo = np.float32(xs[0, rows].min() - xs[0, cols].max())
            dhi = np.float32(xs[0, rows].max() - xs[0, cols].min())
            x0 = dlo >= -half and dhi < half
            if x0 and ((dhi < 0 and dhi * dhi >= c2)
                       or (dlo > 0 and dlo * dlo >= c2)):
                want["apart"] += 1
                continue
            d = c0 - i * tm
            lo, hi = d - (tm - 1), d + (tm - 1)
            if hi < 0:
                lo, hi = lo + n, hi + n
            interior = (x0 and i * tm + tm <= n and c0 + tm <= n and lo >= 1
                        and hi <= w)
            want["interior" if interior else "edge"] += 1
            dd = xs[:, rows, None] - xs[:, None, cols]
            dd = dd - L * np.floor(dd / L + 0.5)
            r2 = (dd * dd).sum(0)
            delta = (cols[None, :] - rows[:, None]) % n
            m = ((r2 < c2) & (rows[:, None] < n) & (cols[None, :] < n)
                 & (delta >= 1) & (delta <= w))
            for v in range(8):
                for u in range(rpt):
                    for j in range(tm // 16):
                        r = [(2 * v + h) * rpt + u for h in (0, 1)]
                        want_fired += bool(m[r, 16 * j:16 * j + 16].any())
                        want_steps += 1
    assert kinds == want and (fired, steps, out) == (want_fired, want_steps, 0)
    assert 0 < fired < steps and kinds["apart"] > 0 and kinds["interior"] > 0
