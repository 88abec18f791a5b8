"""The port's NpT slice (plain versions on the CPU) against the JAX package
in Pallas interpret mode: K5, the x-frame floor, K3's NpT modes
(``final_energy``, anchor and budget as data), the barostat fed the JAX
draws, one whole culled NpT segment and the dense NpT runner across an
attempt.  Engine parity runs on a jittered lattice (N=1000, L=5 nm, tiles
8 x 16); the runners on the dilute fluid of tests/test_npt_runner.py
(N=125, rho*=0.1), with exact forces in both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chiron_tpu.runtime as jrt
import chiron_tpu.testsystems as jts
import chiron_tpu.units as ju
import chiron_tpu_torch.runtime as trt
import chiron_tpu_torch.testsystems as tts
import chiron_tpu_torch.units as tu
from chiron_tpu.ops import lj_cull as jlc
from chiron_tpu_torch import interop
from chiron_tpu_torch.ops import lj_cull as tlc

N = 1000
SIGMA, EPS, CUTOFF = 0.34, 0.99579, 1.02
L = 5.0
TM, TN = 8, 16
SLACK = 0.2
MD_KW = dict(masses_lane=np.full(N, 39.9), dt=0.002, gamma=1.0,
             kT=0.008314 * 120, tm=TM, tn=TN, slack=SLACK)


def _np(a):
    return np.array(a)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


@pytest.fixture(scope="module")
def lattice():
    """A jittered lattice sorted by x, with each package's engine and list."""
    rng = np.random.default_rng(7)
    n_side = int(np.ceil(N ** (1 / 3)))
    g = (np.arange(n_side) + 0.5) * L / n_side
    xyz = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)[:N]
    xyz = (xyz + rng.normal(0, 0.02, xyz.shape)).astype(np.float32) % L
    jmd = jlc.CulledLJMD(N, SIGMA, EPS, CUTOFF, **MD_KW)
    tmd = tlc.CulledLJMD(N, SIGMA, EPS, CUTOFF, **MD_KW, device="cpu")
    pos3 = np.zeros((3, jmd.n_pad), np.float32)
    pos3[:, :N] = xyz.T
    jpos, _ = jlc.sort_by_key(jlc.slab_y_key(jnp.asarray(pos3), N, 0, L),
                              jnp.asarray(pos3), ())
    tpos = torch.from_numpy(_np(jpos))
    box = np.full(3, L, np.float32)
    return dict(jmd=jmd, tmd=tmd, box=box, jpos=jpos, tpos=tpos,
                jpairs=jmd.build_pairs(jpos, jnp.asarray(box), capacity=8192),
                tpairs=tmd.build_pairs(tpos, torch.from_numpy(box), 8192))


def test_k5_force_energy_matches_jax(lattice):
    s = lattice
    F_ref, E_ref = s["jmd"].force_energy(s["jpos"], jnp.asarray(s["box"]),
                                         s["jpairs"])
    F, E = s["tmd"].force_energy(s["tpos"], torch.from_numpy(s["box"]),
                                 s["tpairs"])
    F_ref = _np(F_ref)
    err = np.abs(F.numpy()[:, :N] - F_ref[:, :N])
    # cutoff-boundary pairs may flip between arithmetic orders
    assert err.max() < 0.05
    assert np.percentile(err, 99.0) / np.abs(F_ref).max() < 1e-5
    assert float(F[:, N:].abs().max()) == 0.0
    assert abs(float(E) - float(E_ref)) / abs(float(E_ref)) < 1e-5


def _thin_box_layout():
    """64 particles in a box 2.3 cutoffs wide, one 128-wide column tile: the
    kept rectangles' x half-widths pass half the box (frame-invalid)."""
    small_L = 2.3 * CUTOFF
    rng = np.random.default_rng(3)
    pos3 = np.zeros((3, 128), np.float32)
    pos3[:, :64] = rng.uniform(0, small_L, size=(64, 3)).T
    return pos3, 64, 8, 128, np.full(3, small_L, np.float32)


@pytest.mark.parametrize("case", ["lattice", "frame_invalid"])
def test_tile_frame_scale_floor_matches_jax(lattice, case):
    if case == "lattice":
        pos3, n, tm, tn, box = _np(lattice["jpos"]), N, TM, TN, lattice["box"]
    else:
        pos3, n, tm, tn, box = _thin_box_layout()
    ref = float(jlc.tile_frame_scale_floor(jnp.asarray(pos3), n, tm, tn,
                                           jnp.asarray(box), CUTOFF, SLACK))
    got = tlc.tile_frame_scale_floor(torch.from_numpy(pos3), n, tm, tn,
                                     torch.from_numpy(box), CUTOFF, SLACK)
    assert got.dtype == torch.float32 and got.shape == ()
    if case == "lattice":
        assert 0.0 < ref <= 1.0
        assert abs(float(got) - ref) <= 1e-6 * ref
    else:
        assert ref == float(got) == float("inf")


@pytest.mark.parametrize("side", ["below", "above"])
def test_run_segment_npt_modes_match_jax(lattice, side):
    """Two steps with ``final_energy`` and the anchor and budget as data:
    the anchor is the entry positions with two lanes moved, so the top-2
    drift is about 0.05 and the latch reads the budget, not the slack."""
    s = lattice
    jmd, tmd = s["jmd"], s["tmd"]
    box = s["box"]
    F0 = jmd.force(s["jpos"], jnp.asarray(box), s["jpairs"],
                   approx_recip=False)
    rng = np.random.default_rng(5)
    v0 = rng.normal(0, 0.3, (3, jmd.n_pad)).astype(np.float32)
    anchor = _np(s["jpos"]).copy()
    anchor[0, 10] += 0.03
    anchor[1, 500] -= 0.02
    budget = np.float32(0.045 if side == "below" else 0.055)
    jx, jv, jF, jstale, jE = jmd.run_segment(
        s["jpos"], jnp.asarray(v0), F0, jnp.asarray(box), s["jpairs"],
        seed=11, step_offset=5, n_steps=2, approx_recip=False,
        final_energy=True, drift_anchor=jnp.asarray(anchor),
        drift_budget=jnp.float32(budget))
    tx, tv, tF, tstale, tE = tmd.run_segment(
        s["tpos"], torch.from_numpy(v0), torch.from_numpy(_np(F0)),
        torch.from_numpy(box), s["tpairs"], seed=11, step_offset=5,
        n_steps=2, approx_recip=False, final_energy=True,
        drift_anchor=torch.from_numpy(anchor),
        drift_budget=torch.tensor(budget))
    assert np.abs(tx.numpy() - _np(jx)).max() < 1e-5
    assert np.abs(tv.numpy() - _np(jv)).max() < 1e-4
    assert np.abs(tF.numpy() - _np(jF)).max() < 0.05
    assert abs(float(tE) - float(jE)) / abs(float(jE)) < 1e-5
    assert bool(tstale) == bool(jstale) == (side == "below")
    # the carried energy is the final configuration's K5 energy
    assert float(tE) == float(tmd.force_energy(tx, torch.from_numpy(box),
                                               s["tpairs"])[1])


def test_energy_differentiable_gradient_is_minus_force(lattice):
    s = lattice
    box = torch.from_numpy(s["box"])
    pos = s["tpos"].clone().requires_grad_(True)
    E = s["tmd"].energy_differentiable(pos, box, s["tpairs"])
    E.backward()
    F, E_k5 = s["tmd"].force_energy(s["tpos"], box, s["tpairs"])
    assert torch.equal(pos.grad, -F)
    assert float(E.detach()) == float(E_k5)


def test_drift_top2_and_threshold_tensor(lattice):
    """The plain latch takes the threshold as a float or a 0-dim tensor and
    compares it with the top-2 drift."""
    x = lattice["tpos"]
    box = torch.from_numpy(lattice["box"])
    anchor = x.clone()
    anchor[0, 3] += 0.03
    anchor[2, 40] -= 0.02
    top2 = float(tlc.skin_drift_top2_plain(x, anchor, N, box))
    assert top2 == pytest.approx(0.05, rel=1e-4)
    for thr in (top2 * 0.99, torch.tensor(top2 * 0.99)):
        assert bool(tlc.tile_skin_drift_bad(x, anchor, N, thr, box))
    for thr in (top2 * 1.01, torch.tensor(top2 * 1.01)):
        assert not bool(tlc.tile_skin_drift_bad(x, anchor, N, thr, box))


# ---------------------------------------------------------------------------
# Runners on the dilute fluid
# ---------------------------------------------------------------------------


def _fluid(ts, units, n=125, rho=0.1):
    """The fluid and the stratified random start of tests/test_npt_runner.py
    (one particle a cell, jittered), in MD units."""
    fluid = ts.LennardJonesFluid(nparticles=n, reduced_density=rho)
    box = np.asarray(fluid.box_vectors.value_in_unit_system(
        units.md_unit_system))
    side = int(round(n ** (1 / 3)))
    rng = np.random.default_rng(11)
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    pos = (g + rng.uniform(0.25, 0.75, (n, 3))) * (np.diag(box) / side)
    return fluid, pos, box


def _culled_kw(fluid, units, n=125, P_atm=50.0, interval=10, segment=20,
               temperature_K=300.0, **kw):
    return dict(potential=fluid.potential, n_particles=n,
                topology=fluid.topology,
                temperature=temperature_K * units.kelvin,
                pressure=P_atm * units.atmosphere, tm=8, tn=16,
                barostat_interval=interval, segment_steps=segment, **kw)


def _make_culled(n=125, rho=0.1, seed=3, **kw):
    fluid, pos, box = _fluid(tts, tu, n, rho)
    r = trt.make_culled_npt_lj_runner(**_culled_kw(fluid, tu, n=n, **kw),
                                      device="cpu")
    return r, r.init(pos, box, seed=seed)


def _pair(**kw):
    """The JAX and the port culled NpT runners, each initialised from the
    same start; the port's state is then the JAX one, carried over."""
    jfluid, pos, box = _fluid(jts, ju)
    jr = jrt.make_culled_npt_lj_runner(**_culled_kw(jfluid, ju, **kw),
                                       exact_forces=True)
    js = jr.init(pos, box, seed=3)
    tfluid, _, _ = _fluid(tts, tu)
    tr = trt.make_culled_npt_lj_runner(**_culled_kw(tfluid, tu, **kw),
                                       exact_forces=True, device="cpu")
    ts = tr.init(pos, box, seed=3)
    assert (tr.nslab, tr.capacity, tr.vmax_cap) == (jr.nslab, jr.capacity,
                                                    jr.vmax_cap)
    return jr, js, tr, ts


def _cull_npt_from_jax(js):
    pairs = {k: _np(v) for k, v in js.pairs._asdict().items()}
    return interop.cull_npt_carry(
        _np(js.x), _np(js.v), _np(js.F), _np(js.U), _np(js.step),
        _np(js.box_diag), _np(js.overflowed), pairs, _np(js.x_anchor),
        _np(js.scale_used), _np(js.eval_peak), _np(js.s_total),
        _np(js.s_min_frame), _np(js.vmax_scale), _np(js.n_accepted),
        _np(js.n_proposed), "cpu")


def _jax_draws(key):
    """The key after one attempt and that attempt's two uniforms, as
    ``_npt_volume_proposal`` and ``_npt_accept`` draw them."""
    key, k_prop, k_acc = jax.random.split(key, 3)
    return key, (_np(jax.random.uniform(k_prop, minval=-1.0, maxval=1.0)),
                 _np(jax.random.uniform(k_acc, minval=1e-38)))


_BAROSTAT_FIELDS = ("box_diag", "U", "scale_used", "eval_peak", "s_total",
                    "vmax_scale")


def test_barostat_attempts_match_jax_draws():
    """Eight attempts fed the JAX draws, the fifth one box-invalid (frame
    floor raised past any reachable scale in both packages): the same
    decisions, and the barostat state to 1e-6 relative."""
    jr, js, tr, ts = _pair(volume_max_scale=0.05, autotune_interval=2)
    tc = _cull_npt_from_jax(js)
    key = js.key
    decisions = []
    for i in range(8):
        if i == 4:
            js = dataclasses.replace(js, s_min_frame=jnp.float32(2.0))
            tc = dataclasses.replace(tc, s_min_frame=torch.tensor(2.0))
        key, draws = _jax_draws(key)
        n_acc = int(js.n_accepted)
        js = jr._barostat_attempt(js)
        tc = tr._barostat_attempt(tc, *draws)
        decisions.append(int(js.n_accepted) - n_acc)
        assert int(tc.n_accepted) == int(js.n_accepted), i
        assert int(tc.n_proposed) == int(js.n_proposed) == i + 1
        for name in _BAROSTAT_FIELDS:
            assert _rel(getattr(tc, name).numpy(), _np(getattr(js, name))) \
                < 1e-6, (i, name)
        assert np.abs(tc.x.numpy() - _np(js.x)).max() < 1e-5
        if i == 4:
            js = dataclasses.replace(js, s_min_frame=jnp.float32(0.0))
            tc = dataclasses.replace(tc, s_min_frame=torch.tensor(0.0))
    assert decisions[4] == 0
    assert 0 < sum(decisions) < 8, decisions


def test_culled_npt_segment_matches_jax():
    """One whole segment (S=10, two attempts) from the JAX state carried
    over, with the JAX draws injected."""
    jr, js, tr, _ = _pair(interval=5, segment=10)
    tc = _cull_npt_from_jax(js)
    key, draws = js.key, []
    for _ in range(2):
        key, d = _jax_draws(key)
        draws.append(d)
    js = jr.run(js, 10)
    tc = tr.segment(tc, draws)
    assert int(tc.step[0, 0]) == int(js.step[0, 0]) == 10
    assert int(tc.n_proposed) == int(js.n_proposed) == 2
    assert int(tc.n_accepted) == int(js.n_accepted)
    assert bool(tc.overflowed) == bool(js.overflowed) is False
    assert np.abs(tc.x.numpy() - _np(js.x)).max() < 1e-4
    assert np.abs(tc.v.numpy() - _np(js.v)).max() < 1e-3
    assert _rel(tc.box_diag.numpy(), _np(js.box_diag)) < 1e-6
    assert _rel(tc.U.numpy(), _np(js.U)) < 1e-5
    for name in ("scale_used", "eval_peak", "s_total", "s_min_frame",
                 "vmax_scale"):
        assert _rel(getattr(tc, name).numpy(), _np(getattr(js, name))) \
            < 1e-5, name
    tr.check(tc)
    # the carried energy is a fresh K5 pass on the final configuration
    assert float(tc.U) == float(tr.energy(tc))


def test_dense_npt_steps_across_attempt_match_jax():
    """Four dense NpT steps with an attempt after the third, the JAX noise
    and draws injected."""
    kw = dict(n_particles=125, temperature=300.0, pressure=50.0, tm=64,
              barostat_interval=3, exact_forces=True, autotune_interval=1)

    def make(pkg_rt, ts, units, **extra):
        fluid = ts.LennardJonesFluid(nparticles=125, reduced_density=0.1)
        md = units.md_unit_system
        r = pkg_rt.make_npt_lj_runner(
            potential=fluid.potential, topology=fluid.topology,
            **dict(kw, temperature=kw["temperature"] * units.kelvin,
                   pressure=kw["pressure"] * units.atmosphere), **extra)
        return r, fluid.positions.value_in_unit_system(md), \
            fluid.box_vectors.value_in_unit_system(md)

    jr, pos, box = make(jrt, jts, ju)
    js = jr.init(pos, box, seed=3)
    tr, _, _ = make(trt, tts, tu, device="cpu")
    tc = interop.npt_carry(_np(js.x), _np(js.v), _np(js.F), _np(js.U),
                           _np(js.box_diag), _np(js.vmax_scale),
                           _np(js.n_accepted), _np(js.n_proposed),
                           _np(js.step), "cpu")
    key = js.key
    for i in range(4):
        key, sub = jax.random.split(key)
        noise = torch.from_numpy(_np(jax.random.normal(sub, js.x.shape)))
        draws = ()
        if (i + 1) % 3 == 0:
            key, draws = _jax_draws(key)
        tc = tr.step(tc, noise, *draws)
    js = jr.run(js, 4)
    assert tc.step == int(js.step) == 4
    assert int(tc.n_proposed) == int(js.n_proposed) == 1
    assert int(tc.n_accepted) == int(js.n_accepted)
    assert np.abs(tc.x.numpy() - _np(js.x)).max() < 1e-5
    assert np.abs(tc.v.numpy() - _np(js.v)).max() < 1e-4
    for name in ("box_diag", "vmax_scale"):
        assert _rel(getattr(tc, name).numpy(), _np(getattr(js, name))) \
            < 1e-6, name
    assert _rel(tc.U.numpy(), _np(js.U)) < 1e-5
    tr.check(tc)


def test_culled_npt_autotune_capped_to_slack_envelope():
    """Mirrors tests/test_npt_runner.py:120: the engine's cap on vmax, and
    where it binds: at init and on the increase branch only (a vmax above
    the cap is divided by 1.1, not clamped, on the decrease branch)."""
    r, st = _make_culled(rho=0.05, P_atm=1.0, interval=5, segment=10)
    reach = r.md.cutoff + r.md.slack
    charge_cap = 0.5 * r.md.slack / 2
    assert r.vmax_cap == pytest.approx(
        min(0.3, 1.0 - (1.0 - charge_cap / reach) ** 3))
    s_min = (1.0 - r.vmax_cap) ** (1.0 / 3.0)
    assert 2 * (1.0 - s_min) * reach <= 0.5 * r.md.slack + 1e-6
    _, st2 = _make_culled(rho=0.05, P_atm=1.0, interval=5, segment=10,
                          volume_max_scale=0.3)
    assert float(st2.vmax_scale) == pytest.approx(r.vmax_cap)
    _, st3 = _make_culled(rho=0.05, P_atm=1.0, interval=5, segment=10,
                          volume_max_scale=0.3, autotune=False)
    assert float(st3.vmax_scale) == pytest.approx(0.3)

    cap = r.vmax_cap
    above = torch.tensor(2.0 * cap)
    cases = [  # (n_acc, n_prop, expected from a vmax of 2 cap)
        (0, 20, 2.0 * cap / 1.1),   # decrease branch: no clamp
        (20, 20, cap),              # increase branch: clamped
        (10, 20, 2.0 * cap),        # in band: unchanged
        (0, 19, 2.0 * cap),         # not due: unchanged
    ]
    for n_acc, n_prop, expect in cases:
        got = trt._npt_autotune(above, torch.tensor(n_acc, dtype=torch.int32),
                                torch.tensor(n_prop, dtype=torch.int32), 20,
                                cap=cap)
        ref = jrt._npt_autotune(jnp.float32(2.0 * cap), jnp.int32(n_acc),
                                jnp.int32(n_prop), 20, cap=cap)
        assert float(got) == pytest.approx(expect, rel=1e-6)
        assert float(got) == pytest.approx(float(ref), rel=1e-6)


def test_culled_npt_box_never_crosses_minimum_image_bound():
    """Mirrors tests/test_npt_runner.py:216: proposals down to 0.46x the box
    length are rejected before the box crosses 2 (cutoff + slack).  The
    frame floor (0.97 here) rejects every deeper shrink too, so the walk
    moves only on the few draws in the last 9% of shrinks: 60 attempts."""
    r, st = _make_culled(P_atm=2000.0, volume_max_scale=0.9, autotune=False)
    bound = 2.0 * (r.md.cutoff + r.md.slack)
    assert float(st.box_diag.min()) > bound
    carry = st
    near = False
    for i in range(60):
        carry.generator.manual_seed(100 + i)
        carry = r._barostat_attempt(carry)
        assert float(carry.box_diag.min()) > bound, i
        near |= float(carry.box_diag.min()) < 1.5 * bound
    assert int(carry.n_proposed) == int(st.n_proposed) + 60
    assert near


def test_culled_npt_frame_floor_rejects_shrinks():
    r, st = _make_culled(interval=5, segment=10, autotune=False,
                         volume_max_scale=0.3)
    assert 0.0 < float(st.s_min_frame) <= 1.0
    st = dataclasses.replace(st, s_min_frame=torch.tensor(2.0))
    V0 = float(r.volume(st))
    for _ in range(6):
        st = r._barostat_attempt(st)
    assert int(st.n_accepted) == 0 and int(st.n_proposed) == 6
    assert float(r.volume(st)) == V0


def test_culled_npt_interval_validation():
    with pytest.raises(ValueError, match="multiple of barostat_interval"):
        _make_culled(segment=25, interval=10)
    r, st = _make_culled()
    with pytest.raises(ValueError, match="multiple of segment_steps"):
        r.run(st, 30)


def test_culled_npt_rejected_shrink_charges_latch_budget():
    """Mirrors tests/test_npt_runner.py:416: at a strongly negative pressure
    every shrink is rejected, yet it charges ``eval_peak``, and the drift
    latch fires on what is left of a 0.02 slack.  ``eval_peak`` restarts at
    each rebuild, so it is read after each of the three segments."""
    r, st = _make_culled(P_atm=-5000.0, interval=5, segment=10,
                         temperature_K=50.0, slack=0.02,
                         volume_max_scale=0.5, autotune=False)
    peaks = []
    for _ in range(3):
        st = r.segment(st)
        peaks.append(float(st.eval_peak))
    assert max(peaks) > 0.02, peaks
    assert int(st.n_accepted) < int(st.n_proposed) == 6
    assert bool(st.overflowed)
    with pytest.raises(RuntimeError, match="invariant"):
        r.check(st)


def test_culled_npt_run_and_nan_latch():
    r, st = _make_culled()
    V0 = float(r.volume(st))
    st = r.run(st, 40)
    r.check(st)
    assert int(st.n_proposed) == 4 and int(st.step[0, 0]) == 40
    assert float(r.volume(st)) != V0
    x = r.positions(st)
    assert x.shape == (125, 3) and bool(torch.isfinite(x).all())
    assert float(st.U) == float(r.energy(st))
    # a NaN x coordinate latches at the next segment's start
    st.x[0, 5] = float("nan")
    st = r.run(st, 20)
    with pytest.raises(RuntimeError, match="invariant"):
        r.check(st)


@pytest.mark.parametrize("sort_mode", ["x", "slab"])
def test_scaled_list_energy_equals_rebuilt_list(sort_mode):
    """Mirrors tests/test_npt_runner.py:183 and :295: a proposal's rescaled
    list gives the energy of a list rebuilt on the scaled configuration,
    under either sort key."""
    n = 125 if sort_mode == "x" else 343
    r, st = _make_culled(n=n, sort_mode=sort_mode)
    assert (r.nslab >= 1) == (sort_mode == "slab")
    st = r.run(st, 20)
    r.check(st)
    md = r.md
    for s in (0.9967, 1.0033):
        s = torch.tensor(s)
        x_new, box_new = st.x * s, st.box_diag * s
        scaled = st.pairs._replace(ccx=st.pairs.ccx * s,
                                   rowcx=st.pairs.rowcx * s)
        rebuilt = md.build_pairs(x_new, box_new[0], st.pairs.cols.shape[1])
        U_scaled = float(md.force_energy(x_new, box_new, scaled)[1])
        U_re = float(md.force_energy(x_new, box_new, rebuilt)[1])
        assert abs(U_scaled - U_re) < 1e-3, float(s)


def test_dense_npt_guards_and_check():
    """Mirrors tests/test_npt_runner.py:264 and :378: init refuses a box at
    or below 2 cutoffs, attempts never take the box there, and check()
    raises on a non-finite state."""
    fluid = tts.LennardJonesFluid(nparticles=125, reduced_density=0.1)
    md = tu.md_unit_system
    pos = fluid.positions.value_in_unit_system(md)
    r = trt.make_npt_lj_runner(
        potential=fluid.potential, n_particles=125, topology=fluid.topology,
        temperature=300.0 * tu.kelvin, pressure=2000.0 * tu.atmosphere,
        tm=64, barostat_interval=10, volume_max_scale=0.9, autotune=False,
        device="cpu")
    with pytest.raises(ValueError, match="2\\*cutoff"):
        r.init(pos, np.diag([2.0, 2.0, 2.0]), seed=0)
    st = r.init(pos, fluid.box_vectors.value_in_unit_system(md), seed=3)
    bound = 2.0 * fluid.potential.cutoff
    carry = st
    for i in range(10):
        carry.generator.manual_seed(200 + i)
        carry = r.run(carry, 10)
        assert float(carry.box_diag.min()) > bound, i
    assert int(carry.n_proposed) == 10 and carry.step == 100
    r.check(carry)
    with pytest.raises(RuntimeError, match="non-finite"):
        r.check(dataclasses.replace(carry, U=torch.tensor(float("nan"))))
    bad = carry.x.clone()
    bad[0, 0] = float("inf")
    with pytest.raises(RuntimeError, match="non-finite"):
        r.check(dataclasses.replace(carry, x=bad))
