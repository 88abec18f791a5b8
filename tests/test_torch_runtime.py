"""The port's main path as a whole (plain versions on the CPU) against the
JAX runners in interpret mode: LJ fluid N=1000 at rho*=0.8, tiles 8 x 16,
segments of 4 steps, slack 0.15, exact forces."""

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
from chiron_tpu_torch import interop

N = 1000
CULL = dict(tm=8, tn=16, slack=0.15, segment_steps=4, exact_forces=True)
SEED = 3


def _np(a):
    return np.array(a)


def _setup(ts, units):
    fluid = ts.LennardJonesFluid(nparticles=N, reduced_density=0.8)
    md = units.md_unit_system
    return fluid, fluid.positions.value_in_unit_system(md), \
        fluid.box_vectors.value_in_unit_system(md)


def _common(fluid, units, **kw):
    return dict(potential=fluid.potential, n_particles=N,
                topology=fluid.topology, temperature=120.0 * units.kelvin,
                timestep=2.0 * units.femtoseconds, **kw)


@pytest.fixture(scope="module")
def culled():
    jfluid, jpos, jbox = _setup(jts, ju)
    jr = jrt.make_culled_lj_runner(**_common(jfluid, ju, **CULL))
    js0 = jr.init(jpos, jbox, seed=SEED)
    js8 = jr.run(js0, 8)
    tfluid, tpos, tbox = _setup(tts, tu)
    tr = trt.make_culled_lj_runner(**_common(tfluid, tu, **CULL), device="cpu")
    ts0 = tr.init(tpos, tbox, seed=SEED)
    return dict(jr=jr, js0=js0, js8=js8, tr=tr, ts0=ts0, box=tbox)


def _carry_from_jax(js, device="cpu"):
    pairs = {k: _np(v) for k, v in js.pairs._asdict().items()}
    return interop.cull_carry(
        _np(js.x), _np(js.v), _np(js.F), _np(js.step), _np(js.box_diag),
        _np(js.overflowed), pairs, _np(js.x_anchor), device)


def test_own_init_layout_and_list_equal(culled):
    jr, js0, tr, ts0 = culled["jr"], culled["js0"], culled["tr"], culled["ts0"]
    assert (tr.nslab, tr.capacity) == (jr.nslab, jr.capacity)
    assert tr.nslab == 0  # the bench's pure-x regime
    np.testing.assert_array_equal(ts0.x.numpy(), _np(js0.x))
    np.testing.assert_array_equal(ts0.box_diag.numpy(), _np(js0.box_diag))
    for name in ("rows", "cols", "ccx", "ptr2", "rowcx", "count"):
        np.testing.assert_array_equal(getattr(ts0.pairs, name).numpy(),
                                      _np(getattr(js0.pairs, name)),
                                      err_msg=name)
    assert bool(ts0.overflowed) == bool(js0.overflowed) is False
    # init force: same list, same kernel semantics
    assert np.abs(ts0.F.numpy() - _np(js0.F)).max() < 0.05


def test_eight_culled_steps_from_carried_state_match_jax(culled):
    tr, js8 = culled["tr"], culled["js8"]
    ts = _carry_from_jax(culled["js0"])
    ts8 = tr.run(ts, 8)
    assert int(ts8.step[0, 0]) == int(js8.step[0, 0]) == 8
    assert np.abs(ts8.x.numpy() - _np(js8.x)).max() < 1e-4
    assert np.abs(ts8.v.numpy() - _np(js8.v)).max() < 1e-3
    assert bool(ts8.overflowed) == bool(js8.overflowed) is False
    tr.check(ts8)
    e_ref = float(culled["jr"].energy(js8))
    assert abs(float(tr.energy(ts8)) - e_ref) / abs(e_ref) < 1e-5


def test_segment_fn_is_the_run_body(culled):
    tr = culled["tr"]
    ts = _carry_from_jax(culled["js0"])
    a = tr.run(ts, 4)
    b = tr.segment_fn(4)(ts)
    for name in ("x", "v", "F", "step", "overflowed"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_poisoned_state_latches_and_check_raises(culled):
    tr = culled["tr"]
    ts = _carry_from_jax(culled["js0"])
    # y, not x: the pure-x sort key would move a NaN x past the padding
    # sentinel, out of the live lanes (in both packages)
    ts.x[1, 5] = float("nan")
    out = tr.run(ts, 4)
    assert bool(out.overflowed)
    with pytest.raises(RuntimeError, match="invariant violated"):
        tr.check(out)


def test_fast_runner_step_with_injected_noise_matches_jax():
    jfluid, jpos, jbox = _setup(jts, ju)
    jf = jrt.make_fast_lj_runner(**_common(jfluid, ju, tm=128,
                                           exact_forces=True))
    js = jf.init(jpos, jbox, seed=5)
    js = jf.run(js, 3)  # off the lattice, where forces are not ~0
    _, sub = jax.random.split(js.key)
    noise = jax.random.normal(sub, js.x.shape, dtype=js.x.dtype)
    js1 = jf.run(js, 1)

    tfluid, tpos, tbox = _setup(tts, tu)
    tf = trt.make_fast_lj_runner(**_common(tfluid, tu, tm=128,
                                           exact_forces=True), device="cpu")
    assert tf.n_pad == _np(js.x).shape[1]
    carry = interop.langevin_carry(_np(js.x), _np(js.v), _np(js.F),
                                   _np(js.box_vectors), "cpu")
    t1 = tf.step(carry, torch.from_numpy(_np(noise)))
    assert np.abs(t1.x.numpy() - _np(js1.x)).max() < 1e-5
    assert np.abs(t1.v.numpy() - _np(js1.v)).max() < 1e-4
    e_ref = float(jf.energy(js1))
    assert abs(float(tf.energy(t1)) - e_ref) / abs(e_ref) < 1e-5
    # the port's own init and run keep the lane layout and stay finite
    own = tf.run(tf.init(tpos, tbox, seed=5), 2)
    assert own.x.shape == (3, tf.n_pad) and torch.isfinite(own.x).all()
    assert float(own.v[:, N:].abs().max()) > 0.0  # padding lanes move too, as in JAX
    assert tf.positions(own).shape == (N, 3)


def test_interop_lj_system_and_box():
    from chiron_tpu_torch.ops.lj_dense import box_diagonal

    pot, top = interop.lj_system(0.34, 0.99579, 1.02, np.full(5, 39.948))
    assert (pot.sigma, pot.cutoff) == (0.34, 1.02)
    assert pot.epsilon == pytest.approx(0.99579, rel=1e-15)
    np.testing.assert_array_equal(top.masses(), np.full(5, 39.948))
    box = np.eye(3, dtype=np.float32) * 4.5
    for b in (box, np.diagonal(box), np.diagonal(box).reshape(1, 3)):
        np.testing.assert_array_equal(box_diagonal(b, "cpu").numpy(),
                                      np.full((1, 3), 4.5, np.float32))


def test_culled_runner_rejects_mixed_masses_and_thin_boxes():
    fluid, pos, box = _setup(tts, tu)
    fluid.topology.add_atom("x", "C")  # a different mass
    with pytest.raises(ValueError, match="identical masses"):
        trt.make_culled_lj_runner(**_common(fluid, tu, **CULL), device="cpu")
    small = tts.LennardJonesFluid(nparticles=64, reduced_density=0.8)
    r = trt.make_culled_lj_runner(
        potential=small.potential, n_particles=64, topology=small.topology,
        tm=8, tn=16, device="cpu")
    with pytest.raises(ValueError, match="inapplicable"):
        r.init(small.positions.value_in_unit_system(tu.md_unit_system),
               small.box_vectors.value_in_unit_system(tu.md_unit_system))


def test_nan_x_coordinate_latches_as_in_jax():
    """The input of tests/test_lj_cull.py:286 (N=1000, rho*=0.3, one 5-step
    segment, NaN at x[0, 5]): JAX latches, and so does the port.  The pure-x
    sort moves the NaN key past the padding sentinel, out of the live lanes,
    so the port checks the live coordinates before it sorts."""
    def run(rt, ts, units, **kw):
        fluid = ts.LennardJonesFluid(nparticles=N, reduced_density=0.3)
        md = units.md_unit_system
        r = rt.make_culled_lj_runner(
            potential=fluid.potential, n_particles=N, topology=fluid.topology,
            temperature=120.0 * units.kelvin, tm=8, tn=16, segment_steps=5,
            **kw)
        st = r.init(fluid.positions.value_in_unit_system(md),
                    fluid.box_vectors.value_in_unit_system(md), seed=1)
        return r, st

    jr, js = run(jrt, jts, ju)
    js.x = js.x.at[0, 5].set(jnp.nan)
    js = jr.run(js, 5)
    tr, ts = run(trt, tts, tu, device="cpu")
    ts.x[0, 5] = float("nan")
    ts = tr.run(ts, 5)
    assert bool(js.overflowed) and bool(ts.overflowed)
    for r, s in ((jr, js), (tr, ts)):
        with pytest.raises(RuntimeError, match="invariant violated"):
            r.check(s)


def _engine_cases():
    """(label, n, rho, extra mass, box_vectors given): small, mid-size,
    large, non-uniform masses, a narrow box."""
    return [("small", 1000, 0.8, False, True), ("mid", 4000, 0.8, False, True),
            ("large", 100_000, 0.8, False, False),
            ("masses", 4000, 0.8, True, True), ("narrow", 2100, 3.0, False, True)]


@pytest.mark.parametrize("label,n,rho,extra_mass,with_box", _engine_cases())
def test_make_lj_runner_picks_the_jax_engine(label, n, rho, extra_mass,
                                             with_box):
    names = {"LangevinRunner": "FastLJRunner",
             "CulledRunner": "CulledLJRunner",
             "BandRunner": "BandRunner", "StripRunner": "StripRunner"}
    picked = []
    for rt, ts, units, kw in ((jrt, jts, ju, {}), (trt, tts, tu,
                                                   {"device": "cpu"})):
        fluid = ts.LennardJonesFluid(nparticles=2048 if n > 4000 else n,
                                     reduced_density=rho)
        if extra_mass:
            fluid.topology.add_atom("x", "C")
        box = None
        if with_box:
            box = fluid.box_vectors.value_in_unit_system(units.md_unit_system)
        r = rt.make_lj_runner(fluid.potential, n + extra_mass, box_vectors=box,
                              topology=fluid.topology,
                              temperature=120.0 * units.kelvin, **kw)
        picked.append(type(r).__name__)
    assert names[picked[0]] == picked[1]
    expect = {"small": "FastLJRunner", "mid": "CulledLJRunner",
              "large": "BandRunner", "masses": "FastLJRunner",
              "narrow": "FastLJRunner"}[label]
    assert picked[1] == expect


def test_make_lj_runner_by_name_and_unknown_name():
    fluid, _, box = _setup(tts, tu)
    kw = dict(potential=fluid.potential, n_particles=N, box_vectors=box,
              topology=fluid.topology, device="cpu")
    for engine, cls, extra in (("dense", trt.FastLJRunner, {}),
                               ("culled", trt.CulledLJRunner, {"tm": 8}),
                               ("strip", trt.StripRunner, {"tm": 8}),
                               ("band", trt.BandRunner, {"tm": 64})):
        r = trt.make_lj_runner(engine=engine, **kw, **extra)
        assert type(r) is cls, engine
    assert trt.make_lj_runner(engine="band", **kw).band.device.type == "cpu"
    with pytest.raises(ValueError, match="unknown engine"):
        trt.make_lj_runner(engine="cells", **kw)
