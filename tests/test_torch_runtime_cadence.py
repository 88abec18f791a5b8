"""The culled runner's list cadence (``sort_every``, ``rebuild_every``) in
the port (plain versions on the CPU) against the JAX runners in interpret
mode: LJ fluid N=1000 at rho*=0.8, tiles 8 x 16, segments of 4 steps,
slack 0.15, exact forces, seed 3.

Each port segment starts from the JAX carry that JAX's segment started
from (mid-cadence, its list and anchor older than the segment) and is held
to JAX's next carry: the tile-pair list and its anchor exactly, x within
1e-4 nm, v within 1e-3, the step (and the host's copy of it) and the latch
equal.  A mid-cadence carry goes through a checkpoint each way.
"""

import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

import chiron_tpu.checkpoint as jck
import chiron_tpu.runtime as jrt
import chiron_tpu.testsystems as jts
import chiron_tpu.units as ju
import chiron_tpu_torch.checkpoint as tck
import chiron_tpu_torch.runtime as trt
import chiron_tpu_torch.testsystems as tts
import chiron_tpu_torch.units as tu
from chiron_tpu_torch import interop

N = 1000
CULL = dict(tm=8, tn=16, slack=0.15, segment_steps=4, exact_forces=True)
SEED = 3
# segment lengths: the 3-step remainder shifts the phase (steps 0, 4, 8,
# 11, 15, 19 are segments 0, 1, 2, 2, 3, 4), as the reference lets it
SEGMENTS = (4, 4, 3, 4, 4, 4)
PAIRS = [(4, 1), (1, 2), (2, 2), (1, 3)]
LIST_FIELDS = ("rows", "cols", "ccx", "ptr2", "rowcx", "count")


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


def _carry_from_jax(js, device="cpu"):
    pairs = {k: _np(v) for k, v in js.pairs._asdict().items()}
    return interop.cull_carry(
        _np(js.x), _np(js.v), _np(js.F), _np(js.step), _np(js.box_diag),
        _np(js.overflowed), pairs, _np(js.x_anchor), device)


def _runners(sort_every, rebuild_every):
    """The JAX runner and the port's (on the CPU), each initialised from the
    lattice at SEED, with the cadence."""
    jfluid, jpos, jbox = _setup(jts, ju)
    jr = jrt.make_culled_lj_runner(**_common(
        jfluid, ju, sort_every=sort_every, rebuild_every=rebuild_every,
        **CULL))
    js0 = jr.init(jpos, jbox, seed=SEED)
    tfluid, tpos, tbox = _setup(tts, tu)
    tr = trt.make_culled_lj_runner(**_common(
        tfluid, tu, sort_every=sort_every, rebuild_every=rebuild_every,
        **CULL), device="cpu")
    tr.init(tpos, tbox, seed=SEED)
    return jr, js0, tr


def _jax_segments(jr, js, lengths):
    """JAX's carries at each segment boundary, its segments jitted."""
    fns = {n: jax.jit(jr.segment_fn(n)) for n in set(lengths)}
    out = [js]
    for n in lengths:
        out.append(fns[n](out[-1]))
    return out


@pytest.fixture(scope="module", params=PAIRS,
                ids=lambda p: f"sort{p[0]}-rebuild{p[1]}")
def cadence_run(request):
    sort_every, rebuild_every = request.param
    jr, js0, tr = _runners(sort_every, rebuild_every)
    assert (tr.nslab, tr.capacity) == (jr.nslab, jr.capacity)
    return request.param, jr, tr, _jax_segments(jr, js0, SEGMENTS)


def _assert_list_equal(tp, jp, what):
    for name in LIST_FIELDS:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      _np(getattr(jp, name)),
                                      err_msg=f"{what}: {name}")


def test_each_segment_of_the_cadence_matches_jax(cadence_run):
    (sort_every, rebuild_every), jr, tr, js = cadence_run
    rebuilt = 0
    for k, n in enumerate(SEGMENTS):
        ts = tr.segment_fn(n)(_carry_from_jax(js[k]))
        ref = js[k + 1]
        what = f"segment {k} ({n} steps)"
        step = int(ref.step[0, 0])
        assert int(ts.step[0, 0]) == ts.step_host == step, what
        _assert_list_equal(ts.pairs, ref.pairs, what)
        np.testing.assert_array_equal(ts.x_anchor.numpy(), _np(ref.x_anchor),
                                      err_msg=what)
        assert np.abs(ts.x.numpy() - _np(ref.x)).max() < 1e-4, what
        assert np.abs(ts.v.numpy() - _np(ref.v)).max() < 1e-3, what
        assert bool(ts.overflowed) == bool(ref.overflowed) is False, what
        # the cadence: a kept list keeps its anchor from an earlier segment
        do_sort, do_rebuild = tr.cadence(int(js[k].step[0, 0]))
        kept = np.array_equal(_np(ref.x_anchor), _np(js[k].x_anchor))
        # (segment 0 rebuilds from the sorted lattice of init, its anchor)
        assert kept if not do_rebuild else (k == 0 or not kept), what
        rebuilt += do_rebuild
    expected = {(4, 1): 6, (1, 2): 4, (2, 2): 4, (1, 3): 2}
    assert rebuilt == expected[(sort_every, rebuild_every)]
    e_ref = float(jr.energy(js[-1]))
    assert abs(float(tr.energy(ts)) - e_ref) / abs(e_ref) < 1e-5


def test_the_port_run_keeps_its_host_step_and_follows_jax(cadence_run):
    """The port's own ``run`` from JAX's first carry: the host's step equals
    the device's after each segment, and x, v end where JAX's do."""
    _, _, tr, js = cadence_run
    ts = _carry_from_jax(js[0])
    for n in SEGMENTS:
        ts = tr.run(ts, n)
        assert ts.step_host == int(ts.step[0, 0])
    ref = js[-1]
    assert ts.step_host == int(ref.step[0, 0]) == sum(SEGMENTS)
    assert np.abs(ts.x.numpy() - _np(ref.x)).max() < 1e-4
    assert np.abs(ts.v.numpy() - _np(ref.v)).max() < 1e-3
    assert bool(ts.overflowed) == bool(ref.overflowed) is False


def test_cadence_formula_is_the_references():
    r = trt.make_culled_lj_runner(**_common(_setup(tts, tu)[0], tu,
                                            sort_every=2, rebuild_every=3,
                                            **CULL), device="cpu")
    got = [r.cadence(4 * k) for k in range(8)]
    # do_sort every 6 segments, do_rebuild every 3 (and with each sort)
    assert got == [(True, True), (False, False), (False, False),
                   (False, True), (False, False), (False, False),
                   (True, True), (False, False)]
    assert r.cadence(11) == r.cadence(8)  # the remainder's phase


def test_a_particle_past_the_slack_latches_over_a_kept_list():
    """rebuild_every=3: after segment 0's rebuild, one particle is moved
    0.17 nm (past the 0.15 slack) along a cube diagonal; both packages
    latch at the end of segment 1, which keeps the list.  With a rebuild
    every segment the list is rebuilt from the moved particle instead, and
    neither latches."""
    jr, js0, tr = _runners(1, 3)
    js1 = _jax_segments(jr, js0, (4,))[1]
    x = _np(js1.x)
    box = float(_np(js1.box_diag)[0, 0])
    lane = 17
    moved = x.copy()
    moved[:, lane] = (moved[:, lane] + 0.17 / np.sqrt(3.0)) % box
    d = moved[:, :N] - moved[:, lane:lane + 1]
    d -= box * np.round(d / box)
    r = np.sqrt((d * d).sum(0))
    r[lane] = np.inf
    assert r.min() > 0.25  # no overlap: the forces stay moderate
    js1 = dataclasses.replace(js1, x=jax.numpy.asarray(moved))
    j2 = _jax_segments(jr, js1, (4,))[1]
    t2 = tr.segment_fn(4)(_carry_from_jax(js1))
    assert not bool(js1.overflowed)
    assert bool(j2.overflowed) and bool(t2.overflowed)
    with pytest.raises(RuntimeError, match="invariant violated"):
        tr.check(t2)
    # a rebuild every segment re-anchors at the moved particle
    jr1, _, tr1 = _runners(1, 1)
    j2 = _jax_segments(jr1, js1, (4,))[1]
    t2 = tr1.segment_fn(4)(_carry_from_jax(js1))
    assert not bool(j2.overflowed) and not bool(t2.overflowed)


def test_refusals_equal_the_references():
    """megakernel refuses a cadence, and so does fused_rebuild where it
    applies (a power-of-two n_pad, 128-multiple tiles): tests/
    test_sortbuild.py:190's fluid, N=4000 with 128 x 128 tiles.  The JAX
    runner refuses at its first segment, the port at the factory."""
    def fluid_of(ts, units):
        fluid = ts.LennardJonesFluid(nparticles=4000, reduced_density=0.8)
        md = units.md_unit_system
        return (dict(potential=fluid.potential, n_particles=4000,
                     topology=fluid.topology, tm=128, tn=128),
                fluid.positions.value_in_unit_system(md),
                fluid.box_vectors.value_in_unit_system(md))

    jkw, jpos, jbox = fluid_of(jts, ju)
    tkw, _, _ = fluid_of(tts, tu)
    for opts, match in ((dict(sort_mode="x", megakernel=True, sort_every=2),
                         "cadence knobs"),
                        (dict(fused_rebuild=True, rebuild_every=2),
                         "sort_every")):
        jr = jrt.make_culled_lj_runner(**jkw, **opts)
        jr.init(jpos, jbox, seed=SEED)
        with pytest.raises(ValueError, match=match):
            jr.segment_fn(4)
        with pytest.raises(ValueError, match=match):
            trt.make_culled_lj_runner(**tkw, **opts, device="cpu")


def test_fused_rebuild_elsewhere_runs_the_cadence_as_in_the_reference():
    """Tiles of 8 x 16: fused_rebuild does not apply, so both packages run
    the default path with the cadence.  A cadence under 1 is refused."""
    jfluid, jpos, jbox = _setup(jts, ju)
    tfluid, _, _ = _setup(tts, tu)
    jr = jrt.make_culled_lj_runner(**_common(
        jfluid, ju, fused_rebuild=True, rebuild_every=2, **CULL))
    jr.init(jpos, jbox, seed=SEED)
    jr.segment_fn(4)
    tr = trt.make_culled_lj_runner(**_common(
        tfluid, tu, fused_rebuild=True, rebuild_every=2, **CULL),
        device="cpu")
    assert (tr.path, tr.rebuild_every) == ("default", 2)
    for bad in (dict(sort_every=0), dict(rebuild_every=-1)):
        with pytest.raises(ValueError, match="both >= 1"):
            trt.make_culled_lj_runner(**_common(tfluid, tu, **bad, **CULL),
                                      device="cpu")


def test_make_lj_runner_forwards_the_cadence():
    fluid, pos, box = _setup(tts, tu)
    r = trt.make_lj_runner(engine="culled", box_vectors=box, rebuild_every=2,
                           sort_every=3, device="cpu",
                           **_common(fluid, tu, **CULL))
    assert isinstance(r, trt.CulledLJRunner)
    assert (r.sort_every, r.rebuild_every) == (3, 2)
    s0 = r.init(pos, box, seed=SEED)
    s1 = r.run(s0, 4)   # segment 0: sort and rebuild
    s2 = r.run(s1, 4)   # segment 1: neither
    assert torch.equal(s1.x_anchor, s2.x_anchor)
    assert s2.pairs is s1.pairs and s2.step_host == 8


def test_a_mid_cadence_carry_checkpoints_across_the_packages(tmp_path):
    """rebuild_every=2 after one segment: the list and its anchor are a
    segment old.  The port's file loads into JAX's carry and JAX's into the
    port's (the same tree: the host's step is no field of it), and the
    port's next segment from either equals it from the carry itself."""
    jr, js0, tr = _runners(1, 2)
    js1 = _jax_segments(jr, js0, (4,))[1]
    ts1 = _carry_from_jax(js1)
    assert not np.array_equal(_np(js1.x_anchor), _np(js1.x))
    assert tck.tree_flatten(ts1)[1] == str(jax.tree_util.tree_flatten(js1)[1])
    tpath, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tck.save_checkpoint(tpath, ts1)
    jback, _ = jck.load_checkpoint(tpath, like=js1)
    for a, b in zip(jax.tree_util.tree_leaves(jback),
                    jax.tree_util.tree_leaves(js1)):
        np.testing.assert_array_equal(_np(a), _np(b))
    jck.save_checkpoint(jpath, js1)
    tback, _ = tck.load_checkpoint(jpath, like=ts1)
    assert tback.step_host == ts1.step_host == 4
    want = tr.segment_fn(4)(ts1)
    got = tr.segment_fn(4)(tback)
    for a, b in zip(tck.tree_flatten(got)[0], tck.tree_flatten(want)[0]):
        assert torch.equal(a, b)
    assert got.step_host == want.step_host == 8


def test_the_host_step_follows_the_step_tensor():
    """A carry from ``init`` or a segment answers from its note; a carry
    whose ``step`` was replaced or changed in place since reads ``step``
    itself, also under inference mode."""
    fluid, pos, box = _setup(tts, tu)
    r = trt.make_culled_lj_runner(**_common(fluid, tu, rebuild_every=2,
                                            **CULL), device="cpu")
    c = r.init(pos, box, seed=SEED)
    assert c.step_host == 0 and c._noted[2] == 0
    c = r.segment_fn(4)(c)
    assert c.step_host == 4 and c._noted[2] == 4
    moved = dataclasses.replace(c, step=torch.full((1, 1), 8, dtype=torch.int32))
    assert moved.step_host == 8 and r.cadence(moved.step_host) == (True, True)
    c.step += 4
    assert c.step_host == 8
    assert r.segment_fn(4)(c).step_host == 12
    with torch.inference_mode():
        d = r.segment_fn(4)(r.init(pos, box, seed=SEED))
        assert d.step_host == 4
        d.step.add_(4)
        assert d.step_host == 4  # an inference tensor keeps no version


@pytest.mark.parametrize("factory", ["make_culled_lj_runner",
                                     "make_culled_npt_lj_runner",
                                     "make_strip_lj_runner"])
def test_init_sets_the_seed_as_in_the_reference(factory):
    """``init(seed=)`` sets the noise seed (0 by default) in both packages.
    The reference's ``seed_default`` is overwritten by every ``init`` before
    a segment can run, so the port leaves it out.  The strip runner's fluid
    is test_torch_strip.py's (rho* = 0.3): at 0.8 its halo outgrows N=1000."""
    rho = 0.3 if factory == "make_strip_lj_runner" else 0.8
    kw = dict(tm=8) if factory == "make_strip_lj_runner" else dict(tm=8, tn=16)
    fluid = tts.LennardJonesFluid(nparticles=N, reduced_density=rho)
    md = tu.md_unit_system
    pos = fluid.positions.value_in_unit_system(md)
    box = fluid.box_vectors.value_in_unit_system(md)
    tr = getattr(trt, factory)(**_common(fluid, tu, **kw), device="cpu")
    jsig = inspect.signature(getattr(jrt, factory))
    tsig = inspect.signature(getattr(trt, factory))
    assert "seed_default" in jsig.parameters
    assert "seed_default" not in tsig.parameters
    assert tr.seed is None
    with pytest.raises(RuntimeError, match="init"):
        tr.segment_fn(4) if hasattr(tr, "segment_fn") else tr.segment(None, 4)
    tr.init(pos, box, seed=5)
    assert tr.seed == 5
    tr.init(pos, box)
    assert tr.seed == 0
