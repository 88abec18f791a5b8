"""The port's fused sort + build (K10's plain version on the CPU) against the
JAX package's ``sort_build_raw`` in interpret mode, on tests/test_sortbuild.py's
state (N=1000, n_pad 1024, tiles 128 x 256), and the culled runner's
``fused_rebuild`` path against the JAX runner's."""

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
from chiron_tpu.ops.sortbuild import sort_build_raw
from chiron_tpu_torch import interop
from chiron_tpu_torch.ops import lj_cull as tlc
from chiron_tpu_torch.ops import sortbuild as tsb

N, N_PAD = 1000, 1024
TM, TN = 128, 256
L = 5.0
CUTOFF, SLACK = 1.02, 0.2
CAPS = {0: 64, 4: 256}  # the JAX tests' capacities
FIELDS = ("cols", "ccx", "ptr2", "rowcx", "count")


def _np(a):
    return np.array(a)


def _state(distinct: bool):
    """tests/test_sortbuild.py's state: uniform positions, with distinct x
    keys or, for the tie test, x rounded to 0.05 nm (many equal keys)."""
    rng = np.random.default_rng(11)
    x = rng.uniform(0, L, size=(3, N_PAD)).astype(np.float32)
    if distinct:
        x[0] = np.sort(rng.choice(np.linspace(0.001, L - 0.001, 50000),
                                  size=N_PAD, replace=False).astype(np.float32))
        rng.shuffle(x[0])
    else:
        x[0] = np.round(x[0] / 0.05).astype(np.float32) * np.float32(0.05)
    v = rng.normal(size=(3, N_PAD)).astype(np.float32)
    F = rng.normal(size=(3, N_PAD)).astype(np.float32)
    return x, v, F, np.full(3, L, np.float32)


@pytest.fixture(scope="module")
def jax_outputs():
    """JAX's sort_build_raw at nslab 0 (distinct keys), nslab 4 (distinct)
    and nslab 0 on a state with ties."""
    out = {}
    for key, (nslab, distinct) in {"x": (0, True), "slab4": (4, True),
                                   "ties": (0, False)}.items():
        x, v, F, box = _state(distinct)
        res = sort_build_raw(jnp.asarray(x), jnp.asarray(v), jnp.asarray(F),
                             jnp.asarray(box), n=N, tm=TM, tn=TN, nslab=nslab,
                             cutoff=CUTOFF, slack=SLACK, capacity=CAPS[nslab],
                             interpret=True)
        out[key] = (nslab, distinct, res)
    return out


@pytest.mark.parametrize("case", ["x", "slab4", "ties"])
def test_plain_sort_build_equals_jax_bitwise(jax_outputs, case):
    """Bitwise on the full n_pad, padding and ties included; ``rows`` is
    left out (JAX returns zeros there)."""
    nslab, distinct, (jx, jv, jF, jp) = jax_outputs[case]
    x, v, F, box = (torch.from_numpy(a) for a in _state(distinct))
    xs, vs, fs, tp = tsb.sort_build(x, v, F, box, N, TM, TN, nslab, CUTOFF,
                                    SLACK, CAPS[nslab])
    for a, b in ((xs, jx), (vs, jv), (fs, jF)):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    for name in FIELDS:
        a, b = getattr(tp, name), _np(getattr(jp, name))
        assert a.numpy().dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert bool(tp.overflowed) == bool(jp.overflowed)
    assert 0 < int(tp.count[0, 0])


@pytest.mark.parametrize("nslab", [0, 4])
def test_sort_build_equals_stable_sort_and_build_on_distinct_keys(nslab):
    """With distinct keys the network's permutation is the stable sort's,
    and the list (``rows`` included) is ``build_tile_pairs``'s."""
    x, v, F, box = (torch.from_numpy(a) for a in _state(True))
    key = tlc.slab_y_key(x, N, nslab, box[0], Ly=box[1])
    xo, (vo, fo) = tlc.sort_by_key(key, x, (v, F))
    ref = tlc.build_tile_pairs(xo, N, TM, TN, box, CUTOFF, SLACK, CAPS[nslab])
    xs, vs, fs, tp = tsb.sort_build(x, v, F, box, N, TM, TN, nslab, CUTOFF,
                                    SLACK, CAPS[nslab])
    for a, b in ((xs, xo), (vs, vo), (fs, fo)):
        assert torch.equal(a[:, :N], b[:, :N])
    for name in FIELDS + ("rows",):
        assert torch.equal(getattr(tp, name), getattr(ref, name)), name
    assert bool(tp.overflowed) == bool(ref.overflowed)


def test_bitonic_permutation_sorts_with_ties_and_nans():
    """The network sorts keys with ties; a NaN key compares false against
    every key, so it never swaps and the result stays a permutation (JAX
    leaves it where the network does: the bitwise tests above)."""
    key = torch.tensor([1.0, 1.0, 0.5, 0.5, 2.0, 2.0, 0.5, 1.0])
    perm = tsb.bitonic_permutation(key)
    assert torch.equal(key[perm], torch.sort(key).values)
    nan = torch.tensor([3.0, float("nan"), 1.0, 2.0])
    perm = tsb.bitonic_permutation(nan)
    assert sorted(perm.tolist()) == [0, 1, 2, 3]
    assert perm[1] == 1  # the NaN lane never swaps


def test_capacity_overflow_flagged():
    x, v, F, box = (torch.from_numpy(a) for a in _state(True))
    *_, tp = tsb.sort_build(x, v, F, box, N, TM, TN, 0, CUTOFF, SLACK, 3)
    assert bool(tp.overflowed)
    assert int(tp.count[0, 0]) == 3 and int(tp.ptr2.max()) == 3


def test_sort_build_rejects_bad_shapes():
    x, v, F, box = (torch.from_numpy(a[:, :768] if a.ndim == 2 else a)
                    for a in _state(True))
    with pytest.raises(ValueError, match="power-of-two"):
        tsb.sort_build(x, v, F, box, 700, 128, 256, 0, CUTOFF, SLACK, 64)
    x, v, F, box = (torch.from_numpy(a) for a in _state(True))
    with pytest.raises(ValueError, match="128-multiple"):
        tsb.sort_build(x, v, F, box, N, 64, 256, 0, CUTOFF, SLACK, 64)


# ---- the runner's fused_rebuild path ------------------------------------

RUNNER = dict(temperature=120.0, segment_steps=10, tm=128, tn=128, slack=0.15)


def _runner(rt, ts, units, n=N, **kw):
    fluid = ts.LennardJonesFluid(nparticles=n, reduced_density=0.5)
    md = units.md_unit_system
    r = rt.make_culled_lj_runner(
        potential=fluid.potential, n_particles=n, topology=fluid.topology,
        temperature=RUNNER["temperature"] * units.kelvin,
        segment_steps=RUNNER["segment_steps"], tm=RUNNER["tm"],
        tn=RUNNER["tn"], slack=RUNNER["slack"], fused_rebuild=True, **kw)
    return r, fluid.positions.value_in_unit_system(md), \
        fluid.box_vectors.value_in_unit_system(md)


@pytest.fixture(scope="module")
def jax_runner_segments():
    """tests/test_sortbuild.py's runner (N=1000, rho*=0.5, S=10, tiles 128,
    slack 0.15, seed 9) with fused_rebuild: init and two segments."""
    jr, pos, box = _runner(jrt, jts, ju)
    js0 = jr.init(pos, box, seed=9)
    js1 = jr.run(js0, 10)
    return jr, js0, js1, jr.run(js1, 10)


def _carry(js):
    pairs = {k: _np(v) for k, v in js.pairs._asdict().items()}
    return interop.cull_carry(_np(js.x), _np(js.v), _np(js.F), _np(js.step),
                              _np(js.box_diag), _np(js.overflowed), pairs,
                              _np(js.x_anchor), "cpu")


def test_fused_rebuild_runner_matches_jax(jax_runner_segments):
    """Each of JAX's two segments from its carried start.  (Two segments
    chained from the lattice put particles of one lattice plane within an
    ulp-level difference of each other in x, where the two packages'
    last-bit differences may order them differently at the next sort.)"""
    jr, *states = jax_runner_segments
    tr, pos, box = _runner(trt, tts, tu, device="cpu")
    assert tr.path == "fused_rebuild"
    tr.init(pos, box, seed=9)
    assert (tr.nslab, tr.capacity) == (jr.nslab, jr.capacity)
    for js, js_next in zip(states, states[1:]):
        ts = tr.run(_carry(js), 10)
        assert int(ts.step[0, 0]) == int(js_next.step[0, 0])
        # the tolerance of tests/test_torch_runtime.py's culled segments
        assert np.abs(ts.x.numpy() - _np(js_next.x)).max() < 1e-4
        assert np.abs(ts.v.numpy() - _np(js_next.v)).max() < 1e-3
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(ts.pairs, name).numpy(),
                                          _np(getattr(js_next.pairs, name)),
                                          err_msg=name)
        np.testing.assert_array_equal(ts.x_anchor.numpy(),
                                      _np(js_next.x_anchor))
        assert bool(ts.overflowed) == bool(js_next.overflowed) is False
        tr.check(ts)
        e_ref = float(jr.energy(js_next))
        assert abs(float(tr.energy(ts)) - e_ref) / abs(e_ref) < 1e-5


def test_fused_rebuild_applies_where_the_reference_does():
    """Power-of-two n_pad and 128-multiple tiles take the fused path; other
    tiles the default path; above n_pad 4096 the factory refuses, as the
    reference does at its first segment."""
    r, _, _ = _runner(trt, tts, tu, device="cpu")
    assert r.path == "fused_rebuild"
    fluid = tts.LennardJonesFluid(nparticles=N, reduced_density=0.5)
    kw = dict(potential=fluid.potential, n_particles=N,
              topology=fluid.topology, fused_rebuild=True, device="cpu")
    assert trt.make_culled_lj_runner(tm=64, tn=128, **kw).path == "default"
    assert trt.make_culled_lj_runner(**kw).path == "fused_rebuild"
    big = tts.LennardJonesFluid(nparticles=8000, reduced_density=0.8)
    with pytest.raises(ValueError, match="n_pad=4096"):
        trt.make_culled_lj_runner(potential=big.potential, n_particles=8000,
                                  topology=big.topology, fused_rebuild=True,
                                  device="cpu")
    assert trt.make_culled_lj_runner(
        potential=big.potential, n_particles=8000, topology=big.topology,
        device="cpu").path == "default"


def test_fused_rebuild_latches_a_nan_before_its_sort():
    """A NaN x coordinate leaves the live lanes at the sort; the fused path
    checks the live lanes first, as the default path does."""
    tr, pos, box = _runner(trt, tts, tu, device="cpu")
    st = tr.init(pos, box, seed=9)
    st.x[0, 5] = float("nan")
    out = tr.run(st, 10)
    assert bool(out.overflowed)
    with pytest.raises(RuntimeError, match="invariant violated"):
        tr.check(out)
