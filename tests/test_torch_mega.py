"""The port's megakernel segment (K11's plain version on the CPU) against the
JAX package's ``mega_md_raw`` in interpret mode, on tests/test_lj_mega.py's
system (a jittered lattice, N=1000, L=5 nm, x-sorted, tiles 128 x 128), and
the culled runner's ``megakernel`` path against the JAX runner's."""

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
from chiron_tpu.ops.lj_mega import mega_md_raw
from chiron_tpu_torch import interop
from chiron_tpu_torch.ops import lj_cull as tlc
from chiron_tpu_torch.ops import lj_mega as tmg

N = 1000
SIGMA, EPS, CUTOFF = 0.34, 0.99579, 1.02
L = 5.0
TM = TN = 128
CAP, STEPS, SEED = 512, 5, 3
MD_KW = dict(masses_lane=np.full(N, 39.9), dt=0.002, gamma=1.0,
             kT=0.008314 * 120, tm=TM, tn=TN, slack=0.2)


def _np(a):
    return np.array(a)


@pytest.fixture(scope="module")
def system():
    """tests/test_lj_mega.py's system in both packages, its x-sorted
    positions, small velocities, the culled force, and JAX's mega segment
    at P = 0 and P = 16 (exact reciprocal: interpret mode takes the
    approximate one as a bf16 reciprocal)."""
    rng = np.random.default_rng(7)
    n_side = int(np.ceil(N ** (1 / 3)))
    g = (np.arange(n_side) + 0.5) * L / n_side
    xyz = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)[:N]
    xyz = (xyz + rng.normal(0, 0.02, xyz.shape)).astype(np.float32) % L
    jmd = jlc.CulledLJMD(N, SIGMA, EPS, CUTOFF, **MD_KW)
    tmd = tlc.CulledLJMD(N, SIGMA, EPS, CUTOFF, **MD_KW, device="cpu")
    pos3 = np.zeros((3, jmd.n_pad), np.float32)
    pos3[:, :N] = xyz.T
    box = np.full(3, L, np.float32)
    jpos, _ = jlc.sort_by_key(jlc.slab_y_key(jnp.asarray(pos3), N, 0, L),
                              jnp.asarray(pos3), ())
    pairs = jmd.build_pairs(jpos, jnp.asarray(box), capacity=CAP)
    v0 = 0.01 * jmd.sigv * jnp.ones((3, jmd.n_pad), jnp.float32)
    F0 = jmd.force(jpos, jnp.asarray(box), pairs, approx_recip=False)
    w0 = v0 - (0.5 * jmd.dt) * F0 * jmd.minv
    ref = {}
    for passes in (0, 16):
        ref[passes] = tuple(_np(a) for a in mega_md_raw(
            jpos, w0, F0, jnp.asarray(box),
            jnp.asarray(SEED, jnp.int32).reshape(1, 1),
            jnp.zeros((1, 1), jnp.int32), jmd.minv, jmd.sigv, N, STEPS,
            TM, TN, SIGMA, EPS, CUTOFF, jmd.dt, jmd.a, jmd.b, False,
            jmd.interpret, unroll=jmd.unroll, slack=jmd.slack, capacity=CAP,
            repair_passes=passes))
    state = tuple(torch.from_numpy(_np(a)) for a in (jpos, w0, F0))
    return tmd, state, torch.from_numpy(box), ref


@pytest.mark.parametrize("passes", [0, 16])
def test_plain_mega_segment_matches_jax(system, passes):
    tmd, (x, w, F), box, ref = system
    jx, jw, jF, jflag = ref[passes]
    tx, tw, tF, flag = tmg.mega_segment(tmd, x, w, F, box, CAP, SEED, 0,
                                        STEPS, repair_passes=passes)
    # as tests/test_torch_lj_cull.py's segment: float rounding, and pairs at
    # the cutoff that may flip (each moves a force by at most ~0.033)
    assert np.abs(tx.numpy() - jx).max() < 1e-5
    assert np.abs(tw.numpy() - jw).max() < 1e-4
    dF = np.abs(tF.numpy() - jF)
    assert dF.max() < 0.05
    assert np.percentile(dF, 99.0) / np.abs(jF).max() < 1e-5
    assert bool(flag) == bool(jflag[0, 0] > 0.5)


def test_p0_segment_is_the_classic_segment_bitwise(system):
    """With the repair off, a segment equals the classic path's (the
    list of build_tile_pairs, run_segment with its drift latch) bit for
    bit: same list, noise stream and arithmetic."""
    tmd, (x, w, F), box, _ = system
    half_dt = 0.5 * tmd.dt
    v = w + half_dt * F * tmd.minv
    pairs = tmd.build_pairs(x, box, CAP)
    xc, vc, Fc, stale = tmd.run_segment(
        x, v, F, box, pairs, seed=SEED, step_offset=0, n_steps=STEPS,
        drift_slack=tmd.slack_t)
    xm, wm, Fm, flag = tmg.mega_segment(
        tmd, x, v - half_dt * F * tmd.minv, F, box, CAP, SEED,
        torch.zeros((1, 1), dtype=torch.int32), STEPS, repair_passes=0)
    assert torch.equal(xm, xc) and torch.equal(Fm, Fc)
    assert torch.equal(wm + half_dt * Fm * tmd.minv, vc)
    assert bool(flag) == bool(stale)


def _canon(x, w, F):
    m = torch.cat([x[:, :N], w[:, :N], F[:, :N]], dim=0).numpy()
    return m[:, np.lexsort(m[::-1])]


def _inversions(x):
    xs = x[0, :N].numpy()
    return int(np.sum(xs[:-1] > xs[1:]))


def test_repair_is_a_pure_permutation(system):
    """P = 16 permutes the live lanes of the P = 0 result (the same
    multiset of (x, w, F) columns), leaves the padding unmoved and orders x
    no worse."""
    tmd, (x, w, F), box, _ = system
    a = tmg.mega_segment(tmd, x, w, F, box, CAP, SEED, 0, STEPS,
                         repair_passes=0)
    b = tmg.mega_segment(tmd, x, w, F, box, CAP, SEED, 0, STEPS,
                         repair_passes=16)
    for p, q in zip(a[:3], b[:3]):
        assert torch.equal(p[:, N:], q[:, N:])
    np.testing.assert_array_equal(_canon(*a[:3]), _canon(*b[:3]))
    assert _inversions(b[0]) <= _inversions(a[0])
    assert bool(a[3]) == bool(b[3])
    # and the repair alone on a shuffled order: adjacent disorder is
    # removed, the padding lanes stay put
    rng = np.random.default_rng(1)
    perm = torch.arange(x.shape[1])
    for i in rng.choice(N - 2, 40, replace=False):
        perm[[i, i + 1]] = perm[[i + 1, i]]
    xr, wr, Fr = tmg.mega_repair(x[:, perm], w[:, perm], F[:, perm], N, box, 4)
    assert _inversions(xr) < _inversions(x[:, perm])
    np.testing.assert_array_equal(_canon(xr, wr, Fr),
                                  _canon(x[:, perm], w[:, perm], F[:, perm]))
    assert torch.equal(xr[:, N:], x[:, N:])


def test_repair_comparator_is_minimum_image():
    """A particle that wrapped across x = L, among ones near x = 0, is
    cyclically just before them: the repair moves it to the front of the
    run, not through the box to the end as a linear comparator would."""
    x = torch.tensor([[0.01, 0.02, 4.995, 0.03, 0.0],
                      [1.0, 2.0, 3.0, 4.0, 0.0],
                      [0.0, 0.0, 0.0, 0.0, 0.0]])
    box = torch.full((3,), 5.0)
    z = torch.zeros_like(x)
    xr, _, _ = tmg.repair_plain(x, z, z, 4, box, 4)
    assert xr[0, :4].tolist() == pytest.approx([4.995, 0.01, 0.02, 0.03])
    assert xr[1, :4].tolist() == [3.0, 1.0, 2.0, 4.0]
    assert xr[0, 4] == 0.0  # the padding lane


# ---- the runner's megakernel path ---------------------------------------

RUNNER = dict(segment_steps=10, tm=128, tn=128, slack=0.15, sort_mode="x")


def _runner(rt, ts, units, T=120.0, **kw):
    fluid = ts.LennardJonesFluid(nparticles=N, reduced_density=0.5)
    md = units.md_unit_system
    opts = dict(RUNNER, **kw)
    r = rt.make_culled_lj_runner(
        potential=fluid.potential, n_particles=N, topology=fluid.topology,
        temperature=T * units.kelvin, megakernel=True, **opts)
    return r, fluid.positions.value_in_unit_system(md), \
        fluid.box_vectors.value_in_unit_system(md)


@pytest.fixture(scope="module")
def jax_runner_segments():
    """The JAX runner with megakernel (N=1000, rho*=0.5, S=10, tiles 128,
    slack 0.15, pure x, seed 9): init and two segments."""
    jr, pos, box = _runner(jrt, jts, ju)
    js0 = jr.init(pos, box, seed=9)
    js1 = jr.run(js0, 10)
    return jr, js0, js1, jr.run(js1, 10)


def _carry(js):
    pairs = {k: _np(v) for k, v in js.pairs._asdict().items()}
    return interop.cull_carry(_np(js.x), _np(js.v), _np(js.F), _np(js.step),
                              _np(js.box_diag), _np(js.overflowed), pairs,
                              _np(js.x_anchor), "cpu")


def test_megakernel_runner_matches_jax(jax_runner_segments):
    """Each of JAX's two segments from its carried start (the JAX runner
    steps with the approximate reciprocal, a bf16 one in interpret mode, the
    port's plain force with the exact one)."""
    jr, *states = jax_runner_segments
    tr, pos, box = _runner(trt, tts, tu, device="cpu")
    assert tr.path == "megakernel"
    tr.init(pos, box, seed=9)
    assert (tr.nslab, tr.capacity) == (jr.nslab, jr.capacity) and tr.nslab == 0
    for js, js_next in zip(states, states[1:]):
        ts = tr.run(_carry(js), 10)
        assert int(ts.step[0, 0]) == int(js_next.step[0, 0])
        assert np.abs(ts.x.numpy() - _np(js_next.x)).max() < 1e-4
        assert np.abs(ts.v.numpy() - _np(js_next.v)).max() < 1e-3
        # the list and the anchor pass through unchanged, as in JAX
        for name in ("cols", "ccx", "ptr2", "count"):
            assert torch.equal(getattr(ts.pairs, name),
                               getattr(_carry(js).pairs, name))
        np.testing.assert_array_equal(ts.x_anchor.numpy(), _np(js.x_anchor))
        assert bool(ts.overflowed) == bool(js_next.overflowed) is False
        tr.check(ts)
        e_ref = float(jr.energy(js_next))
        assert abs(float(tr.energy(ts)) - e_ref) / abs(e_ref) < 1e-5


def test_megakernel_drift_latch_fires():
    """At 300 K a slack of 0.02 nm cannot hold over a 50-step segment: the
    flag latches and check() raises (tests/test_lj_mega.py:157)."""
    tr, pos, box = _runner(trt, tts, tu, T=300.0, segment_steps=50,
                           slack=0.02, device="cpu")
    st = tr.run(tr.init(pos, box, seed=5), 50)
    with pytest.raises(RuntimeError, match="invariant violated"):
        tr.check(st)


def test_megakernel_refusals():
    """The pure-x key only (checked at the segment, once init has resolved
    the key), not with fused_rebuild, and tm = 128 tiles."""
    tr, pos, box = _runner(trt, tts, tu, device="cpu")
    st = tr.init(pos, box, seed=5)
    tr.nslab = 4  # as a slab-key layout would resolve
    with pytest.raises(ValueError, match="pure-x"):
        tr.run(st, 10)
    with pytest.raises(ValueError, match="fused_rebuild"):
        _runner(trt, tts, tu, fused_rebuild=True, device="cpu")
    with pytest.raises(ValueError, match="tm = 128"):
        _runner(trt, tts, tu, tm=64, device="cpu")
