"""The reference's wider tiles on the port's plain paths (the CPU), against
the JAX package in interpret mode at the same tiles: the culled pass at
tm 384 and 512 and at tn 768 and 1024, the megakernel at 512 x 512, the
band kernel at tm 512 and the strip kernel at tm 256 and 512; and each
factory at those tiles.  A jittered lattice at rho* 0.3 (N=2000, n_pad 2048;
N=1500, n_pad 1536 at 384 x 768; N=3000, n_pad 3072 at 128 x 1024, the
size the factory needs there), sorted by x."""

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
from chiron_tpu.ops import lj_band as jlb
from chiron_tpu.ops import lj_cull as jlc
from chiron_tpu.ops import lj_strip as jls
from chiron_tpu.ops.lj_mega import mega_md_raw
from chiron_tpu_torch import interop
from chiron_tpu_torch.ops import lj_band as tlb
from chiron_tpu_torch.ops import lj_cull as tlc
from chiron_tpu_torch.ops import lj_mega as tlm
from chiron_tpu_torch.ops import lj_strip as tls

# the LennardJonesFluid's parameters, so that the factories' runners reuse
# the kernels JAX compiled for the tests before them
_LJ = jts.LennardJonesFluid(nparticles=8).potential
SIGMA, EPS, CUTOFF = _LJ.sigma, _LJ.epsilon, _LJ.cutoff
RHO = 0.3 / SIGMA ** 3  # rho* 0.3 in nm^-3
SLACK, CAP, STEPS, SEED = 0.2, 64, 5, 3
CULL_TILES = ((512, 512, 2000), (384, 768, 1500), (128, 1024, 3000))


# JAX's list build, jitted as its runners take it (eagerly it takes some
# 4 s a tile on the CPU)
_jax_build = jax.jit(jlc.build_tile_pairs, static_argnums=(1, 2, 3, 5, 6, 7))


def _np(a):
    return np.array(a)


def _lattice(n, seed=7):
    """A jittered cubic lattice of n particles at RHO: ((n, 3) f32, L)."""
    L = (n / RHO) ** (1 / 3)
    rng = np.random.default_rng(seed)
    n_side = int(np.ceil(n ** (1 / 3)))
    g = (np.arange(n_side) + 0.5) * L / n_side
    xyz = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)[:n]
    return (xyz + rng.normal(0, 0.02, xyz.shape)).astype(np.float32) % L, L


def _md_kw(n, tm, tn):
    return dict(masses_lane=np.full(n, 39.9), dt=0.002, gamma=1.0,
                kT=0.008314 * 120, tm=tm, tn=tn, slack=SLACK)


def _culled_state(tm, tn, n):
    """Both engines at the tile, the x-sorted state, both lists and JAX's
    force and energy (exact reciprocal: interpret mode takes the
    approximate one as a bf16 reciprocal)."""
    xyz, L = _lattice(n)
    jmd = jlc.CulledLJMD(n, SIGMA, EPS, CUTOFF, **_md_kw(n, tm, tn))
    tmd = tlc.CulledLJMD(n, SIGMA, EPS, CUTOFF, **_md_kw(n, tm, tn),
                         device="cpu")
    assert jmd.n_pad == tmd.n_pad and jmd.tm == tm and jmd.tn == tn
    pos3 = np.zeros((3, jmd.n_pad), np.float32)
    pos3[:, :n] = xyz.T
    box = np.full(3, L, np.float32)
    jpos, _ = jlc.sort_by_key(jlc.slab_y_key(jnp.asarray(pos3), n, 0, L),
                              jnp.asarray(pos3), ())
    jbox = jnp.asarray(box)
    jpairs = _jax_build(jpos, n, tm, tn, jbox, CUTOFF, SLACK, CAP)
    tpos = torch.from_numpy(_np(jpos))
    tpairs = tmd.build_pairs(tpos, torch.from_numpy(box), capacity=CAP)
    jF, jE = jmd.force_energy(jpos, jbox, jpairs)
    v0 = 0.05 * jmd.sigv * jnp.ones((3, jmd.n_pad), jnp.float32)
    return dict(n=n, tm=tm, tn=tn, jmd=jmd, tmd=tmd, box=torch.from_numpy(box),
                jpos=jpos, tpos=tpos, jpairs=jpairs, tpairs=tpairs,
                jF=_np(jF), jE=float(jE), v0=torch.from_numpy(_np(v0)))


@pytest.fixture(scope="module", params=CULL_TILES,
                ids=[f"{tm}x{tn}" for tm, tn, _ in CULL_TILES])
def culled(request):
    return _culled_state(*request.param)


@pytest.fixture(scope="module")
def culled512():
    """The state at 512 x 512 and JAX's 5-step segment from it (the jitted
    kernels of the parametrised fixture's are reused)."""
    s = _culled_state(*CULL_TILES[0])
    jmd, jbox = s["jmd"], jnp.asarray(s["box"].numpy())
    s["seg"] = tuple(_np(a) for a in jmd.run_segment(
        s["jpos"], jnp.asarray(s["v0"].numpy()), jnp.asarray(s["jF"]), jbox,
        s["jpairs"], seed=SEED, step_offset=4, n_steps=STEPS,
        approx_recip=False, drift_slack=SLACK))
    return s


def test_tile_pair_list_equals_jax_at_wide_tiles(culled):
    s = culled
    for name in tlc.TilePairList._fields:
        a, b = getattr(s["tpairs"], name), _np(getattr(s["jpairs"], name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert int(s["tpairs"].count) > 0


def test_culled_force_and_energy_match_jax_at_wide_tiles(culled):
    """K4's and K5's plain versions: the force within 1e-5 of max |F|, the
    energy 1e-5 relative, the padding rows zero."""
    s = culled
    n = s["n"]
    F, E = tlc.culled_force_energy(s["tpos"], s["box"], s["tpairs"], n,
                                   s["tm"], s["tn"], SIGMA, EPS, CUTOFF)
    Fa, _ = tlc.culled_force_pass(s["tpos"], s["box"], s["tpairs"], n,
                                  s["tm"], s["tn"], SIGMA, EPS, CUTOFF,
                                  approx_recip=False)
    scale = np.abs(s["jF"]).max()
    assert np.abs(F.numpy() - s["jF"]).max() / scale < 1e-5
    assert torch.equal(F, Fa)
    assert np.abs(F[:, n:].numpy()).max() == 0.0
    assert abs(float(E) - s["jE"]) / abs(s["jE"]) < 1e-5


def test_culled_segment_matches_jax_at_512(culled512):
    """K3's 5 steps at 512 x 512 (NVT, the drift latch at the slack): x
    within 1e-5 nm, v within 1e-4, the flag equal."""
    s = culled512
    tmd = s["tmd"]
    F0 = torch.from_numpy(s["jF"])
    tx, tv, _, flag = tmd.run_segment(
        s["tpos"], s["v0"], F0, s["box"], s["tpairs"], seed=SEED,
        step_offset=4, n_steps=STEPS, approx_recip=False,
        drift_anchor=s["tpos"], drift_budget=SLACK)
    jx, jv, _, jflag = s["seg"]
    assert np.abs(tx.numpy() - jx).max() < 1e-5
    assert np.abs(tv.numpy() - jv).max() < 1e-4
    assert bool(flag) == bool(jflag)


def test_mega_segment_matches_jax_at_512(culled512):
    """K11 at 512 x 512 (P = 16): its list built from the current order
    equal to JAX's, x within 1e-5 nm, w within 1e-4, the flag equal."""
    s = culled512
    tmd, n = s["tmd"], s["n"]
    jpos = jnp.asarray(s["tpos"].numpy())
    F0 = jnp.asarray(s["jF"])
    w0 = jnp.asarray(s["v0"].numpy()) - 0.5 * tmd.dt * F0 * _np(tmd.minv)
    jx, jw, _, jflag = (_np(a) for a in mega_md_raw(
        jpos, w0, F0, jnp.asarray(s["box"].numpy()),
        jnp.asarray(SEED, jnp.int32).reshape(1, 1),
        jnp.zeros((1, 1), jnp.int32), jnp.asarray(_np(tmd.minv)),
        jnp.asarray(_np(tmd.sigv)), n, STEPS, 512, 512, SIGMA, EPS, CUTOFF,
        tmd.dt, tmd.a, tmd.b, False, True, unroll=2, slack=SLACK,
        capacity=CAP, repair_passes=16))
    pairs = tlm.tile_build(s["tpos"], n, 512, 512, s["box"], CUTOFF, SLACK,
                           CAP)
    for name in tlc.TilePairList._fields:
        np.testing.assert_array_equal(getattr(pairs, name).numpy(),
                                      _np(getattr(s["jpairs"], name)), name)
    tx, tw, _, flag = tlm.mega_segment(
        tmd, s["tpos"], torch.from_numpy(_np(w0)), torch.from_numpy(s["jF"]),
        s["box"], CAP, SEED, 0, STEPS, repair_passes=16)
    assert np.abs(tx.numpy() - jx).max() < 1e-5
    assert np.abs(tw.numpy() - jw).max() < 1e-4
    assert bool(flag) == bool(jflag[0, 0] > 0.5)


@pytest.fixture(scope="module")
def banded():
    """The x-sorted lattice (N=2000, n_pad 2048 at tm 512) and a band width
    that covers the cutoff with room."""
    n, tm = 2000, 512
    xyz, L = _lattice(n, seed=11)
    n_pad = -(-n // tm) * tm
    pos3 = np.zeros((3, n_pad), np.float32)
    pos3[:, :n] = xyz.T
    jx, _ = jlb.sort_by_x(jnp.asarray(pos3), (), n)
    W = int(jlb.band_width_needed(jx[0], n, CUTOFF + 0.3, L))
    w = int(1.2 * W)
    assert w < (n - 1) // 2
    return n, tm, w, jx, np.full((1, 3), L, np.float32)


def test_band_force_and_energy_match_jax_at_tm512(banded):
    """K6's plain version at tm 512: force p99 1e-5 and max 1e-5 of max |F|,
    the energy 1e-5 relative."""
    n, tm, w, jx, box = banded
    args = (n, w, SIGMA, EPS, CUTOFF, tm)
    jF = _np(jlb.band_force_raw(jx, jnp.asarray(box), *args, False, True))
    jF2, jE = jlb.band_force_energy_raw(jx, jnp.asarray(box), *args, False,
                                        True)
    tx, tbox = torch.from_numpy(_np(jx)), torch.from_numpy(box.reshape(3))
    F, E = tlb.band_force_energy(tx, tbox, *args)
    scale = np.abs(jF).max()
    err = np.abs(F.numpy() - jF)
    assert np.percentile(err, 99.0) / scale < 1e-5
    assert err.max() / scale < 1e-5
    assert np.abs(_np(jF2) - jF).max() / scale < 1e-5
    assert abs(float(E) - float(jE)) / abs(float(jE)) < 1e-5
    assert torch.equal(tlb.band_force(tx, tbox, *args), F)


@pytest.mark.parametrize("tm", [256, 512])
def test_strip_force_matches_jax_with_the_reference_halo(tm):
    """K7's plain version at tm 256 and 512, each with the halo the
    reference's ``set_halo`` gives (the port's sets the same): force within
    1e-5 of max |F|, energy 1e-5 relative."""
    n = 2000
    xyz, L = _lattice(n, seed=5)
    kw = dict(masses_lane=np.full(n, 39.9), dt=0.002, gamma=1.0,
              kT=0.008314 * 120, tm=tm, slack=0.2)
    jmd = jls.StripLJMD(n, SIGMA, EPS, CUTOFF, **kw)
    tmd = tls.StripLJMD(n, SIGMA, EPS, CUTOFF, **kw, device="cpu")
    assert jmd.n_pad == tmd.n_pad == 2048
    pos3 = np.full((3, jmd.n_pad), np.float32(jls._PAD_X))
    pos3[:, :n] = xyz.T
    jx, _ = jls.sort_by_key_strip(jnp.asarray(pos3), ())
    valid = np.arange(jmd.n_pad) < n
    W = int(jlb.band_width_needed(jnp.where(valid, jx[0], 3.0e38), n,
                                  CUTOFF, L)) + jmd.n_pad - n
    jmd.set_halo(W)
    tmd.set_halo(W)
    assert tmd.H == jmd.H and tmd.H >= W
    box = np.full((1, 3), L, np.float32)
    jxe = jmd.extend(jx, jnp.asarray(box[0]))
    jF = _np(jmd.force(jxe, jnp.asarray(box), approx_recip=False))
    _, jE = jmd.force_energy(jxe, jnp.asarray(box))
    txe = torch.from_numpy(_np(jxe))
    tbox = torch.from_numpy(box)
    F = tmd.force(txe, tbox, approx_recip=False)
    F2, E = tmd.force_energy(txe, tbox)
    scale = np.abs(jF).max()
    assert np.abs(F.numpy() - jF).max() / scale < 1e-5
    assert torch.equal(F, F2)
    assert abs(float(E) - float(jE)) / abs(float(jE)) < 1e-5


@pytest.mark.parametrize("n_pad, tm, H", [(1536, 128, 200), (1536, 384, 160),
                                          (2048, 512, 512)])
def test_strip_kernel_candidates_take_each_slot_at_any_halo(n_pad, tm, H):
    """chip_smoke.py's replica of K7's candidate ranks, at a halo that tm
    does not divide (the reference's rounding to 2048-wide strips gives such
    halos at tm 384) and at tm 512: every slot of the plain pass, taken
    exactly twice, once from each end."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    n_ext = n_pad + H
    q, j, take = cs._strip_candidates(n_pad, tm, H)
    q, j = q[take], j[take]
    ahead, wrapped = j > q, j < 0
    row = torch.where(ahead, q, torch.where(wrapped, j + n_pad, j))
    col = torch.where(ahead, j, torch.where(wrapped, q + n_pad, q))
    rid, cid, tri = tls.strip_slots(n_pad, tm, H)
    want = torch.sort((rid[:, :, None] * n_ext
                       + cid[:, None, :])[:, ~tri].reshape(-1)).values
    keys, counts = torch.unique(row * n_ext + col, return_counts=True)
    assert torch.equal(keys, want) and bool((counts == 2).all())
    assert bool(((q == row) ^ (q == col % n_pad)).all())


# ---- the factories at the wide tiles -------------------------------------


def _setup(factory, ts, units, n, rho, jitter=False, **kw):
    """``factory``'s runner for a LennardJonesFluid of n particles at rho*,
    the fluid's lattice, with ``jitter`` moved by up to some 0.05 nm (no
    two particles share an x, so that the culled runners' sorts and the
    repair order them alike in both packages), and its box."""
    fluid = ts.LennardJonesFluid(nparticles=n, reduced_density=rho)
    md = units.md_unit_system
    r = factory(potential=fluid.potential, n_particles=n,
                topology=fluid.topology, temperature=120.0 * units.kelvin,
                **kw)
    box = fluid.box_vectors.value_in_unit_system(md)
    pos = fluid.positions.value_in_unit_system(md)
    if jitter:
        # one f32 array and box for both packages
        box = np.asarray(box, np.float32)
        rng = np.random.default_rng(13)
        pos = np.asarray(pos, np.float64) + rng.normal(0, 0.02, (n, 3))
        pos = (pos % float(box[0, 0])).astype(np.float32)
    return r, pos, box


# (tm, tn, N, rho*): the x-shift bound (a tile's x extent under half the
# box less the reach) holds at 512 x 512 with N=2000 at rho* 0.2 (each tile
# a quarter of the x-sorted system) with room for the jitter; a column tile
# of 1024 needs N=3000 (a third)
FACTORY_TILES = ((512, 512, 2000, 0.2), (128, 1024, 3000, 0.3))


def _culled_runner(rt, ts, units, tm, tn, n, rho, **kw):
    return _setup(rt.make_culled_lj_runner, ts, units, n, rho, jitter=True,
                  segment_steps=STEPS, tm=tm, tn=tn, slack=0.3,
                  sort_mode="x", **kw)


def _cull_carry(js):
    pairs = {k: _np(v) for k, v in js.pairs._asdict().items()}
    return interop.cull_carry(_np(js.x), _np(js.v), _np(js.F), _np(js.step),
                              _np(js.box_diag), _np(js.overflowed), pairs,
                              _np(js.x_anchor), "cpu")


@pytest.fixture(scope="module")
def jax_culled_runners():
    """JAX's culled runner (default path, pure x) at each of FACTORY_TILES,
    made on first use: its init and, at 512 x 512, one segment from it."""
    runners = {}

    def get(i):
        if i not in runners:
            tm, tn, n, rho = FACTORY_TILES[i]
            jr, pos, box = _culled_runner(jrt, jts, ju, tm, tn, n, rho)
            js0 = jr.init(pos, box, seed=9)
            js1 = jr.run(js0, STEPS) if i == 0 else None
            runners[i] = (tm, tn, n, rho), jr, js0, js1
        return runners[i]

    return get


def _columns(c, n):
    """The live (x, v) columns of a carry in lexicographic order."""
    m = np.concatenate([_np(c.x)[:, :n], _np(c.v)[:, :n]])
    return m[:, np.lexsort(m[::-1])]


@pytest.mark.parametrize("tile, path", [
    (0, "default"), (0, "fused_rebuild"), (0, "megakernel"), (1, "default")],
    ids=["512x512-default", "512x512-fused_rebuild", "512x512-megakernel",
         "128x1024-default"])
def test_culled_factories_match_jax_at_wide_tiles(jax_culled_runners, tile,
                                                  path):
    """Each culled path's factory at the tile: the path, the layout, the
    capacity, the sorted start and its list as JAX's runner's; one segment
    from JAX's start, check() clean, and at 512 x 512 within the runners'
    tolerances (x 1e-4 nm, v 1e-3) of JAX's default segment (the
    megakernel's, built from the sorted order and repaired after its steps,
    as a permutation of it; the other paths' list equal), the energy 1e-5
    relative.  The live lanes are compared: K10's network permutes the
    padding lanes (equal keys)."""
    (tm, tn, n, rho), jr, js0, js1 = jax_culled_runners(tile)
    kw = {"default": {}, "fused_rebuild": dict(fused_rebuild=True),
          "megakernel": dict(megakernel=True)}[path]
    tr, tpos, tbox = _culled_runner(trt, tts, tu, tm, tn, n, rho,
                                    device="cpu", **kw)
    assert tr.path == path and (tr.md.tm, tr.md.tn) == (tm, tn)
    ts0 = tr.init(tpos, tbox, seed=9)
    assert (tr.nslab, tr.capacity, tr.md.n_pad) == (jr.nslab, jr.capacity,
                                                    jr.md.n_pad)
    np.testing.assert_array_equal(ts0.x.numpy(), _np(js0.x))
    for name in tlc.TilePairList._fields:
        np.testing.assert_array_equal(getattr(ts0.pairs, name).numpy(),
                                      _np(getattr(js0.pairs, name)), name)
    ts1 = tr.run(_cull_carry(js0), STEPS)
    tr.check(ts1)
    assert int(ts1.step[0, 0]) == STEPS
    if js1 is None:
        assert torch.isfinite(tr.energy(ts1))
        return
    if path == "megakernel":
        diff = np.abs(_columns(ts1, n) - _columns(js1, n))
        assert diff[:3].max() < 1e-4 and diff[3:].max() < 1e-3
    else:
        assert np.abs(ts1.x.numpy() - _np(js1.x))[:, :n].max() < 1e-4
        assert np.abs(ts1.v.numpy() - _np(js1.v))[:, :n].max() < 1e-3
        for name in ("cols", "ccx", "ptr2", "count"):
            np.testing.assert_array_equal(getattr(ts1.pairs, name).numpy(),
                                          _np(getattr(js1.pairs, name)), name)
    assert bool(ts1.overflowed) == bool(js1.overflowed) is False
    e_ref = float(jr.energy(js1))
    assert abs(float(tr.energy(ts1)) - e_ref) / abs(e_ref) < 1e-5


def test_band_factory_matches_jax_at_tm512():
    """``make_band_lj_runner(tm=512)``: the band width, n_pad and the dense
    op's n_pad as JAX's, the sorted start equal, 5 steps clean (N=2000 at
    rho* 0.1, where the band at tm 512 stays under half the system)."""
    jr, jpos, jbox = _setup(jrt.make_band_lj_runner, jts, ju, 2000, 0.1,
                            tm=512)
    tr, tpos, tbox = _setup(trt.make_band_lj_runner, tts, tu, 2000, 0.1,
                            tm=512, device="cpu")
    js = jr.init(jpos, jbox, seed=3)
    ts = tr.init(tpos, tbox, seed=3)
    assert tr.band.tm == 512 and tr.band.w == jr.band.w
    assert tr.n_pad == jr.band.n_pad == tr.dense.n_pad == jr.dense.n_pad
    np.testing.assert_array_equal(ts.x.numpy(), _np(js.x))
    ts = tr.run(ts, STEPS)
    tr.check(ts)
    assert torch.isfinite(tr.energy(ts))


@pytest.mark.parametrize("tm, n", [(256, 2000), (512, 4000)])
def test_strip_factory_matches_jax_at_wide_tiles(tm, n):
    """``make_strip_lj_runner`` at tm 256 and 512 (rho* 0.1): the halo and
    n_pad as JAX's, the sorted and extended start equal and its force within
    0.05 (a pair at the cutoff may flip), 5 steps clean.  The runner's halo
    is the band with headroom plus a tile, rounded up to tm, and n_pad must
    hold twice the strip: at tm 512 that takes N=4000 at this density (at
    rho* 0.8, N=8000)."""
    kw = dict(segment_steps=STEPS, tm=tm)
    jr, jpos, jbox = _setup(jrt.make_strip_lj_runner, jts, ju, n, 0.1, **kw)
    tr, tpos, tbox = _setup(trt.make_strip_lj_runner, tts, tu, n, 0.1, **kw,
                            device="cpu")
    js = jr.init(jpos, jbox, seed=3)
    ts = tr.init(tpos, tbox, seed=3)
    assert tr.md.tm == tm and tr.md.H == jr.md.H
    assert tr.md.n_pad == jr.md.n_pad
    np.testing.assert_array_equal(ts.x.numpy(), _np(js.x))
    assert np.abs(ts.F.numpy() - _np(js.F)).max() < 0.05
    ts = tr.run(ts, STEPS)
    tr.check(ts)
    assert torch.isfinite(tr.energy(ts))
