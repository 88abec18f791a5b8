"""The port's culled engine (plain versions on the CPU) against the JAX
package's list layer and kernels in interpret mode, on the sorted_system
fixture of tests/test_lj_cull.py (N=1000, L=5, tiles 8 x 16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiron_tpu.ops import lj_cull as jlc
from chiron_tpu_torch.ops import lj_cull as tlc

N = 1000  # not a tile multiple: exercises padding and masking
SIGMA, EPS, CUTOFF = 0.34, 0.99579, 1.02
L = 5.0
TM, TN = 8, 16
SLACK = 0.2
MD_KW = dict(masses_lane=np.full(N, 39.9), dt=0.002, gamma=1.0,
             kT=0.008314 * 120, tm=TM, tn=TN, slack=SLACK)


def _np(a):
    return np.asarray(a)


@pytest.fixture(scope="module", params=[10, 0], ids=["nslab10", "nslab0"])
def sorted_system(request):
    """Jittered lattice sorted by the (x-slab, y) key or by x, in both
    packages; returns both engines, the sorted positions, the permutations
    and a list built by each."""
    nslab = request.param
    rng = np.random.default_rng(7)
    n_side = int(np.ceil(N ** (1 / 3)))
    g = (np.arange(n_side) + 0.5) * L / n_side
    xyz = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)[:N]
    xyz = (xyz + rng.normal(0, 0.02, xyz.shape)).astype(np.float32) % L
    jmd = jlc.CulledLJMD(N, SIGMA, EPS, CUTOFF, **MD_KW)
    tmd = tlc.CulledLJMD(N, SIGMA, EPS, CUTOFF, **MD_KW, device="cpu")
    assert jmd.n_pad == tmd.n_pad
    pos3 = np.zeros((3, jmd.n_pad), np.float32)
    pos3[:, :N] = xyz.T
    iota = np.arange(jmd.n_pad, dtype=np.int32)
    jkey = jlc.slab_y_key(jnp.asarray(pos3), N, nslab=nslab, L=L)
    jpos, (jperm,) = jlc.sort_by_key(jkey, jnp.asarray(pos3), (jnp.asarray(iota),))
    tkey = tlc.slab_y_key(torch.from_numpy(pos3), N, nslab=nslab, L=L)
    tpos, (tperm,) = tlc.sort_by_key(tkey, torch.from_numpy(pos3),
                                     (torch.from_numpy(iota),))
    box = np.full(3, L, np.float32)
    jpairs = jmd.build_pairs(jpos, jnp.asarray(box), capacity=8192)
    tpairs = tmd.build_pairs(tpos, torch.from_numpy(box), capacity=8192)
    return dict(nslab=nslab, jmd=jmd, tmd=tmd, box=box, jkey=jkey, tkey=tkey,
                jpos=jpos, tpos=tpos, jperm=jperm, tperm=tperm,
                jpairs=jpairs, tpairs=tpairs)


def test_sort_key_and_stable_permutation_equal(sorted_system):
    s = sorted_system
    np.testing.assert_array_equal(s["tkey"].numpy(), _np(s["jkey"]))
    np.testing.assert_array_equal(s["tperm"].numpy(), _np(s["jperm"]))
    np.testing.assert_array_equal(s["tpos"].numpy(), _np(s["jpos"]))


def test_tile_bboxes_equal(sorted_system):
    s = sorted_system
    box = s["box"]
    for tile in (TM, TN):
        jc, jh = jlc.tile_bboxes(s["jpos"], N, tile, jnp.asarray(box))
        tc, th = tlc.tile_bboxes(s["tpos"], N, tile, torch.from_numpy(box))
        np.testing.assert_array_equal(tc.numpy(), _np(jc))
        np.testing.assert_array_equal(th.numpy(), _np(jh))


def test_tile_pair_list_equal(sorted_system):
    s = sorted_system
    jp, tp = s["jpairs"], s["tpairs"]
    for name in ("rows", "cols", "ccx", "ptr2", "rowcx", "count"):
        a, b = getattr(tp, name), _np(getattr(jp, name))
        assert a.shape == b.shape, name
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert bool(tp.overflowed) == bool(jp.overflowed) is False
    n_pad = s["tmd"].n_pad
    assert 0 < int(tp.count[0, 0]) < (n_pad // TM) * (n_pad // TN)


@pytest.mark.parametrize("capacity", [3, 40])
def test_capacity_overflow_flagged(sorted_system, capacity):
    s = sorted_system
    jp = s["jmd"].build_pairs(s["jpos"], jnp.asarray(s["box"]), capacity)
    tp = s["tmd"].build_pairs(s["tpos"], torch.from_numpy(s["box"]), capacity)
    assert bool(tp.overflowed) and bool(jp.overflowed)
    for name in ("rows", "cols", "ccx", "ptr2", "count"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      _np(getattr(jp, name)), err_msg=name)


def test_shift_bound_violation_flagged():
    small_L = 2.3 * CUTOFF
    rng = np.random.default_rng(3)
    xyz = rng.uniform(0, small_L, size=(64, 3)).astype(np.float32)
    pos3 = np.zeros((3, 128), np.float32)
    pos3[:, :64] = xyz.T
    box = np.full(3, small_L, np.float32)
    tp = tlc.build_tile_pairs(torch.from_numpy(pos3), 64, 8, 128,
                              torch.from_numpy(box), CUTOFF, 0.2, 512)
    jp = jlc.build_tile_pairs(jnp.asarray(pos3), 64, 8, 128,
                              jnp.asarray(box), CUTOFF, 0.2, 512)
    assert bool(tp.overflowed) and bool(jp.overflowed)


def test_culled_force_matches_jax_kernel(sorted_system):
    s = sorted_system
    box = s["box"]
    F_ref = _np(s["jmd"].force(s["jpos"], jnp.asarray(box), s["jpairs"],
                               approx_recip=False))
    F = s["tmd"].force(s["tpos"], torch.from_numpy(box), s["tpairs"],
                       approx_recip=False).numpy()
    scale = np.abs(F_ref).max()
    err = np.abs(F[:, :N] - F_ref[:, :N])
    # cutoff-boundary pairs may flip between arithmetic orders (each flip
    # moves a force by at most |coef(rc)| rc ~ 0.033); all other pairs match
    # to float precision
    assert err.max() < 0.05
    assert np.percentile(err, 99.0) / scale < 1e-5
    assert np.abs(F[:, N:]).max() == 0.0


def test_culled_energy_matches_jax_kernel(sorted_system):
    s = sorted_system
    box = s["box"]
    _, E_ref = s["jmd"].force_energy(s["jpos"], jnp.asarray(box), s["jpairs"])
    _, E = tlc.culled_force_pass(
        s["tpos"], torch.from_numpy(box), s["tpairs"], N, TM, TN, SIGMA, EPS,
        CUTOFF, approx_recip=False, with_energy=True)
    assert abs(float(E) - float(E_ref)) / abs(float(E_ref)) < 1e-5


def _jax_stream(seed, step, n_pad):
    """The JAX kernel's counters and noise, as tests/test_lj_cull.py
    mirrors them."""
    half = n_pad // 2
    lane = (jnp.arange(3, dtype=jnp.uint32)[:, None] * jnp.uint32(half)
            + jnp.arange(half, dtype=jnp.uint32)[None, :])
    # the kernel reads seed and step as int32 and casts them to uint32
    seed = jnp.asarray(seed, jnp.int32).astype(jnp.uint32)
    step = jnp.asarray(step, jnp.int32).astype(jnp.uint32)
    base = seed * jnp.uint32(0x9E3779B9) + step * jnp.uint32(0x85EBCA6B)

    def mix(z):
        z = z ^ (z >> 16)
        z = z * jnp.uint32(0x85EBCA6B)
        z = z ^ (z >> 13)
        z = z * jnp.uint32(0xC2B2AE35)
        return z ^ (z >> 16)

    c1 = (lane * jnp.uint32(2)) * jnp.uint32(0x9E3779B9) + base
    c2 = (lane * jnp.uint32(2) + jnp.uint32(1)) * jnp.uint32(0x9E3779B9) + base
    u1 = (mix(c1) >> 8).astype(jnp.int32).astype(jnp.float32) * (1.0 / 16777216.0)
    u2 = (mix(c2) >> 8).astype(jnp.int32).astype(jnp.float32) * (1.0 / 16777216.0)
    u1 = jnp.maximum(u1, 1e-7)
    r = jnp.sqrt(-2.0 * jnp.log(u1))
    theta = 6.2831853071795864 * u2
    noise = jnp.concatenate([r * jnp.cos(theta), r * jnp.sin(theta)], axis=1)
    return c1, c2, mix(c1), mix(c2), noise


@pytest.mark.parametrize("seed, step", [(11, 0), (1234, 39), (-7, 2 ** 31 - 3),
                                        (2 ** 31 - 1, 123456)])
def test_splitmix_stream_matches_jax(seed, step):
    n_pad = 1024
    jc1, jc2, jm1, jm2, jnoise = _jax_stream(seed, step, n_pad)
    c1, c2 = tlc.splitmix_counters(seed, step, n_pad)
    for a, b in ((c1, jc1), (c2, jc2), (tlc._mix32(c1), jm1),
                 (tlc._mix32(c2), jm2)):
        np.testing.assert_array_equal(a.numpy(), _np(b).astype(np.int64))
    noise = tlc.splitmix_noise_plain(seed, step, n_pad)
    assert np.abs(noise.numpy() - _np(jnoise)).max() < 1e-6


def test_two_step_segment_matches_jax(sorted_system):
    s = sorted_system
    box = s["box"]
    jmd, tmd = s["jmd"], s["tmd"]
    F0 = jmd.force(s["jpos"], jnp.asarray(box), s["jpairs"], approx_recip=False)
    rng = np.random.default_rng(5)
    v0 = (rng.normal(0, 0.3, (3, jmd.n_pad))).astype(np.float32)
    jx, jv, jF, jstale = jmd.run_segment(
        s["jpos"], jnp.asarray(v0), F0, jnp.asarray(box), s["jpairs"], seed=11,
        step_offset=5, n_steps=2, approx_recip=False, drift_slack=SLACK)
    tx, tv, tF, tstale = tmd.run_segment(
        s["tpos"], torch.from_numpy(v0), torch.from_numpy(np.array(F0)),
        torch.from_numpy(box), s["tpairs"], seed=11, step_offset=5, n_steps=2,
        approx_recip=False, drift_slack=SLACK)
    assert np.abs(tx.numpy() - _np(jx)).max() < 1e-5
    assert np.abs(tv.numpy() - _np(jv)).max() < 1e-4
    assert np.abs(tF.numpy() - _np(jF)).max() < 0.05
    assert bool(tstale) == bool(jstale)


def test_stale_anchor_and_nan_latch(sorted_system):
    """A hand-made stale anchor trips the latch; so does a NaN, in the port
    and in the JAX kernel's in-segment check."""
    s = sorted_system
    box = torch.from_numpy(s["box"])
    x = s["tpos"]
    assert not bool(tlc.tile_skin_drift_bad(x, x.clone(), N, SLACK, box))
    anchor = x.clone()
    anchor[0, 3] += 0.6 * SLACK
    assert not bool(tlc.tile_skin_drift_bad(x, anchor, N, SLACK, box))
    anchor[1, 700] -= 0.6 * SLACK
    assert bool(tlc.tile_skin_drift_bad(x, anchor, N, SLACK, box))
    # the two-tied-lanes rule: two equal drifts of 0.55 slack sum past it
    tied = x.clone()
    tied[2, 10] += 0.55 * SLACK
    tied[2, 20] += 0.55 * SLACK
    assert bool(tlc.tile_skin_drift_bad(x, tied, N, SLACK, box))
    poisoned = x.clone()
    poisoned[0, 5] = float("nan")
    assert bool(tlc.tile_skin_drift_bad(poisoned, x, N, SLACK, box))
    # padding lanes are not live: a NaN there does not latch
    padded = x.clone()
    padded[0, N + 1] = float("nan")
    assert not bool(tlc.tile_skin_drift_bad(padded, x, N, SLACK, box))


# ---------------------------------------------------------------------------
# The culled kernel's work items and scratch layout (csrc/lj_cull_force.cu)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tn", [16, 48, 64, 128, 256, 320, 512])
def test_cull_slices_partition_the_column_tile(tn):
    covered = np.zeros(tn, np.int64)
    for c0, width in tlc.cull_slices(tn):
        assert 0 < width <= tlc.CULL_SLICE and width % 16 == 0
        covered[c0:c0 + width] += 1
    assert (covered == 1).all()


def _check_items_cover_the_list(pairs, n_pad, tm, tn):
    """Every listed (entry, column) pair is taken by exactly one block of the
    capacity x S grid, and each row tile's range of row-partial slots
    [ptr2[2i] S, ptr2[2i+2] S), which the gather sums, holds exactly the
    items of that tile's entries."""
    cap = pairs.cols.shape[1]
    count = int(pairs.count)
    slices = tlc.cull_slices(tn)
    S = len(slices)
    # block b of the capacity x S grid takes slice b % S of entry b // S
    item = torch.arange(cap * S)
    k, s = item // S, item % S
    assert count > 0
    seen = np.zeros((count, tn), np.int64)
    for kk, ss in zip(k.tolist(), s.tolist()):
        if kk < count:
            c0, width = slices[ss]
            seen[kk, c0:c0 + width] += 1
    assert (seen == 1).all()
    rows = pairs.rows[0].numpy()
    ptr2 = pairs.ptr2[0].numpy()
    live = k.numpy() < count
    tile = np.where(live, rows[np.minimum(k.numpy(), cap - 1)], -1)
    items = np.arange(cap * S)
    for i in range(n_pad // tm):
        in_range = (items >= ptr2[2 * i] * S) & (items < ptr2[2 * i + 2] * S)
        np.testing.assert_array_equal(in_range, tile == i)
    _, P, R, e_part, energy = tlc.cull_buffers(n_pad, tm, tn, cap, True, "cpu")
    assert P.shape == (cap * S, 3, tm) and R.shape == (cap, 3, tn)
    assert e_part.shape == (cap * S,) and energy.shape == (1,)


def test_cull_items_cover_the_fixture_list(sorted_system):
    s = sorted_system
    _check_items_cover_the_list(s["tpairs"], s["tmd"].n_pad, TM, TN)


@pytest.mark.parametrize("tm, tn", [(128, 256), (256, 256), (64, 192),
                                   (16, 64)])
def test_cull_items_cover_a_bench_density_list(tm, tn):
    """The main path's shape (N=4000, rho*=0.8, tiles 128 x 256), F2's row
    tile of 256, and ragged slices."""
    from chiron_tpu_torch.testsystems import LennardJonesFluid
    from chiron_tpu_torch.units import md_unit_system

    n = 4000
    fluid = LennardJonesFluid(nparticles=n, reduced_density=0.8)
    rng = np.random.default_rng(3)
    box = fluid.box_vectors.value_in_unit_system(md_unit_system)
    L_box = float(box[0, 0])
    pos = fluid.positions.value_in_unit_system(md_unit_system)
    pos = (pos + rng.normal(0, 0.02, pos.shape)).astype(np.float32) % L_box
    n_pad = -(-n // np.lcm(tm, tn)) * np.lcm(tm, tn)
    pos3 = torch.zeros((3, n_pad))
    pos3[:, :n] = torch.from_numpy(pos.T)
    box_diag = torch.full((3,), L_box)
    key = tlc.slab_y_key(pos3, n, 0, L_box)
    xs, _ = tlc.sort_by_key(key, pos3, ())
    cap = (n_pad // tm) * (n_pad // tn)
    pairs = tlc.build_tile_pairs(xs, n, tm, tn, box_diag, CUTOFF, 0.15, cap)
    assert not bool(pairs.overflowed)
    _check_items_cover_the_list(pairs, n_pad, tm, tn)


def test_cull_kernel_takes_a_row_tile_of_256():
    """F2: the kernel's guard takes tm = 256 and still refuses others."""
    tlc.check_cull_tiles(4096, 256, 256)
    for tm, tn in ((512, 256), (8, 16), (128, 24), (128, 1024)):
        with pytest.raises(ValueError, match="culled force kernel"):
            tlc.check_cull_tiles(4096, tm, tn)
