"""Particle-axis sharding (``chiron_tpu_torch/parallel/spatial.py``) on the CPU
at world size 1, against the JAX package on one CPU device with Pallas in
interpret mode: the plain versions of K8a and K8b against the JAX kernels,
K2, ``make_sharded_lj_force``, and both spatial runners with JAX's noise
injected.  Small sizes (N <= 512, tm 8), as the JAX tests use."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import chiron_tpu.parallel.spatial as js
import chiron_tpu.testsystems as jts
import chiron_tpu.units as ju
import chiron_tpu_torch.parallel.spatial as ts
import chiron_tpu_torch.testsystems as tts
import chiron_tpu_torch.units as tu
from chiron_tpu.ops.lj_band import band_width_needed, sort_by_x
from chiron_tpu.ops.lj_dense import LJDensePallas
from chiron_tpu_torch import interop
from chiron_tpu_torch.ops.lj_dense import LJDense
from chiron_tpu_torch.parallel import make_replica_mesh
from chiron_tpu_torch.topology import Topology

SIGMA, EPS, CUTOFF = 0.34, 0.99579, 1.02
TM = 8


def _np(a):
    return np.array(a)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(a, b):
    """Max abs difference over the max magnitude of b."""
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _jmesh(axis):
    return JaxMesh(np.array(jax.devices()[:1]), (axis,))


def _tmesh(axis):
    return make_replica_mesh(axis_name=axis, device="cpu")


def _jittered(n, rho, seed=1):
    """A jittered-lattice fluid: (N, 3) f32 positions and the box length."""
    fluid = tts.LennardJonesFluid(nparticles=n, reduced_density=rho)
    md = tu.md_unit_system
    L = float(fluid.box_vectors.value_in_unit_system(md)[0, 0])
    pos = fluid.positions.value_in_unit_system(md)
    rng = np.random.default_rng(seed)
    return ((pos + rng.normal(0, 0.03, pos.shape)) % L).astype(np.float32), L


# ---------------------------------------------------------------------------
# K8a, K8b and K2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_energy", [False, True])
def test_row_slab_plain_matches_jax_kernel(with_energy):
    """K8a's plain version against ``_make_row_slab_force`` on the slabs of
    a 4-device layout: the first, a middle one and the last (which holds
    the padding)."""
    n, n_dev = 200, 4
    n_pad = js._spatial_padding(n, n_dev, TM)
    assert ts._spatial_padding(n, n_dev, TM) == n_pad == 224
    r = n_pad // n_dev
    x, L = _jittered(n, 0.8)
    pos3 = np.zeros((3, n_pad), np.float32)
    pos3[:, :n] = x.T
    box = np.full((1, 3), L, np.float32)
    kernel = js._make_row_slab_force(n, n_pad, r, TM, SIGMA, EPS, CUTOFF,
                                     True, with_energy=with_energy)
    for off in (0, 2 * r, 3 * r):
        out = kernel(jnp.asarray(pos3[:, off:off + r]), jnp.asarray(pos3),
                     jnp.asarray(box), jnp.full((1, 1), off, jnp.int32))
        Fj, Ej = (out if with_energy else (out, None))
        Ft, Et = ts.row_slab_force(_t(pos3[:, off:off + r]), _t(pos3),
                                   _t(box), off, n, SIGMA, EPS, CUTOFF,
                                   with_energy)
        assert Ft.shape == (3, r)
        assert _rel(Ft.numpy(), _np(Fj)) < 1e-5
        if off == 3 * r:  # the padding rows take no force
            assert float(Ft[:, n - off:].abs().max()) == 0.0
        if with_energy:
            assert Et.dtype == torch.float32
            assert abs(float(Et) - float(Ej)) / abs(float(Ej)) < 1e-5
        else:
            assert Et is None


def _band_layout(n, n_pad, L, seed, boundary=False):
    """The inputs of tests/test_spatial_runner.py:212-296: random x-sorted
    points and a band 8 ranks above the width they need."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, L, size=(3, n_pad)).astype(np.float32)
    if boundary:  # in-cutoff pairs across the periodic x boundary
        x[0, :6] = rng.uniform(0, 0.2, 6)
        x[0, 6:12] = rng.uniform(L - 0.2, L, 6)
    x3s, _ = sort_by_x(jnp.asarray(x), (), n)
    key = jnp.where(jnp.arange(n_pad) < n, x3s[0], jnp.float32(3e38))
    w = int(band_width_needed(key, n, CUTOFF + 0.3, L)) + 8
    return _np(x3s), w


@pytest.mark.parametrize("case", ["selective", "padding_gap"])
def test_row_band_plain_matches_jax_kernel(case):
    """K8b's plain version (the band rule on every pair) against
    ``_make_row_band_force``'s tile window: a band much narrower than n,
    and a padding gap of several tiles, whose wrap-around pairs only a
    window over the whole padded distance reaches.  Whole layout and
    4 slabs."""
    if case == "selective":
        n, n_pad, seed, rho = 500, 512, 8, 0.05
        boundary = False
    else:
        n, n_pad, seed, rho = 450, 512, 1, 0.1
        boundary = True
    L = (n / rho) ** (1 / 3) * SIGMA
    x3s, w = _band_layout(n, n_pad, L, seed, boundary)
    assert w < n // 2
    box = np.full((1, 3), L, np.float32)
    for rows in (n_pad, n_pad // 4):
        kernel = js._make_row_band_force(n, n_pad, rows, TM, w, SIGMA, 0.99,
                                         CUTOFF, interpret=True)
        for off in range(0, n_pad, rows):
            Fj = _np(kernel(jnp.asarray(x3s), jnp.asarray(box),
                            jnp.full((1, 1), off, jnp.int32)))
            Ft = ts.row_band_force(_t(x3s), _t(box), off, rows, n, w, TM,
                                   SIGMA, 0.99, CUTOFF)
            assert Ft.shape == (3, rows)
            assert _rel(Ft.numpy(), Fj) < 1e-5
    K, nbt = ts.band_window(n, n_pad, TM, w)
    assert nbt < n_pad // TM  # the window is genuinely narrower than n_pad


def test_k2_dense_square_matches_jax():
    n = 200
    x, L = _jittered(n, 0.8)
    box = np.eye(3, dtype=np.float32) * L
    jop = LJDensePallas(n, SIGMA, EPS, CUTOFF, tm=TM, tn=TM, triangle=False)
    top = LJDense(n, SIGMA, EPS, CUTOFF, tm=TM, tn=TM, triangle=False,
                  device="cpu")
    assert not top.triangle and top.n_pad == jop.n_pad
    Fj, Ej = jop.force_energy(jnp.asarray(x), jnp.asarray(box))
    Ft, Et = top.force_energy(x, box)
    assert _rel(Ft.numpy(), _np(Fj)) < 1e-5
    assert abs(float(Et) - float(Ej)) / abs(float(Ej)) < 1e-5


def test_sharded_force_matches_jax():
    n = 200
    x, L = _jittered(n, 0.8)
    jf = js.make_sharded_lj_force(_jmesh("replica"), n, SIGMA, EPS, CUTOFF,
                                  tm=TM, interpret=True)
    tf = ts.make_sharded_lj_force(_tmesh("replica"), n, SIGMA, EPS, CUTOFF,
                                  tm=TM)
    assert (tf.n_pad, tf.rows_per_dev) == (jf.n_pad, jf.rows_per_dev)
    assert not tf.op.triangle and tf.op.n_pad == tf.n_pad
    bd = np.full((1, 3), L, np.float32)
    jp = jf.op.pad_positions(jnp.asarray(x))
    tp = tf.op.pad_positions(x)
    F = tf(tp, _t(bd))
    assert F.shape == (3, tf.n_pad)
    assert _rel(F.numpy(), _np(jf(jp, jnp.asarray(bd)))) < 1e-5
    Ffe, E = tf.force_energy(tp, _t(bd))
    assert torch.equal(Ffe, F)
    _, Ej = jf.force_energy(jp, jnp.asarray(bd))
    assert abs(float(E) - float(Ej)) / abs(float(Ej)) < 1e-5
    # the energy of K2 on the same padding
    assert abs(float(E) - float(tf.op.force_energy_t(tp, _t(bd))[1])) \
        / abs(float(E)) < 1e-5
    # grad(energy) == -force exactly
    p = tp.clone().requires_grad_(True)
    tf.energy_differentiable(p, _t(bd)).backward()
    assert torch.equal(p.grad, -Ffe)


# ---------------------------------------------------------------------------
# The runners, with JAX's noise injected
# ---------------------------------------------------------------------------


def _setup(pkg_rt, pkg_ts, pkg_units, mesh, n, rho, band, **kw):
    fluid = pkg_ts.LennardJonesFluid(nparticles=n, reduced_density=rho)
    md = pkg_units.md_unit_system
    make = (pkg_rt.make_spatial_band_lj_runner if band
            else pkg_rt.make_spatial_lj_runner)
    r = make(mesh, fluid.potential, n, temperature=120.0 * pkg_units.kelvin,
             timestep=2.0 * pkg_units.femtoseconds, topology=fluid.topology,
             tm=TM, **kw)
    return (r, fluid.positions.value_in_unit_system(md),
            fluid.box_vectors.value_in_unit_system(md))


def _jax_noise(key, step, n_pad):
    return _np(jax.random.normal(jax.random.fold_in(key, step), (3, n_pad),
                                 jnp.float32))


N_DENSE = 250


@pytest.fixture(scope="module")
def dense_runners():
    jr, pos, box = _setup(js, jts, ju, _jmesh("spatial"), N_DENSE, 0.4,
                          False, interpret=True)
    tr, tpos, tbox = _setup(ts, tts, tu, _tmesh("spatial"), N_DENSE, 0.4,
                            False)
    return jr, jr.init(pos, box, seed=42), tr, tr.init(tpos, tbox, seed=42)


def test_spatial_runner_init_matches_jax(dense_runners):
    jr, jc, tr, tc = dense_runners
    assert tr.n_pad == jr.n_pad == 256 and tr.rows_per_dev == jr.rows_per_dev
    np.testing.assert_array_equal(tc.x.numpy(), _np(jc.x))
    assert _rel(tc.F.numpy(), _np(jc.F)) < 1e-5
    # padding lanes take velocities (mass 1), and no force
    assert float(tc.v[:, N_DENSE:].abs().min()) > 0.0
    assert float(tc.F[:, N_DENSE:].abs().max()) == 0.0
    v = np.linspace(-1, 1, N_DENSE * 3, dtype=np.float32).reshape(N_DENSE, 3)
    tv = tr.init(tr.positions(tc).numpy(), tc.box_diag, velocities=v)
    np.testing.assert_array_equal(tr.velocities(tv).numpy(), v)
    assert float(tv.v[:, N_DENSE:].abs().max()) == 0.0


def test_spatial_runner_ten_steps_with_jax_noise(dense_runners):
    jr, jc, tr, _ = dense_runners
    state = interop.spatial_carry(jc, "cpu")
    for s in range(10):
        state = tr.step(state, _t(_jax_noise(jc.key, s, tr.n_pad)))
    j10 = jr.run(jc, 10)
    assert state.step == int(_np(j10.step)[0, 0]) == 10
    assert np.abs(state.x.numpy() - _np(j10.x)).max() < 1e-5
    assert np.abs(state.v.numpy() - _np(j10.v)).max() < 1e-4
    e_ref = float(jr.energy(j10))
    assert abs(float(tr.energy(state)) - e_ref) / abs(e_ref) < 1e-5
    assert tr.positions(state).shape == (N_DENSE, 3)
    # run draws the same count of steps from the generator
    out = tr.run(interop.spatial_carry(jc, "cpu"), 3)
    assert out.step == 3 and torch.isfinite(out.x).all()


N_BAND, RHO_BAND, S_BAND = 500, 0.05, 5


@pytest.fixture(scope="module")
def band_runners():
    jr, pos, box = _setup(js, jts, ju, _jmesh("spatial"), N_BAND, RHO_BAND,
                          True, segment_steps=S_BAND, interpret=True)
    tr, tpos, tbox = _setup(ts, tts, tu, _tmesh("spatial"), N_BAND, RHO_BAND,
                            True, segment_steps=S_BAND)
    return jr, jr.init(pos, box, seed=3), tr, tr.init(tpos, tbox, seed=3)


def test_spatial_band_runner_init_matches_jax(band_runners):
    jr, jc, tr, tc = band_runners
    assert tr.n_pad == jr.n_pad and tr.rows_per_dev == jr.rows_per_dev
    assert tr.w == jr.w and tr.w < N_BAND // 2  # a selective band
    np.testing.assert_array_equal(tc.x.numpy(), _np(jc.x))
    assert _rel(tc.F.numpy(), _np(jc.F)) < 1e-5
    assert not bool(tc.overflowed)


def _segment_noise(key, step0, S, n_pad):
    return _t(np.stack([_jax_noise(key, step0 + s, n_pad) for s in range(S)]))


def test_spatial_band_runner_two_segments_with_jax_noise(band_runners):
    jr, jc, tr, _ = band_runners
    state = interop.spatial_band_carry(jc, "cpu")
    for seg in range(2):
        state = tr.segment(state, _segment_noise(jc.key, seg * S_BAND,
                                                 S_BAND, tr.n_pad))
    j10 = jr.run(jc, 2 * S_BAND)
    assert state.step == 10
    assert np.abs(state.x.numpy() - _np(j10.x)).max() < 1e-5
    assert np.abs(state.v.numpy() - _np(j10.v)).max() < 1e-4
    assert bool(state.overflowed) == bool(j10.overflowed) is False
    tr.check(state)
    e_ref = float(jr.energy(j10))
    assert abs(float(tr.energy(state)) - e_ref) / abs(e_ref) < 1e-5
    out = tr.run(state, 2 * S_BAND)  # noise from the generator
    assert out.step == 20 and torch.isfinite(out.x).all()


def test_spatial_band_runner_latches_a_nan(band_runners):
    """A NaN that appears inside a segment (here from a NaN velocity)
    latches at the segment's end, in both packages; a NaN x in a carry
    latches in the port before the sort moves it out of the live lanes."""
    jr, jc, tr, _ = band_runners
    jbad = dataclasses.replace(jc, v=jc.v.at[0, 7].set(jnp.nan))
    assert bool(jr.run(jbad, S_BAND).overflowed)
    bad = interop.spatial_band_carry(jbad, "cpu")
    out = tr.segment(bad)
    assert bool(out.overflowed)
    with pytest.raises(RuntimeError, match="invariant violated"):
        tr.check(out)
    good = interop.spatial_band_carry(jc, "cpu")
    xnan = good.x.clone()
    xnan[1, 11] = float("nan")
    assert bool(tr.segment(dataclasses.replace(good, x=xnan)).overflowed)
    assert not bool(tr.segment(good).overflowed)


def test_spatial_band_runner_guards(band_runners):
    _, _, tr, tc = band_runners
    with pytest.raises(ValueError, match="multiple of segment_steps"):
        tr.run(tc, S_BAND + 2)
    fluid = tts.LennardJonesFluid(nparticles=64, reduced_density=0.2)
    topo = Topology.from_masses(np.linspace(10.0, 40.0, 64))
    with pytest.raises(ValueError, match="identical masses"):
        ts.make_spatial_band_lj_runner(
            _tmesh("spatial"), fluid.potential, 64,
            temperature=120.0 * tu.kelvin,
            timestep=2.0 * tu.femtoseconds, topology=topo)
    unsorted = ts.make_spatial_band_lj_runner(
        _tmesh("spatial"), fluid.potential, 64,
        temperature=120.0 * tu.kelvin, timestep=2.0 * tu.femtoseconds)
    with pytest.raises(RuntimeError, match="init"):
        unsorted.segment(tc)


def test_mesh_and_devices():
    """The mesh is this process alone without torch.distributed, on the card
    unless asked for the CPU; the factories take its device and axis."""
    mesh = make_replica_mesh()
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.device.type == "cuda" and mesh.axis_name == "replica"
    with pytest.raises(ValueError, match="torch.distributed"):
        make_replica_mesh(2, device="cpu")
    # on the card the row tile is at least 128, so every slab is a multiple
    # of 32 rows; on the CPU it stays as given
    f = ts.make_sharded_lj_force(mesh, 300, SIGMA, EPS, CUTOFF, tm=8)
    assert f.op.device.type == "cuda" and f.n_pad == 384 and f.op.tm == 128
    assert ts.make_sharded_lj_force(make_replica_mesh(device="cpu"), 300,
                                    SIGMA, EPS, CUTOFF, tm=8).n_pad == 304
    assert ts._tile(8, torch.device("cuda")) == 128
    assert ts._tile(256, torch.device("cuda")) == 256
    fluid = tts.LennardJonesFluid(nparticles=300, reduced_density=0.5)
    kw = dict(temperature=120.0 * tu.kelvin, timestep=2.0 * tu.femtoseconds)
    with pytest.raises(ValueError, match="axis"):
        ts.make_spatial_lj_runner(make_replica_mesh(device="cpu"),
                                  fluid.potential, 300, **kw)


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


def test_row_band_force_takes_skip_and_runs_plain_on_cpu():
    """``skip`` only steers the kernel: on a CPU tensor both settings run
    the plain version."""
    n, n_pad = 450, 512
    L = (n / 0.1) ** (1 / 3) * SIGMA
    x3s, w = _band_layout(n, n_pad, L, 1, True)
    box = _t(np.full((1, 3), L, np.float32))
    args = (_t(x3s), box, 64, 128, n, w, TM, SIGMA, 0.99, CUTOFF)
    plain = ts.row_band_force_plain(*args[:6], *args[7:])
    assert torch.equal(ts.row_band_force(*args, skip=False), plain)
    assert torch.equal(ts.row_band_force(*args), plain)


def test_row_band_vote_replica_matches_a_direct_count():
    """chip_smoke.py's replica of K8b's choices against a loop over blocks,
    chunks and warps as the kernel takes them: the warp chunks without a
    band pair of the block's rows, those beyond the cutoff in x, and the
    warp steps (one column against the warp's 32 rows) that fire in the
    others, on a layout with a padding gap and pairs across the seam."""
    cs = _chip_smoke()
    n, n_pad, tm = 450, 512, 64
    L = (n / 0.1) ** (1 / 3) * SIGMA
    x3s, w = _band_layout(n, n_pad, L, 1, True)
    got = cs._row_band_votes(torch.from_numpy(x3s),
                             torch.full((1, 3), L), n, CUTOFF, w, tm)

    n_tiles = n_pad // tm
    K, nbt = ts.band_window(n, n_pad, tm, w)
    width = nbt * tm
    c2, half = CUTOFF * CUTOFF, 0.5 * L
    chunks = dead = apart = fired = steps = 0
    for r0 in range(0, n_pad, 32):
        rows = np.arange(r0, r0 + 32)
        first = ((r0 // tm) - K) % n_tiles
        live_rows = rows[rows < n]
        for c0 in range(0, width, 256):
            for g in range(8):
                chunks += 1
                cl = c0 + 32 * g + np.arange(32)
                inwin = cl < width
                col = np.where(inwin, (first * tm + cl) % n_pad, n)
                xs = np.where(inwin, x3s[:, col % n_pad], 0.0).astype(
                    np.float32)
                delta = (col[None, :] - rows[:, None]) % n
                live = ((col[None, :] < n) & (rows[:, None] < n)
                        & (delta >= 1) & ((delta <= w) | (delta >= n - w)))
                if not live.any():
                    dead += 1
                    continue
                dlo = np.float32(x3s[0, live_rows].min() - xs[0].max())
                dhi = np.float32(x3s[0, live_rows].max() - xs[0].min())
                if (dlo >= -half and dhi < half
                        and ((dhi < 0 and dhi * dhi >= c2)
                             or (dlo > 0 and dlo * dlo >= c2))):
                    apart += 1
                    continue
                d = x3s[:, rows, None] - xs[:, None, :]
                d = d - L * np.floor(d / L + 0.5)
                m = live & ((d * d).sum(0) < c2)
                fired += int(m.any(0).sum())
                steps += 32
    assert got == (chunks, dead, apart, fired, steps, 0)
    assert dead > 0 and apart > 0 and 0 < fired < steps
