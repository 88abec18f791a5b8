"""The port's replica axis (``chiron_tpu_torch.parallel.tempering``, K1 over
replicas) against the JAX package's ``chiron_tpu.parallel.tempering``.

The two packages draw different streams (the port's counter stream from
integer keys, JAX's threefry), so the chains are held to JAX's with JAX's
own noise fed to the port (JAX's ``split(key)`` sequence rebuilt on the JAX
side), or at collision rate 0, where the noise drops out: positions to
1e-5 nm, velocities to 1e-4 nm/ps (the integrator tests' tolerances), U to
1e-5 relative.  JAX's dense chain runs K1 in Pallas interpret mode with the
exact reciprocal (interpret mode takes the approximate one as a bf16
reciprocal), the port's K1's plain version.  On one energy vector the swap
sweep, its counts and the velocity scales equal JAX's exactly; a session
that JAX wrote continues in the port; the port's own restart is bit for
bit.  Mirrors ``tests/test_parallel.py``, ``tests/test_restart.py`` and the
tempering tests of ``tests/test_reporters.py`` and ``tests/test_analysis.py``.
"""

import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chiron_tpu.neighbors as jn
import chiron_tpu.parallel.tempering as jpt
import chiron_tpu.reporters as jr
import chiron_tpu.testsystems as jts
import chiron_tpu.units as ju
import chiron_tpu_torch.neighbors as tn
import chiron_tpu_torch.parallel.tempering as tpt
import chiron_tpu_torch.reporters as tr
import chiron_tpu_torch.testsystems as tts
import chiron_tpu_torch.units as tu
from chiron_tpu.ops.lj_dense import LJDensePallas
from chiron_tpu.parallel import ParallelTemperingSampler as JPT
from chiron_tpu.parallel.mesh import make_replica_mesh as j_mesh
from chiron_tpu_torch import interop
from chiron_tpu_torch.ops.lj_cull import splitmix_noise_plain
from chiron_tpu_torch.ops.lj_dense import (LJDense, lj_dense_plain,
                                           lj_dense_replicas_plain)
from chiron_tpu_torch.parallel import Mesh, ParallelTemperingSampler
from chiron_tpu_torch.parallel import make_replica_mesh as t_mesh

R, N_LJ, STEPS, DT = 3, 64, 10, 0.002
X_TOL, V_TOL, U_REL = 1e-5, 1e-4, 1e-5
MD_J = ju.md_unit_system


def _np(a):
    return np.asarray(a)


def _cpu_mesh():
    return t_mesh(device="cpu")


def _jax_noise(keys, n_steps, shape):
    """(n_steps, R, *shape) noise of JAX's chains: each step splits the key
    and draws ``normal(subkey, shape)``."""
    def one(key):
        def step(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.normal(sub, shape, dtype=jnp.float32)
        return jax.lax.scan(step, key, None, length=n_steps)[1]
    return np.swapaxes(_np(jax.vmap(one)(keys)), 0, 1)


@pytest.fixture(scope="module")
def lj_fluid():
    f = jts.LennardJonesFluid(nparticles=N_LJ, reduced_density=0.5)
    pos = _np(f.positions.value_in_unit_system(MD_J)).astype(np.float32)
    box = _np(f.box_vectors.value_in_unit_system(MD_J)).astype(np.float32)
    return f, pos, box


def _kTs():
    temps = np.array([120.0 * 1.1 ** i for i in range(R)], np.float32)
    return temps * ju.kB_MD


# ---------------------------------------------------------------------------
# K1 over replicas and the noise stream
# ---------------------------------------------------------------------------


def test_replica_k1_plain_equals_single_system_on_each_replica(lj_fluid):
    _, pos, box = lj_fluid
    tf = tts.LennardJonesFluid(nparticles=N_LJ, reduced_density=0.5)
    pot = tf.potential
    op = LJDense(N_LJ, pot.sigma, pot.epsilon, pot.cutoff, tm=128, tn=512,
                 device="cpu")
    rng = np.random.default_rng(3)
    x3r = torch.stack([
        op.pad_positions(pos + rng.normal(0, 0.02, pos.shape).astype(
            np.float32)) for _ in range(4)])
    box_r = torch.tensor(np.stack([np.diagonal(box) * (1 + 0.01 * r)
                                   for r in range(4)]),
                         dtype=torch.float32).reshape(4, 1, 3)
    F, E = op.force_energy_r(x3r, box_r)
    Fo = op.force_only_r(x3r, box_r)
    Fp, Ep = lj_dense_replicas_plain(x3r, box_r, N_LJ, pot.sigma,
                                     pot.epsilon, pot.cutoff)
    assert F.shape == (4, 3, op.n_pad) and E.shape == (4,)
    for r in range(4):
        f1, e1 = lj_dense_plain(x3r[r], box_r[r].reshape(1, 3), N_LJ,
                                pot.sigma, pot.epsilon, pot.cutoff)
        assert torch.equal(F[r], f1) and torch.equal(Fo[r], f1)
        assert torch.equal(E[r], e1) and torch.equal(Fp[r], f1)
        assert torch.equal(Ep[r], e1)
    assert len(set(float(e) for e in E)) == 4


def test_replica_noise_is_the_counter_stream_of_each_replica():
    seeds = [tpt.stream_seed(k) for k in (1, 2 ** 40 + 7, 12345)]
    z = tpt.replica_normals(seeds, 5, 3, 3, 256, "cpu")
    assert z.shape == (3, 3, 3, 512)
    for s in range(3):
        for r, seed in enumerate(seeds):
            assert torch.equal(z[s, r], splitmix_noise_plain(seed, 5 + s,
                                                             512))
    # a replica's draw does not depend on the others in its block
    alone = tpt.replica_normals(seeds[1:2], 5, 3, 3, 256, "cpu")
    assert torch.equal(alone[:, 0], z[:, 1])
    flat = tpt.replica_normals(seeds, 0, 200, 1, 64, "cpu").flatten()
    assert abs(float(flat.mean())) < 0.02 and abs(float(flat.std()) - 1) < 0.02


# ---------------------------------------------------------------------------
# The chains against JAX's, with JAX's noise
# ---------------------------------------------------------------------------


def test_dense_chain_matches_jax_with_its_noise(lj_fluid):
    f, pos, box = lj_fluid
    pot = f.potential
    jop = LJDensePallas(N_LJ, pot.sigma, pot.epsilon, pot.cutoff, tm=128,
                        interpret=True)
    tf = tts.LennardJonesFluid(nparticles=N_LJ, reduced_density=0.5)
    top = tf.potential
    op = LJDense(N_LJ, top.sigma, top.epsilon, top.cutoff, tm=128, tn=512,
                 device="cpu")
    assert op.n_pad == jop.n_pad == 512
    masses = np.full(N_LJ, 39.9, np.float32)
    m_lane = np.ones((1, op.n_pad), np.float32)
    m_lane[0, :N_LJ] = masses
    kT = _kTs()
    rng = np.random.default_rng(1)
    x3 = np.zeros((R, 3, op.n_pad), np.float32)
    x3[:, :, :N_LJ] = pos.T
    v3 = (np.sqrt(kT[:, None, None] / m_lane[None])
          * rng.normal(size=(R, 3, op.n_pad))).astype(np.float32)
    bd = np.tile(np.diagonal(box).reshape(1, 1, 3), (R, 1, 1))
    keys = jax.random.split(jax.random.PRNGKey(5), R)
    jchain = jpt.make_pt_dense_chain_fn(jop, jnp.asarray(m_lane), DT, 1.0,
                                        exact_forces=True)
    jx, jv, _, _, jU, _ = jax.jit(jax.vmap(
        lambda x, v, k, b, l, t: jchain(x, v, k, b, l, t, STEPS)))(
        jnp.asarray(x3), jnp.asarray(v3), keys, jnp.asarray(bd),
        jnp.zeros((R, 1)), jnp.asarray(kT))
    noise = _jax_noise(keys, STEPS, (3, op.n_pad))
    tchain = tpt.make_pt_dense_chain_fn(op, torch.tensor(m_lane), DT, 1.0,
                                        exact_forces=True)
    tx, tv, _, tU, over = tchain(
        torch.tensor(x3), torch.tensor(v3), [0] * R, torch.tensor(bd), None,
        torch.tensor(kT), STEPS, noise=torch.tensor(noise))
    assert np.abs(tx.numpy() - _np(jx)).max() < X_TOL
    assert np.abs(tv.numpy() - _np(jv)).max() < V_TOL
    assert np.abs(tU.numpy() - _np(jU)).max() / np.abs(_np(jU)).max() < U_REL
    assert not over.any()
    # the padding lanes drift as JAX's do
    assert np.abs(tx.numpy()[:, :, N_LJ:]).max() > 0


class _NoForce:
    """A dense op with no force and no energy: the chain's BAOAB then acts
    on each lane alone, so its result does not depend on the lane order."""

    def __init__(self, n, cutoff):
        self.n, self.cutoff = n, cutoff

    def force_only_r(self, x3, box_diag, approx_recip=True):
        return torch.zeros_like(x3)

    def force_energy_r(self, x3, box_diag):
        return torch.zeros_like(x3), torch.zeros(x3.shape[0])


def _dense_step(x3, v3, F3, force, m_lane, L, kT, z, collision_rate):
    """One step of the dense chain's arithmetic on unsorted lanes."""
    hdt, a, b = tpt._coefficients(DT, collision_rate)
    bs = b * torch.sqrt(kT.reshape(-1, 1, 1) / m_lane)
    hm = hdt / m_lane
    v3 = torch.addcmul(v3, F3, hm)
    x3 = torch.add(x3, v3, alpha=hdt)
    v3 = torch.addcmul(a * v3, bs, z)
    x3 = torch.add(x3, v3, alpha=hdt)
    x3 = torch.addcmul(x3, torch.floor(x3 / L), L, value=-1.0)
    F3 = force(x3)
    return x3, torch.addcmul(v3, F3, hm), F3


def _shuffled_dense_start(pos, box, n_pad, seed):
    """R replicas of ``pos`` with their live lanes shuffled apart in space
    (each its own way), zero padding lanes, random velocities and masses."""
    rng = np.random.default_rng(seed)
    n = pos.shape[0]
    x3 = np.zeros((R, 3, n_pad), np.float32)
    for r in range(R):
        x3[r, :, :n] = pos[rng.permutation(n)].T
    v3 = rng.normal(0, 0.3, (R, 3, n_pad)).astype(np.float32)
    m_lane = np.ones((1, n_pad), np.float32)
    m_lane[0, :n] = rng.uniform(10.0, 60.0, n)
    bd = np.tile(np.diagonal(box).reshape(1, 1, 3), (R, 1, 1))
    return (torch.tensor(x3), torch.tensor(v3), torch.tensor(m_lane),
            torch.tensor(bd))


@pytest.mark.parametrize("source", ["seeds", "given"])
def test_dense_chain_gives_each_particle_its_own_lanes_noise(
        lj_fluid, monkeypatch, source):
    """With no force, each lane's BAOAB is the same arithmetic whatever the
    order of the lanes, so the sorted chain's outputs equal, bit for bit, a
    step loop on the unsorted lanes with each lane's own mass and noise:
    the counter stream of its replica's seed (drawn in blocks of 3 steps,
    each gathered once) or the given noise.  The outputs come back in the
    input's lane order, the padding lanes last."""
    _, pos, box = lj_fluid
    n_pad, steps = 512, 7
    x3, v3, m_lane, bd = _shuffled_dense_start(pos, box, n_pad, 8)
    kT = torch.tensor(_kTs())
    seeds = [tpt.stream_seed(k) for k in (11, 2 ** 40 + 3, 77)]
    monkeypatch.setattr(tpt, "_NOISE_LANES", R * 3 * n_pad * 3)
    if source == "seeds":
        z, given = tpt.replica_normals(seeds, 0, steps, 3, n_pad // 2,
                                       "cpu"), None
    else:
        z = given = torch.randn(steps, R, 3, n_pad,
                                generator=torch.Generator().manual_seed(4))
    # the sort moves most lanes
    perm = tpt.lane_order(x3, bd, N_LJ, 0.9)
    assert int((perm[:, :N_LJ] != torch.arange(N_LJ)).sum()) > N_LJ
    assert torch.equal(perm[:, N_LJ:], torch.arange(N_LJ, n_pad).expand(
        R, -1))
    chain = tpt.make_pt_dense_chain_fn(_NoForce(N_LJ, 0.9), m_lane, DT, 5.0)
    tx, tv, _, tU, _ = chain(x3, v3, seeds, bd, None, kT, steps,
                             noise=given)
    L = bd.reshape(R, 3, 1)
    zero = torch.zeros_like(x3)
    x, v, F = x3, v3, zero
    for s in range(steps):
        x, v, F = _dense_step(x, v, F, torch.zeros_like, m_lane, L, kT, z[s],
                              5.0)
    assert torch.equal(tx, x) and torch.equal(tv, v)
    assert not torch.equal(tx, x3) and tU.shape == (R,)


def test_dense_chain_takes_one_step_from_a_shuffled_start(lj_fluid):
    """K1's plain version in the sorted chain: one step from lanes shuffled
    apart moves each lane by its step's drift alone and lands within f32
    rounding of a step on the unsorted lanes (the order of the force's sums
    differs); the padding lanes, which feel no force, equal it bit for
    bit."""
    _, pos, box = lj_fluid
    tf = tts.LennardJonesFluid(nparticles=N_LJ, reduced_density=0.5)
    top = tf.potential
    op = LJDense(N_LJ, top.sigma, top.epsilon, top.cutoff, tm=128, tn=512,
                 device="cpu")
    x3, v3, m_lane, bd = _shuffled_dense_start(pos, box, op.n_pad, 9)
    kT = torch.tensor(_kTs())
    z = torch.randn(1, R, 3, op.n_pad,
                    generator=torch.Generator().manual_seed(5))
    chain = tpt.make_pt_dense_chain_fn(op, m_lane, DT, 1.0,
                                       exact_forces=True)
    tx, tv, _, tU, _ = chain(x3, v3, [0] * R, bd, None, kT, 1, noise=z)

    def force(x):
        return op.force_energy_r(x, bd)[0]

    L = bd.reshape(R, 3, 1)
    x, v, _ = _dense_step(x3, v3, force(x3), force, m_lane, L, kT, z[0], 1.0)
    d = tx - x3
    d = d - torch.round(d / L) * L
    assert float(d[:, :, :N_LJ].abs().max()) < 0.01
    assert np.abs((tx - x).numpy()).max() < X_TOL
    assert np.abs((tv - v).numpy()).max() < V_TOL
    assert torch.equal(tx[:, :, N_LJ:], x[:, :, N_LJ:])
    assert torch.equal(tv[:, :, N_LJ:], v[:, :, N_LJ:])
    _, U = op.force_energy_r(x, bd)
    assert np.abs((tU - U).numpy()).max() / np.abs(U.numpy()).max() < U_REL


def _ho_pair():
    jho = jts.HarmonicOscillator(
        k=100.0 * ju.kilojoule_per_mole / ju.nanometer ** 2)
    tho = tts.HarmonicOscillator(
        k=100.0 * tu.kilojoule_per_mole / tu.nanometer ** 2)
    return jho, tho


def test_harmonic_chain_matches_jax_with_its_noise():
    jho, tho = _ho_pair()
    masses = np.asarray(jho.topology.masses(), np.float32)[:, None]
    kT = _kTs()
    rng = np.random.default_rng(2)
    x = rng.normal(0, 0.1, (R, 1, 3)).astype(np.float32)
    v = rng.normal(0, 1.0, (R, 1, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(9), R)
    jchain = jpt.make_pt_chain_fn(jho.potential.make_energy_fn(None),
                                  jnp.asarray(masses), 0.004, 5.0)
    jx, jv, _, _, jU, _ = jax.jit(jax.vmap(
        lambda x, v, k, b, l, t: jchain(x, v, k, b, l, t, 40)))(
        jnp.asarray(x), jnp.asarray(v), keys, jnp.zeros((R, 3, 3)),
        jnp.zeros((R, 1)), jnp.asarray(kT))
    noise = torch.tensor(_jax_noise(keys, 40, (1, 3)))
    tchain = tpt.make_pt_chain_fn(
        tho.potential.make_energy_fn(None), torch.tensor(masses), 0.004, 5.0,
        block_energy=tpt.block_energy_fn(tho.potential))
    tx, tv, _, tU, _ = tchain(torch.tensor(x), torch.tensor(v), [0] * R,
                              None, None, torch.tensor(kT), 40, noise=noise)
    assert np.abs(tx.numpy() - _np(jx)).max() < X_TOL
    assert np.abs(tv.numpy() - _np(jv)).max() < V_TOL
    assert np.abs(tU.numpy() - _np(jU)).max() / np.abs(_np(jU)).max() < U_REL
    # the block's energy in one pass equals the potential's own, replica by
    # replica, and the default (looped) chain takes the same steps
    loop = tpt.make_pt_chain_fn(tho.potential.make_energy_fn(None),
                                torch.tensor(masses), 0.004, 5.0)
    lx, _, _, lU, _ = loop(torch.tensor(x), torch.tensor(v), [0] * R, None,
                           None, torch.tensor(kT), 40, noise=noise)
    assert np.abs(lx.numpy() - tx.numpy()).max() < 1e-6
    assert np.abs(lU.numpy() - tU.numpy()).max() < 1e-5


def test_pair_list_chain_matches_jax_with_its_noise():
    jf = jts.LennardJonesFluid(nparticles=32, reduced_density=0.3)
    tf = tts.LennardJonesFluid(nparticles=32, reduced_density=0.3)
    pos = _np(jf.positions.value_in_unit_system(MD_J)).astype(np.float32)
    box = _np(jf.box_vectors.value_in_unit_system(MD_J)).astype(np.float32)
    jpairs = jn.PairListNsqrd(jn.OrthogonalPeriodicSpace(), cutoff=jf.cutoff)
    tpairs = tn.PairListNsqrd(tn.OrthogonalPeriodicSpace(), cutoff=tf.cutoff)
    jpairs.build(jnp.asarray(pos), jnp.asarray(box))
    tpairs.build(torch.tensor(pos), torch.tensor(box))
    masses = np.asarray(jf.topology.masses(), np.float32)[:, None]
    kT = _kTs()
    rng = np.random.default_rng(4)
    x = np.stack([pos + rng.normal(0, 0.01, pos.shape) for _ in range(R)]
                 ).astype(np.float32)
    v = rng.normal(0, 0.2, (R, 32, 3)).astype(np.float32)
    boxes = np.tile(box[None], (R, 1, 1))
    keys = jax.random.split(jax.random.PRNGKey(3), R)
    jls = jax.vmap(jn.pairlist_build_fn)(jnp.asarray(x), jnp.asarray(boxes))
    jchain = jpt.make_pt_chain_fn(jf.potential.make_energy_fn(jpairs),
                                  jnp.asarray(masses), DT, 1.0, pairs=jpairs)
    jx, jv, _, _, jU, _ = jax.jit(jax.vmap(
        lambda x, v, k, b, l, t: jchain(x, v, k, b, l, t, STEPS)))(
        jnp.asarray(x), jnp.asarray(v), keys, jnp.asarray(boxes), jls,
        jnp.asarray(kT))
    noise = torch.tensor(_jax_noise(keys, STEPS, (32, 3)))
    tls = tn.pairlist_build_fn(torch.tensor(pos), torch.tensor(box))
    tchain = tpt.make_pt_chain_fn(tf.potential.make_energy_fn(tpairs),
                                  torch.tensor(masses), DT, 1.0, pairs=tpairs)
    tx, tv, _, tU, _ = tchain(torch.tensor(x), torch.tensor(v), [0] * R,
                              torch.tensor(boxes), tls, torch.tensor(kT),
                              STEPS, noise=noise)
    assert np.abs(tx.numpy() - _np(jx)).max() < X_TOL
    assert np.abs(tv.numpy() - _np(jv)).max() < V_TOL
    assert np.abs(tU.numpy() - _np(jU)).max() / np.abs(_np(jU)).max() < U_REL


def test_verlet_chain_matches_jax_at_collision_rate_zero():
    """The Verlet-list chain, one replica at a time (JAX's ``lax.map``),
    rebuilding its lists as JAX's does: no noise at collision rate 0."""
    jf = jts.LennardJonesFluid(nparticles=64, reduced_density=0.3)
    tf = tts.LennardJonesFluid(nparticles=64, reduced_density=0.3)
    pos = _np(jf.positions.value_in_unit_system(MD_J)).astype(np.float32)
    box = _np(jf.box_vectors.value_in_unit_system(MD_J)).astype(np.float32)
    kw_j = dict(skin=0.05 * ju.nanometer, n_max_neighbors=64)
    kw_t = dict(skin=0.05 * tu.nanometer, n_max_neighbors=64)
    jpairs = jn.NeighborListNsqrd(jn.OrthogonalPeriodicSpace(),
                                  cutoff=jf.cutoff, **kw_j)
    tpairs = tn.NeighborListNsqrd(tn.OrthogonalPeriodicSpace(),
                                  cutoff=tf.cutoff, **kw_t)
    jpairs.build(jnp.asarray(pos), jnp.asarray(box))
    tpairs.build(torch.tensor(pos), torch.tensor(box))
    masses = np.asarray(jf.topology.masses(), np.float32)[:, None]
    kT = _kTs()
    rng = np.random.default_rng(6)
    v = rng.normal(0, 1.5, (R, 64, 3)).astype(np.float32)
    cs = jpairs.cutoff_md + jpairs.skin_md
    jchain = jax.jit(jpt.make_pt_chain_fn(
        jf.potential.make_energy_fn(jpairs), jnp.asarray(masses), DT, 0.0,
        pairs=jpairs), static_argnums=(6,))
    tls = [tn.neighbor_build_fn(torch.tensor(pos), torch.tensor(box), cs,
                                tpairs.space, 64) for _ in range(R)]
    tchain = tpt.make_pt_chain_fn(tf.potential.make_energy_fn(tpairs),
                                  torch.tensor(masses), DT, 0.0, pairs=tpairs)
    tx, tv, tls, tU, tover = tchain(
        torch.tensor(np.tile(pos[None], (R, 1, 1))), torch.tensor(v),
        [0] * R, torch.tensor(np.tile(box[None], (R, 1, 1))), tls,
        torch.tensor(kT), 30)
    rebuilt = 0
    for r in range(R):
        jls = jn.neighbor_build_fn(jnp.asarray(pos), jnp.asarray(box), cs,
                                   jpairs.space, 64)
        jx, jv, _, jls, jU, jover = jchain(
            jnp.asarray(pos), jnp.asarray(v[r]), jax.random.PRNGKey(r),
            jnp.asarray(box), jls, jnp.float32(kT[r]), 30)
        assert np.abs(tx[r].numpy() - _np(jx)).max() < X_TOL
        assert np.abs(tv[r].numpy() - _np(jv)).max() < V_TOL
        assert abs(float(tU[r]) - float(jU)) / abs(float(jU)) < U_REL
        assert np.array_equal(tls[r].neighbor_list.numpy(),
                              _np(jls.neighbor_list))
        assert bool(tover[r]) == bool(jover) is False
        rebuilt += int(np.abs(_np(jls.ref_positions) - pos).max() > 0)
    assert rebuilt > 0  # the lists were rebuilt on the way


# ---------------------------------------------------------------------------
# The sampler
# ---------------------------------------------------------------------------

HO_TEMPS = [300.0 * (1.2 ** i) for i in range(4)]


def _jax_ho_pt(collision_rate=0.0, reporter=None):
    ho = jts.HarmonicOscillator(
        k=100.0 * ju.kilojoule_per_mole / ju.nanometer ** 2)
    pt = JPT(potential=ho.potential,
             temperatures=[t * ju.kelvin for t in HO_TEMPS],
             timestep=4.0 * ju.femtoseconds,
             collision_rate=collision_rate / ju.picoseconds,
             mesh=j_mesh(1), reporter=reporter)
    pt.initialize(ho.positions, seed=7)
    return pt


def _port_ho_pt(collision_rate=0.0, reporter=None, mesh=None, temps=HO_TEMPS):
    ho = tts.HarmonicOscillator(
        k=100.0 * tu.kilojoule_per_mole / tu.nanometer ** 2)
    pt = ParallelTemperingSampler(
        potential=ho.potential, temperatures=[t * tu.kelvin for t in temps],
        timestep=4.0 * tu.femtoseconds,
        collision_rate=collision_rate / tu.picoseconds,
        mesh=mesh or _cpu_mesh(), reporter=reporter)
    pt.initialize(ho.positions, seed=7)
    return pt


def test_mix_replicas_equals_jax_on_one_energy_vector():
    temps = [300.0 * 1.07 ** i for i in range(7)]
    ho = jts.HarmonicOscillator()
    j = JPT(potential=ho.potential, temperatures=[t * ju.kelvin for t in temps],
            mesh=j_mesh(1))
    j.initialize(ho.positions, seed=1)
    t = _port_ho_pt(temps=temps)
    assert np.array_equal(np.asarray(t.kTs), _np(j.kTs))
    U = np.random.default_rng(8).normal(0.0, 3.0, 7).astype(np.float32)
    U[3] += 60.0  # a gap no swap crosses
    for it in range(1, 7):
        j._iteration = t._iteration = it
        j.velocities = jnp.ones_like(j.velocities)
        t.velocities = torch.ones_like(t.velocities)
        j.mix_replicas(U, np.random.default_rng([11, it]))
        t.mix_replicas(U, np.random.default_rng([11, it]))
        assert np.array_equal(np.asarray(t.kTs), _np(j.kTs)), it
        assert (t.n_accepted_swaps, t.n_proposed_swaps) == (
            j.n_accepted_swaps, j.n_proposed_swaps)
        assert np.array_equal(t.velocities.numpy(), _np(j.velocities)), it
        U = U[np.random.default_rng(it).permutation(7)]
    assert 0 < t.n_accepted_swaps < t.n_proposed_swaps


def test_jax_session_continues_in_the_port(tmp_path):
    """JAX runs 3 iterations and saves; the port loads the file with R
    integer keys; both run 3 more (collision rate 0: no noise)."""
    j = _jax_ho_pt()
    j.run(3, steps_per_iteration=25, seed=11)
    path = str(tmp_path / "jax_pt.npz")
    j.save_session(path)
    t = _port_ho_pt()
    with pytest.raises(ValueError, match="JAX keys"):
        t.load_session(path)
    meta = t.load_session(path, keys=[101, 102, 103, 104])
    assert meta["iteration"] == t._iteration == 3 and t._swap_seed == 11
    assert np.array_equal(np.asarray(t.kTs), _np(j.kTs))
    j.run(3, steps_per_iteration=25)
    t.run(3, steps_per_iteration=25)
    assert np.abs(t.positions.numpy() - _np(j.positions)).max() < X_TOL
    assert np.abs(np.stack(t._u_history) - np.stack(j._u_history)).max() \
        / np.abs(np.stack(j._u_history)).max() < U_REL
    assert (t.n_accepted_swaps, t.n_proposed_swaps) == (
        j.n_accepted_swaps, j.n_proposed_swaps)
    assert np.array_equal(np.asarray(t.kTs), _np(j.kTs))
    assert np.array_equal(np.stack(t._temp_history),
                          np.stack(j._temp_history))


def test_pt_state_carries_jax_arrays_into_the_port(lj_fluid):
    """A dense JAX sampler's replica arrays set a port sampler: the same
    replica positions, the same exact energy, and, with the noise off, the
    same 5 steps of both dense chains with exact forces."""
    f, pos, box = lj_fluid
    temps = [120.0, 132.0, 145.2]
    j = JPT(potential=f.potential, temperatures=[t * ju.kelvin for t in temps],
            collision_rate=0.0 / ju.picoseconds, mesh=j_mesh(1))
    j.initialize(pos, box_vectors=box, seed=3)
    tf = tts.LennardJonesFluid(nparticles=N_LJ, reduced_density=0.5)
    t = ParallelTemperingSampler(
        potential=tf.potential, temperatures=[x * tu.kelvin for x in temps],
        collision_rate=0.0 / tu.picoseconds, mesh=_cpu_mesh())
    t.initialize(pos, box_vectors=box, seed=3)
    assert t._dense_op.n_pad == j._dense_op.n_pad
    interop.pt_state(t, _np(j.positions), _np(j.velocities), _np(j.kTs),
                     _np(j.box_vectors), keys=[1, 2, 3])
    assert np.array_equal(t.replica_positions(), j.replica_positions())
    # the approximate reciprocal of JAX's interpret mode is a bf16 one: hold
    # the energy, taken with the exact reciprocal on both sides, from the
    # same state
    jop = j._dense_op
    _, jE = jax.vmap(jop.force_energy_t)(j.positions, j.box_vectors)
    _, tE = t._dense_op.force_energy_r(t.positions, t.box_vectors)
    assert np.abs(tE.numpy() - _np(jE)).max() / np.abs(_np(jE)).max() < U_REL
    jchain = jpt.make_pt_dense_chain_fn(jop, j.masses, j.timestep, 0.0,
                                        exact_forces=True)
    jx, _, _, _, jU, _ = jax.jit(jax.vmap(
        lambda x, v, k, b, l, kT: jchain(x, v, k, b, l, kT, 5)))(
        j.positions, j.velocities, jax.random.split(jax.random.PRNGKey(0), 3),
        j.box_vectors, jnp.zeros((3, 1)), j.kTs)
    tchain = tpt.make_pt_dense_chain_fn(t._dense_op, t.masses, t.timestep,
                                        0.0, exact_forces=True)
    tx, _, _, tU, _ = tchain(t.positions, t.velocities,
                             tpt.split_keys(t.keys)[1], t.box_vectors, None,
                             torch.tensor(np.asarray(t.kTs)), 5)
    assert np.abs(tx.numpy() - _np(jx)).max() < X_TOL
    assert np.abs(tU.numpy() - _np(jU)).max() / np.abs(_np(jU)).max() < U_REL


def test_port_session_restart_is_bitwise_identical(tmp_path):
    """Mirrors tests/test_restart.py's tempering restart, noise on."""
    ref = _port_ho_pt(collision_rate=1.0)
    ref.run(6, steps_per_iteration=25, seed=11)
    a = _port_ho_pt(collision_rate=1.0)
    a.run(3, steps_per_iteration=25, seed=11)
    path = str(tmp_path / "pt_session.npz")
    a.save_session(path)
    b = _port_ho_pt(collision_rate=1.0)
    b.load_session(path)
    assert b._iteration == 3
    b.run(3, steps_per_iteration=25)  # the restored swap seed
    assert b._iteration == ref._iteration
    assert (b.n_proposed_swaps, b.n_accepted_swaps) == (
        ref.n_proposed_swaps, ref.n_accepted_swaps)
    assert np.array_equal(np.asarray(b.kTs), np.asarray(ref.kTs))
    assert torch.equal(b.positions, ref.positions)
    assert torch.equal(b.velocities, ref.velocities)
    assert b.keys == ref.keys
    assert len(b._u_history) == len(ref._u_history) == 6
    assert np.array_equal(np.stack(b._u_history), np.stack(ref._u_history))


def test_dense_session_restart_is_bitwise_identical(tmp_path, lj_fluid):
    _, pos, box = lj_fluid
    tf = tts.LennardJonesFluid(nparticles=N_LJ, reduced_density=0.5)

    def make():
        pt = ParallelTemperingSampler(
            potential=tf.potential,
            temperatures=[x * tu.kelvin for x in (120.0, 130.0)],
            mesh=_cpu_mesh())
        pt.initialize(pos, box_vectors=box, seed=5)
        return pt

    ref = make().run(4, 5, seed=2)
    a = make().run(2, 5, seed=2)
    a.save_session(str(tmp_path / "s.npz"))
    b = make()
    b.load_session(str(tmp_path / "s.npz"))
    b.run(2, 5)
    assert torch.equal(b.positions, ref.positions)
    assert np.array_equal(np.stack(b._u_history), np.stack(ref._u_history))


def test_reporter_writes_jax_datasets(tmp_path):
    """Mirrors tests/test_reporters.py's tempering reporter: the same run
    (collision rate 0, the port set from JAX's initial arrays) writes the
    same datasets and values."""
    def reporter(pkg, name):
        pkg.BaseReporter.set_directory(str(tmp_path / name))
        rep = pkg.MultistateReporter()
        rep.reset_reporter_file()
        return rep

    jrep, trep = reporter(jr, "jax"), reporter(tr, "port")
    jpt_ = _jax_ho_pt(reporter=jrep)
    tpt_ = _port_ho_pt(reporter=trep)
    interop.pt_state(tpt_, _np(jpt_.positions), _np(jpt_.velocities),
                     _np(jpt_.kTs), None, keys=[1, 2, 3, 4])
    out = {}
    for name, pt, rep in (("jax", jpt_, jrep), ("port", tpt_, trep)):
        pt.run(5, steps_per_iteration=20, seed=3)
        out[name] = {p: np.asarray(rep.get_property(p))
                     for p in ("u_kn", "state_index", "step", "positions")}
    j, t = out["jax"], out["port"]
    assert t["u_kn"].shape == j["u_kn"].shape == (5, 4, 4)
    assert np.abs(t["u_kn"] - j["u_kn"]).max() / np.abs(j["u_kn"]).max() \
        < U_REL
    assert np.array_equal(t["state_index"], j["state_index"])
    assert list(t["step"]) == list(j["step"]) == [1, 2, 3, 4, 5]
    assert set(t["state_index"][-1]) == {0, 1, 2, 3}
    assert t["positions"].shape == j["positions"].shape
    assert np.abs(t["positions"] - j["positions"]).max() < X_TOL


def test_compute_free_energies_empty_history_raises():
    pt = _port_ho_pt(temps=[300.0, 360.0])
    with pytest.raises(ValueError, match="no PT samples"):
        pt.compute_free_energies()
    pt.run(2, 5, seed=1)
    with pytest.raises(ValueError, match="no PT samples"):
        pt.compute_free_energies(discard_fraction=1.0)


def test_estimator_carries_the_iteration_layout():
    """Mirrors tests/test_analysis.py: the estimator behind
    compute_free_energies resamples iterations (a (T, R) layout)."""
    pt = _port_ho_pt(collision_rate=5.0)
    pt.run(10, 20, seed=4)
    f_k = pt.compute_free_energies(discard_fraction=0.2)
    est = pt.estimator
    assert est._iteration_layout == (8, 4) and est._iteration_major is True
    assert f_k.shape == (4,) and f_k[0] == 0.0 and np.isfinite(f_k).all()
    d = est.bootstrap_d_f_k(n_bootstrap=5, seed=0)
    assert d.shape == (4,) and np.isfinite(d).all()


def test_replicas_must_divide_by_the_mesh_size():
    mesh2 = Mesh("replica", None, 0, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        _port_ho_pt(mesh=mesh2, temps=[300.0, 330.0, 360.0])
    pt = _port_ho_pt(mesh=mesh2)  # 4 over 2: this process holds 0 and 1
    assert pt.n_local == 2 and pt.positions.shape[0] == 2


def test_readme_tempering_block_runs_on_the_cpu():
    """The port's tempering block of README.md, as written, on the CPU: its
    mesh asked for the CPU, N=1000 cut to 216, 20 x 100 steps to 3 x 5."""
    readme = pathlib.Path(__file__).parent.parent / "README.md"
    blocks = [b for b in re.findall(r"```python\n(.*?)```",
                                    readme.read_text(), re.S)
              if "ParallelTemperingSampler(" in b]
    assert len(blocks) == 1, "the port's tempering block is not in README.md"
    code = blocks[0]
    for old, new in (("make_replica_mesh()", 'make_replica_mesh(device="cpu")'),
                     ("nparticles=1000", "nparticles=216"),
                     ("n_iterations=20, steps_per_iteration=100",
                      "n_iterations=3, steps_per_iteration=5")):
        assert old in code, old
        code = code.replace(old, new)
    ns = {}
    exec(compile(code, "README.md", "exec"), ns)
    pt = ns["pt"]
    assert pt._dense_op is not None and pt.positions.device.type == "cpu"
    assert pt.positions.shape == (8, 3, 512)
    assert np.isfinite(ns["f_k"]).all() and len(pt._u_history) == 3


@pytest.mark.slow
def test_harmonic_ladder_free_energies_match_the_analytic_values():
    """tests/test_parallel.py's 8-replica ladder, on one process."""
    ho = tts.HarmonicOscillator(
        k=100.0 * tu.kilojoule_per_mole / tu.nanometer ** 2)
    temps = [300.0 * (1.2 ** i) for i in range(8)]
    pt = ParallelTemperingSampler(
        potential=ho.potential, temperatures=[t * tu.kelvin for t in temps],
        timestep=4.0 * tu.femtoseconds, collision_rate=5.0 / tu.picoseconds,
        mesh=_cpu_mesh())
    pt.initialize(ho.positions, seed=1234)
    pt.run(n_iterations=300, steps_per_iteration=200)
    f_k = pt.compute_free_energies(discard_fraction=0.2)
    K, kB = 100.0, 0.008314462618
    f_an = np.array([-1.5 * math.log(2 * math.pi * kB * t / K)
                     for t in sorted(temps)])
    f_an -= f_an[0]
    assert pt.swap_acceptance_fraction > 0.2
    assert np.max(np.abs(f_k - f_an)) < 0.15
