"""The yardstick and the reference: the lattices, the force against a
direct double loop, the roofline's arithmetic on a hand-counted state, and
the reference's noise, keys and swap sweep against the program's own
definitions of them."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from conftest import ROOT


def _config(name):
    return json.loads((ROOT / "h100bench" / "configs" / f"{name}.json")
                      .read_text())


def test_fcc_lattice_of_in_lj():
    from h100bench import systems

    f = systems.fluid(_config("lammps_lj32k"))
    assert f.positions.shape == (32000, 3)
    assert len(np.unique(np.round(f.positions, 4), axis=0)) == 32000
    assert f.box == pytest.approx(33.592 * 0.34, rel=1e-4)
    assert 32000 * 0.34 ** 3 / f.box ** 3 == pytest.approx(0.8442, rel=1e-9)
    assert f.lj.cutoff == pytest.approx(0.85)
    assert f.temperature == pytest.approx(172.463, abs=1e-3)
    assert f.positions.min() >= 0 and f.positions.max() < f.box


def test_simple_cubic_of_lj4000():
    from h100bench import systems

    f = systems.fluid(_config("lj4000"))
    assert f.positions.shape == (4000, 3)
    assert f.box == pytest.approx(5.8139, abs=1e-4)
    assert f.lj.cutoff == pytest.approx(1.02)


def lj_direct(x: np.ndarray, L: np.ndarray, lj):
    """Force and energy of one (N, 3) system by a direct double loop over
    i < j (float64, Python): the check of ``force_energy`` on small N."""
    n = len(x)
    F = np.zeros((n, 3))
    U = 0.0
    for a in range(n):
        for b in range(a + 1, n):
            d = x[a] - x[b]
            d = d - L * np.floor(d / L + 0.5)
            r2 = float(d @ d)
            if r2 >= lj.cutoff ** 2:
                continue
            s6 = (lj.sigma ** 2 / r2) ** 3
            U += 4.0 * lj.epsilon * (s6 * s6 - s6)
            f = 24.0 * lj.epsilon * (2.0 * s6 * s6 - s6) / r2 * d
            F[a] += f
            F[b] -= f
    return F, U


def test_force_against_a_double_loop():
    from h100bench.reference import lj as ref

    rng = np.random.default_rng(3)
    lj = ref.LJ(sigma=0.34, epsilon=0.995792, cutoff=1.02)
    L = np.full(3, 2.3)
    x = rng.random((64, 3)) * L
    F0, U0 = lj_direct(x, L, lj)
    xt = torch.as_tensor(x)[None]
    Lt = torch.as_tensor(L)[None]
    F, U = ref.force_energy(xt, Lt, lj, ref.pair_list(xt, Lt, 1.02 + 0.3))
    np.testing.assert_allclose(F[0].numpy(), F0, rtol=1e-10, atol=1e-9)
    assert float(U[0]) == pytest.approx(U0, rel=1e-12)
    assert ref.pairs_within(xt, Lt, 1.02) == sum(
        1 for a in range(64) for b in range(a + 1, 64)
        if np.sum((lambda d: d - L * np.floor(d / L + 0.5))(x[a] - x[b]) ** 2)
        < 1.02 ** 2)


def test_roofline_arithmetic_on_a_hand_counted_state():
    """Three particles on a line 0.5 nm apart in a 10 nm box: two pairs
    within a 0.9 nm cutoff, one (1.0 nm) beyond it."""
    from h100bench import yardstick
    from h100bench.metrics import pair_roofline, step_mfu
    from h100bench.reference import lj as ref

    x = torch.tensor([[[1.0, 1.0, 1.0], [1.5, 1.0, 1.0], [2.0, 1.0, 1.0]]],
                     dtype=torch.float64)
    L = torch.full((1, 3), 10.0, dtype=torch.float64)
    pairs = ref.pairs_within(x, L, 0.9)
    assert pairs == 2
    r = dict(steps=1000, chains=1, n=3, pairs=pairs,
             trace=dict(busy_s=2e-6, window_s=4e-6, device_ops=5000))
    least = max(36 * 2 / 67e12, 24 * 3 / 3.35e12)
    assert yardstick.least_seconds(*yardstick.force_work(2, 3)) == least
    assert pair_roofline.read(r) == pytest.approx(100 * 1000 * least / 2e-6,
                                                  rel=1e-15)
    assert step_mfu.read(r) == pytest.approx(
        100 * 1000 * 72 / (67e12 * 4e-6), rel=1e-15)
    assert pair_roofline.read(dict(r, pairs=0)) is None


def test_noise_keys_and_sweep_are_the_programs():
    """The reference's definitions give the program's numbers: the normal
    stream, the key split and the swap sweep (the program's plain
    versions, on the CPU)."""
    from chiron_tpu_torch import utils
    from chiron_tpu_torch.ops.lj_cull import splitmix_noise_plain
    from chiron_tpu_torch.parallel import tempering

    from h100bench.reference import lj as ref

    for seed, step in ((0, 0), (2 ** 31 + 12345, 7), (2 ** 40 + 3, 99999)):
        z = splitmix_noise_plain(seed & ref.MASK32, step, 512).double()
        np.testing.assert_allclose(ref.lane_normals([seed], step, 512)[0],
                                   z, rtol=2e-6, atol=2e-6)
    keys = [utils.prng_key(2 ** 33 + 5), 17, 2 ** 63 + 1]
    assert ref.propagation_seeds(keys) == tuple(
        map(list, tempering.split_keys(keys)))
    assert ref.split(keys[0], 5) == utils.split(keys[0], 5)

    class Ladder(tempering.ParallelTemperingSampler):
        def __init__(self, kTs, iteration):
            self.kTs = np.asarray(kTs, dtype=np.float32)
            self.n_replicas = len(kTs)
            self._iteration = iteration
            self.n_proposed_swaps = self.n_accepted_swaps = 0
            self.velocities = torch.ones(len(kTs), 1, 1)
            self._local = slice(0, len(kTs))
            self.device = torch.device("cpu")

    rng = np.random.default_rng(1)
    kTs = (0.9977 * 1.008141 ** np.arange(16)).astype(np.float32)
    for it in range(1, 9):
        U = (-20000 + 300 * rng.standard_normal(16)).astype(np.float32)
        lad = Ladder(rng.permutation(kTs), it)
        want = ref.swap_sweep(lad.kTs, U, it, 2 ** 35 + 1)
        lad.mix_replicas(U, np.random.default_rng([2 ** 35 + 1, it]))
        np.testing.assert_array_equal(lad.kTs, want)


def test_baoab_at_collision_rate_zero_conserves_energy():
    """The reference's integrator, at gamma 0 on a small fluid, keeps the
    total energy (with the potential shifted to 0 at the cutoff, which
    leaves the force as it is): it integrates what it says it does."""
    from h100bench.reference import lj as ref

    lj = ref.LJ(sigma=0.34, epsilon=0.995792, cutoff=0.85)
    L = 2.04
    g = np.arange(6) * (L / 6)
    x = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(1, -1, 3)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(x.shape) * math.sqrt(1.0 / 39.948)
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    Lt = torch.full((1, 3), L, dtype=torch.float64)
    lng = ref.Langevin(dt=0.001, gamma=0.0, mass=39.948)

    def total(xx, vv):
        _, U = ref.force_energy(xx, Lt, lj, ref.pair_list(xx, Lt, 1.0))
        s6 = (lj.sigma / lj.cutoff) ** 6
        shift = 4.0 * lj.epsilon * (s6 * s6 - s6)
        U = float(U[0]) - shift * ref.pairs_within(xx, Lt, lj.cutoff)
        return U + 0.5 * 39.948 * float((vv ** 2).sum())

    e0 = total(xt, vt)
    x1, v1, _, _ = ref.baoab(xt, vt, Lt, lj, lng, [1.0], [1], 0, 200, 256)
    assert abs(total(x1, v1) - e0) < 1e-3 * abs(e0)
