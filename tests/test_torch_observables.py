"""The port's observables (``chiron_tpu_torch.observables``) against the JAX
package's on the same inputs, at float32 tolerance: the RDF (its histogram
exactly), the LJ virial and its pressure (1e-5 relative), the heat
capacity, unwrap (1e-6 nm), MSD and VACF (1e-5 relative, 1e-7 absolute),
diffusion, and MBAR expectations.  The exact constructions of
``tests/test_observables.py`` are held on the port too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chiron_tpu.analysis as ja
import chiron_tpu.observables as jo
import chiron_tpu_torch.analysis as ta
import chiron_tpu_torch.observables as to
import chiron_tpu_torch.units as tu

L = 4.0
SIGMA, EPS, CUTOFF = 0.34, 0.99579, 1.02


@pytest.fixture(scope="module")
def frames():
    """10 frames of 200 particles drifting through an L=4 nm box, wrapped,
    from a seed."""
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.normal(0, 0.05, (10, 200, 3)), axis=0) + rng.uniform(
        0, L, (1, 200, 3))
    return (x % L).astype(np.float32), np.cumsum(
        rng.normal(0, 0.05, (10, 200, 3)), axis=0).astype(np.float32)


def test_rdf_matches_jax(frames):
    wrapped, _ = frames
    box = np.eye(3) * L
    r_t, g_t = to.radial_distribution_function(torch.tensor(wrapped),
                                               torch.tensor(box), n_bins=50)
    r_j, g_j = jo.radial_distribution_function(wrapped, box, n_bins=50)
    assert np.array_equal(r_t, r_j)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-12, atol=0)
    # one frame's histogram exactly
    h_t = to._rdf_histogram(torch.tensor(wrapped[0]), torch.full((3,), L),
                            1.5, 30)
    h_j = jo._rdf_histogram(jnp.asarray(wrapped[0]), jnp.full((3,), L,
                                                              jnp.float32),
                            jnp.float32(1.5), 30)
    assert np.array_equal(h_t.numpy(), np.asarray(h_j))


def test_rdf_of_ideal_gas_is_unity_and_rmax_guard():
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, L, size=(20, 500, 3)).astype(np.float32)
    r, g = to.radial_distribution_function(pos, np.eye(3) * L, n_bins=40,
                                           device="cpu")
    assert np.all(np.abs(g[5:] - 1.0) < 0.1) and r[-1] < 0.5 * L + 1e-6
    with pytest.raises(ValueError, match="half the box"):
        to.radial_distribution_function(np.zeros((4, 3)), np.eye(3) * L,
                                        r_max=3.0, device="cpu")


def test_lj_virial_and_pressure_match_jax(frames):
    wrapped, _ = frames
    box_diag = np.full(3, L, np.float32)
    for f in wrapped[:3]:
        w_t = float(to.lj_virial(torch.tensor(f), torch.tensor(box_diag),
                                 SIGMA, EPS, CUTOFF))
        w_j = float(jo.lj_virial(jnp.asarray(f), jnp.asarray(box_diag),
                                 SIGMA, EPS, CUTOFF))
        assert w_t == pytest.approx(w_j, rel=1e-5)
    p_t = to.lj_virial_pressure(torch.tensor(wrapped), torch.tensor(np.eye(3) * L),
                                120.0 * tu.kelvin, SIGMA, EPS, CUTOFF)
    p_j = jo.lj_virial_pressure(wrapped, np.eye(3) * L, 120.0, SIGMA, EPS,
                                CUTOFF)
    assert p_t == pytest.approx(p_j, rel=1e-5)


def test_lj_virial_matches_finite_difference():
    """W == -3V dU/dV under uniform scaling (the exact virial identity)."""
    rng = np.random.default_rng(3)
    n = 64
    pos = rng.uniform(0, L, size=(n, 3))

    def U(scale):
        p = torch.tensor(pos * scale, dtype=torch.float64)
        b = torch.full((3,), L * scale, dtype=torch.float64)
        d = p[:, None, :] - p[None, :, :]
        d = d - b * torch.round(d / b)
        r2 = (d * d).sum(-1)
        ids = torch.arange(n)
        m = (r2 < CUTOFF ** 2) & (ids[:, None] < ids[None, :])
        i6 = (SIGMA ** 2 / torch.where(m, r2, torch.ones_like(r2))) ** 3
        return float(torch.where(m, 4 * EPS * (i6 * i6 - i6), 0.0 * i6).sum())

    W = float(to.lj_virial(torch.tensor(pos, dtype=torch.float32),
                           torch.full((3,), L), SIGMA, EPS, CUTOFF))
    h = 1e-5  # V = s^3 V0, so W = -3V dU/dV = -dU/ds at s = 1
    dU = (U(1 + h) - U(1 - h)) / (2 * h)
    assert W == pytest.approx(-dU, rel=1e-3)


def test_pressure_of_noninteracting_gas_is_ideal():
    rng = np.random.default_rng(1)
    pos = rng.uniform(0, L, (5, 30, 3)).astype(np.float32)
    p = to.lj_virial_pressure(pos, np.eye(3) * L, 300.0, SIGMA, 0.0, CUTOFF,
                              device="cpu")
    assert p == pytest.approx(30 * tu.kB_MD * 300.0 / L ** 3, rel=1e-12)
    assert to.PRESSURE_MD_TO_BAR == jo.PRESSURE_MD_TO_BAR


def test_heat_capacity_matches_jax():
    E = np.random.default_rng(2).normal(-500.0, 7.0, 4000)
    assert to.heat_capacity_nvt(torch.tensor(E), 300.0) == pytest.approx(
        jo.heat_capacity_nvt(E, 300.0), rel=1e-12)


def test_unwrap_matches_jax_and_recovers_a_ballistic_path(frames):
    wrapped, _ = frames
    u_t = to.unwrap_trajectory(torch.tensor(wrapped), torch.eye(3) * L)
    u_j = np.asarray(jo.unwrap_trajectory(wrapped, np.eye(3) * L))
    np.testing.assert_allclose(u_t.numpy(), u_j, rtol=0, atol=1e-6)
    t = np.arange(50, dtype=np.float32)
    path = np.zeros((50, 1, 3), np.float32)
    path[:, 0, 0] = (0.3 * t) % 2.0
    out = to.unwrap_trajectory(path, [2.0, 2.0, 2.0], device="cpu").numpy()
    assert np.allclose(out[:, 0, 0], 0.3 * t, atol=1e-4)


@pytest.mark.parametrize("wrapped_input", [False, True])
def test_msd_matches_jax(frames, wrapped_input):
    wrapped, walk = frames
    if wrapped_input:
        m_t = to.mean_squared_displacement(torch.tensor(wrapped), [L, L, L])
        m_j = jo.mean_squared_displacement(wrapped, [L, L, L])
    else:
        m_t = to.mean_squared_displacement(torch.tensor(walk + 50.0))
        m_j = jo.mean_squared_displacement(walk + 50.0)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-5,
                               atol=1e-7)


def test_msd_and_diffusion_of_random_walk():
    """A random walk with step variance s^2 an axis: MSD(k) = 3 s^2 k,
    D = s^2 / (2 dt); the port's D equals JAX's."""
    rng = np.random.default_rng(4)
    s, dt = 0.05, 0.1
    walk = np.cumsum(rng.normal(0, s, (200, 400, 3)), axis=0).astype(np.float32)
    msd = to.mean_squared_displacement(walk, device="cpu").numpy()
    assert abs(msd[50] / (3 * s * s * 50) - 1.0) < 0.1
    times = np.arange(len(msd)) * dt
    D = to.diffusion_coefficient(walk, times, device="cpu")
    assert abs(D / (s * s / (2 * dt)) - 1.0) < 0.1
    assert D == pytest.approx(jo.diffusion_coefficient(walk, times), rel=1e-5)


def test_vacf_matches_jax():
    rng = np.random.default_rng(2)
    v = rng.normal(size=(60, 128, 3)).astype(np.float32)
    c_t = to.velocity_autocorrelation(torch.tensor(v))
    np.testing.assert_allclose(c_t.numpy(),
                               np.asarray(jo.velocity_autocorrelation(v)),
                               rtol=1e-5, atol=1e-6)
    assert abs(float(c_t[0]) - 1.0) < 1e-6 and (c_t[1:10].abs() < 0.05).all()
    ones = to.velocity_autocorrelation(np.ones((30, 10, 3), np.float32),
                                       device="cpu")
    assert torch.allclose(ones, torch.ones(30), atol=1e-6)


def test_mbar_expectation_matches_jax_and_respects_layout():
    rng = np.random.default_rng(6)
    T, R = 50, 2
    xs_r = rng.normal(0, 1, size=(R, T))
    u_kn = 0.5 * np.array([1.0, 1.5])[:, None] * xs_r.reshape(-1)[None, :] ** 2
    est_t, est_j = ta.MBAREstimator(), ja.MBAREstimator()
    est_t.initialize(u_kn, np.array([T, T]), iteration_layout=(T, R))
    est_j.initialize(u_kn, np.array([T, T]), iteration_layout=(T, R))
    got = to.mbar_expectation(est_t, torch.tensor(xs_r.T ** 2), state_index=1)
    assert got == pytest.approx(
        jo.mbar_expectation(est_j, xs_r.T ** 2, state_index=1), abs=1e-12)
    with pytest.raises(ValueError, match="iterations, replicas"):
        to.mbar_expectation(est_t, np.zeros((R, T + 1)))
    est2 = ta.MBAREstimator()
    est2.initialize(u_kn, np.array([T, T]))
    with pytest.raises(ValueError, match="iteration layout"):
        to.mbar_expectation(est2, np.zeros((T, R)))


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="holds the default where no card is visible")
def test_host_data_goes_to_the_card_by_default():
    """Without ``device="cpu"`` host data is sent to the card, so with no
    card the entry points raise instead of running on the CPU."""
    pos = np.zeros((2, 4, 3), np.float32)
    for call in (lambda: to.radial_distribution_function(pos, np.eye(3) * L),
                 lambda: to.mean_squared_displacement(pos),
                 lambda: to.velocity_autocorrelation(pos),
                 lambda: to.unwrap_trajectory(pos, [L, L, L])):
        with pytest.raises((RuntimeError, AssertionError)):
            call()
    # a tensor stays on its device whatever ``device`` says
    x = torch.zeros((2, 4, 3))
    assert to.unwrap_trajectory(x, [L, L, L]).device.type == "cpu"
