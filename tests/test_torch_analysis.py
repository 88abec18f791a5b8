"""The port's free-energy analysis (``chiron_tpu_torch.analysis``) against
the JAX package's on the same inputs.

The host estimators are the port's own copy of the JAX package's numpy
code: every one is held to JAX's on the same harmonic-oscillator samples to
1e-10 (float64).  The device parts are torch: the fixed-iteration solve and
the perturbed free energies against JAX's float32 functions (1e-4), the
implicit solve in float64 against the host solver (1e-8) and its gradient
against JAX's ``custom_vjp`` on one ``u_kn`` (1e-4 relative, JAX in
float32) and against a central difference of the host solver (1e-6
relative).  Mirrors ``tests/test_analysis.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chiron_tpu.analysis as ja
import chiron_tpu_torch.analysis as ta


def _ho_samples(spring_constants, n_samples, seed=0):
    """1D harmonic oscillators at beta = 1: u_k(x) = 0.5 K_k x^2, analytic
    f_k = -0.5 ln(2 pi / K_k)."""
    rng = np.random.default_rng(seed)
    x_n = np.concatenate([rng.normal(0.0, 1.0 / np.sqrt(K), size=n_samples)
                          for K in spring_constants])
    u_kn = 0.5 * np.asarray(spring_constants)[:, None] * x_n[None, :] ** 2
    N_k = np.full(len(spring_constants), n_samples)
    f_analytic = -0.5 * np.log(2 * np.pi / np.asarray(spring_constants))
    return u_kn, N_k, f_analytic - f_analytic[0], x_n


@pytest.fixture(scope="module")
def ladder():
    return _ho_samples([1.0, 2.0, 4.0, 8.0], 1500)


def _close(a, b, tol=1e-10):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# The host estimators: JAX's numpy code, to 1e-10
# ---------------------------------------------------------------------------


def test_mbar_solve_matches_jax_and_analytic(ladder):
    u_kn, N_k, f_an, _ = ladder
    f = ta.mbar_solve(u_kn, N_k)
    _close(f, ja.mbar_solve(u_kn, N_k))
    assert f[0] == 0.0 and np.allclose(f, f_an, atol=0.08)


@pytest.mark.parametrize("name", ["weights", "covariance", "overlap",
                                  "perturbed", "bootstrap"])
def test_mbar_host_estimators_match_jax(ladder, name):
    u_kn, N_k, _, x_n = ladder
    f = ja.mbar_solve(u_kn, N_k)
    if name == "weights":
        _close(ta.mbar_weights(u_kn, N_k, f), ja.mbar_weights(u_kn, N_k, f))
    elif name == "covariance":
        _close(ta.mbar_covariance(u_kn, N_k, f), ja.mbar_covariance(u_kn, N_k, f))
    elif name == "overlap":
        a, b = ta.mbar_overlap(u_kn, N_k, f), ja.mbar_overlap(u_kn, N_k, f)
        _close(a["matrix"], b["matrix"])
        _close(a["eigenvalues"], b["eigenvalues"])
        assert a["scalar"] == pytest.approx(b["scalar"], abs=1e-10)
    elif name == "perturbed":
        u_ln = 0.5 * np.array([3.0, 16.0])[:, None] * x_n[None, :] ** 2
        for x, y in zip(ta.mbar_perturbed_free_energies(u_kn, N_k, f, u_ln),
                        ja.mbar_perturbed_free_energies(u_kn, N_k, f, u_ln)):
            _close(x, y)
    else:
        for x, y in zip(ta.mbar_bootstrap(u_kn, N_k, n_bootstrap=8, seed=1),
                        ja.mbar_bootstrap(u_kn, N_k, n_bootstrap=8, seed=1)):
            _close(x, y)


def test_mbar_bootstrap_iteration_layout_matches_jax(ladder):
    u_kn, _, _, _ = ladder
    T, R = 1500, 4
    N_k = np.full(4, T)
    for major in (False, True):
        _close(ta.mbar_bootstrap(u_kn, N_k, 6, seed=2, iteration_layout=(T, R),
                                 iteration_major=major)[0],
               ja.mbar_bootstrap(u_kn, N_k, 6, seed=2, iteration_layout=(T, R),
                                 iteration_major=major)[0])
    with pytest.raises(ValueError):
        ta.mbar_bootstrap(u_kn, np.array([1500, 1500, 3000, 0]), 2,
                          iteration_layout=(T, R))


def test_exp_and_bar_match_jax():
    rng = np.random.default_rng(5)
    w_F, w_R = rng.normal(1.0, 0.7, 500), rng.normal(-0.8, 0.7, 400)
    _close(ta.exp_free_energy(w_F), ja.exp_free_energy(w_F))
    _close(ta.bar(w_F, w_R), ja.bar(w_F, w_R))
    with pytest.raises(ValueError):
        ta.exp_free_energy(np.array([1.0]))


def test_timeseries_tools_match_jax():
    rng = np.random.default_rng(6)
    a = np.empty(600)
    a[0] = 0.0
    for t in range(1, a.size):  # AR(1), phi = 0.8, with a transient
        a[t] = 0.8 * a[t - 1] + rng.normal()
    a[:50] += np.linspace(8.0, 0.0, 50)
    assert ta.statistical_inefficiency(a) == pytest.approx(
        ja.statistical_inefficiency(a), abs=1e-10)
    assert ta.detect_equilibration(a, nskip=7) == pytest.approx(
        ja.detect_equilibration(a, nskip=7), abs=1e-10)
    assert np.array_equal(ta.subsample_correlated_data(a),
                          ja.subsample_correlated_data(a))


def test_mbar_estimator_matches_jax(ladder):
    """The front end: 3D reporter layout, differences and their errors,
    overlap, entropy/enthalpy, expectations."""
    u_kn, N_k, f_an, x_n = ladder
    est_t, est_j = ta.MBAREstimator(), ja.MBAREstimator()
    u_3d = u_kn.reshape(4, 4, 1500).transpose(2, 0, 1)  # (T, S, R)
    est_t.initialize(u_3d, N_k)
    est_j.initialize(u_3d, N_k)
    _close(est_t.f_k, est_j.f_k)
    assert est_t._iteration_layout == est_j._iteration_layout == (1500, 4)
    _close(est_t.get_free_energy_difference(return_uncertainty=True),
           est_j.get_free_energy_difference(return_uncertainty=True))
    for x, y in zip(est_t.delta_f_ij(), est_j.delta_f_ij()):
        _close(x, y)
    for x, y in zip(est_t.compute_entropy_and_enthalpy(),
                    est_j.compute_entropy_and_enthalpy()):
        _close(x, y)
    A_n = x_n ** 2  # one value a column of the flattened u_kn
    _close(est_t.compute_expectation(A_n, 2, return_uncertainty=True),
           est_j.compute_expectation(A_n, 2, return_uncertainty=True))
    for x, y in zip(est_t.compute_expectations(A_n, return_uncertainty=True),
                    est_j.compute_expectations(A_n, return_uncertainty=True)):
        _close(x, y)
    _close(est_t.compute_overlap()["matrix"], est_j.compute_overlap()["matrix"])
    _close(est_t.bootstrap_d_f_k(4, seed=3), est_j.bootstrap_d_f_k(4, seed=3))


def test_mbar_input_validation():
    with pytest.raises(ValueError):
        ta.mbar_solve(np.zeros((2, 10)), np.array([5, 4]))  # sum != N
    with pytest.raises(ValueError):
        ta.mbar_solve(np.zeros((2, 10)), np.array([5, 5, 5]))  # wrong K
    with pytest.raises(RuntimeError):
        ta.MBAREstimator().f_k


# ---------------------------------------------------------------------------
# The device parts: torch against JAX
# ---------------------------------------------------------------------------


def test_mbar_solve_torch_matches_jax(ladder):
    u_kn, N_k, _, _ = ladder
    u32 = u_kn.astype(np.float32)
    f_t = ta.mbar_solve_torch(torch.tensor(u32), torch.tensor(N_k), 300)
    f_j = np.asarray(ja.mbar_solve_jax(u32, N_k, 300))
    assert f_t.dtype == torch.float32
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0, atol=1e-4)
    assert np.allclose(f_t.numpy(), ta.mbar_solve(u_kn, N_k), atol=5e-3)


def test_mbar_solve_implicit_f64_matches_host(ladder):
    u_kn, N_k, _, _ = ladder
    f = ta.mbar_solve_implicit(torch.tensor(u_kn), torch.tensor(N_k))
    assert f.dtype == torch.float64 and float(f[0]) == 0.0
    np.testing.assert_allclose(f.numpy(), ta.mbar_solve(u_kn, N_k), rtol=0,
                               atol=1e-8)


def test_mbar_solve_implicit_f32_matches_jax(ladder):
    u_kn, N_k, _, _ = ladder
    u32 = u_kn.astype(np.float32)
    f_t = ta.mbar_solve_implicit(torch.tensor(u32), torch.tensor(N_k))
    f_j = np.asarray(ja.mbar_solve_implicit(jnp.asarray(u32), jnp.asarray(N_k)))
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def grad_case():
    """One u_kn (3 states, 300 samples each), a random cotangent, and JAX's
    custom_vjp gradient of <c, f_k(u_kn)> (float32)."""
    u_kn, N_k, _, _ = _ho_samples([1.0, 2.0, 4.0], 300, seed=9)
    c = np.random.default_rng(10).normal(size=3)
    g_j = jax.grad(lambda u: jnp.dot(jnp.asarray(c, jnp.float32),
                                     ja.mbar_solve_implicit(u, jnp.asarray(N_k))))(
        jnp.asarray(u_kn, jnp.float32))
    return u_kn, N_k, c, np.asarray(g_j)


def _port_grad(u_kn, N_k, c, dtype):
    u = torch.tensor(u_kn, dtype=dtype, requires_grad=True)
    f = ta.mbar_solve_implicit(u, torch.tensor(N_k))
    (torch.tensor(c, dtype=dtype) * f).sum().backward()
    return u.grad.numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mbar_implicit_grad_matches_jax_custom_vjp(grad_case, dtype):
    u_kn, N_k, c, g_j = grad_case
    g_t = _port_grad(u_kn, N_k, c, dtype)
    scale = np.abs(g_j).max()
    assert np.abs(g_t - g_j).max() / scale < 1e-4


def test_mbar_implicit_grad_matches_host_central_difference(grad_case):
    """d f_2 / d theta where u_2 -> theta u_2: the f64 implicit gradient
    against a central difference of the f64 host solver, 1e-6 relative."""
    u_kn, N_k, _, _ = grad_case
    u = torch.tensor(u_kn, requires_grad=True)
    ta.mbar_solve_implicit(u, torch.tensor(N_k))[2].backward()
    g = float((u.grad[2] * u.detach()[2]).sum())

    def f_host(theta):
        v = u_kn.copy()
        v[2] = theta * v[2]
        return ta.mbar_solve(v, N_k, tol=1e-14)[2]

    h = 1e-5
    fd = (f_host(1 + h) - f_host(1 - h)) / (2 * h)
    assert g == pytest.approx(fd, rel=1e-6)


def test_zero_count_state_matches_jax_and_host_reweighting():
    """A zero-count (perturbed) state is masked out of the denominator
    (-inf), and its f is the host reweighting value; gradients stay
    finite."""
    Ks, n = [1.0, 4.0], 2000
    rng = np.random.default_rng(2)
    xs = np.concatenate([rng.normal(0, 1 / np.sqrt(K), size=n) for K in Ks])
    u_kn = 0.5 * np.asarray(Ks)[:, None] * xs[None, :] ** 2
    u_aug = np.vstack([u_kn, 0.5 * 9.0 * xs[None, :] ** 2])
    N_aug = np.array([n, n, 0])
    f_host = ta.mbar_solve(u_kn, np.array([n, n]))
    f_target, _ = ta.mbar_perturbed_free_energies(u_kn, np.array([n, n]),
                                                  f_host, u_aug[2:3])
    f_sc = ta.mbar_solve_torch(torch.tensor(u_aug, dtype=torch.float32),
                               torch.tensor(N_aug))
    np.testing.assert_allclose(
        f_sc.numpy(), np.asarray(ja.mbar_solve_jax(u_aug.astype(np.float32), N_aug)),
        rtol=0, atol=1e-4)
    u = torch.tensor(u_aug, requires_grad=True)
    f = ta.mbar_solve_implicit(u, torch.tensor(N_aug))
    assert torch.isfinite(f).all()
    np.testing.assert_allclose(f[:2].detach().numpy(), f_host, rtol=0, atol=1e-8)
    assert float(f[2].detach()) == pytest.approx(float(f_target[0]), abs=1e-8)
    f[2].backward()
    assert torch.isfinite(u.grad).all()


def test_perturbed_torch_matches_jax_and_its_grad_is_the_target_weights(ladder):
    u_kn, N_k, _, x_n = ladder
    f = ta.mbar_solve(u_kn, N_k)
    u_ln = 0.5 * np.array([[3.0]]) * x_n[None, :] ** 2
    u = torch.tensor(u_ln, requires_grad=True)
    f_t = ta.mbar_perturbed_free_energies_torch(torch.tensor(u_kn),
                                                torch.tensor(N_k),
                                                torch.tensor(f), u)
    f_j = ja.mbar_perturbed_free_energies_jax(
        jnp.asarray(u_kn, jnp.float32), jnp.asarray(N_k),
        jnp.asarray(f, jnp.float32), jnp.asarray(u_ln, jnp.float32))
    np.testing.assert_allclose(f_t.detach().numpy(), np.asarray(f_j), rtol=1e-4)
    _close(f_t.detach().numpy(),
           ta.mbar_perturbed_free_energies(u_kn, N_k, f, u_ln)[0])
    f_t.sum().backward()
    w = ta.mbar_weights(np.vstack([u_kn, u_ln]), np.append(N_k, 0),
                        np.append(f, f_t.detach().numpy()))[-1]
    _close(u.grad.numpy()[0], w, tol=1e-9)
