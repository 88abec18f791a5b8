"""Free-energy analysis: MBAR and its companions (port of
``chiron_tpu/analysis.py``).

The host estimators are the JAX package's numpy code, kept here as this
package's own copy, behaviour for behaviour: the MBAR equations solved in
float64 (self-consistent iteration, then a Newton polish), weights, the
asymptotic covariance (Shirts & Chodera 2008, Eq. D6), perturbed
free energies, overlap, bootstrap, EXP, BAR, the timeseries tools and
:class:`MBAREstimator`.

The JAX parts are torch functions on the tensors' device: the fixed-
iteration solve (:func:`mbar_solve_torch`, JAX's ``mbar_solve_jax``),
:func:`mbar_perturbed_free_energies_torch`, and the differentiable solve
:func:`mbar_solve_implicit`, a ``torch.autograd.Function`` whose backward is
the implicit-function VJP (one ``(K-1, K-1)`` solve and two matmuls).
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

log = logging.getLogger("chiron_tpu_torch")

def _logsumexp(a: np.ndarray, axis=None):
    a = np.asarray(a, dtype=np.float64)
    a_max = np.max(a, axis=axis, keepdims=True)
    a_max = np.where(np.isfinite(a_max), a_max, 0.0)
    s = np.sum(np.exp(a - a_max), axis=axis, keepdims=True)
    out = np.log(s) + a_max
    if axis is not None:
        out = np.squeeze(out, axis=axis)
    else:
        out = out.reshape(())
    return out


def _log_mixture_denominator(
    u_kn: np.ndarray, N_k: np.ndarray, f_k: np.ndarray
) -> np.ndarray:
    """ln sum_j N_j exp(f_j - u_jn), shape (N,) -- the MBAR mixture
    denominator.  Zero-count states are masked out (log N = -inf), so the
    same expression serves sampled and augmented (perturbed) systems."""
    N_k = np.asarray(N_k, dtype=np.float64)
    log_N_k = np.where(N_k > 0, np.log(np.maximum(N_k, 1)), -np.inf)
    return _logsumexp((f_k + log_N_k)[:, None] - u_kn, axis=0)


def mbar_solve(
    u_kn: np.ndarray,
    N_k: np.ndarray,
    tol: float = 1.0e-10,
    max_sc_iterations: int = 2000,
    max_newton_iterations: int = 50,
    f_init: np.ndarray = None,
) -> np.ndarray:
    """Solve the MBAR equations for dimensionless free energies f_k.

    Parameters
    ----------
    u_kn : (K, N) array
        Reduced potential of every sample n evaluated at every state k.
    N_k : (K,) array
        Number of samples drawn from each state; sum(N_k) == N.
    f_init : optional (K,) array
        Warm start (e.g. the full-data solution when solving bootstrap
        replicates); the self-consistent stage then converges in a few
        iterations instead of hundreds.

    Returns
    -------
    f_k : (K,) float64 array with f_k[0] == 0.

    Notes
    -----
    Self-consistent iteration
        f_k = -ln sum_n exp(-u_kn - ln sum_j N_j exp(f_j - u_jn))
    followed by Newton-Raphson on the gradient of the MBAR objective
        g_k = N_k - N_k sum_n W_kn,   W_kn = exp(f_k - u_kn)/sum_j N_j exp(f_j - u_jn)
    """
    u_kn = np.asarray(u_kn, dtype=np.float64)
    N_k = np.asarray(N_k, dtype=np.float64)
    K, N = u_kn.shape
    if N_k.shape != (K,):
        raise ValueError(f"N_k must have shape ({K},), got {N_k.shape}")
    if int(N_k.sum()) != N:
        raise ValueError(
            f"sum(N_k) = {int(N_k.sum())} must equal the number of samples N = {N}"
        )

    if f_init is not None:
        f_k = np.asarray(f_init, dtype=np.float64).copy()
        f_k -= f_k[0]
    else:
        f_k = np.zeros(K)

    def log_denominator(f):
        return _log_mixture_denominator(u_kn, N_k, f)

    # -- self-consistent warm-up ------------------------------------------
    for _ in range(max_sc_iterations):
        log_denom = log_denominator(f_k)
        f_new = -_logsumexp(-u_kn - log_denom[None, :], axis=1)
        f_new -= f_new[0]
        delta = np.max(np.abs(f_new - f_k))
        f_k = f_new
        if delta < 1e-6:
            break

    # -- Newton polish on states 1..K-1 (f_0 pinned to 0) ------------------
    for _ in range(max_newton_iterations):
        log_denom = log_denominator(f_k)  # (N,)
        # W_kn = exp(f_k - u_kn - log_denom)
        logW = f_k[:, None] - u_kn - log_denom[None, :]
        W = np.exp(logW)  # (K, N)
        NW = N_k[:, None] * W
        g = N_k - NW.sum(axis=1)  # gradient, (K,)
        # Hessian H_ij = -N_i N_j sum_n W_in W_jn  (i != j)
        #         H_ii = N_i sum_n W_in (1 - N_i W_in)
        H = -NW @ NW.T / 1.0
        np.fill_diagonal(H, (NW * (1.0 - NW)).sum(axis=1))
        # Solve on the reduced system (drop state 0).
        # Newton step on F(f): f <- f - H^-1 grad(F), with grad(F) = -g.
        try:
            df = np.linalg.solve(H[1:, 1:], g[1:])
        except np.linalg.LinAlgError:
            break
        f_k[1:] += df
        f_k -= f_k[0]
        if np.max(np.abs(df)) < tol:
            break

    return f_k


def mbar_weights(u_kn: np.ndarray, N_k: np.ndarray, f_k: np.ndarray) -> np.ndarray:
    """Normalized MBAR weight matrix W_kn (each row sums to 1)."""
    u_kn = np.asarray(u_kn, dtype=np.float64)
    log_denom = _log_mixture_denominator(u_kn, N_k, f_k)
    logW = f_k[:, None] - u_kn - log_denom[None, :]
    return np.exp(logW)


def mbar_covariance(
    u_kn: np.ndarray, N_k: np.ndarray, f_k: np.ndarray
) -> np.ndarray:
    """Asymptotic covariance matrix Theta of the MBAR free energies.

    Shirts & Chodera, J. Chem. Phys. 129, 124105 (2008), Eq. D6 in the
    SVD form (the estimator pymbar exposes through ``MBAR.theta``, which
    the reference chiron inherits from pymbar):

        W = U S V^T  (economy SVD of the N x K weight matrix)
        Theta = V S [I_K - S V^T diag(N_k) V S]^+ S V^T

    Uncertainty of a free-energy difference:
        d(f_i - f_j) = sqrt(Theta_ii + Theta_jj - 2 Theta_ij)

    The pseudo-inverse absorbs the one exactly-singular direction (the
    common additive gauge of the f_k).
    """
    W = mbar_weights(u_kn, N_k, f_k).T  # (N, K): W_nk
    N_k = np.asarray(N_k, dtype=np.float64)
    K = W.shape[1]
    _, S, Vt = np.linalg.svd(W, full_matrices=False)
    V = Vt.T
    Sig = np.diag(S)
    inner = np.eye(K) - Sig @ (V.T * N_k) @ V @ Sig
    return V @ Sig @ np.linalg.pinv(inner, rcond=1e-10) @ Sig @ V.T


def mbar_perturbed_free_energies(
    u_kn: np.ndarray, N_k: np.ndarray, f_k: np.ndarray, u_ln: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Free energies of UNSAMPLED (perturbed) states from existing samples.

    The core MBAR reweighting identity: for any target state l with
    reduced potentials ``u_ln`` evaluated on the pooled samples,

        f_l = -ln sum_n exp(-u_ln) / sum_k N_k exp(f_k - u_kn)

    (pymbar's ``compute_perturbed_free_energies``; the reference
    inherits it via chiron/analysis.py:35).  Uncertainties come from the
    Eq. D6 covariance of the AUGMENTED system: the L target states are
    appended as zero-count states, which leaves the sampled-state
    solution unchanged but lets the same SVD machinery price the
    perturbed estimates.  Returns ``(f_l, d_f_l)`` with f in the
    f_k[0] == 0 gauge of the input and d_f_l the standard error of
    f_l - f_0.
    """
    u_kn = np.asarray(u_kn, dtype=np.float64)
    u_ln = np.asarray(u_ln, dtype=np.float64)
    if u_ln.ndim == 1:
        u_ln = u_ln[None, :]
    if u_ln.shape[1] != u_kn.shape[1]:
        raise ValueError(
            f"u_ln has {u_ln.shape[1]} samples but u_kn has "
            f"{u_kn.shape[1]}; both must cover the pooled samples"
        )
    N_k = np.asarray(N_k, dtype=np.float64)
    log_denom = _log_mixture_denominator(u_kn, N_k, f_k)
    f_l = -_logsumexp(-u_ln - log_denom[None, :], axis=1)
    K, L = u_kn.shape[0], u_ln.shape[0]
    u_aug = np.vstack([u_kn, u_ln])
    N_aug = np.concatenate([N_k, np.zeros(L)])
    f_aug = np.concatenate([np.asarray(f_k, dtype=np.float64), f_l])
    th = mbar_covariance(u_aug, N_aug, f_aug)
    var = np.maximum(
        th.diagonal()[K:] + th[0, 0] - 2.0 * th[0, K:], 0.0
    )
    return f_l, np.sqrt(var)


def mbar_overlap(
    u_kn: np.ndarray, N_k: np.ndarray, f_k: np.ndarray
) -> dict:
    """State-overlap diagnostics from the MBAR weights.

    ``matrix[i, j] = sum_n N_j W_ni W_nj`` is the probability that a
    sample drawn from state i would be "assigned" to state j; each row
    sums to 1.  Its largest eigenvalue is exactly 1, and the
    second-largest eigenvalue measures how close the state graph is to
    disconnected.  ``scalar`` follows pymbar's ``compute_overlap``
    convention: ``1 - eigenvalues[1]``, so values near 1 mean a
    well-connected ladder and values near 0 mean at least one state
    pair has essentially no phase-space overlap (the corresponding
    Delta f is unreliable).
    """
    W = mbar_weights(u_kn, N_k, f_k)  # (K, N)
    N_k = np.asarray(N_k, dtype=np.float64)
    O = W @ (W.T * N_k[None, :])  # O_ij = sum_n N_j W_in W_jn
    eigvals = np.sort(np.linalg.eigvals(O).real)[::-1]
    return {
        "matrix": O,
        "eigenvalues": eigvals,
        "scalar": float(1.0 - eigvals[1]) if len(eigvals) > 1 else 1.0,
    }


def mbar_bootstrap(
    u_kn: np.ndarray, N_k: np.ndarray, n_bootstrap: int = 50,
    seed: int = 0, iteration_layout: Tuple[int, int] = None,
    iteration_major: bool = False, f_init: np.ndarray = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Bootstrap free energies: resample-and-resolve replicates.

    Complements the asymptotic covariance (:func:`mbar_covariance`) the
    way pymbar 4's ``uncertainty_method="bootstrap"`` does -- the two
    estimates should agree for well-sampled ladders, and disagreement
    flags correlated or under-sampled data.

    Two resampling schemes:

    * default (independent per-state sampling): samples are resampled
      with replacement WITHIN each origin-state block, so the columns
      of ``u_kn`` must be ordered by the state that GENERATED them --
      the first ``N_k[0]`` columns drawn from state 0, and so on.
    * ``iteration_layout=(T, R)`` (replica-exchange data): columns are
      ordered by replica, n = r*T + t (the layout
      ``MBAREstimator.initialize`` produces from the reporter's stacked
      3D array) -- or, with ``iteration_major=True``, by iteration,
      n = t*R + r (the layout ``ParallelTemperingSampler`` builds) --
      and a replica's block mixes every state it visited through swaps,
      so per-block resampling would break the N_k composition.
      Instead, ITERATIONS are resampled: replicate b draws T iteration
      indices with replacement and takes all R replicas' samples at
      those iterations.  Each iteration carries exactly one sample per
      state regardless of the swap permutation, so N_k is preserved
      exactly.

    Returns ``(d_f_k, f_replicates)``: the standard deviation of
    ``f_k`` over replicates (relative to the f_k[0] == 0 gauge each
    replicate is solved in) and the ``(n_bootstrap, K)`` replicate set.
    Replicate solves warm-start from ``f_init`` (the full-data solution,
    computed here when the caller does not already hold it).
    """
    u_kn = np.asarray(u_kn, dtype=np.float64)
    N_k = np.asarray(N_k, dtype=np.int64)
    if int(N_k.sum()) != u_kn.shape[1]:
        layout_hint = (
            "the (T, R) iteration tiling must cover every sample"
            if iteration_layout is not None
            else "bootstrap requires the origin-block layout"
        )
        raise ValueError(
            f"N_k sums to {int(N_k.sum())} but u_kn has {u_kn.shape[1]} "
            f"samples; {layout_hint}"
        )
    if iteration_layout is not None:
        T, R = iteration_layout
        if T * R != u_kn.shape[1]:
            raise ValueError(
                f"iteration_layout {iteration_layout} does not tile "
                f"{u_kn.shape[1]} samples"
            )
        # iteration resampling preserves N_k only when every iteration
        # carries exactly one sample per sampled state: R positive-count
        # states with N_k == T each (a replica-exchange permutation).
        pos = N_k[N_k > 0]
        if pos.size != R or not np.all(pos == T):
            raise ValueError(
                f"iteration_layout=({T}, {R}) requires exactly {R} "
                f"sampled states with N_k == {T} each (one sample per "
                f"state per iteration); got N_k = {N_k.tolist()}"
            )
    rng = np.random.default_rng(seed)
    f_full = mbar_solve(u_kn, N_k) if f_init is None else np.asarray(f_init)
    fs = np.empty((n_bootstrap, u_kn.shape[0]), dtype=np.float64)
    if iteration_layout is not None:
        if iteration_major:
            base = np.arange(R, dtype=np.int64)[None, :]  # (1, R)
            for b in range(n_bootstrap):
                t_idx = rng.integers(0, T, size=T)        # (T,)
                cols = (t_idx[:, None] * R + base).ravel()
                fs[b] = mbar_solve(u_kn[:, cols], N_k, f_init=f_full)
        else:
            base = np.arange(R, dtype=np.int64)[:, None] * T  # (R, 1)
            for b in range(n_bootstrap):
                t_idx = rng.integers(0, T, size=T)            # (T,)
                cols = (base + t_idx[None, :]).ravel()
                fs[b] = mbar_solve(u_kn[:, cols], N_k, f_init=f_full)
    else:
        starts = np.concatenate([[0], np.cumsum(N_k)])
        for b in range(n_bootstrap):
            cols = np.concatenate([
                starts[k] + rng.integers(0, N_k[k], size=int(N_k[k]))
                for k in range(len(N_k)) if N_k[k] > 0
            ])
            fs[b] = mbar_solve(u_kn[:, cols], N_k, f_init=f_full)
    return fs.std(axis=0, ddof=1), fs


def _log_N(N_k: torch.Tensor) -> torch.Tensor:
    """ln N_k, -inf for zero-count states (not log(tiny): that would still
    leak weight into the denominator of an unsampled state)."""
    return torch.where(N_k > 0, torch.log(torch.clamp_min(N_k, 1.0)),
                       torch.full_like(N_k, -float("inf")))


def _mbar_log_denominator_torch(u_kn, log_N_k, f_k):
    """ln sum_j N_j exp(f_j - u_jn) on the device, shape (N,)."""
    return torch.logsumexp((f_k + log_N_k)[:, None] - u_kn, dim=0)


def _as_u_N(u_kn, N_k):
    u_kn = torch.as_tensor(u_kn)
    if not u_kn.is_floating_point():
        u_kn = u_kn.to(torch.float32)
    return u_kn, torch.as_tensor(N_k, dtype=u_kn.dtype, device=u_kn.device)


def mbar_solve_torch(u_kn, N_k, n_iterations: int = 500) -> torch.Tensor:
    """Fixed-iteration MBAR self-consistent solve on the device of ``u_kn``
    (its dtype; JAX's ``mbar_solve_jax``).  The host solver is the
    precision reference."""
    u_kn, N_k = _as_u_N(u_kn, N_k)
    log_N_k = _log_N(N_k)
    f_k = torch.zeros(u_kn.shape[0], dtype=u_kn.dtype, device=u_kn.device)
    for _ in range(n_iterations):
        log_denom = _mbar_log_denominator_torch(u_kn, log_N_k, f_k)
        f_new = -torch.logsumexp(-u_kn - log_denom[None, :], dim=1)
        f_k = f_new - f_new[0]
    return f_k


def _mbar_sc_newton_torch(u_kn, log_N_k, N_k, n_sc: int, n_newton: int):
    """Self-consistent warm-up and Newton polish on the device, with fixed
    iteration counts (the two stages of :func:`mbar_solve`).  K is small (a
    replica ladder), so the (K-1, K-1) Newton solve is negligible."""
    K = u_kn.shape[0]
    f_k = torch.zeros(K, dtype=u_kn.dtype, device=u_kn.device)
    for _ in range(n_sc):
        log_denom = _mbar_log_denominator_torch(u_kn, log_N_k, f_k)
        f_new = -torch.logsumexp(-u_kn - log_denom[None, :], dim=1)
        f_k = f_new - f_new[0]

    sampled = N_k > 0
    mask2 = sampled[:, None] & sampled[None, :]
    zero = torch.zeros((), dtype=u_kn.dtype, device=u_kn.device)
    for _ in range(n_newton):
        log_denom = _mbar_log_denominator_torch(u_kn, log_N_k, f_k)
        W = torch.exp(f_k[:, None] - u_kn - log_denom[None, :])
        NW = N_k[:, None] * W
        g = N_k - NW.sum(dim=1)
        H = -(NW @ NW.T)
        H = H - torch.diag(torch.diagonal(H)) + torch.diag(
            (NW * (1.0 - NW)).sum(dim=1))
        # zero-count states are absent from the MBAR likelihood: their
        # rows are identically zero and would make H[1:, 1:] singular.
        # Decouple them (unit diagonal, zero gradient: df = 0); their f is
        # set by the reweighting after the polish.
        H = torch.where(mask2, H, zero)
        diag = torch.where(sampled, torch.diagonal(H), torch.ones_like(g))
        H = H - torch.diag(torch.diagonal(H)) + torch.diag(diag)
        g = torch.where(sampled, g, zero)
        df = torch.linalg.solve(H[1:, 1:], g[1:])
        f_k = torch.cat([f_k[:1], f_k[1:] + df])
        f_k = f_k - f_k[0]
    # zero-count states: one reweighting step against the polished sampled
    # f (the self-consistent map's exact value for a state absent from the
    # denominator)
    log_denom = _mbar_log_denominator_torch(u_kn, log_N_k, f_k)
    F = -torch.logsumexp(-u_kn - log_denom[None, :], dim=1)
    return torch.where(sampled, f_k, F - F[0])


class _MBARSolveImplicit(torch.autograd.Function):
    """The solve forward; the implicit-function VJP of the fixed point
    backward."""

    @staticmethod
    def forward(ctx, u_kn, N_k, n_sc, n_newton):
        with torch.no_grad():
            f_k = _mbar_sc_newton_torch(u_kn, _log_N(N_k), N_k, n_sc,
                                        n_newton)
        ctx.save_for_backward(u_kn, N_k, f_k)
        return f_k

    @staticmethod
    def backward(ctx, g):
        u_kn, N_k, f_k = ctx.saved_tensors
        log_denom = _mbar_log_denominator_torch(u_kn, _log_N(N_k), f_k)
        W = torch.exp(f_k[:, None] - u_kn - log_denom[None, :])  # (K, N)
        # A_kj = dF_k/df_j = N_j sum_n W_kn W_jn; the fixed point solved is
        # f_k = F_k - F_0 (k >= 1), so J_kj = A_kj - A_0j on the reduced set
        A = W @ (N_k[:, None] * W).T
        J = A[1:, 1:] - A[0:1, 1:]
        K = f_k.shape[0]
        eye = torch.eye(K - 1, dtype=u_kn.dtype, device=u_kn.device)
        x = torch.linalg.solve((eye - J).T, g[1:])
        # ubar = sum_k c_k dF_k/du with c = [-sum(x), x], contracted with
        # dF_k/du_im = W_km (delta_ik - N_i W_im)
        c = torch.cat([-x.sum(dim=0, keepdim=True), x])
        cW = c @ W  # (N,)
        u_bar = W * (c[:, None] - N_k[:, None] * cW[None, :])
        return u_bar, None, None, None


def mbar_solve_implicit(
    u_kn,
    N_k,
    n_sc_iterations: int = 200,
    n_newton_iterations: int = 6,
) -> torch.Tensor:
    """Differentiable MBAR solve: autograd flows through the estimator.

    The forward is the self-consistent warm-up and the Newton polish on the
    device of ``u_kn`` (in its dtype); the backward applies the implicit
    function theorem to the fixed point

        f_k = F_k(f, u) = -ln sum_n exp(-u_kn - d_n),
        d_n = ln sum_j N_j exp(f_j - u_jn),

    in the f_0 == 0 gauge, where the Jacobians are weight contractions:
    dF_k/df_j = N_j sum_n W_kn W_jn and dF_k/du_im = W_km (delta_ik - N_i
    W_im).  So the backward is one (K-1, K-1) solve and two matmuls,
    whatever the forward's iteration count, and exact at the fixed point.

    The gradient is that of the ESTIMATOR in the u_kn entries.  A sampled
    state's row also declares where its samples came from, so for physical
    sensitivities d(Delta f)/d theta freeze the origins (this solve at the
    sampled parameters) and differentiate the target states through
    :func:`mbar_perturbed_free_energies_torch`.  ``N_k`` is bookkeeping,
    not a differentiable input.
    """
    u_kn, N_k = _as_u_N(u_kn, N_k)
    return _MBARSolveImplicit.apply(u_kn, N_k, int(n_sc_iterations),
                                    int(n_newton_iterations))


def mbar_perturbed_free_energies_torch(u_kn, N_k, f_k, u_ln) -> torch.Tensor:
    """Differentiable reweighting to unsampled states (the device analogue
    of :func:`mbar_perturbed_free_energies`, without the error bars): a
    closed-form logsumexp, so autograd through it is exact, and its
    gradient in the target's reduced potentials is the target weights
    df_l/du_ln = W_ln."""
    u_kn, N_k = _as_u_N(u_kn, N_k)
    log_denom = _mbar_log_denominator_torch(u_kn, _log_N(N_k),
                                            torch.as_tensor(f_k))
    return -torch.logsumexp(-torch.as_tensor(u_ln) - log_denom[None, :],
                            dim=1)

def exp_free_energy(w: np.ndarray) -> Tuple[float, float]:
    """One-sided exponential averaging (Zwanzig): Delta f and its SE.

    Delta f = -ln < exp(-w) > over forward work values w (reduced
    units).  The pymbar capability (``pymbar.other_estimators.exp``) the
    reference inherits.  Biased when the work distribution's tail is
    under-sampled -- prefer :func:`bar` or MBAR when both directions are
    available.
    """
    w = np.asarray(w, dtype=np.float64)
    n = w.size
    if n < 2:
        raise ValueError(
            "exp_free_energy needs at least 2 work values "
            f"(got {n}); the SE of one sample is undefined"
        )
    mx = np.max(-w)
    ew = np.exp(-w - mx)
    mean = ew.mean()
    df = -(mx + np.log(mean))
    se = ew.std(ddof=1) / (mean * np.sqrt(n))  # delta method on ln
    return float(df), float(se)


def bar(w_F: np.ndarray, w_R: np.ndarray) -> Tuple[float, float]:
    """Bennett acceptance ratio: Delta f (0 -> 1) and its SE.

    ``w_F`` are forward reduced work values u_1 - u_0 on samples from
    state 0; ``w_R`` reverse work u_0 - u_1 on samples from state 1.
    Implemented exactly as two-state MBAR (BAR is MBAR's K=2 special
    case), reusing the solver and the Eq. D6 asymptotic covariance --
    so the estimate is the optimal (minimum-variance) two-state one
    (pymbar ``other_estimators.bar`` capability).
    """
    w_F = np.asarray(w_F, dtype=np.float64)
    w_R = np.asarray(w_R, dtype=np.float64)
    u_kn = np.block([
        [np.zeros_like(w_F), w_R],
        [w_F, np.zeros_like(w_R)],
    ])
    N_k = np.array([w_F.size, w_R.size])
    f_k = mbar_solve(u_kn, N_k)
    th = mbar_covariance(u_kn, N_k, f_k)
    var = max(th[0, 0] + th[1, 1] - 2.0 * th[0, 1], 0.0)
    return float(f_k[1]), float(np.sqrt(var))


def statistical_inefficiency(A_t: np.ndarray, mintime: int = 3) -> float:
    """Statistical inefficiency g = 1 + 2 tau of a correlated timeseries.

    The reference inherits this capability from pymbar
    (``pymbar.timeseries.statistical_inefficiency``; reference
    chiron/analysis.py:35 pulls in pymbar) -- it is the standard
    pre-MBAR decorrelation estimate: N_eff = N / g.  Computed from the
    normalized fluctuation autocorrelation with the Chodera truncation
    heuristic (stop summing when C(t) first crosses zero after
    ``mintime``), using one FFT for all lags.
    """
    A_t = np.asarray(A_t, dtype=np.float64)
    T = A_t.size
    if T < 2:
        return 1.0
    dA = A_t - A_t.mean()
    var = float(np.dot(dA, dA)) / T
    if var <= 0.0:
        return 1.0
    # FFT autocovariance over all lags, unbiased normalization
    nfft = 1 << (2 * T - 1).bit_length()
    f = np.fft.rfft(dA, nfft)
    acov = np.fft.irfft(f * np.conjugate(f), nfft)[:T]
    acov /= np.arange(T, 0, -1)  # unbiased: divide by (T - t)
    C_t = acov / var
    g = 1.0
    for t in range(1, T - 1):
        if C_t[t] <= 0.0 and t > mintime:
            break
        g += 2.0 * C_t[t] * (1.0 - t / T)
    return max(1.0, g)


def detect_equilibration(A_t: np.ndarray, nskip: int = 1):
    """Choose the production-region start that maximizes N_eff.

    pymbar's ``detect_equilibration``: for each candidate start t0 in
    [0, T-2], compute g of A[t0:] and pick the t0 maximizing
    (T - t0 + 1) / g (pymbar's exact N_eff formula, +1 included).
    Returns ``(t0, g, N_eff)``.

    ``nskip`` spaces the candidate starts; the default 1 is pymbar's
    exhaustive scan (every t0 considered), so default-argument results
    match ``pymbar.timeseries.detect_equilibration``.  Each candidate
    costs an O(T log T) inefficiency evaluation, so for long reporter
    series pass e.g. ``nskip=max(1, T//100)`` to keep the scan
    seconds-scale at a t0 resolution of T/100.
    """
    A_t = np.asarray(A_t, dtype=np.float64)
    T = A_t.size
    if T < 3:
        return 0, 1.0, float(T)
    best = (0, 1.0, 0.0)
    for t0 in range(0, T - 1, nskip):
        g = statistical_inefficiency(A_t[t0:])
        n_eff = (T - t0 + 1) / g
        if n_eff > best[2]:
            best = (t0, g, n_eff)
    return best


def subsample_correlated_data(A_t: np.ndarray, g: float = None) -> np.ndarray:
    """Indices of (approximately) uncorrelated samples, stride ~g apart

    (pymbar's ``subsample_correlated_data``).  Feed the result to
    :class:`MBAREstimator` so the asymptotic variance's iid assumption
    holds.
    """
    A_t = np.asarray(A_t, dtype=np.float64)
    T = A_t.size
    if g is None:
        g = statistical_inefficiency(A_t)
    g = max(1.0, float(g))
    # real-spaced stride (not ceil(g)) keeps ~T/g samples
    idx = np.unique(np.round(np.arange(0.0, T, g)).astype(np.int64))
    return idx[idx < T]


class MBAREstimator:
    """Reference-parity MBAR front-end (reference analysis.py:4-63)."""

    def __init__(self) -> None:
        self.f_k_: Optional[np.ndarray] = None
        self._u_kn: Optional[np.ndarray] = None
        self._N_k: Optional[np.ndarray] = None
        self._theta: Optional[np.ndarray] = None
        self._iteration_layout: Optional[Tuple[int, int]] = None
        self._iteration_major: bool = False

    def initialize(
        self, u_kn: np.ndarray, N_k,
        iteration_layout: Optional[Tuple[int, int]] = None,
        iteration_major: bool = False,
    ) -> None:
        """Solve MBAR for the given reduced-potential samples.

        Accepts either a 2D ``(K, N)`` matrix, or the reporter's stacked 3D
        ``(n_iterations, n_states, n_replicas)`` layout, which is flattened
        so sample n = (replica, iteration) (reference analysis.py:31-35).

        For 2D replica-exchange data, pass ``iteration_layout=(T, R)``
        (with ``iteration_major=True`` when columns are ordered
        n = t*R + r rather than n = r*T + t) so ``bootstrap_d_f_k``
        resamples iterations instead of origin blocks -- swap-mixed
        columns are not origin-ordered (see :func:`mbar_bootstrap`).
        """
        u_kn = np.asarray(u_kn, dtype=np.float64)
        N_k = np.asarray(N_k, dtype=np.int64)
        self._iteration_layout = iteration_layout
        self._iteration_major = iteration_major
        if u_kn.ndim == 3:
            t, s, r = u_kn.shape
            # (T, S, R) -> (S, R, T) -> (S, R*T)
            u_kn = np.transpose(u_kn, (1, 2, 0)).reshape(s, r * t)
            # columns ordered by REPLICA (n = r*T + t): remember the
            # (T, R) tiling so bootstrap resamples iterations, not
            # replica blocks (a replica visits many states under swaps)
            self._iteration_layout = (t, r)
            self._iteration_major = False
        if u_kn.ndim != 2:
            raise ValueError(f"u_kn must be 2D or 3D, got shape {u_kn.shape}")
        self._u_kn = u_kn
        self._N_k = N_k
        self._theta = None
        self.f_k_ = mbar_solve(u_kn, N_k)
        log.debug("MBAR f_k = %s", self.f_k_)

    @property
    def f_k(self) -> np.ndarray:
        """Dimensionless free energy per state, f_k[0] == 0."""
        if self.f_k_ is None:
            raise RuntimeError("MBAREstimator.initialize must be called first")
        return self.f_k_

    @property
    def u_kn(self) -> np.ndarray:
        """The pooled (K, N) reduced-potential matrix this estimator was
        initialized with (2D, post-flatten) -- the sample set to
        evaluate perturbed states' ``u_ln`` on."""
        if self._u_kn is None:
            raise RuntimeError("MBAREstimator.initialize must be called first")
        return self._u_kn

    @property
    def N_k(self) -> np.ndarray:
        """Per-state sample counts matching :attr:`u_kn`'s columns."""
        if self._N_k is None:
            raise RuntimeError("MBAREstimator.initialize must be called first")
        return self._N_k

    def get_free_energy_difference(
        self, return_uncertainty: bool = False
    ):
        """Delta f between the two end states (f_K-1 - f_0).

        The reference returns ``self.mbar_f_k[-1]`` where ``mbar_f_k`` is
        never assigned after ``initialize`` (latent upstream bug, reference
        analysis.py:63); since f_k[0] == 0 the intended value is exactly
        f_k[-1], which we return.  With ``return_uncertainty=True`` also
        returns the asymptotic standard error of that difference
        (a pymbar capability).
        """
        if not return_uncertainty:
            return float(self.f_k[-1])
        d = self.d_f_k
        return float(self.f_k[-1]), float(d[-1])

    @property
    def theta(self) -> np.ndarray:
        """Asymptotic covariance matrix of f_k (Shirts & Chodera Eq. D6)."""
        if self._theta is None:
            self._theta = mbar_covariance(self._u_kn, self._N_k, self.f_k)
        return self._theta

    @property
    def d_f_k(self) -> np.ndarray:
        """Standard error of f_k - f_0 per state (d_f_k[0] == 0)."""
        th = self.theta
        var = np.maximum(th.diagonal() + th[0, 0] - 2.0 * th[0, :], 0.0)
        return np.sqrt(var)

    def delta_f_ij(self) -> Tuple[np.ndarray, np.ndarray]:
        """All pairwise (Delta f_ij, d Delta f_ij) matrices."""
        f = self.f_k
        th = self.theta
        delta = f[None, :] - f[:, None]
        var = (
            th.diagonal()[:, None] + th.diagonal()[None, :] - 2.0 * th
        )
        return delta, np.sqrt(np.maximum(var, 0.0))

    def compute_overlap(self) -> dict:
        """State-overlap diagnostics (matrix / eigenvalues / scalar)."""
        return mbar_overlap(self._u_kn, self._N_k, self.f_k)

    def compute_entropy_and_enthalpy(self):
        """Decompose f_k into reduced enthalpy and entropy per state.

        Returns ``(f_k, u_k, s_k)`` with ``u_k = <u_k>_k`` (the average
        reduced potential of state k under its own distribution, via the
        MBAR weights) and ``s_k = u_k - f_k`` (dimensionless entropy up
        to a k-independent constant), so ``f = u - s`` exactly.  pymbar
        exposes the same decomposition through
        ``compute_entropy_and_enthalpy``; for a harmonic oscillator at
        beta=1 the reduced enthalpy is exactly 1/2 per quadratic degree
        of freedom (equipartition) -- the test anchor.
        """
        W = mbar_weights(self._u_kn, self._N_k, self.f_k)  # (K, N)
        u_k = np.einsum("kn,kn->k", W, self._u_kn)
        s_k = u_k - self.f_k
        return self.f_k.copy(), u_k, s_k

    def bootstrap_d_f_k(
        self, n_bootstrap: int = 50, seed: int = 0
    ) -> np.ndarray:
        """Bootstrap standard error of f_k - f_0 (see mbar_bootstrap).

        When this estimator was initialized from the reporter's 3D
        (iterations, states, replicas) array -- or with an explicit
        ``iteration_layout`` -- replicates resample ITERATIONS (correct
        under replica exchange); otherwise they resample within
        origin-state blocks.  Replicate solves warm-start from the
        already-converged full-data ``f_k``.
        """
        d, _ = mbar_bootstrap(
            self._u_kn, self._N_k, n_bootstrap=n_bootstrap, seed=seed,
            iteration_layout=self._iteration_layout,
            iteration_major=self._iteration_major,
            f_init=self.f_k_,
        )
        return d

    def compute_expectation(self, A_n: np.ndarray, state_index: int = 0,
                            return_uncertainty: bool = False):
        """<A> at state ``state_index`` via MBAR weights.

        With ``return_uncertainty``, also returns the weighted standard
        error sqrt(Var_w(A) / ESS) with the Kish effective sample size
        ESS = 1 / sum(w_n^2) -- the standard importance-sampling error
        estimate (pymbar exposes the same capability through
        ``compute_expectations``)."""
        W = mbar_weights(self._u_kn, self._N_k, self.f_k_)
        w = W[state_index]
        w = w / w.sum()
        A_n = np.asarray(A_n, dtype=np.float64)
        mean = float(np.dot(w, A_n))
        if not return_uncertainty:
            return mean
        ess = 1.0 / np.sum(w * w)
        var = float(np.dot(w, (A_n - mean) ** 2))
        return mean, float(np.sqrt(var / max(ess, 1.0)))

    def compute_perturbed_free_energies(self, u_ln: np.ndarray):
        """``(f_l, d_f_l)`` of unsampled target states (see
        :func:`mbar_perturbed_free_energies`).  ``u_ln`` is ``(L, N)``
        (or ``(N,)`` for one state): the target states' reduced
        potentials on the pooled samples."""
        return mbar_perturbed_free_energies(
            self._u_kn, self._N_k, self.f_k, u_ln
        )

    def compute_expectations(
        self, A_n: np.ndarray, return_uncertainty: bool = False
    ):
        """<A> at EVERY state k (pymbar ``compute_expectations`` shape).

        Vectorized over states: one weight matrix, one einsum.  With
        ``return_uncertainty`` also returns the per-state importance-
        sampling standard errors (same Kish-ESS estimate as
        :meth:`compute_expectation`).  Returns ``(K,)`` arrays.
        """
        W = mbar_weights(self._u_kn, self._N_k, self.f_k_)  # (K, N)
        W = W / W.sum(axis=1, keepdims=True)
        A_n = np.asarray(A_n, dtype=np.float64)
        means = W @ A_n                                      # (K,)
        if not return_uncertainty:
            return means
        ess = 1.0 / np.sum(W * W, axis=1)
        var = np.einsum("kn,kn->k", W, (A_n[None, :] - means[:, None]) ** 2)
        return means, np.sqrt(var / np.maximum(ess, 1.0))
