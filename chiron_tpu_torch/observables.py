"""Physical observables over sampled configurations (port of
``chiron_tpu/observables.py``).

Structure (RDF), mechanical state (the LJ virial and its pressure),
response (heat capacity) and transport (unwrap, MSD, diffusion, VACF), and
MBAR reweighting of an observable.  The JAX package jits each estimator;
here each is a torch function on the device of the tensors it is given,
in float32 as JAX computes them.  Host data (numpy arrays, lists, the
reporters' properties) goes to the entry point's ``device``: the card
unless the caller passes ``device="cpu"``.

All inputs are unitless MD-system numerics (nm, kJ/mol, K), or Quantities
that are stripped at the boundary.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import units


def _f32(a, device) -> torch.Tensor:
    """A float32 tensor of ``a``: a tensor keeps its device, host data goes
    to ``device``."""
    if torch.is_tensor(a):
        return a.to(dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def _box_lengths(box_vectors, device) -> torch.Tensor:
    b = _f32(units.strip_md(box_vectors, units.nanometer), device)
    return torch.diagonal(b) if b.ndim == 2 else b.reshape(3)


def _rdf_histogram(positions, box_diag, r_max: float, n_bins: int):
    """Pair-distance histogram of ONE frame: (n_bins,) float32 counts of
    the i < j pairs within ``r_max``."""
    n = positions.shape[0]
    d = positions[:, None, :] - positions[None, :, :]
    d = d - box_diag * torch.round(d / box_diag)
    r = torch.sqrt(torch.sum(d * d, dim=-1))
    iu = torch.triu_indices(n, n, offset=1, device=positions.device)
    r = r[iu[0], iu[1]]
    bins = torch.clamp(torch.floor(r / r_max * n_bins).to(torch.int64),
                       0, n_bins)
    # pairs beyond r_max land in the sentinel bin n_bins and are dropped
    bins = torch.where(r < r_max, bins, torch.full_like(bins, n_bins))
    return torch.bincount(bins, minlength=n_bins + 1)[:n_bins].to(
        torch.float32)


def radial_distribution_function(
    positions,
    box_vectors,
    r_max: Optional[float] = None,
    n_bins: int = 100,
    *,
    device="cuda",
):
    """g(r) averaged over a trajectory.

    ``positions``: (n_frames, N, 3) or (N, 3) (nm, a tensor, an array or a
    Quantity; host data is histogrammed on ``device``); ``box_vectors``:
    the (3, 3) orthorhombic box; ``r_max`` defaults to L/2.  Returns
    ``(r_centers, g)`` as numpy arrays.
    """
    pos = _f32(units.strip_md(positions, units.nanometer), device)
    box_diag = _box_lengths(box_vectors, pos.device).to(pos.device)
    if pos.ndim == 2:
        pos = pos[None]
    n_frames, n, _ = pos.shape
    L_min = float(box_diag.min())
    if r_max is None:
        r_max = 0.5 * L_min
    if r_max > 0.5 * L_min + 1e-9:
        raise ValueError(
            f"r_max ({r_max}) exceeds half the box ({0.5 * L_min}): the "
            "minimum-image histogram would alias"
        )
    counts = np.zeros(n_bins, dtype=np.float64)
    r_max32 = float(np.float32(r_max))
    for f in range(n_frames):
        counts += _rdf_histogram(pos[f], box_diag, r_max32,
                                 n_bins).cpu().numpy()
    counts /= n_frames
    edges = np.linspace(0.0, r_max, n_bins + 1)
    r_centers = 0.5 * (edges[1:] + edges[:-1])
    shell_vol = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    volume = float(np.prod(box_diag.double().cpu().numpy()))
    rho = n / volume
    # counts are i<j pairs: the ideal-gas expectation per shell is
    # N(N-1)/2 V_shell/V = shell_vol rho (n-1)/2
    ideal = shell_vol * rho * (n - 1) / 2.0
    g = counts / ideal
    return r_centers, g


def lj_virial(positions, box_diag, sigma: float, epsilon: float,
              cutoff: float, *, device="cuda") -> torch.Tensor:
    """Pair virial W = sum_{i<j} f_ij . r_ij of the cutoff LJ potential, a
    () tensor on the positions' device (``device`` for host data).

    It equals -3V dU/dV under uniform scaling of a configuration, so
    P_inst = (N kT + W/3) / V is the instantaneous virial pressure.
    """
    positions = _f32(positions, device)
    box_diag = _f32(box_diag, positions.device).to(positions.device)
    n = positions.shape[0]
    d = positions[:, None, :] - positions[None, :, :]
    d = d - box_diag * torch.round(d / box_diag)
    r2 = torch.sum(d * d, dim=-1)
    ids = torch.arange(n, device=positions.device)
    m = (r2 < cutoff * cutoff) & (ids[:, None] < ids[None, :])
    r2s = torch.where(m, r2, torch.ones_like(r2))
    i2 = (sigma * sigma) / r2s
    i6 = i2 * i2 * i2
    # f.r = 24 eps (2 (s/r)^12 - (s/r)^6)
    w = torch.where(m, 24.0 * epsilon * (2.0 * i6 * i6 - i6),
                    torch.zeros_like(i6))
    return torch.sum(w)


def lj_virial_pressure(
    positions,
    box_vectors,
    temperature,
    sigma: float,
    epsilon: float,
    cutoff: float,
    *,
    device="cuda",
):
    """Virial pressure of LJ configurations: P = (N kT + W/3)/V
    (kJ/mol/nm^3).  ``positions`` may be one frame (N, 3) or a trajectory
    (F, N, 3), whose average is returned; host data goes to ``device``.
    Multiply by :data:`PRESSURE_MD_TO_BAR` for bar."""
    pos = _f32(units.strip_md(positions, units.nanometer), device)
    box = units.strip_md(box_vectors, units.nanometer)
    box_np = (box.detach().cpu().numpy() if torch.is_tensor(box)
              else np.asarray(box))
    T = units.strip_md(temperature, units.kelvin)
    kT = units.kB_MD * T
    box_diag = torch.as_tensor(np.diagonal(box_np).astype(np.float32),
                               device=pos.device)
    volume = float(np.prod(np.diagonal(box_np)))
    if pos.ndim == 2:
        pos = pos[None]
    n = pos.shape[1]
    ws = [float(lj_virial(p, box_diag, float(sigma), float(epsilon),
                          float(cutoff))) for p in pos]
    w = float(np.mean(ws))
    return (n * kT + w / 3.0) / volume


def heat_capacity_nvt(energies, temperature):
    """C_V from NVT energy fluctuations: (<E^2> - <E>^2) / (kB T^2).

    ``energies``: potential plus kinetic samples in kJ/mol (add (3N/2) kB
    to the result when only potential energies are given and the kinetic
    part is the classical ideal one).  Returns kJ/mol/K.
    """
    E = units.strip_md(energies, units.kilojoule_per_mole)
    if torch.is_tensor(E):
        E = E.detach().cpu().numpy()
    E = np.asarray(E, dtype=np.float64)
    T = units.strip_md(temperature, units.kelvin)
    return float(np.var(E) / (units.kB_MD * T * T))


def unwrap_trajectory(frames, box_diag, *, device="cuda") -> torch.Tensor:
    """Undo periodic wrapping across (T, N, 3) frames.

    Frame-to-frame displacements are minimum-imaged and accumulated, so the
    result is continuous in space -- valid while no particle moves more
    than L/2 between consecutive frames.  Transport observables (MSD,
    diffusion) need this: the runners wrap positions every step.  Host
    frames go to ``device``.
    """
    frames = _f32(frames, device)
    L = _f32(box_diag, frames.device).to(frames.device)
    if L.ndim == 2:  # a full (3, 3) box, as the RDF takes
        L = torch.diagonal(L)
    L = L.reshape(1, 1, 3)
    d = torch.diff(frames, dim=0)
    d = d - L * torch.round(d / L)
    return torch.cat([frames[:1], frames[:1] + torch.cumsum(d, dim=0)],
                     dim=0)


def _autocorr_fft(a: torch.Tensor) -> torch.Tensor:
    """S2(m) = sum_t a[t] a[t+m] for each lag m, along dim 0 (FFT)."""
    T = a.shape[0]
    fa = torch.fft.rfft(a, n=2 * T, dim=0)
    return torch.fft.irfft(fa * torch.conj(fa), n=2 * T, dim=0)[:T]


def _msd_all_lags(x: torch.Tensor) -> torch.Tensor:
    """MSD over all lags via the FFT autocorrelation identity (O(T log T N)
    instead of the direct O(T^2 N) origin average)."""
    T = x.shape[0]
    # MSD is translation-invariant: centre each particle on its initial
    # position BEFORE the f32 pass, or the S1 - 2 S2 form cancels
    # catastrophically far from the origin
    x = x - x[0:1]
    D = torch.sum(x * x, dim=-1)                     # (T, N)
    S2 = torch.sum(_autocorr_fft(x), dim=-1)         # (T, N)
    # S1(m) = S1(m-1) - D[m-1] - D[T-m], JAX's scan as the same sequence
    # of subtractions
    S1 = torch.empty_like(D)
    S1[0] = 2.0 * torch.sum(D, dim=0)
    for m in range(1, T):
        S1[m] = S1[m - 1] - D[m - 1] - D[T - m]
    counts = (T - torch.arange(T, device=x.device)).to(torch.float32)[:, None]
    return torch.mean((S1 - 2.0 * S2) / counts, dim=1)


def mean_squared_displacement(frames, box_diag=None, *,
                              device="cuda") -> torch.Tensor:
    """MSD(t) averaged over particles and ALL time origins: a (T,) tensor
    (nm^2).  ``frames`` is (T, N, 3), host frames go to ``device``; pass
    ``box_diag`` to unwrap first (required for wrapped trajectories)."""
    x = _f32(frames, device)
    if box_diag is not None:
        x = unwrap_trajectory(x, box_diag)
    return _msd_all_lags(x)


def diffusion_coefficient(frames, times, box_diag=None,
                          fit_fraction=(0.2, 0.8), *, device="cuda"):
    """Self-diffusion D from the Einstein relation MSD = 6 D t: the least-
    squares slope over the middle ``fit_fraction`` of the lag times (past
    the ballistic onset, before the noisy tail).  D in nm^2/ps for
    ``times`` in ps; the MSD is computed on ``device`` for host frames."""
    msd = mean_squared_displacement(frames, box_diag, device=device).cpu().numpy().astype(
        np.float64)
    t = np.asarray(times, dtype=np.float64)
    lo = int(len(t) * fit_fraction[0])
    hi = max(lo + 2, int(len(t) * fit_fraction[1]))
    slope = np.polyfit(t[lo:hi], msd[lo:hi], 1)[0]
    return float(slope / 6.0)


def velocity_autocorrelation(velocities, *, device="cuda") -> torch.Tensor:
    """Normalized VACF(t) over (T, N, 3) velocity frames: a (T,) tensor.

    C(t) = <v(0).v(t)> / <v(0).v(0)>, averaged over particles and ALL time
    origins; the Green-Kubo integral of the unnormalized VACF is an
    independent route to D.  Host velocities go to ``device``.
    """
    v = _f32(velocities, device)
    T = v.shape[0]
    S2 = torch.mean(torch.sum(_autocorr_fft(v), dim=-1), dim=1)  # (T,)
    counts = (T - torch.arange(T, device=v.device)).to(torch.float32)
    c = S2 / counts
    return c / c[0]


def mbar_expectation(estimator, samples, state_index: int = 0):
    """<A> at a thermodynamic state by MBAR reweighting
    (:meth:`analysis.MBAREstimator.compute_expectation`).

    A 1D ``samples`` must already be in the estimator's column order; a 2D
    ``(iterations, replicas)`` array is flattened to match the layout the
    estimator was initialized with (a plain C-order flatten of the natural
    (T, R) array would pair each weight with the wrong sample under the
    replica-major order of the 3D reporter path).
    """
    a = samples.detach().cpu().numpy() if torch.is_tensor(samples) \
        else np.asarray(samples)
    if a.ndim == 1:
        flat = a
    elif a.ndim == 2 and estimator._iteration_layout is not None:
        T, R = estimator._iteration_layout
        if a.shape != (T, R):
            raise ValueError(
                f"expected an (iterations, replicas) = ({T}, {R}) "
                f"observable array matching the estimator's layout, got "
                f"{a.shape}"
            )
        flat = a.reshape(-1) if estimator._iteration_major else a.T.reshape(-1)
    else:
        raise ValueError(
            "multi-dimensional observable arrays need the estimator's "
            "iteration layout to order samples (initialize with "
            "iteration_layout=...), or pass a 1D array already in the "
            "estimator's column order"
        )
    return estimator.compute_expectation(flat, state_index=state_index)


# bar per (kJ/mol/nm^3): 1 kJ/mol/nm^3 = 16.6054 bar
PRESSURE_MD_TO_BAR = 16.605390671738466
