"""The plain reference of the benchmark's LJ fluids.

Everything the program derives, worked out again from the same inputs:
the truncated 12-6 pair force and energy (float64 by default) over a Verlet
list of its own, BAOAB Langevin steps driven by the counter-based normal
stream that the program's noise is defined by, the integer key split that
seeds a tempering replica's stream, and the tempering swap sweep.

Plain ``torch`` and ``numpy`` only: nothing here imports the program, and
nothing takes a table, a list or a scale that the program made.  Several
systems of one size run as a batch (``x`` of shape (B, N, 3)), each in its
own box, as a tempering ladder's replicas do.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1
GOLDEN64 = 0x9E3779B97F4A7C15
KB_KJ_PER_MOL_K = 0.00831446261815324  # the molar gas constant R
KCAL = 4.184                           # kJ per kcal


# ---------------------------------------------------------------------------
# Keys and the normal stream
# ---------------------------------------------------------------------------


def splitmix64(x: int) -> int:
    z = (x + GOLDEN64) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def split(key: int, num: int = 2):
    """``num`` child keys of an integer key (the splitmix64 counter split)."""
    return tuple(splitmix64((int(key) + i * GOLDEN64) & MASK64)
                 for i in range(num))


def stream_seed(key: int) -> int:
    """The 32-bit seed of the normal stream that a key stands for."""
    key = int(key)
    return (key ^ (key >> 32)) & MASK32


def propagation_seeds(keys):
    """(next keys, stream seeds): each key split once, the second child
    seeding the propagation's stream."""
    pairs = [split(k) for k in keys]
    return [a for a, _ in pairs], [stream_seed(b) for _, b in pairs]


def _mul32(z, k: int):
    """(z k) mod 2^32 of int64 ``z`` in [0, 2^32), taken in the 16-bit
    halves of ``k`` so that no product leaves int64."""
    return (z * (k & 0xFFFF) + (((z * (k >> 16)) & 0xFFFF) << 16)) & MASK32


def _mix32(z):
    z = z ^ (z >> 16)
    z = _mul32(z, 0x85EBCA6B)
    z = z ^ (z >> 13)
    z = _mul32(z, 0xC2B2AE35)
    return z ^ (z >> 16)


def lane_normals(seeds, step: int, n_pad: int, device="cpu"):
    """(B, 3, n_pad) float64 standard normals of one step: lane l of row q
    of system b takes counters 2 c and 2 c + 1 of c = q n_pad / 2 + (l mod
    n_pad / 2) on the splitmix32 stream of ``seeds[b]`` at ``step``, as a
    Box-Muller pair whose cosine serves the first half of the row and whose
    sine the second."""
    half = n_pad // 2
    i64 = dict(dtype=torch.int64, device=device)
    seeds = torch.tensor([int(s) & MASK32 for s in seeds], **i64)
    base = (_mul32(seeds, 0x9E3779B9)
            + ((int(step) & MASK32) * 0x85EBCA6B & MASK32)) & MASK32
    base = base.reshape(-1, 1, 1)
    c = torch.arange(3 * half, **i64).reshape(1, 3, half)
    c1 = (2 * c * 0x9E3779B9 + base) & MASK32
    c2 = ((2 * c + 1) * 0x9E3779B9 + base) & MASK32
    scale = 1.0 / 16777216.0
    u1 = torch.clamp_min((_mix32(c1) >> 8).double() * scale, 1e-7)
    u2 = (_mix32(c2) >> 8).double() * scale
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = 2.0 * math.pi * u2
    return torch.cat([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


# ---------------------------------------------------------------------------
# Pair force and energy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LJ:
    """The truncated (unshifted) 12-6 potential, MD units (nm, kJ/mol)."""

    sigma: float
    epsilon: float
    cutoff: float


def min_image(d, L):
    return d - L * torch.floor(d / L + 0.5)


def pair_list(x, L, reach: float, block: int = 1024):
    """(i, j) int64 flat indices into the (B N) particles of every pair
    i < j of one system closer than ``reach`` (the minimum image).  ``x``
    (B, N, 3), ``L`` (B, 3); all pairs, a block of rows at a time."""
    B, N, _ = x.shape
    out_i, out_j = [], []
    cols = torch.arange(N, device=x.device)
    for b in range(B):
        xb = x[b].to(torch.float64)
        Lb = L[b].to(torch.float64)
        for r0 in range(0, N, block):
            rows = torch.arange(r0, min(N, r0 + block), device=x.device)
            d = min_image(xb[rows, None, :] - xb[None, :, :], Lb)
            r2 = (d * d).sum(-1)
            keep = (r2 < reach * reach) & (cols[None, :] > rows[:, None])
            ii, jj = torch.nonzero(keep, as_tuple=True)
            out_i.append(rows[ii] + b * N)
            out_j.append(jj + b * N)
    return torch.cat(out_i), torch.cat(out_j)


def force_energy(x, L, lj: LJ, pairs):
    """((B, N, 3) force, (B,) energy) of ``x`` over the pairs of
    ``pair_list`` (those beyond the cutoff add nothing), in the dtype of
    ``x``."""
    B, N, _ = x.shape
    i, j = pairs
    flat = x.reshape(B * N, 3)
    Lp = L.to(x.dtype)[i // N]
    d = min_image(flat[i] - flat[j], Lp)
    r2 = (d * d).sum(-1)
    inside = r2 < lj.cutoff * lj.cutoff
    s2 = (lj.sigma * lj.sigma) / r2
    s6 = s2 * s2 * s2
    s12 = s6 * s6
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    coef = torch.where(inside, 24.0 * lj.epsilon * (2.0 * s12 - s6) / r2,
                       zero)
    fij = coef[:, None] * d
    F = torch.zeros_like(flat)
    F.index_add_(0, i, fij)
    F.index_add_(0, j, -fij)
    e = torch.where(inside, 4.0 * lj.epsilon * (s12 - s6), zero)
    U = torch.zeros(B, dtype=x.dtype, device=x.device)
    U.index_add_(0, i // N, e)
    return F.reshape(B, N, 3), U


class Forces:
    """Force and energy of a batch on a Verlet list with ``skin``, rebuilt
    when a particle has moved half the skin since the list was built."""

    def __init__(self, lj: LJ, L, skin: float = 0.3):
        self.lj, self.L, self.skin = lj, L, skin
        self.pairs = None
        self.anchor = None

    def __call__(self, x):
        if self.anchor is not None:
            d = min_image(x.to(torch.float64) - self.anchor,
                          self.L.to(torch.float64)[:, None, :])
            if float((d * d).sum(-1).max()) > (0.5 * self.skin) ** 2:
                self.pairs = None
        if self.pairs is None:
            self.pairs = pair_list(x, self.L, self.lj.cutoff + self.skin)
            self.anchor = x.to(torch.float64)
        return force_energy(x, self.L, self.lj, self.pairs)


def pairs_within(x, L, cutoff: float, block: int = 1024) -> int:
    """Unordered pairs closer than ``cutoff`` in each system of ``x``
    (B, N, 3), summed over the batch."""
    return int(pair_list(x, L, cutoff, block)[0].numel())


# ---------------------------------------------------------------------------
# Dynamics
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Langevin:
    """BAOAB in MD units: ``dt`` ps, ``gamma`` 1/ps, ``mass`` amu."""

    dt: float
    gamma: float
    mass: float


def baoab(x, v, L, lj: LJ, lng: Langevin, kT, seeds, step0: int,
          n_steps: int, n_pad: int, dtype=torch.float64):
    """``n_steps`` BAOAB steps of a batch from (x, v), (B, N, 3), particle
    i of system b driven by lane i of the normal stream of ``seeds[b]`` at
    steps ``step0, step0 + 1, ...`` in a layout ``n_pad`` lanes wide.  ``kT``
    holds each system's kT (kJ/mol).  Returns the final (x, v, F, U) in
    ``dtype``: x wrapped into the box."""
    dev = x.device
    B, N, _ = x.shape
    x = x.to(dtype)
    v = v.to(dtype)
    Ld = L.to(dtype)[:, None, :]
    forces = Forces(lj, L)
    F, U = forces(x)
    half = 0.5 * lng.dt
    a = math.exp(-lng.gamma * lng.dt)
    b = math.sqrt(1.0 - math.exp(-2.0 * lng.gamma * lng.dt))
    sig = torch.tensor([b * math.sqrt(float(k) / lng.mass) for k in kT],
                       dtype=dtype, device=dev).reshape(B, 1, 1)
    for s in range(n_steps):
        z = lane_normals(seeds, step0 + s, n_pad, dev)[:, :, :N]
        z = z.transpose(1, 2).to(dtype)
        v = v + (half / lng.mass) * F
        x = x + half * v
        v = a * v + sig * z
        x = x + half * v
        x = x - torch.floor(x / Ld) * Ld
        F, U = forces(x)
        v = v + (half / lng.mass) * F
    return x, v, F, U


# ---------------------------------------------------------------------------
# The tempering swap sweep
# ---------------------------------------------------------------------------


def swap_sweep(kTs: np.ndarray, U: np.ndarray, iteration: int, seed):
    """The even/odd neighbour sweep of a temperature ladder after
    ``iteration`` (1-based): float32 betas, neighbours by ``argsort`` of
    kT, a pair accepted where log p >= 0 or a uniform of
    ``default_rng([seed, iteration])`` is below exp(log p).  Returns the
    new (R,) float32 kT of each replica."""
    old = np.asarray(kTs, dtype=np.float32)
    U = np.asarray(U, dtype=np.float32)
    betas = 1.0 / old
    rank_of = np.argsort(old)
    rng = np.random.default_rng([seed, iteration])
    new = old.copy()
    for s in range(iteration % 2, len(old) - 1, 2):
        i, j = rank_of[s], rank_of[s + 1]
        log_p = (betas[i] - betas[j]) * (U[i] - U[j])
        if log_p >= 0 or rng.uniform() < math.exp(log_p):
            new[i], new[j] = new[j], new[i]
    return new


def worse(a: float, b) -> float:
    """The larger of two readings of a number compared, where a reading
    that is not a number (a NaN) counts as infinitely bad."""
    b = float(b)
    return float("inf") if b != b else max(a, b)


def nearest(xa, xb, L, block: int = 1024):
    """For each particle of ``xa`` (N, 3) the index of the nearest one of
    ``xb`` (M, 3) in the box ``L`` (3,) and the distance to it."""
    idx, dist = [], []
    xa32 = xa.to(torch.float32)
    xb32 = xb.to(torch.float32)
    L32 = L.to(torch.float32)
    for r0 in range(0, len(xa), block):
        d = min_image(xa32[r0:r0 + block, None, :] - xb32[None, :, :], L32)
        r2 = (d * d).sum(-1)
        m = torch.argmin(r2, dim=1)
        idx.append(m)
        dd = min_image(xa[r0:r0 + block].to(torch.float64)
                       - xb[m].to(torch.float64), L.to(torch.float64))
        dist.append(torch.sqrt((dd * dd).sum(-1)))
    return torch.cat(idx), torch.cat(dist)
