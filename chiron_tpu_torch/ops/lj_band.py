"""Banded LJ force over x-sorted particles (port of ``chiron_tpu/ops/lj_band.py``).

Particles are kept sorted by x, so every pair within the cutoff has a
bounded cyclic rank distance: the force is evaluated only on the band of
width ``w`` ahead of each rank.  ``band_force`` and ``band_force_energy``
wrap kernel K6 (``csrc/lj_band.cu``, replacing ``band_force_raw`` and
``band_force_energy_raw``); on a CPU tensor they run ``band_force_plain``.
``LJBand`` has the surface of ``LJBandPallas``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .diff import energy_with_force_gradient
from .lj_cull import row_chunk, sort_by_key
from .lj_dense import _round_up


def n_band_tiles(w: int, tm: int, n_tiles: int) -> int:
    """Column tiles a row tile visits (``lj_band.py:50``): the band, the
    padding gap between rank n-1 and rank 0, and the row tile's own span,
    never more than every tile once."""
    return min((w + tm - 1) // tm + 2, n_tiles)


def check_band_tiles(n_pad: int, tm: int):
    """Raise unless K6 takes row tile ``tm`` at ``n_pad``: 64 or a multiple
    of 128, dividing n_pad."""
    if not (tm == 64 or (tm > 0 and tm % 128 == 0)) or n_pad % tm:
        raise ValueError(
            f"band kernel takes tm 64 or a multiple of 128 dividing n_pad "
            f"(got tm={tm}, n_pad={n_pad})")


def sort_by_x(pos3, payloads, n: int):
    """Stable sort of the (3, n_pad) layout by x (``lj_band.py:211``);
    payloads (last axis n_pad) follow the permutation.  Live lanes are
    keyed by x and the padding by 3e38, so it stays at the end; after the
    sort the padding's x is 0.  Returns (sorted pos3, sorted payloads)."""
    live = torch.arange(pos3.shape[1], device=pos3.device) < n
    ps, payloads = sort_by_key(torch.where(live, pos3[0], 3.0e38), pos3,
                               payloads)
    return torch.stack([torch.where(live, ps[0], 0.0), ps[1], ps[2]]), payloads


def band_width_needed(xs, n: int, reach, L):
    """() int32: the largest forward rank window that covers x-distance
    ``reach``, cyclic in ``L`` (``lj_band.py:228``).  ``xs`` is the (n_pad,)
    sorted x row with sentinels beyond n; ``L`` a float or a 0-dim tensor."""
    n_pad = xs.shape[0]
    idx = torch.arange(n_pad, device=xs.device)
    valid = idx < n
    hi = torch.where(valid, xs, 0.0) + reach
    count_fwd = torch.searchsorted(xs, hi, right=True) - idx
    count_wrap = torch.searchsorted(xs, hi - L, right=True)
    counts = torch.where(valid, count_fwd + count_wrap, 0)
    return torch.max(counts).to(torch.int32)


def band_force_plain(pos3, box_diag, n: int, w: int, sigma: float,
                     epsilon: float, cutoff: float, tm: int,
                     with_energy: bool = False):
    """Plain version of K6: returns ((3, n_pad) force, energy or None).

    Row tile by row tile, so that memory stays bounded at large N: each
    row is paired with the ``n_band_tiles`` column tiles ahead of its tile
    (cyclically), and a pair counts when both ranks are live and the cyclic
    rank distance over the n live ranks is in [1, w].  Full minimum image on
    all three axes, r^2 clamped at 1e-4 sigma^2, the exact reciprocal, the
    energy of each unordered pair once, summed in float64.
    """
    dev = pos3.device
    n_pad = pos3.shape[1]
    n_tiles = n_pad // tm
    nbt = n_band_tiles(w, tm, n_tiles)
    sigma2 = sigma * sigma
    eps4 = 4.0 * epsilon
    L = box_diag.reshape(3, 1, 1)
    lane = torch.arange(tm, device=dev)
    F = torch.zeros((3, n_pad), dtype=pos3.dtype, device=dev)
    energy = torch.zeros((), dtype=torch.float64, device=dev)
    zero = torch.zeros((), dtype=pos3.dtype, device=dev)
    for i in range(n_tiles):
        rid = i * tm + lane
        jt = (i + torch.arange(nbt, device=dev)) % n_tiles
        cid = (jt[:, None] * tm + lane).reshape(-1)
        d = pos3[:, rid, None] - pos3[:, None, cid]
        d = d - L * torch.floor(d / L + 0.5)
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        delta = torch.remainder(cid[None, :] - rid[:, None] + n, n)
        pm = ((rid[:, None] < n) & (cid[None, :] < n)
              & (delta >= 1) & (delta <= w))
        m = (r2 < cutoff * cutoff) & pm
        inv = 1.0 / torch.clamp_min(r2, 1e-4 * sigma2)
        i2 = sigma2 * inv
        i6 = i2 * i2 * i2
        coef = torch.where(m, (6.0 * eps4) * (2.0 * i6 * i6 - i6) * inv, zero)
        t = coef[None] * d
        F[:, rid] += t.sum(dim=2)
        F.index_add_(1, cid, -t.sum(dim=1))
        if with_energy:
            e = torch.where(m, eps4 * (i6 * i6 - i6), zero)
            energy = energy + torch.sum(e, dtype=torch.float64)
    return F, (energy.to(pos3.dtype) if with_energy else None)


def _band_launch(kernel: str, pos3, box_diag, n: int, w: int, sigma: float,
                 epsilon: float, cutoff: float, tm: int, approx_recip: bool,
                 with_energy: bool, skip: bool):
    """Check the inputs and launch ``csrc/lj_band.cu``, counted under
    ``kernel``.  Returns ((3, n_pad) force, () energy or None)."""
    _build.check_cuda(pos3, "pos3")
    dev = pos3.device
    n_pad = pos3.shape[1]
    _build.require(pos3, "pos3", (3, n_pad), torch.float32)
    _build.require(box_diag, "box_diag", None, torch.float32, dev)
    check_band_tiles(n_pad, tm)
    if (box_diag.numel() != 3 or not 0 < w < (n - 1) // 2
            or not 0 < n <= n_pad):
        raise ValueError(
            f"band kernel takes 3 box lengths and 0 < w < (n-1)//2 (got "
            f"n_pad={n_pad}, n={n}, w={w})"
        )
    n_tiles = n_pad // tm
    nbt = n_band_tiles(w, tm, n_tiles)
    ts = row_chunk(tm)  # the square sub-tile a block takes
    # each block a sub-tile, each visit C = tm / ts column chunks
    F, P, R, e_part, energy = _build.pass_buffers(
        n_pad, n_pad // ts, n_pad // ts * nbt * (tm // ts), ts, with_energy,
        dev)
    sigma2 = sigma * sigma
    _build.launch(
        kernel, "chiron_band_force",
        pos3.data_ptr(), box_diag.data_ptr(), P.data_ptr(), R.data_ptr(),
        e_part.data_ptr(), F.data_ptr(),
        None if energy is None else energy.data_ptr(),
        n, n_pad, tm, w, nbt, _build.PASS_SPLIT, sigma2, cutoff * cutoff,
        1e-4 * sigma2, 24.0 * epsilon, 4.0 * epsilon, int(approx_recip),
        int(skip), _build.stream_of(pos3),
    )
    return F, (energy[0] if with_energy else None)


def band_force(pos3, box_diag, n: int, w: int, sigma: float, epsilon: float,
               cutoff: float, tm: int, approx_recip: bool = True,
               skip: bool = True):
    """K6 (``band_force_raw``): the (3, n_pad) banded force of x-sorted
    ``pos3``.  Launches ``csrc/lj_band.cu`` on a CUDA tensor; runs
    ``band_force_plain`` (exact reciprocal) on a CPU tensor.  ``skip=False``
    makes the kernel take every slot, with no skip: the reference whose
    bits the skips keep on a finite state (for tests)."""
    if pos3.device.type == "cpu":
        return band_force_plain(pos3, box_diag, n, w, sigma, epsilon, cutoff,
                                tm)[0]
    return _band_launch("band_force", pos3, box_diag, n, w, sigma, epsilon,
                        cutoff, tm, approx_recip, False, skip)[0]


def band_force_energy(pos3, box_diag, n: int, w: int, sigma: float,
                      epsilon: float, cutoff: float, tm: int,
                      skip: bool = True):
    """K6 (``band_force_energy_raw``): banded force and () single-count
    truncated-LJ energy in one pass, with the exact reciprocal (``skip`` as
    in ``band_force``)."""
    if pos3.device.type == "cpu":
        return band_force_plain(pos3, box_diag, n, w, sigma, epsilon, cutoff,
                                tm, with_energy=True)
    return _band_launch("band_force_energy", pos3, box_diag, n, w, sigma,
                        epsilon, cutoff, tm, False, True, skip)


class LJBand:
    """Banded LJ force over x-sorted state (``LJBandPallas``).

    ``margin`` is the x drift each particle may make between re-sorts;
    ``w`` the band capacity in ranks, set by ``calibrate`` when None.  On
    the card ``tm`` is raised to at least 128, as on the TPU; on the CPU it
    is kept as given, as the JAX package's interpret mode keeps it.
    """

    def __init__(self, n: int, sigma: float, epsilon: float, cutoff: float,
                 margin: float = 0.15, tm: int = 256, w: Optional[int] = None,
                 *, device="cuda"):
        self.n = n
        self.sigma = float(sigma)
        self.epsilon = float(epsilon)
        self.cutoff = float(cutoff)
        self.margin = float(margin)
        self.reach = self.cutoff + 2.0 * self.margin
        self.device = torch.device(device)
        if self.device.type != "cpu":
            tm = max(tm, 128)
        self.tm = tm
        self.n_pad = _round_up(n, tm)
        if w is not None and w >= (n - 1) // 2:
            raise ValueError(
                f"band width w={w} >= n/2 would double-count pairs; "
                f"use LJDense for boxes this small"
            )
        self.w = w

    def calibrate(self, pos3_sorted, L, headroom: float = 1.2) -> int:
        """Pick the band capacity from the initial sorted configuration,
        from its x row as ``sort_by_x`` leaves it (the padding's x is 0, as
        in the JAX package).  Raises where the band would span half the
        system: the dense engine's regime."""
        w_data = int(band_width_needed(pos3_sorted[0], self.n, self.reach, L))
        w = int(w_data * headroom) + self.tm
        if w >= (self.n - 1) // 2:
            raise ValueError(
                f"banded kernel inapplicable: band width {w} >= n/2 "
                f"({self.n // 2}); the box is too small relative to "
                f"cutoff+2*margin -- use LJDense instead"
            )
        self.w = w
        return w

    def _args(self):
        if self.w is None:
            raise RuntimeError("call calibrate() first")
        return (self.n, self.w, self.sigma, self.epsilon, self.cutoff, self.tm)

    def force(self, pos3_sorted, box_diag, approx_recip: bool = True):
        return band_force(pos3_sorted, box_diag, *self._args(),
                          approx_recip=approx_recip)

    def force_energy(self, pos3_sorted, box_diag):
        """Force and () single-count energy in one pass, exact reciprocal."""
        return band_force_energy(pos3_sorted, box_diag, *self._args())

    def energy_differentiable(self, pos3_sorted, box_diag):
        """Banded energy whose autograd gradient is exactly ``-force`` of
        one exact pass; the band width is constant data."""
        return energy_with_force_gradient(
            lambda p: self.force_energy(p, box_diag), pos3_sorted)
