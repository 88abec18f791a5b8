"""Dense all-pairs LJ force and energy (port of ``chiron_tpu/ops/lj_dense.py``).

``lj_dense_force_energy`` is the wrapper of kernel K1 (``csrc/lj_dense.cu``,
replacing ``_make_triangle_kernel``): all-pairs minimum-image LJ in the
(3, n_pad) f32 lane layout, with the approximate or the Newton-refined
reciprocal and an optional energy.  On a CPU tensor it runs
``lj_dense_plain``, the same function in plain PyTorch.
``lj_dense_force_energy_replicas`` is K1 over a leading replica axis in one
launch of the same C entry (JAX's ``vmap`` of the same ``pallas_call`` in
the dense tempering chain), each replica's result K1's on that replica bit
for bit; its plain version ``lj_dense_replicas_plain`` loops
``lj_dense_plain``.  ``LJDense`` has the surface of ``LJDensePallas``;
with ``triangle=False`` it stands for K2, the JAX square kernel
(``_make_kernel``), which computes the same function and runs on the same
CUDA kernel.  ``lj_rows_plain`` is the pair math of any rows against every
column, shared by the plain versions here and in ``parallel/spatial.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..profiling import span
from . import _build
from .diff import energy_with_force_gradient


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# The kernel's blocks (csrc/lj_dense.cu) own DENSE_ROWS rows each and leave
# one energy partial each.
DENSE_ROWS = 32


def box_diagonal(box, device) -> torch.Tensor:
    """(1, 3) f32 box lengths on ``device`` from a (3, 3) orthogonal box or
    from 3 lengths (numpy, list or tensor)."""
    if not torch.is_tensor(box):
        box = np.array(box, dtype=np.float32)  # a writable copy
    b = torch.as_tensor(box, dtype=torch.float32, device=device)
    if b.shape == (3, 3):
        b = torch.diagonal(b)
    return b.reshape(1, 3).contiguous()


def lj_rows_plain(rows3, pos3, box_diag, off: int, n: int, sigma: float,
                  epsilon: float, cutoff: float, with_energy: bool = True,
                  keep=None, divide: bool = False):
    """The dense pair math for rows ``off ..`` of the lane layout, in plain
    PyTorch: returns ((3, rows) force, () float64 energy or None).

    ``rows3`` holds the rows' positions and ``pos3`` every column's.  Each
    row meets every live column but itself (and, with ``keep(rid, cid)``,
    only where that bool grid holds); the energy sums each pair from its
    row's side.  Mirrors ``_lj_tile_math``: minimum image by
    floor(d/L + 1/2), r^2 clamped at 1e-4 sigma^2, coef = 24 eps (2 s12 -
    s6) / r^2, the exact division (which the kernels' Newton-refined
    reciprocal matches to an ulp).  ``divide`` takes the minimum image as
    floor(d / L + 1/2), the fused MD kernel's form.  Rows go in chunks of at
    most 2^25 pair slots, so that memory stays bounded at large N.
    """
    dev = pos3.device
    n_rows, n_pad = rows3.shape[1], pos3.shape[1]
    chunk = max(1, (1 << 25) // n_pad)
    sigma2 = sigma * sigma
    eps4 = 4.0 * epsilon
    L = box_diag.reshape(3, 1, 1)
    inv_L = 1.0 / L
    cid = torch.arange(n_pad, device=dev)
    zero = torch.zeros((), dtype=pos3.dtype, device=dev)
    force = torch.empty((3, n_rows), dtype=pos3.dtype, device=dev)
    energy = torch.zeros((), dtype=torch.float64, device=dev)
    for r0 in range(0, n_rows, chunk):
        rows = rows3[:, r0:r0 + chunk]
        rid = off + r0 + torch.arange(rows.shape[1], device=dev)
        d = rows[:, :, None] - pos3[:, None, :]
        d = d - L * torch.floor((d / L if divide else d * inv_L) + 0.5)
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        pair = ((rid[:, None] < n) & (cid[None, :] < n)
                & (rid[:, None] != cid[None, :]))
        if keep is not None:
            pair = pair & keep(rid[:, None], cid[None, :])
        m = (r2 < cutoff * cutoff) & pair
        r2s = torch.clamp_min(r2, 1e-4 * sigma2)
        inv = 1.0 / r2s
        inv_r2 = sigma2 * inv
        i6 = inv_r2 * inv_r2 * inv_r2
        i12 = i6 * i6
        coef = torch.where(m, (6.0 * eps4) * (2.0 * i12 - i6) * inv, zero)
        force[:, r0:r0 + rows.shape[1]] = torch.sum(coef[None] * d, dim=2)
        if with_energy:
            e = torch.where(m, eps4 * (i12 - i6), zero)
            energy = energy + torch.sum(e, dtype=torch.float64)
    return force, (energy if with_energy else None)


def lj_dense_plain(pos3, box_diag, n: int, sigma: float, epsilon: float,
                   cutoff: float, with_energy: bool = True):
    """Plain version of K1 (and K2): returns ((3, n_pad) force, energy or
    None), every pair of live particles once from each side (the energy,
    summed in float64, is halved); see ``lj_rows_plain``."""
    force, energy = lj_rows_plain(pos3, pos3, box_diag, 0, n, sigma, epsilon,
                                  cutoff, with_energy)
    if not with_energy:
        return force, None
    return force, (0.5 * energy).to(pos3.dtype)


def lj_dense_force_energy(pos3, box_diag, n: int, sigma: float,
                          epsilon: float, cutoff: float,
                          approx_recip: bool = False,
                          with_energy: bool = True):
    """K1: dense LJ force (and energy) of ``pos3`` in the lane layout.

    ``box_diag`` holds the three box lengths on the device of ``pos3``.
    Returns ((3, n_pad) force with zero padding columns, () energy or None).
    """
    return _dense_launch("lj_dense", pos3, box_diag, n, sigma, epsilon,
                         cutoff, approx_recip, with_energy)


def _dense_launch(counter, pos3, box_diag, n, sigma, epsilon, cutoff,
                  approx_recip, with_energy):
    """K1 on one system ((3, n_pad) ``pos3``, 3 box lengths) or on R
    replicas in one launch ((R, 3, n_pad), R x 3 box lengths), its launch
    counted under ``counter``; returns the force in the shape of ``pos3``
    and the () or (R,) energy (or None)."""
    single = pos3.dim() == 2
    if pos3.device.type == "cpu":
        if single:
            return lj_dense_plain(pos3, box_diag, n, sigma, epsilon, cutoff,
                                  with_energy)
        return lj_dense_replicas_plain(pos3, box_diag, n, sigma, epsilon,
                                       cutoff, with_energy)
    _build.check_cuda(pos3, "pos3")
    if pos3.dim() not in (2, 3) or pos3.shape[-2] != 3:
        raise ValueError(f"pos3: shape {tuple(pos3.shape)}, expected "
                         "(3, n_pad) or (R, 3, n_pad)")
    R = 1 if single else pos3.shape[0]
    n_pad = pos3.shape[-1]
    _build.require(pos3, "pos3", tuple(pos3.shape[:-2]) + (3, n_pad),
                   torch.float32)
    _build.require(box_diag, "box_diag", None, torch.float32, pos3.device)
    if (box_diag.numel() != 3 * R or n_pad % DENSE_ROWS != 0
            or not 0 < n <= n_pad or not 0 < R <= 65535):
        raise ValueError(
            f"{counter}: needs 3 box lengths a replica, n_pad % {DENSE_ROWS} "
            f"== 0, 0 < n <= n_pad and 0 < R <= 65535 (got "
            f"{box_diag.numel()} lengths, R={R}, n_pad={n_pad}, n={n})"
        )
    force = torch.empty_like(pos3)
    e_part = torch.empty((R, n_pad // DENSE_ROWS), dtype=torch.float32,
                         device=pos3.device)
    energy = torch.empty(R, dtype=torch.float32, device=pos3.device)
    sigma2 = sigma * sigma
    eps4 = 4.0 * epsilon
    _build.launch(
        counter, "chiron_lj_dense",
        pos3.data_ptr(), box_diag.data_ptr(), force.data_ptr(),
        e_part.data_ptr(), energy.data_ptr(), n, n_pad, R, sigma2, 6.0 * eps4,
        eps4, cutoff * cutoff, 1e-4 * sigma2, int(approx_recip),
        int(with_energy), _build.stream_of(pos3),
    )
    if not with_energy:
        return force, None
    return force, (energy[0] if single else energy)


def lj_dense_replicas_plain(pos3r, box_r, n: int, sigma: float,
                            epsilon: float, cutoff: float,
                            with_energy: bool = True):
    """Plain version of K1 over replicas: ``lj_dense_plain`` on each
    (3, n_pad) replica of ``pos3r`` with its own 3 box lengths; returns
    ((R, 3, n_pad) force, (R,) energy or None)."""
    box_r = box_r.reshape(-1, 3)
    out = [lj_dense_plain(pos3r[r], box_r[r].reshape(1, 3), n, sigma,
                          epsilon, cutoff, with_energy)
           for r in range(pos3r.shape[0])]
    force = torch.stack([f for f, _ in out])
    if not with_energy:
        return force, None
    return force, torch.stack([e for _, e in out])


def lj_dense_force_energy_replicas(pos3r, box_r, n: int, sigma: float,
                                   epsilon: float, cutoff: float,
                                   approx_recip: bool = False,
                                   with_energy: bool = True):
    """K1 over replicas, one launch: ``pos3r`` (R, 3, n_pad) positions in
    the lane layout, ``box_r`` the R replicas' box lengths (R x 3 floats,
    (R, 1, 3) as the tempering sampler keeps them).  Returns ((R, 3, n_pad)
    force, (R,) energy or None); replica r's are ``lj_dense_force_energy``'s
    on ``pos3r[r]`` bit for bit.  Counted as ``lj_dense_replicas``."""
    if pos3r.dim() != 3:
        raise ValueError(f"pos3r: shape {tuple(pos3r.shape)}, expected "
                         "(R, 3, n_pad)")
    return _dense_launch("lj_dense_replicas", pos3r, box_r, n, sigma,
                         epsilon, cutoff, approx_recip, with_energy)


class LJDense:
    """Dense LJ force+energy for a fixed (N, params): the ``LJDensePallas``
    surface on K1.

    ``tm``/``tn`` only set the padding (n_pad is a multiple of both, as in
    the JAX package, so that the runners share one state shape).  The JAX
    package has two kernels for this function: the triangle (K1, the
    default) and, with ``triangle=False``, the square kernel (K2) that
    visits every pair from both sides.  ``csrc/lj_dense.cu`` already visits
    every pair from both sides, so both run it; ``triangle`` only names the
    surface and the launch count (``lj_dense`` or ``lj_dense_square``).
    """

    def __init__(self, n: int, sigma: float, epsilon: float, cutoff: float,
                 tm: int = 128, tn: int = 128, n_pad: Optional[int] = None,
                 triangle: bool = True, *, device="cuda"):
        self.n = n
        self.sigma = float(sigma)
        self.epsilon = float(epsilon)
        self.cutoff = float(cutoff)
        self.n_pad = _round_up(n_pad if n_pad is not None else n, max(tm, tn))
        self.tm, self.tn = tm, tn
        self.triangle = triangle
        self.device = torch.device(device)

    def _fe(self, pos3, box_diag, approx_recip, with_energy):
        return _dense_launch(
            "lj_dense" if self.triangle else "lj_dense_square", pos3,
            box_diag, self.n, self.sigma, self.epsilon, self.cutoff,
            approx_recip, with_energy,
        )

    def force_only_t(self, pos3, box_diag, approx_recip: bool = True):
        """(3, n_pad) force without the energy (the stepping hot path)."""
        return self._fe(pos3, box_diag, approx_recip, False)[0]

    def force_energy_t(self, pos3, box_diag):
        """(3, n_pad) force and () energy, exact reciprocal."""
        return self._fe(pos3, box_diag, False, True)

    def force_only_r(self, pos3r, box_r, approx_recip: bool = True):
        """(R, 3, n_pad) force of R replicas in one launch (K1 over
        replicas); ``box_r`` holds each replica's box lengths."""
        with span("chiron.op.lj_dense_replicas"):
            return lj_dense_force_energy_replicas(
                pos3r, box_r, self.n, self.sigma, self.epsilon, self.cutoff,
                approx_recip, False)[0]

    def force_energy_r(self, pos3r, box_r):
        """(R, 3, n_pad) force and (R,) energy of R replicas, exact
        reciprocal, in one launch."""
        with span("chiron.op.lj_dense_replicas"):
            return lj_dense_force_energy_replicas(
                pos3r, box_r, self.n, self.sigma, self.epsilon, self.cutoff,
                False, True)

    def pad_positions(self, positions):
        """(N, 3) -> (3, n_pad) f32 on this op's device, zero padding."""
        p = torch.as_tensor(positions, dtype=torch.float32, device=self.device)
        pos3 = torch.zeros((3, self.n_pad), dtype=torch.float32,
                           device=self.device)
        pos3[:, :self.n] = p.T
        return pos3

    def unpad(self, a3):
        return a3[:, :self.n].T

    def force_energy(self, positions, box_vectors):
        """(N, 3) force and energy of (N, 3) positions in a (3, 3) box."""
        box_diag = box_diagonal(box_vectors, self.device)
        force3, energy = self.force_energy_t(self.pad_positions(positions),
                                             box_diag)
        return self.unpad(force3), energy

    def energy(self, positions, box_vectors):
        """Differentiable energy: autograd gives exactly ``-force``."""
        return energy_with_force_gradient(
            lambda p: self.force_energy(p, box_vectors), positions,
        )
