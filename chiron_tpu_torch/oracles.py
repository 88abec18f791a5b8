"""Plain dense LJ oracle (port of ``chiron_tpu/oracles.py``).

The semantic reference for the fused engines: truncated, unshifted LJ with
the cutoff strict (r^2 < cutoff^2), minimum image via round() and
self-exclusion.  It computes in the dtype of ``pos``: float32 to mirror the
JAX oracle, float64 as the high-precision reference.
"""

import torch


def lj_dense_oracle(pos, box, sigma, epsilon, cutoff):
    """Masked dense LJ force + energy with minimum image.

    ``pos`` is (N, 3), ``box`` a (3, 3) orthogonal box (diagonal used).
    Returns (force (N, 3), total energy scalar) in ``pos.dtype``.
    """
    box = torch.as_tensor(box, dtype=pos.dtype, device=pos.device)
    ids = torch.arange(pos.shape[0], device=pos.device)
    Lv = torch.diagonal(box)
    d = pos[:, None, :] - pos[None, :, :]
    d = d - Lv * torch.round(d / Lv)
    r2 = torch.sum(d * d, -1)
    m = (r2 < cutoff * cutoff) & (ids[:, None] != ids[None, :])
    r2s = torch.where(m, r2, torch.ones_like(r2))
    inv2 = (sigma * sigma) / r2s
    inv6 = inv2 * inv2 * inv2
    zero = torch.zeros_like(r2)
    coef = torch.where(m, 24 * epsilon * (2 * inv6 * inv6 - inv6) / r2s, zero)
    F = torch.sum(coef[..., None] * d, dim=1)
    E = 0.5 * torch.sum(torch.where(m, 4 * epsilon * (inv6 * inv6 - inv6), zero))
    return F, E
