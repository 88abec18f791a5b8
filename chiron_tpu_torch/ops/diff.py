"""Differentiable energy whose gradient is exactly ``-force``
(port of ``chiron_tpu/ops/diff.py``).

One fused force+energy pass computes both; the autograd backward replays
the saved force, so ``grad(energy) == -force`` holds bit for bit and costs
nothing beyond the forward pass.
"""

from __future__ import annotations

import torch


class _EnergyWithForceGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, positions, force_energy_fn):
        with torch.no_grad():
            force, energy = force_energy_fn(positions)
        ctx.save_for_backward(force)
        return energy

    @staticmethod
    def backward(ctx, grad_energy):
        (force,) = ctx.saved_tensors
        return -grad_energy * force, None


def energy_with_force_gradient(force_energy_fn, positions):
    """Evaluate a differentiable energy at ``positions``.

    ``force_energy_fn(p) -> (force, energy)`` is one fused pass with the
    exact reciprocal and ``force`` of ``p``'s shape; the returned energy's
    gradient under autograd is exactly ``-force``.
    """
    return _EnergyWithForceGradient.apply(positions, force_energy_fn)
