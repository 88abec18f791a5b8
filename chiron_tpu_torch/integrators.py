"""Langevin carry (port of ``chiron_tpu/integrators.py:52-67``).

Only ``LangevinCarry`` is ported: the dense fast runner
(``runtime.make_fast_lj_runner``) keeps its state in it.  The class-based
``LangevinIntegrator`` waits for the general-API port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class LangevinCarry:
    """Full dynamic state of one Langevin chain.

    ``x``, ``v`` and ``F`` are (3, n_pad) float32 in the kernels' lane
    layout, ``box_vectors`` the (1, 3) box diagonal and ``overflowed`` a
    () bool.  ``generator`` draws the O-step noise: it replaces the JAX
    carry's PRNG key, and lives on the state's device.
    """

    x: torch.Tensor
    v: torch.Tensor
    F: torch.Tensor
    box_vectors: torch.Tensor
    overflowed: torch.Tensor
    generator: Optional[torch.Generator] = None
