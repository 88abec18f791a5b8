"""Simulation spaces: displacement and periodic wrapping as pure functions
(port of ``chiron_tpu/space.py``).

The space classes are stateless singletons whose methods are pure functions
of ``(xyz, box_vectors)`` tensors; every output lies on the device of
``xyz``.  The minimum image is ``mod(r + L/2, L) - L/2`` with JAX's
floor-mod: ``fmod`` and then ``L`` added where the remainder is nonzero
and of the other sign than ``L``.  ``torch.fmod`` is exact, as XLA's ``rem``
is, so the displacements, and the pair lists' integer masks built on them,
are JAX's bit for bit; ``torch.remainder`` rounds differently in the last
ulp.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional, Tuple

import torch


def _floor_mod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.mod(x, y)`` for floats, as JAX computes it."""
    r = torch.fmod(x, y)
    fix = (r != 0) & ((r < 0) != (y < 0))
    return torch.where(fix, r + y, r)


def _box_lengths(box_vectors: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(box_vectors, dim1=-2, dim2=-1)


class Space(ABC):
    """How to measure displacements and wrap coordinates under the BCs.

    Box vectors are always passed as data, so that a barostat move that
    rescales the box needs no new object.
    """

    @abstractmethod
    def displacement(
        self, xyz_1: torch.Tensor, xyz_2: torch.Tensor,
        box_vectors: Optional[torch.Tensor],
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Return (r_ij, dist): displacement vectors and their norms."""

    @abstractmethod
    def wrap(self, xyz: torch.Tensor,
             box_vectors: Optional[torch.Tensor]) -> torch.Tensor:
        """Apply the boundary conditions to coordinates."""

    # Stateless singletons: all instances are interchangeable.
    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))


def _norm(r_ij: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(r_ij * r_ij, dim=-1))


class OrthogonalPeriodicSpace(Space):
    """Orthogonal periodic box."""

    def displacement(self, xyz_1, xyz_2, box_vectors):
        if box_vectors is None:
            raise ValueError("box_vectors must be provided for a periodic system")
        r_ij = xyz_1 - xyz_2
        L = _box_lengths(box_vectors)
        r_ij = _floor_mod(r_ij + L * 0.5, L) - L * 0.5
        return r_ij, _norm(r_ij)

    def wrap(self, xyz, box_vectors):
        if box_vectors is None:
            raise ValueError("box_vectors must be provided for a periodic system")
        L = _box_lengths(box_vectors)
        return xyz - torch.floor(xyz / L) * L


class OrthogonalNonPeriodicSpace(Space):
    """Open (non-periodic) space."""

    def displacement(self, xyz_1, xyz_2, box_vectors=None):
        r_ij = xyz_1 - xyz_2
        return r_ij, _norm(r_ij)

    def wrap(self, xyz, box_vectors=None):
        return xyz
