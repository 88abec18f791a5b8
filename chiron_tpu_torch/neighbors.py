"""Interaction discovery: all-pairs list, Verlet neighbor list and the dense
scheme (port of ``chiron_tpu/neighbors.py``).

The list states are plain dataclasses of tensors, and every function here
follows the device of the positions it is given.  The structures equal the
JAX package's exactly:

* half-list semantics: no self pairs, pair (i, j) only in the row of the
  smaller index;
* a row's ids ascend and are padded to ``n_max_neighbors`` with the row's
  fill, the first listed column, moved one on where it equals the row id
  (0, or 1 for row 0, where the row is empty): JAX's fixed-size
  ``jnp.where(mask_row, size=K, fill_value=fill)``, here as a cumulative
  sum that scatters each listed column to its rank;
* a ``True`` ``overflow`` flag where a row needed more than K slots, and the
  host ``build``'s grow-by-10 retry.

The fill never names the row itself and the all-pairs list never lists i
with itself, so no zero distance reaches a norm's backward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from . import units

# Spaces are re-exported here, where the reference keeps them.
from .space import OrthogonalNonPeriodicSpace, OrthogonalPeriodicSpace, Space


# ---------------------------------------------------------------------------
# States
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NeighborListState:
    """Verlet-list state (all fields are tensors on one device).

    neighbor_list : (N, K) int32 -- padded neighbor ids (half list).
    neighbor_mask : (N, K) int32 -- 1 for real neighbors, 0 for padding.
    n_neighbors   : (N,)   int32 -- true neighbor counts (may exceed K!).
    ref_positions : (N, 3) -- positions at build time (skin reference).
    box_vectors   : (3, 3) or None -- box at build time.
    overflow      : ()     bool  -- True if any row needed more than K slots.
    """

    neighbor_list: torch.Tensor
    neighbor_mask: torch.Tensor
    n_neighbors: torch.Tensor
    ref_positions: torch.Tensor
    box_vectors: Optional[torch.Tensor]
    overflow: torch.Tensor


@dataclass(frozen=True)
class DensePairsState:
    """State of the dense (list-free) scheme: just the box.  K1 recomputes
    all pairs every evaluation, so a barostat move needs no rebuild."""

    box_vectors: torch.Tensor


@dataclass(frozen=True)
class PairListState:
    """All-pairs list state.

    all_pairs      : (N, N-1) int32 -- row i lists every j != i.
    reduction_mask : (N, N-1) bool  -- True where i < j (no double counting).
    box_vectors    : (3, 3) or None.
    """

    all_pairs: torch.Tensor
    reduction_mask: torch.Tensor
    box_vectors: Optional[torch.Tensor]


# ---------------------------------------------------------------------------
# Pure functions of tensors
# ---------------------------------------------------------------------------


def _rows_where(mask: torch.Tensor, size: int,
                fill: torch.Tensor) -> torch.Tensor:
    """Per row, the ascending column ids where ``mask`` holds, the first
    ``size`` of them, padded with the row's ``fill``: JAX's
    ``vmap(lambda m, f: jnp.where(m, size=size, fill_value=f))``."""
    n_rows, n_cols = mask.shape
    rank = torch.cumsum(mask, dim=1, dtype=torch.int64) - 1
    # a column that is not listed, or ranks past ``size``, goes to the
    # spare slot ``size``, which is cut off below
    slot = torch.where(mask & (rank < size), rank, size)
    cols = torch.arange(n_cols, dtype=torch.int32, device=mask.device)
    out = fill.to(torch.int32)[:, None].expand(n_rows, size + 1).clone()
    out.scatter_(1, slot, cols.expand(n_rows, n_cols))
    return out[:, :size]


def neighbor_build_fn(
    positions: torch.Tensor,
    box_vectors: Optional[torch.Tensor],
    cutoff_and_skin: float,
    space: Space,
    n_max_neighbors: int,
) -> NeighborListState:
    """Build a half neighbor list with fixed capacity ``n_max_neighbors``:
    an O(N^2) masked distance computation in one broadcast displacement."""
    n = positions.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=positions.device)
    _, dist = space.displacement(positions[:, None, :], positions[None, :, :],
                                 box_vectors)
    half = ids[:, None] < ids[None, :]
    neighbor_mask = (dist < cutoff_and_skin) & half
    n_neighbors = neighbor_mask.sum(dim=1, dtype=torch.int32)

    # The fill: the first True column per row (0 if the row is empty),
    # bumped by one where it equals the row id.
    fill = torch.argmax(neighbor_mask.to(torch.uint8), dim=1).to(torch.int32)
    fill = torch.where(fill == ids, fill + 1, fill)

    neighbor_list = _rows_where(neighbor_mask, n_max_neighbors, fill)
    k = torch.arange(n_max_neighbors, dtype=torch.int32, device=positions.device)
    padding = (k[None, :] < n_neighbors[:, None]).to(torch.int32)
    overflow = torch.any(n_neighbors > n_max_neighbors)
    return NeighborListState(
        neighbor_list=neighbor_list,
        neighbor_mask=padding,
        n_neighbors=n_neighbors,
        ref_positions=positions,
        box_vectors=box_vectors,
        overflow=overflow,
    )


def neighbor_calculate_fn(
    state: NeighborListState,
    positions: torch.Tensor,
    cutoff: float,
    space: Space,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distances and vectors for the listed neighbors at the current
    positions: (n_pairs, mask, dist, r_ij) with shapes (N,), (N, K), (N, K),
    (N, K, 3), the mask int32 as in JAX."""
    neighbor_pos = positions[state.neighbor_list]  # (N, K, 3) gather
    r_ij, dist = space.displacement(positions[:, None, :], neighbor_pos,
                                    state.box_vectors)
    mask = ((dist < cutoff) & (state.neighbor_mask != 0)).to(torch.int32)
    return mask.sum(dim=1, dtype=torch.int32), mask, dist, r_ij


def neighbor_check_fn(
    state: NeighborListState,
    positions: torch.Tensor,
    skin: float,
    space: Space,
) -> torch.Tensor:
    """The rebuild predicate as a () bool tensor: any particle moved >=
    skin/2 since the build."""
    _, disp = space.displacement(positions, state.ref_positions,
                                 state.box_vectors)
    return torch.any(disp >= skin * 0.5)


def pairlist_build_fn(positions: torch.Tensor,
                      box_vectors: Optional[torch.Tensor]) -> PairListState:
    """The static all-pairs structure: row i holds every j != i, ascending."""
    n = positions.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=positions.device)
    cols = ids[: n - 1]
    all_pairs = cols[None, :] + (cols[None, :] >= ids[:, None]).to(torch.int32)
    return PairListState(
        all_pairs=all_pairs,
        reduction_mask=ids[:, None] < all_pairs,
        box_vectors=box_vectors,
    )


def pairlist_calculate_fn(
    state: PairListState,
    positions: torch.Tensor,
    cutoff: float,
    space: Space,
    use_cutoff: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """All-pairs distances: (n_pairs, mask, dist, r_ij)."""
    neighbor_pos = positions[state.all_pairs]  # (N, N-1, 3)
    r_ij, dist = space.displacement(positions[:, None, :], neighbor_pos,
                                    state.box_vectors)
    keep = state.reduction_mask
    if use_cutoff:
        keep = (dist < cutoff) & keep
    mask = keep.to(torch.int32)
    return mask.sum(dim=1, dtype=torch.int32), mask, dist, r_ij


# ---------------------------------------------------------------------------
# Host-facing classes
# ---------------------------------------------------------------------------


def _positions_to_md(positions) -> torch.Tensor:
    """(N, 3) float32 tensor in nm; a tensor keeps its device, host data goes
    to the CPU."""
    positions = units.coerce(positions)
    if isinstance(positions, units.Quantity):
        if not positions.unit.is_compatible(units.nanometer):
            raise ValueError(
                f"Positions require distance units, not {positions.unit}"
            )
        positions = positions.value_in_unit_system(units.md_unit_system)
    positions = _f32(positions)
    if positions.ndim != 2 or positions.shape[1] != 3:
        raise ValueError(
            f"positions should be a Nx3 array, shape provided: {tuple(positions.shape)}"
        )
    return positions


def _box_to_md(box_vectors, device) -> Optional[torch.Tensor]:
    if box_vectors is None:
        return None
    box_vectors = units.coerce(box_vectors)
    if isinstance(box_vectors, units.Quantity):
        if not box_vectors.unit.is_compatible(units.nanometer):
            raise ValueError(
                f"Box vectors require distance unit, not {box_vectors.unit}"
            )
        box_vectors = box_vectors.value_in_unit_system(units.md_unit_system)
    box_vectors = _f32(box_vectors, device)
    if box_vectors.shape != (3, 3):
        raise ValueError(
            f"box_vectors should be a 3x3 array, shape provided: "
            f"{tuple(box_vectors.shape)}"
        )
    return box_vectors


def _f32(a, device=None) -> torch.Tensor:
    """A float32 tensor of ``a`` on ``device`` (a tensor's own by default,
    the CPU for host data)."""
    if torch.is_tensor(a):
        return a.to(device=device or a.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def _distance_quantity(value, name: str, optional: bool = False):
    """Coerce and validate a construction-boundary distance quantity; a
    bare number raises a TypeError naming the argument."""
    if value is None:
        if optional:
            return None
        raise TypeError(
            f"{name} must be a unit.Quantity with units of distance, got None"
        )
    value = units.coerce(value)
    if not isinstance(value, units.Quantity):
        raise TypeError(
            f"{name} must be a unit.Quantity with units of distance, "
            f"got {type(value)} instead."
        )
    if not value.unit.is_compatible(units.nanometer):
        raise ValueError(
            f"{name} must be a unit.Quantity with units of distance, "
            f"{name}.unit = {value.unit}"
        )
    return value


def _check_n(positions, n_particles: int) -> None:
    if positions.shape[0] != n_particles:
        raise ValueError(
            f"Number of particles cannot changes without rebuilding. "
            f"Positions must have shape ({n_particles}, 3), "
            f"found {tuple(positions.shape)}"
        )


class PairsBase:
    """Shared API of pair-discovery schemes."""

    def __init__(self, space: Space, cutoff=units.Quantity(1.2, units.nanometer)):
        if not isinstance(space, Space):
            raise TypeError(f"space must be of type Space, found {type(space)}")
        self.space = space
        self.cutoff = cutoff  # validated by the (possibly overridden) setter
        self.is_built = False

    @property
    def cutoff(self):
        return self._cutoff

    @cutoff.setter
    def cutoff(self, cutoff):
        self._cutoff = _distance_quantity(cutoff, "cutoff", optional=True)

    def build_from_state(self, sampler_state):
        """Build from a SamplerState, on its device."""
        from .states import SamplerState

        if not isinstance(sampler_state, SamplerState):
            raise TypeError(
                f"Expected SamplerState, got {type(sampler_state)} instead"
            )
        self.build(sampler_state.positions, sampler_state.box_vectors)

    def build(self, positions, box_vectors):  # pragma: no cover - abstract
        raise NotImplementedError

    def calculate(self, positions):  # pragma: no cover - abstract
        raise NotImplementedError

    def check(self, positions) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError


class NeighborListNsqrd(PairsBase):
    """Verlet neighbor list with a skin buffer: a host shell over the
    ``neighbor_*_fn`` functions, which the integrator calls directly with
    the :class:`NeighborListState`."""

    def __init__(
        self,
        space: Space,
        cutoff=units.Quantity(1.2, units.nanometer),
        skin=units.Quantity(0.4, units.nanometer),
        n_max_neighbors: int = 200,
    ):
        super().__init__(space, cutoff)
        self.skin = skin  # validated by the setter
        self.n_max_neighbors = int(n_max_neighbors)
        self._state: Optional[NeighborListState] = None

    @property
    def cutoff(self):
        return self._cutoff

    @cutoff.setter
    def cutoff(self, cutoff):
        self._cutoff = _distance_quantity(cutoff, "cutoff")
        self.is_built = False

    @property
    def skin(self):
        return self._skin

    @skin.setter
    def skin(self, skin):
        self._skin = _distance_quantity(skin, "skin")
        self.is_built = False

    @property
    def cutoff_md(self) -> float:
        return float(self.cutoff.value_in_unit_system(units.md_unit_system))

    @property
    def skin_md(self) -> float:
        return float(self.skin.value_in_unit_system(units.md_unit_system))

    @property
    def state(self) -> NeighborListState:
        if self._state is None:
            raise ValueError("Neighborlist must be built before use")
        return self._state

    @property
    def neighbor_list(self) -> torch.Tensor:
        return self.state.neighbor_list

    @property
    def neighbor_mask(self) -> torch.Tensor:
        return self.state.neighbor_mask

    @property
    def n_neighbors(self) -> torch.Tensor:
        return self.state.n_neighbors

    def build(self, positions, box_vectors) -> None:
        """Build, growing the capacity to (max count) + 10 where a row
        reaches it."""
        positions = _positions_to_md(positions)
        box_vectors = _box_to_md(box_vectors, positions.device)
        cutoff_and_skin = self.cutoff_md + self.skin_md
        state = neighbor_build_fn(positions, box_vectors, cutoff_and_skin,
                                  self.space, self.n_max_neighbors)
        # one extra build suffices: n_neighbors is exact whatever the capacity
        if bool(torch.any(state.n_neighbors >= self.n_max_neighbors)):
            self.n_max_neighbors = int(state.n_neighbors.max()) + 10
            state = neighbor_build_fn(positions, box_vectors, cutoff_and_skin,
                                      self.space, self.n_max_neighbors)
        self._state = state
        self.ref_positions = positions
        self.box_vectors = box_vectors
        self.is_built = True

    def calculate(self, positions: torch.Tensor):
        """(n_neighbors, neighbor_list, padding_mask, dist, r_ij)."""
        state = self.state
        n_pairs, mask, dist, r_ij = neighbor_calculate_fn(
            state, _f32(positions), self.cutoff_md, self.space)
        return n_pairs, state.neighbor_list, mask, dist, r_ij

    def check(self, positions: torch.Tensor) -> bool:
        """Host-facing rebuild predicate."""
        if self._state is None:
            return True
        if self._state.ref_positions.shape[0] != positions.shape[0]:
            return True
        positions = _f32(positions, self._state.ref_positions.device)
        return bool(neighbor_check_fn(self._state, positions, self.skin_md,
                                      self.space))


class DensePairs(PairsBase):
    """List-free dense pair scheme on K1 (``ops/lj_dense.LJDense``): no
    neighbor tables, no rebuild predicate, no capacity -- the kernel
    recomputes all pairs each evaluation.  It goes wherever a
    ``NeighborListNsqrd`` or ``PairListNsqrd`` does, in a periodic box."""

    def __init__(self, space: Space,
                 cutoff=units.Quantity(1.2, units.nanometer)):
        if not isinstance(space, OrthogonalPeriodicSpace):
            raise TypeError(
                "DensePairs requires an OrthogonalPeriodicSpace (the fused "
                "kernel applies minimum-image PBC)"
            )
        super().__init__(space, cutoff)
        self._state: Optional[DensePairsState] = None

    @property
    def cutoff(self):
        return self._cutoff

    @cutoff.setter
    def cutoff(self, cutoff):
        self._cutoff = _distance_quantity(cutoff, "cutoff")

    @property
    def cutoff_md(self) -> float:
        return float(self.cutoff.value_in_unit_system(units.md_unit_system))

    @property
    def state(self) -> DensePairsState:
        if self._state is None:
            raise ValueError("DensePairs must be built before use")
        return self._state

    def build(self, positions, box_vectors) -> None:
        positions = _positions_to_md(positions)
        if box_vectors is None:
            raise ValueError("DensePairs requires box vectors")
        box_vectors = _box_to_md(box_vectors, positions.device)
        self.n_particles = positions.shape[0]
        self.ref_positions = positions
        self.box_vectors = box_vectors
        self._state = DensePairsState(box_vectors=box_vectors)
        self.is_built = True

    def calculate(self, positions: torch.Tensor):
        """Dense distances in plain torch (API parity; the potential runs
        K1 instead).  It materializes the N x N pair matrix."""
        positions = _f32(positions)
        n = positions.shape[0]
        if n > 20_000:
            raise ValueError(
                f"DensePairs.calculate materializes an N x N pair matrix; "
                f"N={n} would need {n ** 2 * 16 / 1e9:.1f}+ GB. Use "
                "NeighborListNsqrd or the fused kernel paths at this size."
            )
        _check_n(positions, self.n_particles)
        ids = torch.arange(n, dtype=torch.int32, device=positions.device)
        r_ij, dist = self.space.displacement(
            positions[:, None, :], positions[None, :, :], self.state.box_vectors)
        mask = (ids[:, None] < ids[None, :]) & (dist < self.cutoff_md)
        pairs = ids[None, :].expand(n, n)
        return (mask.sum(dim=1, dtype=torch.int32), pairs,
                mask.to(torch.int32), dist, r_ij)

    def check(self, positions: torch.Tensor) -> bool:
        """Never needs rebuilding (box updates flow through the state)."""
        return positions.shape[0] != getattr(self, "n_particles", -1)


class PairListNsqrd(PairsBase):
    """All-pairs list with an optional cutoff (``cutoff=None``: none at
    calculate time)."""

    def __init__(self, space: Space, cutoff: Optional[units.Quantity] = None):
        super().__init__(space, cutoff)
        self._state: Optional[PairListState] = None

    @property
    def cutoff_md(self) -> Optional[float]:
        if self.cutoff is None:
            return None
        return float(self.cutoff.value_in_unit_system(units.md_unit_system))

    @property
    def state(self) -> PairListState:
        if self._state is None:
            raise ValueError("Pair list must be built before use")
        return self._state

    @property
    def all_pairs(self) -> torch.Tensor:
        return self.state.all_pairs

    @property
    def reduction_mask(self) -> torch.Tensor:
        return self.state.reduction_mask

    def build(self, positions, box_vectors) -> None:
        positions = _positions_to_md(positions)
        box_vectors = _box_to_md(box_vectors, positions.device)
        self.n_particles = positions.shape[0]
        self.ref_positions = positions
        self.box_vectors = box_vectors
        self._state = pairlist_build_fn(positions, box_vectors)
        self.is_built = True

    def calculate(self, positions: torch.Tensor):
        positions = _f32(positions)
        _check_n(positions, self.n_particles)
        state = self.state
        use_cutoff = self.cutoff is not None
        cutoff = self.cutoff_md if use_cutoff else float("inf")
        n_pairs, mask, dist, r_ij = pairlist_calculate_fn(
            state, positions, cutoff, self.space, use_cutoff)
        return n_pairs, state.all_pairs, mask, dist, r_ij

    def check(self, positions: torch.Tensor) -> bool:
        """Rebuild only when N changes."""
        return positions.shape[0] != getattr(self, "n_particles", -1)
