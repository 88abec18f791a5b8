"""Carry state into the port from plain numpy arrays and floats.

A caller that holds a state of the JAX package (or of anything else) turns
its arrays into numpy and hands them here: this module imports no jax.  The
layouts are the JAX package's: (3, n_pad) f32 lanes, a (1, 3) box
diagonal, and the tile-pair list's (1, capacity) rows.
"""

from __future__ import annotations

import numpy as np
import torch

from . import units
from .integrators import LangevinCarry
from .ops.lj_cull import TilePairList
from .ops.lj_dense import box_diagonal
from .parallel.spatial import SpatialBandCarry, SpatialCarry
from .potential import LJPotential
from .runtime import BandCarry, CullCarry, CullNPTCarry, NPTCarry, StripCarry
from .topology import Topology


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def _f32(a, device):
    return _t(a, np.float32, device).reshape(())


def _i32(a, device):
    return _t(a, np.int32, device).reshape(())


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def lj_system(sigma: float, epsilon: float, cutoff: float, masses):
    """(LJPotential, Topology) from MD-unit floats and per-particle masses."""
    topology = Topology.from_masses(np.asarray(masses, dtype=np.float64))
    potential = LJPotential(
        topology,
        sigma=sigma * units.nanometer,
        epsilon=epsilon * units.kilojoule_per_mole,
        cutoff=cutoff * units.nanometer,
    )
    return potential, topology


def langevin_carry(x, v, F, box, device, seed: int = 0) -> LangevinCarry:
    """A ``LangevinCarry`` from (3, n_pad) arrays and a box (``box_diagonal``
    takes a (3, 3) box or 3 lengths); ``seed`` seeds the generator that
    ``FastLJRunner.run`` draws its noise from."""
    return LangevinCarry(
        x=_t(x, np.float32, device), v=_t(v, np.float32, device),
        F=_t(F, np.float32, device), box_vectors=box_diagonal(box, device),
        overflowed=torch.zeros((), dtype=torch.bool, device=device),
        generator=_generator(device, seed),
    )


def tile_pair_list(rows, cols, ccx, ptr2, rowcx, count, overflowed,
                   device) -> TilePairList:
    return TilePairList(
        rows=_t(rows, np.int32, device).reshape(1, -1),
        cols=_t(cols, np.int32, device).reshape(1, -1),
        ccx=_t(ccx, np.float32, device).reshape(1, -1),
        ptr2=_t(ptr2, np.int32, device).reshape(1, -1),
        rowcx=_t(rowcx, np.float32, device).reshape(1, -1),
        count=_t(count, np.int32, device).reshape(1, 1),
        overflowed=_t(overflowed, np.bool_, device).reshape(()),
    )


def cull_carry(x, v, F, step, box, overflowed, pairs: dict, x_anchor,
               device) -> CullCarry:
    """A ``CullCarry`` from arrays; ``pairs`` maps the ``TilePairList``
    field names to arrays."""
    return CullCarry(
        x=_t(x, np.float32, device), v=_t(v, np.float32, device),
        F=_t(F, np.float32, device),
        step=_t(step, np.int32, device).reshape(1, 1),
        box_diag=box_diagonal(box, device),
        overflowed=_t(overflowed, np.bool_, device).reshape(()),
        pairs=tile_pair_list(device=device, **pairs),
        x_anchor=_t(x_anchor, np.float32, device),
    )


def cull_npt_carry(x, v, F, U, step, box, overflowed, pairs: dict, x_anchor,
                   scale_used, eval_peak, s_total, s_min_frame, vmax_scale,
                   n_accepted, n_proposed, device,
                   seed: int = 0) -> CullNPTCarry:
    """A ``CullNPTCarry`` from arrays in the JAX carry's layout; ``seed``
    seeds the generator that takes the place of the JAX key."""
    return CullNPTCarry(
        x=_t(x, np.float32, device), v=_t(v, np.float32, device),
        F=_t(F, np.float32, device), U=_f32(U, device),
        step=_t(step, np.int32, device).reshape(1, 1),
        box_diag=box_diagonal(box, device),
        overflowed=_t(overflowed, np.bool_, device).reshape(()),
        pairs=tile_pair_list(device=device, **pairs),
        x_anchor=_t(x_anchor, np.float32, device),
        scale_used=_f32(scale_used, device),
        eval_peak=_f32(eval_peak, device), s_total=_f32(s_total, device),
        s_min_frame=_f32(s_min_frame, device),
        generator=_generator(device, seed),
        vmax_scale=_f32(vmax_scale, device),
        n_accepted=_i32(n_accepted, device),
        n_proposed=_i32(n_proposed, device),
    )


def npt_carry(x, v, F, U, box, vmax_scale, n_accepted, n_proposed, step,
              device, seed: int = 0) -> NPTCarry:
    """An ``NPTCarry`` (dense NpT runner) from arrays in the JAX layout."""
    return NPTCarry(
        x=_t(x, np.float32, device), v=_t(v, np.float32, device),
        F=_t(F, np.float32, device),
        U=_f32(U, device), generator=_generator(device, seed),
        box_diag=box_diagonal(box, device),
        vmax_scale=_f32(vmax_scale, device),
        n_accepted=_i32(n_accepted, device),
        n_proposed=_i32(n_proposed, device),
        step=int(step),
    )


def band_carry(x, v, F, ref_x, box, overflowed, device,
               seed: int = 0) -> BandCarry:
    """A ``BandCarry`` from arrays in the JAX carry's layout; ``seed``
    seeds the generator that takes the place of the JAX key."""
    return BandCarry(
        x=_t(x, np.float32, device), v=_t(v, np.float32, device),
        F=_t(F, np.float32, device), ref_x=_t(ref_x, np.float32, device),
        box_diag=box_diagonal(box, device),
        overflowed=_t(overflowed, np.bool_, device).reshape(()),
        generator=_generator(device, seed),
    )


def _host_int(a) -> int:
    return int(np.asarray(a).reshape(-1)[0])


def spatial_carry(carry, device, seed: int = 0) -> SpatialCarry:
    """A ``SpatialCarry`` from a carry whose fields ``x``, ``v``, ``F``,
    ``step`` and ``box_diag`` hold arrays in the JAX layout (a JAX
    ``SpatialCarry`` as it is: numpy reads its arrays); ``seed`` seeds the
    generator that takes the place of the JAX key."""
    return SpatialCarry(
        x=_t(carry.x, np.float32, device), v=_t(carry.v, np.float32, device),
        F=_t(carry.F, np.float32, device), step=_host_int(carry.step),
        box_diag=box_diagonal(np.asarray(carry.box_diag), device),
        generator=_generator(device, seed),
    )


def spatial_band_carry(carry, device, seed: int = 0) -> SpatialBandCarry:
    """A ``SpatialBandCarry`` from a carry with the fields of the JAX
    ``SpatialBandCarry`` (``x``, ``v``, ``F``, ``step``, ``box_diag``,
    ``overflowed``), as ``spatial_carry``."""
    return SpatialBandCarry(
        x=_t(carry.x, np.float32, device), v=_t(carry.v, np.float32, device),
        F=_t(carry.F, np.float32, device), step=_host_int(carry.step),
        box_diag=box_diagonal(np.asarray(carry.box_diag), device),
        generator=_generator(device, seed),
        overflowed=_t(carry.overflowed, np.bool_, device).reshape(()),
    )


def strip_carry(x, v, F, step, box, overflowed, device) -> StripCarry:
    """A ``StripCarry`` from arrays in the JAX carry's layout (``x`` the
    (3, n_pad + H) extended positions)."""
    return StripCarry(
        x=_t(x, np.float32, device), v=_t(v, np.float32, device),
        F=_t(F, np.float32, device),
        step=_t(step, np.int32, device).reshape(1, 1),
        box_diag=box_diagonal(box, device),
        overflowed=_t(overflowed, np.bool_, device).reshape(()),
    )
