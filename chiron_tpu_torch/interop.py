"""Carry state into the port from plain numpy arrays and floats.

A caller that holds a state of the JAX package (or of anything else) turns
its arrays into numpy and hands them here: this module imports no jax.  The
layouts are the JAX package's: (3, n_pad) f32 lanes, a (1, 3) box
diagonal, and the tile-pair list's (1, capacity) rows for the runners;
(N, 3) positions, a (3, 3) box and the pair schemes' own arrays for the
general API.  A JAX PRNG key has no counterpart (``utils``): the general
API's converters take an integer key, and so does the loader of a sampler
checkpoint that the JAX package wrote (``sampler_state_from_checkpoint``).
``pt_state`` sets a ``ParallelTemperingSampler`` from the replica arrays of
JAX's sampler and R integer keys.
"""

from __future__ import annotations

import numpy as np
import torch

from . import units
from .checkpoint import load_checkpoint, load_sampler_checkpoint
from .integrators import LangevinCarry
from .mcmc import MCCarry
from .neighbors import DensePairsState, NeighborListState, PairListState
from .ops.lj_cull import TilePairList
from .ops.lj_dense import box_diagonal
from .parallel.spatial import SpatialBandCarry, SpatialCarry
from .potential import LJPotential
from .runtime import BandCarry, CullCarry, CullNPTCarry, NPTCarry, StripCarry
from .states import SamplerState
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
    field names to arrays.  The list and its anchor pass as they are, so a
    run continues the JAX run's list cadence: ``step`` is read once here,
    into the host's copy that the cadence reads."""
    return CullCarry(
        x=_t(x, np.float32, device), v=_t(v, np.float32, device),
        F=_t(F, np.float32, device),
        step=_t(step, np.int32, device).reshape(1, 1),
        box_diag=box_diagonal(box, device),
        overflowed=_t(overflowed, np.bool_, device).reshape(()),
        pairs=tile_pair_list(device=device, **pairs),
        x_anchor=_t(x_anchor, np.float32, device),
    ).note_step(int(np.asarray(step).reshape(-1)[0]))


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


def _box(box, device):
    return None if box is None else _t(box, np.float32, device)


def neighbor_list_state(neighbor_list, neighbor_mask, n_neighbors,
                        ref_positions, box_vectors, overflow,
                        device) -> NeighborListState:
    """A ``NeighborListState`` from the JAX state's arrays."""
    return NeighborListState(
        neighbor_list=_t(neighbor_list, np.int32, device),
        neighbor_mask=_t(neighbor_mask, np.int32, device),
        n_neighbors=_t(n_neighbors, np.int32, device),
        ref_positions=_t(ref_positions, np.float32, device),
        box_vectors=_box(box_vectors, device),
        overflow=_t(overflow, np.bool_, device).reshape(()),
    )


def pair_list_state(all_pairs, reduction_mask, box_vectors,
                    device) -> PairListState:
    """A ``PairListState`` from the JAX state's arrays."""
    return PairListState(
        all_pairs=_t(all_pairs, np.int32, device),
        reduction_mask=_t(reduction_mask, np.bool_, device),
        box_vectors=_box(box_vectors, device),
    )


def dense_pairs_state(box_vectors, device) -> DensePairsState:
    return DensePairsState(box_vectors=_box(box_vectors, device))


def sampler_state(positions, key: int, velocities, box_vectors,
                  device) -> SamplerState:
    """A ``SamplerState`` from MD-unit arrays (nm, nm/ps) and an integer
    key, on ``device``."""
    nm = units.nanometer
    return SamplerState(
        positions=units.Quantity(np.array(positions, np.float32), nm),
        current_PRNG_key=key,
        velocities=(None if velocities is None else units.Quantity(
            np.array(velocities, np.float32), nm / units.picosecond)),
        box_vectors=(None if box_vectors is None else units.Quantity(
            np.array(box_vectors, np.float32), nm)),
        device=device,
    )


def general_langevin_carry(x, v, F, box_vectors, overflowed, key: int,
                           nbr_state, device) -> LangevinCarry:
    """A general-API ``LangevinCarry`` from (N, 3) arrays, a (3, 3) box (or
    None), an integer key and a pair state made by the converters above
    (or None)."""
    return LangevinCarry(
        x=_t(x, np.float32, device), v=_t(v, np.float32, device),
        F=_t(F, np.float32, device), box_vectors=_box(box_vectors, device),
        overflowed=_t(overflowed, np.bool_, device).reshape(()),
        key=key, nbr_state=nbr_state,
    )


def mc_carry(positions, box_vectors, key: int, reduced_potential, list_state,
             n_accepted, n_proposed, param, overflowed,
             device) -> MCCarry:
    """An ``MCCarry`` from the JAX carry's arrays (numpy reads them), an
    integer key and a pair state made by the converters above (or None)."""
    return MCCarry(
        positions=_t(positions, np.float32, device),
        box_vectors=_box(box_vectors, device),
        key=key,
        reduced_potential=_f32(reduced_potential, device),
        list_state=list_state,
        n_accepted=_i32(n_accepted, device),
        n_proposed=_i32(n_proposed, device),
        param=_f32(param, device),
        overflowed=_t(overflowed, np.bool_, device).reshape(()),
    )


def sampler_state_from_checkpoint(path, key: int, device, moves=None):
    """``(SamplerState, metadata)`` from a sampler checkpoint written by
    ``save_sampler_checkpoint`` of either package, on ``device``.

    The positions, velocities, box, iteration and move statistics (into
    ``moves``, a ``{name: move}`` mapping) carry over; the PRNG key is
    ``key``, since a JAX checkpoint's threefry key has no counterpart here.
    """
    leaves, meta = load_checkpoint(path)
    if "fields" not in meta:
        raise ValueError(
            f"{path}: no field header; load it into a SamplerState made to "
            "match with checkpoint.load_sampler_checkpoint")
    state = sampler_state(leaves[0], key, None, None, device)
    meta = load_sampler_checkpoint(path, state, moves=moves, key=key)
    return state, meta


def pt_state(sampler, positions, velocities, kTs, box, keys):
    """Set an initialized ``ParallelTemperingSampler`` from the JAX
    sampler's replica arrays (numpy) and R integer keys.

    ``positions`` and ``velocities`` are (R, 3, n_pad) in the dense chain's
    lane layout or (R, N, 3) (turned into lanes for the dense chain);
    ``kTs`` the (R,) ladder; ``box`` JAX's ``box_vectors``: (R, 1, 3)
    diagonals for the dense chain, (R, 3, 3), or None.  Each process takes
    its own block of the replicas.  The Verlet lists are rebuilt from the
    positions.
    """
    R = sampler.n_replicas
    loc = sampler._local
    dev = sampler.device
    op = sampler._dense_op

    def lanes(a):
        a = np.asarray(a, dtype=np.float32)
        if op is not None and a.shape[1:] != (3, op.n_pad):
            out = np.zeros((a.shape[0], 3, op.n_pad), np.float32)
            out[:, :, :op.n] = np.transpose(a, (0, 2, 1))
            a = out
        if a.shape[0] != R:
            raise ValueError(f"{a.shape[0]} replicas given, the sampler "
                             f"has {R}")
        return _t(a[loc], np.float32, dev).contiguous()

    sampler.positions = lanes(positions)
    sampler.velocities = lanes(velocities)
    sampler.kTs = np.asarray(kTs, dtype=np.float32).copy()
    if len(keys) != R:
        raise ValueError(f"{len(keys)} keys for {R} replicas")
    sampler.keys = [int(k) for k in keys]
    if box is not None and sampler.box_vectors is not None:
        b = np.asarray(box, dtype=np.float32)
        if op is not None and b.shape[1:] == (3, 3):
            b = np.diagonal(b, axis1=1, axis2=2)[:, None, :]
        sampler.box_vectors = _t(b.reshape(
            (R,) + tuple(sampler.box_vectors.shape[1:]))[loc], np.float32,
            dev).contiguous()
    if isinstance(sampler.list_state, list):
        sampler._rebuild_lists()
    return sampler
