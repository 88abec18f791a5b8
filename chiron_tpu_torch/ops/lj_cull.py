"""Culled tile-pair LJ engine (port of ``chiron_tpu/ops/lj_cull.py``).

Two layers, as in the JAX package:

* the list layer in plain PyTorch: the spatial sort key, the stable sort,
  per-tile bounding boxes and the capacity-padded tile-pair Verlet list
  (``build_tile_pairs``), all device-side with no host synchronisation;
* the engine: ``CulledLJMD.run_segment`` advances S BAOAB steps on a fixed
  list (K3, the fused TPU kernel ``culled_md_raw``).  On a CUDA tensor it
  is one call of ``chiron_cull_md_segment`` (``csrc/lj_cull_force.cu``),
  counted as ``culled_md``, which enqueues the whole segment on the current
  stream: the BAOAB kernel once (``csrc/baoab.cu``), each step's culled
  force pass, whose gather applies the next step's BAOAB update in its
  epilogue, and the drift latch (``csrc/drift.cu``), each counted under its
  own name; the force pass alone replaces ``culled_force_raw`` (K4).  Its
  scratch comes from a ``SegmentWorkspace`` the runners hold across
  segments.  On a CPU tensor, and in ``run_segment_stepwise`` on either
  device, the segment is a Python loop of the wrappers ``baoab_phase_``,
  ``culled_force_pass`` and ``tile_skin_drift_bad``, each of which runs its
  plain version (``baoab_phase_plain``, ``row_force_pass_plain``,
  ``tile_skin_drift_bad_plain``) on a CPU tensor.

The step counter, the list and the latch stay on the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..profiling import cull_work, spanned
from . import _build
from .diff import energy_with_force_gradient

_TWO_PI = 6.2831853071795864
_MASK32 = 0xFFFFFFFF


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Spatial sort + tile bboxes + tile-pair list
# ---------------------------------------------------------------------------


def slab_y_key(pos3, n: int, nslab, L, Ly=None):
    """Monotone spatial sort key (``lj_cull.py:61``).

    ``nslab == 0``: pure x.  ``nslab >= 1``: (x-slab, y) lexicographic with
    the slab separation scaled by the y box length.  Padding columns get a
    3e38 sentinel so that they stay at the end.  ``L`` and ``Ly`` may be
    floats or 0-dim f32 tensors, as the caller has them.  ``pos3`` may hold
    a batch, (3, ..., n_pad), with ``nslab`` (a tensor of counts, each at
    least 1), ``L`` and ``Ly`` broadcasting against one of its rows: the
    dense tempering chain's replicas, whose slab counts stay on the device.
    """
    n_pad = pos3.shape[-1]
    if not torch.is_tensor(nslab) and nslab == 0:
        key = pos3[0]
    else:
        if Ly is None:
            Ly = L
        slab_w = L / nslab
        slab = torch.floor(pos3[0] / slab_w)
        if torch.is_tensor(nslab):
            slab = torch.minimum(torch.clamp_min(slab, 0), nslab - 1)
        else:
            slab = torch.clamp(slab, 0, nslab - 1)
        key = slab * (2.0 * Ly) + pos3[1]
    live = torch.arange(n_pad, device=pos3.device) < n
    return torch.where(live, key, 3.0e38)


def sort_by_key(key, pos3, payloads: Tuple[torch.Tensor, ...]):
    """Stable sort of the (3, n_pad) layout and each payload (last axis
    n_pad) by ``key``; ties keep their order, as ``jax.lax.sort`` does."""
    perm = torch.sort(key, stable=True).indices
    return pos3[:, perm], tuple(p[..., perm] for p in payloads)


def tile_bboxes(pos3, n: int, tile: int, box_diag):
    """Circular per-tile bounding boxes: (centers, halves), each (3, n_tiles),
    from min-imaged offsets to each tile's first particle."""
    n_pad = pos3.shape[1]
    n_tiles = n_pad // tile
    L = box_diag.reshape(3, 1, 1)
    p = pos3.reshape(3, n_tiles, tile)
    ref = p[:, :, :1]
    d = p - ref
    d = d - L * torch.round(d / L)
    lo = torch.amin(d, dim=2)
    hi = torch.amax(d, dim=2)
    centers = ref[:, :, 0] + 0.5 * (lo + hi)
    halves = 0.5 * (hi - lo)
    return centers, halves


class TilePairList(NamedTuple):
    """Capacity-padded tile-pair Verlet list (all fields device tensors).

    Entries are sorted by (row tile, general-before-fast, col tile); row
    i's general entries are [ptr2[2i], ptr2[2i+1]) and its fast entries
    [ptr2[2i+1], ptr2[2i+2]).  ``ccx`` is the col tile's x-center shifted by
    the pair's periodic image, ``rowcx`` the row tile's x-center.
    """

    rows: torch.Tensor      # (1, capacity) int32 row-tile index
    cols: torch.Tensor      # (1, capacity) int32 col-tile index
    ccx: torch.Tensor       # (1, capacity) f32 image-shifted col x-center
    ptr2: torch.Tensor      # (1, 2*nr+1) int32 segment boundaries
    rowcx: torch.Tensor     # (1, nr) f32 row bbox x-centers
    count: torch.Tensor     # (1, 1) int32 live entries
    overflowed: torch.Tensor  # () bool: capacity exceeded or shift bound broken


class _TileGeometry(NamedTuple):
    keep: torch.Tensor   # (nr, nc) bool: the rectangles the list holds
    hsum: torch.Tensor   # (3, nr, nc) summed bbox half-widths
    rcen: torch.Tensor   # (3, nr) row tile centers
    ccen: torch.Tensor   # (3, nc) col tile centers


def _tile_geometry(pos3, n: int, tm: int, tn: int, box_diag, reach: float):
    """The kept-rectangle selection shared by ``build_tile_pairs`` and
    ``tile_frame_scale_floor``: rectangles whose bbox min-image distance is
    under ``reach`` and that can hold a pair with col rank > row rank."""
    dev = pos3.device
    n_pad = pos3.shape[1]
    pad_mask = torch.arange(n_pad, device=dev) < n
    pos3 = torch.where(pad_mask, pos3, pos3[:, n - 1:n])
    nr, nc = n_pad // tm, n_pad // tn
    rcen, rhal = tile_bboxes(pos3, n, tm, box_diag)
    ccen, chal = tile_bboxes(pos3, n, tn, box_diag)
    L = box_diag.reshape(3, 1, 1)
    dc = rcen[:, :, None] - ccen[:, None, :]
    dc = dc - L * torch.round(dc / L)
    hsum = rhal[:, :, None] + chal[:, None, :]
    dmin = torch.clamp_min(torch.abs(dc) - hsum, 0.0)
    d2 = dmin * dmin
    near = (d2[0] + d2[1] + d2[2]) < reach * reach
    ri = torch.arange(nr, device=dev)[:, None]
    ci = torch.arange(nc, device=dev)[None, :]
    useful = (ci * tn + (tn - 1) > ri * tm) & (ri * tm < n) & (ci * tn < n)
    return _TileGeometry(near & useful, hsum, rcen, ccen)


def build_tile_pairs(pos3, n: int, tm: int, tn: int, box_diag, cutoff: float,
                     slack: float, capacity: int) -> TilePairList:
    """Build the tile-pair list from current positions (``lj_cull.py:144``).

    Keeps the rectangles of ``_tile_geometry`` at reach cutoff + slack.  The
    ordered placement is a scatter into capacity + 1 slots, the last of
    which takes the dropped entries and is cut off; it gives the arrays the
    JAX package's one-hot placement gives.
    """
    dev = pos3.device
    n_pad = pos3.shape[1]
    box_diag = box_diag.reshape(3)
    nr, nc = n_pad // tm, n_pad // tn
    keep, hsum, rcen, ccen = _tile_geometry(pos3, n, tm, tn, box_diag,
                                            cutoff + slack)
    ri = torch.arange(nr, device=dev)[:, None]
    ci = torch.arange(nc, device=dev)[None, :]
    dcx_raw = rcen[0][:, None] - ccen[0][None, :]
    Lx = box_diag[0]
    ccx_sh = ccen[0][None, :] + torch.round(dcx_raw / Lx) * Lx
    bound_x = 0.5 * Lx - cutoff - slack
    shift_bad = torch.any(keep & (hsum[0] > bound_x))

    last_real_col = (n - 1) // tn
    last_real_row = (n - 1) // tm
    general = (
        (ci * tn < ri * tm + tm)
        | (ci >= last_real_col)
        | (ri >= last_real_row)
    )
    kg = keep & general
    kf = keep & ~general
    seg = torch.stack([kg.sum(dim=1), kf.sum(dim=1)], dim=1).reshape(-1)
    ptr2 = torch.cat([torch.zeros(1, dtype=seg.dtype, device=dev),
                      torch.cumsum(seg, dim=0)])
    total = ptr2[-1]
    gen_rank = torch.cumsum(kg, dim=1) - 1
    fast_rank = torch.cumsum(kf, dim=1) - 1
    base_gen = ptr2[0:2 * nr:2][:, None]
    base_fast = ptr2[1:2 * nr:2][:, None]
    slot = torch.where(kg, base_gen + gen_rank, base_fast + fast_rank)
    slot = torch.where(keep & (slot < capacity), slot, capacity).reshape(-1)

    def place(vals, dtype):
        buf = torch.zeros(capacity + 1, dtype=dtype, device=dev)
        buf[slot] = vals.expand(nr, nc).reshape(-1).to(dtype)
        return buf[:capacity].reshape(1, capacity)

    return TilePairList(
        rows=place(ri, torch.int32),
        cols=place(ci, torch.int32),
        ccx=place(ccx_sh, torch.float32),
        ptr2=torch.clamp_max(ptr2, capacity).to(torch.int32).reshape(1, -1),
        rowcx=rcen[0].reshape(1, -1).contiguous(),
        count=torch.clamp_max(total, capacity).to(torch.int32).reshape(1, 1),
        overflowed=(total > capacity) | shift_bad,
    )


def tile_frame_scale_floor(pos3, n: int, tm: int, tn: int, box_diag,
                           cutoff: float, slack: float):
    """The least cumulative isotropic box scale the current layout's
    constant-x-frame convention admits (``lj_cull.py:265``): () f32.

    Under a rescale by ``s`` the build's bound ``hsum_x <= 0.5 Lx - reach``
    becomes ``s hsum_x <= 0.5 s Lx - reach``, so ``s >= reach / (0.5 Lx -
    hx_max)`` over the kept rectangles; ``+inf`` where the layout is
    already frame-invalid (``0.5 Lx - hx_max <= 0``), which rejects every
    shrink.  The NpT runner computes it at each rebuild.
    """
    box_diag = box_diag.reshape(3)
    reach = cutoff + slack
    keep, hsum, _, _ = _tile_geometry(pos3, n, tm, tn, box_diag, reach)
    hx_max = torch.max(torch.where(keep, hsum[0], 0.0))
    denom = 0.5 * box_diag[0] - hx_max
    return torch.where(denom > 0.0, reach / denom, math.inf)


# ---------------------------------------------------------------------------
# Force pass (K4, K5, and K3's force phase)
# ---------------------------------------------------------------------------


def row_force_pass_plain(x3, box_diag, pairs: TilePairList, n: int, tm: int,
                         tn: int, sigma: float, epsilon: float, cutoff: float,
                         with_energy: bool = False):
    """Plain version of the culled force pass (``_row_force_pass``).

    Evaluates every live entry's (tm, tn) rectangle at once with the
    kernel's semantics (sigma-prescaled coordinates, x folded into the
    entry frame, y/z minimum image by trunc(2d/L), the general-entry rank
    mask and r^2 clamp).  The reciprocal is the exact division (the kernel's
    approximate one is held to its exact one on the card).  Positions must
    be wrapped into [0, L).  Returns ((3, n_pad) force, energy or None).
    """
    dev = x3.device
    n_pad = x3.shape[1]
    box = box_diag.reshape(3)
    Lx, Ly, Lz = box[0], box[1], box[2]
    iLx, iLy, iLz = 1.0 / Lx, 1.0 / Ly, 1.0 / Lz
    inv_sigma = 1.0 / sigma
    Lys, Lzs = Ly * inv_sigma, Lz * inv_sigma
    two_inv_Lys = (2.0 * iLy) * (1.0 / inv_sigma)
    two_inv_Lzs = (2.0 * iLz) * (1.0 / inv_sigma)
    cutoff2_s = (cutoff / sigma) ** 2

    count = int(pairs.count.reshape(-1)[0])
    rows = pairs.rows[0, :count].long()
    cols = pairs.cols[0, :count].long()
    ccx = pairs.ccx[0, :count]
    ptr2 = pairs.ptr2[0].long()
    general = (torch.arange(count, device=dev) < ptr2[2 * rows + 1])[:, None, None]
    rid = rows[:, None] * tm + torch.arange(tm, device=dev)       # (K, tm)
    cid = cols[:, None] * tn + torch.arange(tn, device=dev)       # (K, tn)
    rcx = pairs.rowcx[0][rows][:, None]
    xi = x3[0][rid]
    xi = (xi - Lx * torch.floor((xi - rcx) * iLx + 0.5)) * inv_sigma
    yi = x3[1][rid] * inv_sigma
    zi = x3[2][rid] * inv_sigma
    xj = x3[0][cid]
    xj = (xj - Lx * torch.floor((xj - ccx[:, None]) * iLx + 0.5)) * inv_sigma
    yj = x3[1][cid] * inv_sigma
    zj = x3[2][cid] * inv_sigma

    dx = xi[:, :, None] - xj[:, None, :]
    dy = yi[:, :, None] - yj[:, None, :]
    dy = dy - Lys * torch.trunc(dy * two_inv_Lys)
    dz = zi[:, :, None] - zj[:, None, :]
    dz = dz - Lzs * torch.trunc(dz * two_inv_Lzs)
    r2 = dx * dx + dy * dy + dz * dz
    rank_ok = (cid[:, None, :] > rid[:, :, None]) & (cid[:, None, :] < n)
    m = (r2 < cutoff2_s) & (rank_ok | ~general)
    r2s = torch.where(general, torch.clamp_min(r2, 1e-4), r2)
    inv = 1.0 / r2s
    i6 = inv * inv * inv
    zero = torch.zeros((), dtype=x3.dtype, device=dev)
    coef = torch.where(m, (i6 - 0.5) * i6 * inv, zero)

    F = torch.zeros((3, n_pad), dtype=x3.dtype, device=dev)
    for a, d in enumerate((dx, dy, dz)):
        t = coef * d
        F[a].index_add_(0, rid.reshape(-1), t.sum(dim=2).reshape(-1))
        F[a].index_add_(0, cid.reshape(-1), -t.sum(dim=1).reshape(-1))
    F = (48.0 * epsilon / sigma) * F
    if not with_energy:
        return F, None
    e = torch.where(m, (i6 - 1.0) * i6, zero)
    return F, (4.0 * epsilon) * torch.sum(e, dtype=torch.float64).to(x3.dtype)


# The kernel's work items (csrc/lj_cull_force.cu): entry k's column tile is
# cut into slices of CULL_SLICE columns and its row tile into chunks of
# row_chunk(tm) rows, and block (k S + s) C + c takes slice s of entry
# k against chunk c of the entry's row tile.
CULL_SLICE = 64
# the row tiles below 128 the kernel takes; above, every multiple of 128
CULL_SMALL_TM = (16, 32, 64)


def cull_slices(tn: int):
    """The (first column, width) of each column slice of a tile of ``tn``
    columns, in slot order."""
    return [(c0, min(CULL_SLICE, tn - c0)) for c0 in range(0, tn, CULL_SLICE)]


def row_chunk(tm: int) -> int:
    """The rows of a row tile of ``tm`` that one block of the culled and
    band passes takes (``csrc/common.cuh`` ``row_chunk``): the whole tile up
    to 256, else 256 where they divide it, else 128, so that a block's
    registers and shared memory stay those of tm = 256 whatever the
    tile."""
    return tm if tm <= 256 else (256 if tm % 256 == 0 else 128)


def cull_buffers(n_pad: int, tm: int, tn: int, capacity: int,
                 with_energy: bool, device):
    """Outputs and scratch of the culled pass at this capacity, with S
    column slices and C = tm / ``row_chunk(tm)`` row chunks an entry:
    the (3, n_pad) force, the row partials (capacity S, 3, tm), the column
    partials (capacity C, 3, tn), the energy partials (capacity S C,) and
    the (1,) energy or None."""
    S = len(cull_slices(tn))
    C = tm // row_chunk(tm)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((3, n_pad), **f32),
            torch.empty((capacity * S, 3, tm), **f32),
            torch.empty((capacity * C, 3, tn), **f32),
            torch.empty(capacity * S * C, **f32),
            torch.empty(1, **f32) if with_energy else None)


def check_cull_tiles(n_pad: int, tm: int, tn: int):
    if (not (tm in CULL_SMALL_TM or (tm > 0 and tm % 128 == 0)) or tn <= 0
            or tn % 16 or n_pad % tm or n_pad % tn):
        raise ValueError(
            f"culled force kernel takes tm in {CULL_SMALL_TM} or a multiple "
            f"of 128, tn a multiple of 16, both dividing n_pad (got tm={tm}, "
            f"tn={tn}, n_pad={n_pad})"
        )


def _check_cull_inputs(x3, box_diag, pairs: TilePairList, tm: int, tn: int):
    """Raise unless ``x3``, the box and the list are what the culled kernels
    take.  Returns the list's capacity."""
    _build.check_cuda(x3, "x3")
    dev = x3.device
    n_pad = x3.shape[1]
    nr = n_pad // tm
    capacity = pairs.cols.shape[1]
    _build.require(x3, "x3", (3, n_pad), torch.float32)
    _build.require(box_diag, "box_diag", None, torch.float32, dev)
    for name, dtype, shape in (
        ("rows", torch.int32, (1, capacity)),
        ("cols", torch.int32, (1, capacity)),
        ("ccx", torch.float32, (1, capacity)),
        ("ptr2", torch.int32, (1, 2 * nr + 1)),
        ("rowcx", torch.float32, (1, nr)),
        ("count", torch.int32, (1, 1)),
    ):
        _build.require(getattr(pairs, name), f"pairs.{name}", shape, dtype, dev)
    check_cull_tiles(n_pad, tm, tn)
    if box_diag.numel() != 3:
        raise ValueError("culled force kernel takes 3 box lengths")
    return capacity


def list_pointers(pairs: TilePairList, with_overflow: bool = True):
    """The list arrays' device pointers in the kernels' order (rows, cols,
    ccx, ptr2, rowcx, count), then the overflow flag that a build writes."""
    names = ("rows", "cols", "ccx", "ptr2", "rowcx", "count")
    if with_overflow:
        names += ("overflowed",)
    return tuple(getattr(pairs, name).data_ptr() for name in names)


def _cull_force_launch(kernel: str, x3, box_diag, pairs: TilePairList, n: int,
                       tm: int, tn: int, sigma: float, epsilon: float,
                       cutoff: float, approx_recip: bool, with_energy: bool):
    """Check the inputs and launch ``csrc/lj_cull_force.cu``, counted under
    ``kernel``.  Returns ((3, n_pad) force, () energy or None)."""
    capacity = _check_cull_inputs(x3, box_diag, pairs, tm, tn)
    n_pad = x3.shape[1]
    F, P, R, e_part, energy = cull_buffers(n_pad, tm, tn, capacity,
                                           with_energy, x3.device)
    inv_sigma = 1.0 / sigma
    work = cull_work(x3.device)
    _build.launch(
        kernel, "chiron_cull_force",
        x3.data_ptr(), box_diag.data_ptr(), *list_pointers(pairs, False),
        P.data_ptr(), R.data_ptr(), e_part.data_ptr(), F.data_ptr(),
        None if energy is None else energy.data_ptr(),
        n, n_pad, tm, tn, capacity, inv_sigma, 1.0 / inv_sigma,
        (cutoff / sigma) ** 2, 48.0 * epsilon / sigma, 4.0 * epsilon,
        int(approx_recip), None if work is None else work.data_ptr(),
        _build.stream_of(x3),
    )
    return F, (energy[0] if with_energy else None)


def culled_force_pass(x3, box_diag, pairs: TilePairList, n: int, tm: int,
                      tn: int, sigma: float, epsilon: float, cutoff: float,
                      approx_recip: bool = True, with_energy: bool = False):
    """Culled LJ force of wrapped positions ``x3`` over the tile-pair list
    (K4, and K3's force phase).

    Returns ((3, n_pad) force, energy or None).  On a CUDA tensor this
    launches ``csrc/lj_cull_force.cu``; ``with_energy`` (K3's
    ``final_energy`` step) also sums the total truncated-LJ energy of the
    listed pairs, always with the exact reciprocal, while the force takes
    ``approx_recip``'s: that energy equals ``culled_force_energy``'s bit for
    bit.
    """
    if x3.device.type == "cpu":
        return row_force_pass_plain(x3, box_diag, pairs, n, tm, tn, sigma,
                                    epsilon, cutoff, with_energy)
    return _cull_force_launch("culled_force", x3, box_diag, pairs, n, tm, tn,
                              sigma, epsilon, cutoff, approx_recip,
                              with_energy)


def culled_force_energy(x3, box_diag, pairs: TilePairList, n: int, tm: int,
                        tn: int, sigma: float, epsilon: float, cutoff: float):
    """K5 (``culled_force_energy_raw``): culled force and () total
    truncated-LJ energy in one pass, with the exact reciprocal.

    On a CUDA tensor this launches ``csrc/lj_cull_force.cu`` with the
    energy flag, counted as ``culled_force_energy``; on a CPU tensor it
    runs ``row_force_pass_plain(with_energy=True)``.
    """
    if x3.device.type == "cpu":
        return row_force_pass_plain(x3, box_diag, pairs, n, tm, tn, sigma,
                                    epsilon, cutoff, with_energy=True)
    return _cull_force_launch("culled_force_energy", x3, box_diag, pairs, n,
                              tm, tn, sigma, epsilon, cutoff, False, True)


# ---------------------------------------------------------------------------
# BAOAB phase (K3) and its noise stream
# ---------------------------------------------------------------------------


def _mul32(z, k: int):
    """(z * k) mod 2^32 for int64 z in [0, 2^32) without int64 overflow."""
    lo = z * (k & 0xFFFF)
    hi = ((z * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(z):
    z = z ^ (z >> 16)
    z = _mul32(z, 0x85EBCA6B)
    z = z ^ (z >> 13)
    z = _mul32(z, 0xC2B2AE35)
    return z ^ (z >> 16)


def lane_counters(seed, step, shape, device="cpu"):
    """The two splitmix32 counters, 2 lane and 2 lane + 1, of every lane of
    ``shape`` (numbered in row-major order) at ``step``, as int64 tensors
    holding uint32 values (the JAX MD kernels' noise stream).  ``seed`` and
    ``step`` are ints, or int64 tensors on ``device`` whose broadcast shape B
    leads the counters' shape: (*B, *shape), one stream for each entry."""
    lane = torch.arange(shape[0] * shape[1], dtype=torch.int64,
                        device=device).reshape(shape)
    base = (_mul32(seed & _MASK32, 0x9E3779B9)
            + _mul32(step & _MASK32, 0x85EBCA6B)) & _MASK32
    if torch.is_tensor(base):
        base = base.reshape(base.shape + (1,) * len(shape))
    c1 = ((lane * 2) * 0x9E3779B9 + base) & _MASK32
    c2 = ((lane * 2 + 1) * 0x9E3779B9 + base) & _MASK32
    return c1, c2


def counter_uniforms(c1, c2):
    """The f32 uniform pair (mix >> 8) 2^-24 of the counters, u1 clamped at
    1e-7 for the log."""
    scale = 1.0 / 16777216.0
    u1 = (_mix32(c1) >> 8).to(torch.int32).to(torch.float32) * scale
    u2 = (_mix32(c2) >> 8).to(torch.int32).to(torch.float32) * scale
    return torch.clamp_min(u1, 1e-7), u2


def splitmix_counters(seed: int, step: int, n_pad: int, device="cpu"):
    """The counters of every (3, n_pad/2) lane (``_baoab_phase``'s stream)."""
    return lane_counters(seed, step, (3, n_pad // 2), device)


def splitmix_noise_plain(seed, step, n_pad: int, device="cpu", rows: int = 3):
    """The (rows, n_pad) standard-normal O-step noise of one step: two-output
    Box-Muller on half the lanes (cos half | sin half of each row).  Tensor
    ``seed`` and ``step`` lead the result with their broadcast shape, as in
    ``lane_counters``."""
    u1, u2 = counter_uniforms(*lane_counters(seed, step, (rows, n_pad // 2),
                                             device))
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI * u2
    return torch.cat([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def baoab_phase_plain(x, w, F, minv, sigv, box_diag, seed: int, step: int,
                      dt: float, a: float, b: float):
    """Plain version of one BAOAB update phase: returns the new (x, w, F)."""
    v = w + dt * F * minv
    x = x + (dt * 0.5) * v
    noise = splitmix_noise_plain(seed, step, x.shape[1], x.device)
    v = a * v + b * sigv * noise
    x = x + (dt * 0.5) * v
    L = box_diag.reshape(3, 1)
    x = x - torch.floor(x * (1.0 / L)) * L
    return x, v, torch.zeros_like(F)


def baoab_phase_(x, w, F, minv, sigv, box_diag, seed: int, step_offset,
                 s: int, dt: float, a: float, b: float):
    """One BAOAB update phase in place on (x, w, F) at step
    ``step_offset + s`` (``step_offset`` a (1, 1) int32 device tensor)."""
    if x.device.type == "cpu":
        step = int(step_offset.reshape(-1)[0]) + s
        out = baoab_phase_plain(x, w, F, minv, sigv, box_diag, seed, step,
                                dt, a, b)
        for dst, src in zip((x, w, F), out):
            dst.copy_(src)
        return
    _build.check_cuda(x, "x")
    dev = x.device
    n_pad = x.shape[1]
    for name, t, shape in (("x", x, (3, n_pad)), ("w", w, (3, n_pad)),
                           ("F", F, (3, n_pad)), ("minv", minv, (1, n_pad)),
                           ("sigv", sigv, (1, n_pad))):
        _build.require(t, name, shape, torch.float32, dev)
    _build.require(box_diag, "box_diag", None, torch.float32, dev)
    _build.require(step_offset, "step_offset", (1, 1), torch.int32, dev)
    if n_pad % 2 or box_diag.numel() != 3:
        raise ValueError("baoab: n_pad must be even and the box 3 lengths")
    _build.launch(
        "baoab", "chiron_baoab",
        x.data_ptr(), w.data_ptr(), F.data_ptr(), minv.data_ptr(),
        sigv.data_ptr(), box_diag.data_ptr(), step_offset.data_ptr(), s,
        seed & _MASK32, n_pad, dt, dt * 0.5, a, b, _build.stream_of(x),
    )


# ---------------------------------------------------------------------------
# Drift latch (K3's last step)
# ---------------------------------------------------------------------------


def skin_drift_plain(x, anchor, n: int, box_diag):
    """(n_pad,) f32 min-image drift of each lane from ``anchor``, 0 on the
    padding lanes (lane >= n)."""
    n_pad = x.shape[1]
    valid = torch.arange(n_pad, device=x.device) < n
    L = box_diag.reshape(3, 1)
    dxa = x - anchor
    dxa = dxa - L * torch.floor(dxa * (1.0 / L) + 0.5)
    d2 = dxa[0] * dxa[0]
    d2 = d2 + dxa[1] * dxa[1]
    d2 = d2 + dxa[2] * dxa[2]
    return torch.sqrt(torch.where(valid, d2, 0.0))


def skin_drift_top2_plain(x, anchor, n: int, box_diag):
    """() f32 sum of the two largest min-image drifts of the live lanes from
    ``anchor`` (two lanes tied at the largest count it twice); NaN where a
    live lane's drift is NaN."""
    d = skin_drift_plain(x, anchor, n, box_diag)
    m1 = torch.max(d)
    others = torch.where(d == m1, -1.0, d)
    m2 = torch.clamp_min(torch.max(others), 0.0)
    tied = torch.sum(d == m1) > 1
    return m1 + torch.where(tied, m1, m2)


def live_nonfinite(x, n: int):
    """() bool: some live coordinate (lane < n) is not finite."""
    return ~torch.isfinite(x[:, :n]).all()


def tile_skin_drift_bad_plain(x, anchor, n: int, threshold, box_diag):
    """Plain version of the latch: () bool, True when the top-2 joint
    min-image drift from ``anchor`` exceeds ``threshold`` (a float or a
    0-dim tensor) or a live coordinate is not finite."""
    n_pad = x.shape[1]
    valid = torch.arange(n_pad, device=x.device) < n
    finite_ok = torch.all(torch.abs(torch.where(valid, x, 0.0)) < 3.0e38)
    top2 = skin_drift_top2_plain(x, anchor, n, box_diag)
    return (top2 > threshold) | ~finite_ok


class LatchScratch:
    """The drift latch's scratch for one n_pad: 4 ints of partial a block
    of ``_build.LATCH_BLOCK_LANES`` lanes, and the last-block ticket, which
    the kernel leaves at 0.  Latches that run at once on different streams
    need one each."""

    def __init__(self, n_pad: int, device):
        blocks = -(-n_pad // _build.LATCH_BLOCK_LANES)
        self.n_pad = n_pad
        self.part = torch.empty(4 * blocks, dtype=torch.int32, device=device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=device)

    def pointers(self):
        return self.part.data_ptr(), self.ticket.data_ptr()


def _threshold(threshold, device):
    """A latch threshold as a 0-dim f32 tensor on ``device`` (a float is put
    there, one more launch)."""
    if not torch.is_tensor(threshold):
        threshold = torch.full((), threshold, dtype=torch.float32,
                               device=device)
    _build.require(threshold, "threshold", (), torch.float32, device)
    return threshold


def tile_skin_drift_bad(x, anchor, n: int, threshold, box_diag,
                        scratch: LatchScratch = None):
    """The drift latch: () bool tensor on the device of ``x``.

    ``threshold`` is a 0-dim f32 tensor on the device, read there by the
    kernel: the engine's ``slack_t`` in NVT, the NpT runner's remaining
    budget.  A float is put on the device first, one more launch.  The
    kernel takes its scratch from ``scratch``, or from a new one (a fill
    launch for its ticket).
    """
    if x.device.type == "cpu":
        return tile_skin_drift_bad_plain(x, anchor, n, threshold, box_diag)
    _build.check_cuda(x, "x")
    n_pad = x.shape[1]
    _build.require(x, "x", (3, n_pad), torch.float32)
    _build.require(anchor, "anchor", (3, n_pad), torch.float32, x.device)
    _build.require(box_diag, "box_diag", None, torch.float32, x.device)
    threshold = _threshold(threshold, x.device)
    if box_diag.numel() != 3:
        raise ValueError("drift: the box needs 3 lengths")
    if scratch is None:
        scratch = LatchScratch(n_pad, x.device)
    if scratch.n_pad != n_pad:
        raise ValueError(f"latch scratch for n_pad {scratch.n_pad}, not "
                         f"{n_pad}")
    flag = torch.empty((), dtype=torch.bool, device=x.device)
    _build.launch(
        "tile_skin_drift", "chiron_drift",
        x.data_ptr(), anchor.data_ptr(), box_diag.data_ptr(), n, n_pad,
        threshold.data_ptr(), *scratch.pointers(), flag.data_ptr(),
        _build.stream_of(x),
    )
    return flag


class SegmentWorkspace:
    """The scratch of K3's segments on one engine and list capacity,
    allocated once and reused by every segment: the force pass's row,
    column and energy partials, and the drift latch's."""

    def __init__(self, md, capacity: int):
        _, self.P, self.R, self.e_part, _ = cull_buffers(
            md.n_pad, md.tm, md.tn, capacity, False, md.device)
        self.capacity = capacity
        self.latch = LatchScratch(md.n_pad, md.device)

    def check(self, capacity: int):
        if self.capacity != capacity:
            raise ValueError(f"the workspace holds capacity {self.capacity}, "
                             f"not {capacity}")


def segment_launches(n_steps: int, latch: bool):
    """The kernels that K3's segment enqueues from its C entry, as
    ``_build.launch`` counts them: ``cull_md_steps`` (lj_cull_force.cu)
    launches step 0's BAOAB phase and each step's culled force pass (the
    other steps' BAOAB updates run in its gather), and the entry then the
    latch where it has a flag.  K11's entry runs the same steps and latch."""
    out = [("baoab", 1), ("culled_force", n_steps)]
    if latch:
        out.append(("tile_skin_drift", 1))
    return out


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class CulledLJMD:
    """S-step BAOAB segments on the culled tile-pair LJ force
    (``lj_cull.py:998``): half-kick convention w = v - dt/2 F/m inside,
    standard (x, v, F) at both ends; the caller owns sorting and rebuilds."""

    def __init__(self, n, sigma, epsilon, cutoff, masses_lane, dt, gamma, kT,
                 tm: int = 128, tn: int = 128,
                 slack: float = 0.2, n_pad: int = None, *, device="cuda"):
        self.n = n
        self.sigma, self.epsilon, self.cutoff = (
            float(sigma), float(epsilon), float(cutoff)
        )
        self.dt = float(dt)
        # f32 coefficients, computed as the JAX engine computes them
        f32 = torch.float32
        self.a = float(torch.exp(torch.tensor(-gamma * dt, dtype=f32)))
        self.b = float(torch.sqrt(
            1.0 - torch.exp(torch.tensor(-2.0 * gamma * dt, dtype=f32))
        ))
        self.kT = float(kT)
        self.slack = float(slack)
        self.tm, self.tn = tm, tn
        self.n_pad = _round_up(n_pad if n_pad is not None else n,
                               math.lcm(tm, tn))
        self.device = torch.device(device)
        m = torch.as_tensor(masses_lane, dtype=f32).reshape(1, -1)
        if m.shape[1] != self.n_pad:
            mm = torch.ones((1, self.n_pad), dtype=f32)
            mm[0, :m.shape[1]] = m[0]
            m = mm
        m = m.to(self.device)
        self.minv = 1.0 / m
        self.sigv = torch.sqrt(self.kT / m)
        # the NVT latch threshold, on the device once for every segment
        self.slack_t = torch.full((), self.slack, dtype=f32,
                                  device=self.device)

    def build_pairs(self, pos3, box_diag, capacity: int) -> TilePairList:
        return build_tile_pairs(pos3, self.n, self.tm, self.tn, box_diag,
                                self.cutoff, self.slack, capacity)

    def force(self, pos3, box_diag, pairs: TilePairList,
              approx_recip: bool = True):
        """Culled force of WRAPPED positions under the given list (K4)."""
        return culled_force_pass(
            pos3, box_diag, pairs, self.n, self.tm, self.tn, self.sigma,
            self.epsilon, self.cutoff, approx_recip,
        )[0]

    def force_energy(self, pos3, box_diag, pairs: TilePairList):
        """Force and () total truncated-LJ energy of WRAPPED positions in
        one culled pass (K5), with the exact reciprocal, since the energy
        feeds the NpT runner's Metropolis ratios."""
        return culled_force_energy(
            pos3, box_diag, pairs, self.n, self.tm, self.tn, self.sigma,
            self.epsilon, self.cutoff,
        )

    def energy_differentiable(self, pos3, box_diag, pairs: TilePairList):
        """Total energy over the list as a differentiable function of
        ``pos3``: its autograd gradient is exactly ``-force`` of one exact
        K5 pass.  The list is constant data (no gradient into it)."""
        return energy_with_force_gradient(
            lambda p: self.force_energy(p, box_diag, pairs), pos3)

    @spanned("chiron.op.culled_md")
    def run_segment(self, x3, v3, f3, box_diag, pairs: TilePairList, seed: int,
                    step_offset, n_steps: int, approx_recip: bool = True,
                    final_energy: bool = False, drift_anchor=None,
                    drift_budget=None, workspace: SegmentWorkspace = None):
        """Advance ``n_steps`` on a fixed list from (x3, v3, f3) (K3).

        ``step_offset`` is the (1, 1) int32 step counter of the noise
        stream.  Returns new (x, v, F) tensors, then:

        * with ``drift_anchor``, the () bool drift latch: the top-2 joint
          drift from ``drift_anchor`` (the positions the list was built
          from) against ``drift_budget``, a float or a 0-dim f32 tensor
          (the engine's ``slack_t``, or the NpT runner's budget);
        * with ``final_energy``, the () energy of the final configuration,
          taken by the last step's force pass with the exact reciprocal.

        On a CUDA tensor the segment is one C call on ``workspace``'s
        scratch (a new one if None), its inputs checked once; it equals
        ``run_segment_stepwise`` bit for bit.  On a CPU tensor it is that
        loop of plain versions.
        """
        if x3.device.type == "cpu":
            return self.run_segment_stepwise(
                x3, v3, f3, box_diag, pairs, seed, step_offset, n_steps,
                approx_recip, final_energy, drift_anchor, drift_budget)
        capacity = _check_cull_inputs(x3, box_diag, pairs, self.tm, self.tn)
        dev, n_pad = x3.device, self.n_pad
        for name, t in (("x3", x3), ("v3", v3), ("f3", f3)):
            _build.require(t, name, (3, n_pad), torch.float32, dev)
        if n_steps < 1:
            raise ValueError(f"a segment takes n_steps >= 1 (got {n_steps})")
        if workspace is None:
            workspace = SegmentWorkspace(self, capacity)
        workspace.check(capacity)
        if not torch.is_tensor(step_offset):
            step_offset = torch.tensor([[step_offset]], dtype=torch.int32,
                                       device=dev)
        _build.require(step_offset, "step_offset", (1, 1), torch.int32, dev)
        if drift_anchor is not None:
            anchor = drift_anchor
            threshold = _threshold(drift_budget, dev)
            _build.require(anchor, "drift_anchor", (3, n_pad), torch.float32,
                           dev)
        else:
            anchor = threshold = None
        half_dt = 0.5 * self.dt
        w = v3 - half_dt * f3 * self.minv
        x, F = torch.empty_like(x3), torch.empty_like(f3)
        flag = (None if anchor is None
                else torch.empty((), dtype=torch.bool, device=dev))
        energy = (torch.empty(1, dtype=torch.float32, device=dev)
                  if final_energy else None)
        inv_sigma = 1.0 / self.sigma
        work = cull_work(dev)
        _build.launch(
            "culled_md", "chiron_cull_md_segment",
            x3.data_ptr(), f3.data_ptr(), x.data_ptr(), w.data_ptr(),
            F.data_ptr(), self.minv.data_ptr(), self.sigv.data_ptr(),
            box_diag.data_ptr(), step_offset.data_ptr(), seed & _MASK32,
            n_steps, *list_pointers(pairs, False), workspace.P.data_ptr(),
            workspace.R.data_ptr(), workspace.e_part.data_ptr(),
            None if energy is None else energy.data_ptr(),
            None if anchor is None else anchor.data_ptr(),
            None if threshold is None else threshold.data_ptr(),
            *workspace.latch.pointers(),
            None if flag is None else flag.data_ptr(),
            self.n, n_pad, self.tm, self.tn, capacity, self.dt, half_dt,
            self.a, self.b, inv_sigma, 1.0 / inv_sigma,
            (self.cutoff / self.sigma) ** 2, 48.0 * self.epsilon / self.sigma,
            4.0 * self.epsilon, int(approx_recip),
            None if work is None else work.data_ptr(), _build.stream_of(x3),
            enqueued=segment_launches(n_steps, flag is not None),
        )
        out = [x, w + half_dt * F * self.minv, F]
        if flag is not None:
            out.append(flag)
        if final_energy:
            out.append(energy[0])
        return tuple(out)

    def run_segment_stepwise(self, x3, v3, f3, box_diag, pairs: TilePairList,
                             seed: int, step_offset, n_steps: int,
                             approx_recip: bool = True,
                             final_energy: bool = False, drift_anchor=None,
                             drift_budget=None):
        """``run_segment`` as a Python loop of the step's wrappers:
        ``baoab_phase_`` and ``culled_force_pass`` each step, then
        ``tile_skin_drift_bad`` (2 S + 1 calls).  On a CPU tensor these run
        their plain versions; on a CUDA tensor, their kernels, which
        ``run_segment``'s one call must equal bit for bit."""
        if not torch.is_tensor(step_offset):
            step_offset = torch.tensor([[step_offset]], dtype=torch.int32,
                                       device=x3.device)
        half_dt = 0.5 * self.dt
        w = v3 - half_dt * f3 * self.minv
        x = x3.clone()
        F = f3.clone()
        energy = None
        for s in range(n_steps):
            baoab_phase_(x, w, F, self.minv, self.sigv, box_diag, seed,
                         step_offset, s, self.dt, self.a, self.b)
            F, energy = culled_force_pass(
                x, box_diag, pairs, self.n, self.tm, self.tn, self.sigma,
                self.epsilon, self.cutoff, approx_recip,
                with_energy=final_energy and s == n_steps - 1,
            )
        v = w + half_dt * F * self.minv
        out = [x, v, F]
        if drift_anchor is not None:
            out.append(tile_skin_drift_bad(x, drift_anchor, self.n,
                                           drift_budget, box_diag))
        if final_energy:
            out.append(energy)
        return tuple(out)
