"""One culled MD segment in one host call (port of
``chiron_tpu/ops/lj_mega.py``).

``mega_segment`` is the counterpart of ``mega_md_raw`` (K11: ``_make_mega_kernel``
:82, ``pallas_call`` :368): the tile-pair list built from the positions in
their current order, S BAOAB steps on the culled force, the drift latch
against the entry positions, and P odd-even transposition passes that
repair the spatial order in place of a re-sort.  On a CUDA tensor one C
entry of ``csrc/lj_mega.cu`` enqueues all of it on the current stream,
counted as ``mega_md`` and each kernel it enqueues under its own name: its
own ``tile_build`` and ``mega_repair`` and K3's steps (``baoab`` once, the
culled force S times, the next step's BAOAB update in its gather) and
latch, on list and scratch buffers a ``MegaWorkspace`` holds across
segments.  On a CPU tensor it runs ``mega_segment_plain``:
``build_tile_pairs``, then ``baoab_phase_plain``, ``row_force_pass_plain``
and ``tile_skin_drift_bad_plain``, then ``repair_plain``.  ``tile_build``
and ``mega_repair`` are the two kernels' own wrappers.

The repair's comparator is the minimum-image x difference, so the order it
keeps is cyclic: a particle that wrapped across the x boundary stays near
its rank.  The padding lanes (n and above) never move.  Only the pure-x
sort key fits it (``nslab == 0``).
"""

from __future__ import annotations

import torch

from . import _build
from .lj_cull import (
    _MASK32,
    CulledLJMD,
    SegmentWorkspace,
    TilePairList,
    baoab_phase_plain,
    build_tile_pairs,
    list_pointers,
    row_force_pass_plain,
    segment_launches,
    tile_skin_drift_bad_plain,
)
from .sortbuild import list_buffers


def repair_plain(x, w, F, n: int, box_diag, passes: int):
    """Plain version of the repair (``lj_mega.py:300-335``): returns the
    reordered (x, w, F)."""
    n_pad = x.shape[1]
    lane = torch.arange(n_pad, device=x.device)
    Lx = box_diag.reshape(3)[0]
    inv_Lx = 1.0 / Lx
    rows = torch.cat([x, w, F], dim=0)
    for p in range(passes):
        key = rows[0]
        dn = key - torch.roll(key, -1)
        dn = dn - Lx * torch.round(dn * inv_Lx)
        dp = torch.roll(key, 1) - key
        dp = dp - Lx * torch.round(dp * inv_Lx)
        is_lo = (lane % 2) == (p % 2)
        t_nxt = is_lo & (dn > 0) & (lane < n - 1)
        t_prv = ~is_lo & (dp > 0) & (lane > 0) & (lane < n)
        rows = torch.where(t_nxt, torch.roll(rows, -1, dims=1),
                           torch.where(t_prv, torch.roll(rows, 1, dims=1),
                                       rows))
    return rows[0:3], rows[3:6], rows[6:9]


def check_mega_tiles(n_pad: int, tm: int, tn: int):
    # the TPU kernel takes tiles in multiples of its 128-lane rows, and so
    # do the build (tile_build.cuh) and K3's steps
    if tm <= 0 or tn <= 0 or tm % 128 or tn % 128 or n_pad % tn or n_pad % tm:
        raise ValueError(
            f"the megakernel takes tm and tn multiples of 128, both dividing "
            f"n_pad (got tm={tm}, tn={tn}, n_pad={n_pad})")


def tile_build(x3, n: int, tm: int, tn: int, box_diag, cutoff: float,
               slack: float, capacity: int) -> TilePairList:
    """The list of ``x3`` in its current order (K11's build, K10's without
    the sort): ``build_tile_pairs``'s arrays.  On a CUDA tensor one launch,
    counted as ``tile_build``."""
    if x3.device.type == "cpu":
        return build_tile_pairs(x3, n, tm, tn, box_diag, cutoff, slack,
                                capacity)
    _build.check_cuda(x3, "x3")
    n_pad = x3.shape[1]
    check_mega_tiles(n_pad, tm, tn)
    _build.require(x3, "x3", (3, n_pad), torch.float32)
    _build.require(box_diag, "box_diag", None, torch.float32, x3.device)
    if box_diag.numel() != 3 or not 0 < n <= n_pad or capacity < 1:
        raise ValueError("tile_build: needs 3 box lengths, 0 < n <= n_pad "
                         "and a capacity")
    pairs = list_buffers(n_pad, tm, capacity, x3.device)
    _build.launch(
        "tile_build", "chiron_tile_build", x3.data_ptr(), box_diag.data_ptr(),
        *list_pointers(pairs), n, n_pad, tm, tn, cutoff, slack,
        (cutoff + slack) ** 2, capacity, _build.stream_of(x3),
    )
    return pairs


def repair_scratch(n_pad: int, passes: int, device):
    """The repair's global window scratch (keys, idx) where its window at
    n_pad and P outgrows shared memory (the kernel's launch decides), else
    None."""
    lanes = _build.library().chiron_repair_scratch_lanes(n_pad, passes)
    if lanes == 0:
        return None
    return (torch.empty(lanes, dtype=torch.float32, device=device),
            torch.empty(lanes, dtype=torch.int32, device=device))


def _scratch_pointers(scratch):
    return (None, None) if scratch is None else tuple(
        t.data_ptr() for t in scratch)


def mega_repair(x, w, F, n: int, box_diag, passes: int):
    """``passes`` repair passes over (x, w, F): returns new tensors.  On a
    CUDA tensor one launch, counted as ``mega_repair``, into new tensors."""
    if x.device.type == "cpu":
        return repair_plain(x, w, F, n, box_diag, passes)
    _build.check_cuda(x, "x")
    n_pad = x.shape[1]
    for name, t in (("x", x), ("w", w), ("F", F)):
        _build.require(t, name, (3, n_pad), torch.float32, x.device)
    _build.require(box_diag, "box_diag", None, torch.float32, x.device)
    if passes < 0:
        raise ValueError(f"repair passes {passes} < 0")
    out = tuple(torch.empty_like(t) for t in (x, w, F))
    scratch = repair_scratch(n_pad, passes, x.device)
    _build.launch("mega_repair", "chiron_mega_repair", x.data_ptr(),
                  w.data_ptr(), F.data_ptr(), *(t.data_ptr() for t in out),
                  box_diag.data_ptr(), n, n_pad, passes,
                  *_scratch_pointers(scratch), _build.stream_of(x))
    return out


def mega_segment_plain(md: CulledLJMD, x3, w3, f3, box_diag, capacity: int,
                       seed: int, step_offset: int, n_steps: int,
                       repair_passes: int = 16):
    """Plain version of K11 on ``md``'s system: returns (x, w, F, () bool
    flag)."""
    n = md.n
    box = box_diag.reshape(3)
    pairs = build_tile_pairs(x3, n, md.tm, md.tn, box, md.cutoff, md.slack,
                             capacity)
    x, w, F = x3, w3, f3
    for s in range(n_steps):
        x, w, F = baoab_phase_plain(x, w, F, md.minv, md.sigv, box, seed,
                                    step_offset + s, md.dt, md.a, md.b)
        F, _ = row_force_pass_plain(x, box, pairs, n, md.tm, md.tn, md.sigma,
                                    md.epsilon, md.cutoff)
    flag = pairs.overflowed | tile_skin_drift_bad_plain(x, x3, n, md.slack,
                                                        box)
    x, w, F = repair_plain(x, w, F, n, box, repair_passes)
    return x, w, F, flag


class MegaWorkspace(SegmentWorkspace):
    """The list and scratch buffers of K11's segments on one engine and
    capacity, allocated once and reused by every segment: K3's segment
    scratch, the list, the (x, w, F) the steps update in place, the drift
    latch's flag and, once a repair needs it, the repair's window
    scratch."""

    def __init__(self, md: CulledLJMD, capacity: int):
        n_pad = md.n_pad
        check_mega_tiles(n_pad, md.tm, md.tn)
        super().__init__(md, capacity)
        dev = md.device
        self.pairs = list_buffers(n_pad, md.tm, capacity, dev)
        self.state = torch.empty((3, 3, n_pad), dtype=torch.float32,
                                 device=dev)
        self.drift_bad = torch.empty((), dtype=torch.bool, device=dev)
        self._repair = None

    def repair_pointers(self, passes: int):
        """The repair's (keys, idx) scratch pointers at P = ``passes``,
        allocated on the first repair that needs them."""
        if self._repair is None:
            self._repair = repair_scratch(self.state.shape[2], passes,
                                          self.state.device)
        return _scratch_pointers(self._repair)


def mega_segment(md: CulledLJMD, x3, w3, f3, box_diag, capacity: int,
                 seed: int, step_offset, n_steps: int,
                 repair_passes: int = 16, approx_recip: bool = True,
                 workspace: MegaWorkspace = None):
    """K11: one segment of ``n_steps`` on ``md``'s system from (x3, w3, f3)
    in the current order, w the velocity before the trailing half-kick.

    ``step_offset`` is the step counter of the noise stream, an int or a
    (1, 1) int32 device tensor.  Returns new (x, w, F) tensors and the () bool
    flag: a capacity overflow or broken shift bound at the build, or the
    drift latch at the end.  The segment's list stays inside (in
    ``workspace.pairs`` on the card).
    """
    if x3.device.type == "cpu":
        if torch.is_tensor(step_offset):
            step_offset = int(step_offset.reshape(-1)[0])
        return mega_segment_plain(md, x3, w3, f3, box_diag, capacity, seed,
                                  step_offset, n_steps, repair_passes)
    _build.check_cuda(x3, "x3")
    dev = x3.device
    n_pad = md.n_pad
    if workspace is None:
        workspace = MegaWorkspace(md, capacity)
    workspace.check(capacity)
    for name, t in (("x3", x3), ("w3", w3), ("f3", f3)):
        _build.require(t, name, (3, n_pad), torch.float32, dev)
    _build.require(box_diag, "box_diag", None, torch.float32, dev)
    if box_diag.numel() != 3:
        raise ValueError("mega_segment: the box needs 3 lengths")
    if n_steps < 1 or repair_passes < 0:
        raise ValueError(f"mega_segment: n_steps {n_steps} must be >= 1 and "
                         f"repair_passes {repair_passes} >= 0")
    if not torch.is_tensor(step_offset):
        step_offset = torch.tensor([[step_offset]], dtype=torch.int32,
                                   device=dev)
    _build.require(step_offset, "step_offset", (1, 1), torch.int32, dev)
    x, w, F = (torch.empty_like(t) for t in (x3, w3, f3))
    flag = torch.empty((), dtype=torch.bool, device=dev)
    inv_sigma = 1.0 / md.sigma
    ws = workspace
    _build.launch(
        "mega_md", "chiron_mega_segment",
        x3.data_ptr(), w3.data_ptr(), f3.data_ptr(),
        *(ws.state[q].data_ptr() for q in range(3)),
        x.data_ptr(), w.data_ptr(), F.data_ptr(),
        md.minv.data_ptr(), md.sigv.data_ptr(), box_diag.data_ptr(),
        step_offset.data_ptr(), seed & _MASK32, n_steps,
        *list_pointers(ws.pairs), ws.P.data_ptr(), ws.R.data_ptr(),
        ws.e_part.data_ptr(), md.slack_t.data_ptr(), *ws.latch.pointers(),
        ws.drift_bad.data_ptr(), *ws.repair_pointers(repair_passes),
        flag.data_ptr(), md.n, n_pad, md.tm, md.tn, capacity,
        md.cutoff, md.slack, (md.cutoff + md.slack) ** 2,
        md.dt, md.dt * 0.5, md.a, md.b, inv_sigma, 1.0 / inv_sigma,
        (md.cutoff / md.sigma) ** 2, 48.0 * md.epsilon / md.sigma,
        int(approx_recip), repair_passes, _build.stream_of(x),
        enqueued=(("tile_build", 1), *segment_launches(n_steps, True),
                  ("mega_repair", 1)),
    )
    return x, w, F, flag
