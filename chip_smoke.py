#!/usr/bin/env python3
"""Drive the PyTorch port's LJ-fluid paths once on one NVIDIA GPU: NVT and
NpT at N=4000, the band engine at N=100,000 and the halo-strip engine.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits nonzero):

1. the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc;
2. build the kernels of ``chiron_tpu_torch/csrc`` with nvcc;
3. compare every kernel with its plain PyTorch version on the card, at the
   main path's shapes (N=4000, n_pad=4096, tiles 128 x 256), on a
   configuration melted by 1000 dense steps, and time both with CUDA events:
   K1, the culled force (K4, K3's force phase), K5 and K3's exact-energy
   final step, the culled runner at a row tile of 256 (K5 against its plain
   version, then 400 steps, ``check()`` clean, energy within 1e-5 of the f64
   oracle), BAOAB, the drift latch with the slack and with a budget
   on either side of the measured drift (and, exactly, at the top-2 sum
   that a torch replica merges from the kernel's partials, where it holds,
   and one ulp under it, where it latches), K3's segment as one C call
   (``culled_md``) bitwise equal to the step-by-step sequence of the same
   kernels at S = 1, 2 and 40 in NVT, with the exact reciprocal and in NpT
   (anchor, budget, final energy), a NaN latching both, and within 1e-5 nm
   of its plain loop over 5 steps, and K7 on the strip layout of that
   state (its force, force and energy, each bitwise equal when repeated,
   its chunks skipped and LJ loop trips counted by a torch replica, and
   BAOAB phase with the halo refresh).  K6 is held to its plain version at
   the end of phase 7, on the band layout of the N=100,000 fluid;
4. run one culled segment, one NpT segment with the barostat's generator
   restored in between, and one strip segment, twice from one carry: the
   results must be bitwise equal (no float atomics anywhere);
5. the NVT main path of ``bench.py`` on the port, with launch counts reset
   just before it: ``LennardJonesFluid(4000, 0.8)``, 1000 dense BAOAB steps
   at 120 K and 2 fs, then the culled runner (S=40, slack 0.15) for 3000
   steps; ``check()`` must pass, the energy must be finite and agree with
   the f64 oracle, the kinetic temperature must be within 5% of 120 K, and
   every kernel of the path must have been launched;
6. the NpT path, with the counts reset again: from the phase-5 state, the
   culled NpT runner at 120 K and 100 atm (barostat every 25 steps, S=50,
   slack 0.2) for 3000 steps, then the dense NpT runner for 500 steps; 120
   and 20 attempts, ``check()`` clean, the carried energy equal to a fresh
   K5 pass within 1e-6, K5 within 1e-5 of the f64 oracle, T_kin within 5%,
   and all five kernels launched;
7. the band path, counted: ``make_lj_runner(engine="auto")`` on
   ``LennardJonesFluid(100000, 0.8)`` must return the band runner; from the
   lattice, 2000 steps to melt and thermalise, then a timed 1000-step
   window; ``check()`` clean, the runner's K1 energy finite, T_kin within
   5%, K6's force and K1 launched (the counts are read here).  Then the K1
   energy within 1e-5 of K6's single-count energy, K6 against its plain
   version on that state and bitwise equal to K6 taking every slot
   (``skip=False``), a repeated band step (through the re-sort and without
   it) bitwise equal, a NaN live coordinate latched by the next step, so
   that ``check()`` raises, and K6's visit kinds and vote rate counted by a
   torch replica of its choices;
8. the strip path, counted: ``make_lj_runner(engine="strip")`` at N=4000
   from phase 5's state (S=50, slack 0.3) for 3000 steps; ``check()``
   clean, ``strip_baoab``, the strip force, the latch and K1 launched (the
   counts are read after the runner's ``energy``); the K1 and K7 energies
   within 1e-5 of the f64 oracle, T_kin within 5%; K7 on that state with
   the halo a tile narrower than the band the cutoff needs, where the strip
   misses pairs, within its tolerances of its plain version, its change
   from the covering halo equal to the plain version's within 0.02 (it
   misses the same pairs), and bitwise equal when repeated; and
   ``engine="auto"`` returns the dense runner at N=1000 and the culled
   runner at N=4000;
9. the spatial path at world size 1 (a mesh of this process alone), counted,
   from phase 7's melted N=100,000 state (tm 256): ``make_sharded_lj_force``
   (force, ``force_energy``, ``energy_differentiable``), the banded spatial
   runner for 500 steps (S=25) and the dense spatial runner for 100.  Then
   the sharded force within 1e-5 of K2's (``LJDense(triangle=False)``) and
   its energy too, ``-grad`` equal to its force bit for bit, K2 within 1e-5
   of its plain version; K8a (force, and force with the slab energy) and
   K8b within 1e-5 (max and 99th percentile, relative to the largest force)
   of their plain versions, with 4 slabs at offsets 0, r, 2r, 3r
   concatenating to the 1-slab result bit for bit, K8a's one slab (K1's
   kernel) equal to K2 bit for bit and half its slab energy to K2's energy,
   K8b bitwise equal to K8b taking every slot and its skipped chunks and
   vote rate counted by a torch replica; both runners
   ``check()``-clean or finite with T_kin within 5%, a repeated band
   segment bitwise equal; and one band segment in a 1-rank NCCL group equal
   bit for bit to the group-free one (the gathers run on the card);
10. the last three TPU kernels, each with its path, from phase 5's melted
   state: (a) K9, ``FusedLJMD`` at n_pad 4096 against its plain version
   (F after 1 step within 1e-4 of the largest force, x after 3 steps within
   1e-5 nm), a repeated run bitwise equal, then, counted, 1000 steps in
   segments of 100 with ``step_offset``: K1's energy within 1e-5 of the f64
   oracle, T_kin within 5%; (b) K10, ``sort_build`` bitwise equal to its
   plain version on every output at nslab 0 and 4, its x' the permutation
   of a torch replica of its network (8 lanes a thread; each stage in a
   thread, by a shuffle or through shared memory), and at n_pad 1024, 2048
   and 4096 on tied keys (a -0 among them) and on a NaN live coordinate,
   nslab 0 and 4, with the whole capacity, an overflow and the shift latch,
   bitwise equal to its plain version, to a repeat and to the replicas of
   its network and its build; timed beside ``torch.sort`` of the same keys
   (the sort phase's yardstick only); then, counted, the
   culled runner with ``fused_rebuild`` (S=40, slack 0.15) for 3000 steps
   on the kernel path: ``check()`` clean, energy within 1e-5 of the oracle,
   T_kin within 5%; (c) K11, its ``tile_build`` and ``mega_repair`` (at
   P = 1, 16 and 256) bitwise equal to their plain versions, the build also
   at n_pad 8192 (64 x 32 tile pairs, two passes; sorted and shuffled, two
   capacities) to its plain version and to the build's replica, the repair
   to a torch replica of its windows at the kernel's chunk, each timed
   against its bound, a P=0 ``mega_segment`` from a freshly
   sorted state bitwise equal to the classic kernel path, a P=16 one a pure
   permutation of it with the padding unmoved, the segment within 1e-5 nm of
   its plain version over 5 steps, then, counted, the culled runner with
   ``megakernel`` (pure x, S=40, slack 0.15, P=16) for 3000 steps:
   ``check()`` clean, energy within 1e-5 of the oracle, T_kin within 5%,
   the share of neighbouring live lanes in cyclic x order above one half
   and held from the first segment to the last; then 400 steps at P=256
   passes with more than 95% of them in order.

The ``kernels`` line gives each kernel's launches on the eight counted
paths (phases 5-10, under ``launches_by_path``; ``launches`` is their sum), its
error and times, and its bound.  The C entries of K3's and K11's segments
(``culled_md``, ``mega_md``) count one launch a call and each kernel they
enqueue under that kernel's name (``baoab`` once a segment,
``culled_force`` once a step: the gather's epilogue performs the other
steps' BAOAB updates).  K6's and K7's energy passes run on no
runner's path (both runners take their energy from K1, as in the JAX
package): they are held to their plain versions in [3] and [7] and show
no launches.  The bound is the larger of the f32 operations its
function needs over 67 TFLOP/s and its bytes (each input read once, each
output written once) over 3.35 TB/s, from this run's shapes, list and pairs
within the cutoff (for K6 and K8b, the band pairs within the cutoff in x
take the distance test: their kernels skip the rest whole).
The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script fails before printing any result.
"""

import json
import math
import os
import subprocess
import sys
import time
from dataclasses import replace

N = 4000
DENSITY = 0.8
T_KELVIN = 120.0
DENSE_STEPS = 1000
CULLED_STEPS = 3000
SEGMENT = 40
SLACK = 0.15
SEED = 1234
P_ATM = 100.0
NPT_INTERVAL = 25
NPT_SEGMENT = 50
NPT_SLACK = 0.2
NPT_STEPS = 3000
DENSE_NPT_STEPS = 500
N_BAND = 100_000
BAND_MELT_STEPS = 2000
BAND_STEPS = 1000
STRIP_STEPS = 3000
SPATIAL_TM = 256
SPATIAL_SEGMENT = 25
SPATIAL_BAND_STEPS = 500
SPATIAL_DENSE_STEPS = 100
FUSED_STEPS = 1000
FUSED_SEGMENT = 100
TM_WIDE = 256
WIDE_STEPS = 400
REPAIR_PASSES = 16
# enough odd-even passes to undo a segment's displacement at S=40
DEEP_REPAIR = 256
DEEP_STEPS = 400
# the kernels each counted path must launch.  No runner takes K6's or K7's
# energy pass (the band and strip runners take their energy from K1, as the
# JAX runners do): those two are held to their plain versions and listed
# with no launches on any path.
PATH_KERNELS = {
    "nvt": ("lj_dense", "culled_md", "culled_force", "baoab",
            "tile_skin_drift"),
    "npt": ("lj_dense", "culled_md", "culled_force", "culled_force_energy",
            "baoab", "tile_skin_drift"),
    "band": ("band_force", "lj_dense"),
    "strip": ("strip_baoab", "strip_force", "tile_skin_drift", "lj_dense"),
    "spatial": ("lj_dense_square", "row_slab_force", "row_slab_force_energy",
                "row_band_force"),
    "fused": ("fused_md", "lj_dense"),
    "fused_rebuild": ("sort_build", "culled_md", "baoab", "culled_force",
                      "tile_skin_drift", "lj_dense"),
    "mega": ("mega_md", "tile_build", "baoab", "culled_force",
             "tile_skin_drift", "mega_repair", "lj_dense"),
}
OFF_PATH = ("band_force_energy", "strip_force_energy")

# The card's peaks (NVIDIA H100 SXM data sheet, at 700 W): f32 outside the
# tensor cores, and HBM3.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# f32 operations a pair that the functions need (an FMA is 2).  Every
# candidate pair takes the distance test: for K1 and K6 the three
# minimum-image axes (subtract, scale, round, FMA: 5 each), r^2 (5) and the
# compare (1); for the culled passes, whose x fold is done once a particle,
# and for K7, whose halo carries the x image, dx (1), the y and z folds (5
# each), r^2 and the compare.  Only the pairs within
# the cutoff take the LJ term: the reciprocal (1), i6 (2), the coefficient
# (3), three force products and six sums into both particles; the energy
# adds (i6 - 1) i6 and its sum.  For K6 and K8b the candidate pairs are the
# band pairs within the cutoff in x alone: their kernels skip, whole, every
# visit whose x ranges hold no pair within the cutoff in x, and so a pair
# beyond it in x needs no distance test.
TEST_FLOPS = {"lj_dense": 21, "culled": 17, "band": 21, "strip": 17}
LJ_FLOPS = 15
ENERGY_FLOPS = 3
# per lane: BAOAB's kick, drifts, wrap and half a Box-Muller pair; the
# latch's image fold, norm and reductions; the fused update's kick, drifts,
# divide-wrap and a whole Box-Muller draw (its cos branch only)
LANE_FLOPS = {"baoab": 40, "tile_skin_drift": 20, "fused_update": 60}
# a repair comparison: the difference and its image fold (multiply, round,
# multiply, subtract)
REPAIR_FLOPS = 5


def _run(cmd):
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def _cuda_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _require(ok, what):
    if not ok:
        raise AssertionError(what)


def _report(name, err, tol, ms, plain_ms):
    print(f"  {name}: max_abs_err={err:.3e} (tolerance {tol}) "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")


def _bound(flops, nbytes):
    """(bound_ms, bound_by): the least time of the work on the card."""
    t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _segment_flops(listed, in_cut, n_pad):
    """The operations of a K3 segment of SEGMENT steps on one list:
    ``listed`` distance tests and ``in_cut`` LJ terms a step, BAOAB on the
    3 n_pad lanes a step, and the latch once."""
    return (SEGMENT * (listed * TEST_FLOPS["culled"] + in_cut * LJ_FLOPS
                       + 3 * n_pad * LANE_FLOPS["baoab"])
            + n_pad * LANE_FLOPS["tile_skin_drift"])


def _slab_pairs(n, off, rows):
    """Unordered pairs of the n live particles with at least one end in
    rows [off, off + rows): the distance tests a slab's force needs."""
    m = max(0, min(n, off + rows) - off)
    return m * (m - 1) // 2 + m * (n - m)


def _pairs_in_cutoff(x3, box_diag, n, cutoff):
    """Unordered pairs of live particles closer than the cutoff (f64)."""
    import torch

    pos = x3[:, :n].T.double()
    L = box_diag.reshape(3).double()
    count = 0
    for i0 in range(0, n, 1000):
        d = pos[i0:i0 + 1000, None, :] - pos[None, :, :]
        d = d - L * torch.round(d / L)
        r2 = (d * d).sum(-1)
        ids = torch.arange(n, device=pos.device)
        upper = ids[None, :] > ids[i0:i0 + 1000, None]
        count += int(((r2 < cutoff * cutoff) & upper).sum())
    return count


def _pairs_in_band(x3, box_diag, n, cutoff, w, chunk=512):
    """(within the cutoff, within it in x): pairs of x-sorted live particles
    at cyclic rank distance [1, w] closer than the cutoff, and those closer
    than it in x alone (f64).  The first is every pair within the cutoff
    while the band runner's ``check()`` is clean."""
    import torch

    pos = x3[:, :n].T.double()
    L = box_diag.reshape(3).double()
    count = count_x = 0
    for r0 in range(0, n, chunk):
        rows = torch.arange(r0, min(r0 + chunk, n), device=pos.device)
        cols = torch.arange(r0 + 1, r0 + chunk + w, device=pos.device) % n
        d = pos[rows, None, :] - pos[None, cols, :]
        d = d - L * torch.round(d / L)
        r2 = (d * d).sum(-1)
        delta = (cols[None, :] - rows[:, None]) % n
        band = (delta >= 1) & (delta <= w)
        count += int((band & (r2 < cutoff * cutoff)).sum())
        count_x += int((band & (d[..., 0].abs() < cutoff)).sum())
    return count, count_x


def _image_split(x3, box_diag):
    """The kernels' test of whether the minimum image may take compares:
    the bound of x that the image of |dx| < 1/2 L stands for (the exact
    threshold is within an ulp of it), and the count of coordinates outside
    [-L/8, 9L/8], where the kernels take the floor image instead."""
    L = box_diag.reshape(3, 1).float()
    out = int(((x3 < -0.125 * L) | (x3 > 1.125 * L)).sum())
    return 0.5 * float(L[0, 0]), out


def _x_apart(dlo, dhi, half, c2):
    """The kernels' x-range tests on the bounds dlo <= dx <= dhi of a
    visit's x displacements: (no x image, every pair beyond the cutoff in
    x)."""
    x0 = (dlo >= -half) & (dhi < half)
    return x0, x0 & (((dhi < 0) & (dhi * dhi >= c2))
                     | ((dlo > 0) & (dlo * dlo >= c2)))


def _band_votes(x3, box_diag, n, cutoff, w, tm):
    """A torch replica, on the card, of K6's choices on this state: the
    visits whose x ranges hold no pair within the cutoff (skipped whole),
    the interior ones (no rank mask) and the edge ones; and, in the visits
    taken, the share of warp steps (one row of each of the warp's two row
    groups against 16 columns) whose vote fires.  Returns (kinds, fired,
    steps, coordinates outside the compare image's range)."""
    import torch

    from chiron_tpu_torch.ops.lj_band import n_band_tiles

    dev = x3.device
    n_tiles = x3.shape[1] // tm
    nbt = n_band_tiles(w, tm, n_tiles)
    half, out = _image_split(x3, box_diag)
    L = box_diag.reshape(3, 1, 1).float()
    c2 = cutoff * cutoff
    lane = torch.arange(tm, device=dev)
    zero = torch.zeros((), dtype=torch.long, device=dev)
    apart_n, interior_n, fired, steps = zero, zero, zero, zero
    for i in range(n_tiles):
        rid = i * tm + lane
        tiles = (i + torch.arange(nbt, device=dev)) % n_tiles
        cols = (tiles[:, None] * tm + lane).reshape(-1)
        rx, cx = x3[0, rid], x3[0, cols].reshape(nbt, tm)
        x0, apart = _x_apart(rx.min() - cx.max(1).values,
                             rx.max() - cx.min(1).values, half, c2)
        dd = tiles * tm - i * tm
        wrap = dd + tm - 1 < 0
        lo = dd - (tm - 1) + torch.where(wrap, n, 0)
        hi = dd + (tm - 1) + torch.where(wrap, n, 0)
        interior = (~apart & x0 & (lo >= 1) & (hi <= w)
                    & (tiles * tm + tm <= n) & (i * tm + tm <= n))
        d = x3[:, rid, None] - x3[:, None, cols]
        d = d - L * torch.floor(d / L + 0.5)
        r2 = (d * d).sum(0)
        delta = torch.remainder(cols[None, :] - rid[:, None], n)
        m = ((r2 < c2) & (rid[:, None] < n) & (cols[None, :] < n)
             & (delta >= 1) & (delta <= w))
        # warp v holds the rows 32 v + 16 h + u (h = 0, 1) of row step u
        # against the columns 16 j + c (c < 16) of column step j
        f = m.reshape(8, 2, tm // 16, nbt, tm // 16, 16).any(5).any(1)
        f = f[:, :, ~apart, :]
        apart_n = apart_n + apart.sum()
        interior_n = interior_n + interior.sum()
        fired = fired + f.sum()
        steps = steps + f.numel()
    visits = n_tiles * nbt
    kinds = {"apart": int(apart_n), "interior": int(interior_n),
             "edge": visits - int(apart_n) - int(interior_n)}
    return kinds, int(fired), int(steps), out


def _row_band_votes(x3, box_diag, n, cutoff, w, tm):
    """A torch replica, on the card, of K8b's choices (one slab of every
    row) on this state: of its warps' 32-column chunks of the window, those
    that hold no band pair of the block's rows and those whose x ranges hold
    no pair within the cutoff (both skipped), and in the others the share of
    warp steps (a column against the warp's 32 rows) whose vote fires.
    Returns (chunks, skipped by the band, skipped by x, fired, steps,
    coordinates outside the compare image's range)."""
    import torch

    from chiron_tpu_torch.parallel.spatial import band_window

    dev = x3.device
    n_pad = x3.shape[1]
    n_tiles = n_pad // tm
    K, nbt = band_window(n, n_pad, tm, w)
    width = nbt * tm
    n_chunks = (width + 255) // 256
    half, out = _image_split(x3, box_diag)
    L = box_diag.reshape(3, 1, 1).float()
    c2 = cutoff * cutoff
    blocks = tm // 32
    cl = torch.arange(n_chunks * 256, device=dev)
    inwin = cl < width
    inf = float("inf")
    zero = torch.zeros((), dtype=torch.long, device=dev)
    dead_n, apart_n, fired, steps = zero, zero, zero, zero
    for rt in range(n_tiles):
        rows = rt * tm + torch.arange(tm, device=dev)
        c = (((rt - K) % n_tiles) * tm + cl) % n_pad
        xs = torch.where(inwin, x3[:, c], 0.0)
        col = torch.where(inwin, c, n)
        d = x3[:, rows, None] - xs[:, None, :]
        d = d - L * torch.floor(d / L + 0.5)
        r2 = (d * d).sum(0)
        delta = torch.remainder(col[None, :] - rows[:, None], n)
        live = ((col[None, :] < n) & (rows[:, None] < n) & (delta >= 1)
                & ((delta <= w) | (delta >= n - w)))
        shape = (blocks, 32, n_chunks, 8, 32)
        any_live = live.reshape(shape).any(4).any(1)
        row_live = (rows < n).reshape(blocks, 32)
        rxb = x3[0, rows].reshape(blocks, 32)
        rlo = torch.where(row_live, rxb, inf).min(1).values
        rhi = torch.where(row_live, rxb, -inf).max(1).values
        cxw = xs[0].reshape(n_chunks, 8, 32)
        _, apart = _x_apart(rlo[:, None, None] - cxw.max(2).values[None],
                            rhi[:, None, None] - cxw.min(2).values[None],
                            half, c2)
        taken = any_live & ~apart
        f = (live & (r2 < c2)).reshape(shape).any(1) & taken[..., None]
        dead_n = dead_n + (~any_live).sum()
        apart_n = apart_n + (any_live & apart).sum()
        fired = fired + f.sum()
        steps = steps + 32 * taken.sum()
    return (n_tiles * blocks * n_chunks * 8, int(dead_n), int(apart_n),
            int(fired), int(steps), out)


def _strip_candidates(n_pad, tm, H, device="cpu"):
    """A torch replica of K7's index math (``csrc/lj_strip.cu``,
    ``strip_pairs``): block b holds the particles q = 32 b + lane, and its
    warps walk chunks of 32 ranks from lane 0's first rank ts - H (ts = q -
    q mod tm), rounded down to a multiple of 32, to lane 31's end ts + tm +
    H; a chunk inside every lane's range [ts - H, ts + tm + H) and holding
    no lane's own rank is taken whole, another rank by rank.  Returns (q, j,
    take), each (blocks, chunks, 32 lanes, 32 ranks): lane q, rank j, and
    whether the kernel takes that slot."""
    import torch

    q = torch.arange(n_pad, device=device).reshape(-1, 32)
    ts = q - q % tm
    lo, hi = ts - H, ts + tm + H
    base = lo[:, :1] & ~31
    n_chunks = (hi[:, -1:] - base + 31) // 32
    k = torch.arange(int(n_chunks.max()), device=device)
    c0 = (base + 32 * k)[:, :, None]                        # (b, c, 1)
    inner = ((lo[:, None] <= c0) & (c0 + 32 <= hi[:, None])
             & ((q[:, None] < c0) | (q[:, None] >= c0 + 32))).all(2)
    j = c0[..., None] + torch.arange(32, device=device)     # (b, c, 1, 32)
    Q, LO, HI = (t[:, None, :, None] for t in (q, lo, hi))  # (b, 1, 32, 1)
    take = ((k[None, :] < n_chunks)[..., None, None]
            & (inner[..., None, None] | ((j >= LO) & (j < HI) & (j != Q))))
    return Q.expand_as(take), j.expand_as(take), take


def _strip_visits(xe, box_diag, tm, H, cutoff):
    """A torch replica, on the card, of K7's choices on an extended layout:
    of its warps' chunks of 32 ranks, those whose x ranges put every pair
    at least the cutoff apart (skipped), and in the others the LJ loop's
    trips (the warp's largest count of ranks taken within the cutoff a
    lane) and terms.  Returns (chunks, skipped, trips, terms)."""
    import torch

    n_pad = xe.shape[1] - H
    q, j, take = _strip_candidates(n_pad, tm, H, xe.device)
    c0 = j[:, :, 0, 0]
    wrapped = c0 < 0
    live = take.any(3).any(2)
    # rank j's column (xe[n_pad + j] below 0, rank 0's past the array), the
    # lanes' points and their halo copies (x + Lx where q < H)
    jc = j[:, :, 0]
    cols = xe[:, torch.where(jc < 0, jc + n_pad,
                             torch.where(jc >= n_pad + H, 0, jc))]
    ql = q[:, 0, :, 0]
    pts = xe[:, ql]                                     # (3, b, lanes)
    halo = torch.where(ql < H, xe[0, (ql + n_pad).clamp(max=n_pad + H - 1)],
                       pts[0])
    px = torch.where(wrapped[..., None], halo[:, None], pts[0][:, None])
    fin_q = torch.isfinite(pts[1:]).all(0) & torch.isfinite(pts[0])
    fin_h = torch.isfinite(pts[1:]).all(0) & torch.isfinite(halo)
    fin = (torch.isfinite(cols).all(0).all(2)
           & torch.where(wrapped, fin_h.all(1)[:, None],
                         fin_q.all(1)[:, None]))
    up = px.max(2).values - cols[0].min(2).values
    down = px.min(2).values - cols[0].max(2).values
    c2 = cutoff * cutoff
    apart = fin & (((up < 0) & (up * up >= c2))
                   | ((down > 0) & (down * down >= c2)))
    L = box_diag.reshape(3)
    d = torch.stack([px[..., None] - cols[0][:, :, None],
                     pts[1][:, None, :, None] - cols[1][:, :, None],
                     pts[2][:, None, :, None] - cols[2][:, :, None]])
    for a in (1, 2):
        d[a] = d[a] - L[a] * torch.floor(d[a] / L[a] + 0.5)
    r2 = (d * d).sum(0)
    hit = ~(r2 >= c2) & take & (live & ~apart)[..., None, None]
    trips = hit.sum(3).max(2).values
    return (int(live.sum()), int((live & apart).sum()), int(trips.sum()),
            int(hit.sum()))


# K11's repair (csrc/lj_mega.cu, launch_repair): chunks of round_up(P, 32)
# lanes, 32 to 512, a window of the chunk and P lanes each side in shared
# memory while it fits REPAIR_SMEM bytes, else one block over the whole order
REPAIR_SMEM = 200 * 1024


def _repair_geometry(n_pad, passes):
    """The repair kernel's (chunk, blocks, window) at n_pad and P passes, as
    ``launch_repair`` chooses them."""
    halo = min(passes, n_pad)
    chunk = min(max(-(-halo // 32) * 32, 32), 512)
    window = min(chunk + 2 * halo, n_pad)
    if 8 * window > REPAIR_SMEM:
        return n_pad, 1, n_pad
    return chunk, -(-n_pad // chunk), window


def _repair_windows(x, w, F, n, box_diag, passes, chunk):
    """A torch replica of the repair kernel's algorithm: each chunk of
    ``chunk`` lanes runs the P odd-even passes on its own window of lanes
    [c0 - P, c1 + P) clipped to [0, n_pad) (the parity from the global lane,
    a pair (i, i + 1) only inside the window and for i < n - 1), and keeps
    the source lanes of its own chunk.  Returns the reordered (x, w, F)."""
    import torch

    n_pad = x.shape[1]
    dev = x.device
    halo = min(passes, n_pad)
    c0 = torch.arange(0, n_pad, chunk, device=dev)
    c1 = torch.clamp_max(c0 + chunk, n_pad)
    w0 = torch.clamp_min(c0 - halo, 0)
    w1 = torch.clamp_max(c1 + halo, n_pad)
    g = w0[:, None] + torch.arange(int((w1 - w0).max()), device=dev)
    inside = g < w1[:, None]
    src = torch.where(inside, g, 0)
    keys = x[0][src]
    Lx = box_diag.reshape(3)[0]
    inv_Lx = 1.0 / Lx
    for p in range(passes):
        d = keys[:, :-1] - keys[:, 1:]
        d = d - Lx * torch.round(d * inv_Lx)
        swap = ((g[:, :-1] % 2 == p % 2) & inside[:, 1:]
                & (g[:, :-1] < n - 1) & (d > 0))
        lo = torch.nn.functional.pad(swap, (0, 1))   # t takes t + 1
        hi = torch.nn.functional.pad(swap, (1, 0))   # t takes t - 1
        keys, src = (torch.where(lo, t.roll(-1, 1),
                                 torch.where(hi, t.roll(1, 1), t))
                     for t in (keys, src))
    own = (g >= c0[:, None]) & (g < c1[:, None]) & inside
    perm = torch.empty(n_pad, dtype=torch.long, device=dev)
    perm[g[own]] = src[own]
    return x[:, perm], w[:, perm], F[:, perm]


def _top2_partial(d):
    """The latch kernel's partial of a set of lane drifts ``d`` (1-D f32):
    (m1, m2, the count at m1), NaN-absorbing, (-1, -1, 0) for no lanes."""
    import math

    m1, m2, c = -1.0, -1.0, 0
    for v in d.tolist():
        m1, m2, c = _top2_merge((m1, m2, c), (v, -1.0, 1))
        if math.isnan(m1):
            break
    return m1, m2, c


def _top2_merge(a, b):
    """The latch kernel's merge of two partials (csrc/drift.cu, merge):
    exact and independent of the order."""
    if a[0] != a[0]:
        return a
    if b[0] != b[0]:
        return b
    if a[0] == b[0]:
        return a[0], max(a[1], b[1]), a[2] + b[2]
    if a[0] > b[0]:
        return a[0], max(a[1], b[0]), a[2]
    return b[0], max(b[1], a[0]), b[2]


def _top2_value(part):
    """() f32 top-2 sum of a merged partial: m1 + (m1 if two lanes tie at
    m1, else max(m2, 0)), in f32."""
    import torch

    m1, m2, c = part
    second = m1 if c > 1 else max(m2, 0.0)
    return (torch.tensor(m1, dtype=torch.float32)
            + torch.tensor(second, dtype=torch.float32))


def _latch_replica(x, anchor, n, threshold, box_diag, splits):
    """The latch kernel's flag and top-2 sum from partials over ``splits``
    (lane index tensors, a partition of the lanes, merged in their order),
    the drifts and the finite test taken lane by lane as the kernel takes
    them.  Returns (() bool flag, () f32 top-2 sum)."""
    import functools

    import torch

    from chiron_tpu_torch.ops.lj_cull import skin_drift_plain

    d = skin_drift_plain(x, anchor, n, box_diag).cpu()
    live = torch.arange(x.shape[1]) < n
    finite = bool((x.cpu().abs() < 3.0e38)[:, live].all())
    part = functools.reduce(_top2_merge,
                            (_top2_partial(d[ix]) for ix in splits))
    top2 = _top2_value(part)
    return (top2 > torch.as_tensor(threshold).cpu()) | (not finite), top2


def _latch_splits(n_pad):
    """The lanes each thread of the latch kernel folds: 4 a thread, block b
    and thread t taking b 4 threads + t + u threads for u < 4, with one
    block of 1024 threads up to n_pad 4096 and blocks of 256 above."""
    import torch

    threads = 1024 if n_pad <= 4096 else 256
    block_lanes = 4 * threads
    lane = torch.arange(n_pad)
    key = (lane // block_lanes) * threads + lane % threads
    return [lane[key == k] for k in range(int(key.max()) + 1)]


def _epilogue_noise(seed, step, n_pad, device="cpu"):
    """A torch replica of the culled gather's epilogue noise: particle q's
    axis a takes counter lane a n_pad/2 + q mod n_pad/2 of the (3, n_pad/2)
    stream, its Box-Muller cos branch below n_pad/2 and its sin branch
    above.  Returns the (3, n_pad) noise."""
    import torch

    from chiron_tpu_torch.ops.lj_cull import _MASK32, counter_uniforms

    half = n_pad // 2
    q = torch.arange(n_pad, dtype=torch.int64, device=device)
    lane = (torch.arange(3, dtype=torch.int64, device=device)[:, None] * half
            + q % half)
    base = ((seed & _MASK32) * 0x9E3779B9
            + (step & _MASK32) * 0x85EBCA6B) & _MASK32
    c1 = ((lane * 2) * 0x9E3779B9 + base) & _MASK32
    c2 = ((lane * 2 + 1) * 0x9E3779B9 + base) & _MASK32
    u1, u2 = counter_uniforms(c1, c2)
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = 6.2831853071795864 * u2
    return torch.where(q < half, r * torch.cos(theta), r * torch.sin(theta))


def _culled_md_plain(md, x3, v3, f3, box_diag, pairs, seed, step, n_steps,
                     slack=None):
    """K3's segment as a loop of plain versions on the tensors' device:
    (x, v, F) and, with ``slack``, the latch against the entry."""
    from chiron_tpu_torch.ops import lj_cull as lc

    half = 0.5 * md.dt
    x, w, F = x3, v3 - half * f3 * md.minv, f3
    for k in range(n_steps):
        x, w, F = lc.baoab_phase_plain(x, w, F, md.minv, md.sigv, box_diag,
                                       seed, step + k, md.dt, md.a, md.b)
        F, _ = lc.row_force_pass_plain(x, box_diag, pairs, md.n, md.tm,
                                       md.tn, md.sigma, md.epsilon, md.cutoff)
    out = (x, w + half * F * md.minv, F)
    if slack is None:
        return out
    return out + (lc.tile_skin_drift_bad_plain(x, x3, md.n, slack,
                                               box_diag),)


def _canon(x, v, F, n):
    """The live lanes' (x, v, F) columns in lexicographic order (numpy)."""
    import numpy as np
    import torch

    m = torch.cat([x[:, :n], v[:, :n], F[:, :n]], dim=0).cpu().numpy()
    return m[:, np.lexsort(m[::-1])]


# The list build (csrc/tile_build.cuh): a row's column tiles lie in words of
# 32 lanes; a pass takes whole rows, at most 32 and at most PASS_WORDS words
PASS_WORDS = 512
# K10's network (csrc/sortbuild.cu): the adjacent lanes a thread holds
SORT_LANES = 8


def _popc(m):
    """The set bits of each 32-bit mask in the int64 tensor ``m``."""
    return sum((m >> b) & 1 for b in range(32))


def _build_grid(nr, nc):
    """The build's (words a row, rows a pass), as ``tile_build::grid``."""
    ncw = -(-nc // 32)
    return ncw, min(max(PASS_WORDS // ncw, 1), 32)


def _list_replica(x3, n, tm, tn, box_diag, cutoff, slack, capacity):
    """A torch replica of the list build's pair stage in the kernel's lane
    layout (csrc/tile_build.cuh): the plain version's rectangle geometry,
    then, a pass of whole rows at a time, word w of the pass on a warp,
    column (w mod ncw) 32 + lane on its lane; the two ballots (kept general,
    kept fast) a word; each row's counts and words' prefixes by popcount;
    the rows' exclusive scan over the running total of the earlier passes;
    each kept pair's slot from the popcount of its row's mask below its
    lane; the shift bound over every kept pair.  Returns a TilePairList."""
    import torch

    from chiron_tpu_torch.ops import lj_cull as lc

    dev = x3.device
    n_pad = x3.shape[1]
    nr, nc = n_pad // tm, n_pad // tn
    box = box_diag.reshape(3)
    keep, hsum, rcen, ccen = lc._tile_geometry(x3, n, tm, tn, box,
                                               cutoff + slack)
    Lx = box[0]
    bound_x = 0.5 * Lx - cutoff - slack
    ncw, rows_a_pass = _build_grid(nr, nc)
    lane = torch.arange(32, device=dev)
    below = (1 << lane) - 1
    rows = torch.zeros(capacity, dtype=torch.int32, device=dev)
    cols = torch.zeros_like(rows)
    ccx = torch.zeros(capacity, dtype=torch.float32, device=dev)
    ptr2 = torch.zeros(2 * nr + 1, dtype=torch.int64, device=dev)
    run, bad, taken = 0, False, set()
    for r0 in range(0, nr, rows_a_pass):
        nrows = min(rows_a_pass, nr - r0)
        w = torch.arange(nrows * ncw, device=dev)
        r = (r0 + w // ncw)[:, None].expand(-1, 32)
        c = (w % ncw)[:, None] * 32 + lane
        on = c < nc
        cc = torch.where(on, c, 0)
        k = keep[r, cc] & on
        general = ((cc * tn < r * tm + tm) | (cc >= (n - 1) // tn)
                   | (r >= (n - 1) // tm))
        bad = bad or bool((k & (hsum[0][r, cc] > bound_x)).any())
        gm = ((k & general).long() << lane).sum(1)
        fm = ((k & ~general).long() << lane).sum(1)
        gp, fp = _popc(gm).reshape(nrows, ncw), _popc(fm).reshape(nrows, ncw)
        gpre = (torch.cumsum(gp, 1) - gp).reshape(-1)
        fpre = (torch.cumsum(fp, 1) - fp).reshape(-1)
        gsum, fsum = gp.sum(1), fp.sum(1)
        incl = torch.cumsum(gsum + fsum, 0) + run
        base = incl - gsum - fsum
        ri = torch.arange(r0, r0 + nrows, device=dev)
        ptr2[2 * ri + 1] = torch.clamp_max(incl - fsum, capacity)
        ptr2[2 * ri + 2] = torch.clamp_max(incl, capacity)
        run = int(incl[-1])
        i = w // ncw
        gbit = ((gm[:, None] >> lane) & 1) == 1
        fbit = ((fm[:, None] >> lane) & 1) == 1
        slot = torch.where(
            gbit, (base[i] + gpre)[:, None] + _popc(gm[:, None] & below),
            (base[i] + gsum[i] + fpre)[:, None] + _popc(fm[:, None] & below))
        put = (gbit | fbit) & (slot < capacity)
        _require(taken.isdisjoint(slot[put].tolist())
                 and slot[put].unique().numel() == int(put.sum()),
                 "two pairs of the build replica share a slot")
        taken.update(slot[put].tolist())
        rr, cp = r[put], cc[put]
        rows[slot[put]] = rr.to(torch.int32)
        cols[slot[put]] = cp.to(torch.int32)
        cx = ccen[0][cp]
        ccx[slot[put]] = cx + torch.round((rcen[0][rr] - cx) / Lx) * Lx
    return lc.TilePairList(
        rows=rows.reshape(1, -1), cols=cols.reshape(1, -1),
        ccx=ccx.reshape(1, -1), ptr2=ptr2.to(torch.int32).reshape(1, -1),
        rowcx=rcen[0].reshape(1, -1).contiguous(),
        count=torch.tensor([[min(run, capacity)]], dtype=torch.int32,
                           device=dev),
        overflowed=torch.tensor(run > capacity or bad, device=dev))


def _rint_div(d, L):
    """A torch replica of the build's round(d / L) (csrc/tile_build.cuh,
    rint_div): where |d| <= L, copysign([d >= t] - [d <= -t], d) with t the
    float after L/2; elsewhere the division."""
    import torch

    t = torch.nextafter(0.5 * L, torch.full_like(L, math.inf))
    n = (d >= t).float() - (d <= -t).float()
    return torch.where(d.abs() <= L, torch.copysign(n, d),
                       torch.round(d / L))


def _network_route(j, lanes=SORT_LANES):
    """Where K10's network takes a stage of partner distance ``j``:
    ``"thread"`` (both lanes held by one thread), ``"warp"`` (a shuffle
    within the warp) or ``"shared"`` (shared memory and a barrier)."""
    return ("thread" if j < lanes
            else "warp" if j < 32 * lanes else "shared")


def _network_replica(key, lanes=SORT_LANES):
    """A torch replica of K10's bitonic network in the kernel's layout:
    thread t holds lanes t lanes + u (u < lanes) of the n_pad keys; stage
    (k, j) pairs held lane (t, u) with (t, u ^ j) inside the thread, else
    with (t ^ j / lanes, u), in the same warp for a shuffle and in another
    one through shared memory; the lane that keeps the smaller key (the
    lower lane l of an ascending block, l & k == 0, or the upper lane of a
    descending one) takes its partner's pair when its key is strictly
    smaller, the other lane when it is strictly larger: the TPU kernel's
    strict comparisons.  Returns the int64 permutation and the stages each
    route took."""
    import collections

    import torch

    n = key.shape[0]
    held = max(n // lanes, 1)
    t = torch.arange(held, device=key.device)[:, None]
    u = torch.arange(min(lanes, n), device=key.device)[None, :]
    lane = t * lanes + u
    kh, ih = key[lane], lane.clone()
    routes = collections.Counter()
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            route = _network_route(j, lanes)
            routes[route] += 1
            if route == "thread":
                pt, pu = t.expand_as(lane), (u ^ j).expand_as(lane)
            else:
                pt, pu = (t ^ (j // lanes)).expand_as(lane), u.expand_as(lane)
                in_warp = (pt // 32 == t // 32).all()
                _require(bool(in_warp) == (route == "warp"),
                         f"stage j={j}: partner outside the route {route}")
            pk, pi = kh[pt, pu], ih[pt, pu]
            keep_min = ((lane & j) == 0) == ((lane & ~j & k) == 0)
            swap = torch.where(keep_min, pk < kh, kh < pk)
            kh, ih = torch.where(swap, pk, kh), torch.where(swap, pi, ih)
            j //= 2
        k *= 2
    return ih.reshape(-1), dict(routes)


def _same(a, b):
    """Equal bit for bit where both hold numbers, NaN where either does."""
    import torch

    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def _listbuild_state(dev, n, n_pad, kind, seed=4):
    """(x, v, F) on ``dev``, n live lanes of n_pad in a 5.8 nm box: x on a
    0.05 nm grid ("ties": hundreds of live keys tie, a -0 with a +0) or
    with a NaN live x and y ("nan"); the padding at 3e38, as the sorting
    runners leave it."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 5.8, (3, n_pad)).astype(np.float32)
    if kind == "ties":
        x[0] = np.round(x[0] / 0.05) * np.float32(0.05)
        x[0, [3, 9]] = -0.0, 0.0  # zeros of both signs tie too
        _require(n - np.unique(x[0, :n]).size >= 256, "too few tied keys")
    else:
        x[0, 5] = x[1, n // 2] = np.nan
    x[:, n:] = 3.0e38
    v, F = rng.normal(0, 1, (2, 3, n_pad)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (x, v, F))


def _sort_build_edges(dev):
    """K10 at n_pad 1024, 2048 and 4096 (tiles 128 x 256) on tied keys and
    on a NaN live coordinate, nslab 0 and 4, with the whole capacity, a
    capacity of 3 (overflow) and a cutoff over L/2 (the shift latch): equal
    bit for bit to the plain version, to a repeat, and to the network's and
    the build's replicas.  Returns the number of cases."""
    import torch

    from chiron_tpu_torch.ops import lj_cull as lc
    from chiron_tpu_torch.ops import sortbuild as sb

    box = torch.full((3,), 5.8, device=dev)
    tm, tn, cases = 128, 256, 0
    for n_pad in (1024, 2048, 4096):
        n = n_pad - 96
        full = (n_pad // tm) * (n_pad // tn)
        for kind in ("ties", "nan"):
            x, v, F = _listbuild_state(dev, n, n_pad, kind)
            for nslab in (0, 4):
                perm, _ = _network_replica(
                    lc.slab_y_key(x, n, nslab, box[0], Ly=box[1]))
                for cutoff, cap in ((1.02, full), (1.02, 3), (2.9, full)):
                    a = (x, v, F, box, n, tm, tn, nslab, cutoff, SLACK, cap)
                    ko, again = sb.sort_build(*a), sb.sort_build(*a)
                    po = sb.sort_build_plain(*a)
                    rep = _list_replica(x[:, perm], n, tm, tn, box, cutoff,
                                        SLACK, cap)
                    ok = all(_same(k, p) and _same(k, q) and _same(k, t[:, perm])
                             for k, p, q, t in zip(ko[:3], po[:3], again[:3],
                                                   (x, v, F)))
                    ok = ok and all(
                        _same(getattr(ko[3], f), getattr(o, f))
                        for o in (po[3], again[3], rep)
                        for f in lc.TilePairList._fields)
                    _require(ok and (cap == full and cutoff < 2
                                     or bool(ko[3].overflowed)),
                             f"K10 at n_pad {n_pad} ({kind}, nslab {nslab}, "
                             f"cutoff {cutoff}, capacity {cap}) differs")
                    cases += 1
    return cases


def _tile_build_8192(dev, common):
    """K11's build at n_pad 8192 (N=8000, tiles 128 x 256: 64 x 32 = 2048
    pairs, two passes), on the runner's sorted layout and shuffled (every
    kept rectangle over the shift bound), at its capacity and at 20: equal
    bit for bit to build_tile_pairs, to a repeat and to the build's
    replica.  Returns (n_pad, the sorted layout's count, capacity)."""
    import numpy as np
    import torch

    from chiron_tpu_torch import units
    from chiron_tpu_torch.ops import lj_cull as lc
    from chiron_tpu_torch.ops import lj_mega as lm
    from chiron_tpu_torch.runtime import make_culled_lj_runner
    from chiron_tpu_torch.testsystems import LennardJonesFluid

    n = 8000
    fluid = LennardJonesFluid(nparticles=n, reduced_density=DENSITY)
    box = fluid.box_vectors.value_in_unit_system(units.md_unit_system)
    pos = fluid.positions.value_in_unit_system(units.md_unit_system)
    rng = np.random.default_rng(SEED)
    pos = ((pos + rng.normal(0, 0.01, pos.shape)) % box[0, 0]).astype(
        np.float32)
    kw = {**common, "potential": fluid.potential, "n_particles": n,
          "topology": fluid.topology}
    runner = make_culled_lj_runner(slack=SLACK, segment_steps=SEGMENT,
                                   sort_mode="x", megakernel=True, **kw)
    c0 = runner.init(pos, box, seed=SEED)
    md = runner.md
    _require((md.n_pad, md.tm, md.tn) == (8192, 128, 256),
             f"n_pad {md.n_pad}, tiles {md.tm} x {md.tn}")
    g = torch.Generator(device=dev).manual_seed(SEED)
    perm = torch.cat([torch.randperm(n, generator=g, device=dev),
                      torch.arange(n, md.n_pad, device=dev)])
    b = c0.box_diag[0]
    for x in (c0.x, c0.x[:, perm].contiguous()):
        for cap in (runner.capacity, 20):
            a = (x, n, md.tm, md.tn, b, md.cutoff, md.slack, cap)
            kt, again = lm.tile_build(*a), lm.tile_build(*a)
            want = (lc.build_tile_pairs(*a), again, _list_replica(*a))
            _require(all(_same(getattr(kt, f), getattr(o, f)) for o in want
                         for f in lc.TilePairList._fields),
                     f"tile_build at n_pad 8192 (capacity {cap}) differs")
    return md.n_pad, int(lc.build_tile_pairs(
        c0.x, n, md.tm, md.tn, b, md.cutoff, md.slack,
        runner.capacity).count), runner.capacity


def _phase10(dev, common, fluid, st, runner, results, smi, t_kin):
    """[10] K9, K10 and K11, each against its plain version and on its path,
    from phase 5's melted state ``st``; adds their rows to ``results`` and
    returns the three paths' launch counts."""
    import torch

    from chiron_tpu_torch import units
    from chiron_tpu_torch.ops import _build
    from chiron_tpu_torch.ops import lj_cull as lc
    from chiron_tpu_torch.ops import lj_mega as lm
    from chiron_tpu_torch.ops import sortbuild as sb
    from chiron_tpu_torch.ops.lj_dense import LJDense, lj_dense_force_energy
    from chiron_tpu_torch.ops.lj_md_fused import (
        FusedLJMD,
        fused_md,
        fused_md_plain,
    )
    from chiron_tpu_torch.oracles import lj_dense_oracle
    from chiron_tpu_torch.runtime import _md_constants, make_culled_lj_runner

    pot = fluid.potential
    sig, eps, cut = pot.sigma, pot.epsilon, pot.cutoff
    box = fluid.box_vectors.value_in_unit_system(units.md_unit_system)
    box_diag = st.box_diag
    box1 = box_diag.reshape(3).contiguous()
    L = float(box1[0])
    melt = runner.positions(st)
    x5, v5, F5 = st.x, st.v, st.F
    n_pad = x5.shape[1]
    lane_bytes = 3 * n_pad * 4
    counts = {}

    def oracle_rel(energy, pos):
        _, e64 = lj_dense_oracle(pos.double(),
                                 torch.as_tensor(box, device=dev).double(),
                                 sig, eps, cut)
        return abs(energy - float(e64)) / abs(float(e64))

    def check_t(v, what):
        t = t_kin(v)
        _require(abs(t - T_KELVIN) / T_KELVIN < 0.05, f"{what} T_kin {t}")
        return t

    # ---- (a) K9: FusedLJMD ----
    kT, dt, gamma = _md_constants(common["temperature"], common["timestep"],
                                  1.0 / units.picoseconds)
    md9 = FusedLJMD(N, sig, eps, cut, fluid.topology.masses(), dt, gamma, kT,
                    device=dev)
    _require(md9.n_pad == n_pad, f"FusedLJMD n_pad {md9.n_pad}")
    F9, _ = lj_dense_force_energy(x5, box_diag, N, sig, eps, cut,
                                  approx_recip=True, with_energy=False)
    w9 = v5 - (0.5 * dt) * F9 * md9.minv
    lj = (sig, eps, cut, md9.dt, md9.a, md9.b)

    def k9(fn, steps, offset=0):
        return fn(x5, w9, F9, box1, md9.minv, md9.sigv, SEED, offset, N,
                  steps, *lj)

    k1, p1 = k9(fused_md, 1), k9(fused_md_plain, 1)
    scale = float(p1[2].abs().max())
    err_f = float((k1[2] - p1[2]).abs().max()) / scale
    k3, p3 = k9(fused_md, 3), k9(fused_md_plain, 3)
    err_x = float((k3[0] - p3[0]).abs().max())
    err_w = float((k3[1] - p3[1]).abs().max())
    _require(err_f < 1e-4 and err_x < 1e-5,
             f"K9 F rel err {err_f} after 1 step, x err {err_x} after 3")
    again = k9(fused_md, 3)
    _require(all(torch.equal(a, b) for a, b in zip(k3, again)),
             "a repeated fused_md run differs")
    in_cut = _pairs_in_cutoff(x5, box_diag, N, cut)
    ms = _cuda_ms(lambda: k9(fused_md, FUSED_SEGMENT), reps=5)
    plain_ms = _cuda_ms(lambda: k9(fused_md_plain, FUSED_SEGMENT), reps=1)
    # the call's function: S steps of the pair work and the update, reading
    # x, w, F, 1/m, sigma_v and the box once and writing x, w, F once
    bound_ms, bound_by = _bound(
        FUSED_SEGMENT * (N * (N - 1) // 2 * TEST_FLOPS["lj_dense"]
                         + in_cut * LJ_FLOPS
                         + 3 * n_pad * LANE_FLOPS["fused_update"]),
        6 * lane_bytes + 2 * n_pad * 4 + 12)
    print(f"[10] (a) K9: fused_md F rel err {err_f:.3e} after 1 step "
          f"(tolerance 1e-4), x err {err_x:.3e} (1e-5), w err {err_w:.3e} "
          f"after 3; a repeated run is bitwise equal")
    _report(f"fused_md ({FUSED_SEGMENT} steps a call)", max(err_x, err_w),
            "x 1e-5", ms, plain_ms)
    print(f"    bound {bound_ms * 1e3:.3f} us ({bound_by}; {in_cut} pairs "
          f"within the cutoff a step; {smi})")
    results["fused_md"] = dict(
        source="chiron_tpu_torch/csrc/lj_md_fused.cu",
        replaces="chiron_tpu/ops/lj_md_fused.py:212",
        max_abs_err=max(err_x, err_w), ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by)

    _build.reset_launch_counts()
    x, v, F = x5, v5, F9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(0, FUSED_STEPS, FUSED_SEGMENT):
        x, v, F = md9.run(x, v, F, box_diag, SEED, FUSED_SEGMENT,
                          step_offset=k)
    torch.cuda.synchronize()
    fused_rate = FUSED_STEPS / (time.perf_counter() - t0)
    dense = LJDense(N, sig, eps, cut, n_pad=n_pad, device=dev)
    energy = float(dense.force_energy_t(x, box_diag)[1])
    counts["fused"] = dict(_build.launches)
    e_rel = oracle_rel(energy, x[:, :N].T)
    _require(math.isfinite(energy) and e_rel < 1e-5,
             f"fused energy {energy}, rel err vs f64 oracle {e_rel}")
    t9 = check_t(v[:, :N].T, "fused")
    print(f"    fused path: {FUSED_STEPS} steps in calls of {FUSED_SEGMENT} "
          f"with step_offset: energy {energy:.6f} kJ/mol (f64 oracle rel "
          f"{e_rel:.2e}), T_kin {t9:.3f} K, launches {counts['fused']}; "
          f"{fused_rate:.1f} steps/s (N={N}, {smi})")

    # ---- (b) K10: sort_build and the fused_rebuild runner ----
    rb = make_culled_lj_runner(slack=SLACK, segment_steps=SEGMENT,
                               fused_rebuild=True, **common)
    _require(rb.path == "fused_rebuild", f"fused_rebuild path {rb.path}")
    rb.init(melt, box, seed=SEED)
    tm, tn, cap = rb.md.tm, rb.md.tn, rb.capacity
    for nslab, capacity in ((0, cap), (4, (n_pad // tm) * (n_pad // tn))):
        a = (x5, v5, F5, box1, N, tm, tn, nslab, cut, SLACK, capacity)
        ko, po = sb.sort_build(*a), sb.sort_build_plain(*a)
        same = [torch.equal(p, q) for p, q in zip(ko[:3], po[:3])]
        same += [torch.equal(getattr(ko[3], f), getattr(po[3], f))
                 for f in lc.TilePairList._fields]
        _require(all(same), f"sort_build nslab {nslab} differs from plain: "
                            f"{same}")
        print(f"    (b) K10 sort_build nslab {nslab}: x', v', F' and the list "
              f"(count {int(ko[3].count)}, capacity {capacity}, overflowed "
              f"{bool(ko[3].overflowed)}) bitwise equal to plain")
    key = lc.slab_y_key(x5, N, 0, box1[0], Ly=box1[1])
    perm, routes = _network_replica(key)
    _require(torch.equal(sb.sort_build(x5, v5, F5, box1, N, tm, tn, 0, cut,
                                       SLACK, cap)[0], x5[:, perm]),
             "K10's x' is not the network replica's permutation")
    print(f"        its network ({SORT_LANES} lanes a thread, stages "
          f"{routes}) is the replica's permutation; "
          f"{_sort_build_edges(dev)} edge cases (n_pad 1024, 2048 and "
          f"4096; tied keys or a NaN live coordinate; nslab 0 and 4; the "
          f"whole capacity, an overflow, the shift latch) bitwise equal to "
          f"plain, to a repeat and to the replicas")
    a = (x5, v5, F5, box1, N, tm, tn, 0, cut, SLACK, cap)
    ms = _cuda_ms(lambda: sb.sort_build(*a))
    plain_ms = _cuda_ms(lambda: sb.sort_build_plain(*a), reps=5)
    nr = n_pad // tm
    list_bytes = 4 * (3 * cap + 2 * nr + 1 + nr + 1) + 1
    bound_ms, bound_by = _bound(0, 2 * 3 * lane_bytes + 12 + list_bytes)
    _report("sort_build (bitwise)", 0.0, "equal", ms, plain_ms)
    sort_ms = _cuda_ms(lambda: torch.sort(key, stable=True))
    print(f"    bound {bound_ms * 1e3:.3f} us ({bound_by}; {smi}); torch.sort "
          f"(stable) of the same {n_pad} keys {sort_ms:.4f} ms, a yardstick "
          f"of the sort phase only: no PyTorch call computes K10's function")
    results["sort_build"] = dict(
        source="chiron_tpu_torch/csrc/sortbuild.cu",
        replaces="chiron_tpu/ops/sortbuild.py:351", max_abs_err=0.0, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)

    _build.reset_launch_counts()
    s = rb.init(melt, box, seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = rb.run(s, CULLED_STEPS)
    torch.cuda.synchronize()
    rebuild_rate = CULLED_STEPS / (time.perf_counter() - t0)
    rb.check(s)
    energy = float(rb.energy(s))
    counts["fused_rebuild"] = dict(_build.launches)
    e_rel = oracle_rel(energy, rb.positions(s))
    _require(math.isfinite(energy) and e_rel < 1e-5,
             f"fused_rebuild energy {energy}, rel err {e_rel}")
    tb = check_t(rb.velocities(s), "fused_rebuild")
    print(f"    fused_rebuild path (S={SEGMENT}, slack {SLACK}, path "
          f"{rb.path}): check() passed, energy {energy:.6f} kJ/mol (f64 "
          f"oracle rel {e_rel:.2e}), T_kin {tb:.3f} K, launches "
          f"{counts['fused_rebuild']}; {rebuild_rate:.1f} steps/s (N={N}, "
          f"{smi})")

    # ---- (c) K11: tile_build, mega_repair, mega_segment, the runner ----
    rm = make_culled_lj_runner(slack=SLACK, segment_steps=SEGMENT,
                               sort_mode="x", megakernel=True, **common)
    s0 = rm.init(melt, box, seed=SEED)
    md, cap = rm.md, rm.capacity
    kt = lm.tile_build(x5, N, md.tm, md.tn, box1, md.cutoff, md.slack, cap)
    pt = lc.build_tile_pairs(x5, N, md.tm, md.tn, box1, md.cutoff, md.slack,
                             cap)
    same = [torch.equal(getattr(kt, f), getattr(pt, f))
            for f in lc.TilePairList._fields]
    geometry = {}
    for passes in (1, REPAIR_PASSES, DEEP_REPAIR):
        kr = lm.mega_repair(x5, v5, F5, N, box1, passes)
        pr = lm.repair_plain(x5, v5, F5, N, box1, passes)
        chunk, blocks, window = geometry[passes] = _repair_geometry(
            n_pad, passes)
        rr = _repair_windows(x5, v5, F5, N, box1, passes, chunk)
        same += [torch.equal(p, q) and torch.equal(p, r)
                 for p, q, r in zip(kr, pr, rr)]
    kr = lm.mega_repair(x5, v5, F5, N, box1, REPAIR_PASSES)
    _require(all(same), f"tile_build / mega_repair differ from plain: {same}")
    moved = int((kr[0] != x5).any(dim=0).sum())
    ms = _cuda_ms(lambda: lm.tile_build(x5, N, md.tm, md.tn, box1, md.cutoff,
                                        md.slack, cap))
    plain_ms = _cuda_ms(lambda: lc.build_tile_pairs(
        x5, N, md.tm, md.tn, box1, md.cutoff, md.slack, cap), reps=5)
    nr = n_pad // md.tm
    list_bytes = 4 * (3 * cap + 2 * nr + 1 + nr + 1) + 1
    bound_ms, bound_by = _bound(0, lane_bytes + 12 + list_bytes)
    _report("tile_build (bitwise)", 0.0, "equal", ms, plain_ms)
    n8, count8, cap8 = _tile_build_8192(dev, common)
    print(f"    bound {bound_ms * 1e3:.3f} us ({bound_by}; {smi}); at n_pad "
          f"{n8} (count {count8}, capacity {cap8}; sorted and shuffled, two "
          f"capacities) bitwise equal to plain, to a repeat and to the "
          f"build's replica")
    results["tile_build"] = dict(
        source="chiron_tpu_torch/csrc/lj_mega.cu",
        replaces="chiron_tpu/ops/lj_mega.py:368", max_abs_err=0.0, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    ms = _cuda_ms(lambda: lm.mega_repair(x5, v5, F5, N, box1, REPAIR_PASSES))
    deep_ms = _cuda_ms(lambda: lm.mega_repair(x5, v5, F5, N, box1,
                                              DEEP_REPAIR))
    plain_ms = _cuda_ms(lambda: lm.repair_plain(x5, v5, F5, N, box1,
                                                REPAIR_PASSES), reps=5)
    # reads and writes the nine (x, w, F) rows once
    bound_ms, bound_by = _bound(0, 2 * 3 * lane_bytes + 12)
    _report(f"mega_repair (P={REPAIR_PASSES}, bitwise; chunk, blocks, window "
            f"{geometry[REPAIR_PASSES]}; at P={DEEP_REPAIR} "
            f"{geometry[DEEP_REPAIR]} {deep_ms:.4f} ms)", 0.0, "equal", ms,
            plain_ms)
    print(f"    bound {bound_ms * 1e3:.3f} us ({bound_by}; {smi})")
    results["mega_repair"] = dict(
        source="chiron_tpu_torch/csrc/lj_mega.cu",
        replaces="chiron_tpu/ops/lj_mega.py:368", max_abs_err=0.0, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    # P = 0 from the freshly sorted init state: the classic kernel path
    half = 0.5 * md.dt
    xs, vs, Fs = s0.x, s0.v, s0.F
    ws = vs - half * Fs * md.minv
    pairs = md.build_pairs(xs, box_diag[0], cap)
    xc, vc, Fc, stale = md.run_segment(
        xs, vs, Fs, box_diag, pairs, seed=SEED, step_offset=s0.step,
        n_steps=SEGMENT, drift_slack=md.slack_t)
    work = lm.MegaWorkspace(md, cap)

    def mega(passes, steps=SEGMENT, approx=True):
        return lm.mega_segment(md, xs, ws, Fs, box_diag, cap, SEED, s0.step,
                               steps, passes, approx_recip=approx,
                               workspace=work)

    m0, m16 = mega(0), mega(REPAIR_PASSES)
    _require(torch.equal(m0[0], xc) and torch.equal(m0[2], Fc)
             and torch.equal(m0[1] + half * m0[2] * md.minv, vc)
             and bool(m0[3]) == bool(stale),
             "the P=0 megakernel segment differs from the classic path")
    import numpy as np

    _require(all(torch.equal(p[:, N:], q[:, N:]) for p, q in zip(m0[:3], m16[:3]))
             and np.array_equal(_canon(*m0[:3], N), _canon(*m16[:3], N)),
             "the P=16 segment is not a permutation of the P=0 one")
    k5 = mega(0, 5, False)
    p5 = lm.mega_segment_plain(md, xs, ws, Fs, box_diag, cap, SEED,
                               int(s0.step), 5, 0)
    err_x = float((k5[0] - p5[0]).abs().max())
    err_w = float((k5[1] - p5[1]).abs().max())
    _require(err_x < 1e-5 and err_w < 1e-4 and bool(k5[3]) == bool(p5[3]),
             f"mega_md vs plain over 5 steps: x err {err_x}, w err {err_w}")
    print(f"    (c) K11: tile_build and mega_repair (1, {REPAIR_PASSES} and "
          f"{DEEP_REPAIR} passes, {moved} lanes moved at {REPAIR_PASSES}) "
          f"bitwise equal to plain and to the windowed replica; a P=0 segment "
          f"(S={SEGMENT}) from the sorted init state equals the classic "
          f"kernel path bit for bit; P={REPAIR_PASSES} is a permutation of "
          f"it with the padding unmoved; 5 steps (exact reciprocal, P=0) x "
          f"err {err_x:.3e} (1e-5), w err {err_w:.3e} (1e-4)")
    ms = _cuda_ms(lambda: mega(REPAIR_PASSES), reps=10)
    plain_ms = _cuda_ms(lambda: lm.mega_segment_plain(
        md, xs, ws, Fs, box_diag, cap, SEED, int(s0.step), SEGMENT,
        REPAIR_PASSES), reps=1)
    count = int(pairs.count)
    in_cut = _pairs_in_cutoff(xs, box_diag, N, cut)
    # one bound over the segment's totals: its steps' operations, the
    # latch's and the repair's; its inputs read once (x, w, F, 1/m,
    # sigma_v, the box, the step, the slack) and outputs written once (x,
    # w, F, the flag); the list lives and dies inside the segment
    bound_ms, bound_by = _bound(
        _segment_flops(count * md.tm * md.tn, in_cut, n_pad)
        + REPAIR_PASSES * (N // 2) * REPAIR_FLOPS,
        6 * lane_bytes + 2 * n_pad * 4 + 21)
    _report(f"mega_md (S={SEGMENT}, P={REPAIR_PASSES} a call; error over 5 "
            f"steps)", max(err_x, err_w), "x 1e-5", ms, plain_ms)
    print(f"    bound {bound_ms * 1e3:.3f} us ({bound_by}: {SEGMENT} x K3's "
          f"step on {count} entries and {in_cut} pairs within the cutoff, "
          f"the latch and {REPAIR_PASSES} repair passes; {smi})")
    results["mega_md"] = dict(
        source="chiron_tpu_torch/csrc/lj_mega.cu",
        replaces="chiron_tpu/ops/lj_mega.py:368",
        max_abs_err=max(err_x, err_w), ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by)

    def in_order(carry):
        d = carry.x[0, 1:N] - carry.x[0, :N - 1]
        d = d - L * torch.round(d / L)
        return float((d >= 0).double().mean())

    _build.reset_launch_counts()
    s = rm.init(melt, box, seed=SEED)
    s = rm.run(s, SEGMENT)
    first = in_order(s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = rm.run(s, CULLED_STEPS - SEGMENT)
    torch.cuda.synchronize()
    mega_rate = (CULLED_STEPS - SEGMENT) / (time.perf_counter() - t0)
    rm.check(s)
    energy = float(rm.energy(s))
    counts["mega"] = dict(_build.launches)
    e_rel = oracle_rel(energy, rm.positions(s))
    _require(math.isfinite(energy) and e_rel < 1e-5,
             f"megakernel energy {energy}, rel err {e_rel}")
    tm_ = check_t(rm.velocities(s), "megakernel")
    last = in_order(s)
    # a segment moves a particle about 9 mean x gaps here, more than P = 16
    # passes undo: the repair holds a steady local order, it does not sort
    _require(last > 0.5 and last > first - 0.05,
             f"megakernel order: {first} after one segment, {last} at the end")
    print(f"    megakernel path (pure x, S={SEGMENT}, slack {SLACK}, "
          f"P={rm.repair_passes}): check() passed, energy {energy:.6f} kJ/mol "
          f"(f64 oracle rel {e_rel:.2e}), T_kin {tm_:.3f} K, neighbouring "
          f"live lanes in cyclic order {first:.4f} after one segment and "
          f"{last:.4f} at the end, launches {counts['mega']}; "
          f"{mega_rate:.1f} steps/s over the last {CULLED_STEPS - SEGMENT} "
          f"steps (N={N}, {smi})")
    deep = make_culled_lj_runner(slack=SLACK, segment_steps=SEGMENT,
                                 sort_mode="x", megakernel=True,
                                 repair_passes=DEEP_REPAIR, **common)
    s = deep.run(deep.init(melt, box, seed=SEED), DEEP_STEPS)
    deep.check(s)
    deep_order = in_order(s)
    _require(deep_order > 0.95, f"P={DEEP_REPAIR} order {deep_order}")
    print(f"    with P={DEEP_REPAIR} passes, {DEEP_STEPS} steps: check() "
          f"passed, {deep_order:.4f} of neighbouring live lanes in cyclic "
          f"order")
    return counts


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chiron_tpu_torch import units
    from chiron_tpu_torch.ops import _build
    from chiron_tpu_torch.ops import lj_band as lb
    from chiron_tpu_torch.ops import lj_cull as lc
    from chiron_tpu_torch.ops import lj_strip as ls
    from chiron_tpu_torch.ops.lj_dense import lj_dense_force_energy, lj_dense_plain
    from chiron_tpu_torch.oracles import lj_dense_oracle
    from chiron_tpu_torch.parallel import spatial as sp
    from chiron_tpu_torch.parallel import distributed as pdist
    from chiron_tpu_torch.parallel import (
        make_replica_mesh,
        make_sharded_lj_force,
        make_spatial_band_lj_runner,
        make_spatial_lj_runner,
    )
    from chiron_tpu_torch.runtime import (
        BandRunner,
        CulledLJRunner,
        FastLJRunner,
        StripRunner,
        make_culled_lj_runner,
        make_culled_npt_lj_runner,
        make_fast_lj_runner,
        make_lj_runner,
        make_npt_lj_runner,
    )
    from chiron_tpu_torch.testsystems import LennardJonesFluid

    dev = torch.device("cuda")

    # ---- 1. the card and the toolchain ----
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(f"[1] card: {smi}")
    print(f"    python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    print("    " + _run([_build._nvcc(), "--version"]).splitlines()[-1])

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.library()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({_build.build_dir()})")

    fluid = LennardJonesFluid(nparticles=N, reduced_density=DENSITY)
    box = fluid.box_vectors.value_in_unit_system(units.md_unit_system)
    pos0 = fluid.positions.value_in_unit_system(units.md_unit_system)
    pot = fluid.potential
    common = dict(potential=pot, n_particles=N, topology=fluid.topology,
                  temperature=T_KELVIN * units.kelvin,
                  timestep=2.0 * units.femtoseconds, device=dev)

    # ---- 3. each kernel against its plain version ----
    print(f"[3] kernels against their plain versions (melted N={N})")
    fast = make_fast_lj_runner(**common)
    fs = fast.run(fast.init(pos0, box, seed=7), DENSE_STEPS)
    x_melt = fs.x
    box_diag = fs.box_vectors
    sig, eps, cut = pot.sigma, pot.epsilon, pot.cutoff
    results = {}

    # K1: the dense triangle kernel at n_pad = 4096
    in_cut = _pairs_in_cutoff(x_melt, box_diag, N, cut)
    Fp, Ep = lj_dense_plain(x_melt, box_diag, N, sig, eps, cut)
    scale = float(Fp.abs().max())
    Fk, Ek = lj_dense_force_energy(x_melt, box_diag, N, sig, eps, cut,
                                   approx_recip=False)
    Fa, _ = lj_dense_force_energy(x_melt, box_diag, N, sig, eps, cut,
                                  approx_recip=True, with_energy=False)
    err = float((Fk - Fp).abs().max())
    err_a = float((Fa - Fp).abs().max())
    e_rel = abs(float(Ek) - float(Ep)) / abs(float(Ep))
    _require(err / scale < 1e-5, f"K1 exact force rel err {err / scale}")
    _require(err_a / scale < 1e-4, f"K1 approx force rel err {err_a / scale}")
    _require(e_rel < 1e-5, f"K1 energy rel err {e_rel}")
    ms = _cuda_ms(lambda: lj_dense_force_energy(
        x_melt, box_diag, N, sig, eps, cut, approx_recip=True,
        with_energy=False))
    plain_ms = _cuda_ms(lambda: lj_dense_plain(
        x_melt, box_diag, N, sig, eps, cut, with_energy=False), reps=5)
    print(f"  lj_dense approx-recip force rel err {err_a / scale:.3e} "
          f"(tolerance 1e-4), energy rel err {e_rel:.3e} (tolerance 1e-5)")
    _report("lj_dense (exact force vs plain, rel tol 1e-5)", err, "1e-5 rel",
            ms, plain_ms)
    n_pad = x_melt.shape[1]
    lane_bytes = 3 * n_pad * 4  # one (3, n_pad) f32 array
    tested = N * (N - 1) // 2
    bound_ms, bound_by = _bound(
        tested * TEST_FLOPS["lj_dense"] + in_cut * LJ_FLOPS,
        2 * lane_bytes + 12)
    print(f"    pairs: {tested} distance tests, {in_cut} within the cutoff; "
          f"bound {bound_ms * 1e3:.3f} us ({bound_by})")
    results["lj_dense"] = dict(
        source="chiron_tpu_torch/csrc/lj_dense.cu",
        replaces="chiron_tpu/ops/lj_dense.py:340", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)

    # K4 and K3's force phase: the culled force on the production list
    runner = make_culled_lj_runner(slack=SLACK, segment_steps=SEGMENT,
                                   **common)
    c0 = runner.init(fast.positions(fs), box, seed=7)
    md = runner.md
    pairs = c0.pairs
    print(f"    culled list: nslab={runner.nslab} capacity={runner.capacity} "
          f"count={int(pairs.count)} (tm={md.tm}, tn={md.tn}, "
          f"n_pad={md.n_pad})")

    def cforce(approx, energy=False):
        return lc.culled_force_pass(c0.x, box_diag, pairs, N, md.tm, md.tn,
                                    sig, eps, cut, approx, energy)

    Fp, Ep = lc.row_force_pass_plain(c0.x, box_diag, pairs, N, md.tm, md.tn,
                                     sig, eps, cut, with_energy=True)
    Fk, Ek = cforce(False, True)
    Fa, _ = cforce(True)
    scale = float(Fp.abs().max())
    diff = (Fk - Fp)[:, :N].abs()
    err = float(diff.max())
    p99 = float(torch.quantile(diff.flatten(), 0.99)) / scale
    err_a = float((Fa - Fk).abs().max()) / scale
    e_rel = abs(float(Ek) - float(Ep)) / abs(float(Ep))
    _require(err < 0.05 and p99 < 1e-5, f"culled force err {err}, p99 {p99}")
    _require(float(Fk[:, N:].abs().max()) == 0.0, "culled force padding")
    _require(err_a < 1e-4, f"culled approx vs exact rel err {err_a}")
    _require(e_rel < 1e-5, f"culled energy rel err {e_rel}")
    ms = _cuda_ms(lambda: cforce(True))
    plain_ms = _cuda_ms(lambda: lc.row_force_pass_plain(
        c0.x, box_diag, pairs, N, md.tm, md.tn, sig, eps, cut), reps=5)
    print(f"  culled_force p99 rel err {p99:.3e} (tolerance 1e-5), approx vs "
          f"exact rel {err_a:.3e} (1e-4), energy rel {e_rel:.3e} (1e-5)")
    _report("culled_force (exact vs plain, max abs tol 0.05)", err, 0.05, ms,
            plain_ms)
    count = int(pairs.count)
    listed = count * md.tm * md.tn
    in_cut = _pairs_in_cutoff(c0.x, box_diag, N, cut)
    nr = n_pad // md.tm
    list_bytes = 4 * (2 * count + 2 * nr + 2) + 12  # cols, ccx, ptr2, ...
    bound_ms, bound_by = _bound(
        listed * TEST_FLOPS["culled"] + in_cut * LJ_FLOPS,
        2 * lane_bytes + list_bytes)
    print(f"    pairs: {listed} distance tests on the list ({count} entries "
          f"x {md.tm} x {md.tn}), {in_cut} within the cutoff; bound "
          f"{bound_ms * 1e3:.3f} us ({bound_by})")
    results["culled_force"] = dict(
        source="chiron_tpu_torch/csrc/lj_cull_force.cu",
        replaces="chiron_tpu/ops/lj_cull.py:700", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)

    # K5: the culled force and energy, exact reciprocal
    def k5():
        return lc.culled_force_energy(c0.x, box_diag, pairs, N, md.tm, md.tn,
                                      sig, eps, cut)

    F5, E5 = k5()
    diff = (F5 - Fp)[:, :N].abs()
    err = float(diff.max())
    p99 = float(torch.quantile(diff.flatten(), 0.99)) / scale
    e_rel = abs(float(E5) - float(Ep)) / abs(float(Ep))
    box33 = torch.diag(box_diag.reshape(3)).double()
    _, e_oracle = lj_dense_oracle(c0.x[:, :N].T.double(), box33, sig, eps,
                                  cut)
    e_rel_oracle = abs(float(E5) - float(e_oracle)) / abs(float(e_oracle))
    _require(err < 0.05 and p99 < 1e-5, f"K5 force err {err}, p99 {p99}")
    _require(e_rel < 1e-5 and e_rel_oracle < 1e-5,
             f"K5 energy rel err {e_rel} (plain), {e_rel_oracle} (oracle)")
    # K3's final_energy step: approximate force, K5's energy, bit for bit
    F_mix, E_mix = cforce(True, True)
    _require(torch.equal(F_mix, Fa), "exact-energy step force != approx pass")
    _require(torch.equal(E_mix, E5), "exact-energy step energy != K5 energy")
    ms = _cuda_ms(k5)
    mix_ms = _cuda_ms(lambda: cforce(True, True))
    plain_ms = _cuda_ms(lambda: lc.row_force_pass_plain(
        c0.x, box_diag, pairs, N, md.tm, md.tn, sig, eps, cut,
        with_energy=True), reps=5)
    print(f"  culled_force_energy p99 rel err {p99:.3e} (tolerance 1e-5), "
          f"energy rel {e_rel:.3e} to plain and {e_rel_oracle:.3e} to the "
          f"f64 oracle (1e-5); exact-energy step: force equal to the approx "
          f"pass and energy equal to K5, bit for bit ({mix_ms:.4f} ms)")
    _report("culled_force_energy (K5 vs plain, max abs tol 0.05)", err, 0.05,
            ms, plain_ms)
    bound_ms, bound_by = _bound(
        listed * TEST_FLOPS["culled"] + in_cut * (LJ_FLOPS + ENERGY_FLOPS),
        2 * lane_bytes + list_bytes + 4)
    print(f"    pairs: {listed} distance tests on the list, {in_cut} within "
          f"the cutoff; bound {bound_ms * 1e3:.3f} us ({bound_by})")
    results["culled_force_energy"] = dict(
        source="chiron_tpu_torch/csrc/lj_cull_force.cu",
        replaces="chiron_tpu/ops/lj_cull.py:766", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)

    # the culled runner at its widest row tile
    r256 = make_culled_lj_runner(slack=SLACK, segment_steps=SEGMENT,
                                 tm=TM_WIDE, **common)
    c256 = r256.init(fast.positions(fs), box, seed=7)
    a256 = (c256.x, box_diag, c256.pairs, N, TM_WIDE, r256.md.tn, sig, eps,
            cut)
    Fp, Ep = lc.row_force_pass_plain(*a256, with_energy=True)
    Fk, Ek = lc.culled_force_energy(*a256)
    diff = (Fk - Fp)[:, :N].abs()
    err = float(diff.max())
    p99 = float(torch.quantile(diff.flatten(), 0.99)) / float(Fp.abs().max())
    e_rel = abs(float(Ek) - float(Ep)) / abs(float(Ep))
    _require(err < 0.05 and p99 < 1e-5 and e_rel < 1e-5,
             f"tm={TM_WIDE} culled force err {err}, p99 {p99}, energy {e_rel}")
    s256 = r256.run(c256, WIDE_STEPS)
    r256.check(s256)
    e256 = float(r256.energy(s256))
    _, e64 = lj_dense_oracle(r256.positions(s256).double(),
                             torch.as_tensor(box, device=dev).double(), sig,
                             eps, cut)
    e_rel64 = abs(e256 - float(e64)) / abs(float(e64))
    _require(math.isfinite(e256) and e_rel64 < 1e-5,
             f"tm={TM_WIDE} runner energy {e256}, oracle rel {e_rel64}")
    print(f"  culled runner at tm={TM_WIDE} (count "
          f"{int(c256.pairs.count)}, n_pad {r256.md.n_pad}): K5 vs plain max "
          f"abs {err:.3e} (0.05), p99 rel {p99:.3e} (1e-5), energy rel "
          f"{e_rel:.3e} (1e-5); {WIDE_STEPS} steps check() passed, energy "
          f"{e256:.6f} kJ/mol (f64 oracle rel {e_rel64:.2e})")

    # K3's BAOAB phase, in place on copies of the carry
    w0 = c0.v - (0.5 * md.dt) * c0.F * md.minv
    state_k = [c0.x.clone(), w0.clone(), c0.F.clone()]
    lc.baoab_phase_(*state_k, md.minv, md.sigv, box_diag, SEED, c0.step, 3,
                    md.dt, md.a, md.b)
    xp, wp, Fz = lc.baoab_phase_plain(c0.x, w0, c0.F, md.minv, md.sigv,
                                      box_diag, SEED, 3, md.dt, md.a, md.b)
    ex = float((state_k[0] - xp).abs().max())
    ew = float((state_k[1] - wp).abs().max())
    _require(ex < 1e-5 and ew < 1e-4, f"baoab x err {ex}, v err {ew}")
    _require(float(state_k[2].abs().max()) == 0.0 and float(Fz.abs().max()) == 0.0,
             "baoab F reset")
    ms = _cuda_ms(lambda: lc.baoab_phase_(
        *state_k, md.minv, md.sigv, box_diag, SEED, c0.step, 3, md.dt, md.a,
        md.b))
    plain_ms = _cuda_ms(lambda: lc.baoab_phase_plain(
        c0.x, w0, c0.F, md.minv, md.sigv, box_diag, SEED, 3, md.dt, md.a,
        md.b))
    print(f"  baoab position err {ex:.3e} (tolerance 1e-5)")
    _report("baoab (velocity vs plain, tol 1e-4)", ew, 1e-4, ms, plain_ms)
    # reads x, w, F, 1/m, sigma_v, box, step; writes x, w, F
    bound_ms, bound_by = _bound(3 * n_pad * LANE_FLOPS["baoab"],
                                6 * lane_bytes + 2 * n_pad * 4 + 16)
    results["baoab"] = dict(
        source="chiron_tpu_torch/csrc/baoab.cu",
        replaces="chiron_tpu/ops/lj_cull.py:984", max_abs_err=max(ex, ew),
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)

    # K3's drift latch: a real segment, a forced trip and a NaN, against
    # the engine's slack on the device, as the NVT segment passes it
    c1 = runner.segment_fn(SEGMENT)(c0)
    slack_t = md.slack_t
    x_end, anchor = c1.x, c1.x_anchor
    tripped = anchor.clone()
    tripped[0, 10] += 0.6 * SLACK
    tripped[1, 20] -= 0.6 * SLACK
    poisoned = x_end.clone()
    poisoned[2, 5] = float("nan")
    flags = []
    for xx, aa, expect in ((x_end, anchor, None), (x_end, tripped, True),
                           (poisoned, anchor, True)):
        fk = bool(lc.tile_skin_drift_bad(xx, aa, N, slack_t, box_diag))
        fp = bool(lc.tile_skin_drift_bad_plain(xx, aa, N, slack_t, box_diag))
        _require(fk == fp and (expect is None or fk == expect),
                 f"drift latch kernel {fk}, plain {fp}, expected {expect}")
        flags.append(fk)
    latch_scratch = lc.LatchScratch(n_pad, dev)
    ms = _cuda_ms(lambda: lc.tile_skin_drift_bad(x_end, anchor, N, slack_t,
                                                 box_diag, latch_scratch))
    plain_ms = _cuda_ms(lambda: lc.tile_skin_drift_bad_plain(
        x_end, anchor, N, slack_t, box_diag))
    # the NpT mode: the threshold is a budget on the device, set on either
    # side of the measured top-2 drift (1e-3 apart: the card fuses the
    # squares into FMAs, so its drift may differ from the plain one by an
    # ulp), and a NaN
    top2 = float(lc.skin_drift_top2_plain(x_end, anchor, N, box_diag))
    for xx, scale, expect in ((x_end, 0.999, True), (x_end, 1.001, False),
                              (poisoned, 1.001, True)):
        budget = torch.tensor(top2 * scale, device=dev)
        fk = bool(lc.tile_skin_drift_bad(xx, anchor, N, budget, box_diag))
        fp = bool(lc.tile_skin_drift_bad_plain(xx, anchor, N, budget,
                                               box_diag))
        _require(fk == fp == expect,
                 f"budgeted latch kernel {fk}, plain {fp}, expected {expect}")
        flags.append(fk)
    # the kernel's top-2 sum is the plain one's bit for bit: its partials,
    # merged as the kernel's threads fold them (the replica), give the
    # plain sum, and the flag flips exactly there
    _, top2_r = _latch_replica(x_end, anchor, N, slack_t, box_diag,
                               _latch_splits(n_pad))
    top2_t = lc.skin_drift_top2_plain(x_end, anchor, N, box_diag)
    _require(torch.equal(top2_r, top2_t.cpu()),
             f"latch replica {float(top2_r)} vs plain {float(top2_t)}")
    below = torch.nextafter(top2_t, torch.zeros_like(top2_t))
    for thr, expect in ((top2_t, False), (below, True)):
        fk = bool(lc.tile_skin_drift_bad(x_end, anchor, N, thr, box_diag))
        _require(fk == expect, f"latch at the top-2 sum {float(top2_t)!r} "
                               f"and threshold {float(thr)!r}: {fk}")
    _report(f"tile_skin_drift (flags {flags} equal to plain; top-2 drift "
            f"{top2:.6f} nm; threshold at the sum holds and one ulp under "
            f"it latches, as the replica's merge of the kernel's partials "
            f"predicts)", 0.0, "equal", ms, plain_ms)
    bound_ms, bound_by = _bound(n_pad * LANE_FLOPS["tile_skin_drift"],
                                2 * lane_bytes + 20)
    results["tile_skin_drift"] = dict(
        source="chiron_tpu_torch/csrc/drift.cu",
        replaces="chiron_tpu/ops/lj_cull.py:984", max_abs_err=0.0,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)

    # K3's segment: one C call, bit for bit the step-by-step sequence of
    # the same tree's kernels (baoab_phase_ and culled_force_pass S times,
    # then tile_skin_drift_bad) in NVT, with the exact reciprocal, and in
    # NpT (anchor, budget, final energy), and its time against the plain
    # loop
    seg_ws = lc.SegmentWorkspace(md, runner.capacity)
    budget = torch.tensor(0.5 * SLACK, device=dev)
    modes = {"nvt": dict(drift_slack=slack_t),
             "exact": dict(approx_recip=False, drift_slack=slack_t),
             "npt": dict(final_energy=True, drift_anchor=c1.x_anchor,
                         drift_budget=budget)}

    def segment(steps, stepwise=False, x3=c0.x, **kw):
        if stepwise:
            return md.run_segment_stepwise(x3, c0.v, c0.F, box_diag, pairs,
                                           SEED, c0.step, steps, **kw)
        return md.run_segment(x3, c0.v, c0.F, box_diag, pairs, SEED,
                              c0.step, steps, workspace=seg_ws, **kw)

    for mode, kw in modes.items():
        for steps in (1, 2, SEGMENT):
            one, seq = segment(steps, **kw), segment(steps, True, **kw)
            _require(len(one) == len(seq)
                     and all(torch.equal(p, q) for p, q in zip(one, seq)),
                     f"the {mode} segment of {steps} steps differs from the "
                     f"step-by-step sequence")
    poisoned = c0.x.clone()
    poisoned[1, 17] = float("nan")
    one = segment(SEGMENT, x3=poisoned, **modes["nvt"])
    seq = segment(SEGMENT, True, x3=poisoned, **modes["nvt"])
    _require(bool(one[3]) and bool(seq[3]), "a NaN segment did not latch")
    ke = segment(5, approx_recip=False)
    pe = _culled_md_plain(md, c0.x, c0.v, c0.F, box_diag, pairs, SEED, 0, 5)
    err_x = float((ke[0] - pe[0]).abs().max())
    err_v = float((ke[1] - pe[1]).abs().max())
    _require(err_x < 1e-5 and err_v < 1e-4,
             f"culled_md vs plain over 5 steps: x err {err_x}, v err {err_v}")
    ms = _cuda_ms(lambda: segment(SEGMENT, **modes["nvt"]), reps=10)
    step_ms = _cuda_ms(lambda: segment(SEGMENT, True, **modes["nvt"]),
                       reps=10)
    plain_ms = _cuda_ms(lambda: _culled_md_plain(
        md, c0.x, c0.v, c0.F, box_diag, pairs, SEED, 0, SEGMENT, slack_t),
        reps=1)
    # one bound over the segment's totals: S steps' operations and the
    # latch's; its inputs read once (x, v, F, 1/m, sigma_v, the list and
    # the box, the step, the slack; the anchor is the entry x) and outputs
    # written once (x, v, F, the flag)
    bound_ms, bound_by = _bound(
        _segment_flops(listed, in_cut, n_pad),
        6 * lane_bytes + 2 * n_pad * 4 + list_bytes + 9)
    print(f"  culled_md (K3's segment, one C call): bitwise equal to the "
          f"step-by-step sequence at S = 1, 2, {SEGMENT} in NVT, with the "
          f"exact reciprocal and in NpT (anchor, budget {float(budget)}, "
          f"final energy); a NaN latches both; the sequence takes "
          f"{step_ms:.4f} ms a segment")
    _report(f"culled_md (S={SEGMENT} a call; error over 5 steps, exact "
            f"reciprocal)", max(err_x, err_v), "x 1e-5", ms, plain_ms)
    print(f"    bound {bound_ms * 1e3:.3f} us ({bound_by}: {SEGMENT} x K3's "
          f"step on {count} entries and {in_cut} pairs within the cutoff, "
          f"the latch)")
    results["culled_md"] = dict(
        source="chiron_tpu_torch/csrc/lj_cull_force.cu",
        replaces="chiron_tpu/ops/lj_cull.py:984",
        max_abs_err=max(err_x, err_v), ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by)

    # K7: the halo-strip kernels on the strip layout of the melted state
    strip = make_lj_runner(engine="strip", box_vectors=box, **common)
    _require(isinstance(strip, StripRunner), f"strip engine {type(strip)}")
    s0 = strip.init(fast.positions(fs), box, seed=7)
    smd = strip.md
    H, tm = smd.H, smd.tm
    sargs = (s0.x, box_diag, N, tm, H, sig, eps, cut)
    print(f"    strip layout: tm={tm}, H={H}, n_pad={smd.n_pad}, strip width "
          f"{tm + H}")
    Fp, Ep = ls.strip_force_plain(*sargs, with_energy=True)
    Fk, Ek = ls.strip_force_energy(*sargs)
    Fa = ls.strip_force(*sargs, approx_recip=True)
    scale = float(Fp.abs().max())
    diff = (Fk - Fp)[:, :N].abs()
    err = float(diff.max())
    p99 = float(torch.quantile(diff.flatten(), 0.99)) / scale
    err_a = float((Fa - Fk).abs().max()) / scale
    e_rel = abs(float(Ek) - float(Ep)) / abs(float(Ep))
    _, e_k1 = lj_dense_force_energy(
        torch.where(strip.valid, s0.x[:, :n_pad], 0.0), box_diag, N, sig, eps,
        cut)
    e_rel_k1 = abs(float(Ek) - float(e_k1)) / abs(float(e_k1))
    _require(err < 0.05 and p99 < 1e-5, f"K7 force err {err}, p99 {p99}")
    _require(float(Fk[:, N:].abs().max()) == 0.0, "K7 force padding")
    _require(err_a < 1e-4, f"K7 approx vs exact rel err {err_a}")
    _require(e_rel < 1e-5 and e_rel_k1 < 1e-5,
             f"K7 energy rel err {e_rel} (plain), {e_rel_k1} (K1)")
    Fk2, Ek2 = ls.strip_force_energy(*sargs)
    _require(torch.equal(Fk2, Fk) and torch.equal(Ek2, Ek)
             and torch.equal(ls.strip_force(*sargs, approx_recip=True), Fa),
             "K7: a repeated call differs")
    in_cut = _pairs_in_cutoff(s0.x, box_diag, N, cut)
    nr = n_pad // tm
    slots = n_pad * (tm + H) - nr * tm * (tm + 1) // 2
    xe_bytes = 3 * (n_pad + H) * 4
    for name, energy, line in (("strip_force", False, 477),
                               ("strip_force_energy", True, 526)):
        def call(energy=energy):
            if energy:
                return ls.strip_force_energy(*sargs)
            return ls.strip_force(*sargs, approx_recip=True)

        ms = _cuda_ms(call)
        plain_ms = _cuda_ms(lambda energy=energy: ls.strip_force_plain(
            *sargs, with_energy=energy), reps=5)
        bound_ms, bound_by = _bound(
            slots * TEST_FLOPS["strip"]
            + in_cut * (LJ_FLOPS + (ENERGY_FLOPS if energy else 0)),
            xe_bytes + 12 + lane_bytes + (4 if energy else 0))
        _report(f"{name} (exact vs plain, max abs tol 0.05)", err, 0.05, ms,
                plain_ms)
        results[name] = dict(
            source="chiron_tpu_torch/csrc/lj_strip.cu",
            replaces=f"chiron_tpu/ops/lj_strip.py:{line}", max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    print(f"  strip force p99 rel err {p99:.3e} (tolerance 1e-5), approx vs "
          f"exact rel {err_a:.3e} (1e-4), energy rel {e_rel:.3e} to plain "
          f"and {e_rel_k1:.3e} to K1 (1e-5)")
    chunks, skipped, trips, terms = _strip_visits(s0.x, box_diag, tm, H, cut)
    print(f"    pairs: {slots} strip slots ({nr} row tiles x {tm + H} "
          f"columns, less the leading triangles), {in_cut} within the "
          f"cutoff; bound {results['strip_force']['bound_ms'] * 1e3:.3f} us "
          f"({results['strip_force']['bound_by']})")
    print(f"  K7 (torch replica): {chunks} warp chunks of 32 ranks, {skipped} "
          f"beyond the cutoff in x (skipped), {32 * 32 * (chunks - skipped)} "
          f"distance tests; {terms} LJ terms (each pair from both ends, "
          f"padding against padding too) in "
          f"{trips} loop trips, {trips / max(chunks - skipped, 1):.3f} a "
          f"chunk taken")

    # K7's BAOAB phase with the halo refresh, in place on copies
    w0 = s0.v - (0.5 * smd.dt) * s0.F * smd.minv
    box1 = box_diag.reshape(-1)
    xk, wk = s0.x.clone(), w0.clone()

    def strip_phase():
        ls.strip_baoab_(xk, wk, s0.F, smd.minv, smd.sigv, box1, SEED,
                        s0.step, 3, N, H, smd.dt, smd.a, smd.b)

    strip_phase()
    xp, wp = ls.strip_baoab_plain(s0.x, w0, s0.F, smd.minv, smd.sigv, box1,
                                  SEED, 3, N, H, smd.dt, smd.a, smd.b)
    ex = float((xk - xp)[:, :N].abs().max())
    ew = float((wk - wp).abs().max())
    halo_x = float((xk[0, n_pad:] - (xk[0, :H] + box1[0])).abs().max())
    _require(ex < 1e-5 and ew < 1e-4, f"strip baoab x err {ex}, v err {ew}")
    _require(halo_x < 1e-4 and torch.equal(xk[1:, n_pad:], xk[1:, :H]),
             f"strip halo is not the shifted center ({halo_x})")
    ms = _cuda_ms(strip_phase)
    plain_ms = _cuda_ms(lambda: ls.strip_baoab_plain(
        s0.x, w0, s0.F, smd.minv, smd.sigv, box1, SEED, 3, N, H, smd.dt,
        smd.a, smd.b))
    print(f"  strip_baoab position err {ex:.3e} (tolerance 1e-5), halo equal "
          f"to the shifted center ({halo_x:.1e} on x)")
    _report("strip_baoab (velocity vs plain, tol 1e-4)", ew, 1e-4, ms,
            plain_ms)
    # reads x, w, F, 1/m, sigma_v, box, step; writes x with its halo, w
    bound_ms, bound_by = _bound(3 * n_pad * LANE_FLOPS["baoab"],
                                4 * lane_bytes + 2 * n_pad * 4 + 16
                                + xe_bytes)
    results["strip_baoab"] = dict(
        source="chiron_tpu_torch/csrc/lj_strip.cu",
        replaces="chiron_tpu/ops/lj_strip.py:308", max_abs_err=max(ex, ew),
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)

    # ---- 4. determinism ----
    seg = runner.segment_fn(SEGMENT)
    a, b = seg(c0), seg(c0)
    for name in ("x", "v", "F", "overflowed"):
        _require(torch.equal(getattr(a, name), getattr(b, name)),
                 f"repeated segment differs in {name}")
    npt_common = dict(common, pressure=P_ATM * units.atmosphere)
    npt = make_culled_npt_lj_runner(
        slack=NPT_SLACK, segment_steps=NPT_SEGMENT,
        barostat_interval=NPT_INTERVAL, **npt_common)
    n0 = npt.init(fast.positions(fs), box, seed=7)
    gen_state = n0.generator.get_state()
    a = npt.segment(n0)
    n0.generator.set_state(gen_state)
    b = npt.segment(n0)
    for name in ("x", "v", "F", "U", "box_diag", "overflowed", "n_accepted",
                 "vmax_scale", "eval_peak"):
        _require(torch.equal(getattr(a, name), getattr(b, name)),
                 f"repeated NpT segment differs in {name}")
    a, b = strip.segment(s0, 50), strip.segment(s0, 50)
    for name in ("x", "v", "F", "step", "overflowed"):
        _require(torch.equal(getattr(a, name), getattr(b, name)),
                 f"repeated strip segment differs in {name}")
    print("[4] a repeated culled segment, a repeated NpT segment with its "
          "generator restored, and a repeated strip segment are bitwise "
          "identical")

    # ---- 5. the NVT main path, counted ----
    _build.reset_launch_counts()
    fast = make_fast_lj_runner(**common)
    fs = fast.init(pos0, box, seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fs = fast.run(fs, DENSE_STEPS)
    torch.cuda.synchronize()
    dense_rate = DENSE_STEPS / (time.perf_counter() - t0)
    runner = make_culled_lj_runner(slack=SLACK, segment_steps=SEGMENT,
                                   **common)
    st = runner.init(fast.positions(fs), box, seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = runner.run(st, CULLED_STEPS)
    torch.cuda.synchronize()
    culled_rate = CULLED_STEPS / (time.perf_counter() - t0)
    nvt_counts = dict(_build.launches)
    runner.check(st)
    energy = float(runner.energy(st))

    _require(math.isfinite(energy), f"energy {energy}")
    pos = runner.positions(st).double()
    _, e64 = lj_dense_oracle(pos, torch.as_tensor(box, device=dev).double(),
                             sig, eps, cut)
    e_rel = abs(energy - float(e64)) / abs(float(e64))
    _require(e_rel < 1e-5, f"energy rel err vs f64 oracle {e_rel}")
    m = float(fluid.topology.masses()[0])

    def t_kin(v):
        v = v.double()
        return m * float((v * v).sum()) / (3 * v.shape[0] * units.kB_MD)

    t5 = t_kin(runner.velocities(st))
    _require(abs(t5 - T_KELVIN) / T_KELVIN < 0.05, f"T_kin {t5}")
    for name in PATH_KERNELS["nvt"]:
        _require(nvt_counts.get(name, 0) > 0, f"kernel {name} never launched")
    print(f"[5] NVT main path: check() passed, energy {energy:.6f} kJ/mol "
          f"(f64 oracle rel err {e_rel:.2e}), T_kin {t5:.3f} K, "
          f"launches {nvt_counts}")
    print(f"    dense {dense_rate:.1f} steps/s, culled {culled_rate:.1f} "
          f"steps/s (N={N}, {smi})")

    # ---- 6. the NpT path, counted: the flagship point at full width ----
    melt = runner.positions(st)
    _build.reset_launch_counts()
    npt = make_culled_npt_lj_runner(
        slack=NPT_SLACK, segment_steps=NPT_SEGMENT,
        barostat_interval=NPT_INTERVAL, **npt_common)
    ns = npt.init(melt, box, seed=SEED)
    V0 = float(npt.volume(ns))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ns = npt.run(ns, NPT_STEPS)
    torch.cuda.synchronize()
    npt_rate = NPT_STEPS / (time.perf_counter() - t0)
    dnpt = make_npt_lj_runner(barostat_interval=NPT_INTERVAL, **npt_common)
    ds = dnpt.init(melt, box, seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = dnpt.run(ds, DENSE_NPT_STEPS)
    torch.cuda.synchronize()
    dense_npt_rate = DENSE_NPT_STEPS / (time.perf_counter() - t0)
    npt_counts = dict(_build.launches)

    npt.check(ns)
    dnpt.check(ds)
    n_prop, n_acc = int(ns.n_proposed), int(ns.n_accepted)
    _require(n_prop == NPT_STEPS // NPT_INTERVAL and 0 < n_acc < n_prop,
             f"culled NpT attempts {n_prop}, accepted {n_acc}")
    _require(int(ds.n_proposed) == DENSE_NPT_STEPS // NPT_INTERVAL,
             f"dense NpT attempts {int(ds.n_proposed)}")
    V = float(npt.volume(ns))
    _require(math.isfinite(V) and V != V0, f"volume {V} (start {V0})")
    U_carried = float(ns.U)
    U_k5 = float(npt.energy(ns))
    u_rel = abs(U_carried - U_k5) / abs(U_k5)
    _require(u_rel <= 1e-6, f"carried U {U_carried} vs fresh K5 {U_k5}")
    box33 = torch.diag(ns.box_diag.reshape(3)).double()
    _, e64 = lj_dense_oracle(npt.positions(ns).double(), box33, sig, eps, cut)
    e_rel = abs(U_k5 - float(e64)) / abs(float(e64))
    _require(e_rel < 1e-5, f"NpT K5 energy rel err vs f64 oracle {e_rel}")
    t6 = t_kin(npt.velocities(ns))
    _require(abs(t6 - T_KELVIN) / T_KELVIN < 0.05, f"NpT T_kin {t6}")
    print(f"[6] NpT ({P_ATM:g} atm, {T_KELVIN:g} K, attempt every "
          f"{NPT_INTERVAL} steps, S={NPT_SEGMENT}, slack {NPT_SLACK}): "
          f"check() passed; culled: {n_acc}/{n_prop} accepted "
          f"({n_acc / n_prop:.3f}), V {V0:.4f} -> {V:.4f} nm^3, carried U "
          f"{U_carried:.6f} vs K5 {U_k5:.6f} (rel {u_rel:.2e}), K5 vs f64 "
          f"oracle rel {e_rel:.2e}, T_kin {t6:.3f} K; dense: "
          f"{int(ds.n_accepted)}/{int(ds.n_proposed)} accepted, V "
          f"{float(dnpt.volume(ds)):.4f} nm^3; launches {npt_counts}")
    print(f"    culled NpT {npt_rate:.1f} steps/s, dense NpT "
          f"{dense_npt_rate:.1f} steps/s (N={N}, {smi})")

    # ---- 7. the band path at full size, counted ----
    big = LennardJonesFluid(nparticles=N_BAND, reduced_density=DENSITY)
    bbox = big.box_vectors.value_in_unit_system(units.md_unit_system)
    bpos = big.positions.value_in_unit_system(units.md_unit_system)
    bcommon = dict(common, potential=big.potential, n_particles=N_BAND,
                   topology=big.topology)
    _build.reset_launch_counts()
    br = make_lj_runner(box_vectors=bbox, **bcommon)
    _require(isinstance(br, BandRunner), f"auto at N={N_BAND}: {type(br)}")
    bs = br.init(bpos, bbox, seed=SEED)
    bs = br.run(bs, BAND_MELT_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bs = br.run(bs, BAND_STEPS)
    torch.cuda.synchronize()
    band_rate = BAND_STEPS / (time.perf_counter() - t0)
    br.check(bs)
    e_k1 = float(br.energy(bs))
    band_counts = dict(_build.launches)
    _, e_k6 = br.band.force_energy(bs.x, bs.box_diag)
    e_k6 = float(e_k6)
    e_rel = abs(e_k1 - e_k6) / abs(e_k6)
    _require(math.isfinite(e_k1) and e_rel < 1e-5,
             f"band energy K1 {e_k1} vs K6 {e_k6}")
    t7 = t_kin(br.velocities(bs))
    _require(abs(t7 - T_KELVIN) / T_KELVIN < 0.05, f"band T_kin {t7}")
    band, w, btm = br.band, br.band.w, br.band.tm
    bn_pad = br.n_pad
    slots = bn_pad * lb.n_band_tiles(w, btm, bn_pad // btm) * btm
    print(f"[7] band path (N={N_BAND}, L={float(bs.box_diag[0, 0]):.3f} nm, "
          f"n_pad={bn_pad}, tm={btm}, w={w}, {slots} band slots a step): "
          f"check() passed, energy K1 {e_k1:.3f} vs K6 {e_k6:.3f} kJ/mol "
          f"(rel {e_rel:.2e}), T_kin {t7:.3f} K, launches {band_counts}")
    print(f"    band {band_rate:.1f} steps/s over {BAND_STEPS} steps after "
          f"{BAND_MELT_STEPS} from the lattice (N={N_BAND}, {smi})")

    # K6 against its plain version on the band layout, then determinism
    bargs = (bs.x, bs.box_diag, N_BAND, w, sig, eps, cut, btm)
    Fp, Ep = lb.band_force_plain(*bargs, with_energy=True)
    Fk, Ek = lb.band_force_energy(*bargs)
    Fa = lb.band_force(*bargs)
    scale = float(Fp.abs().max())
    diff = (Fk - Fp)[:, :N_BAND].abs()
    err = float(diff.max())
    p99 = float(torch.quantile(diff.flatten(), 0.99)) / scale
    err_a = float((Fa - Fk).abs().max()) / scale
    e_rel = abs(float(Ek) - float(Ep)) / abs(float(Ep))
    e_rel_k1 = abs(float(Ek) - e_k1) / abs(e_k1)
    _require(err < 0.05 and p99 < 1e-5, f"K6 force err {err}, p99 {p99}")
    _require(float(Fk[:, N_BAND:].abs().max()) == 0.0, "K6 force padding")
    _require(err_a < 1e-4, f"K6 approx vs exact rel err {err_a}")
    _require(e_rel < 1e-5 and e_rel_k1 < 1e-5,
             f"K6 energy rel err {e_rel} (plain), {e_rel_k1} (K1)")
    noise = torch.randn(bs.x.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED))
    stale = replace(bs, ref_x=bs.ref_x - 2.0 * band.margin)
    for carry, what in ((bs, "in order"), (stale, "through the re-sort")):
        a, b = br.step(carry, noise), br.step(carry, noise)
        for name in ("x", "v", "F", "ref_x", "overflowed"):
            _require(torch.equal(getattr(a, name), getattr(b, name)),
                     f"repeated band step {what} differs in {name}")
    _require(not torch.equal(br.step(stale, noise).ref_x, bs.ref_x),
             "the stale carry was not re-sorted")
    # a NaN live coordinate latches at the next step, and check() raises
    poisoned = replace(bs, x=bs.x.clone())
    poisoned.x[0, 7] = float("nan")
    latched = br.step(poisoned, noise)
    try:
        br.check(latched)
        raised = False
    except RuntimeError:
        raised = True
    _require(bool(latched.overflowed) and raised,
             "the band runner did not latch a NaN live coordinate")
    # K6 keeps the bits of K6 taking every slot
    _require(torch.equal(lb.band_force(*bargs, skip=False), Fa)
             and all(torch.equal(a, b) for a, b in zip(
                 lb.band_force_energy(*bargs, skip=False), (Fk, Ek))),
             "K6 differs from K6 taking every slot")
    in_cut, in_x = _pairs_in_band(bs.x, bs.box_diag, N_BAND, cut, w)
    kinds, fired, steps, out = _band_votes(bs.x, bs.box_diag, N_BAND, cut, w,
                                           btm)
    lane_bytes = 3 * bn_pad * 4
    for name, energy, line in (("band_force", False, 160),
                               ("band_force_energy", True, 188)):
        def call(energy=energy):
            if energy:
                return lb.band_force_energy(*bargs)
            return lb.band_force(*bargs)

        ms = _cuda_ms(call)
        plain_ms = _cuda_ms(lambda energy=energy: lb.band_force_plain(
            *bargs, with_energy=energy), reps=2)
        bound_ms, bound_by = _bound(
            in_x * TEST_FLOPS["band"]
            + in_cut * (LJ_FLOPS + (ENERGY_FLOPS if energy else 0)),
            2 * lane_bytes + 12 + (4 if energy else 0))
        _report(f"{name} (exact vs plain, max abs tol 0.05)", err, 0.05, ms,
                plain_ms)
        results[name] = dict(
            source="chiron_tpu_torch/csrc/lj_band.cu",
            replaces=f"chiron_tpu/ops/lj_band.py:{line}", max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    print(f"  K6 (band layout at the end of [7]): p99 rel err {p99:.3e} "
          f"(tolerance 1e-5), approx vs exact rel {err_a:.3e} (1e-4), energy "
          f"rel {e_rel:.3e} to plain and {e_rel_k1:.3e} to K1 (1e-5); a "
          f"repeated step, in order and through the re-sort, is bitwise "
          f"identical, and so is K6 to K6 taking every slot; a NaN at "
          f"x[0, 7] latches at the next step and check() raises")
    print(f"    pairs: {N_BAND * w} band pairs (n x w), {in_x} within the "
          f"cutoff in x (the distance tests needed), {in_cut} within it; "
          f"bound {results['band_force']['bound_ms'] * 1e3:.3f} us "
          f"({results['band_force']['bound_by']})")
    print(f"  K6 vote (torch replica): {sum(kinds.values())} visits, "
          f"{kinds['apart']} beyond the cutoff in x (skipped), "
          f"{kinds['interior']} interior, {kinds['edge']} edge; "
          f"{fired} of {steps} warp steps in the visits taken fire "
          f"({fired / steps:.4f}); {out} coordinates outside [-L/8, 9L/8]")
    # phase 9 starts from this melted, band-sorted state
    big_melt, big_box, big_w, big_in_cut = br.positions(bs), bs.box_diag, w, in_cut
    del Fp, Fk, Fa, diff, bs, br

    # ---- 8. the strip path, counted ----
    _build.reset_launch_counts()
    sr = make_lj_runner(engine="strip", box_vectors=box, **common)
    ss = sr.init(melt, box, seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ss = sr.run(ss, STRIP_STEPS)
    torch.cuda.synchronize()
    strip_rate = STRIP_STEPS / (time.perf_counter() - t0)
    sr.check(ss)
    energy = float(sr.energy(ss))
    strip_counts = dict(_build.launches)
    # K7 on the layout the next segment would take: re-sorted, the halo
    # rebuilt (a particle that wrapped in x mid-segment has lost its strip
    # pairs until then, in the JAX package too)
    centre = torch.where(sr.valid, ss.x[:, :sr.md.n_pad], ls._PAD_X)
    _, e_k7 = sr.md.force_energy(
        sr.md.extend(ls.sort_by_key_strip(centre, ())[0], ss.box_diag),
        ss.box_diag)
    e_k7 = float(e_k7)
    _, e64 = lj_dense_oracle(sr.positions(ss).double(),
                             torch.as_tensor(box, device=dev).double(), sig,
                             eps, cut)
    e_rel = abs(energy - float(e64)) / abs(float(e64))
    e_rel7 = abs(e_k7 - float(e64)) / abs(float(e64))
    _require(math.isfinite(energy) and e_rel < 1e-5 and e_rel7 < 1e-5,
             f"strip energy rel err vs f64 oracle {e_rel} (K1), {e_rel7} (K7)")
    t8 = t_kin(sr.velocities(ss))
    _require(abs(t8 - T_KELVIN) / T_KELVIN < 0.05, f"strip T_kin {t8}")
    # K7 on that layout with the halo a tile narrower than the band the
    # cutoff needs: the strip then misses pairs (the rows next to the wrap
    # lose partners within the cutoff, each of which moves a force by
    # 0.03-0.08), and the kernel must miss the ones its plain version
    # misses: its change from the covering halo is the plain version's; and
    # a repeated call bitwise equal
    md8 = sr.md
    xs8 = ls.sort_by_key_strip(centre, ())[0]
    need = int(lb.band_width_needed(torch.where(sr.valid, xs8[0], 3.0e38),
                                    N, cut, ss.box_diag[0, 0])) + md8.n_pad - N
    h_full = -(-need // md8.tm) * md8.tm
    h_narrow = (need // md8.tm - 1) * md8.tm

    def extended(h):
        halo = xs8[:, :h].clone()
        halo[0] = halo[0] + ss.box_diag[0, 0]
        return torch.cat([xs8, halo], dim=1)

    nargs = (extended(h_narrow), ss.box_diag, N, md8.tm, h_narrow, sig, eps,
             cut)
    Fn, En = ls.strip_force_energy(*nargs)
    Fna = ls.strip_force(*nargs, approx_recip=True)
    Fnp, Enp = ls.strip_force_plain(*nargs, with_energy=True)
    fargs = (extended(h_full), ss.box_diag, N, md8.tm, h_full, sig, eps, cut)
    Ffp, _ = ls.strip_force_plain(*fargs)
    Ffk = ls.strip_force(*fargs, approx_recip=False)
    scale = float(Fnp.abs().max())
    diff = (Fn - Fnp)[:, :N].abs()
    err_n = float(diff.max())
    p99_n = float(torch.quantile(diff.flatten(), 0.99)) / scale
    e_rel_n = abs(float(En) - float(Enp)) / abs(float(Enp))
    missed = float((Fnp - Ffp).abs().max())
    same_miss = float(((Fn - Ffk) - (Fnp - Ffp)).abs().max())
    _require(err_n < 0.05 and p99_n < 1e-5 and e_rel_n < 1e-5
             and float((Fna - Fn).abs().max()) / scale < 1e-4,
             f"K7 at H={h_narrow} (a tile narrower than the band): err "
             f"{err_n}, p99 {p99_n}, energy rel {e_rel_n}")
    _require(missed > 0.02 and same_miss < 0.02,
             f"K7 at H={h_narrow}: the plain version misses pairs worth "
             f"{missed}, the kernel's change differs from it by {same_miss}")
    again = ls.strip_force_energy(*nargs)
    _require(torch.equal(again[0], Fn) and torch.equal(again[1], En)
             and torch.equal(ls.strip_force(*nargs, approx_recip=True), Fna),
             "K7 at the narrow halo: a repeated call differs")
    del Fn, Fna, Fnp, Ffp, Ffk, diff, again
    small = LennardJonesFluid(nparticles=1000, reduced_density=DENSITY)
    auto_small = make_lj_runner(
        box_vectors=small.box_vectors.value_in_unit_system(
            units.md_unit_system),
        **dict(common, potential=small.potential, n_particles=1000,
               topology=small.topology))
    auto_mid = make_lj_runner(box_vectors=box, **common)
    _require(type(auto_small) is FastLJRunner
             and type(auto_mid) is CulledLJRunner,
             f"auto picks {type(auto_small)} at N=1000, {type(auto_mid)} at "
             f"N={N}")
    print(f"[8] strip path (N={N}, S={sr.segment_steps}, slack "
          f"{sr.md.slack}, H={sr.md.H}): check() passed, energy K1 "
          f"{energy:.6f}, K7 {e_k7:.6f} kJ/mol (f64 oracle rel {e_rel:.2e}, "
          f"{e_rel7:.2e}), T_kin {t8:.3f} K, launches {strip_counts}; auto "
          f"picks FastLJRunner at N=1000 and CulledLJRunner at N={N}")
    print(f"    strip {strip_rate:.1f} steps/s (N={N}, {smi})")
    print(f"  K7 at H={h_narrow}, a tile narrower than the {need} ranks the "
          f"band needs (the missed pairs move the plain force by up to "
          f"{missed:.3e}; the kernel's change from H={h_full} differs from "
          f"the plain version's by {same_miss:.3e}, limit 0.02): max abs err "
          f"{err_n:.3e} (0.05), p99 rel {p99_n:.3e} (1e-5), energy rel "
          f"{e_rel_n:.3e} (1e-5); a repeated call bitwise equal")

    # ---- 9. the spatial path at full width, world size 1, counted ----
    mesh = make_replica_mesh(axis_name="spatial", device=dev)
    skw = dict(potential=big.potential, n_particles=N_BAND,
               topology=big.topology, temperature=T_KELVIN * units.kelvin,
               timestep=2.0 * units.femtoseconds, tm=SPATIAL_TM)
    _build.reset_launch_counts()
    sf = make_sharded_lj_force(mesh, N_BAND, sig, eps, cut,
                               axis_name="spatial", tm=SPATIAL_TM)
    pos3 = sf.op.pad_positions(big_melt)
    F_sh = sf(pos3, big_box)
    F_fe, E_fe = sf.force_energy(pos3, big_box)
    p_grad = pos3.clone().requires_grad_(True)
    sf.energy_differentiable(p_grad, big_box).backward()
    sbr = make_spatial_band_lj_runner(mesh, segment_steps=SPATIAL_SEGMENT,
                                      **skw)
    sbs = sbr.init(big_melt, bbox, seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sbs = sbr.run(sbs, SPATIAL_BAND_STEPS)
    torch.cuda.synchronize()
    sband_rate = SPATIAL_BAND_STEPS / (time.perf_counter() - t0)
    sbr.check(sbs)
    e_sband = float(sbr.energy(sbs))
    sdr = make_spatial_lj_runner(mesh, **skw)
    sds = sdr.init(big_melt, bbox, seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sds = sdr.run(sds, SPATIAL_DENSE_STEPS)
    torch.cuda.synchronize()
    sdense_rate = SPATIAL_DENSE_STEPS / (time.perf_counter() - t0)
    e_sdense = float(sdr.energy(sds))
    spatial_counts = dict(_build.launches)

    t9b, t9d = t_kin(sbr.velocities(sbs)), t_kin(sdr.velocities(sds))
    _require(math.isfinite(e_sband) and abs(t9b - T_KELVIN) / T_KELVIN < 0.05,
             f"spatial band energy {e_sband}, T_kin {t9b}")
    _require(math.isfinite(e_sdense) and abs(t9d - T_KELVIN) / T_KELVIN < 0.05
             and bool(torch.isfinite(sds.x).all()),
             f"spatial dense energy {e_sdense}, T_kin {t9d}")
    sn_pad = sf.n_pad
    print(f"[9] spatial path (N={N_BAND}, world size 1, n_pad={sn_pad}, "
          f"tm={SPATIAL_TM}): band runner (S={SPATIAL_SEGMENT}, w={sbr.w}) "
          f"check() passed, energy (K2) {e_sband:.3f} kJ/mol, T_kin "
          f"{t9b:.3f} K; dense runner energy {e_sdense:.3f} kJ/mol, T_kin "
          f"{t9d:.3f} K; launches {spatial_counts}")
    print(f"    spatial band {sband_rate:.1f} steps/s over "
          f"{SPATIAL_BAND_STEPS} steps, spatial dense {sdense_rate:.2f} "
          f"steps/s over {SPATIAL_DENSE_STEPS} (N={N_BAND}, {smi})")

    # the sharded force against K2, and K2 against its plain version
    lane_bytes = 3 * sn_pad * 4
    F2, E2 = sf.op.force_energy_t(pos3, big_box)
    scale = float(F2.abs().max())
    err_sh = float((F_sh - F2).abs().max()) / scale
    e_rel_sh = abs(float(E_fe) - float(E2)) / abs(float(E2))
    grad_diff = float((p_grad.grad + F_fe).abs().max())
    _require(err_sh < 1e-5 and float((F_fe - F2).abs().max()) / scale < 1e-5,
             f"sharded force rel err {err_sh}")
    _require(e_rel_sh < 1e-5, f"sharded energy rel err {e_rel_sh}")
    _require(grad_diff == 0.0, f"-grad(energy) != force ({grad_diff})")
    Fp, Ep = lj_dense_plain(pos3, big_box, N_BAND, sig, eps, cut)
    diff = (F2 - Fp).abs()
    err = float(diff.max())
    p99 = float(torch.quantile(diff.flatten(), 0.99)) / float(Fp.abs().max())
    e_rel = abs(float(E2) - float(Ep)) / abs(float(Ep))
    _require(err / float(Fp.abs().max()) < 1e-5 and e_rel < 1e-5,
             f"K2 force rel err {err}, energy rel err {e_rel}")
    ms = _cuda_ms(lambda: sf.op.force_energy_t(pos3, big_box), reps=5)
    plain_ms = _cuda_ms(lambda: lj_dense_plain(pos3, big_box, N_BAND, sig,
                                               eps, cut), reps=1)
    bound_ms, bound_by = _bound(
        N_BAND * (N_BAND - 1) // 2 * TEST_FLOPS["lj_dense"]
        + big_in_cut * (LJ_FLOPS + ENERGY_FLOPS), 2 * lane_bytes + 16)
    print(f"  sharded force vs K2: rel err {err_sh:.3e} (tolerance 1e-5), "
          f"energy rel {e_rel_sh:.3e} (1e-5), max |grad E + F| {grad_diff}; "
          f"K2 bound {bound_ms * 1e3:.3f} us ({bound_by}; {smi})")
    _report(f"lj_dense_square (K2, exact, with energy; p99 rel {p99:.3e}, "
            f"energy rel {e_rel:.3e}; rel tol 1e-5)", err, "1e-5 rel", ms,
            plain_ms)
    results["lj_dense_square"] = dict(
        source="chiron_tpu_torch/csrc/lj_dense.cu",
        replaces="chiron_tpu/ops/lj_dense.py:340", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    del Fp, diff, F2, F_sh, F_fe, p_grad

    # K8a at 4 row slabs and at one, against the plain version
    r4 = sn_pad // 4
    a8 = (N_BAND, sig, eps, cut)
    for name, energy in (("row_slab_force", False),
                         ("row_slab_force_energy", True)):
        F1, E1 = sp.row_slab_force(pos3, pos3, big_box, 0, *a8,
                                   with_energy=energy)
        diffs, e_rels, parts, scale = [], [], [], 0.0
        for k in range(4):
            rows = pos3[:, k * r4:(k + 1) * r4].contiguous()
            Fk, Ek = sp.row_slab_force(rows, pos3, big_box, k * r4, *a8,
                                       with_energy=energy)
            Fq, Eq = sp.row_slab_force_plain(rows, pos3, big_box, k * r4,
                                             *a8, with_energy=energy)
            parts.append(Fk)
            diffs.append((Fk - Fq).abs())
            scale = max(scale, float(Fq.abs().max()))
            if energy:
                e_rels.append(abs(float(Ek) - float(Eq)) / abs(float(Eq)))
        diff = torch.cat(diffs, dim=1)
        err = float(diff.max())
        p99 = float(torch.quantile(diff.flatten(), 0.99)) / scale
        _require(err / scale < 1e-5 and p99 < 1e-5,
                 f"{name} rel err {err / scale}, p99 {p99}")
        _require(all(e < 1e-5 for e in e_rels), f"{name} slab energies {e_rels}")
        _require(torch.equal(torch.cat(parts, dim=1), F1),
                 f"{name}: 4 slabs differ from one")
        _require(float(F1[:, N_BAND:].abs().max()) == 0.0, f"{name} padding")
        # one slab runs K2's kernel on K2's rows: its bits, and half its
        # energy (K2 halves the same sum)
        if energy:
            F2k, E2k = sf.op.force_energy_t(pos3, big_box)
            same = torch.equal(F1, F2k) and torch.equal(0.5 * E1, E2k)
        else:
            same = torch.equal(
                F1, sf.op.force_only_t(pos3, big_box, approx_recip=False))
        _require(same, f"{name}: one slab differs from K2 (bitwise)")
        ms = _cuda_ms(lambda energy=energy: sp.row_slab_force(
            pos3, pos3, big_box, 0, *a8, with_energy=energy), reps=5)
        plain_ms = _cuda_ms(lambda energy=energy: sp.row_slab_force_plain(
            pos3, pos3, big_box, 0, *a8, with_energy=energy), reps=1)
        # the timed call is one slab of every row: each pair with a live
        # row in the slab is needed once, here n(n-1)/2 of them, as for K2
        tests = _slab_pairs(N_BAND, 0, sn_pad)
        bound_ms, bound_by = _bound(
            tests * TEST_FLOPS["lj_dense"]
            + big_in_cut * (LJ_FLOPS + (ENERGY_FLOPS if energy else 0)),
            3 * lane_bytes + 12 + (4 if energy else 0))
        _report(f"{name} (K8a vs plain, rel tol 1e-5; p99 rel {p99:.3e}; "
                f"slab energies rel {max(e_rels, default=0.0):.3e}; 4 slabs "
                f"= 1 slab = K2 bit for bit"
                f"{', half the energy too' if energy else ''})", err,
                "1e-5 rel", ms, plain_ms)
        print(f"    pairs: {tests} distance tests (the pairs with a live row "
              f"in the slab), {big_in_cut} LJ terms; bound "
              f"{bound_ms * 1e3:.3f} us ({bound_by}; {smi})")
        results[name] = dict(
            source="chiron_tpu_torch/csrc/lj_dense.cu",
            replaces="chiron_tpu/parallel/spatial.py:126", max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    del F1, F2k, parts, diffs, diff

    # K8b on the band runner's layout, at 4 row slabs and at one
    xb, sbox, sw, stm = sbs.x, sbs.box_diag, sbr.w, sbr.tm
    b8 = (N_BAND, sw, stm, sig, eps, cut)
    Fb = sp.row_band_force(xb, sbox, 0, sn_pad, *b8)
    parts = [sp.row_band_force(xb, sbox, k * r4, r4, *b8) for k in range(4)]
    Fq = sp.row_band_force_plain(xb, sbox, 0, sn_pad, N_BAND, sw, sig, eps,
                                 cut)
    scale = float(Fq.abs().max())
    diff = (Fb - Fq).abs()
    err = float(diff.max())
    p99 = float(torch.quantile(diff.flatten(), 0.99)) / scale
    _require(err / scale < 1e-5 and p99 < 1e-5,
             f"K8b rel err {err / scale}, p99 {p99}")
    _require(torch.equal(torch.cat(parts, dim=1), Fb), "K8b: 4 slabs != one")
    K, nbt = sp.band_window(N_BAND, sn_pad, stm, sw)
    ms = _cuda_ms(lambda: sp.row_band_force(xb, sbox, 0, sn_pad, *b8))
    plain_ms = _cuda_ms(lambda: sp.row_band_force_plain(
        xb, sbox, 0, sn_pad, N_BAND, sw, sig, eps, cut), reps=1)
    _require(torch.equal(sp.row_band_force(xb, sbox, 0, sn_pad, *b8,
                                           skip=False), Fb),
             "K8b differs from K8b taking every slot")
    # one slab of every row: each band pair is needed once, as for K6
    in_band, in_xb = _pairs_in_band(xb, sbox, N_BAND, cut, sw)
    chunks, dead, apart, fired, steps, out = _row_band_votes(
        xb, sbox, N_BAND, cut, sw, stm)
    bound_ms, bound_by = _bound(
        in_xb * TEST_FLOPS["band"] + in_band * LJ_FLOPS, 2 * lane_bytes + 12)
    _report(f"row_band_force (K8b vs plain, rel tol 1e-5; p99 rel "
            f"{p99:.3e}; 4 slabs = 1 slab bit for bit)", err, "1e-5 rel", ms,
            plain_ms)
    print(f"    pairs: {N_BAND * sw} band pairs (n x w), {in_xb} within the "
          f"cutoff in x (the distance tests needed), {in_band} LJ terms; "
          f"the kernel's window {nbt} tiles of {stm} (K={K}), "
          f"{sn_pad * nbt * stm} slots; bound {bound_ms * 1e3:.3f} us "
          f"({bound_by}; {smi}); bitwise equal to K8b taking every slot")
    print(f"  K8b vote (torch replica): {chunks} warp chunks of 32 columns, "
          f"{dead} without a band pair and {apart} beyond the cutoff in x "
          f"(both skipped); {fired} of {steps} warp steps in the others fire "
          f"({fired / steps:.4f}); {out} coordinates outside [-L/8, 9L/8]")
    results["row_band_force"] = dict(
        source="chiron_tpu_torch/csrc/spatial.cu",
        replaces="chiron_tpu/parallel/spatial.py:547", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    del Fb, parts, Fq, diff

    # a repeated band segment, and one in a 1-rank NCCL group, bit for bit
    noise = torch.randn((SPATIAL_SEGMENT, 3, sn_pad), device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED))
    a, b = sbr.segment(sbs, noise), sbr.segment(sbs, noise)
    for name in ("x", "v", "F", "overflowed"):
        _require(torch.equal(getattr(a, name), getattr(b, name)),
                 f"repeated spatial band segment differs in {name}")
    alone = make_spatial_band_lj_runner(mesh, segment_steps=SPATIAL_SEGMENT,
                                        **skw)
    a = alone.segment(alone.init(big_melt, bbox, seed=SEED), noise)
    store_path = _build.BUILD_ROOT / f"nccl_store.{os.getpid()}"
    store_path.parent.mkdir(parents=True, exist_ok=True)
    _require(pdist.initialize_cluster(
        num_processes=1, process_id=0, device=dev,
        store=torch.distributed.FileStore(str(store_path), 1)),
        "NCCL group not initialised")
    try:
        gmesh = make_replica_mesh(axis_name="spatial", device=dev)
        _require(gmesh.group is not None, "the mesh has no process group")
        grouped = make_spatial_band_lj_runner(
            gmesh, segment_steps=SPATIAL_SEGMENT, **skw)
        g = grouped.segment(grouped.init(big_melt, bbox, seed=SEED), noise)
        torch.cuda.synchronize()
    finally:
        torch.distributed.destroy_process_group()
        store_path.unlink(missing_ok=True)
    for name in ("x", "v", "F", "overflowed"):
        _require(torch.equal(getattr(a, name), getattr(g, name)),
                 f"the NCCL-group segment differs in {name}")
    print("  a repeated spatial band segment is bitwise identical, and one "
          "segment in a 1-rank NCCL group equals the group-free one bit for "
          "bit")
    del a, b, g, sbs, sds, noise

    counts = {"nvt": nvt_counts, "npt": npt_counts, "band": band_counts,
              "strip": strip_counts, "spatial": spatial_counts}
    counts.update(_phase10(dev, common, fluid, st, runner, results, smi,
                           t_kin))
    for path, names in PATH_KERNELS.items():
        for name in names:
            _require(counts[path].get(name, 0) > 0,
                     f"kernel {name} never launched on the {path} path")
    kernels = []
    for name, r in results.items():
        by_path = {path: c.get(name, 0) for path, c in counts.items()}
        _require(name in OFF_PATH or sum(by_path.values()) > 0,
                 f"kernel {name} never launched")
        kernels.append(dict(
            name=name, route="cuda", source=r["source"],
            replaces=r["replaces"], launches=sum(by_path.values()),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            launches_by_path=by_path))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
