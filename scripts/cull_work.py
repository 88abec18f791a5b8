#!/usr/bin/env python3
"""The culled pair pass's work at one state, counted on the CPU.

    python3 scripts/cull_work.py --cell lj32k.culled [--state X.npz] [--seed S]

replays what ``cull_pairs`` (``chiron_tpu_torch/csrc/lj_cull_force.cu``)
does with each listed pair of a state, in float32 op for op, and prints
one JSON line: the list's entries, the pairs it lists, the pairs tested
(the warps' bounding-box cull, ``cull::apart``, kept them), the pairs
within the cutoff, the lanes of the LJ term (``lanes``: 32 RPT a q step
whose warp vote passes), the lanes a walk of each lane's own passing pairs
would take instead (``walk_lanes``: 32 a round, as many rounds as the
warp's busiest lane has pairs), and each as a share of the tested pairs.
``tested`` and ``lanes`` are what the kernel's counters
(``profiling.counters()``) read on the card at the same state and list.

The state is the cell's configuration (``h100bench/configs/``) sorted and
listed as its runner does on the CPU (the factory and options of its
traffic file): its positions from ``--state`` (an npz with ``positions``,
(n, 3) nm, as ``chip_profile.py --cull-shapes`` writes the melted states),
else uniform random in the box from ``--seed``.  No card is used.

    python3 scripts/cull_work.py --cell lj32k.culled --within-tile z

orders each row tile's lanes by z before counting (``within_tile``): every
tile holds the same particles, so the list is the same, bit for bit, and
only the warps' shapes change.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

F32 = np.float32
SLICE = 64      # columns a pair block takes (kSlice)
THREADS = 128   # threads a pair block (kThreads)
RAISE = F32(1.002)  # cull::kRaise


def fma32(a, b, c):
    """float32 fma(a, b, c), correctly rounded: the float64 product is exact,
    the float64 sum is made round-to-odd from its TwoSum error, and one
    rounding to float32 is then exact."""
    a, b, c = (np.asarray(v, dtype=np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    bits = s.view(np.int64)
    # |s| above the exact sum: step one ulp toward zero before the odd bit
    down = (e != 0) & ((e < 0) != (s < 0))
    bits = np.where(down, bits - 1, bits)
    bits = np.where(e != 0, bits | 1, bits)
    odd = bits.view(np.float64)
    return np.where(np.isfinite(s), odd, s).astype(F32)


def row_chunk(tm: int) -> int:
    return tm if tm <= 256 else (256 if tm % 256 == 0 else 128)


def block_shape(tm: int):
    """(RPT, KRG, KCG) of the pass at tm (``launch_pairs``)."""
    rpt, krg = {16: (1, 16), 32: (1, 32), 64: (2, 32), 128: (4, 32),
                256: (8, 32)}[row_chunk(tm)]
    return rpt, krg, THREADS // krg


def fold_x(x, cx, Lx, iLx, inv_sigma):
    k = np.floor((x - cx) * iLx + F32(0.5))
    return (x - Lx * k) * inv_sigma


def _image(o, per, iper, contract):
    r = np.rint(o * iper)
    return fma32(-per, r, o) if contract else o - per * r


def boxes(px, py, pz, per, iper, contract):
    """cull::BoxAcc over the last axis (a warp's points, the reference the
    first): centers (3, ...), half-widths (3, ...), finite (...)."""
    cs, hs = [], []
    for a, p in enumerate((px, py, pz)):
        o = p - p[..., :1]
        if per[a] > 0:
            o = _image(o, per[a], iper[a], contract)
        lo, hi = np.fmin.reduce(o, axis=-1), np.fmax.reduce(o, axis=-1)
        ref = p[..., 0]
        half = F32(0.5)
        cs.append(fma32(half, lo + hi, ref) if contract
                  else ref + half * (lo + hi))
        hs.append(half * (hi - lo))
    finite = np.isfinite(px).all(-1) & np.isfinite(py).all(-1) \
        & np.isfinite(pz).all(-1)
    return np.stack(cs), np.stack(hs), finite


def apart(ca, ha, fa, cb, hb, fb, per, iper, thr2, contract):
    """cull::apart of broadcast boxes."""
    g2 = np.zeros(np.broadcast(ca[0], cb[0]).shape, dtype=F32)
    for a in range(3):
        d = ca[a] - cb[a]
        if per[a] > 0:
            d = _image(d, per[a], iper[a], contract)
        g = (np.abs(d) - ha[a]) - hb[a]
        add = fma32(g, g, g2) if contract else g2 + g * g
        g2 = np.where(g > 0, add, g2)
    return fa & fb & (g2 > thr2)


def warp_lanes(passed):
    """The LJ lanes and the walk's lanes of warps whose pass bits are
    ``passed``, shaped (..., row groups, RPT, q steps, column groups), a
    lane being a (row group, column group): (lanes, walk_lanes), each of
    shape (...)."""
    rpt = passed.shape[-3]
    voted = passed.any(axis=(-4, -3, -1)).sum(axis=-1)
    most = passed.sum(axis=(-3, -2)).max(axis=(-2, -1))
    return 32 * rpt * voted, 32 * most


def pair_work(x3, box_diag, pairs, n: int, tm: int, tn: int, sigma: float,
              cutoff: float, contract: bool = True, batch: int = 32):
    """The pass's work over ``pairs`` at wrapped positions ``x3`` ((3, n_pad)
    tensors or arrays, as the kernel takes them): a dict of counts.
    ``contract`` takes the boxes' a - b c as one fma, as nvcc contracts
    them in ``common.cuh``."""
    x3 = np.asarray(torch.as_tensor(x3).cpu(), dtype=F32)
    box = np.asarray(torch.as_tensor(box_diag).cpu(), dtype=F32).reshape(3)
    count = int(np.asarray(pairs.count.cpu()).reshape(-1)[0])
    rows = np.asarray(pairs.rows.cpu()).reshape(-1)[:count].astype(np.int64)
    cols = np.asarray(pairs.cols.cpu()).reshape(-1)[:count].astype(np.int64)
    ccx = np.asarray(pairs.ccx.cpu(), dtype=F32).reshape(-1)[:count]
    ptr2 = np.asarray(pairs.ptr2.cpu()).reshape(-1).astype(np.int64)
    rowcx = np.asarray(pairs.rowcx.cpu(), dtype=F32).reshape(-1)
    rpt, _, kcg = block_shape(tm)
    wr = 32 * rpt // kcg          # a warp's rows
    nq_full = SLICE // kcg
    inv_sigma = F32(1.0 / sigma)
    sigma_fold = F32(1.0 / float(inv_sigma))
    Lx, Ly, Lz = box
    iLx, iLy, iLz = F32(1) / Lx, F32(1) / Ly, F32(1) / Lz
    Lys, Lzs = Ly * inv_sigma, Lz * inv_sigma
    tys, tzs = (F32(2) * iLy) * sigma_fold, (F32(2) * iLz) * sigma_fold
    per = (F32(0), Lys, Lzs)
    iper = (F32(0), iLy * sigma_fold, iLz * sigma_fold)
    cutoff2 = F32((cutoff / sigma) ** 2)
    thr2 = cutoff2 * RAISE
    out = dict(entries=count, listed=count * tm * tn, tested=0, within=0,
               lanes=0, walk_lanes=0)
    slices = [(c0, min(SLICE, tn - c0)) for c0 in range(0, tn, SLICE)]
    general_all = np.arange(count) < ptr2[2 * rows + 1]
    for k0 in range(0, count, batch):
        ks = slice(k0, min(count, k0 + batch))
        K = ks.stop - ks.start
        rid = rows[ks, None] * tm + np.arange(tm)                  # (K, tm)
        xi = fold_x(x3[0][rid], rowcx[rows[ks]][:, None], Lx, iLx, inv_sigma)
        yi, zi = x3[1][rid] * inv_sigma, x3[2][rid] * inv_sigma
        nwb = tm // wr
        shape_w = (K, nwb, wr)
        rc, rh, rf = boxes(xi.reshape(shape_w), yi.reshape(shape_w),
                           zi.reshape(shape_w), per, iper, contract)
        general = general_all[ks]
        for c0, width in slices:
            staged = c0 + np.minimum(np.arange(SLICE), width - 1)
            cid = cols[ks, None] * tn + staged                     # (K, 64)
            px = fold_x(x3[0][cid], ccx[ks][:, None], Lx, iLx, inv_sigma)
            py, pz = x3[1][cid] * inv_sigma, x3[2][cid] * inv_sigma
            cc, ch, cf = boxes(px, py, pz, per, iper, contract)
            skip = apart(rc, rh, rf, cc[:, :, None], ch[:, :, None],
                         cf[:, None], per, iper, thr2, contract)  # (K, nwb)
            # the pairs: (K, nwb, wr, 64), live columns t < width only
            dx = xi.reshape(shape_w)[..., None] - px[:, None, None, :]
            dy = yi.reshape(shape_w)[..., None] - py[:, None, None, :]
            dy = dy - Lys * np.trunc(dy * tys)
            dz = zi.reshape(shape_w)[..., None] - pz[:, None, None, :]
            dz = dz - Lzs * np.trunc(dz * tzs)
            r2 = fma32(dz, dz, fma32(dy, dy, dx * dx))
            ridw = rid.reshape(shape_w)[..., None]
            cidw = cid[:, None, None, :]
            rank = (cidw > ridw) & (cidw < n)
            g = general[:, None, None, None]
            within = (r2 < cutoff2) & (rank | ~g)
            live = (np.arange(SLICE) < width)[None, None, None, :] \
                & ~skip[:, :, None, None]
            passed = (within | np.isnan(r2)) & live
            out["within"] += int((within & live).sum())
            nq = width // kcg
            out["tested"] += int((~skip).sum()) * 32 * nq * rpt
            # lanes: rows (wr/rpt row groups, rpt), columns (nq_full, kcg)
            lanes, walk = warp_lanes(
                passed.reshape(K, nwb, wr // rpt, rpt, nq_full, kcg))
            out["lanes"] += int(lanes.sum())
            out["walk_lanes"] += int(walk.sum())
    tested = max(out["tested"], 1)
    for key in ("within", "lanes", "walk_lanes"):
        out[f"{key}_share"] = out[key] / tested
    return out


def within_tile(x3, n: int, tm: int, axis: int):
    """``x3`` with each tile of ``tm`` lanes ordered by coordinate ``axis``
    (stable), the padding lanes (>= n) left last."""
    x3 = torch.as_tensor(x3)
    n_pad = x3.shape[1]
    key = torch.where(torch.arange(n_pad) < n, x3[axis], float("inf"))
    perm = torch.sort(key.reshape(-1, tm), dim=1, stable=True).indices
    perm = (perm + torch.arange(0, n_pad, tm)[:, None]).reshape(-1)
    return x3[:, perm]


def cell_state(cell: str, state: str = None, seed: int = 1):
    """The cell's runner on the CPU and its sorted start: (runner, x3s,
    box_diag, pairs)."""
    from chiron_tpu_torch import runtime
    from h100bench import spec, systems
    from h100bench.drivers import lj_objects

    c = spec.Cell(ROOT, spec.load(ROOT), cell)
    fluid = systems.fluid(c.config)
    potential, topology, box = lj_objects(fluid)
    if state is not None:
        positions = np.load(state)["positions"].astype(np.float32)
    else:
        rng = np.random.default_rng(seed)
        positions = (rng.random((fluid.n, 3)) * fluid.box).astype(np.float32)
    opts = dict(c.traffic["runner"])
    if c.traffic["factory"] == "make_lj_runner":
        opts["box_vectors"] = box
    runner = getattr(runtime, c.traffic["factory"])(
        potential=potential, n_particles=fluid.n, topology=topology,
        temperature=fluid.temperature, timestep=fluid.lng.dt,
        collision_rate=fluid.lng.gamma, device="cpu", **opts)
    x3s, box_diag, pairs, _, _ = runner._start(positions, box, seed)
    return runner, x3s, box_diag, pairs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cell", required=True,
                   help="a culled cell of BENCHMARK.json")
    p.add_argument("--state", help="npz with positions (n, 3), nm")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--within-tile", choices=("x", "y", "z"),
                   help="order each row tile's lanes by this axis")
    args = p.parse_args(argv)
    runner, x3s, box_diag, pairs = cell_state(args.cell, args.state,
                                              args.seed)
    md = runner.md
    if args.within_tile:
        x3s = within_tile(x3s, md.n, md.tm, "xyz".index(args.within_tile))
    out = pair_work(x3s, box_diag[0], pairs, md.n, md.tm, md.tn, md.sigma,
                    md.cutoff)
    out.update(cell=args.cell, state=args.state or f"random seed {args.seed}",
               nslab=runner.nslab, tm=md.tm, tn=md.tn,
               within_tile=args.within_tile)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
