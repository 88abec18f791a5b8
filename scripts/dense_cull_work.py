#!/usr/bin/env python3
"""K1's column-chunk cull at one state, counted on the CPU.

    python3 scripts/dense_cull_work.py [--rms 0.84] [--seed S] [--replicas R]
    python3 scripts/dense_cull_work.py --state X.npz

replays what each block of K1 (``lj_dense_rows`` in
``chiron_tpu_torch/csrc/lj_dense.cu``) does with each 32-lane column chunk,
in float32 op for op (the boxes and ``cull::apart`` of
``scripts/cull_work.py``): a block's 32 rows and a chunk's 32 columns each
make a bounding box, its reference the first lane's point, and the chunk's
pairs take the distance test unless the boxes lie farther apart than the
cutoff.  It prints one JSON line: the chunks visited (every block visits
every chunk) and tested, and their ratio, for the lanes in the order given
(``given``) and in the order the dense tempering chain runs them
(``sorted``: ``parallel.tempering.lane_order``).  ``visited`` and
``tested`` are what K1's counters (``profiling.counters()``) read on the
card at the same state and order.

The state is the ``lj4000`` configuration's lattice (``h100bench/configs/``)
in lattice order, each particle displaced by a normal of ``--rms`` nm an
axis and wrapped into the box, its padding lanes uniform in the box (where
the chain's free padding lanes drift); or, with ``--state``, an npz with
``x3`` ((R, 3, n_pad) lanes, nm), ``box`` ((R, 3) nm), ``n`` and
``cutoff``, as ``scripts/dense_window.py`` writes.  No card is used.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

F32 = np.float32
CHUNK = 32           # kRows = kChunk in lj_dense.cu
RAISE = F32(1.002)   # cull::kRaise


def _cull_work():
    spec = importlib.util.spec_from_file_location(
        "cull_work", ROOT / "scripts" / "cull_work.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cw = _cull_work()


def tested_chunks(x3, L, cutoff: float, contract: bool = True):
    """(blocks, chunks) bool: the chunks whose pairs block i's warps test,
    at one replica's lanes ``x3`` ((3, n_pad) float32) in its box ``L``
    (3 float32 lengths).  ``contract`` takes the boxes' a - b c as one fma,
    as nvcc contracts them in ``common.cuh``."""
    nb = x3.shape[1] // CHUNK
    per = tuple(L)
    iper = tuple(F32(1) / L)
    thr2 = F32(cutoff * cutoff) * RAISE
    b = x3.reshape(3, nb, CHUNK)
    c, h, f = cw.boxes(b[0], b[1], b[2], per, iper, contract)
    # the rows' box (block i) against the columns' box (chunk j)
    return ~cw.apart(c[:, :, None], h[:, :, None], f[:, None],
                     c[:, None, :], h[:, None, :], f[None, :], per, iper,
                     thr2, contract)


def chunk_work(x3, box, n: int, cutoff: float, contract: bool = True):
    """K1's chunks visited and tested at lanes ``x3`` ((3, n_pad) or
    (R, 3, n_pad), tensors or arrays, as the kernel takes them) in boxes
    ``box`` (3 or R x 3 lengths): a dict of counts and their ratio."""
    x3 = np.asarray(torch.as_tensor(x3).cpu(), dtype=F32)
    if x3.ndim == 2:
        x3 = x3[None]
    box = np.asarray(torch.as_tensor(box).cpu(), dtype=F32).reshape(-1, 3)
    R, _, n_pad = x3.shape
    tested = sum(int(tested_chunks(x3[r], box[r], cutoff, contract).sum())
                 for r in range(R))
    visited = R * (n_pad // CHUNK) ** 2
    return dict(visited=visited, tested=tested, share=tested / visited)


def lattice_state(rms: float, seed: int, replicas: int = 1):
    """The ``lj4000`` lattice displaced by ``rms`` nm an axis, in lattice
    order, padded as the dense sampler pads it: (x3 (R, 3, n_pad), box
    (R, 3), n, cutoff)."""
    from h100bench import systems

    config = json.loads((ROOT / "h100bench" / "configs"
                         / "lj4000.json").read_text())
    fluid = systems.fluid(config)
    n, L = fluid.n, F32(fluid.box)
    n_pad = -(-n // 512) * 512   # the dense sampler's padding at n >= 384
    rng = np.random.default_rng(seed)
    pos = np.asarray(fluid.positions, dtype=np.float64)
    x3 = np.empty((replicas, 3, n_pad), F32)
    for r in range(replicas):
        moved = pos + rng.normal(0.0, rms, pos.shape)
        x3[r, :, :n] = (moved % float(L)).astype(F32).T
        x3[r, :, n:] = (rng.random((3, n_pad - n)) * float(L)).astype(F32)
    box = np.full((replicas, 3), L, F32)
    return x3, box, n, fluid.lj.cutoff


def sorted_lanes(x3, box, n: int, cutoff: float):
    """``x3`` in the dense chain's lane order (``lane_order``)."""
    from chiron_tpu_torch.parallel.tempering import lane_order

    x3 = torch.as_tensor(np.asarray(x3, dtype=F32))
    box = torch.as_tensor(np.asarray(box, dtype=F32)).reshape(-1, 1, 3)
    perm = lane_order(x3, box, n, cutoff)
    return torch.gather(x3, 2, perm[:, None, :].expand_as(x3)).numpy()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--state", help="npz with x3, box, n and cutoff")
    p.add_argument("--rms", type=float, default=0.84,
                   help="the lattice's displacement, nm an axis")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--replicas", type=int, default=1)
    args = p.parse_args(argv)
    if args.state:
        z = np.load(args.state)
        x3, box = z["x3"], z["box"]
        n, cutoff = int(z["n"]), float(z["cutoff"])
        what = args.state
    else:
        x3, box, n, cutoff = lattice_state(args.rms, args.seed, args.replicas)
        what = f"lj4000 lattice, {args.rms} nm rms, seed {args.seed}"
    out = dict(state=what, n=n, n_pad=x3.shape[-1], cutoff=cutoff,
               given=chunk_work(x3, box, n, cutoff),
               sorted=chunk_work(sorted_lanes(x3, box, n, cutoff), box, n,
                                 cutoff))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
