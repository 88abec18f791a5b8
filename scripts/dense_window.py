#!/usr/bin/env python3
"""K1 over a tempering cell's window on the card: its time a launch and its
chunk share on the window's first and last states.

    python3 scripts/dense_window.py [--workload lj4000.pt16] [--seed S] \
        [--seconds 30] [--out output/dense_window]

sets the cell of ``BENCHMARK.json`` up and warms it as ``h100bench/run.py``
does, runs ``--seconds`` of its frames (untraced), and keeps the sampler's
state after the window's first frame and after its last.  For each it
prints the device time of one launch of K1 over the replicas
(``LJDense.force_only_r``, the chain's approximate reciprocal; CUDA events
over 200 launches) and its chunk share (``scripts/dense_cull_work.py``'s
replay: chunks tested over chunks visited) in the order the dense chain
hands K1 its lanes.  Where the program sorts them
(``parallel.tempering.lane_order``) it also gives the sampler's own lane
order beside it; where it does not, that order is the chain's.  One JSON
line, the frame times over each 5 s of the window with it; the two states
go to ``--out`` as npz (``x3``, ``box``, ``n``, ``cutoff``) for
``scripts/dense_cull_work.py --state``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _dense_cull_work():
    spec = importlib.util.spec_from_file_location(
        "dense_cull_work", ROOT / "scripts" / "dense_cull_work.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k1_us(op, x3, box, launches: int = 200) -> float:
    """Device us of one K1 launch over the replicas at ``x3``."""
    import torch

    for _ in range(5):
        op.force_only_r(x3, box)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        op.force_only_r(x3, box)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / launches


def measure(sim, x3, dw):
    """K1's time and chunk share at the sampler's state ``x3`` in the
    chain's order, and in the sampler's own where the chain sorts."""
    import torch

    from chiron_tpu_torch.parallel import tempering

    s = sim.sampler
    op, box = s._dense_op, s.box_vectors
    box_h = box.reshape(-1, 3).cpu().numpy()
    out = {}
    orders = {"own": x3}
    lane_order = getattr(tempering, "lane_order", None)
    if lane_order is not None:
        perm = lane_order(x3, box, op.n, op.cutoff)
        orders["sorted"] = torch.gather(x3, 2,
                                        perm[:, None, :].expand_as(x3))
    for name, x in orders.items():
        work = dw.chunk_work(x, box_h, op.n, op.cutoff)
        out[name] = dict(k1_us=k1_us(op, x, box), share=work["share"],
                         tested=work["tested"], visited=work["visited"])
    out["chain_order"] = "sorted" if lane_order is not None else "own"
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="lj4000.pt16")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--out", default="output/dense_window")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from h100bench import run, spec

    dw = _dense_cull_work()
    cell = spec.Cell(ROOT, spec.load(ROOT), args.workload)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _, sim, _, _ = run.start(cell, args.seed, dev)
    s = sim.sampler
    frames, states = [], {}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        t = time.perf_counter()
        sim.frame(None)
        frames.append(time.perf_counter() - t)
        if len(frames) == 1:
            states["first"] = s.positions.clone()
    states["last"] = s.positions.clone()
    window_s = time.perf_counter() - t0
    ends = np.cumsum(frames)
    slices = [float(np.median(np.asarray(frames)[(ends > a) & (ends <= a + 5)])
                    * 1e3) for a in np.arange(0.0, ends[-1] - 1e-9, 5.0)
              if np.any((ends > a) & (ends <= a + 5))]
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    op = s._dense_op
    result = dict(workload=args.workload, seed=args.seed,
                  card=run.nvidia_smi(), frames=len(frames),
                  window_s=window_s,
                  frame_ms_median_a_5s=slices,
                  frame_ms_p95=float(np.percentile(frames, 95) * 1e3))
    for name, x3 in states.items():
        result[name] = measure(sim, x3, dw)
        np.savez(out_dir / f"{args.workload}.{args.seed}.{name}.npz",
                 x3=x3.cpu().numpy(),
                 box=s.box_vectors.reshape(-1, 3).cpu().numpy(), n=op.n,
                 cutoff=op.cutoff)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
