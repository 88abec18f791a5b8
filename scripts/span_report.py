"""The program's spans over one cell of ``BENCHMARK.json`` on the card.

    python3 scripts/span_report.py --workload <name> --seed <n> --trace
    python3 scripts/span_report.py --workload <name> --seed <n> \
        --seconds 30 [--slice 5]

With ``--trace`` it runs the cell's traced window as ``h100bench/run.py
--trace 1`` does (``run.run_cell``) and prints that result line, then a
line with the traced window's wall time a step and ``profiling.totals()``
of the window a step.  Without it, it sets the cell up and warms it as the
harness does, runs ``--seconds`` of frames inside
``profiling.recording()`` (no profiler), and prints each span name's count,
time and self time a frame over the first and the last ``--slice`` seconds
of the window, beside the frames' median wall time there.  One JSON line
a table; ``--out`` appends them to a file too.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _per(totals, n, unit):
    """``profiling.totals()`` over ``n`` frames or steps, in ``unit``
    seconds (1e-3: ms, 1e-6: us)."""
    return {name: dict(count=t["count"] / n, time=t["total_s"] / unit / n,
                       self_time=t["self_s"] / unit / n)
            for name, t in totals.items()}


def traced(cell, seed, seconds, emit):
    import torch

    from chiron_tpu_torch import profiling

    from h100bench import run

    result = run.run_cell(cell, seed, seconds, True, "cuda",
                          log=lambda *a: print(*a, file=sys.stderr))
    emit(result)
    steps = result["attempted"] * cell.traffic["steps_per_frame"]
    emit(dict(workload=cell.name, seed=seed, steps=steps,
              window_us_per_step=result["device"]["window_s"] * 1e6 / steps,
              card=torch.cuda.get_device_name(0),
              us_per_step=_per(profiling.totals(), steps, 1e-6)))


def recorded(cell, seed, seconds, slice_s, emit, device="cuda"):
    import numpy as np
    import torch

    from chiron_tpu_torch import profiling

    from h100bench import run

    dev = torch.device(device)
    _, sim, draws, picks = run.start(cell, seed, dev)
    t0 = time.perf_counter_ns()
    with profiling.recording():
        w = run.run_window(sim, draws, picks, seconds=seconds)
    t1 = time.perf_counter_ns()
    ends = t0 + np.cumsum(np.asarray(w["frame_s"]) * 1e9)
    frame_ms = np.asarray(w["frame_s"]) * 1e3
    for label, lo, hi in (("first", t0, t0 + slice_s * 1e9),
                          ("last", t1 - slice_s * 1e9, t1)):
        inside = (ends > lo) & (ends <= hi)
        frames = int(inside.sum())
        emit(dict(workload=cell.name, seed=seed, slice=label,
                  seconds=slice_s, frames=frames,
                  frame_ms_median=(float(np.median(frame_ms[inside]))
                                   if frames else None),
                  card=(torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
                  ms_per_frame=_per(profiling.totals(lo, hi),
                                    max(frames, 1), 1e-3)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--trace", action="store_true")
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--slice", type=float, default=5.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from h100bench import spec

    cell = spec.Cell(ROOT, spec.load(ROOT), args.workload)

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")

    if args.trace:
        traced(cell, args.seed, args.seconds, emit)
    else:
        recorded(cell, args.seed, args.seconds, args.slice, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
