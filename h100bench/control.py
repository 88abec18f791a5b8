"""Readings for the limits of a cell: the program's numbers compared on
many seeds, and the control's on some of them, in one process.

    python3 h100bench/control.py --workload <name> --seeds 1,2,3 \
        --seconds 3 [--control-seeds 1,2,3] [--out FILE]

For each seed it sets the cell up, warms it and runs a window of
``--seconds`` as ``run.py`` does, then judges the drawn segments twice:
the program's outputs against the reference, and (for the seeds in
``--control-seeds``) the control's, the reference computed in bfloat16 (the
precision below the configuration's float32) from the same starts.  The
benchmark's own runs never run it.  One JSON line a seed, on standard
output and appended to ``--out``.
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


def readings(cell, seed: int, seconds: float, control: bool, device):
    import torch

    from h100bench import run

    t0 = time.perf_counter()
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
    drv, sim, draws, picks = run.start(cell, seed, dev)
    w = run.run_window(sim, draws, picks, seconds=seconds)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = dict(seed=seed, attempted=w["attempted"], failed=w["failed"],
               judged=len(w["captures"]),
               program=drv.judge_segments(sim, w["captures"]))
    if control:
        out["control"] = drv.judge_segments(sim, w["captures"],
                                            control_dtype=torch.bfloat16)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from h100bench import spec

    cell = spec.Cell(ROOT, spec.load(ROOT), args.workload)
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(dict(workload=args.workload, **readings(
            cell, seed, args.seconds, seed in ctrl, "cuda")))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
