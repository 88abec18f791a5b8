"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  A run builds its inputs from the seed (the
configuration's lattice, the program's melt and start at the seed), warms
up the cell's own shapes (``warmup_frames`` frames), then runs frames for
``--seconds`` (with ``--trace 1``: ``trace_frames`` frames under the
profiler), judges the frames that the seed draws against the plain
reference, and prints, last on standard output, one JSON line:
``correct``, ``attempted`` and ``failed`` frames, the cell's end-to-end
metrics (``--trace 0``) or per-layer metrics (``--trace 1``), the device
and, last, ``checks``: each number compared with its limit, which also
end standard error.  Earlier lines give the card, its power limit and
clocks beside the window, and the versions.

It exits with 2 and prints no result where no card (or fewer than the
cell asks for) is visible, and with 3 where ``jax``, ``jaxlib``, ``flax``
or ``chiron_tpu`` is loaded once the window has closed.  The program's
kernels build once into its own directory inside the checkout
(``chiron_tpu_torch/_build/<hash>/``); the profiler's trace goes to a
temporary directory under ``TMPDIR`` and is deleted once read.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "chiron_tpu")
SMI = "name,power.limit,clocks.sm,clocks.mem,power.draw,temperature.gpu"


def forbidden_modules():
    """The forbidden top-level names among the loaded modules, compared
    whole (``chiron_tpu_torch`` is not ``chiron_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not available ({exc})"


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(sim, draws, picks, seconds=None, frames=None, sync=None):
    """Frames until ``seconds`` have passed or ``frames`` have run.  A
    frame at which the window's position (the share of ``seconds`` or of
    ``frames`` gone) has passed the next of ``draws`` keeps the segment
    that the matching entry of ``picks`` draws; the window's last segment
    is kept too."""
    frame_s, drawn = [], []
    failed = attempted = d = 0
    t0 = prev = time.perf_counter()
    while True:
        pos = (prev - t0) / seconds if frames is None else attempted / frames
        keep = None
        if d < len(draws) and pos >= draws[d]:
            keep = int(picks[d])
            while d < len(draws) and pos >= draws[d]:
                d += 1
        bad, cap, last = sim.frame(keep)
        now = time.perf_counter()
        frame_s.append(now - prev)
        prev = now
        attempted += 1
        failed += int(bad)
        if cap is not None and cap is not last:
            drawn.append(cap)
        if (attempted >= frames) if frames is not None \
                else (now - t0 >= seconds):
            break
    if sync is not None:
        sync()
    return dict(frame_s=frame_s, captures=drawn + [last], window_s=prev - t0,
                attempted=attempted, failed=failed)


def start(cell, seed: int, device):
    """Set ``cell`` up on ``device`` from ``seed`` and warm it: (the
    driver's module, its ``Sim``, the window's draws and picks)."""
    import numpy as np

    from h100bench import systems

    fluid = systems.fluid(cell.config)
    drv = cell.driver()
    sim = drv.Sim(fluid, cell.config, cell.traffic, seed, device)
    for _ in range(cell.traffic["warmup_frames"]):
        sim.frame(None)
    _sync(device)
    rng = np.random.default_rng([seed, 1])
    n = cell.traffic["check_draws"]
    return drv, sim, np.sort(rng.random(n)), rng.integers(0, 1 << 30, n)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float = None, log=print):
    """One run of ``cell`` on ``device``: the result line's object."""
    import numpy as np
    import torch

    from h100bench import trace as tr
    from h100bench.reference import lj as ref

    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    drv, sim, draws, picks = start(cell, seed, dev)
    tf = cell.traffic
    fluid = sim.fluid
    log(f"card {nvidia_smi() if cuda else 'none'} (before the window)")
    setup_s = time.perf_counter() - t0
    reading = dict(setup_s=setup_s, chains=sim.chains, n=fluid.n,
                   dt_ps=fluid.lng.dt)
    if trace:
        w, events, nbytes = tr.profiled(
            lambda: run_window(sim, draws, picks, frames=tf["trace_frames"],
                               sync=lambda: _sync(dev)),
            lambda: sim.frame(None))
        reading["trace"] = tr.reduce(events)
        del events
        log(f"trace: {nbytes} bytes written to a temporary file and deleted")
    else:
        w = run_window(sim, draws, picks, seconds=seconds,
                       sync=lambda: _sync(dev))
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    log(f"card {nvidia_smi() if cuda else 'none'} (after the window)")
    steps = w["attempted"] * sim.steps_per_frame
    reading.update(steps=steps, frame_s=w["frame_s"], window_s=w["window_s"])
    log(f"window: {w['attempted']} frames of {sim.steps_per_frame} steps x "
        f"{sim.chains} chains, {w['failed']} failed, {w['window_s']} s; "
        f"{len(w['captures'])} segments judged; setup {setup_s} s")
    fs = np.asarray(w["frame_s"]) * 1e3
    ends = np.cumsum(fs) * 1e-3
    slices = [int(np.sum((ends > a) & (ends <= a + 5.0)))
              for a in np.arange(0.0, w["window_s"], 5.0)]
    log(f"frame ms: median {np.median(fs)}, p95 {np.percentile(fs, 95)}, "
        f"p99 {np.percentile(fs, 99)}, max {fs.max()}; frames a 5 s slice "
        f"{slices}")

    # the reference, once the window has closed and the peak is read
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_ref = time.perf_counter()
    if trace:
        L = sim.box()
        counts = [ref.pairs_within(sim.end_positions(c), L, fluid.lj.cutoff)
                  for c in w["captures"]]
        reading["pairs"] = float(np.mean(counts))
        log(f"pairs within the cutoff, summed over the chains, at the "
            f"judged segments' ends: {counts}")
    values = drv.judge_segments(sim, w["captures"])
    checks, correct = {}, bool(w["captures"])
    for name, value in values.items():
        limit = cell.limits[name]
        ok = value <= limit
        correct &= ok
        checks[name] = {"value": value if math.isfinite(value) else None,
                        "limit": limit}
    log(f"reference: {time.perf_counter() - t_ref} s")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"])(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": w["attempted"],
              "failed": w["failed"], "metrics": metrics,
              "device": device_info}
    if trace:
        t = reading["trace"]
        device_info.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = t["breakdown"]
    result["checks"] = checks
    return result


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from h100bench import spec

    cell = spec.Cell(ROOT, spec.load(ROOT), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"h100bench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}; {torch.cuda.device_count()} card(s): "
          f"{torch.cuda.get_device_name(0)}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T0)
    bad = forbidden_modules()
    if bad:
        print(f"h100bench: the run loaded {bad}; the benchmark runs the "
              "port alone", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
