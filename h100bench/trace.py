"""The traced window: ``torch.profiler`` over a run of frames, its Chrome
trace read back, and the reduction of the trace to what the per-layer
readers take (device operations, busy time, the window) and to the
breakdown (the device operations that took most time, the idle gaps by
what the host was doing)."""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
WINDOW = "h100bench_window"
# the harness's own spans around its calls into the program (the drivers'
# ``record_function`` names)
SPANS = ("segment", "frame_to_host", "latch_read", "iteration")
TOP = 10


def profiled(run_window, warm):
    """Run ``warm()`` in the profiler's warm-up step, then ``run_window()``
    inside the annotation ``WINDOW`` in its active step; returns
    (``run_window``'s result, the trace's events, the bytes of the trace
    file, which is deleted once read).  The active step starts
    10 ms after the warm-up: a trace opened right before a launch can drop
    the first device records."""
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.01)
        with record_function(WINDOW):
            out = run_window()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        nbytes = os.path.getsize(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return out, events, nbytes


def merged(intervals):
    """The union of (start, end) intervals, as disjoint sorted ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def host_at(host, starts, spans, t, reach: int = 4096) -> str:
    """The name of the innermost host call running at ``t``: of the calls
    (sorted by start) that cover it, the one that started last; past
    ``reach`` calls back, the innermost of the harness's own spans."""
    k = bisect.bisect_right(starts, t) - 1
    for i in range(k, max(-1, k - reach), -1):
        if host[i][1] > t:
            return host[i][2][:80]
    cover = [h for h in spans if h[0] <= t < h[1]]
    if cover:
        return min(cover, key=lambda h: h[1] - h[0])[2][:80]
    return "host outside any traced call"


def reduce(events):
    """The traced window's reading: ``window_s``, ``busy_s`` (the union of
    the device operations' intervals within it), ``device_ops`` (kernels,
    copies and fills that start in it) and the breakdown."""
    def iv(e):
        return float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]

    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [iv(e) for e in xs if e["name"] == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    w0, w1, _ = win[0]
    dev = [iv(e) for e in xs if e.get("cat") in DEVICE_CATS
           and w0 <= float(e["ts"]) < w1]
    busy = merged((a, min(b, w1)) for a, b, _ in dev)
    by_name = collections.Counter()
    for a, b, name in dev:
        by_name[name] += (b - a) * 1e-6
    host = sorted(iv(e) for e in xs if e.get("cat") in HOST_CATS
                  and e["name"] != WINDOW)
    starts = [h[0] for h in host]
    spans = [h for h in host if h[2] in SPANS]
    gaps = collections.Counter()
    edges = [w0] + [x for pair in busy for x in pair] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            name = host_at(host, starts, spans, 0.5 * (g0 + g1))
            gaps[name] += (g1 - g0) * 1e-6
    return dict(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        device_ops=len(dev),
        breakdown=dict(
            device_ops=[[k[:80], v] for k, v in by_name.most_common(TOP)],
            idle_gaps=[[k, v] for k, v in gaps.most_common(TOP)]))
