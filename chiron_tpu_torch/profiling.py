"""Tracing and throughput instrumentation (port of
``chiron_tpu/profiling.py``).

* :func:`span` -- a named section of the program, recorded while recording
  is on (:func:`spanned`: each call of a function as one);
  :func:`recording`, :func:`spans`, :func:`totals`, :func:`dropped` and
  :func:`counters` are the operator's interface to the record;
* :class:`Throughput` -- steps/s counters over measured sections;
* :func:`trace` -- a context manager around ``torch.profiler`` that writes
  a Chrome/Perfetto trace of the host and the card;
* :func:`timed` -- a wall-clock section timer that logs its time (and is a
  span).

Spans.  Recording is on while a ``torch.profiler`` profile records (not in
a schedule's wait or warm-up steps) or inside ``with recording():``, which
records in memory only, with no profiler: the cheap way to time the host's
phases of a production run.  A span entered then appends ``(name, parent,
t0_ns, t1_ns)`` to the record (``time.perf_counter_ns``; ``parent`` is the
index of the enclosing span, or -1; ``t1_ns`` is None while it is open)
and, under the profiler, also opens the annotation that
``torch.profiler.record_function(name)`` opens, so the exported trace shows
it as a ``user_annotation`` on the kernels' timeline.
With recording off a span is one shared no-op object.  The record holds
one session: the first span entered after recording was off starts a new
one and replaces it, so ``spans()`` after a profiled window is that
window's.  It keeps at most ``MAX_SPANS`` spans; ``dropped()`` counts the
rest.  The recorder serves one thread.

The program's spans (prefix ``chiron.``), on the paths of the culled
runner and the tempering sampler:

* ``chiron.segment``: a culled segment (``CulledLJRunner.segment_fn``'s
  body, the megakernel's too); inside it ``chiron.sort`` (the torch sort),
  ``chiron.build`` (``build_tile_pairs``) and the wrapper spans;
* ``chiron.pt.iteration``: one pass of ``ParallelTemperingSampler.run``;
  inside it ``chiron.pt.propagate``, ``chiron.pt.noise`` (each block of
  noise the chain draws), ``chiron.pt.report`` and ``chiron.pt.swap``;
* ``chiron.op.<kernel>``: a kernel wrapper's whole entry (its checks,
  allocations, torch ops and the C call), ``<kernel>`` being its key in
  ``ops._build.launches``: ``culled_md`` (``CulledLJMD.run_segment``),
  ``sort_build``, ``mega_md`` (``lj_mega.mega_segment``) and
  ``lj_dense_replicas`` (``LJDense.force_only_r``, ``force_energy_r``);
* ``chiron.sync.<what>``: the host blocked on a device value:
  ``latch`` (a culled runner's ``check``), ``step`` (``CullCarry.step_host``
  read from the device) and ``energies`` (the tempering sampler's read of
  U); its count is the count of such host syncs.

Counters.  While recording is on, the culled pair pass's wrappers
(``CulledLJMD.run_segment``, ``culled_force_pass``, ``culled_force_energy``,
``lj_mega.mega_segment``) hand their kernels the session's device buffer of
:func:`cull_work`, to which every pair block adds, with one integer atomic
each, the pairs it tested and the lanes that ran its LJ term; off, they
pass null.  :func:`counters` reads the totals once, when asked:

* ``chiron.count.cull_pairs_tested``: pairs that took the distance test
  (the listed pairs of the warps the bounding-box cull kept);
* ``chiron.count.cull_force_lanes``: lanes that ran the LJ term, 32 RPT
  (rows a lane) a column step whose warp vote passed
  (``csrc/lj_cull_force.cu``, ``scripts/cull_work.py``).

>>> with recording():
...     state = runner.run(state, 4000)
>>> totals()["chiron.segment"]
{'count': 100, 'total_s': ..., 'self_s': ...}

Where JAX blocks on a ``sync`` array (``block_until_ready``), these take a
CUDA synchronization: ``sync`` is a tensor (its device is synchronized), a
device, or ``True`` for the current CUDA device, so that device work is
measured.  JAX's ``enable_nan_debugging`` (``jax_debug_nans``) maps to
``torch.autograd.set_detect_anomaly``, which is narrower: it raises on a NaN
that a backward pass produces, not on one of a forward operation (the MC
chains' NaN guard is the production mechanism in both packages).
"""

from __future__ import annotations

import contextlib
import functools
import logging
import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

log = logging.getLogger("chiron_tpu_torch")

MAX_SPANS = 1 << 20
_profiling = torch.autograd._profiler_enabled
# the user annotation that ``record_function`` makes, at a third of its cost
# under the profiler (no operator dispatch)
_annotate = torch.autograd._record_function_with_args_enter
_annotate_end = torch.autograd._record_function_with_args_exit


class _Record:
    """One session of spans: ``spans`` as [name, parent, t0_ns, t1_ns]
    lists, the indices of the ``open`` ones, the count ``dropped`` past
    ``MAX_SPANS``."""

    __slots__ = ("spans", "open", "dropped", "counts")

    def __init__(self):
        self.spans: List[list] = []
        self.open: List[int] = []
        self.dropped = 0
        self.counts: Dict[torch.device, torch.Tensor] = {}


class _Recorder:
    """The process's recorder: ``depth`` open ``recording()`` contexts, the
    current ``record``, and ``fresh``: the next recorded span starts a new
    session."""

    __slots__ = ("depth", "record", "fresh")

    def __init__(self):
        self.depth = 0
        self.record = _Record()
        self.fresh = True


_recorder = _Recorder()

# the counters of cull_work's buffer, in its order
CULL_WORK = ("chiron.count.cull_pairs_tested", "chiron.count.cull_force_lanes")


def _session() -> _Record:
    """The current session's record; the first call after recording was
    off starts a new one."""
    rec = _recorder
    if rec.fresh:
        rec.record, rec.fresh = _Record(), False
    return rec.record


class _Off:
    """The span while recording is off: one shared object, doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """A span while recording is on."""

    __slots__ = ("name", "record", "index", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        record = self.record = _session()
        self.annotation = _annotate(self.name) if _profiling() else None
        spans = record.spans
        if len(spans) < MAX_SPANS:
            self.index = len(spans)
            parent = record.open[-1] if record.open else -1
            spans.append([self.name, parent, time.perf_counter_ns(), None])
            record.open.append(self.index)
        else:
            self.index = -1
            record.dropped += 1
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        record = self.record
        if self.index >= 0:
            record.spans[self.index][3] = t1
            record.open.remove(self.index)
        if self.annotation is not None:
            _annotate_end(self.annotation)
        return False


def span(name: str):
    """A context manager over a named section: recorded while recording is
    on (see the module docstring), the shared no-op object otherwise."""
    if _recorder.depth or _profiling():
        return _Span(name)
    _recorder.fresh = True
    return _OFF


def spanned(name: str):
    """Decorate a function so that each call is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def recording():
    """Record spans in memory, with no profiler, inside the block; outside
    any other recording, it starts a new session."""
    rec = _recorder
    if not (rec.depth or _profiling()):
        rec.fresh = True
    rec.depth += 1
    try:
        yield
    finally:
        rec.depth -= 1
        if not (rec.depth or _profiling()):
            rec.fresh = True


def spans() -> List[tuple]:
    """The record of the last session: ``(name, parent, t0_ns, t1_ns)`` a
    span, in the order they were entered."""
    return [tuple(s) for s in _recorder.record.spans]


def cull_work(device):
    """While recording is on, the session's (2,) int64 buffer on ``device``
    that the culled pair kernels add their work to (``CULL_WORK``), made on
    first use; None while it is off."""
    if not (_recorder.depth or _profiling()):
        return None
    counts = _session().counts
    buf = counts.get(device)
    if buf is None:
        buf = counts[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return buf


def counters() -> Dict[str, int]:
    """The last session's counters, summed over its devices (each
    device's buffer read once); empty where no kernel counted."""
    out: Dict[str, int] = {}
    for buf in _recorder.record.counts.values():
        for name, value in zip(CULL_WORK, buf.tolist()):
            out[name] = out.get(name, 0) + value
    return out


def dropped() -> int:
    """The spans of the last session that ``MAX_SPANS`` left out."""
    return _recorder.record.dropped


def totals(start_ns: int = None, end_ns: int = None
           ) -> Dict[str, Dict[str, float]]:
    """Per span name in the record: ``count``, ``total_s`` and ``self_s``
    (the spans' time less the time their children cover), closed spans
    only, the longest total first; with ``start_ns``/``end_ns``
    (``time.perf_counter_ns``), only the spans that start in between."""
    record = spans()
    lo = -math.inf if start_ns is None else start_ns
    hi = math.inf if end_ns is None else end_ns
    child_ns = [0] * len(record)
    for name, parent, t0, t1 in record:
        if parent >= 0 and t1 is not None:
            child_ns[parent] += t1 - t0
    out: Dict[str, Dict[str, float]] = {}
    for i, (name, _, t0, t1) in enumerate(record):
        if t1 is None or not lo <= t0 < hi:
            continue
        t = out.setdefault(name, dict(count=0, total_s=0.0, self_s=0.0))
        t["count"] += 1
        t["total_s"] += (t1 - t0) * 1e-9
        t["self_s"] += (t1 - t0 - child_ns[i]) * 1e-9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["total_s"]))


def _synchronize(sync) -> None:
    """Wait for the device work behind ``sync`` (see the module docstring)."""
    if sync is None or sync is False:
        return
    if torch.is_tensor(sync):
        if sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
        return
    if sync is True:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    device = torch.device(sync)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Throughput:
    """Steps/s accounting over measured sections.

    >>> tp = Throughput()
    >>> with tp.measure(n_steps=1000, sync=True):
    ...     state = runner.run(state, 1000)
    >>> tp.steps_per_second
    """

    total_steps: int = 0
    total_seconds: float = 0.0
    sections: List[float] = field(default_factory=list)

    @contextlib.contextmanager
    def measure(self, n_steps: int, sync=None):
        _synchronize(sync)
        t0 = time.perf_counter()
        yield
        _synchronize(sync)
        dt = time.perf_counter() - t0
        self.total_steps += n_steps
        self.total_seconds += dt
        self.sections.append(dt)

    @property
    def steps_per_second(self) -> float:
        if self.total_seconds == 0:
            return 0.0
        return self.total_steps / self.total_seconds

    @property
    def steps_per_minute(self) -> float:
        return self.steps_per_second * 60.0

    def report(self) -> Dict[str, float]:
        return {
            "total_steps": self.total_steps,
            "total_seconds": round(self.total_seconds, 4),
            "steps_per_second": round(self.steps_per_second, 2),
            "steps_per_minute": round(self.steps_per_minute, 1),
        }


@contextlib.contextmanager
def trace(log_dir: str = "chiron_tpu_torch_trace"):
    """Profile the block with ``torch.profiler`` (the CPU, and the card
    where there is one) and write ``trace.json`` under ``log_dir``, which
    Perfetto and ``chrome://tracing`` read; yields the profiler, whose
    ``key_averages()`` tabulates the kernels.

    >>> with trace("output/tr") as prof:
    ...     state = runner.run(state, 1000)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _synchronize(True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


@contextlib.contextmanager
def timed(name: str, sync=None):
    """Wall-clock a section, synchronizing on ``sync`` so that device work
    is counted, and log its time; the section is also the span ``name``."""
    _synchronize(sync)
    t0 = time.perf_counter()
    with span(name):
        yield
        _synchronize(sync)
    dt = time.perf_counter() - t0
    log.info("[timed] %s: %.4fs", name, dt)


def enable_nan_debugging(enable: bool = True) -> None:
    """A NaN tripwire for debugging: ``torch.autograd.set_detect_anomaly``,
    which raises with a traceback where a backward pass produces a NaN
    (narrower than JAX's ``jax_debug_nans``, which checks every operation;
    see the module docstring).  Expensive; for debugging only."""
    torch.autograd.set_detect_anomaly(enable)
