"""Tracing and throughput instrumentation (port of
``chiron_tpu/profiling.py``).

* :class:`Throughput` -- steps/s counters over measured sections;
* :func:`trace` -- a context manager around ``torch.profiler`` that writes
  a Chrome/Perfetto trace of the host and the card;
* :func:`timed` -- a wall-clock section timer.

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
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

log = logging.getLogger("chiron_tpu_torch")


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
    is counted."""
    _synchronize(sync)
    t0 = time.perf_counter()
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
