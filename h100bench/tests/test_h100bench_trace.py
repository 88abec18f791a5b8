"""The trace's reduction on a hand-made Chrome trace: busy time as the
union of the device intervals inside the window, the operations counted,
and each idle gap named by the innermost host call running at its middle."""

from __future__ import annotations

import pytest


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_reduce_a_hand_made_trace():
    from h100bench import trace as tr
    from h100bench.metrics import device_idle_share, launches_per_step

    events = [
        _x("user_annotation", tr.WINDOW, 0, 100),
        _x("user_annotation", "iteration", 1, 98),
        _x("kernel", "k1", 10, 20),
        _x("kernel", "k2", 25, 20),         # overlaps k1: counted once
        _x("cpu_op", "aten::mul", 50, 10),
        _x("gpu_memcpy", "copy", 70, 10),
        _x("kernel", "late", 120, 5),       # after the window: left out
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 40},
    ]
    r = tr.reduce(events)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(45e-6)
    assert r["device_ops"] == 3
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx({"iteration": 30e-6, "aten::mul": 25e-6})
    assert dict(r["breakdown"]["device_ops"])["k1"] == pytest.approx(20e-6)
    reading = dict(trace=r, steps=3)
    assert launches_per_step.read(reading) == 1.0
    assert device_idle_share.read(reading) == pytest.approx(0.55)
    with pytest.raises(RuntimeError):
        tr.reduce(events[1:])
