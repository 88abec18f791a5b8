"""The readers of the program's span record (``metrics/_spans.py``): the
sums and the glue's subtraction on a hand-made record, None on an empty one
or where the program keeps none, a reader for every ``program_span``
metric, and the readers on a window of each cell at the CPU's size under
``profiling.recording()``."""

from __future__ import annotations

import importlib
import time

import pytest

from conftest import ROOT, tiny_cell

NEW = ("glue_us_per_step", "wrapper_us_per_step", "host_wait_us_per_step")
US = 1000  # ns


def _readers():
    return {name: importlib.import_module(f"h100bench.metrics.{name}").read
            for name in NEW}


# (name, parent, t0_ns, t1_ns): two segments, an iteration, a latch read
RECORD = [
    ("chiron.segment", -1, 0, 100 * US),             # 0
    ("chiron.sort", 0, 5 * US, 15 * US),             # 1
    ("chiron.op.sort_build", 1, 6 * US, 14 * US),    # 2: inside the sort
    ("chiron.op.culled_md", 0, 20 * US, 60 * US),    # 3
    ("chiron.op.inner", 3, 30 * US, 40 * US),        # 4: counted in 3
    ("chiron.sync.latch", -1, 100 * US, 130 * US),   # 5: outside the glue
    ("chiron.pt.iteration", -1, 200 * US, 400 * US), # 6
    ("chiron.pt.propagate", 6, 210 * US, 390 * US),  # 7
    ("chiron.op.lj_dense_replicas", 7, 220 * US, 250 * US),  # 8
    ("chiron.sync.energies", 7, 300 * US, 380 * US),  # 9
    ("chiron.segment", -1, 500 * US, None),          # 10: open, left out
    ("chiron.op.culled_md", 10, 510 * US, 520 * US),  # 11: a wrapper
]


def test_the_readers_on_a_hand_made_record(monkeypatch):
    from chiron_tpu_torch import profiling

    from h100bench.metrics import _spans

    monkeypatch.setattr(profiling, "spans", lambda: list(RECORD))
    parts = _spans.split(RECORD)
    # glue: (100 - 8 - 40) + (200 - 30 - 80); the open segment counts in
    # no glue, its culled_md in the wrappers
    assert parts == dict(glue=(52 + 90) * US, wrapper=(8 + 40 + 30 + 10)
                         * US, wait=(30 + 80) * US)
    r = dict(steps=4)
    got = {name: read(r) for name, read in _readers().items()}
    assert got == pytest.approx({
        "glue_us_per_step": 142 / 4, "wrapper_us_per_step": 88 / 4,
        "host_wait_us_per_step": 110 / 4})


def test_the_readers_give_none_without_a_record(monkeypatch):
    from chiron_tpu_torch import profiling

    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert all(read(dict(steps=4)) is None for read in _readers().values())
    monkeypatch.setattr(profiling, "spans", lambda: list(RECORD))
    assert all(read(dict(steps=0)) is None for read in _readers().values())
    # a program with no span recorder, as before the spans
    monkeypatch.delattr(profiling, "spans")
    assert all(read(dict(steps=4)) is None for read in _readers().values())


def test_every_program_span_metric_has_a_reader():
    from h100bench import spec

    bench = spec.load(ROOT)
    spans = [m for m in bench["per_layer"] if m["source"] == "program_span"]
    assert sorted(m["name"] for m in spans) == sorted(NEW)
    for m in spans:
        cell = spec.Cell(ROOT, bench, m["workloads"][0])
        assert callable(cell.reader(m["name"]))


@pytest.mark.parametrize("name", ["lj32k.culled", "lj4000.fused",
                                  "lj4000.pt16"])
def test_the_readers_on_a_recorded_window(name):
    """A window of 2 frames at the CPU's size: every reader has a value,
    and the three parts fit inside the window's wall time."""
    import torch

    from chiron_tpu_torch import profiling

    from h100bench import run

    cell = tiny_cell(name)
    _, sim, draws, picks = run.start(cell, 2 ** 31 + 5, torch.device("cpu"))
    t0 = time.perf_counter()
    with profiling.recording():
        w = run.run_window(sim, draws, picks, frames=2)
    wall_us = (time.perf_counter() - t0) * 1e6
    r = dict(steps=w["attempted"] * sim.steps_per_frame)
    got = {m: read(r) for m, read in _readers().items()}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert sum(got.values()) * r["steps"] <= wall_us
