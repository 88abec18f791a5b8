"""The reader of the program's pair counters (``metrics/pair_force_share.py``):
the force lanes over the pairs tested, None where the program keeps no
counters or its window ran no culled pass, and its entry's cells."""

from __future__ import annotations

import importlib

import pytest

from conftest import ROOT


def _read():
    return importlib.import_module("h100bench.metrics.pair_force_share").read


def test_the_share_of_a_recorded_session():
    import torch

    from chiron_tpu_torch import profiling

    with profiling.recording():
        profiling.cull_work(torch.device("cpu")).add_(
            torch.tensor([4096, 320]))
    assert _read()(dict(steps=8)) == pytest.approx(320 / 4096)


def test_none_without_counters_or_a_culled_pass(monkeypatch):
    from chiron_tpu_torch import profiling

    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert _read()(dict(steps=8)) is None
    # a program with no counters, as before them
    monkeypatch.delattr(profiling, "counters")
    assert _read()(dict(steps=8)) is None


def test_its_entry_lists_the_culled_cells():
    from h100bench import spec

    bench = spec.load(ROOT)
    m, = [m for m in bench["per_layer"] if m["name"] == "pair_force_share"]
    assert m["source"] == "program_counter" and m["layer"] == "kernels"
    assert m["workloads"] == ["lj32k.culled", "lj4000.fused"]
    for name in m["workloads"]:
        cell = spec.Cell(ROOT, bench, name)
        assert cell.traffic["kind"] == "culled"
        assert callable(cell.reader(m["name"]))
