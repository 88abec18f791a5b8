"""The reader of K1's chunk counters (``metrics/dense_chunk_share.py``): the
chunks tested over the chunks visited, None where the program keeps no such
counters or its window ran no K1, and its entry's cell."""

from __future__ import annotations

import importlib

import pytest

from conftest import ROOT


def _read():
    return importlib.import_module("h100bench.metrics.dense_chunk_share").read


def test_the_share_of_a_recorded_session():
    import torch

    from chiron_tpu_torch import profiling

    with profiling.recording():
        profiling.dense_work(torch.device("cpu")).add_(
            torch.tensor([262144, 78643]))
        # the culled pass's counters leave it alone
        profiling.cull_work(torch.device("cpu")).add_(torch.tensor([4096, 320]))
    assert _read()(dict(steps=8)) == pytest.approx(78643 / 262144)


def test_none_without_counters_or_a_k1_launch(monkeypatch):
    from chiron_tpu_torch import profiling

    # a program whose counters are the culled pass's only, as before K1's
    monkeypatch.setattr(profiling, "counters", lambda: {
        "chiron.count.cull_pairs_tested": 4096,
        "chiron.count.cull_force_lanes": 320})
    assert _read()(dict(steps=8)) is None
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert _read()(dict(steps=8)) is None
    monkeypatch.delattr(profiling, "counters")
    assert _read()(dict(steps=8)) is None


def test_its_entry_lists_the_tempering_cell():
    from h100bench import spec

    bench = spec.load(ROOT)
    m, = [m for m in bench["per_layer"] if m["name"] == "dense_chunk_share"]
    assert m["source"] == "program_counter" and m["layer"] == "kernels"
    assert m["moves"] == "ns_per_day" and m["better"] == "lower"
    assert m["workloads"] == ["lj4000.pt16"]
    assert bench["per_layer"][-1] is m
    cell = spec.Cell(ROOT, bench, "lj4000.pt16")
    assert cell.traffic["kind"] == "tempering"
    assert callable(cell.reader(m["name"]))
