"""``BENCHMARK.json`` and the files it names: every cell, configuration,
traffic mix and metric loads by name; a cell added as files and entries is
found with no existing file edited; the import check."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import sys

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    from h100bench import spec

    return spec.load(ROOT)


def test_every_cell_loads_by_name():
    from h100bench import spec

    bench = _bench()
    for w in bench["workloads"]:
        cell = spec.Cell(ROOT, bench, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.driver().Sim.kind == cell.traffic["kind"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m["name"]))
        assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
        assert cell.per_layer


def test_every_traffic_file_names_a_driver():
    import importlib

    for path in sorted((ROOT / "h100bench" / "traffic").glob("*.json")):
        tf = json.loads(path.read_text())
        mod = importlib.import_module(f"h100bench.drivers.{tf['kind']}")
        assert mod.Sim.kind == tf["kind"] and tf["steps_per_frame"] > 0
        assert len(tf["why"]) <= 200


def test_benchmark_json_keeps_the_contract():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["h100bench"]
    assert bench["command"][1].startswith("h100bench/")
    rs = bench["run_seconds"]
    runs = 2 + 14 * 24
    assert 1 <= rs <= 51
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("h100bench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        names.add(c["name"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == names
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["source"] == "host_clock"
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_cell_added_as_files_is_found(tmp_path):
    """A new configuration, traffic mix, limits, metric and cell go in as
    new files and new entries; every file there before stays as it was."""
    from h100bench import spec

    shutil.copytree(ROOT / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (tmp_path / "h100bench").rglob("*") if p.is_file()}
    here = tmp_path / "h100bench"
    cfg = json.loads((here / "configs" / "lj4000.json").read_text())
    cfg.update(name="lj8000", n_particles=8000)
    (here / "configs" / "lj8000.json").write_text(json.dumps(cfg))
    tf = json.loads((here / "traffic" / "mega.json").read_text())
    tf["runner"]["slack"] = 0.2
    (here / "traffic" / "mega_slack02.json").write_text(json.dumps(tf))
    (here / "limits" / "lj8000.mega.json").write_text(
        (here / "limits" / "lj4000.fused.json").read_text())
    (here / "metrics" / "frames_per_s.py").write_text(
        "def read(r):\n    return len(r['frame_s']) / r['window_s']\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][1], name="lj8000",
                                 file="h100bench/configs/lj8000.json"))
    bench["workloads"].append(dict(name="lj8000.mega", config="lj8000",
                                   traffic="mega_slack02", chips=1,
                                   why="a cell added as data"))
    bench["per_layer"].append(dict(
        name="frames_per_s", unit="frames/s", better="higher",
        source="host_clock", layer="runners and glue", moves="ns_per_day",
        workloads=["lj8000.mega"]))
    cell = spec.Cell(tmp_path, bench, "lj8000.mega", here=here)
    assert cell.config["n_particles"] == 8000
    assert cell.traffic["runner"]["slack"] == 0.2
    assert cell.driver().Sim.kind == "culled"
    assert "frames_per_s" in [m["name"] for m in cell.per_layer]
    assert cell.reader("frames_per_s")(dict(frame_s=[1, 1], window_s=4.0)) \
        == 0.5
    for path, digest in before.items():
        assert hashlib.sha256(path.read_bytes()).hexdigest() == digest


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax", True),
    ("chiron_tpu", True), ("chiron_tpu.ops", True),
    ("chiron_tpu_torch", False), ("chiron_tpu_torch.runtime", False),
    ("jaxtyping", False)])
def test_the_import_check(monkeypatch, name, bad):
    from h100bench import run

    clean = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, name, object())
    assert (run.forbidden_modules() != clean) == bad


def test_the_harness_imports_no_jax():
    """The harness's files name no JAX module and the reference nothing
    of the program."""
    pattern = re.compile(r"^\s*(?:from|import)\s+([A-Za-z_][\w.]*)", re.M)
    for path in (ROOT / "h100bench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        tops = {m.split(".")[0] for m in pattern.findall(path.read_text())}
        assert not tops & {"jax", "jaxlib", "flax", "chiron_tpu"}, path
        if "reference" in path.parts:
            assert "chiron_tpu_torch" not in tops, path
