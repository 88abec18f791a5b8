"""What ``BENCHMARK.json`` names, found by name: a cell, its configuration
file, its traffic file (``traffic/<traffic>.json``), its limits
(``limits/<cell>.json``), the driver of its traffic's kind
(``drivers/<kind>.py``) and a reader a metric (``metrics/<metric>.py``).
Adding any of these is adding files and entries; nothing here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """One entry of ``workloads`` and everything it names."""

    def __init__(self, root: Path, bench: dict, name: str, here: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _json(root / configs[self.workload["config"]]["file"])
        self.traffic = _json(here / "traffic"
                             / f"{self.workload['traffic']}.json")
        self.limits = _json(here / "limits" / f"{name}.json")
        self.chips = self.workload["chips"]
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]
        self.here = here

    def _has(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def driver(self):
        return importlib.import_module(
            f"{__package__}.drivers.{self.traffic['kind']}")

    def reader(self, metric: str):
        path = self.here / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"{__package__}.metrics.{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
