"""Tiny cells for the CPU: the benchmark's cells with their sizes cut so
that the program's plain versions run a frame in about a second."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_cell(name: str, traffic: str = None):
    """The cell ``name`` of ``BENCHMARK.json`` (with the traffic file
    ``traffic`` in place of its own, if given) at a size the CPU runs: 2048
    particles (500 a rung for tempering, 4 rungs), 4-step segments, frames
    of 8 steps, one draw."""
    import json

    from h100bench import spec

    cell = spec.Cell(ROOT, spec.load(ROOT), name)
    if traffic is not None:
        cell.traffic = json.loads(
            (ROOT / "h100bench" / "traffic" / f"{traffic}.json").read_text())
    cfg = dict(cell.config, melt_steps=min(20, cell.config["melt_steps"]))
    if cfg["lattice"] == "fcc":
        cfg.update(n_particles=2048, unit_cells=8)
    else:
        cfg.update(n_particles=500 if cell.traffic["kind"] == "tempering"
                   else 2048)
    tf = dict(cell.traffic, steps_per_frame=8, warmup_frames=1,
              check_draws=1)
    if "runner" in tf:
        tf["runner"] = dict(tf["runner"], segment_steps=4)
    else:
        tf["rungs"] = 4
    cell.config, cell.traffic = cfg, tf
    return cell


@pytest.fixture
def card():
    """The CUDA device, decided here (never at import); skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: no CUDA device is visible")
    return torch.device("cuda", 0)
