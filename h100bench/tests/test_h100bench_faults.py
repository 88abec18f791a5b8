"""``correct`` comes out false where it should: the control (the reference
in bfloat16, the precision below the configurations' float32, put in the
program's place) and a run whose timed path is broken underneath, one test
a fault the cell can have; and true for a sound run.  The cells at the
CPU's size (``conftest.tiny_cell``), the program's plain versions, the
harness's look for a card skipped.

A cell on one chip exchanges nothing between chips, so that fault has no
case here."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from conftest import tiny_cell

CELLS = ("lj32k.culled", "lj4000.fused", "lj4000.pt16")
# the cells, and the megakernel's traffic on the fused cell's system: its
# cell is out of the benchmark (the program latches in long runs), and its
# judge waits in the driver for it
RUNS = [(c, None) for c in CELLS] + [("lj4000.fused", "mega")]
SEED = 2 ** 31 + 977


def _run(cell):
    from h100bench import run

    return run.run_cell(cell, SEED, 0.5, False, "cpu", log=lambda *a: None)


def _limits_hold(cell, values):
    return all(v <= cell.limits[k] for k, v in values.items())


@pytest.mark.parametrize("name,traffic", RUNS)
def test_a_sound_run_is_correct(name, traffic):
    result = _run(tiny_cell(name, traffic))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1


@pytest.mark.parametrize("name,traffic", RUNS)
def test_the_control_is_not_correct(name, traffic):
    from h100bench import run

    cell = tiny_cell(name, traffic)
    drv, sim, _, _ = run.start(cell, SEED, torch.device("cpu"))
    w = run.run_window(sim, [0.0], [1], frames=2)
    assert _limits_hold(cell, drv.judge_segments(sim, w["captures"]))
    control = drv.judge_segments(sim, w["captures"],
                                 control_dtype=torch.bfloat16)
    assert not _limits_hold(cell, control), control


def _break_culled(monkeypatch, fault):
    """Break the culled runner's segment underneath the harness."""
    from chiron_tpu_torch import runtime

    segment = runtime.CulledLJRunner._segment

    def broken(self, carry, n_steps):
        if fault == "unchanged":
            return carry
        out = segment(self, carry, n_steps)
        n = self.md.n
        if fault == "half":
            # the second half of the particles left standing, the first
            # half's mean force applied to them
            x, v, F = out.x.clone(), out.v.clone(), out.F.clone()
            x[:, n // 2:n] = carry.x[:, n // 2:n]
            v[:, n // 2:n] = carry.v[:, n // 2:n]
            F[:, n // 2:n] = F[:, :n // 2].mean(dim=1, keepdim=True)
            return dataclasses.replace(out, x=x, v=v, F=F).note_step(
                out.step_host)
        x = out.x.clone()
        x[0, n // 3] += 0.01  # one coordinate altered where it is produced
        return dataclasses.replace(out, x=x).note_step(out.step_host)

    monkeypatch.setattr(runtime.CulledLJRunner, "_segment", broken)


def _break_tempering(monkeypatch, fault):
    from chiron_tpu_torch.parallel import tempering

    Sampler = tempering.ParallelTemperingSampler
    advance, mix = Sampler._advance, Sampler.mix_replicas

    def broken_advance(self, n_steps):
        x0, v0 = self.positions, self.velocities
        U, over = advance(self, n_steps)
        if fault == "unchanged":
            self.positions, self.velocities = x0, v0
        elif fault == "half":
            # half of the ladder left out, its energies the mean of the rest
            h = U.shape[0] // 2
            self.positions = torch.cat([self.positions[:h], x0[h:]])
            self.velocities = torch.cat([self.velocities[:h], v0[h:]])
            U = torch.cat([U[:h], U[:h].mean().expand(U.shape[0] - h)])
        elif fault == "energy":
            U = U.clone()
            U[1] *= 1.01
        return U, over

    def broken_mix(self, U, rng):
        mix(self, U, rng)
        if fault == "swap":
            kTs = np.asarray(self.kTs).copy()
            kTs[[0, 1]] = kTs[[1, 0]]
            self.kTs = kTs

    monkeypatch.setattr(Sampler, "_advance", broken_advance)
    monkeypatch.setattr(Sampler, "mix_replicas", broken_mix)


@pytest.mark.parametrize("name,traffic,fault", [
    (c, t, f) for c, t in RUNS if c != "lj4000.pt16"
    for f in ("unchanged", "half", "altered")
] + [("lj4000.pt16", None, f) for f in ("unchanged", "half", "energy",
                                        "swap")])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, traffic,
                                            fault):
    cell = tiny_cell(name, traffic)
    if cell.traffic["kind"] == "tempering":
        _break_tempering(monkeypatch, fault)
    else:
        _break_culled(monkeypatch, fault)
    result = _run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.gpu
def test_run_py_on_the_card(card):
    """``run.py`` end to end on the card: a short window of each cell
    prints a correct result line last."""
    import json
    import subprocess
    import sys

    from conftest import ROOT

    for name in CELLS:
        out = subprocess.run(
            [sys.executable, "h100bench/run.py", "--workload", name,
             "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
