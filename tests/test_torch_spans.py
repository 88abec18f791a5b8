"""The port's spans (``chiron_tpu_torch.profiling``): nothing recorded while
recording is off, the profiler's warm-up step left out, the Chrome trace's
annotations, sessions, and the spans of a culled segment and of a tempering
iteration on the CPU.  No JAX."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

import chiron_tpu_torch.profiling as prof
import chiron_tpu_torch.runtime as rt
import chiron_tpu_torch.testsystems as ts
import chiron_tpu_torch.units as units
from chiron_tpu_torch.parallel import make_replica_mesh
from chiron_tpu_torch.parallel.tempering import ParallelTemperingSampler

MD = units.md_unit_system


def _names(record):
    return [name for name, *_ in record]


def _children(record, parent_name):
    """The names of the spans under the first span named ``parent_name``,
    at any depth."""
    root = _names(record).index(parent_name)

    def under(i):
        p = record[i][1]
        while p >= 0:
            if p == root:
                return True
            p = record[p][1]
        return False

    return {name for i, (name, *_) in enumerate(record) if under(i)}


def test_a_span_with_recording_off_is_the_shared_no_op():
    with prof.recording():
        with prof.span("chiron.test.kept"):
            pass
    first = prof.span("chiron.test.off")
    assert first is prof.span("chiron.test.other")
    with first as entered:
        assert entered is first
    assert _names(prof.spans()) == ["chiron.test.kept"]


def test_the_profiler_records_its_active_step_alone(tmp_path):
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1)) as p:
        with prof.span("chiron.test.warmup"):
            torch.ones(8).sum()
        p.step()
        with prof.span("chiron.test.outer"):
            with prof.span("chiron.test.inner"):
                torch.ones(8).sum()
    record = prof.spans()
    assert [(n, parent) for n, parent, _, _ in record] == [
        ("chiron.test.outer", -1), ("chiron.test.inner", 0)]
    (_, _, a0, a1), (_, _, b0, b1) = record
    assert a0 <= b0 <= b1 <= a1
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    notes = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"}
    assert "chiron.test.warmup" not in notes
    inner = notes["chiron.test.inner"]
    lo, hi = inner["ts"], inner["ts"] + inner["dur"]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::")]
    assert any(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in ops)


def test_recording_without_a_profiler_and_a_new_session_replaces():
    with prof.recording():
        with prof.span("chiron.test.a"):
            with prof.span("chiron.test.b"):
                pass
        with prof.span("chiron.test.c"):
            pass
    record = prof.spans()
    assert [(n, parent) for n, parent, _, _ in record] == [
        ("chiron.test.a", -1), ("chiron.test.b", 0), ("chiron.test.c", -1)]
    assert all(t1 >= t0 for _, _, t0, t1 in record)
    totals = prof.totals()
    a, b = totals["chiron.test.a"], totals["chiron.test.b"]
    assert a["count"] == 1 and a["self_s"] == pytest.approx(
        a["total_s"] - b["total_s"])
    c0 = record[2][2]
    assert list(prof.totals(start_ns=c0)) == ["chiron.test.c"]
    assert set(prof.totals(end_ns=c0)) == {"chiron.test.a", "chiron.test.b"}
    with prof.recording():
        with prof.span("chiron.test.d"):
            pass
    assert _names(prof.spans()) == ["chiron.test.d"]
    assert prof.dropped() == 0


def test_timed_is_a_span_that_logs(caplog):
    with caplog.at_level("INFO", logger="chiron_tpu_torch"):
        with prof.recording():
            with prof.timed("chiron.test.timed"):
                pass
    assert _names(prof.spans()) == ["chiron.test.timed"]
    assert "[timed] chiron.test.timed" in caplog.text


def test_a_culled_segment_and_the_latch_read_are_spans():
    """N=1000 at rho* 0.8, tiles 8 x 16, one 4-step segment on the default
    path (``tests/test_torch_runtime.py``'s system)."""
    fluid = ts.LennardJonesFluid(nparticles=1000, reduced_density=0.8)
    runner = rt.make_culled_lj_runner(
        potential=fluid.potential, n_particles=1000, topology=fluid.topology,
        temperature=120.0 * units.kelvin, timestep=2.0 * units.femtoseconds,
        tm=8, tn=16, slack=0.15, segment_steps=4, device="cpu")
    state = runner.init(fluid.positions.value_in_unit_system(MD),
                        fluid.box_vectors.value_in_unit_system(MD), seed=3)
    with prof.recording():
        state = runner.segment_fn(4)(state)
        runner.check(state)
    record = prof.spans()
    assert _names(record)[0] == "chiron.segment"
    assert {"chiron.sort", "chiron.build", "chiron.op.culled_md"} <= \
        _children(record, "chiron.segment")
    latch = [parent for name, parent, _, _ in record
             if name == "chiron.sync.latch"]
    assert latch == [-1]


def test_a_tempering_iteration_is_spans():
    """2 rungs of N=64 at rho* 0.5 on the dense chain, ``run(1, 2)``."""
    fluid = ts.LennardJonesFluid(nparticles=64, reduced_density=0.5)
    pt = ParallelTemperingSampler(
        potential=fluid.potential,
        temperatures=[120.0 * units.kelvin, 130.0 * units.kelvin],
        mesh=make_replica_mesh(device="cpu"))
    pt.initialize(np.asarray(fluid.positions.value_in_unit_system(MD),
                             np.float32),
                  box_vectors=np.asarray(
                      fluid.box_vectors.value_in_unit_system(MD), np.float32),
                  seed=5)
    assert pt._dense_op is not None
    with prof.recording():
        pt.run(1, 2, seed=2)
    record = prof.spans()
    assert _names(record).count("chiron.pt.iteration") == 1
    inside = _children(record, "chiron.pt.iteration")
    assert {"chiron.pt.propagate", "chiron.pt.noise", "chiron.pt.report",
            "chiron.pt.swap", "chiron.sync.energies",
            "chiron.op.lj_dense_replicas"} <= inside
    # K1 over replicas: the first force, one a step, the energy
    assert prof.totals()["chiron.op.lj_dense_replicas"]["count"] == 4
