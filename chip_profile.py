#!/usr/bin/env python3
"""Where the time of the port's N=4000 NVT and NpT paths goes, on one NVIDIA
GPU.

    python3 chip_profile.py

Runs the workloads of ``chip_smoke.py`` (``LennardJonesFluid(4000, 0.8)``,
120 K, 2 fs, a 1000-step dense melt, the culled runner at S=40 and slack
0.15, then the culled NpT runner at 100 atm, an attempt every 25 steps,
S=50 and slack 0.2, and the dense NpT runner) and prints:

1. the card's name, power limit, SM clock and power draw, before and after;
2. three timed windows of each runner (3000 steps of each culled runner,
   1000 of each dense one), as seconds and steps/s, on the host's clock
   around a device sync;
3. a ``torch.profiler`` trace of 400 steps of each culled runner and 100 of
   each dense one, after a warm-up of the same length: wall per step
   (profiler on), device busy per step (the union of the kernel, memcpy and
   memset intervals), the device's idle share, and the top device rows with
   their time per launch.

Without a CUDA device it exits nonzero before measuring anything.
"""

import os
import subprocess
import sys
import time

N = 4000
SEED = 1234
WINDOWS = 3
WINDOW_STEPS = {"culled": 3000, "dense": 1000, "culled_npt": 3000,
                "dense_npt": 1000}
PROFILE_STEPS = {"culled": 400, "dense": 100, "culled_npt": 400,
                 "dense_npt": 100}
TOP_ROWS = 14


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _busy_us(intervals):
    """Length of the union of (start, end) intervals, in us."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _profile(label, fn, steps):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise RuntimeError(f"{label}: the profiler recorded no device time")
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in device)
    rows = {}
    for e in device:
        total, count = rows.get(e.name, (0.0, 0))
        rows[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    print(f"== {label}: {steps} steps, wall {wall_us / 1e3:.3f} ms "
          f"({wall_us / steps:.1f} us/step, profiler on), device busy "
          f"{busy / 1e3:.3f} ms ({busy / steps:.1f} us/step), idle share "
          f"{1.0 - busy / wall_us:.3f}")
    ranked = sorted(rows.items(), key=lambda kv: -kv[1][0])
    for name, (total, count) in ranked[:TOP_ROWS]:
        print(f"   {total / 1e3:9.3f} ms {count:6d}x {total / count:9.2f} "
              f"us/launch  {name[:90]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chiron_tpu_torch import units
    from chiron_tpu_torch.ops import _build
    from chiron_tpu_torch.runtime import (
        make_culled_lj_runner,
        make_culled_npt_lj_runner,
        make_fast_lj_runner,
        make_npt_lj_runner,
    )
    from chiron_tpu_torch.testsystems import LennardJonesFluid

    print(f"card before: {_card()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.library()
    dev = torch.device("cuda")
    fluid = LennardJonesFluid(nparticles=N, reduced_density=0.8)
    box = fluid.box_vectors.value_in_unit_system(units.md_unit_system)
    pos0 = fluid.positions.value_in_unit_system(units.md_unit_system)
    common = dict(potential=fluid.potential, n_particles=N,
                  topology=fluid.topology, temperature=120.0 * units.kelvin,
                  timestep=2.0 * units.femtoseconds, device=dev)
    fast = make_fast_lj_runner(**common)
    state = {"dense": fast.run(fast.init(pos0, box, seed=SEED), 1000)}
    runner = make_culled_lj_runner(slack=0.15, segment_steps=40, **common)
    state["culled"] = runner.run(
        runner.init(fast.positions(state["dense"]), box, seed=SEED), 400)
    torch.cuda.synchronize()
    print(f"culled list: nslab={runner.nslab} capacity={runner.capacity} "
          f"count={int(state['culled'].pairs.count)}")

    npt_kw = dict(common, pressure=100.0 * units.atmosphere)
    npt = make_culled_npt_lj_runner(slack=0.2, segment_steps=50,
                                    barostat_interval=25, **npt_kw)
    dnpt = make_npt_lj_runner(barostat_interval=25, **npt_kw)
    melt = runner.positions(state["culled"])
    state["culled_npt"] = npt.run(npt.init(melt, box, seed=SEED), 400)
    state["dense_npt"] = dnpt.run(dnpt.init(melt, box, seed=SEED), 100)
    runs = {"culled": runner.run, "dense": fast.run, "culled_npt": npt.run,
            "dense_npt": dnpt.run}

    def advance(label, steps):
        state[label] = runs[label](state[label], steps)

    for label, steps in WINDOW_STEPS.items():
        seconds = []
        for _ in range(WINDOWS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            advance(label, steps)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        print(f"{label} {steps}-step windows: seconds "
              f"{[round(s, 6) for s in seconds]}, steps/s "
              f"{[round(steps / s, 1) for s in seconds]}")
    runner.check(state["culled"])
    npt.check(state["culled_npt"])
    dnpt.check(state["dense_npt"])
    print(f"culled NpT acceptance {npt.acceptance(state['culled_npt']):.3f}, "
          f"dense NpT {dnpt.acceptance(state['dense_npt']):.3f}")

    for label, steps in PROFILE_STEPS.items():
        _profile(label, lambda: advance(label, steps), steps)
    print(f"card after: {_card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
