#!/usr/bin/env python3
"""Where the time of the port's LJ paths goes, on one NVIDIA GPU: NVT and NpT
at N=4000, the band runner at N=100,000, the strip runner at N=4000 and the
spatial runners at N=100,000.

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
   their time per launch; then of 10 calls of K3's segment alone (S=40, one
   C call each, with the latch) on the culled state;
4. the band runner (``make_lj_runner(engine="auto")`` at N=100,000, melted
   from the lattice by 2000 band steps) and the culled runner (S=50, slack
   0.2, as ``benchmarks/large_n.py`` tunes it above 16k), both started from
   the melted state: 500-step windows in the order band, culled, culled,
   band; then, from the band state and one noise seed, 500-step windows of
   the band runner (a sorted candidate every step, chosen on the device)
   against a copy that reads ``stale`` on the host and sorts only when it
   holds, twice in the order device, host, host, device, with their end
   states required equal; then profiler rows of 50 band and 100 culled steps;
   the strip runner at N=4000 from the culled NVT state: three 3000-step
   windows, then 400 profiled steps (its force pass is one kernel,
   ``strip_pairs``); 100 calls of the strip force with the energy (K7's
   energy instantiation and its sum) on the runner's last layout; and 100
   calls of the drift latch on the N=100,000 culled state;
5. the spatial runners on a mesh of this process alone, from the same
   melted N=100,000 state: windows of the banded one (500 steps, S=25) and
   the dense one (100 steps) in the order band, dense, dense, band,
   profiler rows of 50 and 10 steps, and of three calls each of the sharded
   force with the energy and of the runners' energy (K2);
6. the last three kernels' paths at N=4000, each started from the culled
   NVT state: ``FusedLJMD`` (K9, calls of 100 steps with ``step_offset``)
   and the culled runner (S=40, slack 0.15) with ``fused_rebuild`` (K10)
   and with ``megakernel`` (K11, pure x, P=16): 3000-step windows beside
   the default culled runner's, in the order default, fused_rebuild,
   megakernel, fused and back, then profiler rows of 400 steps of each, and
   the count and entries per row tile of each culled path's last list.

Then, where the strip runner latched, it replays the strip runner from its
first state segment by segment (the run is bitwise repeatable) and says
which of its checks fired first: the band width W + (n_pad - n) against the
halo H at a segment's head, or the top-2 joint drift from the sort against
the slack at its end.

    python3 chip_profile.py --strip-latch DIR

runs that replay alone on the state the profile's strip runner starts from
(the dense melt, 400 culled steps, then the strip runner's ``init``) over
as many segments as the profile runs, prints each segment's numbers and
writes them, with that first state, to ``DIR/strip_latch.npz``
(``scripts/strip_latch_reference.py`` replays the JAX package's strip
runner from it on the CPU).

    python3 chip_profile.py --segment-dump OUT [REF]

writes K3's segments (NVT, exact reciprocal, NpT), a megakernel segment and
K10's and ``tile_build``'s outputs on its order from one state to ``OUT``
and, given another tree's ``REF``, compares them bit for bit
(``segment_dump``); it runs in the parent tree too.

Without a CUDA device it exits nonzero before measuring anything.
"""

import copy
import os
import subprocess
import sys
import time
from dataclasses import replace

N = 4000
SEED = 1234
MELT_STEPS = 1000
WINDOWS = 3
WINDOW_STEPS = {"culled": 3000, "dense": 1000, "culled_npt": 3000,
                "dense_npt": 1000}
PROFILE_STEPS = {"culled": 400, "dense": 100, "culled_npt": 400,
                 "dense_npt": 100}
TOP_ROWS = 14
N_BAND = 100_000
BAND_MELT_STEPS = 2000
BIG_WINDOW_STEPS = 500
BIG_PROFILE_STEPS = {"band": 50, "culled_100k": 100, "strip": 400,
                     "spatial_band": 50, "spatial_dense": 10}
SPATIAL_WINDOW_STEPS = {"spatial_band": 500, "spatial_dense": 100}
NEW_PATHS = ("culled", "fused_rebuild", "megakernel", "fused")
NEW_WINDOW_STEPS = 3000
NEW_PROFILE_STEPS = 400
FUSED_CALL = 100
ONE_SHOT_CALLS = 3
STRIP_ENERGY_CALLS = 100
STRIP_WINDOW_STEPS = 3000
SEGMENT_STEPS = 40
SEGMENT_CALLS = 10
LATCH_CALLS = 100
# the strip segments the profile runs: three windows, then the profiler's
# warm-up and recorded calls
STRIP_SEGMENTS = (WINDOWS * STRIP_WINDOW_STEPS
                  + 2 * BIG_PROFILE_STEPS["strip"]) // 50


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
    """Profile one call of ``fn`` after a warm-up call.  The warm-up runs
    inside the profiler's own warm-up phase, and the recorded call starts
    10 ms after it: a trace opened right before a launch dropped the first
    device records, which lost whole one-kernel calls.  The step's own
    annotation on the device timeline is not device work."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.01)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith("ProfilerStep")]
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


def _host_checked(band):
    """A copy of the band runner whose step reads ``stale`` on the host (one
    sync a step) and sorts only when it holds, counting those re-sorts.  It
    shares the runner's calibrated band."""

    class HostChecked(type(band)):
        resorts = 0

        def _resort(self, x, v, state, stale):
            if not bool(stale):
                return x, v, state.ref_x, state.overflowed
            self.resorts += 1
            return self._sorted(x, v, state)

    hc = copy.copy(band)
    hc.__class__ = HostChecked
    return hc


def strip_replay(strip, start, n_segments, steps, dump=None):
    """Replay ``strip`` from ``start`` one segment at a time, with the
    segment head's band width and the end's top-2 drift beside the latch;
    print the first latching segment and a summary, and with ``dump`` write
    every segment's numbers and ``start`` to ``dump/strip_latch.npz``.
    Returns the first latching segment or None."""
    import numpy as np
    import torch

    from chiron_tpu_torch.ops.lj_cull import (
        live_nonfinite,
        skin_drift_top2_plain,
        tile_skin_drift_bad,
    )
    from chiron_tpu_torch.ops.lj_strip import _PAD_X, sort_by_key_strip

    md = strip.md
    n, n_pad, H = md.n, md.n_pad, md.H
    s, first, rows = start, None, []
    for k in range(n_segments):
        center = s.x[:, :n_pad]
        nonfinite = bool(live_nonfinite(center, n))
        x3s, _ = sort_by_key_strip(torch.where(strip.valid, center, _PAD_X),
                                   ())
        width = int(strip._width(x3s, s.box_diag[0, 0])) + (n_pad - n)
        s1 = strip.segment(s, steps)
        x_end = s1.x[:, :n_pad].contiguous()
        top2 = float(skin_drift_top2_plain(x_end, x3s, n, s.box_diag))
        kernel = bool(tile_skin_drift_bad(x_end, x3s, n, md.slack_t,
                                          s.box_diag))
        latched = bool(s1.overflowed) and not bool(s.overflowed)
        rows.append((k, width, top2, kernel, nonfinite, latched))
        if latched and first is None:
            first = k
            print(f"strip replay: segment {k} (steps {k * steps}-"
                  f"{(k + 1) * steps}) latched first: band width "
                  f"W + (n_pad - n) = {width} against H = {H} "
                  f"({'fired' if width > H else 'held'}), top-2 drift "
                  f"{top2:.6f} nm against the slack {md.slack} "
                  f"({'fired' if top2 > md.slack else 'held'}; the latch "
                  f"kernel says {kernel}), non-finite {nonfinite}")
        s = s1
    w = np.array([r[1] for r in rows])
    t = np.array([r[2] for r in rows])
    print(f"strip replay: {n_segments} segments of {steps} steps, H = {H}: "
          f"band width {w.min()}-{w.max()} (over H in "
          f"{int((w > H).sum())}), top-2 drift {t.min():.6f}-{t.max():.6f} "
          f"nm (over the slack in {int((t > md.slack).sum())}), the latch "
          f"kernel set in {sum(r[3] for r in rows)}, first latch "
          f"{first}")
    print("strip replay rows (segment, W + pad, top-2 drift): "
          + " ".join(f"{k}:{wk}:{tk:.4f}"
                     for k, wk, tk, *_ in rows[::max(1, n_segments // 28)]))
    if dump is not None:
        os.makedirs(dump, exist_ok=True)
        np.savez(os.path.join(dump, "strip_latch.npz"),
                 x=start.x.cpu().numpy(), v=start.v.cpu().numpy(),
                 F=start.F.cpu().numpy(),
                 step=start.step.cpu().numpy(),
                 box_diag=start.box_diag.cpu().numpy(), H=H, seed=strip.seed,
                 n=n, tm=md.tm, slack=md.slack, steps=steps, width=w, top2=t,
                 kernel=np.array([r[3] for r in rows]),
                 latched=np.array([r[5] for r in rows]))
    return first


def segment_dump(common, box, pos0, out, ref=None):
    """K3's and K11's segments from one state, written to ``out`` (npz):
    from the dense melt (K1 only) the culled runner's ``init`` (sort, list,
    K4) and, on its list, 40-step segments in NVT (with the latch), with
    the exact reciprocal, and in NpT (anchor, budget 0.1, final energy),
    and a megakernel segment (pure x, P=16), then K10 (``sort_build``,
    nslab 0) and K11's ``tile_build`` on that segment's output.  It makes
    only calls that
    older trees of the port have too, so that it runs in a parent tree;
    with ``ref``, an npz of another tree, each array is compared bit for
    bit."""
    import numpy as np
    import torch

    from chiron_tpu_torch.ops import lj_mega, sortbuild
    from chiron_tpu_torch.runtime import (
        make_culled_lj_runner,
        make_fast_lj_runner,
    )

    fast = make_fast_lj_runner(**common)
    dense = fast.run(fast.init(pos0, box, seed=SEED), MELT_STEPS)
    arrays = {}
    for sort_mode in ("auto", "x"):
        runner = make_culled_lj_runner(slack=0.15, segment_steps=40,
                                       sort_mode=sort_mode, **common)
        c = runner.init(fast.positions(dense), box, seed=SEED)
        md = runner.md
        if sort_mode == "x":
            w = c.v - 0.5 * md.dt * c.F * md.minv
            out_m = lj_mega.mega_segment(md, c.x, w, c.F, c.box_diag,
                                         runner.capacity, SEED, c.step + 7,
                                         40, 16)
            arrays.update({f"mega_{k}": t for k, t in
                           zip(("x", "w", "F", "flag"), out_m)})
            # K10 and K11's build on the segment's repaired order
            box0, cap = c.box_diag[0], runner.capacity
            *moved, sorted_list = sortbuild.sort_build(
                *out_m[:3], box0, N, md.tm, md.tn, 0, md.cutoff, md.slack,
                cap)
            built = lj_mega.tile_build(out_m[0], N, md.tm, md.tn, box0,
                                       md.cutoff, md.slack, cap)
            arrays.update({f"sort_build_{k}": t
                           for k, t in zip(("x", "w", "F"), moved)})
            for f in sorted_list._fields:
                arrays[f"sort_build_{f}"] = getattr(sorted_list, f)
                arrays[f"tile_build_{f}"] = getattr(built, f)
            continue
        modes = {"nvt": dict(drift_slack=md.slack_t),
                 "exact": dict(approx_recip=False, drift_slack=md.slack_t),
                 "npt": dict(final_energy=True, drift_anchor=c.x * 1.0001,
                             drift_budget=torch.tensor(0.1, device=c.x.device))}
        for mode, kw in modes.items():
            got = md.run_segment(c.x, c.v, c.F, c.box_diag, c.pairs, SEED,
                                 c.step + 7, 40, **kw)
            names = ("x", "v", "F", "flag", "energy")[:len(got)]
            arrays.update({f"{mode}_{k}": t for k, t in zip(names, got)})
    arrays = {k: t.cpu().numpy() for k, t in arrays.items()}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **arrays)
    print(f"segment dump: {len(arrays)} arrays to {out}; flags "
          f"{[bool(v) for k, v in arrays.items() if k.endswith('flag')]}")
    if ref is None:
        return
    other = np.load(ref)
    same = {k: bool(np.array_equal(np.atleast_1d(v).view(np.uint8),
                                   np.atleast_1d(other[k]).view(np.uint8)))
            for k, v in arrays.items()}
    print(f"segment dump against {ref}: "
          f"{'every array bit for bit equal' if all(same.values()) else same}")
    for k, v in arrays.items():
        if not same[k] and v.dtype == np.float32:
            print(f"  {k}: max abs difference "
                  f"{float(np.abs(v - other[k]).max())!r}")


def _strip_start(common, box, pos0):
    """The profile's strip runner and its first state: the dense melt, 400
    culled steps, then ``init`` on those positions."""
    from chiron_tpu_torch.runtime import (
        make_culled_lj_runner,
        make_fast_lj_runner,
        make_lj_runner,
    )

    fast = make_fast_lj_runner(**common)
    dense = fast.run(fast.init(pos0, box, seed=SEED), MELT_STEPS)
    runner = make_culled_lj_runner(slack=0.15, segment_steps=40, **common)
    culled = runner.run(runner.init(fast.positions(dense), box, seed=SEED),
                        400)
    strip = make_lj_runner(engine="strip", box_vectors=box, **common)
    return strip, strip.init(runner.positions(culled), box, seed=SEED)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chiron_tpu_torch import units
    from chiron_tpu_torch.ops import _build
    from chiron_tpu_torch.ops.lj_dense import lj_dense_force_energy
    from chiron_tpu_torch.ops.lj_md_fused import FusedLJMD
    from chiron_tpu_torch.parallel import (
        make_replica_mesh,
        make_sharded_lj_force,
        make_spatial_band_lj_runner,
        make_spatial_lj_runner,
    )
    from chiron_tpu_torch.runtime import (
        _md_constants,
        make_culled_lj_runner,
        make_culled_npt_lj_runner,
        make_fast_lj_runner,
        make_lj_runner,
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
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--segment-dump":
        segment_dump(common, box, pos0, *sys.argv[2:])
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--strip-latch":
        strip, start = _strip_start(common, box, pos0)
        print(f"strip runner: H = {strip.md.H}, slack {strip.md.slack}, "
              f"S = {strip.segment_steps}")
        strip_replay(strip, start, STRIP_SEGMENTS, strip.segment_steps,
                     dump=sys.argv[2])
        print(f"card after: {_card()}")
        return 0
    fast = make_fast_lj_runner(**common)
    state = {"dense": fast.run(fast.init(pos0, box, seed=SEED),
                                MELT_STEPS)}
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
    # K3's segment alone, as the runner calls it: one C call of 40 steps
    # with the latch, 10 times from the culled state on its list
    from chiron_tpu_torch.ops.lj_cull import (
        LatchScratch,
        SegmentWorkspace,
        tile_skin_drift_bad,
    )

    c, md = state["culled"], runner.md
    work = SegmentWorkspace(md, runner.capacity)
    _profile("culled_md segments (S=40, one C call each)",
             lambda: [md.run_segment(c.x, c.v, c.F, c.box_diag, c.pairs, SEED,
                                     c.step, SEGMENT_STEPS,
                                     drift_slack=md.slack_t, workspace=work)
                      for _ in range(SEGMENT_CALLS)],
             SEGMENT_CALLS * SEGMENT_STEPS)

    # the last three kernels' paths from the culled NVT state
    start = runner.positions(state["culled"])
    extra = {}
    for path in ("fused_rebuild", "megakernel"):
        r = make_culled_lj_runner(slack=0.15, segment_steps=40, sort_mode="x",
                                  **{path: True}, **common)
        state[path] = r.init(start, box, seed=SEED)
        runs[path] = r.run
        extra[path] = r
    pot = fluid.potential
    kT, dt, gamma = _md_constants(common["temperature"], common["timestep"],
                                  1.0 / units.picoseconds)
    md9 = FusedLJMD(N, pot.sigma, pot.epsilon, pot.cutoff,
                    fluid.topology.masses(), dt, gamma, kT, device=dev)
    c = state["culled"]
    state["fused"] = (c.x, c.v, lj_dense_force_energy(
        c.x, c.box_diag, N, pot.sigma, pot.epsilon, pot.cutoff,
        approx_recip=True, with_energy=False)[0], 0)

    def fused_run(st, steps):
        x, v, F, k = st
        for _ in range(steps // FUSED_CALL):
            x, v, F = md9.run(x, v, F, c.box_diag, SEED, FUSED_CALL,
                              step_offset=k)
            k += FUSED_CALL
        return x, v, F, k

    runs["fused"] = fused_run
    print(f"new paths: {[(p, extra[p].path) for p in extra]}, FusedLJMD "
          f"n_pad {md9.n_pad}")
    for label in NEW_PATHS + NEW_PATHS[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        advance(label, NEW_WINDOW_STEPS)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        print(f"{label} {NEW_WINDOW_STEPS}-step window: {sec:.6f} s, "
              f"{NEW_WINDOW_STEPS / sec:.1f} steps/s")
    for path, r in extra.items():
        r.check(state[path])
    for label in NEW_PATHS[1:]:
        _profile(label, lambda: advance(label, NEW_PROFILE_STEPS),
                 NEW_PROFILE_STEPS)
    # the list each culled path's force last ran on (the megakernel's lives
    # in its workspace): how many entries, and how they spread over the row
    # tiles
    for path in ("culled", *extra):
        pairs = (extra[path]._segment_ws.pairs if path == "megakernel"
                 else state[path].pairs)
        ptr2 = pairs.ptr2[0].cpu()
        seg = ptr2[2::2] - ptr2[0:-1:2]
        print(f"{path} list: count {int(pairs.count)}, entries per row tile "
              f"max {int(seg.max())}, mean {float(seg.double().mean()):.3f}")

    # the large-N engines: band against culled at N=100,000, and the strip
    big = LennardJonesFluid(nparticles=N_BAND, reduced_density=0.8)
    bbox = big.box_vectors.value_in_unit_system(units.md_unit_system)
    bcommon = dict(common, potential=big.potential, n_particles=N_BAND,
                   topology=big.topology)
    band = make_lj_runner(box_vectors=bbox, **bcommon)
    bs = band.init(big.positions.value_in_unit_system(units.md_unit_system),
                   bbox, seed=SEED)
    bs = band.run(bs, BAND_MELT_STEPS)
    band.check(bs)
    melted = band.positions(bs)
    culled_big = make_culled_lj_runner(slack=0.2, segment_steps=50, **bcommon)
    state["band"] = band.init(melted, bbox, seed=SEED)
    state["culled_100k"] = culled_big.init(melted, bbox, seed=SEED)
    torch.cuda.synchronize()
    print(f"N={N_BAND}: band {type(band).__name__} w={band.band.w} "
          f"(recalibrated on the melted state), culled nslab="
          f"{culled_big.nslab} capacity={culled_big.capacity} count="
          f"{int(state['culled_100k'].pairs.count)}")
    runs.update(band=band.run, culled_100k=culled_big.run)
    for label in ("band", "culled_100k", "culled_100k", "band"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        advance(label, BIG_WINDOW_STEPS)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        print(f"N={N_BAND} {label} {BIG_WINDOW_STEPS}-step window: "
              f"{sec:.6f} s, {BIG_WINDOW_STEPS / sec:.1f} steps/s")
    band.check(state["band"])
    culled_big.check(state["culled_100k"])
    # the drift latch at N=100,000 (several blocks and a ticket)
    cb = state["culled_100k"]
    scratch = LatchScratch(culled_big.md.n_pad, dev)
    _profile(f"latch (N={N_BAND}, {LATCH_CALLS} calls)",
             lambda: [tile_skin_drift_bad(cb.x, cb.x_anchor, N_BAND,
                                          culled_big.md.slack_t, cb.box_diag,
                                          scratch)
                      for _ in range(LATCH_CALLS)], LATCH_CALLS)
    # the re-sort chosen on the device (the runner) against a host branch,
    # from one state: the same steps, so the same re-sorts
    hc = _host_checked(band)
    start = state["band"]
    ends = {}
    for label, r in (("device choice", band), ("host check", hc),
                     ("host check", hc), ("device choice", band)) * 2:
        s = replace(start, generator=torch.Generator(dev).manual_seed(SEED))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = r.run(s, BIG_WINDOW_STEPS)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        ends.setdefault(label, s)
        print(f"N={N_BAND} band re-sort by {label}: {BIG_WINDOW_STEPS}-step "
              f"window {sec:.6f} s, {BIG_WINDOW_STEPS / sec:.1f} steps/s")
    print(f"N={N_BAND} band re-sorts in the window: "
          f"{hc.resorts // 4} of {BIG_WINDOW_STEPS} steps")
    a, b = ends.values()
    if not all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("x", "v", "F", "ref_x", "overflowed")):
        raise RuntimeError("the two re-sort choices reached different states")
    # the spatial runners on a mesh of this process alone, from the same
    # melted state
    mesh = make_replica_mesh(axis_name="spatial", device=dev)
    skw = {k: v for k, v in bcommon.items() if k != "device"}
    sband = make_spatial_band_lj_runner(mesh, segment_steps=25, **skw)
    sdense = make_spatial_lj_runner(mesh, **skw)
    state["spatial_band"] = sband.init(melted, bbox, seed=SEED)
    state["spatial_dense"] = sdense.init(melted, bbox, seed=SEED)
    runs.update(spatial_band=sband.run, spatial_dense=sdense.run)
    print(f"N={N_BAND} spatial band w={sband.w}, n_pad={sband.n_pad}")
    for label in ("spatial_band", "spatial_dense", "spatial_dense",
                  "spatial_band"):
        steps = SPATIAL_WINDOW_STEPS[label]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        advance(label, steps)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        print(f"N={N_BAND} {label} {steps}-step window: {sec:.6f} s, "
              f"{steps / sec:.2f} steps/s")
    sband.check(state["spatial_band"])
    strip = make_lj_runner(engine="strip", box_vectors=box, **common)
    state["strip"] = strip_start = strip.init(melt, box, seed=SEED)
    runs["strip"] = strip.run
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        advance("strip", STRIP_WINDOW_STEPS)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        print(f"strip {STRIP_WINDOW_STEPS}-step window: {sec:.6f} s, "
              f"{STRIP_WINDOW_STEPS / sec:.1f} steps/s")
    for label, steps in BIG_PROFILE_STEPS.items():
        _profile(label, lambda: advance(label, steps), steps)
    # a latch ends a production run, not this profile: its 400 steps ran
    # the same kernels, so the rows above stand, and the replay says which
    # check fired
    try:
        strip.check(state["strip"])
    except RuntimeError as err:
        print(f"strip runner latched in its windows or profiled steps: {err}")
        strip_replay(strip, strip_start, STRIP_SEGMENTS, strip.segment_steps)
    xe7, box7 = state["strip"].x, state["strip"].box_diag
    _profile("strip force_energy (K7)",
             lambda: [strip.md.force_energy(xe7, box7)
                      for _ in range(STRIP_ENERGY_CALLS)], STRIP_ENERGY_CALLS)
    # the one-shot calls of the spatial path: the sharded force with the
    # energy (K8a's energy instantiation) and the runners' energy (K2)
    pot = big.potential
    sf = make_sharded_lj_force(mesh, N_BAND, pot.sigma, pot.epsilon,
                               pot.cutoff, axis_name="spatial")
    p3 = sf.op.pad_positions(melted)
    bd = state["spatial_band"].box_diag
    calls = ONE_SHOT_CALLS
    _profile("sharded force_energy",
             lambda: [sf.force_energy(p3, bd) for _ in range(calls)], calls)
    _profile("spatial energy (K2)",
             lambda: [sband.energy(state["spatial_band"])
                      for _ in range(calls)], calls)
    print(f"card after: {_card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
