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

    python3 chip_profile.py --general

profiles the general API alone (``general``): the README's quick start
(``LennardJonesFluid(1000, 0.1)``, 300 K, ``NeighborListNsqrd`` with skin
0.5 nm, ``LangevinIntegrator`` at 2 fs) after 2000 steps, and
``LangevinIntegrator`` on ``DensePairs`` (K1) at N=4000 and 120 K after a
1000-step melt from the lattice, then ``make_langevin_runner`` on the same
scheme: three 1000-step windows of each, then profiler rows of 200 steps.

    python3 chip_profile.py --mc

profiles the paths of ``chip_smoke.py`` [12] (``mc``): the LJ_MCMC state
point (1100 methanes on ``DensePairs``, 140 K, 13.00765 atm) after one
iteration of its schedule -- windows of 500 displacement proposals, 200
volume proposals and 1000 ``LangevinDynamicsMove`` steps, with profiler
rows of a fifth of each, with the host's top operators by self CPU time
--, the lj_mcmove chain on ``NeighborListNsqrd`` (1000-proposal windows,
200 profiled), and ``ReplicaExchangeSampler.run(5)`` as [12](c) calls it,
each window and the profiled call on a new sampler (4 replicas, 5
iterations of 5 x 50 steps each, the energy matrices, the swaps and the
offline MBAR).

    python3 chip_profile.py --pt

profiles the dense tempering path of ``chip_smoke.py`` [13] (``pt``):
``benchmarks/replica_scaling.py``'s ladder (``LennardJonesFluid(1000,
0.8)``, ``linspace(120, 200, R)`` K, seed 7, the dense chain on K1 over
replicas) at R=8 and R=64: after a warm-up ``propagate`` of the window's
length, three 500-step windows of ``propagate`` itself, then profiler rows
of one ``propagate(500)`` (its U gather and read included).

    python3 chip_profile.py --cadence

profiles the culled runner's list cadence, ``chip_smoke.py`` [14]
(``cadence``): from the state the dense runner melts in 1000 steps, for
(``sort_every``, ``rebuild_every``) = (1, 1), (4, 1), (1, 2), (2, 2) at
S=40, slack 0.15 and at S=50, slack 0.3: 5 rounds of 3000-step windows,
the pairs in turn (the order reversed every other round), with each pair's
median; the host's enqueue time a segment, split into the sort, the list
build and K3's call, over 75 segments; then profiler rows of 400 steps of
each pair with the host's top operators.

    python3 chip_profile.py --ho-seeds 1234,1235,...

runs ``examples_torch/ho_multistate_mbar.py`` at ``chip_smoke.py`` [15]'s
cut (``run(14)`` of the example's ``run(25)``) once a seed, one process a
seed, all started together (so their wall seconds are not the example's
rate), with an in-memory reporter: each seed's f_k error against the
analytic values, the asymptotic d f_k of the last rung, the unsampled
sigma's reweighted f, and whether the example's ``check`` holds.

    python3 chip_profile.py --wide

profiles the kernels at the reference's wider tiles (``wide``) beside their
own tiles, on ``chip_smoke.py``'s states: the culled force pass (20 calls)
and K3's segment (one call, S=40) at 128 x 256, 256 x 256, 512 x 512, 128 x
1024 and 384 x 768, K11's segment (S=40, P=16) at 128 x 256 and 512 x 512,
all from the 1000-step dense melt at N=4000; K7 (20 calls) at tm 128 with
the strip runner's halo and at tm 256 and 512 with the covering halo
rounded up to tm, on that state sorted; and K6 (5 calls) at tm 256 and 512
on N=100,000 after 1000 band steps from the lattice: the device time a
launch of each kernel (``chip_smoke.py`` holds each to its plain version).

Without a CUDA device it exits nonzero before measuring anything.
"""

import copy
import os
import subprocess
import sys
import time
from dataclasses import replace

from chip_smoke import EXAMPLE_CUTS, _busy_us, _MemoryReporter

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


def _profile(label, fn, steps, host_rows=0):
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
    if host_rows:
        # the host's side: the operators by their own CPU time a step
        ops = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CPU]
        ops.sort(key=lambda a: -a.self_cpu_time_total)
        print(f"   host: the top {host_rows} operators by self CPU time "
              f"(profiler on)")
        for a in ops[:host_rows]:
            print(f"   {a.self_cpu_time_total / steps:9.2f} us/step "
                  f"{a.count:6d}x  {a.key[:80]}")


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
    nslab 0) and K11's ``tile_build`` on that segment's output; and the
    culled pass (K4, K5 and a 40-step segment), K6 and K7 at the tiles
    every tree since PR 8 takes (culled 16 x 64, 64 x 192, 256 x 256; K6 at
    tm 64, 128, 256, w 1100 and 1500; K7 at tm 16-128, halos of 1024 and
    1152 rounded up to tm).  It makes only calls that older trees of the
    port have too, so that it runs in a parent tree; with ``ref``, an npz
    of another tree, each array is compared bit for bit."""
    import numpy as np
    import torch

    from chiron_tpu_torch.ops import lj_band as lb
    from chiron_tpu_torch.ops import lj_cull as lc
    from chiron_tpu_torch.ops import lj_mega, sortbuild
    from chiron_tpu_torch.ops import lj_strip as ls
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
        modes = {"nvt": dict(drift_anchor=c.x, drift_budget=md.slack_t),
                 "exact": dict(approx_recip=False, drift_anchor=c.x,
                               drift_budget=md.slack_t),
                 "npt": dict(final_energy=True, drift_anchor=c.x * 1.0001,
                             drift_budget=torch.tensor(0.1, device=c.x.device))}
        for mode, kw in modes.items():
            got = md.run_segment(c.x, c.v, c.F, c.box_diag, c.pairs, SEED,
                                 c.step + 7, 40, **kw)
            names = ("x", "v", "F", "flag", "energy")[:len(got)]
            arrays.update({f"{mode}_{k}": t for k, t in zip(names, got)})
    melt = fast.positions(dense)
    pot = common["potential"]
    lj = (pot.sigma, pot.epsilon, pot.cutoff)
    for tm, tn in ((16, 64), (64, 192), (256, 256)):
        r = make_culled_lj_runner(slack=0.15, segment_steps=40, tm=tm,
                                  tn=tn, **common)
        c = r.init(melt, box, seed=SEED)
        a = (c.x, c.box_diag, c.pairs, N, tm, tn, *lj)
        arrays[f"cull{tm}x{tn}_F"] = lc.culled_force_pass(*a)[0]
        F5, E5 = lc.culled_force_energy(*a)
        arrays[f"cull{tm}x{tn}_F5"], arrays[f"cull{tm}x{tn}_E5"] = F5, E5
        got = r.md.run_segment(c.x, c.v, c.F, c.box_diag, c.pairs, SEED,
                               c.step + 7, 40, drift_anchor=c.x,
                               drift_budget=r.md.slack_t)
        arrays.update({f"cull{tm}x{tn}_seg_{k}": t
                       for k, t in zip(("x", "v", "F", "flag"), got)})
    n_pad = -(-N // 256) * 256
    dev = melt.device
    x3 = torch.zeros((3, n_pad), device=dev)
    x3[:, :N] = melt.T
    bd = c.box_diag
    xs = lb.sort_by_x(x3, (), N)[0].contiguous()
    for tm in (64, 128, 256):
        for w in (1100, 1500):
            a = (xs, bd.reshape(3), N, w, *lj, tm)
            arrays[f"band{tm}_{w}_F"] = lb.band_force(*a)
            F6, E6 = lb.band_force_energy(*a)
            arrays[f"band{tm}_{w}_F6"], arrays[f"band{tm}_{w}_E6"] = F6, E6
    x3 = torch.full((3, n_pad), ls._PAD_X, device=dev)
    x3[:, :N] = melt.T
    x3 = ls.sort_by_key_strip(x3, ())[0]
    for tm in (16, 32, 64, 128):
        for H in (1024, 1152):
            H = -(-H // tm) * tm
            halo = x3[:, :H].clone()
            halo[0] = halo[0] + bd[0, 0]
            a = (torch.cat([x3, halo], dim=1), bd, N, tm, H, *lj)
            arrays[f"strip{tm}_{H}_F"] = ls.strip_force(*a)
            F7, E7 = ls.strip_force_energy(*a)
            arrays[f"strip{tm}_{H}_F7"], arrays[f"strip{tm}_{H}_E7"] = F7, E7
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


GENERAL_WINDOW_STEPS = 1000
GENERAL_PROFILE_STEPS = 200
# --mc: a window's proposals or steps (the profiler records a fifth)
MC_WINDOW_STEPS = {"MC displacement chain": 500, "MC barostat chain": 200,
                   "LangevinDynamicsMove (1 fs)": 1000}
MC_HOST_ROWS = 12


def general(dev):
    """Windows and profiler rows of the general API's two paths."""
    import torch

    from chiron_tpu_torch import units
    from chiron_tpu_torch.integrators import LangevinIntegrator
    from chiron_tpu_torch.neighbors import (
        DensePairs,
        NeighborListNsqrd,
        OrthogonalPeriodicSpace,
    )
    from chiron_tpu_torch.runtime import make_langevin_runner
    from chiron_tpu_torch.states import SamplerState, ThermodynamicState
    from chiron_tpu_torch.testsystems import LennardJonesFluid
    from chiron_tpu_torch.utils import PRNG

    def setup(n, density, kelvin, pairs_of):
        fluid = LennardJonesFluid(nparticles=n, reduced_density=density)
        PRNG.set_seed(SEED)
        st = SamplerState(positions=fluid.positions,
                          current_PRNG_key=PRNG.get_random_key(),
                          box_vectors=fluid.box_vectors, device=dev)
        thermo = ThermodynamicState(potential=fluid.potential,
                                    temperature=kelvin * units.kelvin)
        return fluid, st, thermo, pairs_of(fluid)

    space = OrthogonalPeriodicSpace()
    paths = {
        "general quick start (N=1000, NeighborListNsqrd)": setup(
            1000, 0.1, 300.0, lambda f: NeighborListNsqrd(
                space, cutoff=f.cutoff, skin=0.5 * units.nanometer,
                n_max_neighbors=180)),
        "general DensePairs (N=4000, K1)": setup(
            N, 0.8, 120.0, lambda f: DensePairs(space, cutoff=f.cutoff)),
    }
    for label, (fluid, st, thermo, pairs) in paths.items():
        integ = LangevinIntegrator(timestep=2.0 * units.femtoseconds)
        held = {"pairs": pairs, "state": st}

        def advance(steps, held=held, integ=integ, thermo=thermo):
            held["state"], held["pairs"] = integ.run(
                held["state"], thermo, number_of_steps=steps,
                nbr_list=held["pairs"])

        advance(2000 if "quick" in label else MELT_STEPS)
        _windows(label, advance)
        _profile(label, lambda: advance(GENERAL_PROFILE_STEPS),
                 GENERAL_PROFILE_STEPS)
        if "DensePairs" in label:
            st = held["state"]
            runner = make_langevin_runner(
                fluid.potential, pairs=held["pairs"],
                temperature=120.0 * units.kelvin, device=dev)
            carry = {"c": runner.init(st.positions, st.box_vectors, seed=SEED,
                                      velocities=st.velocities)}

            def run(steps):
                carry["c"] = runner.run(carry["c"], steps)

            _windows("make_langevin_runner on DensePairs (N=4000)", run)
            _profile("make_langevin_runner on DensePairs (N=4000)",
                     lambda: run(GENERAL_PROFILE_STEPS), GENERAL_PROFILE_STEPS)


def _windows(label, advance, steps=None):
    import torch

    steps = GENERAL_WINDOW_STEPS if steps is None else steps
    seconds = []
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        advance(steps)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    print(f"{label} {steps}-step windows: seconds "
          f"{[round(x, 6) for x in seconds]}, steps/s "
          f"{[round(steps / x, 1) for x in seconds]}")


def mc(dev):
    """Windows and profiler rows of ``chip_smoke.py`` [12]'s paths: the
    LJ_MCMC state point's displacement chain, barostat chain and
    ``LangevinDynamicsMove`` (N=1100 methane on ``DensePairs``, K1), the
    lj_mcmove chain on ``NeighborListNsqrd``, and [12](b)'s whole
    ``ReplicaExchangeSampler.run(5)`` (4 replicas, 5 iterations of 5 x 50
    Langevin steps each, the energy matrices, the swaps and the offline
    MBAR)."""
    from chip_smoke import (
        METHANE_N,
        REX_ITERATIONS,
        REX_STEPS,
        REX_TEMPS,
        _MemoryReporter,
        _methane,
    )
    from chiron_tpu_torch import units
    from chiron_tpu_torch.mcmc import (
        LangevinDynamicsMove,
        MCMCSampler,
        MonteCarloBarostatMove,
        MonteCarloDisplacementMove,
        MoveSchedule,
    )
    from chiron_tpu_torch.multistate import ReplicaExchangeSampler
    from chiron_tpu_torch.neighbors import (
        DensePairs,
        NeighborListNsqrd,
        OrthogonalPeriodicSpace,
    )
    from chiron_tpu_torch.states import SamplerState, ThermodynamicState
    from chiron_tpu_torch.testsystems import LennardJonesFluid
    from chiron_tpu_torch.utils import PRNG

    space = OrthogonalPeriodicSpace()
    lj, methane = _methane(dev)
    PRNG.set_seed(SEED)
    npt = ThermodynamicState(potential=lj, temperature=140.0 * units.kelvin,
                             pressure=13.00765 * units.atmosphere)
    held = {"state": methane(PRNG.get_random_key()),
            "pairs": DensePairs(space, cutoff=1.4 * units.nanometer)}
    held["pairs"].build_from_state(held["state"])
    moves = {
        "MC displacement chain": MonteCarloDisplacementMove(
            displacement_sigma=0.01 * units.nanometer, number_of_moves=100,
            autotune=True, autotune_interval=100),
        "MC barostat chain": MonteCarloBarostatMove(
            volume_max_scale=0.1, number_of_moves=20, autotune=True,
            autotune_interval=50),
        "LangevinDynamicsMove (1 fs)": LangevinDynamicsMove(
            timestep=1.0 * units.femtoseconds, number_of_steps=200),
    }
    # the schedule once, as chip_smoke.py [12](a) runs it, to warm up
    held["state"], _, held["pairs"] = MCMCSampler(MoveSchedule(
        list(moves.items()))).run(held["state"], npt, 1, held["pairs"])

    for name, move in moves.items():
        label = f"{name} (N={METHANE_N} methane, DensePairs, K1)"

        def advance(steps, move=move):
            move.number_of_moves = steps
            held["state"], _, held["pairs"] = move.update(
                held["state"], npt, held["pairs"])

        steps = MC_WINDOW_STEPS[name]
        _windows(label, advance, steps)
        _profile(label, lambda: advance(steps // 5), steps // 5,
                 host_rows=MC_HOST_ROWS)

    fluid = LennardJonesFluid(nparticles=METHANE_N, reduced_density=0.1)
    sb = {"state": SamplerState(positions=fluid.positions,
                                current_PRNG_key=PRNG.get_random_key(),
                                box_vectors=fluid.box_vectors, device=dev),
          "pairs": NeighborListNsqrd(space, cutoff=fluid.cutoff,
                                     skin=0.5 * units.nanometer,
                                     n_max_neighbors=180)}
    sb["pairs"].build_from_state(sb["state"])
    nvt300 = ThermodynamicState(potential=fluid.potential,
                                temperature=300.0 * units.kelvin)
    mcmove = MonteCarloDisplacementMove(
        displacement_sigma=0.01 * units.nanometer, number_of_moves=1000,
        autotune=True, autotune_interval=100)

    def advance_b(steps):
        mcmove.number_of_moves = steps
        sb["state"], _, sb["pairs"] = mcmove.update(sb["state"], nvt300,
                                                    sb["pairs"])

    advance_b(1000)
    label = f"lj_mcmove chain (N={METHANE_N}, NeighborListNsqrd)"
    _windows(label, advance_b, 1000)
    _profile(label, lambda: advance_b(200), 200)

    ladder = [ThermodynamicState(potential=lj, temperature=T * units.kelvin)
              for T in REX_TEMPS]
    st = held["state"]
    x_np, box_np = st.positions.cpu().numpy(), st.box_vectors.cpu().numpy()

    def sampler():
        rex = ReplicaExchangeSampler(
            mcmc_sampler=MCMCSampler(MoveSchedule([(
                "LangevinDynamicsMove", LangevinDynamicsMove(
                    timestep=1.0 * units.femtoseconds,
                    number_of_steps=REX_STEPS))])),
            reporter=_MemoryReporter())
        rex.create(ladder, [methane(PRNG.get_random_key(), x_np, box_np)
                            for _ in ladder],
                   [DensePairs(space, cutoff=1.4 * units.nanometer)
                    for _ in ladder])
        return rex

    # ``run`` itself, on samplers made ahead (one a window and two for the
    # profiler), each run once from its start as chip_smoke.py [12](c) runs
    samplers = [sampler() for _ in range(WINDOWS + 3)]
    samplers.pop().run(REX_ITERATIONS)  # warm-up

    def run(n):
        samplers.pop().run(n)

    label = (f"replica exchange run({REX_ITERATIONS}) ({len(ladder)} "
             f"replicas x {REX_ITERATIONS} iterations x {REX_ITERATIONS} x "
             f"{REX_STEPS} Langevin steps, DensePairs; 'steps' are "
             "iterations)")
    _windows(label, run, REX_ITERATIONS)
    _profile(label, lambda: run(REX_ITERATIONS), REX_ITERATIONS)


# --pt: the ladders and the length of a window (and of the profiled call)
PT_PROFILE_RS = (8, 64)
PT_WINDOW_STEPS = 500


def pt(dev):
    """Windows and profiler rows of ``ParallelTemperingSampler.propagate``
    on ``chip_smoke.py`` [13](b)'s dense ladder at R=8 and R=64."""
    import numpy as np

    from chip_smoke import PT_N, PT_SEED
    from chiron_tpu_torch import units
    from chiron_tpu_torch.parallel import (ParallelTemperingSampler,
                                           make_replica_mesh)
    from chiron_tpu_torch.testsystems import LennardJonesFluid

    md = units.md_unit_system
    fluid = LennardJonesFluid(nparticles=PT_N, reduced_density=0.8)
    mesh = make_replica_mesh(1, device=dev)
    for R in PT_PROFILE_RS:
        sampler = ParallelTemperingSampler(
            fluid.potential, list(np.linspace(120.0, 200.0, R)), mesh=mesh)
        sampler.initialize(fluid.positions.value_in_unit_system(md),
                           fluid.box_vectors.value_in_unit_system(md),
                           seed=PT_SEED)
        sampler.propagate(PT_WINDOW_STEPS)  # warm-up
        label = (f"dense tempering propagate (N={PT_N}, R={R}, K1 over "
                 f"replicas)")
        _windows(label, sampler.propagate, PT_WINDOW_STEPS)
        _profile(label, lambda: sampler.propagate(PT_WINDOW_STEPS),
                 PT_WINDOW_STEPS, host_rows=8)


# --cadence: rounds of windows, segments timed on the host, profiled steps
CADENCE_ROUNDS = 5
CADENCE_HOST_SEGMENTS = 75


def cadence(common, box, pos0):
    """Windows, host split and profiler rows of the culled runner at each
    list cadence of ``chip_smoke.py`` [14]."""
    import statistics

    import torch

    from chip_smoke import CADENCE_CONFIGS, CADENCE_PAIRS
    from chiron_tpu_torch.runtime import make_culled_lj_runner, make_fast_lj_runner

    fast = make_fast_lj_runner(**common)
    fs = fast.run(fast.init(pos0, box, seed=SEED), MELT_STEPS)
    melt = fast.positions(fs)
    steps = WINDOW_STEPS["culled"]
    for seg, slack in CADENCE_CONFIGS:
        runners, carries = {}, {}
        for pair in CADENCE_PAIRS:
            r = make_culled_lj_runner(
                slack=slack, segment_steps=seg, sort_every=pair[0],
                rebuild_every=pair[1], **common)
            runners[pair] = r
            carries[pair] = r.run(r.init(melt, box, seed=SEED), seg)
        rates = {pair: [] for pair in CADENCE_PAIRS}
        for k in range(CADENCE_ROUNDS):
            order = CADENCE_PAIRS if k % 2 == 0 else CADENCE_PAIRS[::-1]
            for pair in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                carries[pair] = runners[pair].run(carries[pair], steps)
                torch.cuda.synchronize()
                rates[pair].append(steps / (time.perf_counter() - t0))
        for pair in CADENCE_PAIRS:
            r, c = runners[pair], carries[pair]
            latched = bool(c.overflowed)
            print(f"cadence {pair} S={seg} slack {slack}: {steps}-step "
                  f"windows steps/s {[round(x, 1) for x in rates[pair]]}, "
                  f"median {statistics.median(rates[pair]):.1f}; list count "
                  f"{int(c.pairs.count)} of {r.capacity}; latched {latched}")
        for pair in CADENCE_PAIRS:
            r = runners[pair]
            md = r.md
            host = {"sort": 0.0, "build": 0.0, "K3": 0.0}

            def timed(fn, key):
                def wrapper(*args, **kw):
                    t0 = time.perf_counter()
                    out = fn(*args, **kw)
                    host[key] += time.perf_counter() - t0
                    return out
                return wrapper

            r._sort = timed(r._sort, "sort")
            md.build_pairs = timed(md.build_pairs, "build")
            md.run_segment = timed(md.run_segment, "K3")
            c = carries[pair]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CADENCE_HOST_SEGMENTS):
                c = r.segment_fn(seg)(c)
            enqueue = time.perf_counter() - t0
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            del r._sort, md.build_pairs, md.run_segment
            per = {k: v / CADENCE_HOST_SEGMENTS * 1e6 for k, v in host.items()}
            print(f"cadence {pair} S={seg}: host enqueue a segment "
                  f"{enqueue / CADENCE_HOST_SEGMENTS * 1e6:.1f} us (sort "
                  f"{per['sort']:.1f}, build {per['build']:.1f}, K3's call "
                  f"{per['K3']:.1f}, averaged over "
                  f"{CADENCE_HOST_SEGMENTS} segments), wall to the sync "
                  f"{wall / CADENCE_HOST_SEGMENTS * 1e6:.1f} us a segment")
            carries[pair] = c
        for pair in CADENCE_PAIRS:
            r, c = runners[pair], carries[pair]
            _profile(f"cadence {pair} S={seg} slack {slack}",
                     lambda: r.run(c, PROFILE_STEPS["culled"]),
                     PROFILE_STEPS["culled"], host_rows=10)


def ho_seed(seed):
    """One seed of the harmonic ladder at [15]'s cut: one line of numbers."""
    from examples_torch import ho_multistate_mbar as ho

    n_iterations = EXAMPLE_CUTS["ho_multistate_mbar"]["n_iterations"]
    t0 = time.perf_counter()
    r = ho.main(device="cuda", n_iterations=n_iterations, seed=seed,
                reporter=_MemoryReporter())
    wall = time.perf_counter() - t0
    try:
        ho.check(r)
        held = "holds"
    except AssertionError as err:
        held = f"fails ({err})"
    print(f"seed {seed}: run({n_iterations}) f_k error {r['max_error']:.4f} "
          f"kT (limit 0.1), d f_k[-1] {r['d_f_k'][-1]:.4f} kT, unsampled f "
          f"{r['f_unsampled']:.4f} +- {r['d_f_unsampled']:.4f} (analytic "
          f"{r['f_unsampled_true']:.4f}); check {held}; {wall:.1f} s wall",
          flush=True)


def ho_seeds(seeds):
    """``ho_seed`` for each of ``seeds``, one process a seed, all at once."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--ho-seed", str(seed)],
                              stdout=subprocess.PIPE, text=True)
             for seed in seeds]
    failed = 0
    for seed, proc in zip(seeds, procs):
        out, _ = proc.communicate()
        print(out.strip() or f"seed {seed}: no output", flush=True)
        failed += proc.returncode != 0
    return 1 if failed else 0


WIDE_CULL = ((128, 256), (256, 256), (512, 512), (128, 1024), (384, 768))
WIDE_MEGA = ((128, 256), (512, 512))
WIDE_CALLS = 20
WIDE_BAND_CALLS = 5
WIDE_BAND_MELT = 1000


def wide(common, box, pos0):
    """``--wide``: device time a launch of the culled pass, K3's and K11's
    segments, K7 and K6 at the reference's wider tiles beside their own."""
    import torch

    from chiron_tpu_torch import units
    from chiron_tpu_torch.ops import lj_band as lb
    from chiron_tpu_torch.ops import lj_cull as lc
    from chiron_tpu_torch.ops import lj_mega as lm
    from chiron_tpu_torch.ops import lj_strip as ls
    from chiron_tpu_torch.runtime import (
        make_band_lj_runner,
        make_culled_lj_runner,
        make_fast_lj_runner,
        make_strip_lj_runner,
    )
    from chiron_tpu_torch.testsystems import LennardJonesFluid

    fast = make_fast_lj_runner(**common)
    melt = fast.positions(fast.run(fast.init(pos0, box, seed=SEED),
                                   MELT_STEPS))
    pot = common["potential"]
    lj = (pot.sigma, pot.epsilon, pot.cutoff)

    def times(fn, k):
        return lambda: [fn() for _ in range(k)]

    for tm, tn in WIDE_CULL:
        r = make_culled_lj_runner(slack=0.15, segment_steps=SEGMENT_STEPS,
                                  tm=tm, tn=tn, **common)
        c = r.init(melt, box, seed=SEED)
        md = r.md
        a = (c.x, c.box_diag, c.pairs, N, tm, tn, *lj)
        _profile(f"culled force pass at {tm} x {tn} (count "
                 f"{int(c.pairs.count)}, n_pad {md.n_pad}; a step is a call)",
                 times(lambda: lc.culled_force_pass(*a), WIDE_CALLS),
                 WIDE_CALLS)
        ws = lc.SegmentWorkspace(md, r.capacity)
        _profile(f"K3's segment at {tm} x {tn} (S={SEGMENT_STEPS})",
                 lambda: md.run_segment(
                     c.x, c.v, c.F, c.box_diag, c.pairs, SEED, c.step,
                     SEGMENT_STEPS, drift_anchor=c.x,
                     drift_budget=md.slack_t, workspace=ws), SEGMENT_STEPS)
    for tm, tn in WIDE_MEGA:
        r = make_culled_lj_runner(slack=0.15, segment_steps=SEGMENT_STEPS,
                                  tm=tm, tn=tn, sort_mode="x",
                                  megakernel=True, **common)
        c = r.init(melt, box, seed=SEED)
        md = r.md
        w = c.v - 0.5 * md.dt * c.F * md.minv
        ws = lm.MegaWorkspace(md, r.capacity)
        _profile(f"K11's segment at {tm} x {tn} (S={SEGMENT_STEPS}, P=16)",
                 lambda: lm.mega_segment(md, c.x, w, c.F, c.box_diag,
                                         r.capacity, SEED, c.step,
                                         SEGMENT_STEPS, 16, workspace=ws),
                 SEGMENT_STEPS)
    strip = make_strip_lj_runner(tm=128, **common)
    s0 = strip.init(melt, box, seed=SEED)
    xs = s0.x[:, :strip.md.n_pad]
    need = int(lb.band_width_needed(torch.where(strip.valid, xs[0], 3.0e38),
                                    N, pot.cutoff, s0.box_diag[0, 0]))
    need += strip.md.n_pad - N
    for tm in (128, 256, 512):
        H = strip.md.H if tm == 128 else -(-need // tm) * tm
        halo = xs[:, :H].clone()
        halo[0] = halo[0] + s0.box_diag[0, 0]
        xe = torch.cat([xs, halo], dim=1)
        _profile(f"K7 at tm {tm}, H {H} (a step is a call)",
                 times(lambda: ls.strip_force(xe, s0.box_diag, N, tm, H, *lj),
                       WIDE_CALLS), WIDE_CALLS)
    big = LennardJonesFluid(nparticles=N_BAND, reduced_density=0.8)
    md_units = units.md_unit_system
    bcommon = dict(common, potential=big.potential, n_particles=N_BAND,
                   topology=big.topology)
    bbox = big.box_vectors.value_in_unit_system(md_units)
    br = make_band_lj_runner(**bcommon)
    bs = br.run(br.init(big.positions.value_in_unit_system(md_units), bbox,
                        seed=SEED), WIDE_BAND_MELT)
    for tm in (256, 512):
        rb = br if tm == br.band.tm else make_band_lj_runner(tm=tm, **bcommon)
        st = rb.init(br.positions(bs), bbox, seed=SEED)
        band = rb.band
        _profile(f"K6 at tm {tm} (n_pad {rb.n_pad}, w {band.w}; a step is a "
                 f"call)", times(lambda: band.force(st.x, st.box_diag),
                                 WIDE_BAND_CALLS), WIDE_BAND_CALLS)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if len(sys.argv) == 3 and sys.argv[1] == "--ho-seed":
        ho_seed(int(sys.argv[2]))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--ho-seeds":
        print(f"card before: {_card()}")
        rc = ho_seeds([int(s) for s in sys.argv[2].split(",")])
        print(f"card after: {_card()}")
        return rc
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
    if len(sys.argv) == 2 and sys.argv[1] == "--general":
        general(dev)
        print(f"card after: {_card()}")
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--mc":
        mc(dev)
        print(f"card after: {_card()}")
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--pt":
        pt(dev)
        print(f"card after: {_card()}")
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--wide":
        wide(common, box, pos0)
        print(f"card after: {_card()}")
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--cadence":
        cadence(common, box, pos0)
        print(f"card after: {_card()}")
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
                                     drift_anchor=c.x,
                                     drift_budget=md.slack_t, workspace=work)
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
