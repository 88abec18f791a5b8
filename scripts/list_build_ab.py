#!/usr/bin/env python3
"""Trees against each other on the culled runner's list-build paths, on one
NVIDIA GPU, in one process: the ``fused_rebuild`` runner (K10,
``sort_build``) and the ``megakernel`` runner (K11, its ``tile_build``).

    python3 scripts/list_build_ab.py NAME=TREE [NAME=TREE ...] [--rounds R]

Each TREE is the root of a checkout of the port whose package is this
checkout's, file for file, apart from ``csrc/``.  The script builds each
tree's kernels into a library of its own (``ops/_build.library`` on that
tree's ``csrc``, under this checkout's ``_build/``) and runs this checkout's
runners on each library in turn, so the trees share one process, one state
and one host.  The first tree is the base the others are held to.

From the N=4000 state of ``chip_profile.py`` (``LennardJonesFluid(4000,
0.8)``, 120 K, 2 fs, 1000 dense steps from the lattice, then each runner's
``init``: S=40, slack 0.15, pure x sort) it prints

1. the card's name and power limit;
2. R rounds (20 by default) of one 3000-step window of each path for each
   tree, every window from the path's same start state, the trees in the
   round's order (the list rotated by the round, reversed in odd rounds):
   steps/s on the host's clock around a device sync; for each tree and
   path its median and quartiles, and against the base the rounds it wins
   and whether every window of it beats every window of the base;
3. ``torch.profiler`` rows of 400 steps of each path for each tree, in the
   order base, others, others reversed, base: device busy and wall a step,
   the idle share and the list-build kernel's device time a launch; then
   of 20 calls of ``tile_build`` at n_pad 8192 (a jittered lattice of 8000,
   tiles 128 x 256) for each tree.

Each window's end positions must equal, bit for bit, those of every other
window of its path, whatever the tree: the script exits 1 where they do
not.  Without a CUDA device it exits nonzero before measuring anything.
"""

import filecmp
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4000
SEED = 1234
MELT_STEPS = 1000
WINDOW_STEPS = 3000
PROFILE_STEPS = 400
BIG_N = 8000
BIG_CALLS = 20
PATHS = ("fused_rebuild", "megakernel")
KERNEL = {"fused_rebuild": "sort_build", "megakernel": "tile_build_kernel"}


def _package_differs(tree):
    """The files of tree's package, outside csrc/ and builds, that differ
    from this checkout's."""
    ours = os.path.join(ROOT, "chiron_tpu_torch")
    theirs = os.path.join(os.path.abspath(tree), "chiron_tpu_torch")
    skip = {"csrc", "_build", "__pycache__"}
    out = []
    for base, dirs, files in os.walk(ours):
        dirs[:] = [d for d in dirs if d not in skip]
        rel = os.path.relpath(base, ours)
        for f in files:
            other = os.path.join(theirs, rel, f)
            if not (os.path.exists(other) and filecmp.cmp(
                    os.path.join(base, f), other, shallow=False)):
                out.append(os.path.join(rel, f))
    return out


def _stats(xs):
    import numpy as np

    q1, med, q3 = np.percentile(xs, [25, 50, 75])
    return q1, med, q3


def _device_rows(fn, kernel):
    """One profiled call of fn after a warm-up call: (device busy us, wall
    us, launches of kernel, its device us a launch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    sys.path.insert(0, ROOT)
    from chip_profile import _busy_us

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.01)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith("ProfilerStep")]
    if not dev:
        raise RuntimeError("the profiler recorded no device time")
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in dev)
    mine = [e.time_range.elapsed_us() for e in dev if kernel in e.name]
    return busy, wall, len(mine), sum(mine) / max(len(mine), 1)


def main():
    import numpy as np
    import torch

    args = sys.argv[1:]
    rounds = 20
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    trees = [a.split("=", 1) for a in args]
    if len(trees) < 2 or any(len(t) != 2 for t in trees):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("list_build_ab: no CUDA device visible", file=sys.stderr)
        return 2
    for name, tree in trees:
        differs = _package_differs(tree)
        if differs:
            print(f"{name}: the package differs from this checkout's outside "
                  f"csrc/: {differs}", file=sys.stderr)
            return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sys.path.insert(0, ROOT)
    from pathlib import Path

    from chiron_tpu_torch import units
    from chiron_tpu_torch.ops import _build
    from chiron_tpu_torch.ops import lj_mega as lm
    from chiron_tpu_torch.runtime import (
        make_culled_lj_runner,
        make_fast_lj_runner,
    )
    from chiron_tpu_torch.testsystems import LennardJonesFluid

    build = _build.library
    libs = {}
    for name, tree in trees:
        _build.CSRC = Path(tree).resolve() / "chiron_tpu_torch" / "csrc"
        build.cache_clear()
        t0 = time.perf_counter()
        libs[name] = build()
        print(f"{name}: {_build.CSRC} built in "
              f"{time.perf_counter() - t0:.1f} s ({_build.build_dir().name})")

    def use(name):
        _build.library = lambda: libs[name]

    names = [name for name, _ in trees]
    use(names[0])
    dev = torch.device("cuda")
    fluid = LennardJonesFluid(nparticles=N, reduced_density=0.8)
    box = fluid.box_vectors.value_in_unit_system(units.md_unit_system)
    pos = fluid.positions.value_in_unit_system(units.md_unit_system)
    common = dict(potential=fluid.potential, n_particles=N,
                  topology=fluid.topology, temperature=120.0 * units.kelvin,
                  timestep=2.0 * units.femtoseconds, device=dev)
    fast = make_fast_lj_runner(**common)
    melt = fast.positions(fast.run(fast.init(pos, box, seed=SEED),
                                   MELT_STEPS))
    runners, starts = {}, {}
    for path in PATHS:
        r = make_culled_lj_runner(slack=0.15, segment_steps=40, sort_mode="x",
                                  **{path: True}, **common)
        runners[path], starts[path] = r, r.init(melt, box, seed=SEED)
    torch.cuda.synchronize()

    ok = True
    rates = {(n, p): [] for n in names for p in PATHS}
    ends = {}
    for rnd in range(rounds):
        order = names[rnd % len(names):] + names[:rnd % len(names)]
        if rnd % 2:
            order = order[::-1]
        for name in order:
            use(name)
            for path in PATHS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                end = runners[path].run(starts[path], WINDOW_STEPS)
                torch.cuda.synchronize()
                rates[name, path].append(
                    WINDOW_STEPS / (time.perf_counter() - t0))
                runners[path].check(end)
                x = end.x.cpu()
                if path not in ends:
                    ends[path] = x
                elif not torch.equal(x.view(torch.int32),
                                     ends[path].view(torch.int32)):
                    print(f"round {rnd} {name} {path}: the end positions "
                          "differ from the first window's")
                    ok = False
        print(f"round {rnd}: order {order}: " + ", ".join(
            f"{n} {p} {rates[n, p][-1]:.1f}" for n in order for p in PATHS))
    base = names[0]
    print(f"{WINDOW_STEPS}-step windows, {rounds} rounds, steps/s "
          "(q1 / median / q3):")
    for path in PATHS:
        b = np.array(rates[base, path])
        bq1, bmed, bq3 = _stats(b)
        for name in names:
            a = np.array(rates[name, path])
            q1, med, q3 = _stats(a)
            line = (f"  {path} {name}: {q1:.1f} / {med:.1f} / {q3:.1f}, "
                    f"min {a.min():.1f}, max {a.max():.1f}")
            if name != base:
                wins = int((a > b).sum())
                line += (f"; against {base}: wins {wins} of {rounds} rounds, "
                         f"median {med - bmed:+.1f} ({(med / bmed - 1) * 100:+.2f}%), "
                         f"{base}'s quartile spread {bq3 - bq1:.1f}, "
                         f"every window above every {base} window: "
                         f"{bool(a.min() > b.max())}, median under {base}'s "
                         f"q1: {bool(med < bq1)}")
            print(line)

    order = [base] + names[1:] + names[1:][::-1] + [base]
    for name in order:
        use(name)
        for path in PATHS:
            r = runners[path]
            busy, wall, count, per = _device_rows(
                lambda: r.run(starts[path], PROFILE_STEPS), KERNEL[path])
            print(f"== {name} {path}: {PROFILE_STEPS} steps, device busy "
                  f"{busy / PROFILE_STEPS:.2f} us/step, wall "
                  f"{wall / PROFILE_STEPS:.2f} us/step (profiler on), idle "
                  f"share {1 - busy / wall:.3f}; {KERNEL[path]} {count}x "
                  f"{per:.2f} us/launch")
    fluid8 = LennardJonesFluid(nparticles=BIG_N, reduced_density=0.8)
    box8 = fluid8.box_vectors.value_in_unit_system(units.md_unit_system)
    pos8 = fluid8.positions.value_in_unit_system(units.md_unit_system)
    rng = np.random.default_rng(3)
    pos8 = ((pos8 + rng.normal(0, 0.01, pos8.shape)) % box8[0, 0]).astype(
        np.float32)
    kw8 = {**common, "potential": fluid8.potential, "n_particles": BIG_N,
           "topology": fluid8.topology}
    r8 = make_culled_lj_runner(slack=0.15, segment_steps=40, tn=256,
                               sort_mode="x", megakernel=True, **kw8)
    s8 = r8.init(pos8, box8, seed=5)
    md8, bx8 = r8.md, s8.box_diag.reshape(3).contiguous()
    for name in order:
        use(name)
        _, _, count, per = _device_rows(
            lambda: [lm.tile_build(s8.x, BIG_N, md8.tm, md8.tn, bx8,
                                   md8.cutoff, md8.slack, r8.capacity)
                     for _ in range(BIG_CALLS)], "tile_build_kernel")
        print(f"== {name} tile_build at n_pad {md8.n_pad} (tiles {md8.tm} x "
              f"{md8.tn}): {count}x {per:.2f} us/launch")
    _build.library = build
    print(f"end positions equal across every window and tree: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
