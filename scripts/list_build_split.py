#!/usr/bin/env python3
"""Phase times of the culled runner's list build on one NVIDIA GPU: K10
(``sort_build``) and K11's ``tile_build``, from ``clock64()`` stamps in an
instrumented copy of a tree's kernels.

    python3 scripts/list_build_split.py [TREE ...]

For each TREE (the root of a checkout; by default this one) the script
copies its ``chiron_tpu_torch`` package to ``chiron_tpu_torch/_build/split/``
of this checkout (listed in ``.gitignore``) and edits the copy's
``csrc``: thread 0 stamps ``clock64()`` after each phase's barrier (a
barrier is added where a phase has none), the global timer at the kernel's
first and last instruction, and two C entries read the stamps back.  The
tree itself is never touched.  In a process of its own, it then builds the
copy, makes the N=4000 state of ``chip_smoke.py`` (1000 dense steps from
the lattice, the culled runner's ``init``: n_pad 4096, tiles 128 x 256)
and prints, over 50 launches, the median microseconds of each phase of K10
(nslab 0 and 4) and of ``tile_build``, the cycles converted at the clock
the two timers give; then the whole of ``tile_build`` at n_pad 8192 and
100,096 (jittered lattices, the megakernel's tiles).

The stamps' anchors are lines of the kernels' sources (``EDITS``); a tree
whose sources lack one stops the script before anything is built
(``tests/test_torch_listbuild.py`` instruments this checkout on the CPU).
Without a CUDA device the script exits nonzero before measuring anything.
"""

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT_DIR = os.path.join(ROOT, "chiron_tpu_torch", "_build", "split")
LAUNCHES = 50
# stamp slots: 0-9 phases, 10 the global timer at the start, 11 at the end
HEADER = """static __device__ long long g_stamp[16];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k) do { if (threadIdx.x == 0) g_stamp[k] = clock64(); } while (0)
#define START() do { if (threadIdx.x == 0) g_stamp[10] = global_ns(); } while (0)
#define END(k) do { __syncthreads(); STAMP(k); \\
  if (threadIdx.x == 0) g_stamp[11] = global_ns(); } while (0)
namespace tile_build {"""
READER = """
CHIRON_EXPORT int {name}(long long* out) {{
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp)));
}}
"""
BAR = "__syncthreads();\n"

# (file, anchor, replacement): where the stamps go
EDITS = [
    ("tile_build.cuh", "namespace tile_build {", HEADER),
    ("tile_build.cuh", "  if (tid == 0) p.ptr2[0] = 0;\n  __syncthreads();\n",
     "  if (tid == 0) p.ptr2[0] = 0;\n  __syncthreads();\n  STAMP(5);\n"),
    ("tile_build.cuh", "    __syncthreads();\n\n    // warp 0:",
     "    __syncthreads();\n    STAMP(6);\n\n    // warp 0:"),
    ("tile_build.cuh", "    __syncthreads();\n\n    // each kept pair",
     "    __syncthreads();\n    STAMP(7);\n\n    // each kept pair"),
    ("tile_build.cuh", "  if (tid == 0) *total_sh = run;",
     "  " + BAR + "  STAMP(8);\n  if (tid == 0) *total_sh = run;"),
    ("tile_build.cuh", "    p.ccx[k] = 0.0f;\n  }\n}\n",
     "    p.ccx[k] = 0.0f;\n  }\n  END(9);\n}\n"),
    ("sortbuild.cu", "  Held h;\n", "  START();\n  STAMP(0);\n  Held h;\n"),
    ("sortbuild.cu", "  network(h, ",
     "  " + BAR + "  STAMP(1);\n  network(h, "),
    ("sortbuild.cu", "  __syncthreads();  // the exchange buffers are read no "
     "more\n",
     "  __syncthreads();  // the exchange buffers are read no more\n"
     "  STAMP(2);\n"),
    ("sortbuild.cu", "  __syncthreads();\n  // the gather",
     "  __syncthreads();\n  STAMP(3);\n  // the gather"),
    ("sortbuild.cu", "  __syncthreads();  // x' is read by the whole block "
     "below\n",
     "  __syncthreads();  // x' is read by the whole block below\n"
     "  STAMP(4);\n"),
    ("lj_mega.cu", "  tile_build::build(p, smem, box);",
     "  START();\n  STAMP(4);\n  tile_build::build(p, smem, box);"),
]
# the phases of K10 and of tile_build as (name, first stamp) pairs, and
# their last stamp
K10_PHASES = [("keys", 0), ("network", 1), ("permutation", 2), ("gather", 3),
              ("boxes", 4), ("pair stage", 5), ("scan", 6), ("place", 7),
              ("tail", 8)]
TILE_PHASES = [("boxes", 4), ("pair stage", 5), ("scan", 6), ("place", 7),
               ("tail", 8)]
LAST = 9


def instrument(tree, dest):
    """Copy tree's package to dest and put the stamps into its csrc."""
    src = os.path.join(os.path.abspath(tree), "chiron_tpu_torch")
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(src, os.path.join(dest, "chiron_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(dest, "chiron_tpu_torch", "csrc")
    for path, old, new in EDITS:
        full = os.path.join(csrc, path)
        with open(full) as f:
            text = f.read()
        if old not in text:
            raise SystemExit(f"{full}: the stamp's anchor is missing:\n{old}")
        with open(full, "w") as f:
            f.write(text.replace(old, new, 1))
    for path, entry in (("sortbuild.cu", "chiron_sort_stamps"),
                        ("lj_mega.cu", "chiron_tile_stamps")):
        with open(os.path.join(csrc, path), "a") as f:
            f.write(READER.format(name=entry))


def _lattice_runner(common, n, tn, dev):
    """A megakernel runner's init on a jittered lattice of n particles."""
    import numpy as np

    from chiron_tpu_torch import units
    from chiron_tpu_torch.runtime import make_culled_lj_runner
    from chiron_tpu_torch.testsystems import LennardJonesFluid

    fluid = LennardJonesFluid(nparticles=n, reduced_density=0.8)
    box = fluid.box_vectors.value_in_unit_system(units.md_unit_system)
    pos = fluid.positions.value_in_unit_system(units.md_unit_system)
    rng = np.random.default_rng(3)
    pos = ((pos + rng.normal(0, 0.01, pos.shape)) % box[0, 0]).astype(
        np.float32)
    kw = {**common, "potential": fluid.potential, "n_particles": n,
          "topology": fluid.topology}
    runner = make_culled_lj_runner(slack=0.15, segment_steps=40, tn=tn,
                                   sort_mode="x", megakernel=True, **kw)
    return runner, runner.init(pos, box, seed=5)


def measure(copy):
    """Run in the instrumented copy: print the phase medians."""
    import numpy as np
    import torch

    sys.path.insert(0, copy)
    from chiron_tpu_torch import units
    from chiron_tpu_torch.ops import _build
    from chiron_tpu_torch.ops import lj_mega as lm
    from chiron_tpu_torch.ops import sortbuild as sb
    from chiron_tpu_torch.runtime import (
        make_culled_lj_runner,
        make_fast_lj_runner,
    )
    from chiron_tpu_torch.testsystems import LennardJonesFluid

    lib = _build.library()
    for entry in ("chiron_sort_stamps", "chiron_tile_stamps"):
        getattr(lib, entry).argtypes = [ctypes.c_void_p]
        getattr(lib, entry).restype = ctypes.c_int
    dev = torch.device("cuda")
    n = 4000
    fluid = LennardJonesFluid(nparticles=n, reduced_density=0.8)
    box = fluid.box_vectors.value_in_unit_system(units.md_unit_system)
    pos = fluid.positions.value_in_unit_system(units.md_unit_system)
    common = dict(potential=fluid.potential, n_particles=n,
                  topology=fluid.topology, temperature=120.0 * units.kelvin,
                  timestep=2.0 * units.femtoseconds, device=dev)
    fast = make_fast_lj_runner(**common)
    melt = fast.positions(fast.run(fast.init(pos, box, seed=1234), 1000))
    rb = make_culled_lj_runner(slack=0.15, segment_steps=40,
                               fused_rebuild=True, **common)
    s = rb.init(melt, box, seed=1234)
    rm = make_culled_lj_runner(slack=0.15, segment_steps=40, sort_mode="x",
                               megakernel=True, **common)
    sm = rm.init(melt, box, seed=1234)
    box1 = s.box_diag.reshape(3).contiguous()

    def stamps(call, reader):
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        out = []
        for _ in range(LAUNCHES):
            call()
            torch.cuda.synchronize()
            b = np.zeros(16, dtype=np.int64)
            if reader(b.ctypes.data) != 0:
                raise RuntimeError("reading the stamps failed")
            out.append(b)
        return np.array(out)

    def split(label, call, reader, phases):
        b = stamps(call, reader)
        first, last = phases[0][1], LAST
        ns_per_cycle = (b[:, 11] - b[:, 10]) / (b[:, last] - b[:, first])
        bounds = [k for _, k in phases] + [last]
        us = [np.median((b[:, hi] - b[:, lo]) * ns_per_cycle) / 1e3
              for lo, hi in zip(bounds, bounds[1:])]
        total = np.median(b[:, 11] - b[:, 10]) / 1e3
        print(f"  {label}: " + ", ".join(
            f"{name} {t:.3f}" for (name, _), t in zip(phases, us))
            + f"; first to last instruction {total:.3f} us (SM clock "
            f"{1e3 / np.median(ns_per_cycle):.0f} MHz)")

    print(f"{copy}: medians of {LAUNCHES} launches, us")
    for nslab in (0, 4):
        cap = rb.capacity if nslab == 0 else (4096 // 128) * (4096 // 256)
        a = (s.x, s.v, s.F, box1, n, rb.md.tm, rb.md.tn, nslab,
             rb.md.cutoff, rb.md.slack, cap)
        split(f"K10 nslab {nslab}", lambda: sb.sort_build(*a),
              lib.chiron_sort_stamps, K10_PHASES)
    md = rm.md
    split("tile_build", lambda: lm.tile_build(
        sm.x, n, md.tm, md.tn, box1, md.cutoff, md.slack, rm.capacity),
        lib.chiron_tile_stamps, TILE_PHASES)
    for big in (8000, 100_000):
        runner, st = _lattice_runner(common, big, 256, dev)
        bx = st.box_diag.reshape(3).contiguous()
        b = stamps(lambda: lm.tile_build(
            st.x, big, runner.md.tm, runner.md.tn, bx, runner.md.cutoff,
            runner.md.slack, runner.capacity), lib.chiron_tile_stamps)
        print(f"  tile_build at n_pad {st.x.shape[1]} (tiles {runner.md.tm} "
              f"x {runner.md.tn}): first to last instruction "
              f"{np.median(b[:, 11] - b[:, 10]) / 1e3:.3f} us")


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        measure(sys.argv[2])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("list_build_split: no CUDA device visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    rc = 0
    for i, tree in enumerate(sys.argv[1:] or [ROOT]):
        copy = os.path.join(SPLIT_DIR, str(i))
        instrument(tree, copy)
        print(f"== {os.path.abspath(tree)}")
        sys.stdout.flush()
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--measure", copy]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
