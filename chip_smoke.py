#!/usr/bin/env python3
"""Drive the PyTorch port's LJ-fluid main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits nonzero):

1. the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc;
2. build the kernels of ``chiron_tpu_torch/csrc`` with nvcc;
3. compare every kernel with its plain PyTorch version on the card, at the
   main path's shapes (N=4000, n_pad=4096, tiles 128 x 256), on a
   configuration melted by 1000 dense steps, and time both with CUDA events;
4. run one culled segment twice from one carry: the results must be
   bitwise equal (no float atomics anywhere);
5. the main path of ``bench.py`` on the port, with launch counts reset just
   before it: ``LennardJonesFluid(4000, 0.8)``, 1000 dense BAOAB steps at
   120 K and 2 fs, then the culled runner (S=40, slack 0.15) for 3000 steps;
   ``check()`` must pass, the energy must be finite and agree with the f64
   oracle, the kinetic temperature must be within 5% of 120 K, and every
   kernel must have been launched.

The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script fails before printing any result.
"""

import json
import math
import os
import subprocess
import sys
import time

N = 4000
DENSITY = 0.8
T_KELVIN = 120.0
DENSE_STEPS = 1000
CULLED_STEPS = 3000
SEGMENT = 40
SLACK = 0.15
SEED = 1234


def _run(cmd):
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def _cuda_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _require(ok, what):
    if not ok:
        raise AssertionError(what)


def _report(name, err, tol, ms, plain_ms):
    print(f"  {name}: max_abs_err={err:.3e} (tolerance {tol}) "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chiron_tpu_torch import units
    from chiron_tpu_torch.ops import _build
    from chiron_tpu_torch.ops import lj_cull as lc
    from chiron_tpu_torch.ops.lj_dense import lj_dense_force_energy, lj_dense_plain
    from chiron_tpu_torch.oracles import lj_dense_oracle
    from chiron_tpu_torch.runtime import make_culled_lj_runner, make_fast_lj_runner
    from chiron_tpu_torch.testsystems import LennardJonesFluid

    dev = torch.device("cuda")

    # ---- 1. the card and the toolchain ----
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(f"[1] card: {smi}")
    print(f"    python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    print("    " + _run([_build._nvcc(), "--version"]).splitlines()[-1])

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.library()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({_build.build_dir()})")

    fluid = LennardJonesFluid(nparticles=N, reduced_density=DENSITY)
    box = fluid.box_vectors.value_in_unit_system(units.md_unit_system)
    pos0 = fluid.positions.value_in_unit_system(units.md_unit_system)
    pot = fluid.potential
    common = dict(potential=pot, n_particles=N, topology=fluid.topology,
                  temperature=T_KELVIN * units.kelvin,
                  timestep=2.0 * units.femtoseconds, device=dev)

    # ---- 3. each kernel against its plain version ----
    print(f"[3] kernels against their plain versions (melted N={N})")
    fast = make_fast_lj_runner(**common)
    fs = fast.run(fast.init(pos0, box, seed=7), DENSE_STEPS)
    x_melt = fs.x
    box_diag = fs.box_vectors
    sig, eps, cut = pot.sigma, pot.epsilon, pot.cutoff
    results = {}

    # K1: the dense triangle kernel at n_pad = 4096
    Fp, Ep = lj_dense_plain(x_melt, box_diag, N, sig, eps, cut)
    scale = float(Fp.abs().max())
    Fk, Ek = lj_dense_force_energy(x_melt, box_diag, N, sig, eps, cut,
                                   approx_recip=False)
    Fa, _ = lj_dense_force_energy(x_melt, box_diag, N, sig, eps, cut,
                                  approx_recip=True, with_energy=False)
    err = float((Fk - Fp).abs().max())
    err_a = float((Fa - Fp).abs().max())
    e_rel = abs(float(Ek) - float(Ep)) / abs(float(Ep))
    _require(err / scale < 1e-5, f"K1 exact force rel err {err / scale}")
    _require(err_a / scale < 1e-4, f"K1 approx force rel err {err_a / scale}")
    _require(e_rel < 1e-5, f"K1 energy rel err {e_rel}")
    ms = _cuda_ms(lambda: lj_dense_force_energy(
        x_melt, box_diag, N, sig, eps, cut, approx_recip=True,
        with_energy=False))
    plain_ms = _cuda_ms(lambda: lj_dense_plain(
        x_melt, box_diag, N, sig, eps, cut, with_energy=False), reps=5)
    print(f"  lj_dense approx-recip force rel err {err_a / scale:.3e} "
          f"(tolerance 1e-4), energy rel err {e_rel:.3e} (tolerance 1e-5)")
    _report("lj_dense (exact force vs plain, rel tol 1e-5)", err, "1e-5 rel",
            ms, plain_ms)
    results["lj_dense"] = dict(
        source="chiron_tpu_torch/csrc/lj_dense.cu",
        replaces="chiron_tpu/ops/lj_dense.py:340", max_abs_err=err,
        ms=ms, plain_ms=plain_ms)

    # K4 and K3's force phase: the culled force on the production list
    runner = make_culled_lj_runner(slack=SLACK, segment_steps=SEGMENT,
                                   **common)
    c0 = runner.init(fast.positions(fs), box, seed=7)
    md = runner.md
    pairs = c0.pairs
    print(f"    culled list: nslab={runner.nslab} capacity={runner.capacity} "
          f"count={int(pairs.count)} (tm={md.tm}, tn={md.tn}, "
          f"n_pad={md.n_pad})")

    def cforce(approx, energy=False):
        return lc.culled_force_pass(c0.x, box_diag, pairs, N, md.tm, md.tn,
                                    sig, eps, cut, approx, energy)

    Fp, Ep = lc.row_force_pass_plain(c0.x, box_diag, pairs, N, md.tm, md.tn,
                                     sig, eps, cut, with_energy=True)
    Fk, Ek = cforce(False, True)
    Fa, _ = cforce(True)
    scale = float(Fp.abs().max())
    diff = (Fk - Fp)[:, :N].abs()
    err = float(diff.max())
    p99 = float(torch.quantile(diff.flatten(), 0.99)) / scale
    err_a = float((Fa - Fk).abs().max()) / scale
    e_rel = abs(float(Ek) - float(Ep)) / abs(float(Ep))
    _require(err < 0.05 and p99 < 1e-5, f"culled force err {err}, p99 {p99}")
    _require(float(Fk[:, N:].abs().max()) == 0.0, "culled force padding")
    _require(err_a < 1e-4, f"culled approx vs exact rel err {err_a}")
    _require(e_rel < 1e-5, f"culled energy rel err {e_rel}")
    ms = _cuda_ms(lambda: cforce(True))
    plain_ms = _cuda_ms(lambda: lc.row_force_pass_plain(
        c0.x, box_diag, pairs, N, md.tm, md.tn, sig, eps, cut), reps=5)
    print(f"  culled_force p99 rel err {p99:.3e} (tolerance 1e-5), approx vs "
          f"exact rel {err_a:.3e} (1e-4), energy rel {e_rel:.3e} (1e-5)")
    _report("culled_force (exact vs plain, max abs tol 0.05)", err, 0.05, ms,
            plain_ms)
    results["culled_force"] = dict(
        source="chiron_tpu_torch/csrc/lj_cull_force.cu",
        replaces="chiron_tpu/ops/lj_cull.py:700", max_abs_err=err,
        ms=ms, plain_ms=plain_ms)

    # K3's BAOAB phase, in place on copies of the carry
    w0 = c0.v - (0.5 * md.dt) * c0.F * md.minv
    state_k = [c0.x.clone(), w0.clone(), c0.F.clone()]
    lc.baoab_phase_(*state_k, md.minv, md.sigv, box_diag, SEED, c0.step, 3,
                    md.dt, md.a, md.b)
    xp, wp, Fz = lc.baoab_phase_plain(c0.x, w0, c0.F, md.minv, md.sigv,
                                      box_diag, SEED, 3, md.dt, md.a, md.b)
    ex = float((state_k[0] - xp).abs().max())
    ew = float((state_k[1] - wp).abs().max())
    _require(ex < 1e-5 and ew < 1e-4, f"baoab x err {ex}, v err {ew}")
    _require(float(state_k[2].abs().max()) == 0.0 and float(Fz.abs().max()) == 0.0,
             "baoab F reset")
    ms = _cuda_ms(lambda: lc.baoab_phase_(
        *state_k, md.minv, md.sigv, box_diag, SEED, c0.step, 3, md.dt, md.a,
        md.b))
    plain_ms = _cuda_ms(lambda: lc.baoab_phase_plain(
        c0.x, w0, c0.F, md.minv, md.sigv, box_diag, SEED, 3, md.dt, md.a,
        md.b))
    print(f"  baoab position err {ex:.3e} (tolerance 1e-5)")
    _report("baoab (velocity vs plain, tol 1e-4)", ew, 1e-4, ms, plain_ms)
    results["baoab"] = dict(
        source="chiron_tpu_torch/csrc/baoab.cu",
        replaces="chiron_tpu/ops/lj_cull.py:984", max_abs_err=max(ex, ew),
        ms=ms, plain_ms=plain_ms)

    # K3's drift latch: a real segment, a forced trip and a NaN
    c1 = runner.segment_fn(SEGMENT)(c0)
    x_end, anchor = c1.x, c1.x_anchor
    tripped = anchor.clone()
    tripped[0, 10] += 0.6 * SLACK
    tripped[1, 20] -= 0.6 * SLACK
    poisoned = x_end.clone()
    poisoned[2, 5] = float("nan")
    flags = []
    for xx, aa, expect in ((x_end, anchor, None), (x_end, tripped, True),
                           (poisoned, anchor, True)):
        fk = bool(lc.tile_skin_drift_bad(xx, aa, N, SLACK, box_diag))
        fp = bool(lc.tile_skin_drift_bad_plain(xx, aa, N, SLACK, box_diag))
        _require(fk == fp and (expect is None or fk == expect),
                 f"drift latch kernel {fk}, plain {fp}, expected {expect}")
        flags.append(fk)
    ms = _cuda_ms(lambda: lc.tile_skin_drift_bad(x_end, anchor, N, SLACK,
                                                 box_diag))
    plain_ms = _cuda_ms(lambda: lc.tile_skin_drift_bad_plain(
        x_end, anchor, N, SLACK, box_diag))
    _report(f"tile_skin_drift (flags {flags} equal to plain)", 0.0, "equal",
            ms, plain_ms)
    results["tile_skin_drift"] = dict(
        source="chiron_tpu_torch/csrc/drift.cu",
        replaces="chiron_tpu/ops/lj_cull.py:984", max_abs_err=0.0,
        ms=ms, plain_ms=plain_ms)

    # ---- 4. determinism ----
    seg = runner.segment_fn(SEGMENT)
    a, b = seg(c0), seg(c0)
    for name in ("x", "v", "F", "overflowed"):
        _require(torch.equal(getattr(a, name), getattr(b, name)),
                 f"repeated segment differs in {name}")
    print("[4] a repeated culled segment is bitwise identical")

    # ---- 5. the main path, counted ----
    _build.reset_launch_counts()
    fast = make_fast_lj_runner(**common)
    fs = fast.init(pos0, box, seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fs = fast.run(fs, DENSE_STEPS)
    torch.cuda.synchronize()
    dense_rate = DENSE_STEPS / (time.perf_counter() - t0)
    runner = make_culled_lj_runner(slack=SLACK, segment_steps=SEGMENT,
                                   **common)
    st = runner.init(fast.positions(fs), box, seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = runner.run(st, CULLED_STEPS)
    torch.cuda.synchronize()
    culled_rate = CULLED_STEPS / (time.perf_counter() - t0)
    runner.check(st)
    energy = float(runner.energy(st))
    counts = dict(_build.launches)

    _require(math.isfinite(energy), f"energy {energy}")
    pos = runner.positions(st).double()
    _, e64 = lj_dense_oracle(pos, torch.as_tensor(box, device=dev).double(),
                             sig, eps, cut)
    e_rel = abs(energy - float(e64)) / abs(float(e64))
    _require(e_rel < 1e-5, f"energy rel err vs f64 oracle {e_rel}")
    v = runner.velocities(st).double()
    m = float(fluid.topology.masses()[0])
    t_kin = m * float((v * v).sum()) / (3 * N * units.kB_MD)
    _require(abs(t_kin - T_KELVIN) / T_KELVIN < 0.05, f"T_kin {t_kin}")
    for name in results:
        _require(counts.get(name, 0) > 0, f"kernel {name} never launched")
    print(f"[5] main path: check() passed, energy {energy:.6f} kJ/mol "
          f"(f64 oracle rel err {e_rel:.2e}), T_kin {t_kin:.3f} K, "
          f"launches {counts}")
    print(f"    dense {dense_rate:.1f} steps/s, culled {culled_rate:.1f} "
          f"steps/s (N=4000, {smi})")

    kernels = [dict(name=name, route="cuda", launches=counts[name], **r)
               for name, r in results.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
