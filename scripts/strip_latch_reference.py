#!/usr/bin/env python3
"""Replay the JAX package's strip runner, on the CPU, from a state the
PyTorch port wrote on the GPU, and hold its latch checks to the port's.

    python3 chip_profile.py --strip-latch DIR       # on the GPU: the port
    JAX_PLATFORMS=cpu python3 scripts/strip_latch_reference.py \
        DIR/strip_latch.npz [STEPS SEGMENTS]

The state is the first one of the strip runner in ``chip_profile.py``
(``LennardJonesFluid(4000, 0.8)``, 120 K, 2 fs, tm 128, slack 0.3,
segments of 50 steps), with the port's size, tiles, halo H, noise seed
and step.  Both runners draw the same splitmix32 noise from (seed, step),
so they follow one trajectory until float rounding sets them apart.  For
each segment this prints the JAX runner's band width W + (n_pad - n) at the
head and its top-2 joint drift from the sort at the end
(``runtime._top2_drift``) beside the port's, and the first segment at which
each runner latches, with the two largest drifts and the fastest particle
there.  With STEPS and SEGMENTS it replays SEGMENTS segments of STEPS steps
instead (the port's numbers are then not beside it).

    ... strip_latch_reference.py DIR/strip_latch.npz trace K STEPS

replays K segments, then steps on from the head of segment K (its sort and
halo) STEPS single steps without a re-sort, and prints at each step the
largest difference between the strip force and the all-pairs
minimum-image force (``oracles.lj_dense_oracle``) over the live particles,
the largest all-pairs force, and the fastest particle with its x and rank.
(One step a call turns v into w and back, a rounding the segment's own
loop does not take.)
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from chiron_tpu import runtime as jrt
from chiron_tpu import testsystems, units
from chiron_tpu.oracles import lj_dense_oracle
from chiron_tpu.ops.lj_band import band_width_needed
from chiron_tpu.ops.lj_strip import _PAD_X, sort_by_key_strip


def main(path, steps=None, segments=None):
    port = np.load(path)
    n = int(port["n"])
    same = steps is None or int(steps) == int(port["steps"])
    steps = int(port["steps"]) if steps is None else int(steps)
    segments = len(port["width"]) if segments is None else int(segments)
    fluid = testsystems.LennardJonesFluid(nparticles=n, reduced_density=0.8)
    runner = jrt.make_strip_lj_runner(
        potential=fluid.potential, n_particles=n, topology=fluid.topology,
        temperature=120.0 * units.kelvin, timestep=2.0 * units.femtoseconds,
        tm=int(port["tm"]), slack=float(port["slack"]), segment_steps=steps)
    md = runner.md
    md.set_halo(int(port["H"]))
    runner.seed = int(port["seed"])
    n_pad, H = md.n_pad, md.H
    valid = jnp.arange(n_pad) < n
    reach = md.cutoff + md.slack
    sigma_v = float(md.sigv[0, 0])
    state = jrt.StripCarry(
        x=jnp.asarray(port["x"]), v=jnp.asarray(port["v"]),
        F=jnp.asarray(port["F"]), step=jnp.asarray(port["step"]),
        box_diag=jnp.asarray(port["box_diag"]),
        overflowed=jnp.asarray(False))
    L = state.box_diag.reshape(3, 1)
    widths, drifts, first = [], [], None
    t0 = time.perf_counter()
    for k in range(segments):
        center = jnp.where(valid, state.x[:, :n_pad], jnp.float32(_PAD_X))
        x3s, _ = sort_by_key_strip(center, ())
        width = int(band_width_needed(
            jnp.where(valid, x3s[0], jnp.float32(3.0e38)), n, reach,
            state.box_diag[0, 0])) + (n_pad - n)
        was = bool(state.overflowed)
        state = runner.run(state, steps)
        d = state.x[:, :n_pad] - x3s
        d = d - L * jnp.round(d / L)
        top2 = float(jrt._top2_drift(d, valid))
        widths.append(width)
        drifts.append(top2)
        line = f"segment {k}: JAX W + pad {width}, top-2 {top2:.6f} nm"
        if same:
            line += (f"; port {int(port['width'][k])}, "
                     f"{float(port['top2'][k]):.6f} nm")
        print(line, flush=True)
        if first is None and bool(state.overflowed) and not was:
            first = k
            dist = np.where(np.asarray(valid),
                            np.sqrt((np.asarray(d) ** 2).sum(axis=0)), 0.0)
            speed = np.sqrt((np.asarray(state.v)[:, :n] ** 2).sum(axis=0))
            top = np.argsort(-dist)[:2]
            print(f"  first latch: the two largest drifts {dist[top[0]]:.6f} "
                  f"and {dist[top[1]]:.6f} nm; the fastest particle "
                  f"{speed.max():.4f} nm/ps, {speed.max() / sigma_v:.2f} "
                  f"sigma_v (sqrt(kT/m) = {sigma_v:.4f} nm/ps)")
    jax.block_until_ready(state.x)
    w, t = np.array(widths), np.array(drifts)
    print(f"{len(w)} segments of {steps} steps in "
          f"{time.perf_counter() - t0:.1f} s on the CPU; H = {H}, slack "
          f"{md.slack}")
    print(f"JAX: band width {w.min()}-{w.max()} (over H in "
          f"{int((w > H).sum())}), top-2 drift {t.min():.6f}-{t.max():.6f} "
          f"nm (over the slack in {int((t > md.slack).sum())}), first latch "
          f"{first}")
    if same:
        port_first = np.flatnonzero(port["latched"])
        print(f"port: band width {port['width'].min()}-"
              f"{port['width'].max()}, top-2 drift {port['top2'].min():.6f}-"
              f"{port['top2'].max():.6f} nm, first latch "
              f"{int(port_first[0]) if port_first.size else None}")


def trace(path, segments, steps):
    """The strip force against the all-pairs force, step by step from the
    head of segment ``segments``."""
    port = np.load(path)
    n = int(port["n"])
    fluid = testsystems.LennardJonesFluid(nparticles=n, reduced_density=0.8)
    runner = jrt.make_strip_lj_runner(
        potential=fluid.potential, n_particles=n, topology=fluid.topology,
        temperature=120.0 * units.kelvin, timestep=2.0 * units.femtoseconds,
        tm=int(port["tm"]), slack=float(port["slack"]),
        segment_steps=int(port["steps"]))
    md = runner.md
    md.set_halo(int(port["H"]))
    runner.seed = seed = int(port["seed"])
    n_pad = md.n_pad
    valid = jnp.arange(n_pad) < n
    state = jrt.StripCarry(
        x=jnp.asarray(port["x"]), v=jnp.asarray(port["v"]),
        F=jnp.asarray(port["F"]), step=jnp.asarray(port["step"]),
        box_diag=jnp.asarray(port["box_diag"]),
        overflowed=jnp.asarray(False))
    for _ in range(int(segments)):
        state = runner.run(state, int(port["steps"]))
    box = state.box_diag[0]
    center = jnp.where(valid, state.x[:, :n_pad], jnp.float32(_PAD_X))
    x3s, payload = sort_by_key_strip(
        center, tuple(state.v) + tuple(state.F))
    xe = md.extend(x3s, box)
    v, F = jnp.stack(payload[0:3]), jnp.stack(payload[3:6])
    step0 = int(state.step[0, 0])
    pot = fluid.potential
    box33 = jnp.diag(box)
    for s in range(int(steps)):
        xe, v, F = md.run_segment(xe, v, F, box, seed, step0 + s, 1)
        pos = xe[:, :n].T
        F_ref, _ = lj_dense_oracle(pos, box33, pot.sigma, pot.epsilon,
                                   pot.cutoff)
        err = float(jnp.abs(F[:, :n].T - F_ref).max())
        speed = jnp.sqrt(jnp.sum(v[:, :n] ** 2, axis=0))
        q = int(jnp.argmax(speed))
        print(f"step {step0 + s + 1}: strip force off the all-pairs force "
              f"by up to {err:.4g} (largest all-pairs |F| "
              f"{float(jnp.abs(F_ref).max()):.4g}); fastest particle: rank "
              f"{q}, x {float(xe[0, q]):.4f} nm, {float(speed[q]):.4f} "
              f"nm/ps", flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[2] == "trace":
        trace(sys.argv[1], *sys.argv[3:])
    else:
        main(*sys.argv[1:])
