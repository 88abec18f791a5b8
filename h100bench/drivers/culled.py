"""Traffic of the kind ``culled``: one LJ fluid on a culled runner of the
program (``runtime.make_lj_runner`` or ``runtime.make_culled_lj_runner``,
with the traffic file's ``runner`` options), a frame being
``steps_per_frame`` steps in whole segments (``runner.segment_fn``, the
body of ``runner.run``), then the positions copied to the host and the
latch read (``runner.check``).

The judge follows a captured segment from the program's state at its
start with the reference's own BAOAB steps and forces, and compares the
positions, velocities and forces at its end, and the latch.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..reference import lj as ref
from . import lj_objects


class Sim:
    kind = "culled"

    def __init__(self, fluid, config, traffic, seed: int, device):
        from chiron_tpu_torch import runtime

        self.fluid, self.traffic, self.seed = fluid, traffic, seed
        self.device = torch.device(device)
        potential, topology, box = lj_objects(fluid)
        positions = melt(fluid, config, potential, topology, box, seed,
                         device)
        opts = dict(traffic["runner"])
        factory = getattr(runtime, traffic["factory"])
        if traffic["factory"] == "make_lj_runner":
            opts["box_vectors"] = box
        self.runner = factory(
            potential=potential, n_particles=fluid.n, topology=topology,
            temperature=fluid.temperature, timestep=fluid.lng.dt,
            collision_rate=fluid.lng.gamma, device=device, **opts)
        self.slack = traffic["runner"]["slack"]
        self.state = self.runner.init(positions, box, seed=seed)
        S = self.runner.segment_steps
        self.steps_per_frame = traffic["steps_per_frame"]
        if self.steps_per_frame % S:
            raise ValueError(f"steps_per_frame {self.steps_per_frame} is "
                             f"not whole segments of {S}")
        self.segments = self.steps_per_frame // S
        self.segment = self.runner.segment_fn(S)
        self.steps = 0
        self.chains = 1

    def frame(self, keep=None):
        """One frame.  Returns (failed, drawn, last): the segment that
        ``keep`` draws (an index into the frame's segments; None draws
        none) and the frame's last segment, each as (start, end, first
        step)."""
        S = self.runner.segment_steps
        drawn = None
        for k in range(self.segments):
            start = self.state
            with record_function("segment"):
                self.state = self.segment(start)
            if keep is not None and k == keep % self.segments:
                drawn = (start, self.state, self.steps)
            self.steps += S
        last = (start, self.state, self.steps - S)
        with record_function("frame_to_host"):
            self.runner.positions(self.state).to("cpu")
        with record_function("latch_read"):
            try:
                self.runner.check(self.state)
                failed = False
            except RuntimeError:
                failed = True
        return failed, drawn, last

    def end_positions(self, capture):
        """(1, N, 3) positions at a captured segment's end."""
        return capture[1].x[:, :self.fluid.n].T[None]

    def box(self):
        return torch.full((1, 3), self.fluid.box, dtype=torch.float64,
                          device=self.device)

    # -- the judge ---------------------------------------------------------
    def starts(self, capture):
        """The segment's start as the program laid it out for its noise:
        ((1, N, 3) x, (1, N, 3) v) in float64, or None where the start is
        not a permutation of the previous segment's end."""
        start, end, _ = capture
        n = self.fluid.n
        x_in = start.x[:, :n].T.double()
        v_in = start.v[:, :n].T.double()
        if self.runner.path == "megakernel":
            return x_in[None], v_in[None]
        # the default and fused paths sort at the segment's head; the list's
        # anchor holds the sorted start
        x0 = end.x_anchor[:, :n].T.double()
        idx, dist = ref.nearest(x0, x_in, self.box()[0])
        if bool((dist != 0).any()) or idx.unique().numel() != n:
            return None
        return x0[None], v_in[idx][None]

    def program_end(self, capture):
        """The program's (x, v, F, latch) at the segment's end."""
        _, end, _ = capture
        n = self.fluid.n
        return (end.x[:, :n].T[None], end.v[:, :n].T[None],
                end.F[:, :n].T[None], bool(end.overflowed))

    def latch_before(self, capture):
        return bool(capture[0].overflowed)

    def run_reference(self, capture, x0, v0, dtype):
        f = self.fluid
        return ref.baoab(x0, v0, self.box(), f.lj, f.lng, [f.kT],
                         [self.seed], capture[2], self.runner.segment_steps,
                         self.runner.md.n_pad, dtype)


def melt(fluid, config, potential, topology, box, seed, device):
    """The lattice, melted by ``melt_steps`` steps of the program's dense
    runner at the seed (none: the lattice itself)."""
    steps = config.get("melt_steps", 0)
    if not steps:
        return fluid.positions
    from chiron_tpu_torch import runtime

    fast = runtime.make_fast_lj_runner(
        potential=potential, n_particles=fluid.n, topology=topology,
        temperature=fluid.temperature, timestep=fluid.lng.dt,
        collision_rate=fluid.lng.gamma, device=device)
    s = fast.init(fluid.positions, box, seed=seed)
    s = fast.run(s, steps)
    return fast.positions(s).contiguous()


def judge_segments(sim, captures, control_dtype=None):
    """The numbers that decide ``correct`` over the captured segments: the
    program's end against the reference's (or, with ``control_dtype``, the
    reference computed in that precision put in the program's place)."""
    f = sim.fluid
    L = sim.box()
    worst = dict(x_err_nm=0.0, v_err_nm_per_ps=0.0, force_rel_err=0.0,
                 latch_mismatch=0)
    for cap in captures:
        st = sim.starts(cap)
        if st is None:
            worst["x_err_nm"] = float("inf")
            continue
        x0, v0 = st
        xr, vr, _, _ = sim.run_reference(cap, x0, v0, torch.float64)
        if control_dtype is None:
            xo, vo, Fo, flag = sim.program_end(cap)
            flag_in = sim.latch_before(cap)
        else:
            xo, vo, Fo, _ = sim.run_reference(cap, x0, v0, control_dtype)
            flag, flag_in = None, False
        xo, vo, Fo = (t[0].double() for t in (xo, vo, Fo))
        idx, dist = ref.nearest(xo, xr[0], L[0])
        if idx.unique().numel() != f.n or not bool(torch.isfinite(dist).all()):
            worst["x_err_nm"] = float("inf")
            continue
        dv = (vo - vr[0][idx]).norm(dim=1)
        pairs = ref.pair_list(xo[None], L, f.lj.cutoff + 0.3)
        Fr, _ = ref.force_energy(xo[None], L, f.lj, pairs)
        Fr = Fr[0]
        f_rms = float(Fr.norm(dim=1).pow(2).mean().sqrt())
        f_err = float((Fo - Fr).norm(dim=1).max()) / f_rms
        worst["x_err_nm"] = ref.worse(worst["x_err_nm"], dist.max())
        worst["v_err_nm_per_ps"] = ref.worse(worst["v_err_nm_per_ps"],
                                             dv.max())
        worst["force_rel_err"] = ref.worse(worst["force_rel_err"], f_err)
        if flag is not None:
            drift = ref.min_image(xo - x0[0][idx], L[0]).norm(dim=1)
            top2 = float(torch.topk(drift, 2).values.sum())
            if abs(top2 - sim.slack) > 1e-5:
                expected = flag_in or not top2 <= sim.slack
                worst["latch_mismatch"] += int(expected != flag)
    return worst
