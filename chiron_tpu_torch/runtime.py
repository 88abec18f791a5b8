"""Runners of the LJ-fluid NVT main path (port of ``chiron_tpu/runtime.py``).

``make_fast_lj_runner`` is the dense BAOAB runner (K1 every step) that
melts the lattice; ``make_culled_lj_runner`` is the production engine: each
segment sorts the state by the spatial key, rebuilds the tile-pair list and
advances S steps on the culled kernels, with the drift latch at its end.
``run`` is a Python loop of device work: only ``init`` and ``check`` wait
for the device.

Ported knobs are the production ones.  Not ported (opt-in or measured as
losing levers in the JAX package): ``megakernel``, ``fused_rebuild``,
``mxu_reduce``, ``prefetch``, ``unroll``, ``sort_every``/``rebuild_every``
above 1, and the per-call ``interpret`` flag.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import units
from .integrators import LangevinCarry
from .ops.lj_cull import (
    CulledLJMD,
    TilePairList,
    build_tile_pairs,
    slab_y_key,
    sort_by_key,
)
from .ops.lj_dense import LJDense, box_diagonal


def _md_constants(temperature, timestep, collision_rate):
    """(kT, dt, gamma) in MD units."""
    kT = units.kB_MD * units.strip_md(temperature, units.kelvin)
    dt = units.strip_md(timestep, units.picosecond)
    gamma = units.strip_md(collision_rate, 1.0 / units.picosecond)
    return kT, dt, gamma


class FastLJRunner:
    """Dense BAOAB Langevin runner on K1 (``runtime.py:82-187``).

    State lives in the kernel's (3, n_pad) lane layout.  ``step(state,
    noise)`` is the pure step with the O-step noise as an argument; ``run``
    draws that noise from the state's ``torch.Generator``.
    """

    def __init__(self, op: LJDense, masses_1d, kT: float, dt: float,
                 gamma: float, exact_forces: bool):
        f32 = torch.float32
        dev = op.device
        self.op = op
        self.n = op.n
        self.n_pad = op.n_pad
        self.exact_forces = exact_forces
        self.a = torch.exp(torch.tensor(-gamma * dt, dtype=f32)).to(dev)
        self.b = torch.sqrt(
            1.0 - torch.exp(torch.tensor(-2.0 * gamma * dt, dtype=f32))
        ).to(dev)
        self.dt = torch.tensor(dt, dtype=f32, device=dev)
        m_lane = torch.ones((1, self.n_pad), dtype=f32, device=dev)
        m_lane[0, :self.n] = torch.as_tensor(masses_1d, dtype=f32, device=dev)
        self.m_lane = m_lane
        self.sigma_v_lane = torch.sqrt(kT / m_lane)

    def _force(self, x3, box_diag):
        return self.op.force_only_t(x3, box_diag,
                                    approx_recip=not self.exact_forces)

    def init(self, positions, box_vectors, seed: int = 0,
             velocities=None) -> LangevinCarry:
        dev = self.op.device
        x3 = self.op.pad_positions(positions)
        box_diag = box_diagonal(box_vectors, dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        if velocities is None:
            noise = torch.randn((3, self.n_pad), generator=gen, device=dev)
            v3 = self.sigma_v_lane * noise
        else:
            v3 = self.op.pad_positions(velocities)
        return LangevinCarry(
            x=x3, v=v3, F=self._force(x3, box_diag), box_vectors=box_diag,
            overflowed=torch.zeros((), dtype=torch.bool, device=dev),
            generator=gen,
        )

    def step(self, state: LangevinCarry, noise) -> LangevinCarry:
        """One BAOAB step with the given (3, n_pad) standard-normal noise."""
        half = self.dt * 0.5
        box = state.box_vectors
        v = state.v + half * state.F / self.m_lane
        x = state.x + half * v
        v = self.a * v + self.b * self.sigma_v_lane * noise
        x = x + half * v
        Lcol = box.reshape(3, 1)
        x = x - torch.floor(x / Lcol) * Lcol
        F = self._force(x, box)
        v = v + half * F / self.m_lane
        return LangevinCarry(x=x, v=v, F=F, box_vectors=box,
                             overflowed=state.overflowed,
                             generator=state.generator)

    def run(self, state: LangevinCarry, n_steps: int) -> LangevinCarry:
        for _ in range(n_steps):
            noise = torch.randn((3, self.n_pad), generator=state.generator,
                                device=state.x.device)
            state = self.step(state, noise)
        return state

    def energy(self, state: LangevinCarry):
        return self.op.force_energy_t(state.x, state.box_vectors)[1]

    def positions(self, state: LangevinCarry):
        return self.op.unpad(state.x)

    def velocities(self, state: LangevinCarry):
        return self.op.unpad(state.v)


def make_fast_lj_runner(
    potential,
    n_particles: int,
    temperature=300.0 * units.kelvin,
    timestep=2.0 * units.femtoseconds,
    collision_rate=1.0 / units.picoseconds,
    topology=None,
    tm: int = 512,
    exact_forces: bool = False,
    *,
    device,
) -> FastLJRunner:
    """Dense LJ Langevin runner on ``device``.

    ``exact_forces=False`` steps with the approximate reciprocal; energies
    always use the exact one.
    """
    if topology is None:
        topology = potential.topology
    kT, dt, gamma = _md_constants(temperature, timestep, collision_rate)
    op = LJDense(n_particles, potential.sigma, potential.epsilon,
                 potential.cutoff, tm=tm, tn=tm, device=device)
    return FastLJRunner(op, topology.masses(), kT, dt, gamma, exact_forces)


@dataclass
class CullCarry:
    """State of the culled runner in the spatially sorted layout.

    ``pairs`` is the live tile-pair list and ``x_anchor`` the positions it
    was built from.
    """

    x: torch.Tensor           # (3, n_pad)
    v: torch.Tensor           # (3, n_pad)
    F: torch.Tensor           # (3, n_pad)
    step: torch.Tensor        # (1, 1) int32 cumulative step count
    box_diag: torch.Tensor    # (1, 3)
    overflowed: torch.Tensor  # () bool: capacity/shift/drift violation
    pairs: TilePairList
    x_anchor: torch.Tensor    # (3, n_pad)


def _culled_layout_init(md: CulledLJMD, dense: LJDense, positions,
                        box_vectors, sort_mode: str, n: int):
    """Resolve the sort mode and slab count from the box, sort, probe the
    tile-pair count and build the production list with 2x headroom
    (``runtime.py:415-507``).  Returns (x3s, box_diag, nslab, capacity,
    pairs); raises ValueError where the culled kernel cannot apply."""
    x3 = dense.pad_positions(positions)
    box_diag = box_diagonal(box_vectors, md.device)
    box_host = box_diag.cpu()
    Lx = float(box_host[0, 0])
    L_min = float(box_host.min())
    if 0.5 * L_min - md.cutoff - md.slack <= 0:
        raise ValueError(
            "culled runner inapplicable: box under ~2 reaches "
            "(cutoff+slack) wide on its narrowest axis -- use "
            "make_fast_lj_runner instead"
        )
    headroom = 0.5 * Lx - md.cutoff - md.slack
    mode = sort_mode
    if mode == "auto":
        mode = "slab" if Lx / (md.cutoff + md.slack) >= 6.5 else "x"
    if mode == "x":
        nslab = 0
    else:
        nslab_perf = max(1, int(round(Lx / (0.72 * md.cutoff))))
        nslab_geom = int(np.ceil(2.0 * Lx / headroom))
        nslab = max(nslab_perf, nslab_geom)
        if nslab > max(1, n // (2 * max(md.tm, md.tn))):
            raise ValueError(
                "culled runner inapplicable: satisfying the "
                f"x-shift bound needs {nslab} slabs but slab "
                "occupancy would drop below 2 tiles -- use "
                "sort_mode='x' or make_fast_lj_runner"
            )
    key = slab_y_key(x3, n, nslab, Lx, Ly=float(box_host[0, 1]))
    x3s, _ = sort_by_key(key, x3, ())
    nr, nc = md.n_pad // md.tm, md.n_pad // md.tn
    cap_max = nr * nc
    probe = build_tile_pairs(x3s, n, md.tm, md.tn, box_diag[0], md.cutoff,
                             md.slack, capacity=cap_max)
    if bool(probe.overflowed):
        raise ValueError(
            "culled runner inapplicable to this box/cutoff (the x/y shift "
            "bound is violated at init) -- use make_fast_lj_runner"
        )
    count = int(probe.count[0, 0])
    capacity = min(cap_max, int(count * 2.0) + 128)
    pairs = probe._replace(
        rows=probe.rows[:, :capacity].contiguous(),
        cols=probe.cols[:, :capacity].contiguous(),
        ccx=probe.ccx[:, :capacity].contiguous(),
        ptr2=torch.clamp_max(probe.ptr2, capacity),
        count=torch.clamp_max(probe.count, capacity),
    )
    return x3s, box_diag, nslab, capacity, pairs


def _culled_engine_setup(potential, n_particles, temperature, timestep,
                         collision_rate, topology, tm, tn, slack, device):
    """The CulledLJMD engine and the dense energy op on a common padding
    (``runtime.py:510-550``).  Returns (md, dense)."""
    if topology is None:
        topology = potential.topology
    masses_host = topology.masses()
    if not np.allclose(masses_host, masses_host[0]):
        raise ValueError(
            "the culled runner permutes particle order and therefore "
            "requires identical masses"
        )
    kT, dt, gamma = _md_constants(temperature, timestep, collision_rate)
    gran = math.lcm(128, tm, tn)
    common_pad = gran * ((n_particles + gran - 1) // gran)
    md = CulledLJMD(
        n_particles, potential.sigma, potential.epsilon, potential.cutoff,
        masses_lane=np.asarray(masses_host, dtype=np.float32),
        dt=dt, gamma=gamma, kT=kT, tm=tm, tn=tn, slack=slack,
        n_pad=common_pad, device=device,
    )
    dense = LJDense(n_particles, potential.sigma, potential.epsilon,
                    potential.cutoff, tm=128, tn=128, n_pad=md.n_pad,
                    device=device)
    return md, dense


class CulledLJRunner:
    """Culled tile-pair LJ runner: the N~4000 production engine
    (``runtime.py:553-875``).  Sorting permutes particle identity, so
    ``positions(state)`` returns the internal order."""

    def __init__(self, md: CulledLJMD, dense: LJDense, segment_steps: int,
                 sort_mode: str, exact_forces: bool):
        self.md = md
        self.dense = dense
        self.segment_steps = segment_steps
        self.sort_mode = sort_mode
        self.exact_forces = exact_forces
        self.seed = None      # the noise seed, set by init()
        self.nslab = None     # resolved from the box in init()
        self.capacity = None  # resolved from the initial list in init()

    def init(self, positions, box_vectors, seed: int = 0) -> CullCarry:
        md = self.md
        self.seed = seed
        x3s, box_diag, self.nslab, self.capacity, pairs = _culled_layout_init(
            md, self.dense, positions, box_vectors, self.sort_mode, md.n,
        )
        gen = torch.Generator(device=md.device).manual_seed(seed)
        noise = torch.randn((3, md.n_pad), generator=gen, device=md.device)
        return CullCarry(
            x=x3s, v=md.sigv * noise,
            F=md.force(x3s, box_diag, pairs,
                       approx_recip=not self.exact_forces),
            step=torch.zeros((1, 1), dtype=torch.int32, device=md.device),
            box_diag=box_diag,
            overflowed=pairs.overflowed,
            pairs=pairs,
            x_anchor=x3s,
        )

    def _segment(self, carry: CullCarry, n_steps: int) -> CullCarry:
        md = self.md
        box_diag = carry.box_diag
        key = slab_y_key(carry.x, md.n, self.nslab, box_diag[0, 0],
                         Ly=box_diag[0, 1])
        xs, (v3, F3) = sort_by_key(key, carry.x, (carry.v, carry.F))
        pairs = md.build_pairs(xs, box_diag[0], self.capacity)
        x1, v1, F1, stale = md.run_segment(
            xs, v3, F3, box_diag, pairs, seed=self.seed,
            step_offset=carry.step, n_steps=n_steps,
            approx_recip=not self.exact_forces, drift_slack=md.slack,
        )
        return CullCarry(
            x=x1, v=v1, F=F1, step=carry.step + n_steps, box_diag=box_diag,
            overflowed=carry.overflowed | pairs.overflowed | stale,
            pairs=pairs, x_anchor=xs,
        )

    def run(self, state: CullCarry, n_steps: int) -> CullCarry:
        """Advance ``n_steps``: whole segments of ``segment_steps``, then
        one shorter segment for the remainder."""
        step = self.segment_fn(self.segment_steps)
        n_seg, rem = divmod(n_steps, self.segment_steps)
        for _ in range(n_seg):
            state = step(state)
        if rem:
            state = self.segment_fn(rem)(state)
        return state

    def segment_fn(self, n_steps: int):
        """``carry -> carry`` advancing one ``n_steps``-step segment (sort,
        list rebuild, S steps, latch): the body ``run`` iterates."""
        if self.capacity is None:
            raise RuntimeError("call init() before segment_fn()")
        return lambda carry: self._segment(carry, n_steps)

    def check(self, state: CullCarry):
        if bool(state.overflowed):
            raise RuntimeError(
                "culled runner invariant violated (pair-list capacity, "
                "shift bound, or per-segment drift) -- reduce "
                "segment_steps or increase slack and re-run"
            )

    def energy(self, state: CullCarry):
        return self.dense.force_energy_t(state.x, state.box_diag)[1]

    def positions(self, state: CullCarry):
        return self.dense.unpad(state.x)

    def velocities(self, state: CullCarry):
        return self.dense.unpad(state.v)


def make_culled_lj_runner(
    potential,
    n_particles: int,
    temperature=300.0 * units.kelvin,
    timestep=2.0 * units.femtoseconds,
    collision_rate=1.0 / units.picoseconds,
    topology=None,
    tm: int = 128,
    tn: int = 256,
    slack: float = 0.3,
    segment_steps: int = 50,
    sort_mode: str = "auto",
    exact_forces: bool = False,
    *,
    device,
) -> CulledLJRunner:
    """Culled tile-pair fused LJ runner on ``device``.

    Each segment re-sorts and rebuilds the list and checks the tile-skin
    invariant at its end: if the list could have gone stale,
    ``state.overflowed`` latches and ``check()`` raises.  ``sort_mode`` is
    ``"auto"`` (the pure-x key below 6.5 reaches of box, else the
    (x-slab, y) key), ``"x"`` or ``"slab"``; the noise seed is ``init``'s.
    """
    if sort_mode not in ("auto", "x", "slab"):
        raise ValueError(f"sort_mode {sort_mode!r}: use 'auto', 'x' or 'slab'")
    md, dense = _culled_engine_setup(
        potential, n_particles, temperature, timestep, collision_rate,
        topology, tm, tn, slack, device,
    )
    return CulledLJRunner(md, dense, segment_steps, sort_mode, exact_forces)
