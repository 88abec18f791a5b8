"""Runners of the LJ fluid in NVT and NpT (port of ``chiron_tpu/runtime.py``).

``make_lj_runner`` picks one of four NVT engines by size and box, as the JAX
package does: dense below N = 2048, culled up to 80,000, band above, and the
halo-strip engine when asked for by name.

``make_fast_lj_runner`` is the dense BAOAB runner (K1 every step) that
melts the lattice; ``make_culled_lj_runner`` is the production engine: a
segment sorts the state by the spatial key and rebuilds the tile-pair list
(every segment by default, at the ``sort_every``/``rebuild_every`` cadence
otherwise) and advances S steps on the culled kernels, with the drift latch
at its end.
``make_culled_npt_lj_runner`` adds a Monte Carlo barostat to the culled
engine (K5 energies on a rescaled list, the drift budget as device data);
``make_npt_lj_runner`` is its dense counterpart on K1.  ``run`` is a Python
loop of device work: only ``init`` and ``check`` wait for the device.
Every factory runs on the card unless the caller passes ``device="cpu"``,
where the kernels' plain versions run.

``make_band_lj_runner`` steps x-sorted state on the band force (K6) and
re-sorts when a particle has drifted past the margin, chosen on the device;
``make_strip_lj_runner`` re-sorts at every segment and steps on the
halo-strip kernels (K7).

``make_langevin_runner`` is the general API's runner: BAOAB on any
potential and pair scheme (``integrators.make_baoab_step_fn``), on K1 with
``DensePairs``.

The culled runner's two opt-in rebuild paths are ported: ``fused_rebuild``
(the sort and the list build in one launch, ``ops/sortbuild.py``) and
``megakernel`` (the build from the current order, the steps, the latch and
an order repair in one host call, ``ops/lj_mega.py``).  Not ported, since
they only choose how the TPU kernels are lowered: ``mxu_reduce``,
``prefetch``, ``unroll`` and the per-call ``interpret`` flag.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from . import units, utils
from .integrators import LangevinCarry, force_of, make_baoab_step_fn, run_chunk
from .neighbors import DensePairs, NeighborListNsqrd, PairListNsqrd
from .ops.lj_cull import (
    CulledLJMD,
    LatchScratch,
    SegmentWorkspace,
    TilePairList,
    build_tile_pairs,
    live_nonfinite,
    slab_y_key,
    sort_by_key,
    tile_frame_scale_floor,
    tile_skin_drift_bad,
)
from .ops.lj_band import LJBand, band_width_needed, sort_by_x
from .ops.lj_dense import LJDense, box_diagonal
from .ops.lj_mega import MegaWorkspace, check_mega_tiles, mega_segment
from .ops.lj_strip import _PAD_X, StripLJMD, sort_by_key_strip, strip_wrap
from .ops.sortbuild import MAX_N_PAD, sort_build
from .profiling import span, spanned


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

    def _baoa(self, x, v, F, box_diag, noise):
        """B, A, O and A of one BAOAB step, then the wrap: the new (x, v)
        that the step's force is taken at."""
        half = self.dt * 0.5
        v = v + half * F / self.m_lane
        x = x + half * v
        v = self.a * v + self.b * self.sigma_v_lane * noise
        x = x + half * v
        Lcol = box_diag.reshape(3, 1)
        return x - torch.floor(x / Lcol) * Lcol, v

    def _kick(self, v, F):
        """The closing B half-kick."""
        return v + (self.dt * 0.5) * F / self.m_lane

    def step(self, state: LangevinCarry, noise) -> LangevinCarry:
        """One BAOAB step with the given (3, n_pad) standard-normal noise."""
        box = state.box_vectors
        x, v = self._baoa(state.x, state.v, state.F, box, noise)
        F = self._force(x, box)
        return LangevinCarry(x=x, v=self._kick(v, F), F=F, box_vectors=box,
                             overflowed=state.overflowed,
                             generator=state.generator)

    def run(self, state, n_steps: int):
        """``n_steps`` steps, the O-step noise drawn from the state's
        generator."""
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
    device="cuda",
) -> FastLJRunner:
    """Dense LJ Langevin runner on ``device`` (the card unless the caller
    asks for the CPU, where the kernels' plain versions run).

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

    ``step_host`` is ``step`` as a host int, which the list cadence reads.
    It is not a field, so a checkpoint holds the fields of JAX's carry and
    nothing else.  ``init``, every segment and ``interop.cull_carry`` note
    it beside the ``step`` tensor they make, and reading it then waits for
    nothing; a carry made another way, or whose ``step`` has been replaced
    or changed in place since, reads ``step`` from its device once.
    """

    x: torch.Tensor           # (3, n_pad)
    v: torch.Tensor           # (3, n_pad)
    F: torch.Tensor           # (3, n_pad)
    step: torch.Tensor        # (1, 1) int32 cumulative step count
    box_diag: torch.Tensor    # (1, 3)
    overflowed: torch.Tensor  # () bool: capacity/shift/drift violation
    pairs: TilePairList
    x_anchor: torch.Tensor    # (3, n_pad)

    def _step_version(self):
        # an inference tensor keeps no version counter
        return None if self.step.is_inference() else self.step._version

    def note_step(self, step_host: int) -> "CullCarry":
        """Note ``step_host`` as the host's copy of ``step``; returns self."""
        self._noted = (self.step, self._step_version(), int(step_host))
        return self

    @property
    def step_host(self) -> int:
        noted = self.__dict__.get("_noted")
        if (noted is not None and noted[0] is self.step
                and noted[1] == self._step_version()):
            return noted[2]
        with span("chiron.sync.step"):
            return int(self.step.reshape(-1)[0])


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


def _uniform_masses(topology, engine: str) -> np.ndarray:
    """The masses, which an engine that sorts particles needs identical."""
    masses = np.asarray(topology.masses())
    if not np.allclose(masses, masses[0]):
        raise ValueError(
            f"the {engine} runner permutes particle order and therefore "
            "requires identical masses"
        )
    return masses


def _culled_engine_setup(potential, n_particles, temperature, timestep,
                         collision_rate, topology, tm, tn, slack, device):
    """The CulledLJMD engine and the dense energy op on a common padding
    (``runtime.py:510-550``).  Returns (md, dense)."""
    if topology is None:
        topology = potential.topology
    masses_host = _uniform_masses(topology, "culled")
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


class _CulledRunner:
    """What both culled runners share: the engine, the layout that ``init``
    resolves, and the head of every segment (the non-finite check, the sort
    and the list rebuild).  Sorting permutes particle identity, so
    ``positions(state)`` returns the internal order."""

    _INVARIANT = "culled runner invariant violated"

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
        self._segment_ws = None  # K3's segment scratch on the card

    def _start(self, positions, box_vectors, seed: int):
        """The start of ``init``: resolve the layout, sort, build the list
        and draw the velocities.  Returns (x3s, box_diag, pairs, generator,
        v3)."""
        md = self.md
        self.seed = seed
        x3s, box_diag, self.nslab, self.capacity, pairs = _culled_layout_init(
            md, self.dense, positions, box_vectors, self.sort_mode, md.n,
        )
        gen = torch.Generator(device=md.device).manual_seed(seed)
        v3 = md.sigv * torch.randn((3, md.n_pad), generator=gen,
                                   device=md.device)
        return x3s, box_diag, pairs, gen, v3

    def _sort(self, carry):
        """Sort (x, v, F) by the spatial key.  Returns (xs, v, F,
        overflowed), where ``overflowed`` adds a non-finite live coordinate
        to the carry's."""
        if self.capacity is None:
            raise RuntimeError("call init() before running a segment")
        box_diag = carry.box_diag
        # before the sort, which may move a NaN key out of the live lanes
        nonfinite = live_nonfinite(carry.x, self.md.n)
        key = slab_y_key(carry.x, self.md.n, self.nslab, box_diag[0, 0],
                         Ly=box_diag[0, 1])
        xs, (v3, F3) = sort_by_key(key, carry.x, (carry.v, carry.F))
        return xs, v3, F3, carry.overflowed | nonfinite

    def _resort(self, carry):
        """The head of a segment: sort, then rebuild the list.  Returns (xs,
        v, F, pairs, overflowed), the rebuild's overflow added."""
        xs, v3, F3, overflowed = self._sort(carry)
        pairs = self.md.build_pairs(xs, carry.box_diag[0], self.capacity)
        return xs, v3, F3, pairs, overflowed | pairs.overflowed

    def _segment_workspace(self, kind=SegmentWorkspace):
        """The segments' scratch on the card (K3's, or K11's with
        ``kind=MegaWorkspace``) for the current capacity, made once (None on
        the CPU)."""
        md = self.md
        if md.device.type != "cuda":
            return None
        ws = self._segment_ws
        if not isinstance(ws, kind) or ws.capacity != self.capacity:
            ws = self._segment_ws = kind(md, self.capacity)
        return ws

    def check(self, state):
        with span("chiron.sync.latch"):
            overflowed = bool(state.overflowed)
        if overflowed:
            raise RuntimeError(
                f"{self._INVARIANT} -- reduce segment_steps or increase "
                "slack and re-run"
            )

    def positions(self, state):
        return self.dense.unpad(state.x)

    def velocities(self, state):
        return self.dense.unpad(state.v)


class CulledLJRunner(_CulledRunner):
    """Culled tile-pair LJ runner: the N~4000 production engine
    (``runtime.py:553-875``).

    ``path`` names how a segment rebuilds: ``"default"`` (the torch sort and
    ``build_tile_pairs``, at the ``sort_every``/``rebuild_every`` cadence),
    ``"fused_rebuild"`` (K10) or ``"megakernel"`` (K11, with
    ``repair_passes``)."""

    _INVARIANT = ("culled runner invariant violated (pair-list capacity, "
                  "shift bound, or per-segment drift)")

    def __init__(self, md: CulledLJMD, dense: LJDense, segment_steps: int,
                 sort_mode: str, exact_forces: bool, path: str = "default",
                 repair_passes: int = 16, sort_every: int = 1,
                 rebuild_every: int = 1):
        super().__init__(md, dense, segment_steps, sort_mode, exact_forces)
        self.path = path
        self.repair_passes = repair_passes
        self.sort_every = sort_every
        self.rebuild_every = rebuild_every

    def init(self, positions, box_vectors, seed: int = 0) -> CullCarry:
        md = self.md
        x3s, box_diag, pairs, _, v3 = self._start(positions, box_vectors,
                                                  seed)
        return CullCarry(
            x=x3s, v=v3,
            F=md.force(x3s, box_diag, pairs,
                       approx_recip=not self.exact_forces),
            step=torch.zeros((1, 1), dtype=torch.int32, device=md.device),
            box_diag=box_diag,
            overflowed=pairs.overflowed,
            pairs=pairs,
            x_anchor=x3s,
        ).note_step(0)

    def cadence(self, step: int):
        """(sort, rebuild): what the segment that starts at ``step`` does on
        the default path (``runtime.py:735-747``).  The segment index counts
        whole ``segment_steps``, so a shorter remainder segment shifts the
        phase, as in the JAX package."""
        seg_i = step // self.segment_steps
        do_sort = seg_i % (self.rebuild_every * self.sort_every) == 0
        return do_sort, do_sort or seg_i % self.rebuild_every == 0

    @spanned("chiron.segment")
    def _segment(self, carry: CullCarry, n_steps: int) -> CullCarry:
        if self.path == "megakernel":
            return self._mega_segment(carry, n_steps)
        md = self.md
        # the cadence is decided on the host's copy of the step: no sync
        step_host = carry.step_host
        if self.path == "fused_rebuild":
            # before the sort, which may move a NaN key out of the live lanes
            nonfinite = live_nonfinite(carry.x, md.n)
            xs, v3, F3, pairs = sort_build(
                carry.x, carry.v, carry.F, carry.box_diag[0], md.n, md.tm,
                md.tn, self.nslab, md.cutoff, md.slack, self.capacity)
            overflowed = carry.overflowed | nonfinite | pairs.overflowed
            anchor = xs
        else:
            do_sort, do_rebuild = self.cadence(step_host)
            if do_sort:
                with span("chiron.sort"):
                    xs, v3, F3, overflowed = self._sort(carry)
            else:
                xs, v3, F3, overflowed = (carry.x, carry.v, carry.F,
                                          carry.overflowed)
            if do_rebuild:
                with span("chiron.build"):
                    pairs = md.build_pairs(xs, carry.box_diag[0],
                                           self.capacity)
                anchor = xs
            else:
                pairs, anchor = carry.pairs, carry.x_anchor
            overflowed = overflowed | pairs.overflowed
        # the latch: the top-2 joint drift from the list's anchor against the
        # slack, in K3's last launch.  With a rebuild every segment the anchor
        # is the segment's entry; with rebuild_every > 1 it may be segments
        # old, where the JAX package checks in XLA (runtime.py:800-810)
        x1, v1, F1, stale = md.run_segment(
            xs, v3, F3, carry.box_diag, pairs, seed=self.seed,
            step_offset=carry.step, n_steps=n_steps,
            approx_recip=not self.exact_forces, drift_anchor=anchor,
            drift_budget=md.slack_t, workspace=self._segment_workspace(),
        )
        return CullCarry(
            x=x1, v=v1, F=F1, step=carry.step + n_steps,
            box_diag=carry.box_diag, overflowed=overflowed | stale,
            pairs=pairs, x_anchor=anchor,
        ).note_step(step_host + n_steps)

    def _mega_segment(self, carry: CullCarry, n_steps: int) -> CullCarry:
        """A megakernel segment (``runtime.py:658-699``): the list and the
        anchor of the carry pass through unchanged."""
        md = self.md
        if self.nslab != 0:
            raise ValueError(
                "megakernel supports the pure-x sort regime only (nslab == "
                "0); use sort_mode='x' or the default path for slab-key "
                "workloads")
        half_dt = 0.5 * md.dt
        w = carry.v - half_dt * carry.F * md.minv
        x1, w1, F1, flag = mega_segment(
            md, carry.x, w, carry.F, carry.box_diag, self.capacity,
            self.seed, carry.step, n_steps, self.repair_passes,
            approx_recip=not self.exact_forces,
            workspace=self._segment_workspace(MegaWorkspace))
        return CullCarry(
            x=x1, v=w1 + half_dt * F1 * md.minv, F=F1,
            step=carry.step + n_steps, box_diag=carry.box_diag,
            overflowed=carry.overflowed | flag, pairs=carry.pairs,
            x_anchor=carry.x_anchor,
        ).note_step(carry.step_host + n_steps)

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
        """``carry -> carry`` advancing one ``n_steps``-step segment (sort
        and list rebuild where due, S steps, latch): the body ``run``
        iterates."""
        if self.capacity is None:
            raise RuntimeError("call init() before segment_fn()")
        return lambda carry: self._segment(carry, n_steps)

    def energy(self, state: CullCarry):
        return self.dense.force_energy_t(state.x, state.box_diag)[1]


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
    sort_every: int = 1,
    rebuild_every: int = 1,
    fused_rebuild: bool = False,
    megakernel: bool = False,
    repair_passes: int = 16,
    *,
    device="cuda",
) -> CulledLJRunner:
    """Culled tile-pair fused LJ runner on ``device`` (the card by default).

    The list is rebuilt every ``rebuild_every`` segments and the state
    re-sorted by the spatial key every ``sort_every`` rebuilds (both 1 by
    default, as in the JAX package); the cadence is decided on the host.
    Every segment checks the tile-skin invariant at its end, the top-2
    joint drift from the positions the list was built from against the
    slack: if the list could have gone stale, ``state.overflowed`` latches
    and ``check()`` raises.  The capacity is fixed at ``init``, so the
    fatter boxes of an unsorted rebuild may overflow it, which latches too.
    ``sort_mode`` is ``"auto"`` (the pure-x key below 6.5 reaches of box,
    else the (x-slab, y) key), ``"x"`` or ``"slab"``; the noise seed is
    ``init``'s.

    ``fused_rebuild`` sorts and builds in one launch (K10) where n_pad is a
    power of two and both tiles are multiples of 128, as in the reference;
    elsewhere the default path runs.  ``megakernel`` (pure-x key only, tiles
    in multiples of 128) builds the list from the current order, runs the
    steps and the latch, and repairs the order with ``repair_passes``
    odd-even passes instead of re-sorting (K11); it carries the list and
    anchor of ``init`` through unchanged.  Both refuse a cadence above 1,
    as in the reference.  ``runner.path`` names the path taken.
    """
    if sort_mode not in ("auto", "x", "slab"):
        raise ValueError(f"sort_mode {sort_mode!r}: use 'auto', 'x' or 'slab'")
    if sort_every < 1 or rebuild_every < 1:
        raise ValueError(
            f"sort_every and rebuild_every count segments: both >= 1 (got "
            f"{sort_every}, {rebuild_every})")
    cadence = sort_every != 1 or rebuild_every != 1
    if megakernel and (fused_rebuild or cadence):
        raise ValueError(
            "megakernel rebuilds/repairs every segment; cadence knobs and "
            "fused_rebuild do not apply")
    md, dense = _culled_engine_setup(
        potential, n_particles, temperature, timestep, collision_rate,
        topology, tm, tn, slack, device,
    )
    n_pad = md.n_pad
    path = "default"
    if megakernel:
        check_mega_tiles(n_pad, md.tm, md.tn)
        path = "megakernel"
    elif fused_rebuild and ((n_pad & (n_pad - 1)) == 0 and md.tm % 128 == 0
                            and md.tn % 128 == 0):
        if n_pad > MAX_N_PAD:
            raise ValueError(
                f"fused_rebuild sorts in one block's shared memory, up to "
                f"n_pad={MAX_N_PAD} (got {n_pad}); use the default sort/build "
                f"path")
        if cadence:
            raise ValueError(
                "fused_rebuild sorts and rebuilds every segment; "
                "sort_every/rebuild_every must stay 1 with it")
        path = "fused_rebuild"
    return CulledLJRunner(md, dense, segment_steps, sort_mode, exact_forces,
                          path, repair_passes, sort_every, rebuild_every)


# ---------------------------------------------------------------------------
# NpT: the Monte Carlo barostat of both NpT runners (runtime.py:884-925)
# ---------------------------------------------------------------------------


def _npt_draws(generator, device, u_prop=None, u_acc=None):
    """An attempt's two uniforms as 0-dim f32 device tensors: the volume
    draw in [-1, 1) and the acceptance draw, floored at 1e-38.  Both come
    from ``generator`` (one launch) unless both are given, as the tests
    give the JAX package's own draws."""
    if u_prop is None or u_acc is None:
        u = torch.rand(2, generator=generator, device=device)
        return 2.0 * u[0] - 1.0, torch.clamp_min(u[1], 1e-38)
    f32 = dict(dtype=torch.float32, device=device)
    return torch.as_tensor(u_prop, **f32), torch.as_tensor(u_acc, **f32)


def _npt_volume_proposal(box_diag, vmax_scale, u_prop):
    """Isotropic volume proposal (reference mcmc.py:950-983): dV = u vmax V,
    positions and box scaled by (V'/V)^(1/3).  Returns (V, V_new, s)."""
    V = torch.prod(box_diag)
    V_new = V + u_prop * vmax_scale * V
    return V, V_new, torch.pow(V_new / V, 1.0 / 3.0)


def _npt_accept(beta, P_md, n, U, U_new, V, V_new, box_ok, u_acc):
    """McDonald-1972 NpT acceptance (reference mcmc.py:995-1000) with NaN
    rejection (mcmc.py:428) and box-validity rejection: () bool."""
    log_ratio = (-beta * ((U_new - U) + P_md * (V_new - V))
                 + n * torch.log(V_new / V))
    log_ratio = torch.where(torch.isnan(U_new) | ~box_ok, -math.inf,
                            log_ratio)
    return torch.log(u_acc) < log_ratio


def _npt_autotune(vmax, n_acc, n_prop, interval: int, cap: float = 0.3):
    """Reference barostat autotune (mcmc.py:902-911): /1.1 below 25%
    cumulative acceptance, x1.1 above 75%, capped at ``cap``.  As in the
    JAX package the cap binds only on the increase branch."""
    due = (n_prop % interval) == 0
    ratio = n_acc.to(torch.float32) / torch.clamp_min(n_prop, 1)
    vmax = torch.where(due & (ratio < 0.25), vmax / 1.1, vmax)
    return torch.where(due & (ratio > 0.75),
                       torch.clamp_max(vmax * 1.1, cap), vmax)


def _scalar(value, dtype, device):
    return torch.tensor(value, dtype=dtype, device=device)


@dataclass
class CullNPTCarry:
    """State of the culled NpT runner: the culled NVT state plus the
    barostat's generator, statistics and the slack budget spent by volume
    scalings since the last rebuild."""

    x: torch.Tensor            # (3, n_pad)
    v: torch.Tensor            # (3, n_pad)
    F: torch.Tensor            # (3, n_pad)
    U: torch.Tensor            # () f32 exact potential of x (carried)
    step: torch.Tensor         # (1, 1) int32 cumulative MD steps
    box_diag: torch.Tensor     # (1, 3)
    overflowed: torch.Tensor   # () bool
    pairs: TilePairList
    x_anchor: torch.Tensor     # (3, n_pad) rebuild positions, rescaled
    scale_used: torch.Tensor   # () f32 slack spent by ACCEPTED scalings
    eval_peak: torch.Tensor    # () f32 worst slack any box-valid proposal
    #                            EVALUATION needed, accepted or not
    s_total: torch.Tensor      # () f32 cumulative box scale since rebuild
    s_min_frame: torch.Tensor  # () f32 x-frame floor on s_total
    generator: torch.Generator  # barostat draws (the JAX carry's key)
    vmax_scale: torch.Tensor   # () f32 max relative volume change
    n_accepted: torch.Tensor   # () int32
    n_proposed: torch.Tensor   # () int32


class CulledNPTRunner(_CulledRunner):
    """NpT on the culled engine (``runtime.py:970-1288``): BAOAB
    sub-segments of ``barostat_interval`` steps with one isotropic volume
    attempt before each, ``segment_steps`` between list rebuilds.

    A proposal rescales the live list (``ccx``, ``rowcx`` times ``s``)
    instead of rebuilding it and charges ``|1 - s| (cutoff + slack)`` of
    the slack; the drift latch of each sub-segment then checks the top-2
    drift from the rescaled rebuild positions against the slack left.  Its
    energies come from K5 (exact reciprocal); the current configuration's
    U is carried, refreshed by each sub-segment's last force pass.  Between
    ``init`` and ``check`` nothing waits for the device.
    """

    _INVARIANT = ("culled NpT runner invariant violated (pair-list "
                  "capacity, shift bound, or drift+scale budget)")

    def __init__(self, md: CulledLJMD, dense: LJDense, segment_steps: int,
                 barostat_interval: int, sort_mode: str, exact_forces: bool,
                 beta: float, P_md: float, volume_max_scale: float,
                 autotune: bool, autotune_interval: int):
        super().__init__(md, dense, segment_steps, sort_mode, exact_forces)
        self.barostat_interval = barostat_interval
        self.n_sub = segment_steps // barostat_interval
        self.beta, self.P_md = beta, P_md
        self.volume_max_scale = volume_max_scale
        self.autotune, self.autotune_interval = autotune, autotune_interval
        self.reach = md.cutoff + md.slack
        # every evaluated box-valid shrink charges |1-s| reach, so the n_sub
        # attempts of a segment must fit in HALF the slack (the other half
        # is the thermal drift's); vmax is a proposal parameter, so the cap
        # leaves detailed balance intact (runtime.py:1044-1055)
        charge_cap = 0.5 * md.slack / self.n_sub
        s_min_attempt = max(1e-3, 1.0 - charge_cap / self.reach)
        self.vmax_cap = min(0.3, 1.0 - s_min_attempt ** 3)

    def init(self, positions, box_vectors, seed: int = 0) -> CullNPTCarry:
        md = self.md
        dev = md.device
        x3s, box_diag, pairs, gen, v3 = self._start(positions, box_vectors,
                                                    seed)
        # one exact pass gives the carried energy and the first force
        F3, U0 = md.force_energy(x3s, box_diag, pairs)
        vmax = self.volume_max_scale
        if self.autotune:  # the engine owns vmax: start inside the envelope
            vmax = min(vmax, self.vmax_cap)
        f32, i32 = torch.float32, torch.int32
        return CullNPTCarry(
            x=x3s, v=v3, F=F3, U=U0,
            step=torch.zeros((1, 1), dtype=i32, device=dev),
            box_diag=box_diag, overflowed=pairs.overflowed, pairs=pairs,
            x_anchor=x3s,
            scale_used=_scalar(0.0, f32, dev),
            eval_peak=_scalar(0.0, f32, dev),
            s_total=_scalar(1.0, f32, dev),
            s_min_frame=tile_frame_scale_floor(
                x3s, md.n, md.tm, md.tn, box_diag, md.cutoff, md.slack),
            generator=gen,
            vmax_scale=_scalar(vmax, f32, dev),
            n_accepted=_scalar(0, i32, dev),
            n_proposed=_scalar(0, i32, dev),
        )

    def _barostat_attempt(self, carry: CullNPTCarry, u_prop=None,
                          u_acc=None) -> CullNPTCarry:
        """One volume attempt; the two uniforms may be given."""
        md = self.md
        u_prop, u_acc = _npt_draws(carry.generator, md.device, u_prop, u_acc)
        box = carry.box_diag
        V, V_new, s = _npt_volume_proposal(box, carry.vmax_scale, u_prop)
        x_new = carry.x * s
        box_new = box * s
        pairs = carry.pairs
        pairs_new = pairs._replace(ccx=pairs.ccx * s, rowcx=pairs.rowcx * s)
        F_new, U_new = md.force_energy(x_new, box_new, pairs_new)
        # the minimum image as the box shrinks, and the x-frame floor of
        # the layout built at the last rebuild
        s_total_new = carry.s_total * s
        box_ok = (((0.5 * torch.min(box_new) - md.cutoff - md.slack) > 0.0)
                  & (s_total_new >= carry.s_min_frame))
        accept = _npt_accept(self.beta, self.P_md, md.n, carry.U, U_new, V,
                             V_new, box_ok, u_acc)

        def sel(a, b):
            return torch.where(accept, a, b)

        # a shrink moves pairs beyond reach inward by at most |1-s| reach;
        # the decision read U_new off the rescaled list, so a rejected
        # box-valid shrink charges the latch budget too (runtime.py:1146)
        charge = torch.clamp_min(1.0 - s, 0.0) * self.reach
        eval_peak = torch.maximum(
            carry.eval_peak,
            torch.where(box_ok, carry.scale_used + charge, carry.scale_used),
        )
        n_acc = carry.n_accepted + accept.to(torch.int32)
        n_prop = carry.n_proposed + 1
        vmax = carry.vmax_scale
        if self.autotune:
            vmax = _npt_autotune(vmax, n_acc, n_prop, self.autotune_interval,
                                 cap=self.vmax_cap)
        return replace(
            carry,
            x=sel(x_new, carry.x), F=sel(F_new, carry.F), U=sel(U_new, carry.U),
            box_diag=sel(box_new, box),
            pairs=pairs._replace(ccx=sel(pairs_new.ccx, pairs.ccx),
                                 rowcx=sel(pairs_new.rowcx, pairs.rowcx)),
            x_anchor=sel(carry.x_anchor * s, carry.x_anchor),
            scale_used=carry.scale_used + torch.where(accept, charge, 0.0),
            eval_peak=eval_peak,
            s_total=sel(s_total_new, carry.s_total),
            vmax_scale=vmax, n_accepted=n_acc, n_proposed=n_prop,
        )

    def segment(self, carry: CullNPTCarry, draws=None) -> CullNPTCarry:
        """One segment: sort, rebuild, floor, then ``n_sub`` rounds of an
        attempt and a sub-segment.  ``draws`` may give each attempt's
        (u_prop, u_acc)."""
        md = self.md
        xs, v3, F3, pairs, overflowed = self._resort(carry)
        zero = torch.zeros((), dtype=torch.float32, device=md.device)
        carry = replace(
            carry, x=xs, v=v3, F=F3, overflowed=overflowed, pairs=pairs,
            x_anchor=xs, scale_used=zero, eval_peak=zero, s_total=zero + 1.0,
            s_min_frame=tile_frame_scale_floor(
                xs, md.n, md.tm, md.tn, carry.box_diag, md.cutoff, md.slack),
        )
        for k in range(self.n_sub):
            carry = self._barostat_attempt(
                carry, *(draws[k] if draws is not None else ()))
            x1, v1, F1, stale, U1 = md.run_segment(
                carry.x, carry.v, carry.F, carry.box_diag, carry.pairs,
                seed=self.seed, step_offset=carry.step,
                n_steps=self.barostat_interval,
                approx_recip=not self.exact_forces,
                final_energy=True, drift_anchor=carry.x_anchor,
                # against the WORST evaluated scaling, not just the accepted
                drift_budget=md.slack - carry.eval_peak,
                workspace=self._segment_workspace(),
            )
            carry = replace(carry, x=x1, v=v1, F=F1, U=U1,
                            overflowed=carry.overflowed | stale,
                            step=carry.step + self.barostat_interval)
        return carry

    def run(self, state: CullNPTCarry, n_steps: int) -> CullNPTCarry:
        if n_steps % self.segment_steps != 0:
            raise ValueError(
                f"n_steps must be a multiple of segment_steps "
                f"({self.segment_steps})"
            )
        for _ in range(n_steps // self.segment_steps):
            state = self.segment(state)
        return state

    def volume(self, state: CullNPTCarry):
        return torch.prod(state.box_diag)

    def acceptance(self, state: CullNPTCarry) -> float:
        prop = int(state.n_proposed)
        return int(state.n_accepted) / prop if prop else 0.0

    def energy(self, state: CullNPTCarry):
        return self.md.force_energy(state.x, state.box_diag, state.pairs)[1]


def make_culled_npt_lj_runner(
    potential,
    n_particles: int,
    temperature=300.0 * units.kelvin,
    pressure=1.0 * units.atmosphere,
    timestep=2.0 * units.femtoseconds,
    collision_rate=1.0 / units.picoseconds,
    topology=None,
    tm: int = 128,
    tn: int = 256,
    slack: float = 0.2,
    segment_steps: int = 50,
    barostat_interval: int = 25,
    volume_max_scale: float = 0.01,
    autotune: bool = True,
    autotune_interval: int = 20,
    sort_mode: str = "auto",
    exact_forces: bool = False,
    *,
    device="cuda",
) -> CulledNPTRunner:
    """NpT on the culled tile-pair engine, on ``device`` (the card by
    default): Langevin BAOAB with a McDonald-1972 Monte Carlo barostat
    attempt every ``barostat_interval`` steps (reference chiron/mcmc.py:
    985-1000, autotune :902-911).  ``segment_steps`` must be a multiple of
    ``barostat_interval`` and ``run``'s step count of ``segment_steps``.
    Volume moves leave velocities untouched.
    """
    if segment_steps % barostat_interval != 0:
        raise ValueError("segment_steps must be a multiple of barostat_interval")
    if sort_mode not in ("auto", "x", "slab"):
        raise ValueError(f"sort_mode {sort_mode!r}: use 'auto', 'x' or 'slab'")
    md, dense = _culled_engine_setup(
        potential, n_particles, temperature, timestep, collision_rate,
        topology, tm, tn, slack, device,
    )
    return CulledNPTRunner(
        md, dense, segment_steps, barostat_interval, sort_mode, exact_forces,
        beta=1.0 / md.kT, P_md=units.pressure_to_md(pressure),
        volume_max_scale=volume_max_scale, autotune=autotune,
        autotune_interval=autotune_interval,
    )


@dataclass
class NPTCarry:
    """State of the dense NpT runner (lane layout)."""

    x: torch.Tensor            # (3, n_pad)
    v: torch.Tensor            # (3, n_pad)
    F: torch.Tensor            # (3, n_pad)
    U: torch.Tensor            # () f32 potential of x, fresh ONLY on steps
    #                            that feed a barostat attempt
    generator: torch.Generator  # noise and barostat draws (the JAX key)
    box_diag: torch.Tensor     # (1, 3)
    vmax_scale: torch.Tensor   # () f32 max relative volume change
    n_accepted: torch.Tensor   # () int32
    n_proposed: torch.Tensor   # () int32
    step: int                  # cumulative MD steps, known on the host


class NPTRunner(FastLJRunner):
    """Dense NpT on K1 (``runtime.py:1624-1814``): the dense runner's BAOAB
    step and a volume attempt every ``barostat_interval`` steps.  The steps
    that feed an attempt take the exact force and energy; the others the
    force alone, with the approximate reciprocal unless ``exact_forces``.
    The step count is a host integer, so that choice costs no device
    sync."""

    def __init__(self, op: LJDense, masses_1d, kT: float, dt: float,
                 gamma: float, P_md: float, barostat_interval: int,
                 volume_max_scale: float, autotune: bool,
                 autotune_interval: int, exact_forces: bool):
        super().__init__(op, masses_1d, kT, dt, gamma, exact_forces)
        self.beta, self.P_md = 1.0 / kT, P_md
        self.barostat_interval = barostat_interval
        self.volume_max_scale = volume_max_scale
        self.autotune, self.autotune_interval = autotune, autotune_interval

    def init(self, positions, box_vectors, seed: int = 0) -> NPTCarry:
        op = self.op
        dev = op.device
        x3 = op.pad_positions(positions)
        box_diag = box_diagonal(box_vectors, dev)
        if float(box_diag.min()) <= 2.0 * op.cutoff:
            raise ValueError(
                "NpT runner requires min(box) > 2*cutoff for minimum-image "
                "validity; shrink the cutoff or use a larger box"
            )
        gen = torch.Generator(device=dev).manual_seed(seed)
        v3 = self.sigma_v_lane * torch.randn((3, self.n_pad), generator=gen,
                                             device=dev)
        F3, U0 = op.force_energy_t(x3, box_diag)
        return NPTCarry(
            x=x3, v=v3, F=F3, U=U0, generator=gen, box_diag=box_diag,
            vmax_scale=_scalar(self.volume_max_scale, torch.float32, dev),
            n_accepted=_scalar(0, torch.int32, dev),
            n_proposed=_scalar(0, torch.int32, dev), step=0,
        )

    def _barostat_attempt(self, carry: NPTCarry, u_prop=None,
                          u_acc=None) -> NPTCarry:
        op = self.op
        u_prop, u_acc = _npt_draws(carry.generator, op.device, u_prop, u_acc)
        V, V_new, s = _npt_volume_proposal(carry.box_diag, carry.vmax_scale,
                                           u_prop)
        x_new = carry.x * s
        box_new = carry.box_diag * s
        # carry.U is fresh: the step that scheduled this attempt took it
        F_new, U_new = op.force_energy_t(x_new, box_new)
        box_ok = torch.min(box_new) > 2.0 * op.cutoff
        accept = _npt_accept(self.beta, self.P_md, op.n, carry.U, U_new, V,
                             V_new, box_ok, u_acc)
        n_acc = carry.n_accepted + accept.to(torch.int32)
        n_prop = carry.n_proposed + 1
        vmax = carry.vmax_scale
        if self.autotune:
            vmax = _npt_autotune(vmax, n_acc, n_prop, self.autotune_interval)
        return replace(
            carry,
            x=torch.where(accept, x_new, carry.x),
            F=torch.where(accept, F_new, carry.F),
            U=torch.where(accept, U_new, carry.U),
            box_diag=torch.where(accept, box_new, carry.box_diag),
            vmax_scale=vmax, n_accepted=n_acc, n_proposed=n_prop,
        )

    def step(self, carry: NPTCarry, noise, u_prop=None, u_acc=None) -> NPTCarry:
        """One BAOAB step with the given (3, n_pad) standard-normal noise,
        then the attempt when the step closes an interval (its draws may
        be given)."""
        box = carry.box_diag
        x, v = self._baoa(carry.x, carry.v, carry.F, box, noise)
        step = carry.step + 1
        attempt = step % self.barostat_interval == 0
        if attempt:
            F, U = self.op.force_energy_t(x, box)
        else:
            F, U = self._force(x, box), carry.U
        carry = replace(carry, x=x, v=self._kick(v, F), F=F, U=U, step=step)
        if attempt:
            carry = self._barostat_attempt(carry, u_prop, u_acc)
        return carry

    def check(self, state: NPTCarry):
        """Raise if the state went non-finite: a NaN blow-up otherwise
        freezes the barostat silently (every proposal is rejected)."""
        ok = bool(torch.isfinite(state.U) & torch.isfinite(state.x).all()
                  & torch.isfinite(state.v).all())
        if not ok:
            raise RuntimeError(
                "dense NpT runner state is non-finite (diverged MD; the "
                "barostat has been rejecting every proposal) -- reduce the "
                "timestep and re-run"
            )

    def volume(self, state: NPTCarry):
        return torch.prod(state.box_diag)

    def acceptance(self, state: NPTCarry) -> float:
        prop = int(state.n_proposed)
        return int(state.n_accepted) / prop if prop else 0.0

    def energy(self, state: NPTCarry):
        return self.op.force_energy_t(state.x, state.box_diag)[1]


def make_npt_lj_runner(
    potential,
    n_particles: int,
    temperature=300.0 * units.kelvin,
    pressure=1.0 * units.atmosphere,
    timestep=2.0 * units.femtoseconds,
    collision_rate=1.0 / units.picoseconds,
    topology=None,
    tm: int = 512,
    barostat_interval: int = 25,
    volume_max_scale: float = 0.01,
    autotune: bool = True,
    autotune_interval: int = 20,
    exact_forces: bool = False,
    *,
    device="cuda",
) -> NPTRunner:
    """Dense NpT runner on ``device`` (the card by default): BAOAB with an
    isotropic McDonald-1972 volume attempt every ``barostat_interval``
    steps and the reference autotune rule (cap 0.3).  Dense-engine domain
    (N up to ~8k); volume moves leave velocities untouched."""
    if topology is None:
        topology = potential.topology
    kT, dt, gamma = _md_constants(temperature, timestep, collision_rate)
    op = LJDense(n_particles, potential.sigma, potential.epsilon,
                 potential.cutoff, tm=tm, tn=tm, device=device)
    return NPTRunner(op, topology.masses(), kT, dt, gamma,
                     units.pressure_to_md(pressure), barostat_interval,
                     volume_max_scale, autotune, autotune_interval,
                     exact_forces)


# ---------------------------------------------------------------------------
# The band engine (K6) and the halo-strip engine (K7)
# ---------------------------------------------------------------------------


@dataclass
class BandCarry:
    """State of the band runner in the x-sorted (3, n_pad) layout."""

    x: torch.Tensor           # (3, n_pad)
    v: torch.Tensor           # (3, n_pad)
    F: torch.Tensor           # (3, n_pad)
    ref_x: torch.Tensor       # (n_pad,) x at the last sort
    box_diag: torch.Tensor    # (1, 3)
    overflowed: torch.Tensor  # () bool: the band width outgrew w
    generator: torch.Generator  # O-step noise (the JAX carry's key)


class BandRunner(FastLJRunner):
    """Banded LJ Langevin runner for large N (``runtime.py:208-362``): the
    dense runner's BAOAB step and ``run`` loop on the band force (K6), with
    ``dense`` kept for ``energy`` and the padding helpers.

    Each step re-sorts the whole state when some live particle's cyclic x
    drift since the last sort has reached ``margin``: the JAX ``lax.cond``
    as a choice on the device.  Sorting permutes particle identity:
    ``positions(state)`` returns the internal order.
    """

    def __init__(self, band: LJBand, dense: LJDense, mass: float, kT: float,
                 dt: float, gamma: float):
        super().__init__(dense, np.full(band.n, mass), kT, dt, gamma,
                         exact_forces=False)
        self.band, self.dense = band, dense
        # every lane, padding included, takes the one mass and sigma_v, as
        # in JAX: the padding lanes drift and take noise like live ones
        self.m_lane = torch.full_like(self.m_lane, mass)
        self.sigma_v_lane = torch.full_like(
            self.m_lane, float(np.float32(np.sqrt(kT / mass))))
        self.valid = torch.arange(self.n_pad, device=band.device) < self.n

    def init(self, positions, box_vectors, seed: int = 0) -> BandCarry:
        """Sort, calibrate the band width from the sorted start, and draw
        the velocities (on every lane, padding included, as in JAX)."""
        band, dev = self.band, self.band.device
        box_diag = box_diagonal(box_vectors, dev)
        x3s, _ = sort_by_x(self.dense.pad_positions(positions), (), self.n)
        band.calibrate(x3s, float(box_diag[0, 0]))
        gen = torch.Generator(device=dev).manual_seed(seed)
        v3 = self.sigma_v_lane * torch.randn((3, self.n_pad), generator=gen,
                                             device=dev)
        return BandCarry(
            x=x3s, v=v3, F=band.force(x3s, box_diag), ref_x=x3s[0].clone(),
            box_diag=box_diag,
            overflowed=torch.zeros((), dtype=torch.bool, device=dev),
            generator=gen,
        )

    def _sorted(self, x, v, state: BandCarry):
        """(x, v, ref_x, overflowed) re-sorted by x, with the band width the
        sorted state needs checked against w."""
        xs, (vs,) = sort_by_x(x, (v,), self.n)
        w_needed = band_width_needed(
            torch.where(self.valid, xs[0], 3.0e38), self.n, self.band.reach,
            state.box_diag[0, 0])
        return xs, vs, xs[0], state.overflowed | (w_needed > self.band.w)

    def _resort(self, x, v, state: BandCarry, stale):
        """(x, v, ref_x, overflowed) after the re-sort where ``stale`` holds:
        the sorted candidate, chosen on the device, so that no step waits
        for the host (a host branch on ``stale`` won or lost by 2-4% with
        the host's speed, ``PERF.md`` §6)."""
        xs, vs, ref_x, overflowed = self._sorted(x, v, state)
        return (torch.where(stale, xs, x), torch.where(stale, vs, v),
                torch.where(stale, ref_x, state.ref_x),
                torch.where(stale, overflowed, state.overflowed))

    def step(self, state: BandCarry, noise) -> BandCarry:
        """One BAOAB step with the given (3, n_pad) standard-normal noise,
        with the re-sort where the state went stale.  A non-finite live
        coordinate latches ``overflowed`` before the sort, which would move
        a NaN key past the padding (a device reduction, no host sync); the
        JAX runner does not latch it."""
        if self.band.w is None:
            raise RuntimeError("call init() before stepping")
        box = state.box_diag
        Lx = box[0, 0]
        x, v = self._baoa(state.x, state.v, state.F, box, noise)
        nonfinite = live_nonfinite(x, self.n)
        dx = x[0] - state.ref_x
        dx = dx - Lx * torch.round(dx / Lx)
        stale = torch.any(torch.where(self.valid, torch.abs(dx), 0.0)
                          >= self.band.margin)
        x, v, ref_x, overflowed = self._resort(x, v, state, stale)
        F = self.band.force(x, box)
        return BandCarry(x=x, v=self._kick(v, F), F=F, ref_x=ref_x,
                         box_diag=box, overflowed=overflowed | nonfinite,
                         generator=state.generator)

    def check(self, state: BandCarry):
        if bool(state.overflowed):
            raise RuntimeError(
                "band runner invariant violated (band width exceeded the "
                "calibrated w after a density fluctuation, or a live "
                "coordinate went non-finite) -- increase margin and re-run"
            )

    def energy(self, state: BandCarry):
        return self.dense.force_energy_t(state.x, state.box_diag)[1]


def band_run_chunk(step_fn, carry, n_steps: int):
    """``n_steps`` calls of the scan-style ``step_fn(carry, None) -> (carry,
    out)`` (``runtime.py:365-368``), a Python loop of device work."""
    for _ in range(n_steps):
        carry, _ = step_fn(carry, None)
    return carry


def make_band_lj_runner(
    potential,
    n_particles: int,
    temperature=300.0 * units.kelvin,
    timestep=2.0 * units.femtoseconds,
    collision_rate=1.0 / units.picoseconds,
    topology=None,
    tm: int = 256,
    margin: float = 0.15,
    *,
    device="cuda",
) -> BandRunner:
    """Banded (x-sorted) LJ Langevin runner for large N on ``device`` (the
    card unless the caller asks for the CPU)."""
    if topology is None:
        topology = potential.topology
    mass = float(_uniform_masses(topology, "banded")[0])
    kT, dt, gamma = _md_constants(temperature, timestep, collision_rate)
    band = LJBand(n_particles, potential.sigma, potential.epsilon,
                  potential.cutoff, margin=margin, tm=tm, device=device)
    dense_tile = min(512, tm if tm >= 128 else 128)
    if tm > 512:
        # the reference's 512 may not divide the band's n_pad here (tm 640,
        # say): K1 takes any tile, so take the largest that does
        dense_tile = math.gcd(dense_tile, band.n_pad)
    dense = LJDense(n_particles, potential.sigma, potential.epsilon,
                    potential.cutoff, tm=dense_tile, tn=dense_tile,
                    n_pad=band.n_pad, device=device)
    return BandRunner(band, dense, mass, kT, dt, gamma)


@dataclass
class StripCarry:
    """State of the halo-strip runner in the x-sorted extended layout."""

    x: torch.Tensor           # (3, n_pad + H) extended positions
    v: torch.Tensor           # (3, n_pad)
    F: torch.Tensor           # (3, n_pad)
    step: torch.Tensor        # (1, 1) int32 cumulative step count
    box_diag: torch.Tensor    # (1, 3)
    overflowed: torch.Tensor  # () bool: band width or drift violation


class StripRunner:
    """Halo-strip LJ runner (``runtime.py:1308-1497``): every segment
    re-sorts the state by x, checks the band width against the halo, and
    advances S steps on K7; its drift latch (the top-2 joint drift from the
    sort against the slack, or a live coordinate not finite) and the band
    check latch into ``overflowed``.  Sorting permutes particle identity:
    ``positions(state)`` returns the internal order."""

    def __init__(self, md: StripLJMD, dense: LJDense, segment_steps: int,
                 halo_headroom: float, exact_forces: bool):
        self.md, self.dense = md, dense
        self.segment_steps = segment_steps
        self.halo_headroom = halo_headroom
        self.exact_forces = exact_forces
        self.seed = None  # the noise seed, set by init()
        self.valid = torch.arange(md.n_pad, device=md.device) < md.n
        self.reach = md.cutoff + md.slack
        # the drift latch's scratch on the card, held across segments
        self._latch = (LatchScratch(md.n_pad, md.device)
                       if md.device.type == "cuda" else None)

    def _width(self, x3s, Lx):
        return band_width_needed(torch.where(self.valid, x3s[0], 3.0e38),
                                 self.md.n, self.reach, Lx)

    def init(self, positions, box_vectors, seed: int = 0) -> StripCarry:
        """Sort, fix the halo from the band width with headroom, draw the
        velocities and take the first force."""
        md = self.md
        self.seed = seed
        x3 = torch.where(self.valid, self.dense.pad_positions(positions),
                         _PAD_X)
        box_diag = box_diagonal(box_vectors, md.device)
        x3s, _ = sort_by_key_strip(x3, ())
        W = int(self._width(x3s, float(box_diag[0, 0])))
        md.set_halo(int(W * self.halo_headroom) + md.tm + (md.n_pad - md.n))
        xe = md.extend(x3s, box_diag)
        gen = torch.Generator(device=md.device).manual_seed(seed)
        v3 = md.sigv * torch.randn((3, md.n_pad), generator=gen,
                                   device=md.device)
        return StripCarry(
            x=xe, v=v3,
            F=md.force(xe, box_diag, approx_recip=not self.exact_forces),
            step=torch.zeros((1, 1), dtype=torch.int32, device=md.device),
            box_diag=box_diag,
            overflowed=torch.zeros((), dtype=torch.bool, device=md.device),
        )

    def segment(self, state: StripCarry, n_steps: int) -> StripCarry:
        """One segment: the sort, the band check, ``n_steps`` steps on K7
        and the drift latch (the scan body of ``runtime.py:1412-1459``).
        The live x is wrapped into [0, L) before the sort (a carry from
        elsewhere may hold it unwrapped) and, by ``run_segment``, after the
        last force; x stays continuous between."""
        if self.seed is None:
            raise RuntimeError("call init() before running a segment")
        md = self.md
        n, n_pad = md.n, md.n_pad
        box = state.box_diag
        # before the sort, which may move a NaN key out of the live lanes
        nonfinite = live_nonfinite(state.x[:, :n_pad], n)
        center = strip_wrap(state.x, box, n, n_pad, 0, sentinel=True)
        x3s, (v3, F3) = sort_by_key_strip(center, (state.v, state.F))
        # pad slots sit between rank n-1 and the halo, so a wrap-crossing
        # row needs an array window of W + (n_pad - n)
        overflowed = (state.overflowed | nonfinite
                      | (self._width(x3s, box[0, 0]) + (n_pad - n) > md.H))
        xe1, v1, F1 = md.run_segment(
            md.extend(x3s, box), v3, F3, box, self.seed, state.step, n_steps,
            approx_recip=not self.exact_forces)
        drift_bad = tile_skin_drift_bad(xe1[:, :n_pad].contiguous(), x3s, n,
                                        md.slack_t, box, scratch=self._latch)
        return StripCarry(x=xe1, v=v1, F=F1, step=state.step + n_steps,
                          box_diag=box, overflowed=overflowed | drift_bad)

    def run(self, state: StripCarry, n_steps: int) -> StripCarry:
        """Whole segments of ``segment_steps``, then one for the rest."""
        n_seg, rem = divmod(n_steps, self.segment_steps)
        for _ in range(n_seg):
            state = self.segment(state, self.segment_steps)
        if rem:
            state = self.segment(state, rem)
        return state

    def check(self, state: StripCarry):
        if bool(state.overflowed):
            raise RuntimeError(
                "strip runner invariant violated (band width or per-segment "
                "drift) -- reduce segment_steps or increase slack and re-run"
            )

    def energy(self, state: StripCarry):
        center = torch.where(self.valid, state.x[:, :self.md.n_pad], 0.0)
        return self.dense.force_energy_t(center, state.box_diag)[1]

    def positions(self, state: StripCarry):
        return state.x[:, :self.md.n].T

    def velocities(self, state: StripCarry):
        return state.v[:, :self.md.n].T


def make_strip_lj_runner(
    potential,
    n_particles: int,
    temperature=300.0 * units.kelvin,
    timestep=2.0 * units.femtoseconds,
    collision_rate=1.0 / units.picoseconds,
    topology=None,
    tm: int = 128,
    slack: float = 0.3,
    segment_steps: int = 50,
    halo_headroom: float = 1.3,
    exact_forces: bool = False,
    *,
    device="cuda",
) -> StripRunner:
    """Halo-strip LJ runner on ``device`` (the card by default); the noise
    seed is ``init``'s."""
    if topology is None:
        topology = potential.topology
    masses = _uniform_masses(topology, "strip")
    kT, dt, gamma = _md_constants(temperature, timestep, collision_rate)
    md = StripLJMD(n_particles, potential.sigma, potential.epsilon,
                   potential.cutoff, masses_lane=masses,
                   dt=dt, gamma=gamma, kT=kT, tm=tm, slack=slack,
                   device=device)
    dense = LJDense(n_particles, potential.sigma, potential.epsilon,
                    potential.cutoff, tm=128, tn=128, n_pad=md.n_pad,
                    device=device)
    return StripRunner(md, dense, segment_steps, halo_headroom, exact_forces)


def make_lj_runner(
    potential,
    n_particles: int,
    box_vectors=None,
    temperature=300.0 * units.kelvin,
    timestep=2.0 * units.femtoseconds,
    collision_rate=1.0 / units.picoseconds,
    topology=None,
    engine: str = "auto",
    *,
    device="cuda",
    **kwargs,
):
    """The LJ engine for the system (``runtime.py:1536-1597``), on
    ``device`` (the card by default).

    ``engine="auto"`` takes the dense runner below N = 2048, for
    non-uniform masses, or when the narrowest box side is at most
    2.6 (cutoff + 0.3); the culled runner up to N = 80,000; the band runner
    above.  ``"dense"``, ``"culled"``, ``"strip"`` and ``"band"`` choose
    directly; ``kwargs`` go to the chosen factory.
    """
    if topology is None:
        topology = potential.topology
    masses = np.asarray(topology.masses())
    uniform = bool(np.allclose(masses, masses[0]))
    if engine == "auto":
        wide_enough = True
        if box_vectors is not None:
            box = np.asarray(units.strip_md(box_vectors, units.nanometer))
            wide_enough = float(np.diagonal(box).min()) > 2.6 * (
                potential.cutoff + 0.3)
        if n_particles < 2048 or not uniform or not wide_enough:
            engine = "dense"
        elif n_particles <= 80_000:
            engine = "culled"
        else:
            engine = "band"
    factories = {"dense": make_fast_lj_runner, "culled": make_culled_lj_runner,
                 "strip": make_strip_lj_runner, "band": make_band_lj_runner}
    if engine not in factories:
        raise ValueError(
            f"unknown engine {engine!r}; pick auto/dense/culled/strip/band")
    return factories[engine](
        potential=potential, n_particles=n_particles, topology=topology,
        temperature=temperature, timestep=timestep,
        collision_rate=collision_rate, device=device, **kwargs)


@dataclass
class LangevinRunner:
    """BAOAB propagator of the general API: ``state = runner.run(state,
    n)``, on ``device``."""

    step_fn: object
    energy_fn: object
    masses: torch.Tensor
    temperature_md: float
    pairs: object
    device: torch.device

    def init(self, positions, box_vectors=None, seed: int = 0,
             velocities=None) -> LangevinCarry:
        """The initial carry: velocities (drawn from ``seed`` unless given),
        the pair scheme's state, forces."""
        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)

        x = f32(positions)
        box = None if box_vectors is None else f32(box_vectors)
        key = utils.prng_key(seed)
        if velocities is None:
            key, vkey = utils.split(key)
            v = utils.initialize_velocities_md(self.temperature_md,
                                               self.masses, vkey)
        else:
            v = f32(velocities)
        if isinstance(self.pairs, (NeighborListNsqrd, PairListNsqrd,
                                   DensePairs)):
            self.pairs.build(x, box)
            nbr_state = self.pairs.state
        else:
            nbr_state = None
        return LangevinCarry(
            x=x, v=v, F=force_of(self.energy_fn, x, nbr_state),
            box_vectors=box,
            overflowed=torch.zeros((), dtype=torch.bool, device=self.device),
            key=key, nbr_state=nbr_state,
        )

    def run(self, state: LangevinCarry, n_steps: int) -> LangevinCarry:
        """Advance ``n_steps``; ``state`` itself is left as it was."""
        return run_chunk(self.step_fn, state, n_steps)

    def energy(self, state: LangevinCarry):
        return self.energy_fn(state.x, state.nbr_state)


def make_langevin_runner(
    potential,
    pairs=None,
    topology=None,
    temperature=300.0 * units.kelvin,
    timestep=2.0 * units.femtoseconds,
    collision_rate=1.0 / units.picoseconds,
    *,
    device="cuda",
) -> LangevinRunner:
    """A BAOAB runner for ``potential`` (and a pair scheme) on ``device``,
    the card unless the caller passes ``device="cpu"``."""
    if topology is None:
        topology = potential.topology
    device = torch.device(device)
    masses = utils.masses_md(topology, device)
    T = units.strip_md(temperature, units.kelvin)
    kT, dt, gamma = _md_constants(temperature, timestep, collision_rate)
    if isinstance(pairs, DensePairs) and not pairs.is_built:
        raise ValueError(
            "build the DensePairs scheme (build/build_from_state) before "
            "creating a runner -- the fused kernel is specialized on the "
            "particle count"
        )
    energy_fn = potential.make_energy_fn(pairs)
    step_fn = make_baoab_step_fn(energy_fn, masses, dt, gamma, kT, pairs=pairs)
    return LangevinRunner(step_fn=step_fn, energy_fn=energy_fn, masses=masses,
                          temperature_md=T, pairs=pairs, device=device)
