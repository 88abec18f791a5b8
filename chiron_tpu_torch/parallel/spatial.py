"""Particle-axis (spatial) sharding of the pair stage (port of
``chiron_tpu/parallel/spatial.py``).

Each process of the mesh (``parallel.mesh``) owns the contiguous slab of
``rows_per_dev`` rows ``[rank * rows_per_dev, (rank + 1) * rows_per_dev)``
of the (3, n_pad) lane layout and computes the forces of its rows only, on
the kernels of K8:

* ``row_slab_force`` (K8a, replacing ``_make_row_slab_force``): the slab
  against every column, with the slab's pair energy when asked, on K1's
  kernel (``csrc/lj_dense.cu``) taking the slab's rows;
* ``row_band_force`` (K8b, replacing ``_make_row_band_force``,
  ``csrc/spatial.cu``): the slab of the x-sorted layout against the cyclic
  rank band, both directions.

Each has its plain PyTorch version here, which a wrapper runs for a CPU
tensor.  The energies of the runners come from K2, ``LJDense(triangle=
False)``.

Every entry point returns global arrays, equal on every rank, as the JAX
global arrays are.  ``make_spatial_lj_runner`` keeps each rank's slab of x,
v and F through a run and all-gathers the positions once a step;
``make_spatial_band_lj_runner`` keeps the sorted state replicated and
all-gathers the band force once a step.  The O-step noise is drawn over the
full particle axis from a generator seeded alike on every rank, and each
rank takes its rows, so the trajectory does not depend on the mesh size.
With a mesh of one process (no group) no collective runs and
``torch.distributed`` need not be initialised.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import units
from ..ops import _build
from ..ops.diff import energy_with_force_gradient
from ..ops.lj_band import band_width_needed, sort_by_x
from ..ops.lj_cull import live_nonfinite
from ..ops.lj_dense import LJDense, box_diagonal, lj_rows_plain
from ..runtime import _md_constants, _uniform_masses
from .mesh import Mesh

# ---------------------------------------------------------------------------
# K8: the per-device kernels and their plain versions
# ---------------------------------------------------------------------------


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_slab(n_pad: int, rows: int, off: int, n: int, box_diag):
    if (box_diag.numel() != 3 or n_pad % 32 or rows % 32 or off % 32
            or not 0 <= off <= n_pad - rows or not 0 < n <= n_pad):
        raise ValueError(
            f"spatial kernels take 3 box lengths, n_pad, rows and off "
            f"multiples of 32 with the slab inside the layout and 0 < n <= "
            f"n_pad (got n_pad={n_pad}, rows={rows}, off={off}, n={n})"
        )


def row_slab_force_plain(rows3, pos3, box_diag, off: int, n: int,
                         sigma: float, epsilon: float, cutoff: float,
                         with_energy: bool = False):
    """Plain version of K8a: ((3, rows) force of the rows ``off ..``, ()
    f32 slab energy or None), every pair counted from its row's side (not
    halved); the dense pair math of ``lj_rows_plain``."""
    force, energy = lj_rows_plain(rows3, pos3, box_diag, off, n, sigma,
                                  epsilon, cutoff, with_energy)
    return force, (energy.to(pos3.dtype) if with_energy else None)


def row_slab_force(rows3, pos3, box_diag, off: int, n: int, sigma: float,
                   epsilon: float, cutoff: float, with_energy: bool = False):
    """K8a: the LJ force on the (3, rows) slab ``rows3`` (global rows
    ``off ..``) from every column of ``pos3`` (3, n_pad), with the exact
    reciprocal; with ``with_energy`` also the () slab energy, not halved.
    Launches K1's kernel (``csrc/lj_dense.cu``) on the slab's rows for CUDA
    tensors (counted as ``row_slab_force`` or ``row_slab_force_energy``):
    one slab of every row has K2's bits, and half its energy is K2's.  Runs
    ``row_slab_force_plain`` on CPU tensors."""
    if rows3.device.type == "cpu":
        return row_slab_force_plain(rows3, pos3, box_diag, off, n, sigma,
                                    epsilon, cutoff, with_energy)
    _build.check_cuda(rows3, "rows3")
    dev = rows3.device
    rows, n_pad = rows3.shape[1], pos3.shape[1]
    _build.require(rows3, "rows3", (3, rows), torch.float32)
    _build.require(pos3, "pos3", (3, n_pad), torch.float32, dev)
    _build.require(box_diag, "box_diag", None, torch.float32, dev)
    _check_slab(n_pad, rows, off, n, box_diag)
    f32 = dict(dtype=torch.float32, device=dev)
    force = torch.empty((3, rows), **f32)
    e_part = torch.empty(rows // 32, **f32) if with_energy else None
    energy = torch.empty(1, **f32) if with_energy else None
    sigma2, eps4 = sigma * sigma, 4.0 * epsilon
    _build.launch(
        "row_slab_force_energy" if with_energy else "row_slab_force",
        "chiron_row_slab_force",
        rows3.data_ptr(), pos3.data_ptr(), box_diag.data_ptr(),
        force.data_ptr(), _ptr(e_part), _ptr(energy), n, n_pad, rows, off,
        sigma2, 6.0 * eps4, eps4, cutoff * cutoff, 1e-4 * sigma2,
        int(with_energy), _build.stream_of(rows3),
    )
    return force, (energy[0] if with_energy else None)


def band_window(n: int, n_pad: int, tm: int, w: int):
    """(K, nbt): K8b's column window (``spatial.py:488-489``).  The rank
    distance runs over the n live ranks but the tiles over the padded
    layout, whose padding gap may span many tiles, so the window covers the
    band plus that gap: the row tile's K neighbours on each side, never
    more than every tile once."""
    n_tiles = n_pad // tm
    K = min((w + (n_pad - n) + tm - 1) // tm + 2, n_tiles)
    return K, min(2 * K + 1, n_tiles)


def row_band_force_plain(pos3, box_diag, off: int, rows: int, n: int, w: int,
                         sigma: float, epsilon: float, cutoff: float):
    """Plain version of K8b: the (3, rows) force of rows ``off ..`` of the
    x-sorted ``pos3``.  It applies the band rule (cyclic rank distance
    1 <= delta <= w or delta >= n - w) to every pair, with no tile window, so
    a window too narrow in a kernel shows as a difference."""

    def in_band(rid, cid):
        delta = torch.remainder(cid - rid + n, n)
        return (delta >= 1) & ((delta <= w) | (delta >= n - w))

    return lj_rows_plain(pos3[:, off:off + rows], pos3, box_diag, off, n,
                         sigma, epsilon, cutoff, with_energy=False,
                         keep=in_band)[0]


def row_band_force(pos3, box_diag, off: int, rows: int, n: int, w: int,
                   tm: int, sigma: float, epsilon: float, cutoff: float,
                   skip: bool = True):
    """K8b: the (3, rows) banded force of rows ``off ..`` of the x-sorted
    ``pos3`` (3, n_pad), both band directions, exact reciprocal, over the
    window of ``tm``-column tiles of ``band_window``.  Launches
    ``csrc/spatial.cu`` on a CUDA tensor (counted as ``row_band_force``);
    runs ``row_band_force_plain`` on a CPU tensor.  ``skip=False`` makes the
    kernel take every slot of the window, with no skip: the reference whose
    bits the skips keep on a finite state (for tests)."""
    if pos3.device.type == "cpu":
        return row_band_force_plain(pos3, box_diag, off, rows, n, w, sigma,
                                    epsilon, cutoff)
    _build.check_cuda(pos3, "pos3")
    dev = pos3.device
    n_pad = pos3.shape[1]
    _build.require(pos3, "pos3", (3, n_pad), torch.float32)
    _build.require(box_diag, "box_diag", None, torch.float32, dev)
    _check_slab(n_pad, rows, off, n, box_diag)
    if tm % 32 or n_pad % tm or not 0 < w < n_pad:
        raise ValueError(
            f"row_band_force: tm a multiple of 32 dividing n_pad and "
            f"0 < w < n_pad (got tm={tm}, n_pad={n_pad}, w={w})"
        )
    K, nbt = band_window(n, n_pad, tm, w)
    force = torch.empty((3, rows), dtype=torch.float32, device=dev)
    sigma2 = sigma * sigma
    _build.launch(
        "row_band_force", "chiron_row_band_force",
        pos3.data_ptr(), box_diag.data_ptr(), force.data_ptr(), n, n_pad,
        rows, off, tm, w, K, nbt, sigma2, 24.0 * epsilon, cutoff * cutoff,
        1e-4 * sigma2, int(skip), _build.stream_of(pos3),
    )
    return force


# ---------------------------------------------------------------------------
# The layout and the collectives
# ---------------------------------------------------------------------------


def _spatial_padding(n: int, n_dev: int, tm: int) -> int:
    base_pad = ((n + tm - 1) // tm) * tm
    return int(math.ceil(base_pad / (n_dev * tm)) * n_dev * tm)


def _tile(tm: int, device: torch.device) -> int:
    """The row tile: on the card at least 128, the TPU's floor off interpret
    mode, so that the card runs the TPU's shapes (and every slab is a
    multiple of 32 rows); on the CPU as given, as interpret mode keeps it."""
    return tm if device.type == "cpu" else max(tm, 128)


def _check_axis(mesh: Mesh, axis_name: str):
    if mesh.axis_name != axis_name:
        raise ValueError(
            f"the mesh's axis is {mesh.axis_name!r}, not {axis_name!r}")


def _gather_rows(mesh: Mesh, rows):
    """Every rank's (3, r) rows side by side in rank order: (3, size r), as
    JAX's ``all_gather(axis=1, tiled=True)``."""
    if mesh.group is None:
        return rows
    parts = [torch.empty_like(rows) for _ in range(mesh.size)]
    dist.all_gather(parts, rows.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=1)


def _rank_sum(mesh: Mesh, value):
    """A () value summed over the ranks, added in rank order, so that the
    total never depends on a collective's reduction order."""
    if mesh.group is None:
        return value
    parts = [torch.empty_like(value) for _ in range(mesh.size)]
    dist.all_gather(parts, value.contiguous(), group=mesh.group)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


# ---------------------------------------------------------------------------
# The sharded force
# ---------------------------------------------------------------------------


def make_sharded_lj_force(mesh: Mesh, n: int, sigma: float, epsilon: float,
                          cutoff: float, axis_name: str = "replica",
                          tm: int = 256):
    """Build ``force(pos3, box_diag) -> force3`` with the rows of the
    particle axis sharded over ``mesh``, on the mesh's device.

    ``pos3`` is the (3, n_pad) layout with ``n_pad == force.n_pad`` (use
    ``force.op.pad_positions``), the same on every rank.  Each rank computes
    its slab on K8a, and ``force`` returns the gathered (3, n_pad) force on
    every rank (zero on the padding); ``force.force_energy`` adds the total
    energy (the slab sums in rank order, halved), and
    ``force.energy_differentiable`` is that energy with ``-force`` as its
    exact autograd gradient.  ``force.op`` is K2 on the same padding.
    """
    _check_axis(mesh, axis_name)
    dev = mesh.device
    tm = _tile(tm, dev)
    op = LJDense(n, sigma, epsilon, cutoff, tm=tm, tn=tm,
                 n_pad=_spatial_padding(n, mesh.size, tm), triangle=False,
                 device=dev)
    n_pad = op.n_pad
    rows_per_dev = n_pad // mesh.size
    off = mesh.rank * rows_per_dev

    def slab(pos3, box_diag, with_energy):
        rows = pos3[:, off:off + rows_per_dev].contiguous()
        return row_slab_force(rows, pos3, box_diag, off, n, sigma, epsilon,
                              cutoff, with_energy)

    def force(pos3, box_diag):
        """(3, n_pad) padded positions -> (3, n_pad) force, gathered."""
        return _gather_rows(mesh, slab(pos3, box_diag, False)[0])

    def force_energy(pos3, box_diag):
        """(3, n_pad) padded positions -> (gathered force, total energy)."""
        f, e = slab(pos3, box_diag, True)
        # every unordered pair is computed by both owners' slabs
        return _gather_rows(mesh, f), 0.5 * _rank_sum(mesh, e)

    def energy_differentiable(pos3, box_diag):
        """The total energy as a differentiable function of ``pos3``: one
        sharded pass gives the value and, as its autograd gradient, exactly
        ``-force``."""
        return energy_with_force_gradient(
            lambda p: force_energy(p, box_diag), pos3)

    force.op = op
    force.n_pad = n_pad
    force.rows_per_dev = rows_per_dev
    force.force_energy = force_energy
    force.energy_differentiable = energy_differentiable
    return force


# ---------------------------------------------------------------------------
# The runners
# ---------------------------------------------------------------------------


def _runner_setup(mesh: Mesh, potential, n_particles: int, temperature,
                  timestep, collision_rate, axis_name: str, tm: int):
    """(op, kT, dt, gamma, tm) of both runners: K2 on the mesh padding, the
    MD constants (``collision_rate=None`` means 1/ps, as in both JAX
    factories) and the row tile."""
    _check_axis(mesh, axis_name)
    kT, dt, gamma = _md_constants(
        temperature, timestep,
        1.0 / units.picosecond if collision_rate is None else collision_rate)
    tm = _tile(tm, mesh.device)
    op = LJDense(n_particles, potential.sigma, potential.epsilon,
                 potential.cutoff, tm=tm, tn=tm,
                 n_pad=_spatial_padding(n_particles, mesh.size, tm),
                 triangle=False, device=mesh.device)
    return op, kT, dt, gamma, tm


class _SpatialRunner:
    """What both runners share: the mesh layout, the BAOAB kinematics of the
    JAX chains and the global-array views."""

    def __init__(self, mesh: Mesh, op: LJDense, dt: float, gamma: float):
        self.mesh, self.op = mesh, op
        self.n, self.n_pad = op.n, op.n_pad
        self.rows_per_dev = self.n_pad // mesh.size
        self.off = mesh.rank * self.rows_per_dev
        self.half = 0.5 * dt
        self.a = float(np.exp(-gamma * dt))
        self.b = float(np.sqrt(1.0 - np.exp(-2.0 * gamma * dt)))

    def _baoa(self, x, v, F, minv, sigv, noise, Lcol):
        """B, A, O and A of a step, then the wrap: the new (x, v) that the
        step's force is taken at."""
        v1 = v + self.half * F * minv
        x1 = x + self.half * v1
        v2 = self.a * v1 + self.b * sigv * noise
        x2 = x1 + self.half * v2
        return x2 - torch.floor(x2 / Lcol) * Lcol, v2

    def _kick(self, v, F, minv):
        """The closing B half-kick."""
        return v + self.half * F * minv

    def positions(self, state):
        return state.x[:, :self.n].T

    def velocities(self, state):
        return state.v[:, :self.n].T

    def energy(self, state):
        """K2 on the full positions (one O(N^2) pass on every rank)."""
        return self.op.force_energy_t(state.x, state.box_diag)[1]


@dataclass
class SpatialCarry:
    """State of the dense spatial runner: global (3, n_pad) arrays, equal on
    every rank."""

    x: torch.Tensor            # (3, n_pad)
    v: torch.Tensor            # (3, n_pad)
    F: torch.Tensor            # (3, n_pad)
    step: int                  # cumulative steps
    box_diag: torch.Tensor     # (1, 3)
    generator: torch.Generator  # O-step noise (the JAX carry's key)


class SpatialRunner(_SpatialRunner):
    """BAOAB Langevin with the rows sharded over the mesh
    (``spatial.py:282-465``): each rank integrates its slab and takes its
    slab's force on K8a after one all-gather of the positions a step.

    The padding lanes take mass 1 (as in JAX): their velocities are drawn,
    their positions drift and wrap, their forces are zero.  Masses may
    differ (no sort: the particle order stays).
    """

    def __init__(self, mesh: Mesh, op: LJDense, masses, kT: float, dt: float,
                 gamma: float):
        super().__init__(mesh, op, dt, gamma)
        f32 = dict(dtype=torch.float32, device=mesh.device)
        m_pad = np.ones((1, self.n_pad), np.float32)
        m_pad[0, :self.n] = np.asarray(masses, dtype=np.float32)
        self.minv = torch.as_tensor(1.0 / m_pad, **f32)
        self.sigv = torch.sqrt(kT / torch.as_tensor(m_pad, **f32))

    def _rows(self, a):
        return a[:, self.off:self.off + self.rows_per_dev]

    def _slab_force(self, x_rows, x_full, box_diag):
        op = self.op
        return row_slab_force(x_rows, x_full, box_diag, self.off, self.n,
                              op.sigma, op.epsilon, op.cutoff)[0]

    def init(self, positions, box_vectors, seed: int = 0,
             velocities=None) -> SpatialCarry:
        dev = self.mesh.device
        x3 = self.op.pad_positions(positions)
        box_diag = box_diagonal(box_vectors, dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        if velocities is None:
            v3 = self.sigv * torch.randn((3, self.n_pad), generator=gen,
                                         device=dev)
        else:
            v3 = self.op.pad_positions(velocities)
        F3 = _gather_rows(self.mesh, self._slab_force(
            self._rows(x3).contiguous(), x3, box_diag))
        return SpatialCarry(x=x3, v=v3, F=F3, step=0, box_diag=box_diag,
                            generator=gen)

    def _advance(self, state: SpatialCarry, noises) -> SpatialCarry:
        """The steps of ``noises`` (each the full (3, n_pad) noise) on this
        rank's slab, then the velocities and forces gathered."""
        box = state.box_diag
        Lcol = box.reshape(3, 1)
        minv, sigv = self._rows(self.minv), self._rows(self.sigv)
        x_full = state.x
        x, v, F = self._rows(state.x), self._rows(state.v), self._rows(state.F)
        steps = 0
        for noise in noises:
            x, v = self._baoa(x, v, F, minv, sigv, self._rows(noise), Lcol)
            x_full = _gather_rows(self.mesh, x)
            F = self._slab_force(x, x_full, box)
            v = self._kick(v, F, minv)
            steps += 1
        return SpatialCarry(
            x=x_full, v=_gather_rows(self.mesh, v.contiguous()),
            F=_gather_rows(self.mesh, F.contiguous()), step=state.step + steps,
            box_diag=box, generator=state.generator)

    def step(self, state: SpatialCarry, noise) -> SpatialCarry:
        """One step with the given full-axis (3, n_pad) standard-normal
        noise (each rank takes its rows)."""
        return self._advance(state, (noise,))

    def run(self, state: SpatialCarry, n_steps: int) -> SpatialCarry:
        """``n_steps`` steps, the noise drawn from the state's generator."""
        dev = state.x.device
        noises = (torch.randn((3, self.n_pad), generator=state.generator,
                              device=dev) for _ in range(n_steps))
        return self._advance(state, noises)


def make_spatial_lj_runner(
    mesh: Mesh,
    potential,
    n_particles: int,
    temperature,
    timestep,
    collision_rate=None,
    topology=None,
    axis_name: str = "spatial",
    tm: int = 256,
) -> SpatialRunner:
    """BAOAB Langevin with the particle axis sharded over ``mesh``, on the
    mesh's device (the card unless the mesh was made for the CPU).
    ``collision_rate=None`` means 1/ps.  Returns a runner with ``init``
    (``velocities=`` optional), ``run``, ``step(state, noise)``,
    ``positions``, ``velocities`` and ``energy``."""
    if topology is None:
        topology = potential.topology
    op, kT, dt, gamma, _ = _runner_setup(mesh, potential, n_particles,
                                         temperature, timestep,
                                         collision_rate, axis_name, tm)
    return SpatialRunner(mesh, op, topology.masses(), kT, dt, gamma)


@dataclass
class SpatialBandCarry:
    """State of the banded spatial runner: the x-sorted (3, n_pad) layout,
    equal on every rank."""

    x: torch.Tensor            # (3, n_pad), x-sorted
    v: torch.Tensor            # (3, n_pad)
    F: torch.Tensor            # (3, n_pad)
    step: int                  # cumulative steps
    box_diag: torch.Tensor     # (1, 3)
    generator: torch.Generator  # O-step noise (the JAX carry's key)
    overflowed: torch.Tensor   # () bool: band capacity / drift violation


class SpatialBandRunner(_SpatialRunner):
    """Large-N spatially sharded Langevin on the band force
    (``spatial.py:586-831``).  Every rank keeps the whole state; each
    segment of ``segment_steps`` steps sorts it by x (v and F follow),
    checks the band width the sorted state needs against ``w``, and steps
    with each rank's band rows (K8b) all-gathered.  ``overflowed`` latches
    if a sort needs a wider band, if a particle's x drifts more than
    ``margin`` within a segment, or if a live x is not finite at a segment's
    end or (a repair over the JAX package, as in the port's other sorting
    runners) at its start.  Sorting permutes particle identity:
    ``positions(state)`` returns the internal order.
    """

    def __init__(self, mesh: Mesh, op: LJDense, mass: float, kT: float,
                 dt: float, gamma: float, tm: int, margin: float,
                 segment_steps: int):
        super().__init__(mesh, op, dt, gamma)
        self.tm, self.margin, self.segment_steps = tm, margin, segment_steps
        self.reach = op.cutoff + 2.0 * margin
        # one mass and sigma_v on every lane, padding included, as in JAX
        self.minv = float(np.float32(1.0 / mass))
        self.sigv = float(np.float32(np.sqrt(kT / mass)))
        self.valid = torch.arange(self.n_pad, device=mesh.device) < self.n
        self.w = None  # calibrated by init()

    def _width(self, xs, Lx):
        return band_width_needed(torch.where(self.valid, xs[0], 3.0e38),
                                 self.n, self.reach, Lx)

    def _force(self, x, box_diag):
        op = self.op
        return _gather_rows(self.mesh, row_band_force(
            x, box_diag, self.off, self.rows_per_dev, self.n, self.w, self.tm,
            op.sigma, op.epsilon, op.cutoff))

    def init(self, positions, box_vectors, seed: int = 0) -> SpatialBandCarry:
        """Sort, calibrate ``w`` (1.25 headroom plus 8, rounded up to 8; a
        re-init recalibrates), draw the velocities and take the force."""
        dev = self.mesh.device
        box_diag = box_diagonal(box_vectors, dev)
        x3s, _ = sort_by_x(self.op.pad_positions(positions), (), self.n)
        w_data = int(self._width(x3s, float(box_diag[0, 0])))
        self.w = min(((int(w_data * 1.25) + 8 + 7) // 8) * 8, self.n_pad - 1)
        gen = torch.Generator(device=dev).manual_seed(seed)
        v3 = self.sigv * torch.randn((3, self.n_pad), generator=gen,
                                     device=dev)
        return SpatialBandCarry(
            x=x3s, v=v3, F=self._force(x3s, box_diag), step=0,
            box_diag=box_diag, generator=gen,
            overflowed=torch.zeros((), dtype=torch.bool, device=dev))

    def segment(self, state: SpatialBandCarry, noise=None) -> SpatialBandCarry:
        """One segment: the sort, the band check, ``segment_steps`` steps and
        the drift latch.  ``noise`` may give the segment's (S, 3, n_pad)
        standard-normal noise; else it comes from the state's generator."""
        if self.w is None:
            raise RuntimeError("call init() before running a segment")
        S, n, dev = self.segment_steps, self.n, state.x.device
        box = state.box_diag
        Lcol, Lx = box.reshape(3, 1), box[0, 0]
        # before the sort, which may move a NaN key out of the live lanes
        nonfinite = live_nonfinite(state.x, n)
        x, (v, F) = sort_by_x(state.x, (state.v, state.F), n)
        over = state.overflowed | nonfinite | (self._width(x, Lx) > self.w)
        ref_x = x[0]
        for s in range(S):
            nz = (torch.randn((3, self.n_pad), generator=state.generator,
                              device=dev) if noise is None else noise[s])
            x, v = self._baoa(x, v, F, self.minv, self.sigv, nz, Lcol)
            F = self._force(x, box)
            v = self._kick(v, F, self.minv)
        valid = self.valid.to(torch.float32)
        dx = x[0] - ref_x
        dx = dx - Lx * torch.round(dx / Lx)
        over = (over | (torch.max(torch.abs(dx) * valid) > self.margin)
                | ~torch.all(torch.isfinite(x[0] * valid)))
        return SpatialBandCarry(x=x, v=v, F=F, step=state.step + S,
                                box_diag=box, generator=state.generator,
                                overflowed=over)

    def run(self, state: SpatialBandCarry, n_steps: int) -> SpatialBandCarry:
        S = self.segment_steps
        if n_steps % S:
            raise ValueError(f"n_steps must be a multiple of segment_steps={S}")
        for _ in range(n_steps // S):
            state = self.segment(state)
        return state

    def check(self, state: SpatialBandCarry):
        if bool(state.overflowed):
            raise RuntimeError(
                "banded spatial runner invariant violated (band capacity, "
                "per-segment x drift or a non-finite coordinate) -- increase "
                "margin or reduce segment_steps and re-run"
            )


def make_spatial_band_lj_runner(
    mesh: Mesh,
    potential,
    n_particles: int,
    temperature,
    timestep,
    collision_rate=None,
    topology=None,
    axis_name: str = "spatial",
    tm: int = 256,
    margin: float = 0.15,
    segment_steps: int = 25,
) -> SpatialBandRunner:
    """The banded spatial runner for N >> 10^4 on the mesh's device (the
    card unless the mesh was made for the CPU).  Requires identical masses
    (sorting permutes particle identity); ``collision_rate=None`` means
    1/ps; ``run``'s step count must be a multiple of ``segment_steps``."""
    if topology is None:
        topology = potential.topology
    mass = float(_uniform_masses(topology, "banded spatial")[0])
    op, kT, dt, gamma, tm = _runner_setup(mesh, potential, n_particles,
                                          temperature, timestep,
                                          collision_rate, axis_name, tm)
    return SpatialBandRunner(mesh, op, mass, kT, dt, gamma, tm, margin,
                             segment_steps)
