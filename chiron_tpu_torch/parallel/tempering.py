"""Replica-parallel tempering (port of ``chiron_tpu/parallel/tempering.py``).

All replica state is stacked on a leading axis R, and one BAOAB chain with
the temperature as data serves every replica.  Where the JAX package runs
``shard_map`` of ``vmap(chain)``, each process of the port's mesh holds its
``replica_sharding`` block (R / size replicas, contiguous) on its device and
runs the chain over the whole block at once:

* the dense chain (``make_pt_dense_chain_fn``) keeps the block in one
  (R_local, 3, n_pad) state: a step is one launch of K1 over replicas
  (``LJDense.force_only_r``) and batched elementwise BAOAB, ``kT`` an
  (R_local, 1, 1) tensor, so its launches do not grow with R;
* the pair-list and bare-potential chains (``make_pt_chain_fn``) take the
  force of the whole block from one backward pass through the block's
  energies (``block_energy_fn``: the harmonic and ideal-gas energies in one
  pass, any other potential replica by replica); the Verlet-list chain
  runs one replica at a time (JAX's ``lax.map``), with the integrator's one
  ``.item()`` a step for the rebuild.

After a propagation each process all-gathers U (R floats, the implicit
gather of JAX's out-sharding) with the overflow flags, reads them once, and
every process runs the same host swap sweep, so the ladders agree.
Positions are gathered only for a reporter or a session file.

The noise is the port's own stream, not JAX's threefry: each replica's
integer key (``utils``) is split once a propagation, and the second child
seeds the splitmix32 counter stream of the fused kernels
(``ops/lj_cull.splitmix_noise_plain``), one counter a step.  A replica's
noise thus depends only on its own key and step, never on R or the mesh,
and a block's draw takes the same launches at any R.  The chains also take
their noise from the caller (``noise``), which is how the tests feed both
packages JAX's draws.  The swap sweep is JAX's host arithmetic (float32
ladder, ``default_rng([seed, iteration])``), so on the same energies it
makes the same decisions.
"""

from __future__ import annotations

import logging
import math
from dataclasses import fields, replace
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import units, utils
from ..analysis import MBAREstimator
from ..integrators import LangevinCarry, force_of, make_baoab_step_fn
from ..neighbors import (
    NeighborListNsqrd,
    NeighborListState,
    PairListNsqrd,
    PairListState,
    neighbor_build_fn,
    pairlist_build_fn,
)
from ..ops.lj_cull import _MASK32, splitmix_noise_plain
from ..potential import (HarmonicOscillatorPotential, IdealGasPotential,
                         grad_of)
from ..profiling import span
from .mesh import Mesh, make_replica_mesh, replica_sharding

log = logging.getLogger("chiron_tpu_torch")

# a noise draw holds at most this many int64 counters, so that a long
# propagation draws its noise in blocks of steps
_NOISE_LANES = 1 << 22
# a replica's lanes are a multiple of this, so that every replica's draw
# takes the same vector path on the CPU at any R
_LANE_ALIGN = 64


def stream_seed(key: int) -> int:
    """The 32-bit counter-stream seed of an integer key."""
    key = int(key)
    return (key ^ (key >> 32)) & _MASK32


def split_keys(keys):
    """Split each key once: ``(next keys, stream seeds)`` (JAX's
    ``key, subkey = split(key)``, the subkey seeding a propagation)."""
    pairs = [utils.split(k) for k in keys]
    return [k for k, _ in pairs], [stream_seed(s) for _, s in pairs]


def _to_device(values, dtype, device) -> torch.Tensor:
    """Host values as a tensor on ``device``, copied without a host sync
    (a non-blocking copy from host memory), so that a chain's set-up stays
    off the host's clock."""
    t = torch.as_tensor(np.asarray(values), dtype=dtype)
    return t.to(device, non_blocking=True)


def replica_normals(seeds, step0: int, n_steps: int, rows: int, half: int,
                    device) -> torch.Tensor:
    """(n_steps, R, rows, 2 half) float32 standard normals: entry [s, r] is
    ``splitmix_noise_plain(seeds[r], step0 + s, 2 half, rows=rows)``, the
    counter stream of replica r's seed at its step.  ``seeds`` is a list or
    an int64 tensor on ``device``."""
    seed = (seeds if torch.is_tensor(seeds) else
            _to_device([int(s) & _MASK32 for s in seeds], torch.int64, device))
    steps = torch.arange(step0, step0 + n_steps, dtype=torch.int64,
                         device=device)
    return splitmix_noise_plain(seed[None, :], steps[:, None], 2 * half,
                                device, rows=rows)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class _Noise:
    """A block's O-step noise, step by step: drawn from the replicas'
    stream seeds in blocks of steps, or taken from ``given``, an
    (n_steps, R, *shape) tensor.  ``shape`` is (3, n_pad) for the lane
    layout and (N, 3) otherwise."""

    def __init__(self, seeds, n_steps, shape, device, given=None):
        self.seeds, self.n_steps, self.shape = list(seeds), n_steps, shape
        self.device, self.given = device, given
        if shape[0] == 3 and shape[1] % (2 * _LANE_ALIGN) == 0:
            self.rows, self.half = 3, shape[1] // 2  # the lane layout
        else:
            count = shape[0] * shape[1]
            self.rows, self.half = 1, _round_up((count + 1) // 2, _LANE_ALIGN)
        lanes = len(self.seeds) * self.rows * self.half * 2
        self.block = max(1, min(n_steps, _NOISE_LANES // max(lanes, 1)))
        self.seed_t = (None if given is not None else _to_device(
            [int(x) & _MASK32 for x in self.seeds], torch.int64, device))

    def __iter__(self):
        if self.given is not None:
            if tuple(self.given.shape[2:]) != tuple(self.shape) or \
                    self.given.shape[0] < self.n_steps:
                raise ValueError(
                    f"noise: shape {tuple(self.given.shape)}, expected "
                    f"({self.n_steps}, {len(self.seeds)}, *{self.shape})")
            yield from self.given[:self.n_steps]
            return
        R = len(self.seeds)
        count = self.shape[0] * self.shape[1]
        for s0 in range(0, self.n_steps, self.block):
            nb = min(self.block, self.n_steps - s0)
            with span("chiron.pt.noise"):
                z = replica_normals(self.seed_t, s0, nb, self.rows,
                                    self.half, self.device)
                if self.rows == 1:
                    z = z.reshape(nb, R, -1)[:, :, :count].reshape(
                        nb, R, *self.shape)
            yield from z


def _coefficients(timestep: float, collision_rate: float):
    """(dt / 2, a, b) of BAOAB in float32, as JAX computes them."""
    dt = torch.tensor(timestep, dtype=torch.float32)
    a = torch.exp(-collision_rate * dt)
    b = torch.sqrt(1.0 - torch.exp(-2.0 * collision_rate * dt))
    return float(dt * 0.5), float(a), float(b)


def block_energy_fn(potential, pairs=None) -> Callable:
    """``(x, box, list_state) -> (R,)`` energies of a block of replicas
    (``x`` (R, N, 3), ``box`` (R, 3, 3) or None, ``list_state`` the block's
    pair-list state or None).  The harmonic and ideal-gas potentials take
    the block in one pass; any other loops over the replicas (each with its
    own box in a pair-list state)."""
    if isinstance(potential, HarmonicOscillatorPotential):
        k, U0 = potential.k, potential.U0
        x0_on = {}  # x0 on each device, copied there once

        def harmonic(x, box, list_state):
            if x.device not in x0_on:
                x0_on[x.device] = potential.x0.to(x.device)
            return 0.5 * k * torch.sum((x - x0_on[x.device]) ** 2,
                                       dim=(1, 2)) + U0
        return harmonic
    if isinstance(potential, IdealGasPotential):
        def ideal_gas(x, box, list_state):
            return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        return ideal_gas
    return _replica_by_replica(potential.make_energy_fn(pairs))


def _replica_by_replica(energy_fn):
    """A block's energies from ``energy_fn(x, list_state)`` on each replica,
    each with its own box in a pair-list state."""
    def looped(x, box, list_state):
        def state(r):
            if isinstance(list_state, PairListState) and box is not None:
                return replace(list_state, box_vectors=box[r])
            return list_state
        return torch.stack([energy_fn(x[r], state(r))
                            for r in range(x.shape[0])])
    return looped


def make_pt_chain_fn(
    energy_fn: Callable,
    masses: torch.Tensor,
    timestep: float,
    collision_rate: float,
    pairs=None,
    block_energy: Optional[Callable] = None,
) -> Callable:
    """BAOAB chain over a block of replicas with the temperature as data.

    Returns ``chain(x, v, seeds, box, list_state, kT, n_steps, noise=None)
    -> (x, v, list_state, U, overflowed)``: ``x``, ``v`` (R, N, 3),
    ``seeds`` the R stream seeds (``split_keys``), ``box`` (R, 3, 3) or
    None, ``kT`` (R,), ``noise`` None or (n_steps, R, N, 3); ``U`` and
    ``overflowed`` are (R,).  ``list_state`` is the pair scheme's: one
    ``PairListState`` for the block (each replica's box from ``box``), a
    list of R ``NeighborListState`` (the Verlet chain runs one replica at
    a time, rebuilding on the host's read of the predicate), or None.
    ``masses`` is (N, 1) on the state's device.  The force of the block is
    one backward pass through ``block_energy`` (``block_energy_fn``; by
    default ``energy_fn`` on each replica), so each replica gets the
    gradient of its own energy.
    """
    hdt, a, b = _coefficients(timestep, collision_rate)
    has_nbr = isinstance(pairs, NeighborListNsqrd)
    space = (pairs.space if isinstance(pairs, (NeighborListNsqrd,
                                               PairListNsqrd)) else None)

    if has_nbr:
        def chain(x, v, seeds, box, list_state, kT, n_steps, noise=None):
            kT_host = _host(kT)
            out = [_verlet_replica(
                energy_fn, masses, timestep, collision_rate, pairs, x[r],
                v[r], seeds[r], None if box is None else box[r],
                list_state[r], float(kT_host[r]), n_steps,
                None if noise is None else noise[:, r])
                for r in range(x.shape[0])]
            return (torch.stack([o[0] for o in out]),
                    torch.stack([o[1] for o in out]),
                    [o[2] for o in out], torch.stack([o[3] for o in out]),
                    torch.stack([o[4] for o in out]))
        return chain

    if block_energy is None:
        block_energy = _replica_by_replica(energy_fn)

    def forces(x, box, list_state):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            energy = block_energy(xg, box, list_state).sum()
            return -grad_of(energy, xg)

    def chain(x, v, seeds, box, list_state, kT, n_steps, noise=None):
        R = x.shape[0]
        bs = b * torch.sqrt(kT.reshape(R, 1, 1) / masses)
        wrap_box = None if box is None else box[:, None]
        F = forces(x, box, list_state)
        for z in _Noise(seeds, n_steps, tuple(x.shape[1:]), x.device, noise):
            v = v + hdt * F / masses
            x = x + hdt * v
            v = a * v + bs * z
            x = x + hdt * v
            if space is not None:
                x = space.wrap(x, wrap_box)
            F = forces(x, box, list_state)
            v = v + hdt * F / masses
        with torch.no_grad():
            U = block_energy(x, box, list_state)
        return x, v, list_state, U, torch.zeros(R, dtype=torch.bool,
                                                 device=x.device)

    return chain


def _verlet_replica(energy_fn, masses, timestep, collision_rate, pairs, x, v,
                    seed, box, list_state, kT, n_steps, noise):
    """One replica's Verlet-list chain: the integrator's step function
    (``make_baoab_step_fn``) fed the replica's noise."""
    step = make_baoab_step_fn(energy_fn, masses, timestep, collision_rate,
                              kT, pairs=pairs)
    carry = LangevinCarry(
        x=x, v=v, F=force_of(energy_fn, x, list_state), box_vectors=box,
        overflowed=torch.zeros((), dtype=torch.bool, device=x.device),
        key=0, nbr_state=list_state)
    given = None if noise is None else noise[:, None]
    for z in _Noise([seed], n_steps, tuple(x.shape), x.device, given):
        carry = step(carry, z[0])
    U = energy_fn(carry.x, carry.nbr_state)
    return carry.x, carry.v, carry.nbr_state, U.detach(), carry.overflowed


def make_pt_dense_chain_fn(
    op,
    m_lane: torch.Tensor,
    timestep: float,
    collision_rate: float,
    exact_forces: bool = False,
) -> Callable:
    """BAOAB chain over a block of replicas on K1 over replicas.

    State in the kernel's (R, 3, n_pad) lane layout, ``box_diag`` (R, 1, 3);
    signature as :func:`make_pt_chain_fn` (``list_state`` passes through).
    A step is one launch of K1 over the block (``op.force_only_r``, the
    approximate reciprocal unless ``exact_forces``) and about 17 batched
    elementwise operations; U is K1's exact energy, one more launch.
    Padding lanes (masses 1) take velocities and noise as JAX's do; K1
    ignores them.
    """
    hdt, a, b = _coefficients(timestep, collision_rate)
    approx = not exact_forces

    def chain(x3, v3, seeds, box_diag, list_state, kT, n_steps, noise=None):
        R = x3.shape[0]
        bs = b * torch.sqrt(kT.reshape(R, 1, 1) / m_lane)
        L = box_diag.reshape(R, 3, 1)
        F = op.force_only_r(x3, box_diag, approx_recip=approx)
        for z in _Noise(seeds, n_steps, tuple(x3.shape[1:]), x3.device,
                        noise):
            v3 = v3 + hdt * F / m_lane
            x3 = x3 + hdt * v3
            v3 = a * v3 + bs * z
            x3 = x3 + hdt * v3
            x3 = x3 - torch.floor(x3 / L) * L
            F = op.force_only_r(x3, box_diag, approx_recip=approx)
            v3 = v3 + hdt * F / m_lane
        _, U = op.force_energy_r(x3, box_diag)
        return x3, v3, list_state, U, torch.zeros(R, dtype=torch.bool,
                                                   device=x3.device)

    return chain


def _stack_states(states):
    """One state of the dataclass of ``states`` with every tensor field
    stacked on a leading axis (None fields stay None)."""
    s0 = states[0]
    return type(s0)(**{
        f.name: (None if getattr(s0, f.name) is None else
                 torch.stack([getattr(s, f.name) for s in states]))
        for f in fields(s0)})


def _unstack_state(state, r):
    return type(state)(**{
        f.name: (None if getattr(state, f.name) is None
                 else getattr(state, f.name)[r]) for f in fields(state)})


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class ParallelTemperingSampler:
    """Parallel tempering with the replicas split over the port's mesh.

    Parameters
    ----------
    potential
        A potential shared by all replicas (temperatures differ).
    temperatures
        The ladder, one entry per replica (Quantity or kelvin floats).
    timestep, collision_rate
        Langevin parameters (Quantity or MD-unit floats).
    pairs
        Optional ``NeighborListNsqrd`` / ``PairListNsqrd`` (a template;
        per-replica states are built on the device).
    mesh
        The port's ``Mesh`` (``make_replica_mesh``); its device holds this
        process's replicas.  Default: ``make_replica_mesh(device=device)``.
        ``len(temperatures)`` must divide by the mesh size.
    device
        The device of the default mesh: the card unless the caller asks
        for the CPU.
    """

    def __init__(
        self,
        potential,
        temperatures: List,
        timestep=2.0 * units.femtoseconds,
        collision_rate=1.0 / units.picoseconds,
        pairs=None,
        mesh: Optional[Mesh] = None,
        reporter=None,
        *,
        device="cuda",
    ):
        self.potential = potential
        self.temps_md = np.array(
            [units.strip_md(t, units.kelvin) for t in temperatures],
            dtype=np.float32,
        )
        # the ladder lives on the host (float32, as JAX's kTs): a swap
        # sweep reads nothing from the device but the U vector
        self.kTs = self.temps_md * units.kB_MD
        self.n_replicas = len(self.temps_md)
        self.timestep = units.strip_md(timestep, units.picosecond)
        self.collision_rate = units.strip_md(
            collision_rate, 1.0 / units.picosecond
        )
        self.pairs = pairs
        self.mesh = mesh if mesh is not None else make_replica_mesh(
            device=device)
        n_dev = self.mesh.size
        if self.n_replicas % n_dev != 0:
            raise ValueError(
                f"Number of replicas ({self.n_replicas}) must be divisible "
                f"by the mesh size ({n_dev})."
            )
        self.device = self.mesh.device
        self._local = replica_sharding(self.mesh).local_slice(self.n_replicas)
        self._chain = None
        self._dense_op = None
        self._u_history: List[np.ndarray] = []
        self._temp_history: List[np.ndarray] = []
        self.n_accepted_swaps = 0
        self.n_proposed_swaps = 0
        self._iteration = 0
        self._estimator = MBAREstimator()
        self._reporter = reporter
        self._swap_seed = 0

    @property
    def n_local(self) -> int:
        """Replicas held by this process."""
        return self._local.stop - self._local.start

    # -- setup ---------------------------------------------------------------
    def initialize(self, positions, box_vectors=None, masses=None,
                   seed: int = 1234, dense: Optional[bool] = None):
        """Stack R copies of the initial configuration (this process's block
        of them) and build the pair states.

        ``dense=None`` picks the dense chain on K1 over replicas when no
        pair scheme was given, the potential is an LJ potential and the
        system is periodic.  Each replica's key is a child of
        ``utils.prng_key(seed)``; its velocities come from that key's
        stream, and the key is split once before its first propagation, as
        JAX's ``initialize`` does.
        """
        if dense is None:
            dense = (
                self.pairs is None
                and box_vectors is not None
                and hasattr(self.potential, "sigma")
                and hasattr(self.potential, "cutoff")
            )
        R = self.n_replicas
        keys = list(utils.split(utils.prng_key(seed), R + 1)[1:])
        v_seeds = [stream_seed(k) for k in keys]
        self.keys = [utils.split(k)[0] for k in keys]
        x0 = torch.as_tensor(
            np.array(units.strip_md(positions, units.nanometer),
                     dtype=np.float32), device=self.device)
        if masses is None:
            masses = self.potential.topology.masses()
        masses = np.asarray(masses, dtype=np.float32)
        kT = self._local_kTs()
        if dense:
            return self._initialize_dense(x0, box_vectors, masses, v_seeds,
                                          kT)
        self.masses = torch.as_tensor(masses, device=self.device)[:, None]
        n = x0.shape[0]
        self.positions = x0[None].repeat(self.n_local, 1, 1)
        z = next(iter(_Noise(v_seeds[self._local], 1, (n, 3), self.device)))
        self.velocities = torch.sqrt(kT[:, None, None] / self.masses) * z

        box = None
        if box_vectors is not None:
            box = torch.as_tensor(
                np.array(units.strip_md(box_vectors, units.nanometer),
                         dtype=np.float32), device=self.device)
            self.box_vectors = box[None].repeat(self.n_local, 1, 1)
        else:
            self.box_vectors = None

        if isinstance(self.pairs, NeighborListNsqrd):
            # the capacity is sized on the host build (grow-retry), then
            # each replica's state is built with it
            self.pairs.build(x0, box)
            self.list_state = [
                neighbor_build_fn(x, box, self.pairs.cutoff_md
                                  + self.pairs.skin_md, self.pairs.space,
                                  self.pairs.n_max_neighbors)
                for x in self.positions]
        elif isinstance(self.pairs, PairListNsqrd):
            self.pairs.build(x0, box)
            self.list_state = pairlist_build_fn(x0, box)
        else:
            self.list_state = None
        self._chain = make_pt_chain_fn(
            self.potential.make_energy_fn(self.pairs), self.masses,
            self.timestep, self.collision_rate, pairs=self.pairs,
            block_energy=block_energy_fn(self.potential, self.pairs),
        )

    def _initialize_dense(self, x0, box_vectors, masses, v_seeds, kT):
        """Dense setup: this process's block in the (R_local, 3, n_pad)
        layout, JAX's padding rule (tm = min(512, max(128, round_up(n,
        128))), tn 512)."""
        from ..ops.lj_dense import LJDense

        n = x0.shape[0]
        op = LJDense(
            n=n,
            sigma=self.potential.sigma,
            epsilon=self.potential.epsilon,
            cutoff=self.potential.cutoff,
            tm=min(512, max(128, _round_up(n, 128))),
            tn=512,
            device=self.device,
        )
        self._dense_op = op
        n_pad = op.n_pad
        m_lane = torch.ones((1, n_pad), dtype=torch.float32,
                            device=self.device)
        m_lane[0, :n] = torch.as_tensor(masses, device=self.device)
        self.masses = m_lane
        self.positions = op.pad_positions(x0)[None].repeat(self.n_local, 1, 1)
        z = next(iter(_Noise(v_seeds[self._local], 1, (3, n_pad),
                             self.device)))
        self.velocities = torch.sqrt(kT[:, None, None] / m_lane[None]) * z
        box = np.array(units.strip_md(box_vectors, units.nanometer),
                       dtype=np.float32)
        diag = torch.as_tensor(np.diagonal(box).copy(), device=self.device)
        self.box_vectors = diag.reshape(1, 1, 3).repeat(self.n_local, 1, 1)
        self.list_state = None
        self._chain = make_pt_dense_chain_fn(
            op, m_lane, self.timestep, self.collision_rate)

    def _local_kTs(self) -> torch.Tensor:
        return _to_device(self.kTs[self._local], torch.float32, self.device)

    # -- collectives ----------------------------------------------------------
    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """This process's block of a replica-leading tensor, all-gathered
        into the whole (R, ...) tensor on every process."""
        if self.mesh.group is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.mesh.size)]
        dist.all_gather(parts, t, group=self.mesh.group)
        return torch.cat(parts)

    # -- one iteration --------------------------------------------------------
    def _advance(self, n_steps: int):
        """Propagate this process's block ``n_steps`` steps and return its
        (U, overflowed) on the device, with no host sync: every key is
        split on the host (all R, so that the processes agree), the local
        replicas' seeds go to the chain."""
        self.keys, seeds = split_keys(self.keys)
        x, v, ls, U, over = self._chain(
            self.positions, self.velocities, seeds[self._local],
            self.box_vectors, self.list_state, self._local_kTs(), n_steps)
        self.positions, self.velocities, self.list_state = x, v, ls
        return U, over

    def propagate(self, n_steps: int) -> np.ndarray:
        """Advance every replica ``n_steps`` BAOAB steps; returns the (R,)
        float32 energies, gathered over the mesh with the overflow flags
        and read once."""
        U, over = self._advance(n_steps)
        packed = self._gather(torch.stack([U.to(torch.float32),
                                           over.to(torch.float32)], dim=1))
        with span("chiron.sync.energies"):
            host = _host(packed)
        if host[:, 1].any():
            raise RuntimeError(
                "Neighbor capacity exceeded in a replica; increase "
                "n_max_neighbors."
            )
        return host[:, 0].copy()

    def mix_replicas(self, U: np.ndarray, rng: np.random.Generator):
        """Even/odd temperature-ladder swap sweep on the host, JAX's
        arithmetic: float32 betas, ranks by ``argsort``, accept where
        ``log_p >= 0 or rng.uniform() < exp(log_p)``; velocities follow
        their temperature, rescaled by sqrt(T_new / T_old)."""
        old_kTs = np.asarray(self.kTs)
        betas = 1.0 / old_kTs
        rank_of = np.argsort(old_kTs)
        offset = self._iteration % 2
        kTs = old_kTs.copy()
        for s in range(offset, self.n_replicas - 1, 2):
            i, j = rank_of[s], rank_of[s + 1]
            log_p = (betas[i] - betas[j]) * (U[i] - U[j])
            self.n_proposed_swaps += 1
            if log_p >= 0 or rng.uniform() < math.exp(log_p):
                kTs[i], kTs[j] = kTs[j], kTs[i]
                self.n_accepted_swaps += 1
        scale = np.sqrt(kTs / old_kTs)
        self.velocities = self.velocities * _to_device(
            scale[self._local], torch.float32, self.device)[:, None, None]
        self.kTs = kTs

    # -- the run loop -------------------------------------------------------
    def run(self, n_iterations: int, steps_per_iteration: int = 100,
            seed=None):
        """PT loop: propagate -> record energies -> swap.

        The swap stream is ``default_rng([seed, iteration])``, so a session
        restored from :meth:`save_session` continues bit for bit;
        ``seed=None`` keeps the current swap seed (the one
        :meth:`load_session` restored).
        """
        seed = self._swap_seed if seed is None else seed
        self._swap_seed = seed
        for _ in range(n_iterations):
            with span("chiron.pt.iteration"):
                self._iteration += 1
                with span("chiron.pt.propagate"):
                    U = self.propagate(steps_per_iteration)
                self._u_history.append(U)
                self._temp_history.append(np.asarray(self.kTs).copy())
                with span("chiron.pt.report"):
                    self._report_iteration(U)
                rng = np.random.default_rng([seed, self._iteration])
                with span("chiron.pt.swap"):
                    self.mix_replicas(U, rng)
        if self._reporter is not None:
            self._reporter.flush_buffer()
        return self

    # -- reporting --------------------------------------------------------
    def _report_iteration(self, U: np.ndarray):
        """MultistateReporter integration: u_kn, state_index, step, and the
        replicas' positions and boxes (gathered: every process of a mesh
        reports, each to its own reporter)."""
        if self._reporter is None:
            return
        betas_ladder = 1.0 / np.sort(self.temps_md * units.kB_MD)
        data = {}
        props = self._reporter.properties_to_report
        if "u_kn" in props:
            data["u_kn"] = betas_ladder[:, None] * np.asarray(U)[None, :]
        if "state_index" in props:
            data["state_index"] = np.argsort(np.argsort(np.asarray(self.kTs)))
        if "step" in props:
            data["step"] = np.asarray(self._iteration)
        if "positions" in props:
            data["positions"] = self.replica_positions()
        if "box_vectors" in props and self.box_vectors is not None:
            b = _host(self._gather(self.box_vectors))
            if b.shape[1:] == (1, 3):  # the dense path keeps box diagonals
                boxes = np.zeros((b.shape[0], 3, 3), b.dtype)
                for a in range(3):
                    boxes[:, a, a] = b[:, 0, a]
                data["box_vectors"] = boxes
            else:
                data["box_vectors"] = b
        self._reporter.report(data)

    def replica_positions(self) -> np.ndarray:
        """(R, N, 3) positions of every replica (gathered over the mesh)."""
        x = _host(self._gather(self.positions))
        if self._dense_op is not None:
            return np.transpose(x[:, :, :self._dense_op.n], (0, 2, 1))
        return x

    # -- session checkpoint -------------------------------------------------
    def _session_tree(self) -> dict:
        """The session in JAX's layout: the whole replica axis, gathered."""
        R = self.n_replicas
        if isinstance(self.list_state, list):
            ls = _stack_states(self.list_state)
            ls = type(ls)(**{f.name: (None if getattr(ls, f.name) is None
                                      else self._gather(getattr(ls, f.name)))
                             for f in fields(ls)})
        elif isinstance(self.list_state, PairListState):
            ls = _stack_states([self.list_state] * R)
        elif self._dense_op is not None:
            ls = np.zeros((R, 1), np.float32)  # JAX's dummy
        else:
            ls = np.zeros((R, 0), np.float32)
        return {
            "positions": _host(self._gather(self.positions)),
            "velocities": _host(self._gather(self.velocities)),
            "keys": np.array(self.keys, dtype=np.uint64),
            "kTs": np.asarray(self.kTs, dtype=np.float32),
            "box_vectors": (
                _host(self._gather(self.box_vectors))
                if self.box_vectors is not None
                else np.zeros((R, 0, 0), np.float32)
            ),
            "list_state": ls,
            "u_history": (np.stack(self._u_history) if self._u_history
                          else np.zeros((0, R), np.float32)),
            "temp_history": (np.stack(self._temp_history)
                             if self._temp_history
                             else np.zeros((0, R), np.float32)),
        }

    def save_session(self, path: str):
        """Persist the whole session (replica state, kT ladder, swap
        statistics, keys, histories) in JAX's checkpoint layout, so that
        :meth:`load_session` continues bit for bit.  Every process of a
        mesh takes part in the gathers; process 0 writes."""
        from ..checkpoint import save_checkpoint

        tree = self._session_tree()
        if self.mesh.rank != 0:
            return
        save_checkpoint(path, tree, metadata={
            "iteration": int(self._iteration),
            "n_accepted_swaps": int(self.n_accepted_swaps),
            "n_proposed_swaps": int(self.n_proposed_swaps),
            "swap_seed": int(self._swap_seed),
            "n_replicas": int(self.n_replicas),
        })

    def load_session(self, path: str, keys=None):
        """Restore a session saved by :meth:`save_session` of either
        package into this (identically constructed and initialized)
        sampler; returns the metadata.

        A session the JAX package wrote holds threefry keys, which have no
        counterpart here: pass ``keys``, R integer keys, to continue it
        (they replace a port file's keys too).  The Verlet lists are the
        file's (a port file) or rebuilt from the positions (a JAX file).
        """
        from ..checkpoint import load_checkpoint

        tree, meta = load_checkpoint(path, like=self._session_tree())
        R = self.n_replicas
        if meta.get("n_replicas") != R:
            raise ValueError(
                f"checkpoint has {meta.get('n_replicas')} replicas, "
                f"sampler has {R}"
            )
        saved_keys = np.asarray(tree["keys"])
        if keys is not None:
            if len(keys) != R:
                raise ValueError(f"keys: {len(keys)} keys for {R} replicas")
            self.keys = [int(k) for k in keys]
        elif saved_keys.shape == (R,) and saved_keys.dtype == np.uint64:
            self.keys = [int(k) for k in saved_keys]
        else:
            raise ValueError(
                f"the session's keys (shape {saved_keys.shape}, "
                f"{saved_keys.dtype}) are JAX keys: pass keys=<R ints>")
        loc = self._local

        def local(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32)[loc],
                                   device=self.device).contiguous()

        self.positions = local(tree["positions"])
        self.velocities = local(tree["velocities"])
        self.kTs = np.asarray(tree["kTs"], dtype=np.float32)
        if self.box_vectors is not None:
            self.box_vectors = local(tree["box_vectors"])
        if isinstance(self.list_state, list):
            ls = tree["list_state"]
            if isinstance(ls, NeighborListState):
                self.list_state = [
                    _unstack_state(ls, r) for r in range(loc.start, loc.stop)]
            else:
                self._rebuild_lists()
        self._u_history = [np.asarray(r) for r in tree["u_history"]]
        self._temp_history = [np.asarray(r) for r in tree["temp_history"]]
        self._iteration = meta["iteration"]
        self.n_accepted_swaps = meta["n_accepted_swaps"]
        self.n_proposed_swaps = meta["n_proposed_swaps"]
        self._swap_seed = meta["swap_seed"]
        return meta

    def _rebuild_lists(self):
        self.list_state = [
            neighbor_build_fn(
                x, None if self.box_vectors is None else self.box_vectors[r],
                self.pairs.cutoff_md + self.pairs.skin_md, self.pairs.space,
                self.pairs.n_max_neighbors)
            for r, x in enumerate(self.positions)]

    @property
    def swap_acceptance_fraction(self) -> float:
        if self.n_proposed_swaps == 0:
            return 0.0
        return self.n_accepted_swaps / self.n_proposed_swaps

    # -- analysis -------------------------------------------------------------
    def compute_free_energies(self, discard_fraction: float = 0.2) -> np.ndarray:
        """MBAR free energies of the temperature ladder from the PT samples:
        u_kn[s, n] = beta_s U_n over every recorded sample, one sample a
        temperature an iteration."""
        n_total = len(self._u_history)
        start = int(n_total * discard_fraction)
        kept = self._u_history[start:]
        if not kept:
            raise ValueError(
                f"no PT samples to analyze: {n_total} recorded iterations, "
                f"discard_fraction={discard_fraction} leaves zero -- call "
                "run() first or lower the fraction"
            )
        Us = np.concatenate(kept)
        betas_ladder = 1.0 / (np.sort(self.temps_md) * units.kB_MD)
        u_kn = betas_ladder[:, None] * Us[None, :]
        n_samples_per_temp = len(kept)
        N_k = np.full(self.n_replicas, n_samples_per_temp)
        # columns are iteration-major (n = t R + r) and swap-mixed: the
        # bootstrap resamples iterations, not origin blocks
        self._estimator.initialize(
            u_kn, N_k,
            iteration_layout=(n_samples_per_temp, self.n_replicas),
            iteration_major=True,
        )
        return self._estimator.f_k

    @property
    def f_k(self) -> np.ndarray:
        return self._estimator.f_k

    @property
    def estimator(self):
        """The MBAREstimator behind :meth:`compute_free_energies` (its
        uncertainties, bootstrap with iteration resampling, overlap)."""
        return self._estimator
