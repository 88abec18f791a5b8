"""Langevin BAOAB integrator (port of ``chiron_tpu/integrators.py``).

``LangevinCarry`` is the state of one Langevin chain.  The dense fast runner
(``runtime.make_fast_lj_runner``) keeps it in the kernels' (3, n_pad) lane
layout with its own generator; the general API (``make_baoab_step_fn``,
``LangevinIntegrator``, ``runtime.make_langevin_runner``) keeps (N, 3)
tensors, the (3, 3) box, the integer PRNG key (``utils``) and the pair
scheme's state.

The step is a function of the carry: it splits the key, draws the O-step
noise on the carry's device (or takes it from the caller), and returns a new
carry.  The force is ``-grad`` of the potential's energy under autograd, so
on ``DensePairs`` it is K1's force bit for bit.  Where the carry's ``x``
requires grad the force is taken with ``create_graph``, so that a trajectory
stays differentiable (in the potential's parameters, say), as JAX's scan is
by construction; otherwise the step keeps no graph.

The neighbor list's rebuild is decided on the host: one ``.item()`` a step
reads the device predicate, the reference chiron's own cadence, where JAX
chooses inside ``lax.cond``.  Its capacity is read at step time, so a build
that regrew it is seen by a step function made before.  Reporting happens
at the reference's chunk boundaries.  Same seed, same trajectory on one
backend; the stream is not JAX's (``utils``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, replace
from typing import Callable, Optional

import torch

from . import units, utils
from .neighbors import (
    DensePairs,
    DensePairsState,
    NeighborListNsqrd,
    PairListNsqrd,
    neighbor_build_fn,
    neighbor_check_fn,
)
from .potential import grad_of, value_and_grad
from .states import SamplerState, ThermodynamicState

log = logging.getLogger("chiron_tpu_torch")


@dataclass
class LangevinCarry:
    """Full dynamic state of one Langevin chain.

    In the fast runner: ``x``, ``v`` and ``F`` are (3, n_pad) float32 in the
    kernels' lane layout, ``box_vectors`` the (1, 3) box diagonal, and
    ``generator`` (on the state's device) draws the noise.  In the general
    API: (N, 3) tensors, the (3, 3) box or None, the integer ``key`` and
    ``nbr_state``, the pair scheme's state (or None).  ``overflowed`` is a
    () bool, sticky.
    """

    x: torch.Tensor
    v: torch.Tensor
    F: torch.Tensor
    box_vectors: Optional[torch.Tensor]
    overflowed: torch.Tensor
    generator: Optional[torch.Generator] = None
    key: Optional[int] = None
    nbr_state: Optional[object] = None


def force_of(energy_fn: Callable, x: torch.Tensor, list_state) -> torch.Tensor:
    """-grad of ``energy_fn(x, list_state)``: with ``create_graph`` where
    ``x`` requires grad, and with no graph kept otherwise."""
    if x.requires_grad:
        return -grad_of(energy_fn(x, list_state), x, create_graph=True)
    return -value_and_grad(lambda p: energy_fn(p, list_state), x)[1]


def make_baoab_step_fn(
    energy_fn: Callable,
    masses: torch.Tensor,
    timestep: float,
    collision_rate: float,
    kT: float,
    pairs=None,
) -> Callable:
    """Build the BAOAB step ``(carry, noise=None) -> carry``.

    ``energy_fn(positions, list_state) -> energy`` as
    ``potential.make_energy_fn`` gives it; ``masses`` is (N, 1) on the
    carry's device.  ``noise``, (N, 3), replaces the draw from the carry's
    key (the key is split all the same).
    """
    dt = torch.tensor(timestep, dtype=torch.float32)
    a = torch.exp(-collision_rate * dt)
    b = torch.sqrt(1.0 - torch.exp(-2.0 * collision_rate * dt))
    sigma_v = torch.sqrt(kT / masses)
    half_dt = dt * 0.5

    has_nbr = isinstance(pairs, NeighborListNsqrd)
    if has_nbr:
        space = pairs.space
        cutoff_and_skin = pairs.cutoff_md + pairs.skin_md
        skin = pairs.skin_md
    elif isinstance(pairs, (PairListNsqrd, DensePairs)):
        space = pairs.space
    else:
        space = None

    def step(carry: LangevinCarry, noise=None) -> LangevinCarry:
        key, subkey = utils.split(carry.key)
        x, v, F = carry.x, carry.v, carry.F
        nbr_state = carry.nbr_state

        # B: half kick
        v = v + half_dt * F / masses
        # A: half drift
        x = x + half_dt * v
        # O: Ornstein-Uhlenbeck
        if noise is None:
            noise = utils.normal(subkey, x.shape, x.device, x.dtype)
        v = a * v + b * sigma_v * noise
        # A: half drift
        x = x + half_dt * v

        overflowed = carry.overflowed
        if space is not None:
            x = space.wrap(x, carry.box_vectors)
        if has_nbr:
            if neighbor_check_fn(nbr_state, x, skin, space).item():
                # the capacity is read now: a build may have regrown it
                nbr_state = neighbor_build_fn(
                    x.detach(), carry.box_vectors, cutoff_and_skin, space,
                    pairs.n_max_neighbors)
            overflowed = overflowed | nbr_state.overflow

        # B: the force, half kick
        F = force_of(energy_fn, x, nbr_state)
        v = v + half_dt * F / masses
        return LangevinCarry(x=x, v=v, F=F, box_vectors=carry.box_vectors,
                             overflowed=overflowed, key=key,
                             nbr_state=nbr_state)

    return step


def run_chunk(step_fn: Callable, carry: LangevinCarry,
              n_steps: int) -> LangevinCarry:
    """Advance ``n_steps`` BAOAB steps."""
    for _ in range(n_steps):
        carry = step_fn(carry)
    return carry


class LangevinIntegrator:
    """Host-facing Langevin integrator.  It runs on the device of the sampler
    state's tensors."""

    def __init__(
        self,
        timestep=1.0 * units.femtoseconds,
        collision_rate=1.0 / units.picoseconds,
        refresh_velocities: bool = False,
        report_interval: int = 100,
        reporter=None,
        save_traj_in_memory: bool = False,
    ) -> None:
        self.timestep = units.coerce(timestep)
        self.collision_rate = units.coerce(collision_rate)
        self.report_interval = report_interval
        self.reporter = reporter
        self.refresh_velocities = refresh_velocities
        self.save_traj_in_memory = save_traj_in_memory
        self.traj = []
        self.velocities = None
        self._move_iteration = 0
        if reporter is not None:
            log.info("Using reporter %s", reporter)

    def run(
        self,
        sampler_state: SamplerState,
        thermodynamic_state: ThermodynamicState,
        number_of_steps: int = 5_000,
        nbr_list=None,
        progress_bar: bool = False,
    ):
        """Run Langevin dynamics; returns ``(updated SamplerState,
        nbr_list)``.  ``reporter`` (any object with ``.report(dict)``) is
        called after every step whose elapsed index is a multiple of
        ``report_interval``; ``progress_bar`` prints progress there."""
        potential = thermodynamic_state.potential
        device = sampler_state.positions.device
        masses = utils.masses_md(potential.topology, device)

        temperature = thermodynamic_state.temperature
        kT = units.kB_MD * float(
            temperature.value_in_unit_system(units.md_unit_system))
        dt = float(self.timestep.value_in_unit_system(units.md_unit_system))
        gamma = float(
            self.collision_rate.value_in_unit_system(units.md_unit_system))

        key = sampler_state.new_PRNG_key

        # The init draw takes its own subkey, so the chain's first O-step
        # noise is independent of the velocity sample.
        if (
            self.refresh_velocities
            or sampler_state.velocities is None
            or sampler_state.velocities.shape[0] != sampler_state.positions.shape[0]
        ):
            key, vkey = utils.split(key)
            sampler_state.velocities = utils.initialize_velocities(
                temperature, potential.topology, vkey, device)

        x0 = sampler_state.positions
        v0 = sampler_state.velocities
        box = sampler_state.box_vectors

        if nbr_list is not None:
            nbr_list.build_from_state(sampler_state)

        # The list state travels in the carry, so the box and the tables
        # are always current data.
        if isinstance(nbr_list, NeighborListNsqrd):
            nbr_state = nbr_list.state
        elif isinstance(nbr_list, PairListNsqrd):
            nbr_state = replace(nbr_list.state, box_vectors=box)
        elif isinstance(nbr_list, DensePairs):
            nbr_state = DensePairsState(box_vectors=box)
        else:
            nbr_state = None

        # The step function is kept while what it closes over is unchanged,
        # so repeated runs (an MCMC loop's) reuse it.
        cache_key = (
            potential.cache_token() if hasattr(potential, "cache_token")
            else id(potential),
            type(nbr_list).__name__ if nbr_list is not None else None,
            type(getattr(nbr_list, "space", None)).__name__,
            getattr(nbr_list, "cutoff_md", None),
            getattr(nbr_list, "skin_md", None),
            x0.shape[0], dt, gamma, kT, str(device),
            masses.cpu().numpy().tobytes(),
        )
        if getattr(self, "_step_cache_key", None) != cache_key:
            if nbr_list is None:
                try:
                    energy_fn = potential.make_energy_fn(None)
                except (TypeError, NotImplementedError):
                    def energy_fn(x, s):
                        return potential.compute_energy(x, None)
            else:
                energy_fn = potential.make_energy_fn(nbr_list)
            self._step_cache_key = cache_key
            self._step_fn = make_baoab_step_fn(energy_fn, masses, dt, gamma,
                                               kT, pairs=nbr_list)
            self._energy_fn = energy_fn
        step_fn = self._step_fn

        carry = LangevinCarry(
            x=x0, v=v0, F=force_of(self._energy_fn, x0, nbr_state),
            box_vectors=box,
            overflowed=torch.zeros((), dtype=torch.bool, device=device),
            key=key, nbr_state=nbr_state,
        )

        # Chunk boundaries give the reference's report cadence: a report
        # after every step where elapsed_step % report_interval == 0.
        r = self.report_interval
        elapsed_base = self._move_iteration * number_of_steps
        boundaries = [s for s in range(number_of_steps)
                      if (s + elapsed_base) % r == 0]
        step_index = -1
        for target in boundaries + [number_of_steps - 1]:
            n = target - step_index
            if n <= 0:
                continue
            carry = run_chunk(step_fn, carry, n)
            step_index = target
            elapsed_step = step_index + elapsed_base
            if progress_bar:
                print(f"\rLangevin {step_index + 1}/{number_of_steps} steps",
                      end="", flush=True)
            if elapsed_step % r == 0:
                if self.reporter is not None:
                    self._report(carry, potential, nbr_list, step_index,
                                 self._move_iteration, elapsed_step)
                if self.save_traj_in_memory:
                    self.traj.append(carry.x)

        if progress_bar:
            print()
        if bool(carry.overflowed):
            raise RuntimeError(
                "Neighbor list capacity exceeded during on-device propagation; "
                "increase n_max_neighbors (or the skin) and rerun."
            )

        sampler_state.positions = carry.x
        sampler_state.velocities = carry.v
        sampler_state.current_PRNG_key = carry.key
        if isinstance(nbr_list, NeighborListNsqrd):
            nbr_list._state = carry.nbr_state
        return sampler_state, nbr_list

    def _report(self, carry, potential, nbr_list, step, iteration, elapsed_step):
        if isinstance(nbr_list, NeighborListNsqrd):
            nbr_list._state = carry.nbr_state
        d = {
            "positions": carry.x,
            "potential_energy": potential.compute_energy(carry.x, nbr_list),
            "step": step,
            "iteration": iteration,
            "elapsed_step": elapsed_step,
        }
        if nbr_list is not None:
            d["box_vectors"] = carry.box_vectors
        self.reporter.report(d)
