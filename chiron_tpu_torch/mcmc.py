"""Markov-chain Monte Carlo moves and sampler (port of ``chiron_tpu/mcmc.py``).

JAX compiles each move's chain into one ``lax.scan``; here the chain is a
Python loop of device operations with the same carry (:class:`MCCarry`):

* the proposal, the energy, the NaN guard, the Metropolis decision, the
  statistics and the autotune stay on the device as ``torch.where``, so on
  ``DensePairs`` and ``PairListNsqrd`` a chain makes no host sync at all;
  the per-step records are stacked and moved to the host once an update;
* on ``NeighborListNsqrd`` the rebuild predicate is read on the host, one
  ``.item()`` a step, where JAX chooses inside ``lax.cond`` (the port's
  integrator does the same);
* each step splits the integer key into three on the host (``utils``): the
  proposal noise is ``utils.normal`` of the first child, the volume and the
  acceptance uniforms come from a ``torch.Generator`` on the device seeded
  with theirs.  The step functions also take their draws from the caller
  (``step(carry, draws)``), which is how the tests feed JAX's draws to both
  packages.

The arithmetic is JAX's, in float32: ``uniform < exp(min(log_ratio, 0))``,
``pow(V'/V, 1/3)``, ``N ln(V'/V)``, and the autotune windows (x1.1 and
/1.1 on the cumulative acceptance, the division as XLA compiles it; the
barostat's cap of 0.3 on its increase branch only, so a restored value
above 0.3 stays unclamped).
"""

from __future__ import annotations

import copy
import logging
from dataclasses import dataclass, fields, replace
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from . import units, utils
from .neighbors import (
    DensePairs,
    NeighborListNsqrd,
    PairListNsqrd,
    PairsBase,
    neighbor_build_fn,
    neighbor_check_fn,
)
from .states import SamplerState, ThermodynamicState

log = logging.getLogger("chiron_tpu_torch")


# ---------------------------------------------------------------------------
# Functional core
# ---------------------------------------------------------------------------


@dataclass
class MCCarry:
    """State of a Metropolis chain: tensors on one device, and the integer
    PRNG key."""

    positions: torch.Tensor
    box_vectors: Optional[torch.Tensor]
    key: int
    reduced_potential: torch.Tensor  # () f32
    list_state: Optional[object]  # NeighborListState | PairListState | ...
    n_accepted: torch.Tensor  # () int32, cumulative across updates
    n_proposed: torch.Tensor  # () int32
    param: torch.Tensor  # () f32: displacement sigma or volume_max_scale
    overflowed: torch.Tensor  # () bool


def _uniform(key: int, device) -> torch.Tensor:
    """A () f32 uniform in [0, 1) from a generator on ``device`` seeded with
    ``key``.  On an H100 ``chip_profile.py --mc`` times a new generator a
    few us a draw above a held one re-seeded, about 1% of a proposal, so
    none is held."""
    gen = torch.Generator(device=device).manual_seed(int(key))
    return torch.rand((), generator=gen, device=device, dtype=torch.float32)


def _metropolis_accept(uniform, log_ratio, proposed_u):
    """The reference's acceptance rule with its NaN guard."""
    accept = (log_ratio >= 0.0) | (
        uniform < torch.exp(torch.clamp_max(log_ratio, 0.0)))
    return accept & ~torch.isnan(proposed_u)


def _select(accept, new, old):
    """``where(accept, new, old)`` over a tensor, a dataclass of tensors or
    None; a field that is one object on both sides is kept as it is."""
    if new is old or new is None:
        return new
    if torch.is_tensor(new):
        return torch.where(accept, new, old)
    return type(new)(**{f.name: _select(accept, getattr(new, f.name),
                                        getattr(old, f.name))
                        for f in fields(new)})


def _refresh_list_state(pairs, positions, box_vectors, list_state,
                        force: bool):
    """List maintenance of a proposal, per pair scheme: returns
    ``(list_state, overflow)``, ``overflow`` a () bool tensor or None."""
    if isinstance(pairs, NeighborListNsqrd):
        space = pairs.space
        cutoff_and_skin = pairs.cutoff_md + pairs.skin_md
        if force or neighbor_check_fn(list_state, positions, pairs.skin_md,
                                      space).item():
            # the capacity is read now: a retry may have grown it
            list_state = neighbor_build_fn(positions, box_vectors,
                                           cutoff_and_skin, space,
                                           pairs.n_max_neighbors)
        return list_state, list_state.overflow
    if isinstance(pairs, (PairListNsqrd, DensePairs)):
        # list-free or static structures: only the box rides along
        if list_state.box_vectors is box_vectors:
            return list_state, None
        return replace(list_state, box_vectors=box_vectors), None
    return list_state, None


# XLA simplifies ``x / 1.1`` to ``x * (1 / 1.1)`` with the reciprocal
# rounded to float32; the autotune's shrink is that product, bit for bit
_INV_1P1 = float(np.float32(1.0) / np.float32(1.1))


def make_displacement_step_fn(
    reduced_fn: Callable,
    pairs: Optional[PairsBase],
    atom_mask: Optional[torch.Tensor],
    autotune: bool,
    autotune_interval: int,
) -> Callable:
    """The Metropolis displacement step ``(carry, draws=None) -> (carry,
    record)``; ``draws`` is ``(noise (N, 3), uniform ())`` in place of the
    draws from the carry's key (the key is split all the same).

    ``reduced_fn(positions, box_vectors, list_state) -> u`` from
    ``ThermodynamicState.make_reduced_potential_fn``; ``atom_mask`` (N,)
    float32 (on any device) or None.
    """
    space = pairs.space if pairs is not None else None
    masks = {}

    def step(carry: MCCarry, draws=None):
        key, k_prop, k_acc = utils.split(carry.key, 3)
        x = carry.positions
        sigma = carry.param
        if draws is None:
            noise = utils.normal(k_prop, x.shape, x.device, x.dtype)
            uniform = _uniform(k_acc, x.device)
        else:
            noise, uniform = draws
        disp = noise * sigma
        if atom_mask is not None:
            if x.device not in masks:
                masks[x.device] = atom_mask.to(x.device)[:, None]
            disp = disp * masks[x.device]
        proposed = x + disp
        if space is not None:
            proposed = space.wrap(proposed, carry.box_vectors)

        list_state, overflow = _refresh_list_state(
            pairs, proposed, carry.box_vectors, carry.list_state, force=False)
        proposed_u = reduced_fn(proposed, carry.box_vectors, list_state)
        log_ratio = carry.reduced_potential - proposed_u
        accept = _metropolis_accept(uniform, log_ratio, proposed_u)

        positions = torch.where(accept, proposed, x)
        u = torch.where(accept, proposed_u, carry.reduced_potential)
        n_accepted = carry.n_accepted + accept.to(torch.int32)
        n_proposed = carry.n_proposed + 1

        if autotune:
            # the reference's rule: cumulative acceptance ratio, x1.1 above
            # 0.6, /1.1 below 0.4, every ``autotune_interval`` attempts
            ratio = n_accepted / torch.clamp_min(n_proposed, 1)
            due = (n_proposed % autotune_interval == 0) & (n_proposed > 0)
            sigma = torch.where(
                due & (ratio > 0.6), sigma * 1.1,
                torch.where(due & (ratio < 0.4),
                            sigma * _INV_1P1, sigma))

        new_carry = MCCarry(
            positions=positions,
            box_vectors=carry.box_vectors,
            key=key,
            reduced_potential=u,
            list_state=_select(accept, list_state, carry.list_state),
            n_accepted=n_accepted,
            n_proposed=n_proposed,
            param=sigma,
            overflowed=(carry.overflowed if overflow is None
                        else carry.overflowed | overflow),
        )
        record = {
            "reduced_potential": u,
            "param": sigma,
            "n_accepted": n_accepted,
            "n_proposed": n_proposed,
        }
        return new_carry, record

    return step


def make_barostat_step_fn(
    reduced_fn: Callable,
    pairs: Optional[PairsBase],
    nr_of_atoms: int,
    autotune: bool,
    autotune_interval: int,
) -> Callable:
    """The MC-barostat step ``(carry, draws=None) -> (carry, record)``: an
    isotropic volume move with the NpT acceptance ``-(u' - u) + N ln(V'/V)``
    (McDonald 1972).  ``draws`` is ``(volume uniform in [-1, 1), acceptance
    uniform)``."""

    def step(carry: MCCarry, draws=None):
        key, k_prop, k_acc = utils.split(carry.key, 3)
        vmax_scale = carry.param
        dev = carry.positions.device
        if draws is None:
            u_vol = _uniform(k_prop, dev) * 2.0 - 1.0
            uniform = _uniform(k_acc, dev)
        else:
            u_vol, uniform = draws

        volume = torch.prod(torch.diagonal(carry.box_vectors))
        delta_volume = u_vol * (vmax_scale * volume)
        proposed_volume = volume + delta_volume
        scale = torch.pow(proposed_volume / volume, 1.0 / 3.0)

        proposed = carry.positions * scale
        proposed_box = carry.box_vectors * scale

        # the box changed: the list is always refreshed
        list_state, overflow = _refresh_list_state(
            pairs, proposed, proposed_box, carry.list_state, force=True)
        proposed_u = reduced_fn(proposed, proposed_box, list_state)
        log_ratio = (carry.reduced_potential - proposed_u
                     + nr_of_atoms * torch.log(proposed_volume / volume))
        accept = _metropolis_accept(uniform, log_ratio, proposed_u)

        positions = torch.where(accept, proposed, carry.positions)
        box_vectors = torch.where(accept, proposed_box, carry.box_vectors)
        u = torch.where(accept, proposed_u, carry.reduced_potential)
        n_accepted = carry.n_accepted + accept.to(torch.int32)
        n_proposed = carry.n_proposed + 1

        if autotune:
            # the reference's rule: /1.1 below 0.25, x1.1 above 0.75, capped
            # at 0.3 on the increase only
            ratio = n_accepted / torch.clamp_min(n_proposed, 1)
            due = (n_proposed % autotune_interval == 0) & (n_proposed > 0)
            vmax_scale = torch.where(
                due & (ratio < 0.25), vmax_scale * _INV_1P1,
                torch.where(due & (ratio > 0.75),
                            torch.clamp_max(vmax_scale * 1.1, 0.3),
                            vmax_scale))

        new_carry = MCCarry(
            positions=positions,
            box_vectors=box_vectors,
            key=key,
            reduced_potential=u,
            list_state=_select(accept, list_state, carry.list_state),
            n_accepted=n_accepted,
            n_proposed=n_proposed,
            param=vmax_scale,
            overflowed=(carry.overflowed if overflow is None
                        else carry.overflowed | overflow),
        )
        record = {
            "reduced_potential": u,
            "param": vmax_scale,
            "n_accepted": n_accepted,
            "n_proposed": n_proposed,
            "volume": torch.prod(torch.diagonal(box_vectors)),
        }
        return new_carry, record

    return step


def run_mc_chain(step_fn: Callable, carry: MCCarry, n_steps: int,
                 draws=None):
    """Run ``n_steps`` proposals; returns ``(carry, records)``, each record
    stacked over the steps on the device.  ``draws``, a tuple of tensors
    with a leading axis of ``n_steps``, gives step ``i`` the draws
    ``tuple(d[i] for d in draws)``."""
    records = []
    with torch.no_grad():
        for i in range(n_steps):
            carry, rec = step_fn(
                carry, None if draws is None else tuple(d[i] for d in draws))
            records.append(rec)
    if not records:
        return carry, {}
    return carry, {k: torch.stack([r[k] for r in records])
                   for k in records[0]}


# ---------------------------------------------------------------------------
# Host-facing move classes
# ---------------------------------------------------------------------------


class MCMCMove:
    """Base move bookkeeping."""

    def __init__(
        self,
        number_of_moves: int,
        reporter=None,
        report_interval: Optional[int] = 100,
    ):
        self.number_of_moves = number_of_moves
        self.reporter = reporter
        self.report_interval = report_interval
        self._move_iteration = 0
        self._number_of_attempts_made = 0
        if self.reporter is not None:
            assert self.report_interval is not None
            log.info("Using reporter %s", self.reporter)

    def update(
        self,
        sampler_state: SamplerState,
        thermodynamic_state: ThermodynamicState,
        nbr_list: Optional[PairsBase] = None,
    ) -> Tuple[SamplerState, ThermodynamicState, Optional[PairsBase]]:
        raise NotImplementedError

    @property
    def number_of_attemps_made(self):
        # [sic] -- the reference's spelling
        return self._number_of_attempts_made


class LangevinDynamicsMove(MCMCMove):
    """Langevin dynamics as an MCMC move, on the port's
    ``LangevinIntegrator``."""

    def __init__(
        self,
        timestep=1.0 * units.femtoseconds,
        collision_rate=1.0 / units.picoseconds,
        refresh_velocities: bool = False,
        reporter=None,
        report_interval: int = 100,
        number_of_steps: int = 1_000,
        save_traj_in_memory: bool = False,
    ):
        super().__init__(
            number_of_moves=number_of_steps,
            reporter=reporter,
            report_interval=report_interval,
        )
        self.timestep = units.coerce(timestep)
        self.collision_rate = units.coerce(collision_rate)
        self.save_traj_in_memory = save_traj_in_memory
        self.traj = []
        from .integrators import LangevinIntegrator

        self.integrator = LangevinIntegrator(
            timestep=self.timestep,
            collision_rate=self.collision_rate,
            refresh_velocities=refresh_velocities,
            report_interval=report_interval,
            reporter=reporter,
            save_traj_in_memory=save_traj_in_memory,
        )

    def update(self, sampler_state, thermodynamic_state, nbr_list=None):
        assert isinstance(sampler_state, SamplerState), (
            f"Sampler state must be SamplerState, not {type(sampler_state)}"
        )
        assert isinstance(thermodynamic_state, ThermodynamicState), (
            f"Thermodynamic state must be ThermodynamicState, "
            f"not {type(thermodynamic_state)}"
        )
        updated_sampler_state, updated_nbr_list = self.integrator.run(
            sampler_state,
            thermodynamic_state,
            number_of_steps=self.number_of_moves,
            nbr_list=nbr_list,
        )
        self._number_of_attempts_made += self.number_of_moves
        if self.save_traj_in_memory:
            self.traj.append(self.integrator.traj)
            self.integrator.traj = []
        self._move_iteration += 1
        self.integrator._move_iteration = self._move_iteration
        return updated_sampler_state, thermodynamic_state, updated_nbr_list


class MCMove(MCMCMove):
    """Metropolis-Hastings base: owns the chain's step function."""

    def __init__(
        self,
        number_of_moves: int,
        reporter=None,
        report_interval: int = 1,
        autotune: bool = False,
        autotune_interval: int = 100,
        acceptance_method: str = "Metropolis-Hastings",
    ) -> None:
        super().__init__(
            number_of_moves=number_of_moves,
            reporter=reporter,
            report_interval=report_interval,
        )
        if acceptance_method != "Metropolis-Hastings":
            raise ValueError(
                f"Unsupported acceptance method: {acceptance_method}"
            )
        self.acceptance_method = acceptance_method
        self.autotune = autotune
        self.autotune_interval = autotune_interval
        self.reset_statistics()
        self._step_cache = {}
        self._chain_volume = None  # box volume of the last chain (nm^3)

    # -- statistics ---------------------------------------------------------
    def _update_statistics(self, decision: bool):
        if decision:
            self.n_accepted += 1
        self.n_proposed += 1

    @property
    def statistics(self):
        return dict(n_accepted=self.n_accepted, n_proposed=self.n_proposed)

    @statistics.setter
    def statistics(self, value):
        self.n_accepted = value["n_accepted"]
        self.n_proposed = value["n_proposed"]

    def reset_statistics(self):
        self.n_accepted = 0
        self.n_proposed = 0

    # -- subclass hooks -----------------------------------------------------
    def _param_value(self) -> float:
        raise NotImplementedError

    def _set_param_value(self, value: float) -> None:
        raise NotImplementedError

    def _make_step_fn(self, thermodynamic_state, nbr_list) -> Callable:
        raise NotImplementedError

    def _report_record(self, idx, record, thermodynamic_state):
        raise NotImplementedError

    def _chain_cache_key(self, sampler_state, thermodynamic_state,
                         nbr_list):
        """Identity of the step function: everything it closes over (the
        potential's token, the list's kind and shapes, the ensemble, the
        move's statics).  Recomputed after a capacity regrow."""
        potential = thermodynamic_state.potential
        return (
            potential.cache_token()
            if hasattr(potential, "cache_token")
            else id(potential),
            type(nbr_list).__name__ if nbr_list is not None else None,
            type(getattr(nbr_list, "space", None)).__name__,
            getattr(nbr_list, "n_max_neighbors", None),
            getattr(nbr_list, "cutoff_md", None),
            getattr(nbr_list, "skin_md", None),
            sampler_state.number_of_particles,
            float(thermodynamic_state.kT_md),
            None
            if thermodynamic_state.pressure is None
            else float(thermodynamic_state.pressure_md),
            # `is not None`: an empty subset (all atoms frozen) must not
            # alias the no-mask chain
            None
            if getattr(self, "atom_subset", None) is None
            else tuple(np.asarray(self.atom_subset).ravel().tolist()),
            self.autotune,
            self.autotune_interval,
        )

    # -- driver -------------------------------------------------------------
    def update(self, sampler_state, thermodynamic_state, nbr_list=None):
        """Run ``number_of_moves`` proposals as one device chain."""
        cache_key = self._chain_cache_key(
            sampler_state, thermodynamic_state, nbr_list
        )
        if cache_key not in self._step_cache:
            self._step_cache.clear()
            self._step_cache[cache_key] = self._make_step_fn(
                thermodynamic_state, nbr_list
            )
        step_fn = self._step_cache[cache_key]

        if nbr_list is not None:
            if not nbr_list.is_built:
                nbr_list.build_from_state(sampler_state)
            list_state = nbr_list.state
        else:
            list_state = None

        device = sampler_state.positions.device
        u0 = thermodynamic_state.get_reduced_potential(sampler_state, nbr_list)

        def scalar(value, dtype):
            return torch.as_tensor(value, dtype=dtype, device=device).detach()

        carry = MCCarry(
            positions=sampler_state.positions,
            box_vectors=sampler_state.box_vectors,
            key=sampler_state.new_PRNG_key,
            reduced_potential=scalar(u0, torch.float32),
            list_state=list_state,
            n_accepted=scalar(self.n_accepted, torch.int32),
            n_proposed=scalar(self.n_proposed, torch.int32),
            param=scalar(self._param_value(), torch.float32),
            overflowed=scalar(False, torch.bool),
        )

        # The grow-and-retry of a capacity overflow: the chain is
        # deterministic in its starting carry, so the list is grown, rebuilt
        # from the SAME starting state, and the whole segment re-run; the
        # statistics reach the host only after a clean run.  Only a
        # neighbor list can overflow, so only its chains read the flag.
        carry0 = carry
        for attempt in range(8):
            carry, records = run_mc_chain(step_fn, carry0,
                                          self.number_of_moves)
            if not isinstance(nbr_list, NeighborListNsqrd):
                break
            if not bool(carry.overflowed):
                break
            # geometric growth (+10 floor); a particle has at most n-1
            # neighbors, so past that ceiling an overflow can only mean NaN
            # or invalid positions
            n_particles = int(carry0.positions.shape[0])
            if nbr_list.n_max_neighbors >= n_particles - 1:
                raise RuntimeError(
                    "MC chain overflowed with neighbor capacity already "
                    f"at the physical ceiling ({nbr_list.n_max_neighbors}"
                    f" >= n-1 = {n_particles - 1}); this indicates NaN "
                    "positions or an invalid configuration."
                )
            nbr_list.n_max_neighbors = min(
                n_particles - 1,
                nbr_list.n_max_neighbors + nbr_list.n_max_neighbors // 2
                + 10,
            )
            nbr_list.build(carry0.positions, carry0.box_vectors)
            step_fn = self._make_step_fn(thermodynamic_state, nbr_list)
            self._step_cache.clear()
            self._step_cache[
                self._chain_cache_key(
                    sampler_state, thermodynamic_state, nbr_list
                )
            ] = step_fn
            carry0 = replace(carry0, list_state=nbr_list.state)
        else:
            raise RuntimeError(
                "Neighbor list capacity exceeded during MC chain even "
                "after repeated growth; increase n_max_neighbors and rerun."
            )

        # the statistics and the tuned parameter, in one transfer (float64
        # holds the int32 counts and the float32 parameter exactly)
        n_acc, n_prop, param = torch.stack([
            carry.n_accepted.double(), carry.n_proposed.double(),
            carry.param.double()]).tolist()
        self.n_accepted = int(n_acc)
        self.n_proposed = int(n_prop)
        self._set_param_value(param)

        # the reporter's cadence: every report_interval attempts, from the
        # record stream moved to the host once
        if self.reporter is not None and records:
            self._chain_volume = (
                None
                if carry.box_vectors is None
                else float(torch.prod(torch.diagonal(carry.box_vectors)))
            )
            host_records = {k: v.cpu().numpy() for k, v in records.items()}
            start = self._number_of_attempts_made
            for i in range(self.number_of_moves):
                attempts = start + i + 1
                if attempts % self.report_interval == 0:
                    rec = {k: v[i] for k, v in host_records.items()}
                    self._report_record(i, rec, thermodynamic_state)

        self._number_of_attempts_made += self.number_of_moves
        self._move_iteration += 1

        # the accepted state back into the host shells
        sampler_state.positions = carry.positions
        if carry.box_vectors is not None:
            sampler_state.box_vectors = carry.box_vectors
        if nbr_list is not None:
            nbr_list._state = carry.list_state
            nbr_list.box_vectors = carry.list_state.box_vectors
            if isinstance(nbr_list, NeighborListNsqrd):
                nbr_list.ref_positions = carry.list_state.ref_positions

        return sampler_state, thermodynamic_state, nbr_list


class MonteCarloDisplacementMove(MCMove):
    """Gaussian displacement of all (or a subset of) particles."""

    def __init__(
        self,
        displacement_sigma=1.0 * units.nanometer,
        number_of_moves: int = 100,
        atom_subset: Optional[List[int]] = None,
        report_interval: int = 1,
        reporter=None,
        autotune: bool = False,
        autotune_interval: int = 100,
        acceptance_method="Metropolis-Hastings",
    ):
        super().__init__(
            number_of_moves=number_of_moves,
            reporter=reporter,
            report_interval=report_interval,
            autotune=autotune,
            autotune_interval=autotune_interval,
            acceptance_method=acceptance_method,
        )
        self.displacement_sigma = units.coerce(displacement_sigma)
        self.atom_subset = atom_subset

    def _param_value(self) -> float:
        return float(
            self.displacement_sigma.value_in_unit_system(units.md_unit_system)
        )

    def _set_param_value(self, value: float) -> None:
        self.displacement_sigma = units.Quantity(value, units.nanometer)

    def _make_step_fn(self, thermodynamic_state, nbr_list):
        reduced_fn = thermodynamic_state.make_reduced_potential_fn(nbr_list)
        atom_mask = None
        if self.atom_subset is not None:
            n = thermodynamic_state.nr_of_particles
            atom_mask = torch.zeros(n, dtype=torch.float32)
            # int64 explicitly: an empty list would otherwise be a float
            # indexer
            atom_mask[torch.as_tensor(np.asarray(self.atom_subset),
                                      dtype=torch.int64)] = 1.0
        return make_displacement_step_fn(
            reduced_fn,
            nbr_list,
            atom_mask,
            self.autotune,
            self.autotune_interval,
        )

    def _report_record(self, idx, record, thermodynamic_state):
        beta = thermodynamic_state.beta_md
        u = float(record["reduced_potential"])
        potential_energy = u / beta
        if thermodynamic_state.pressure is not None and (
            self._chain_volume is not None
        ):
            # u is the REDUCED potential: with a pressure it includes
            # beta*P*V, which the pure potential energy leaves out (the
            # barostat's rows do the same; the two share the column).  A
            # displacement chain never changes the box.
            potential_energy -= (
                thermodynamic_state.pressure_md * self._chain_volume
            )
        self.reporter.report(
            {
                "step": idx,
                "iteration": self._move_iteration,
                "number_of_attempts_made": int(record["n_proposed"]),
                "potential_energy": potential_energy,
                "displacement_sigma": float(record["param"]),
                "acceptance_probability": float(record["n_accepted"])
                / max(int(record["n_proposed"]), 1),
            }
        )


class MonteCarloBarostatMove(MCMove):
    """Isotropic-volume NpT barostat move."""

    def __init__(
        self,
        volume_max_scale=0.01,
        number_of_moves: int = 100,
        report_interval: int = 1,
        reporter=None,
        autotune: bool = False,
        autotune_interval: int = 100,
        acceptance_method="Metropolis-Hastings",
    ):
        super().__init__(
            number_of_moves=number_of_moves,
            reporter=reporter,
            report_interval=report_interval,
            autotune=autotune,
            autotune_interval=autotune_interval,
            acceptance_method=acceptance_method,
        )
        self.volume_max_scale = volume_max_scale

    def _param_value(self) -> float:
        return float(self.volume_max_scale)

    def _set_param_value(self, value: float) -> None:
        self.volume_max_scale = value

    def _make_step_fn(self, thermodynamic_state, nbr_list):
        if thermodynamic_state.pressure is None:
            raise ValueError(
                "MonteCarloBarostatMove requires a thermodynamic state with "
                "a pressure (NpT ensemble)."
            )
        reduced_fn = thermodynamic_state.make_reduced_potential_fn(nbr_list)
        return make_barostat_step_fn(
            reduced_fn,
            nbr_list,
            thermodynamic_state.nr_of_particles,
            self.autotune,
            self.autotune_interval,
        )

    def _report_record(self, idx, record, thermodynamic_state):
        beta = thermodynamic_state.beta_md
        pressure = thermodynamic_state.pressure_md
        u = float(record["reduced_potential"])
        volume = float(record["volume"])
        potential_energy = u / beta - pressure * volume
        self.reporter.report(
            {
                "step": idx,
                "iteration": self._move_iteration,
                "number_of_attempts_made": int(record["n_proposed"]),
                "potential_energy": potential_energy,
                "volume": volume,
                "max_volume_scale": float(record["param"]),
                "acceptance_probability": float(record["n_accepted"])
                / max(int(record["n_proposed"]), 1),
            }
        )


class RotamerMove(MCMove):
    """Placeholder: rotamer sampling is not implemented in the reference
    either; kept for API parity."""

    def _make_step_fn(self, thermodynamic_state, nbr_list):
        raise NotImplementedError("RotamerMove is a placeholder (as upstream).")


class ProtonationStateMove(MCMove):
    """Placeholder, as in the reference."""

    def _make_step_fn(self, thermodynamic_state, nbr_list):
        raise NotImplementedError(
            "ProtonationStateMove is a placeholder (as upstream)."
        )


class TautomericStateMove(MCMove):
    """Placeholder, as in the reference."""

    def _make_step_fn(self, thermodynamic_state, nbr_list):
        raise NotImplementedError(
            "TautomericStateMove is a placeholder (as upstream)."
        )


class MoveSchedule:
    """Ordered (name, move) schedule."""

    def __init__(self, move_schedule: List[Tuple[str, MCMCMove]]) -> None:
        self.move_schedule = move_schedule
        self._validate_sequence()

    def _validate_sequence(self):
        for move_name, move_class in self.move_schedule:
            if not isinstance(move_class, MCMCMove):
                raise ValueError(
                    f"Move {move_name} in the sequence is not available."
                )


class MCMCSampler:
    """MCMC driver over a move schedule."""

    def __init__(self, move_set: MoveSchedule):
        log.info("Initializing MCMC sampler")
        self.move = move_set

    def run(
        self,
        sampler_state: SamplerState,
        thermodynamic_state: ThermodynamicState,
        n_iterations: int = 1,
        nbr_list: Optional[PairsBase] = None,
    ):
        # copies, as the reference makes them: K1's op is shared by the
        # copies of a potential (``LJPotential._dense_op``), not copied
        sampler_state = copy.deepcopy(sampler_state)
        thermodynamic_state = copy.deepcopy(thermodynamic_state)
        nbr_list = copy.deepcopy(nbr_list)

        log.info("Running MCMC sampler for %d iterations", n_iterations)
        for iteration in range(n_iterations):
            for move_name, move in self.move.move_schedule:
                log.debug("Performing: %s", move_name)
                sampler_state, thermodynamic_state, nbr_list = move.update(
                    sampler_state, thermodynamic_state, nbr_list
                )

        for _, move in self.move.move_schedule:
            if move.reporter is not None:
                move.reporter.flush_buffer()
        return sampler_state, thermodynamic_state, nbr_list
