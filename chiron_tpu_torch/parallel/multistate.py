"""Mesh-propagated multistate sampling for potential families (port of
``chiron_tpu/parallel/multistate.py``).

:class:`MeshMultiStateSampler` is the port's ``ReplicaExchangeSampler`` with
two stages batched over the replicas when every state is one potential
family with its parameters as data (``potential.stack_homogeneous_params``)
or a mix of registered kinds (``potential.stack_registered_params``):

* propagation: each process of the mesh runs its ``replica_sharding`` block
  through one BAOAB chain whose force is ``torch.func.vmap`` of the
  gradient over the block's replicas and their states' parameters, with
  the tempering chain's noise stream (``tempering.replica_normals``);
  the positions and velocities are then all-gathered, so every process
  holds every replica;
* the R x S reduced-potential matrix: ``vmap`` over replicas of ``vmap``
  over states.

A replica never evaluates another kind's energy: both stages group their
replicas (or states) by kind and run each group through its own branch, as
JAX's ``lax.map`` keeps its switch a real branch.  JAX's energies here are
plain ``jnp`` (no Pallas kernel), so these stages are plain torch.  The
sampler falls back to the serial base-class path, with a warning, when the
states are no registered family, the boxes differ, there is no topology or
the move schedule is not Langevin dynamics alone.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import units, utils
from ..mcmc import LangevinDynamicsMove
from ..multistate import ReplicaExchangeSampler
from ..potential import stack_homogeneous_params, stack_registered_params
from .mesh import Mesh, make_replica_mesh, replica_sharding
from .tempering import _Noise, stream_seed

log = logging.getLogger("chiron_tpu_torch")


def _tree_map(fn, tree):
    """``fn`` on every tensor of a tuple/dict tree of parameters."""
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class MeshMultiStateSampler(ReplicaExchangeSampler):
    """Replica exchange with the replicas split over the port's mesh.

    Same API as :class:`chiron_tpu_torch.multistate.ReplicaExchangeSampler`;
    propagation and the energy matrix run batched when the ladder allows.
    R must divide by the mesh size for the batched path.  The default mesh
    is this process alone on the sampler states' device.
    """

    def __init__(self, mcmc_sampler, reporter=None,
                 mesh: Optional[Mesh] = None):
        super().__init__(mcmc_sampler=mcmc_sampler, reporter=reporter)
        self._mesh = mesh
        self._stacked = None     # (param_energy_fn, stacked_params) or None
        self._propagator = None  # the batched chain
        self._ukn_fn = None

    # -- setup -----------------------------------------------------------
    def _allocate_variables(self, thermodynamic_states, sampler_states,
                            nbr_lists):
        super()._allocate_variables(
            thermodynamic_states, sampler_states, nbr_lists
        )
        self._try_build_stacked_path()

    def _langevin_only_move(self):
        moves = [m for _, m in self._mcmc_sampler[0].move.move_schedule]
        if len(moves) == 1 and isinstance(moves[0], LangevinDynamicsMove):
            return moves[0]
        return None

    def _try_build_stacked_path(self):
        potentials = [ts.potential for ts in self._thermodynamic_states]
        stacked = stack_homogeneous_params(potentials)
        if stacked is None:
            # a ladder over any mix of registered potential kinds
            boxes = [s.box_vectors for s in self._sampler_states]
            box0 = boxes[0]
            same_box = all(
                (b is None and box0 is None)
                or (b is not None and box0 is not None
                    and bool(torch.equal(b, box0)))
                for b in boxes
            )
            if same_box:
                box_diag = None if box0 is None else torch.diagonal(box0)
                stacked = stack_registered_params(potentials,
                                                  box_diag=box_diag)
        move = self._langevin_only_move()
        topo = next(
            (ts.potential.topology for ts in self._thermodynamic_states
             if getattr(ts.potential, "topology", None) is not None),
            None,
        )
        if stacked is None or move is None or topo is None:
            log.warning(
                "MeshMultiStateSampler: falling back to SERIAL per-replica "
                "propagation (a potential class is not registered via "
                "chiron_tpu_torch.potential.register_potential_kind, "
                "parameter shapes are inconsistent, boxes mismatch, no "
                "topology for masses, or a non-Langevin move schedule) -- "
                "expect reference-grade performance for this ladder"
            )
            return
        device = self._sampler_states[0].positions.device
        if self._mesh is None:
            self._mesh = make_replica_mesh(device=device)
        R = self.number_of_replicas
        n_dev = self._mesh.size
        if R % n_dev != 0:
            log.info(
                "MeshMultiStateSampler: %d replicas not divisible by mesh "
                "size %d; falling back to serial propagation", R, n_dev,
            )
            return
        self._local = replica_sharding(self._mesh).local_slice(R)
        param_energy_fn, params = stacked
        params = _tree_map(lambda t: t.to(device), params)
        self._stacked = (param_energy_fn, params)
        self._masses = torch.as_tensor(
            np.asarray(topo.masses(), dtype=np.float32), device=device)[:, None]
        dt = units.strip_md(move.timestep, units.picosecond)
        gamma = units.strip_md(move.collision_rate, 1.0 / units.picosecond)
        # JAX's order: a and b from the host floats, then dt in float32
        a = float(torch.exp(torch.tensor(-gamma * dt, dtype=torch.float32)))
        b = float(torch.sqrt(1.0 - torch.exp(
            torch.tensor(-2.0 * gamma * dt, dtype=torch.float32))))
        hdt = float(torch.tensor(dt, dtype=torch.float32) * 0.5)

        # each kind's branch over its own replicas or states: JAX's
        # lax.switch under lax.map is a real branch, never all of them
        branches = getattr(param_energy_fn, "branches", None)
        kind_list = getattr(param_energy_fn, "kind_list", None)
        if branches is None:
            branches, kind_list = (param_energy_fn,), [0] * len(potentials)
        self._kind_list = kind_list
        grads = [torch.func.vmap(torch.func.grad(
            lambda x, p, fn=fn: -fn(p, x))) for fn in branches]

        def force(x, params_r, kinds):
            if len(set(kinds)) == 1:
                return grads[kinds[0]](x, params_r)
            F = torch.empty_like(x)
            for k in sorted(set(kinds)):
                idx = torch.as_tensor(
                    [r for r, kr in enumerate(kinds) if kr == k],
                    device=x.device)
                F[idx] = grads[k](x[idx], _tree_map(lambda t: t[idx],
                                                     params_r))
            return F

        masses = self._masses

        def chain(x, v, seeds, kT, params_r, kinds, n_steps: int,
                  noise=None):
            """The block's BAOAB chain; potential parameters are data."""
            bs = b * torch.sqrt(kT.reshape(-1, 1, 1) / masses)
            F = force(x, params_r, kinds)
            for z in _Noise(seeds, n_steps, tuple(x.shape[1:]), x.device,
                            noise):
                v = v + hdt * F / masses
                x = x + hdt * v
                v = a * v + bs * z
                x = x + hdt * v
                F = force(x, params_r, kinds)
                v = v + hdt * F / masses
            return x, v

        self._propagator = chain

        # u_kn in one pass a kind: E[r, s] = U(params_s, x_r), u = beta_s E
        groups = {}
        for s_idx, k in enumerate(kind_list):
            groups.setdefault(k, []).append(s_idx)
        groups = [(k, torch.as_tensor(idxs, device=device))
                  for k, idxs in groups.items()]

        def ukn(xs, betas):
            E = torch.zeros((xs.shape[0], len(kind_list)),
                            dtype=torch.float32, device=xs.device)
            for k, idxs in groups:
                params_g = _tree_map(lambda t: t[idxs], params)
                fn = branches[k]
                E[:, idxs] = torch.func.vmap(
                    lambda x: torch.func.vmap(lambda p: fn(p, x))(params_g)
                )(xs)
            return E * betas[None, :]

        if any(ts.pressure is not None for ts in self._thermodynamic_states):
            # the batched u_kn is beta_s E only; states with pressure need
            # beta p V: energies go through the serial reduced-potential
            # path, propagation stays batched
            self._ukn_fn = None
            log.info(
                "MeshMultiStateSampler: pressure set on a state; energy "
                "matrix uses the serial reduced-potential path (includes "
                "beta*p*V), propagation stays batched"
            )
        else:
            self._ukn_fn = ukn
        log.info(
            "MeshMultiStateSampler: batched path active (%d replicas on "
            "%d processes)", R, n_dev,
        )

    # -- stacked state marshalling ----------------------------------------
    def _gather_positions(self):
        return torch.stack([s.positions for s in self._sampler_states])

    def _gather_stacked(self):
        """Positions, velocities, and fresh per-replica subkeys.

        Splits each replica's key: only the propagation stage may call
        this (the energy matrix uses :meth:`_gather_positions`, or
        reproducibility would depend on how often energies are computed)."""
        xs = self._gather_positions()
        vs = []
        keys = []
        for s in self._sampler_states:
            v = s.velocities
            vs.append(torch.zeros_like(s.positions) if v is None else v)
            keys.append(s.new_PRNG_key)
        return xs, torch.stack(vs), keys

    def _all_gather(self, t):
        if self._mesh.group is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self._mesh.size)]
        dist.all_gather(parts, t, group=self._mesh.group)
        return torch.cat(parts)

    # -- overridden stages -------------------------------------------------
    def _propagate_replicas(self) -> None:
        if self._propagator is None:
            # Serial fallback with the batched path's sampling per
            # iteration: one move-schedule sweep (number_of_moves steps),
            # not the base class's n_iterations sweeps -- the two paths of
            # this class must sample alike.
            saved = self.number_of_iterations
            self.number_of_iterations = 1
            try:
                return super()._propagate_replicas()
            finally:
                self.number_of_iterations = saved
        xs, vs, keys = self._gather_stacked()
        move = self._langevin_only_move()
        n_steps = move.number_of_moves
        # per-replica thermodynamic state assignment (permuted by swaps)
        perm = np.asarray(self._replica_thermodynamic_states)
        device = xs.device
        kTs = torch.tensor(
            [self._thermodynamic_states[s].kT_md for s in perm],
            dtype=torch.float32, device=device,
        )
        missing_v = np.asarray(
            [s.velocities is None for s in self._sampler_states]
        )
        if missing_v.any():
            # split each replica key: [1] seeds the velocities, [0] the
            # chain, so that the chain's noise is independent of them;
            # only the replicas that lack velocities are drawn
            split2 = [utils.split(k) for k in keys]
            keys = [k0 for k0, _ in split2]
            z = next(iter(_Noise([stream_seed(k1) for _, k1 in split2], 1,
                                 tuple(xs.shape[1:]), device)))
            drawn = torch.sqrt(kTs[:, None, None] / self._masses) * z
            vs = torch.where(torch.as_tensor(missing_v, device=device)
                             [:, None, None], drawn, vs)
        loc = self._local
        _, params = self._stacked
        perm_l = perm[loc]
        params_r = _tree_map(
            lambda t: t[torch.as_tensor(perm_l, device=t.device)], params)
        kinds = [self._kind_list[s] for s in perm_l]
        x, v = self._propagator(
            xs[loc], vs[loc], [stream_seed(k) for k in keys[loc]], kTs[loc],
            params_r, kinds, n_steps)
        xs, vs = self._all_gather(x), self._all_gather(v)
        for r, s in enumerate(self._sampler_states):
            s.positions = xs[r]
            s.velocities = vs[r]
            self._traj[r].append(s.positions)
        for sid in perm:
            # bookkeeping as the serial fallback's (one sweep of
            # number_of_moves steps per outer iteration)
            mv = self._mcmc_sampler[sid].move.move_schedule[0][1]
            mv._number_of_attempts_made += n_steps
            mv._move_iteration += 1
        if self._ukn_fn is None:
            # the serial energy matrix reads the host neighbor lists, which
            # nothing on the batched path maintains: rebuild any that went
            # stale, so u_kn never uses create()-time pair indices
            for r, s in enumerate(self._sampler_states):
                nl = self._nbr_lists[r]
                if (
                    nl is not None
                    and getattr(nl, "is_built", False)
                    and bool(nl.check(s.positions))
                ):
                    nl.build(s.positions, s.box_vectors)

    def _compute_energies(self) -> None:
        if self._ukn_fn is None:
            return super()._compute_energies()
        xs = self._gather_positions()
        betas = torch.tensor(
            [ts.beta_md for ts in self._thermodynamic_states],
            dtype=torch.float32, device=xs.device,
        )
        self._energy_thermodynamic_states = (
            self._ukn_fn(xs, betas).detach().cpu().numpy().astype(np.float64)
        )
