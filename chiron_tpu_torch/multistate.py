"""Multistate sampling and replica exchange (port of
``chiron_tpu/multistate.py``).

* :class:`MultiStateSampler` -- ``create`` / ``minimize`` / ``run`` /
  ``f_k`` over a list of per-replica MCMC samplers, the R x S
  reduced-potential matrix from ``calculate_reduced_potential_at_states``
  (on ``DensePairs``, K1 once a replica and distinct potential), the
  offline MBAR each iteration, and ``save_session`` / ``load_session``.
* :class:`ReplicaExchangeSampler` -- even/odd neighbour swaps with the
  Metropolis criterion on the energy matrix; its uniforms come from numpy's
  ``default_rng`` seeded per iteration as in the JAX package, so on one
  energy matrix its decisions are JAX's bit for bit.

Two behaviours of the reference are kept: ``run(n_iterations)`` also sets
each replica's inner MCMC iteration count, so a replica propagates
``n_iterations`` times per outer iteration (``n_iterations**2`` in all);
and ``create`` makes a ``MultistateReporter`` (in the current directory,
unless ``BaseReporter.set_directory`` names another) when none is given.
"""

from __future__ import annotations

import copy
import logging
from typing import List, Optional

import numpy as np
import torch

from . import units
from .analysis import MBAREstimator
from .mcmc import MCMCSampler
from .neighbors import PairsBase
from .states import (
    SamplerState,
    ThermodynamicState,
    calculate_reduced_potential_at_states,
)

log = logging.getLogger("chiron_tpu_torch")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class MultiStateSampler:
    """Replica/state machinery.

    Replica ``i`` carries sampler state ``i`` and is propagated at the
    thermodynamic state given by ``_replica_thermodynamic_states[i]``;
    subclasses permute that assignment to implement replica exchange.
    """

    def __init__(self, mcmc_sampler: MCMCSampler, reporter=None):
        self._thermodynamic_states = None
        self._sampler_states = None
        self._replica_thermodynamic_states = None
        self._iteration = None
        self._energy_thermodynamic_states = None
        self._n_accepted_matrix = None
        self._n_proposed_matrix = None
        self._nbr_lists = None
        self._reporter = reporter
        self._mcmc_sampler = copy.deepcopy(mcmc_sampler)
        self._online_estimator = None
        self._offline_estimator = MBAREstimator()
        self._is_periodic = None
        self.number_of_iterations = 1

    # -- properties -------------------------
    @property
    def number_of_thermodynamic_states(self) -> int:
        return 0 if self._thermodynamic_states is None else len(
            self._thermodynamic_states
        )

    @property
    def number_of_replicas(self) -> int:
        return 0 if self._sampler_states is None else len(self._sampler_states)

    @property
    def iteration(self):
        return self._iteration

    @property
    def mcmc_sampler(self):
        return copy.deepcopy(self._mcmc_sampler)

    @property
    def sampler_states(self) -> Optional[List[SamplerState]]:
        if self._sampler_states is None:
            return None
        return copy.deepcopy(self._sampler_states)

    @property
    def is_periodic(self):
        if self._sampler_states is None:
            return None
        self._is_periodic = self._sampler_states[0].box_vectors is not None
        return self._is_periodic

    @property
    def is_completed(self):
        return self._is_completed()

    # -- setup ---------------------------------------------------------------
    def create(
        self,
        thermodynamic_states: List[ThermodynamicState],
        sampler_states: List[SamplerState],
        nbr_lists: List[PairsBase],
    ):
        """Allocate replicas."""
        if len(thermodynamic_states) != len(sampler_states):
            raise RuntimeError(
                "Number of thermodynamic states and sampler states must be equal."
            )
        self._allocate_variables(thermodynamic_states, sampler_states, nbr_lists)
        if self._reporter is None:
            from .reporters import MultistateReporter

            self._reporter = MultistateReporter()

    def _allocate_variables(self, thermodynamic_states, sampler_states, nbr_lists):
        self._thermodynamic_states = copy.deepcopy(thermodynamic_states)
        self._sampler_states = copy.deepcopy(sampler_states)
        self._nbr_lists = copy.deepcopy(nbr_lists)

        assert len(self._thermodynamic_states) == len(self._sampler_states)
        assert len(self._thermodynamic_states) == len(self._nbr_lists)

        for nbr_list, state in zip(self._nbr_lists, self._sampler_states):
            if nbr_list is not None:
                nbr_list.build(state.positions, state.box_vectors)

        # replicas sharing a PRNG key draw bitwise-identical O-step noise
        # and stay correlated forever (degenerate swap statistics and
        # correlated MBAR samples) -- the natural `[SamplerState(x0,
        # PRNGKey(0), ...)] * R` construction does exactly that
        key_bytes = {int(s._current_PRNG_key) for s in self._sampler_states}
        if len(key_bytes) < len(self._sampler_states):
            log.warning(
                "multiple replicas share the same PRNG key: their noise "
                "streams will be bitwise-identical and the chains "
                "correlated. Give each SamplerState a distinct key (e.g. "
                "utils.split(utils.prng_key(seed), R))."
            )

        n = self.number_of_thermodynamic_states
        self._replica_thermodynamic_states = np.arange(n, dtype=int)
        self._n_accepted_matrix = np.zeros((n, n), np.int64)
        self._n_proposed_matrix = np.zeros((n, n), np.int64)
        self._energy_thermodynamic_states = np.zeros(
            (self.number_of_replicas, n), np.float64
        )
        self._traj = [[] for _ in range(self.number_of_replicas)]

        if isinstance(self._mcmc_sampler, MCMCSampler):
            self._mcmc_sampler = [
                copy.deepcopy(self._mcmc_sampler) for _ in range(n)
            ]
        elif len(self._mcmc_sampler) != n:
            raise RuntimeError(
                f"The number of MCMCMoves ({len(self._mcmc_sampler)}) and "
                f"ThermodynamicStates ({n}) must be the same."
            )
        self._iteration = 0

    # -- minimization ----------------------
    def _minimize_replica(
        self, replica_id: int, tolerance=None, max_iterations: int = 1_000
    ):
        from .minimize import minimize_energy

        thermodynamic_state = self._thermodynamic_states[
            self._replica_thermodynamic_states[replica_id]
        ]
        sampler_state = self._sampler_states[replica_id]
        nbr_list = self._nbr_lists[replica_id]

        initial_energy = thermodynamic_state.get_reduced_potential(
            sampler_state, nbr_list
        )
        log.debug(
            "Replica %d/%d: initial energy %8.3f kT",
            replica_id + 1, self.number_of_replicas, float(initial_energy),
        )

        result = minimize_energy(
            sampler_state.positions,
            thermodynamic_state.potential.compute_energy,
            nbr_list,
            maxiter=max_iterations,
        )
        self._sampler_states[replica_id].positions = result.params

        if nbr_list is not None and nbr_list.check(
            self._sampler_states[replica_id].positions
        ):
            nbr_list.build(
                self._sampler_states[replica_id].positions,
                self._sampler_states[replica_id].box_vectors,
            )

        final_energy = thermodynamic_state.get_reduced_potential(
            sampler_state, nbr_list
        )
        log.debug(
            "Replica %d/%d: final energy %8.3f kT",
            replica_id + 1, self.number_of_replicas, float(final_energy),
        )

    def minimize(self, tolerance=None, max_iterations: int = 1_000) -> None:
        if self.number_of_replicas == 0:
            raise RuntimeError(
                "Cannot minimize replicas. The simulation must be created first."
            )
        log.debug("Minimizing all replicas...")
        for replica_id in range(self.number_of_replicas):
            self._minimize_replica(replica_id, tolerance, max_iterations)

    # -- propagation ---------------------------------------------------------
    def _propagate_replica(self, replica_id: int):
        """One replica's MCMC propagation."""
        thermodynamic_state_id = self._replica_thermodynamic_states[replica_id]
        sampler_state = self._sampler_states[replica_id]
        thermodynamic_state = self._thermodynamic_states[thermodynamic_state_id]
        nbr_list = self._nbr_lists[replica_id]
        mcmc_sampler = self._mcmc_sampler[thermodynamic_state_id]

        (
            self._sampler_states[replica_id],
            self._thermodynamic_states[thermodynamic_state_id],
            self._nbr_lists[replica_id],
        ) = mcmc_sampler.run(
            sampler_state, thermodynamic_state, self.number_of_iterations, nbr_list
        )
        self._traj[replica_id].append(self._sampler_states[replica_id].positions)

    def _propagate_replicas(self) -> None:
        log.debug("Propagating all replicas...")
        for replica_id in range(self.number_of_replicas):
            self._propagate_replica(replica_id)

    # -- energy matrix -------------------------------------------------------
    def _compute_replica_reduced_potential(self, replica_id: int) -> np.ndarray:
        sampler_state = self._sampler_states[replica_id]
        nbr_list = self._nbr_lists[replica_id]
        energies = calculate_reduced_potential_at_states(
            sampler_state, self._thermodynamic_states, nbr_list
        )
        return energies.detach().cpu().numpy()

    def _compute_energies(self) -> None:
        """R x S reduced-potential matrix."""
        log.debug("Computing energy matrix for all replicas...")
        self._energy_thermodynamic_states = np.zeros(
            (self.number_of_replicas, self.number_of_thermodynamic_states)
        )
        for replica_id in range(self.number_of_replicas):
            self._energy_thermodynamic_states[replica_id, :] = (
                self._compute_replica_reduced_potential(replica_id)
            )

    # -- swaps ---------------------------------------------------------------
    def _perform_swap_proposals(self) -> np.ndarray:
        """Identity in the base class."""
        return self._replica_thermodynamic_states

    def _mix_replicas(self) -> np.ndarray:
        """Swap bookkeeping wrapper."""
        log.debug("Mixing replicas...")
        self._n_accepted_matrix[:, :] = 0
        self._n_proposed_matrix[:, :] = 0
        new_replica_states = self._perform_swap_proposals()
        n_swaps_proposed = self._n_proposed_matrix.sum()
        n_swaps_accepted = self._n_accepted_matrix.sum()
        frac = n_swaps_accepted / n_swaps_proposed if n_swaps_proposed > 0 else 0.0
        log.debug(
            "Accepted %d/%d attempted swaps (%.1f%%)",
            n_swaps_accepted, n_swaps_proposed, frac * 100.0,
        )
        self._replica_thermodynamic_states = new_replica_states
        return new_replica_states

    # -- driver --------------------------------------------------------------
    def _is_completed(self, iteration_limit: Optional[int] = None) -> bool:
        if iteration_limit is not None and self._iteration >= iteration_limit:
            log.info(
                "Reached iteration limit %d (current iteration %d)",
                iteration_limit, self._iteration,
            )
            return True
        return False

    def run(self, n_iterations: int = 10) -> None:
        """Propagate / mix / measure loop.

        NOTE: as in the reference, ``n_iterations`` doubles as the per-move
        iteration count handed to each replica's MCMCSampler.
        """
        log.info("Running simulation...")
        self.number_of_iterations = n_iterations

        if self._iteration == 0:
            self._compute_energies()
            self._report_iteration()

        while not self._is_completed(n_iterations):
            self._iteration += 1
            log.info("Iteration %d/%d", self._iteration, n_iterations)
            self._mix_replicas()
            self._propagate_replicas()
            self._compute_energies()
            self._report_iteration()
            self._update_analysis()

        if self._reporter is not None:
            self._reporter.flush_buffer()

    # -- reporting / analysis ------------------------------------------------
    def _report_energy_matrix(self):
        # transposed to (S, R), as the reference reports it
        return {"u_kn": self._energy_thermodynamic_states.T}

    def _report_positions(self):
        xyz = np.zeros(
            (self.number_of_replicas, self._sampler_states[0].positions.shape[0], 3)
        )
        for replica_id in range(self.number_of_replicas):
            xyz[replica_id] = _host(self._sampler_states[replica_id].positions)
        return {"positions": xyz}

    def _report(self, property: str):
        if property == "positions":
            return self._report_positions()
        elif property == "u_kn":
            return self._report_energy_matrix()
        elif property == "state_index":
            return {"state_index": np.asarray(self._replica_thermodynamic_states)}
        elif property == "step":
            return {"step": np.asarray(self._iteration)}
        elif property == "box_vectors":
            if self._sampler_states[0].box_vectors is None:
                return None
            boxes = np.stack(
                [_host(s.box_vectors) for s in self._sampler_states]
            )
            return {"box_vectors": boxes}
        return None

    def _report_iteration(self):
        if self._reporter is None:
            return
        prop = {}
        for property in self._reporter.properties_to_report:
            p = self._report(property)
            if p:
                prop.update(p)
        self._reporter.report(prop)

    def _update_analysis(self):
        """Offline MBAR update each iteration."""
        log.debug("Updating free energy analysis...")
        if self._offline_estimator:
            u_kn = self._reporter.get_property("u_kn")
            if u_kn is not None:
                u_kn = np.asarray(u_kn)
                if u_kn.ndim == 3 and u_kn.shape[0] >= 3:
                    # Discard the iteration-0 frame: it is the shared,
                    # unequilibrated initial configuration (all replicas
                    # identical), which biases f_k toward zero.  The
                    # reference chiron feeds it to MBAR; the JAX package
                    # and this one treat it as equilibration.
                    u_kn = u_kn[1:]
                # N_k derived from the frames actually used, so the sample
                # count is always consistent (the reference chiron passes
                # [iteration]*K, which can disagree with the reporter's
                # buffered frame count).
                n_frames = u_kn.shape[0] if u_kn.ndim == 3 else 1
                N_k = [n_frames] * self.number_of_thermodynamic_states
                self._offline_estimator.initialize(u_kn=u_kn, N_k=N_k)
                log.debug("f_k = %s", self._offline_estimator.f_k)
        elif self._online_estimator:
            self._online_estimator.update()
        else:
            raise RuntimeError("No free energy estimator provided.")

    @property
    def f_k(self) -> np.ndarray:
        if self._offline_estimator:
            return self._offline_estimator.f_k
        elif self._online_estimator:
            return self._online_estimator.f_k
        raise RuntimeError("No free energy estimator found.")

    # -- session checkpoint --------------------------------------------------
    def save_session(self, path: str):
        """Persist the full multistate session: every replica's sampler
        state, the replica->state permutation, swap matrices, the energy
        matrix, and move bookkeeping, in the checkpoint layout of
        ``checkpoint`` (the JAX package's)."""
        from .checkpoint import save_checkpoint

        tree = {
            f"replica_{i}": s.as_data()
            for i, s in enumerate(self._sampler_states)
        }
        tree["permutation"] = np.asarray(
            self._replica_thermodynamic_states, dtype=np.int64
        )
        tree["n_accepted"] = self._n_accepted_matrix
        tree["n_proposed"] = self._n_proposed_matrix
        tree["u_matrix"] = self._energy_thermodynamic_states
        attempts = [
            int(move._number_of_attempts_made)
            for sampler in self._mcmc_sampler
            for _, move in sampler.move.move_schedule
        ]
        save_checkpoint(path, tree, metadata={
            "iteration": int(self._iteration),
            "n_replicas": int(self.number_of_replicas),
            "move_attempts": attempts,
        })

    def load_session(self, path: str):
        """Restore a session saved by :meth:`save_session` into this
        (identically created) sampler; returns the checkpoint metadata."""
        from dataclasses import replace as _replace

        from .checkpoint import load_checkpoint

        def data_of(s):
            d = s.as_data()
            if d.velocities is None:
                # propagated sessions carry velocities; densify a freshly
                # created template so leaves match by field
                d = _replace(d, velocities=torch.zeros_like(d.positions))
            return d

        template = {
            f"replica_{i}": data_of(s)
            for i, s in enumerate(self._sampler_states)
        }
        template["permutation"] = np.asarray(
            self._replica_thermodynamic_states, dtype=np.int64
        )
        template["n_accepted"] = self._n_accepted_matrix
        template["n_proposed"] = self._n_proposed_matrix
        template["u_matrix"] = self._energy_thermodynamic_states
        tree, meta = load_checkpoint(path, like=template)
        if meta.get("n_replicas") != self.number_of_replicas:
            raise ValueError(
                f"checkpoint has {meta.get('n_replicas')} replicas, "
                f"sampler has {self.number_of_replicas}"
            )
        for i, s in enumerate(self._sampler_states):
            s.update_from_data(tree[f"replica_{i}"])
        self._replica_thermodynamic_states = np.asarray(
            tree["permutation"], dtype=int
        )
        self._n_accepted_matrix = np.asarray(tree["n_accepted"])
        self._n_proposed_matrix = np.asarray(tree["n_proposed"])
        self._energy_thermodynamic_states = np.asarray(tree["u_matrix"])
        self._iteration = meta["iteration"]
        attempts = iter(meta.get("move_attempts", []))
        for sampler in self._mcmc_sampler:
            for _, move in sampler.move.move_schedule:
                try:
                    move._number_of_attempts_made = next(attempts)
                except StopIteration:
                    break
        return meta


class ReplicaExchangeSampler(MultiStateSampler):
    """Even/odd neighbor-swap replica exchange.

    Implements the swap algorithm the reference scaffolds but leaves empty
   : on even iterations propose swaps
    between state pairs (0,1), (2,3), ...; on odd iterations (1,2), (3,4),
    ...  Each proposal is accepted with the Metropolis criterion

        P = min[1, exp((u_il + u_jm) - (u_im + u_jl))]

    where replicas i, j currently sample states l, m and u are entries of
    the reduced-potential matrix -- no extra energy evaluations needed.
    Deterministic even/odd sweeps reach the same diffusion limit as
    random-pair sweeps at a fraction of the proposals.
    """

    def _perform_swap_proposals(self) -> np.ndarray:
        n_states = self.number_of_thermodynamic_states
        replica_states = np.array(self._replica_thermodynamic_states)
        u = self._energy_thermodynamic_states  # (R, S): replica x state

        # state -> replica inverse map
        state_to_replica = np.empty(n_states, dtype=int)
        state_to_replica[replica_states] = np.arange(len(replica_states))

        offset = self._iteration % 2
        rng = np.random.default_rng(self._swap_seed())
        for s in range(offset, n_states - 1, 2):
            i = state_to_replica[s]
            j = state_to_replica[s + 1]
            log_p = (u[i, s] + u[j, s + 1]) - (u[i, s + 1] + u[j, s])
            self._n_proposed_matrix[s, s + 1] += 1
            self._n_proposed_matrix[s + 1, s] += 1
            if log_p >= 0 or rng.uniform() < np.exp(log_p):
                replica_states[i], replica_states[j] = (
                    replica_states[j], replica_states[i],
                )
                state_to_replica[s], state_to_replica[s + 1] = j, i
                self._n_accepted_matrix[s, s + 1] += 1
                self._n_accepted_matrix[s + 1, s] += 1
        return replica_states

    def _swap_seed(self) -> int:
        # Deterministic per-iteration stream for reproducibility.
        return 0x5EED ^ (self._iteration * 2654435761 % 2 ** 31)
