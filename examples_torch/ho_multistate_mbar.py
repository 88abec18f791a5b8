"""Harmonic-oscillator multistate sampling + MBAR free-energy check.

Recreates the reference's multistate workload (chiron/tests/
test_multistate.py:91-151; the port of ``examples/ho_multistate_mbar.py``):
a ladder of 4 harmonic oscillators with K_i = kT / sigma_i^2, sampled by
per-state Langevin dynamics under ``ReplicaExchangeSampler``; MBAR must
recover the analytic free-energy differences within 0.1 kT, and reweighting
to an unsampled sigma must agree with its analytic value.
"""

import math
import os
import sys

if __package__ in (None, ""):  # run as a script from a checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from chiron_tpu_torch import units
from chiron_tpu_torch.mcmc import LangevinDynamicsMove, MCMCSampler, MoveSchedule
from chiron_tpu_torch.multistate import ReplicaExchangeSampler
from chiron_tpu_torch.neighbors import OrthogonalNonPeriodicSpace, PairListNsqrd
from chiron_tpu_torch.potential import HarmonicOscillatorPotential
from chiron_tpu_torch.reporters import BaseReporter, MultistateReporter
from chiron_tpu_torch.states import SamplerState, ThermodynamicState
from chiron_tpu_torch.testsystems import HarmonicOscillator
from chiron_tpu_torch.utils import PRNG
from examples_torch._common import require_device, run_cli, timed

N_STATES = 4
S_NEW = 2.3  # angstrom: an unsampled sigma between the ladder's rungs


def sigma_angstrom(i: int) -> float:
    return 2.0 + 0.2 * i


def build(device, seed=1234):
    """(thermodynamic states, sampler states, pair lists) of the ladder;
    ``seed`` seeds the replicas' keys."""
    ho = HarmonicOscillator()
    T = 300.0 * units.kelvin
    kT = units.BOLTZMANN_CONSTANT_kB * T * units.AVOGADRO_CONSTANT_NA
    sigmas = [units.Quantity(sigma_angstrom(i), units.angstrom)
              for i in range(N_STATES)]
    thermodynamic_states = [
        ThermodynamicState(HarmonicOscillatorPotential(ho.topology, k=kT / s ** 2),
                           temperature=T)
        for s in sigmas]
    PRNG.set_seed(seed)
    sampler_states = [
        SamplerState(ho.positions, current_PRNG_key=PRNG.get_random_key(),
                     device=device)
        for _ in sigmas]
    nbr_lists = [PairListNsqrd(OrthogonalNonPeriodicSpace(), cutoff=None)
                 for _ in sigmas]
    return thermodynamic_states, sampler_states, nbr_lists


def langevin_move(number_of_steps=500):
    """Each replica's propagation: Langevin dynamics at 1 fs."""
    return LangevinDynamicsMove(timestep=1.0 * units.femtoseconds,
                                number_of_steps=number_of_steps)


def analytic_f(s: float) -> float:
    """-(3/2) ln(2 pi sigma^2) (reduced, sigma in angstrom)."""
    return -1.5 * math.log(2 * math.pi * s ** 2)


def main(device="cuda", n_iterations=25, number_of_steps=500,
         minimize_iterations=200, seed=1234, reporter=None):
    """``run(n_iterations)`` propagates each replica ``n_iterations`` times
    an iteration, as the reference does.  ``seed`` (the JAX example's 1234)
    seeds the replicas.  ``reporter`` defaults to the JAX example's HDF5
    ``MultistateReporter`` under ``output/ho_multistate``."""
    dev = require_device(device)
    thermodynamic_states, sampler_states, nbr_lists = build(dev, seed)
    if reporter is None:
        BaseReporter.set_directory("output/ho_multistate")
        reporter = MultistateReporter()
        reporter.reset_reporter_file()

    mcmc_sampler = MCMCSampler(MoveSchedule([
        ("LangevinDynamicsMove", langevin_move(number_of_steps))]))
    sampler = ReplicaExchangeSampler(mcmc_sampler=mcmc_sampler,
                                     reporter=reporter)
    sampler.create(thermodynamic_states, sampler_states, nbr_lists)
    sampler.minimize(max_iterations=minimize_iterations)
    _, seconds = timed(dev, lambda: sampler.run(n_iterations))

    f_analytic = np.array([analytic_f(sigma_angstrom(i))
                           for i in range(N_STATES)])
    f_analytic -= f_analytic[0]
    f_k = np.asarray(sampler.f_k)
    err = float(np.max(np.abs(f_k - f_analytic)))
    print("analytic  f_k:", np.round(f_analytic, 4))
    print("estimated f_k:", np.round(f_k, 4))
    print(f"max |error| = {err:.4f} kT")

    # uncertainty + diagnostics: asymptotic error bars, bootstrap
    # cross-check, state-overlap scalar
    est = sampler._offline_estimator
    d_asym = est.d_f_k
    d_boot = est.bootstrap_d_f_k(n_bootstrap=30, seed=0)
    overlap = est.compute_overlap()["scalar"]
    print("d f_k (asymptotic):", np.round(d_asym, 4))
    print("d f_k (bootstrap): ", np.round(d_boot, 4))
    print(f"overlap scalar = {overlap:.3f}  (near 1 = connected ladder)")

    # reweight to a state never sampled: u scales as 1/sigma^2, so its
    # reduced potentials are a rescale of state 0's row on the pooled samples
    u_new = est.u_kn[0] * (sigma_angstrom(0) / S_NEW) ** 2
    f_l, d_f_l = est.compute_perturbed_free_energies(u_new)
    f_new_true = analytic_f(S_NEW) - analytic_f(sigma_angstrom(0))
    print(f"unsampled sigma={S_NEW} A: f = {f_l[0]:.4f} +- {d_f_l[0]:.4f} kT"
          f"  (analytic {f_new_true:.4f})")
    n_steps = N_STATES * n_iterations * n_iterations * number_of_steps
    return dict(f_k=f_k, f_analytic=f_analytic, max_error=err,
                d_f_k=np.asarray(d_asym), d_f_k_bootstrap=np.asarray(d_boot),
                overlap=float(overlap), f_unsampled=float(f_l[0]),
                d_f_unsampled=float(d_f_l[0]), f_unsampled_true=f_new_true,
                steps_per_second=n_steps / seconds, seconds=seconds,
                headline=f"f_k error {err:.4f} kT (< 0.1), "
                         f"{n_steps / seconds:.1f} Langevin steps/s, unsampled "
                         f"sigma f {f_l[0]:.4f} (analytic {f_new_true:.4f})")


def check(results):
    assert results["max_error"] < 0.1, (
        f"free energies did not converge to 0.1 kT: {results['max_error']}")
    assert abs(results["f_unsampled"] - results["f_unsampled_true"]) < max(
        4.0 * results["d_f_unsampled"], 0.1), results
    print("MBAR free-energy check: PASS")


if __name__ == "__main__":
    run_cli(main, check, __doc__)
