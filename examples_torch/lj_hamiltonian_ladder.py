"""Hamiltonian-exchange free-energy ladder: epsilon-scaled LJ states.

The production free-energy workflow (the port of
``examples/lj_hamiltonian_ladder.py``): a ladder of alchemically scaled
Hamiltonians U_k = lambda_k * U_LJ at one temperature, sampled by replica
exchange, with MBAR recovering the reduced free energy of switching the
interactions on, error bars from both the asymptotic covariance and an
iteration-resampling bootstrap, and reweighting to a lambda that was never
sampled.

Because U scales linearly in epsilon, the exact reduced-potential relation
u_k = (lambda_k / lambda_0) * u_0 gives two internal oracles: the u_kn
matrix rows must be proportional, and the perturbed-state estimate at a
sampled lambda must reproduce the solved f_k.
"""

import os
import sys

if __package__ in (None, ""):  # run as a script from a checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from chiron_tpu_torch import units
from chiron_tpu_torch.mcmc import LangevinDynamicsMove, MCMCSampler, MoveSchedule
from chiron_tpu_torch.multistate import ReplicaExchangeSampler
from chiron_tpu_torch.neighbors import NeighborListNsqrd, OrthogonalPeriodicSpace
from chiron_tpu_torch.potential import LJPotential
from chiron_tpu_torch.reporters import BaseReporter, MultistateReporter
from chiron_tpu_torch.states import SamplerState, ThermodynamicState
from chiron_tpu_torch.testsystems import LennardJonesFluid
from chiron_tpu_torch.utils import PRNG
from examples_torch._common import require_device, run_cli, timed

# ladder spacing for healthy phase-space overlap: d f/d lambda = <beta U_LJ>
# ~ -2.5 kT/particle here, so 27 particles at 0.075-lambda rungs put
# adjacent states ~2 kT apart
LAMBDAS = [float(x) for x in np.round(np.linspace(0.25, 1.0, 11), 4)]


def build(device, n=27):
    """(thermodynamic states, sampler states, neighbor lists) of the
    ladder."""
    fluid = LennardJonesFluid(nparticles=n, reduced_density=0.4)
    T = 300.0 * units.kelvin
    thermodynamic_states = [
        ThermodynamicState(
            LJPotential(fluid.topology, sigma=fluid.sigma,
                        epsilon=lam * fluid.epsilon, cutoff=fluid.cutoff),
            temperature=T)
        for lam in LAMBDAS]
    PRNG.set_seed(2024)
    sampler_states = [
        SamplerState(fluid.positions, current_PRNG_key=PRNG.get_random_key(),
                     box_vectors=fluid.box_vectors, device=device)
        for _ in LAMBDAS]
    nbr_lists = [
        NeighborListNsqrd(OrthogonalPeriodicSpace(), cutoff=fluid.cutoff,
                          skin=0.3 * units.nanometer, n_max_neighbors=80)
        for _ in LAMBDAS]
    return thermodynamic_states, sampler_states, nbr_lists


def langevin_move(number_of_steps=100):
    """Each replica's propagation: Langevin dynamics at 2 fs."""
    return LangevinDynamicsMove(timestep=2.0 * units.femtoseconds,
                                number_of_steps=number_of_steps)


def main(device="cuda", n=27, n_iterations=20, number_of_steps=100,
         reporter=None):
    """``run(n_iterations)`` propagates each replica ``n_iterations`` times
    an iteration, as the reference does.  ``reporter`` defaults to the JAX
    example's HDF5 ``MultistateReporter`` under
    ``output/lj_hamiltonian_ladder``."""
    dev = require_device(device)
    thermodynamic_states, sampler_states, nbr_lists = build(dev, n)
    if reporter is None:
        BaseReporter.set_directory("output/lj_hamiltonian_ladder")
        reporter = MultistateReporter()
        reporter.reset_reporter_file()

    mcmc_sampler = MCMCSampler(MoveSchedule([
        ("LangevinDynamicsMove", langevin_move(number_of_steps))]))
    sampler = ReplicaExchangeSampler(mcmc_sampler=mcmc_sampler,
                                     reporter=reporter)
    sampler.create(thermodynamic_states=thermodynamic_states,
                   sampler_states=sampler_states, nbr_lists=nbr_lists)
    _, seconds = timed(dev, lambda: sampler.run(n_iterations))

    est = sampler._offline_estimator
    f_k, d_f_k = np.asarray(est.f_k), np.asarray(est.d_f_k)
    d_boot = est.bootstrap_d_f_k(n_bootstrap=20, seed=0)
    print("lambda ladder:        ", LAMBDAS)
    print("f_k (kT):             ", np.round(f_k, 3))
    print("d f_k (asymptotic):   ", np.round(d_f_k, 3))
    print("d f_k (bootstrap):    ", np.round(d_boot, 3))
    print(f"Delta f(switch on) = {f_k[-1]:.3f} +- {d_f_k[-1]:.3f} kT")

    u_kn = np.asarray(est.u_kn)
    # the perturbed-state machinery at a SAMPLED state, from the same samples
    f_same, _ = est.compute_perturbed_free_energies(u_kn[2])
    # reweight to an UNSAMPLED lambda between the ladder rungs
    lam_new = 0.5 * (LAMBDAS[4] + LAMBDAS[5])
    f_l, d_f_l = est.compute_perturbed_free_energies(
        (lam_new / LAMBDAS[0]) * u_kn[0])
    print(f"unsampled lambda={lam_new}: f = {f_l[0]:.3f} +- {d_f_l[0]:.3f} kT")
    overlap = float(est.compute_overlap()["scalar"])
    print(f"overlap scalar = {overlap:.3f}  (near 1 = connected ladder)")
    n_steps = len(LAMBDAS) * n_iterations * n_iterations * number_of_steps
    return dict(f_k=f_k, d_f_k=d_f_k, d_f_k_bootstrap=np.asarray(d_boot),
                u_kn=u_kn, f_same=float(f_same[0]), f_unsampled=float(f_l[0]),
                d_f_unsampled=float(d_f_l[0]), overlap=overlap,
                replica_steps_per_second=n_steps / seconds, seconds=seconds,
                headline=f"{n_steps / seconds:.1f} replica-steps/s, Delta f "
                         f"{f_k[-1]:.3f} +- {d_f_k[-1]:.3f} kT, overlap "
                         f"{overlap:.3f} (> 0.2)")


def check(results):
    f_k, u_kn = results["f_k"], results["u_kn"]
    # oracle 1: u_kn rows are exact lambda multiples of row 0
    for k, lam in enumerate(LAMBDAS):
        np.testing.assert_allclose(u_kn[k], (lam / LAMBDAS[0]) * u_kn[0],
                                   rtol=1e-5)
    print("u_kn proportionality (exact epsilon scaling): OK")
    # oracle 2: perturbed(lambda_2) reproduces the solved f_k[2]
    assert abs(results["f_same"] - f_k[2]) < 1e-6, (results["f_same"], f_k[2])
    print(f"perturbed(lambda={LAMBDAS[2]}) == solved f_k[2]: OK")
    lo, hi = sorted((f_k[4], f_k[5]))
    d = results["d_f_unsampled"]
    assert lo - 4 * d < results["f_unsampled"] < hi + 4 * d, (
        results["f_unsampled"], f_k)
    assert results["overlap"] > 0.2, "ladder spacing should give healthy overlap"
    print("Hamiltonian-ladder free-energy workflow: PASS")


if __name__ == "__main__":
    run_cli(main, check, __doc__)
