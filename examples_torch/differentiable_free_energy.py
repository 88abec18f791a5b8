"""Differentiable free energies: autograd THROUGH the MBAR estimator.

The port of ``examples/differentiable_free_energy.py``, the companion of
``differentiable_md.py`` (gradients through the *sampler*): here gradients
flow through the *analysis* layer.  ``analysis.mbar_solve_implicit`` (an
``autograd.Function`` whose backward is the implicit-function-theorem VJP
of the MBAR fixed point) closes the chain, so force-field sensitivities of
free energies come from one backward pass:

    samples -> U(x; eps, sigma) -> u_kn -> MBAR -> Delta f
                                                   |
    d Delta f / d (eps_k, sigma)  <---- autograd --+

The workload is an alchemical epsilon ladder on a small LJ fluid sampled by
Metropolis displacement chains on ``PairListNsqrd``.

Two distinct gradients exist here, and the program demonstrates both:

* the ESTIMATOR's sensitivity -- autograd through the solve, where a
  sampled state's u_kn row is both target and origin declaration; exact for
  the estimator (checked against f64 finite differences) but not a
  consistent estimator of the physical d(Delta f)/d theta;
* the PHYSICAL gradient -- freeze the origins (one solve at the sampled
  parameters), express the endpoint as a theta-dependent TARGET state on the
  pooled samples (``mbar_perturbed_free_energies_torch``), and
  differentiate: the reweighted TI estimator sum_n W_ln du_ln/d theta, the
  one a Newton fit of eps_K to a target Delta f drives.

Checks: (1) estimator-gradient exactness vs f64 finite differences; (2) the
physical gradient equals the reweighted TI expectation exactly and the
direct TI sample average statistically; (3) the unsampled-state gradient
identity df_l/du_ln == W_ln; (4) the Newton fit reaches its target.
"""

import os
import sys

if __package__ in (None, ""):  # run as a script from a checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from chiron_tpu_torch import units
from chiron_tpu_torch.analysis import (
    mbar_perturbed_free_energies_torch,
    mbar_solve,
    mbar_solve_implicit,
)
from chiron_tpu_torch.mcmc import MonteCarloDisplacementMove
from chiron_tpu_torch.neighbors import OrthogonalPeriodicSpace, PairListNsqrd
from chiron_tpu_torch.states import SamplerState, ThermodynamicState
from chiron_tpu_torch.testsystems import LennardJonesFluid
from chiron_tpu_torch.utils import PRNG
from examples_torch._common import require_device, run_cli, timed

LAMBDAS = [0.4, 0.6, 0.8, 1.0]
LAMBDA_NEW = 0.7  # an unsampled rung


def displacement_move(moves_per_snapshot):
    """A state's chain between snapshots: sigma 0.05 nm, autotuned once a
    snapshot."""
    return MonteCarloDisplacementMove(
        displacement_sigma=0.05 * units.nanometer,
        number_of_moves=moves_per_snapshot,
        autotune=True, autotune_interval=moves_per_snapshot)


def sample_ladder(fluid, lambdas, T, n_snapshots, moves_per_snapshot,
                  n_equil_snapshots, device):
    """Sample each epsilon-scaled state with a displacement chain; snapshot
    positions between segments.  Returns (K * n_snapshots, N, 3)."""
    snaps = []
    for lam in lambdas:
        potential = type(fluid.potential)(
            fluid.topology, sigma=fluid.sigma,
            epsilon=lam * fluid.epsilon, cutoff=fluid.cutoff)
        thermo = ThermodynamicState(potential, temperature=T)
        state = SamplerState(fluid.positions,
                             current_PRNG_key=PRNG.get_random_key(),
                             box_vectors=fluid.box_vectors, device=device)
        pairs = PairListNsqrd(OrthogonalPeriodicSpace(), cutoff=fluid.cutoff)
        pairs.build_from_state(state)
        move = displacement_move(moves_per_snapshot)
        xs = []
        for s in range(n_snapshots + n_equil_snapshots):
            state, thermo, pairs = move.update(state, thermo, pairs)
            if s >= n_equil_snapshots:
                xs.append(state.positions.detach().cpu().numpy())
        snaps.append(np.stack(xs))
        print(f"  lambda={lam:.2f}: {len(xs)} snapshots, "
              f"acceptance {move.n_accepted / move.n_proposed:.2f}")
    return np.concatenate(snaps)


def lj_energies(xs, eps, sigma, box, cutoff):
    """The LJ energy of each of the (M, n, 3) samples, (M,): every pair
    within the cutoff once, minimum image in the box ``box`` (3,)."""
    n = xs.shape[1]
    ids = torch.arange(n, device=xs.device)
    d = xs[:, :, None, :] - xs[:, None, :, :]
    d = d - box * torch.round(d / box)
    r2 = (d * d).sum(-1)
    mask = (r2 < cutoff * cutoff) & (ids[:, None] < ids[None, :])
    s6 = ((sigma * sigma) / torch.where(mask, r2, torch.ones_like(r2))) ** 3
    return torch.where(mask, 4.0 * eps * (s6 * s6 - s6),
                       torch.zeros_like(r2)).sum((1, 2))


class LadderAnalysis:
    """The analysis of one fixed sample set ``xs`` (K blocks of equal size,
    block k from state k), in the samples' dtype and on their device."""

    def __init__(self, xs, n_states, box, cutoff, beta):
        self.xs, self.box, self.cutoff, self.beta = xs, box, cutoff, beta
        self.n_cfg = xs.shape[0] // n_states
        self.N_k = torch.full((n_states,), self.n_cfg, dtype=xs.dtype,
                              device=xs.device)

    def u_kn(self, eps_k, sigma):
        """Reduced potentials of every sample at every state's epsilon."""
        return self.beta * torch.stack([
            lj_energies(self.xs, e, sigma, self.box, self.cutoff)
            for e in eps_k])

    def delta_f(self, eps_k, sigma):
        """Reduced free energy of the last rung against the first, a
        differentiable function of every state's epsilon and sigma."""
        return mbar_solve_implicit(self.u_kn(eps_k, sigma), self.N_k)[-1]

    def estimator_gradient(self, eps_k, sigma):
        """(Delta f, d Delta f/d eps_k, d Delta f/d sigma) through the
        solve."""
        eps_k = eps_k.detach().requires_grad_(True)
        sigma = sigma.detach().requires_grad_(True)
        df = self.delta_f(eps_k, sigma)
        g_eps, g_sig = torch.autograd.grad(df, (eps_k, sigma))
        return df.detach(), g_eps, g_sig

    def delta_f_host(self, eps_k, sigma):
        """Delta f by the f64 host solver (no gradient)."""
        with torch.no_grad():
            u = self.u_kn([torch.as_tensor(e, dtype=self.xs.dtype)
                           for e in eps_k], sigma)
        return mbar_solve(u.double().cpu().numpy(),
                          self.N_k.cpu().numpy())[-1]

    def freeze(self, eps_k, sigma):
        """One solve at the sampled parameters pins the origins."""
        with torch.no_grad():
            self.sigma0 = torch.as_tensor(sigma, dtype=self.xs.dtype,
                                          device=self.xs.device)
            self.u_kn0 = self.u_kn(eps_k, self.sigma0)
            self.f_k = mbar_solve_implicit(self.u_kn0, self.N_k)
            self.log_denom = torch.logsumexp(
                (self.f_k + torch.log(self.N_k))[:, None] - self.u_kn0, dim=0)

    def u_target(self, eps):
        return self.beta * lj_energies(self.xs, eps, self.sigma0, self.box,
                                       self.cutoff)

    def target_free_energy(self, eps):
        """The frozen-origin free energy of the state at ``eps`` (sigma0),
        reweighted on the pooled samples."""
        return mbar_perturbed_free_energies_torch(
            self.u_kn0, self.N_k, self.f_k, self.u_target(eps)[None, :])[0]

    def physical_gradient(self, eps):
        """(f(eps), df/d eps) of :meth:`target_free_energy`."""
        eps = torch.as_tensor(eps, dtype=self.xs.dtype,
                              device=self.xs.device).detach().requires_grad_(True)
        f = self.target_free_energy(eps)
        (g,) = torch.autograd.grad(f, eps)
        return f.detach(), g

    def reweighted_ti(self, eps):
        """sum_n W_n beta dU_n/d eps at the target ``eps``: the reweighting
        identity the physical gradient must equal.  U is linear in eps, so
        dU_n/d eps is U_n at eps = 1."""
        with torch.no_grad():
            u = self.u_target(eps)
            f_l = -torch.logsumexp(-u - self.log_denom, dim=0)
            W = torch.exp(f_l - u - self.log_denom)
            dU = self.u_target(1.0)  # beta dU_n / d eps
            return (W * dU).sum()

    def direct_ti(self, j):
        """<beta dU/d eps> over state ``j``'s own block of samples."""
        with torch.no_grad():
            block = slice(j * self.n_cfg, (j + 1) * self.n_cfg)
            return self.u_target(1.0)[block].mean()

    def newton_step(self, eps, target):
        """One scalar Newton step of eps toward f(eps) == target."""
        f, g = self.physical_gradient(eps)
        return (eps - (f - target) / g).detach()


def main(device="cuda", n_snapshots=60, moves_per_snapshot=100,
         n_equil_snapshots=20, newton_iterations=8):
    dev = require_device(device)
    n = 27
    md = units.md_unit_system
    fluid = LennardJonesFluid(nparticles=n, reduced_density=0.4)
    T = 300.0 * units.kelvin
    beta = 1.0 / (units.kB_MD * 300.0)
    sig0 = float(fluid.sigma.value_in_unit_system(md))
    eps0 = float(fluid.epsilon.value_in_unit_system(md))
    cut = float(fluid.cutoff.value_in_unit_system(md))
    f32 = dict(dtype=torch.float32, device=dev)
    box = torch.as_tensor(np.array(np.diagonal(
        fluid.box_vectors.value_in_unit_system(md))), **f32)

    PRNG.set_seed(7)
    print("sampling the epsilon ladder with Metropolis displacement chains")
    x_n, t_sample = timed(dev, lambda: sample_ladder(
        fluid, LAMBDAS, T, n_snapshots, moves_per_snapshot,
        n_equil_snapshots, dev))
    ana = LadderAnalysis(torch.as_tensor(x_n, **f32), len(LAMBDAS), box, cut,
                         beta)

    eps_k0 = torch.tensor([lam * eps0 for lam in LAMBDAS], **f32)
    df, g_eps, g_sig = ana.estimator_gradient(eps_k0, torch.tensor(sig0, **f32))
    df, g_sig = float(df), float(g_sig)
    print(f"Delta f (lambda {LAMBDAS[0]} -> {LAMBDAS[-1]}) = {df:.4f} kT")
    print("d Delta f / d eps_k =", np.round(g_eps.cpu().numpy(), 4))
    print(f"d Delta f / d sigma = {g_sig:+.3f} kT/nm")

    # -- check 1: exactness vs f64 host finite differences ---------------
    h = 1e-3 * sig0
    fd_sig = (ana.delta_f_host(eps_k0, sig0 + h)
              - ana.delta_f_host(eps_k0, sig0 - h)) / (2 * h)
    rel_sig = abs(fd_sig - g_sig) / abs(fd_sig)
    print(f"finite diff sigma   = {fd_sig:+.3f}  (rel err {rel_sig:.1e})")
    j = len(LAMBDAS) - 1
    he = 1e-3 * eps0
    ep = eps_k0.cpu().numpy().copy()
    ep[j] += he
    em = eps_k0.cpu().numpy().copy()
    em[j] -= he
    fd_eps = (ana.delta_f_host(ep, sig0) - ana.delta_f_host(em, sig0)) / (2 * he)
    rel_eps = abs(fd_eps - float(g_eps[j])) / abs(fd_eps)
    print(f"finite diff eps_K   = {fd_eps:+.3f}  (rel err {rel_eps:.1e})")

    # -- check 2: the PHYSICAL gradient (frozen origins) ------------------
    ana.freeze(eps_k0, sig0)
    _, g_phys = ana.physical_gradient(eps_k0[j])
    g_phys = float(g_phys)
    reweighted = float(ana.reweighted_ti(eps_k0[j]))
    ti = float(ana.direct_ti(j))
    print(f"physical d Delta f/d eps_K = {g_phys:+.3f} == reweighted TI "
          f"{reweighted:+.3f}; direct TI <beta dU/deps>_K = {ti:+.3f} "
          f"(estimator-sensitivity grad, a DIFFERENT object: "
          f"{float(g_eps[j]):+.3f})")

    # -- check 3: unsampled state -- gradient == reweighted expectation --
    eps_new = torch.tensor(LAMBDA_NEW * eps0, **f32)
    g_new = float(ana.physical_gradient(eps_new)[1])
    expected = float(ana.reweighted_ti(eps_new))
    rel_new = abs(g_new - expected) / max(abs(expected), 1e-9)
    print(f"unsampled lambda={LAMBDA_NEW}: d f/d eps = {g_new:+.3f} == "
          f"reweighted beta <dU/deps> = {expected:+.3f} (rel {rel_new:.1e})")

    # -- what the gradient is FOR: force-field fitting --------------------
    # scalar Newton on the physical (frozen-origin) objective toward a
    # Delta f 1 kT above the sampled one, well inside the ladder's span
    target = df + 1.0
    e_cur = eps_k0[j]
    for it in range(newton_iterations):
        if abs(float(ana.target_free_energy(e_cur)) - target) < 1e-4:
            break
        e_cur = ana.newton_step(e_cur, target)
    reached = float(ana.target_free_energy(e_cur))
    print(f"fit: eps_K {float(eps_k0[j]):.4f} -> {float(e_cur):.4f} "
          f"reaches Delta f = {reached:.4f} (target {target:.4f}) in {it} "
          f"Newton steps")
    n_proposals = len(LAMBDAS) * (n_snapshots + n_equil_snapshots) \
        * moves_per_snapshot
    return dict(delta_f=df, g_eps=g_eps.cpu().numpy(), g_sigma=g_sig,
                rel_sigma=rel_sig, rel_eps=rel_eps, g_phys=g_phys,
                reweighted_ti=reweighted, direct_ti=ti, rel_unsampled=rel_new,
                fit=reached, target=target,
                proposals_per_second=n_proposals / t_sample,
                headline=f"gradient errors {rel_sig:.3e} (sigma), "
                         f"{rel_eps:.3e} (eps_K) (< 2e-2), Newton fit "
                         f"{abs(reached - target):.2e} from its target, "
                         f"{n_proposals / t_sample:.1f} proposals/s")


def check(results):
    r = results
    assert r["rel_sigma"] < 2e-2, r["rel_sigma"]
    assert r["rel_eps"] < 2e-2, r["rel_eps"]
    assert abs(r["g_phys"] - r["reweighted_ti"]) < 1e-3 * max(
        abs(r["reweighted_ti"]), 1.0), (r["g_phys"], r["reweighted_ti"])
    # statistical agreement with the direct TI average
    assert abs(r["g_phys"] - r["direct_ti"]) / abs(r["direct_ti"]) < 0.15, (
        r["g_phys"], r["direct_ti"])
    assert r["rel_unsampled"] < 1e-3, r["rel_unsampled"]
    assert abs(r["fit"] - r["target"]) < 1e-3, (r["fit"], r["target"])
    print("differentiable free-energy pipeline: PASS")


if __name__ == "__main__":
    run_cli(main, check, __doc__)
