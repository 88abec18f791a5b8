"""Differentiable MD: gradients THROUGH a Langevin trajectory.

The port of ``examples/differentiable_md.py``.  The whole BAOAB trajectory
is a Python loop of torch operations with the potential's parameters as
tensors, its force ``-autograd.grad(energy, x, create_graph=True)``, so a
backward pass flows end to end through every step:

    d <U_final> / d epsilon   via reverse mode over a 200-step chain

validated against a central finite difference.  The noise is drawn up
front from an explicit ``torch.Generator`` (a reparameterized trajectory,
exactly differentiable).  The energy is the program's own plain all-pairs
sum, not K1: K1's autograd function has the force as its gradient and no
second derivative.
"""

import math
import os
import sys

if __package__ in (None, ""):  # run as a script from a checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from chiron_tpu_torch import units
from chiron_tpu_torch.testsystems import LennardJonesFluid
from chiron_tpu_torch.utils import PRNG
from examples_torch._common import require_device, run_cli, timed

TEMPERATURE = 120.0  # K
MASS = 39.9          # amu
EPS0, SIG0 = 0.99579, 0.34  # kJ/mol, nm: the point the gradient is taken at


def make_traj_energy(n, box_diag, kT, masses, dt=0.002, gamma=1.0,
                     n_steps=200, cutoff=1.02):
    """Returns ``loss(eps, sigma, x0, noises, v_noise)``: the potential
    energy after an ``n_steps`` BAOAB chain from ``x0`` with the standard
    normal ``noises`` (n_steps, n, 3) and initial velocity draws ``v_noise``
    (n, 3), differentiable in (eps, sigma)."""
    a = math.exp(-gamma * dt)
    b = math.sqrt(1.0 - math.exp(-2.0 * gamma * dt))
    m = masses[:, None]
    sigv = torch.sqrt(kT / m)
    ids = torch.arange(n, device=box_diag.device)
    upper = ids[:, None] < ids[None, :]

    def energy(eps, sigma, x):
        d = x[:, None, :] - x[None, :, :]
        d = d - box_diag * torch.round(d / box_diag)
        r2 = (d * d).sum(-1)
        mask = (r2 < cutoff * cutoff) & upper
        r2s = torch.where(mask, r2, torch.ones_like(r2))
        s2 = (sigma * sigma) / r2s
        s6 = s2 * s2 * s2
        return torch.where(mask, 4.0 * eps * (s6 * s6 - s6),
                           torch.zeros_like(r2)).sum()

    def loss(eps, sigma, x0, noises, v_noise):
        create_graph = torch.is_grad_enabled() and (
            eps.requires_grad or sigma.requires_grad)

        def force(x):
            # a position that does not depend on the parameters (x0, or
            # every x outside a backward) is a new leaf of the force's graph
            if not (create_graph and x.requires_grad):
                x = x.detach().requires_grad_(True)
            with torch.enable_grad():
                (g,) = torch.autograd.grad(energy(eps, sigma, x), x,
                                           create_graph=create_graph)
            return -g

        x, v = x0, sigv * v_noise
        F = force(x)
        for noise in noises:
            v = v + 0.5 * dt * F / m
            x = x + 0.5 * dt * v
            v = a * v + b * sigv * noise
            x = x + 0.5 * dt * v
            x = x - box_diag * torch.floor(x / box_diag)
            F = force(x)
            v = v + 0.5 * dt * F / m
        return energy(eps, sigma, x)

    return loss


def draw_noise(n, n_steps, seed, device):
    """(noises (n_steps, n, 3), v_noise (n, 3)), standard normal, from a
    ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    noises = torch.randn((n_steps, n, 3), generator=gen, device=device)
    return noises, torch.randn((n, 3), generator=gen, device=device)


def main(device="cuda", n=125, n_steps=200):
    dev = require_device(device)
    md = units.md_unit_system
    fluid = LennardJonesFluid(nparticles=n, reduced_density=0.5)
    f32 = dict(dtype=torch.float32, device=dev)
    box_diag = torch.as_tensor(
        np.array(np.diagonal(fluid.box_vectors.value_in_unit_system(md))),
        **f32)
    x0 = torch.as_tensor(fluid.positions.value_in_unit_system(md), **f32)
    kT = units.kB_MD * TEMPERATURE
    masses = torch.full((n,), MASS, **f32)
    PRNG.set_seed(1234)
    noises, v_noise = draw_noise(n, n_steps, PRNG.get_random_key(), dev)
    loss = make_traj_energy(n, box_diag, kT, masses, n_steps=n_steps)

    eps0 = torch.tensor(EPS0, requires_grad=True, **f32)
    sig0 = torch.tensor(SIG0, requires_grad=True, **f32)

    def backward():
        return torch.autograd.grad(loss(eps0, sig0, x0, noises, v_noise),
                                   (eps0, sig0))

    (g_eps, g_sig), seconds = timed(dev, backward)
    g_eps, g_sig = float(g_eps), float(g_sig)
    print(f"reverse mode through {n_steps} BAOAB steps in {seconds:.1f}s")
    print(f"dU_final/d_eps  = {g_eps:+.3f}")
    print(f"dU_final/d_sigma= {g_sig:+.1f}")

    # central finite difference on epsilon
    h = 1e-3
    with torch.no_grad():
        fd = (float(loss(eps0 + h, sig0, x0, noises, v_noise))
              - float(loss(eps0 - h, sig0, x0, noises, v_noise))) / (2 * h)
    rel = abs(fd - g_eps) / max(abs(fd), 1e-9)
    print(f"finite diff     = {fd:+.3f}  (rel err {rel:.2e})")
    return dict(g_eps=g_eps, g_sigma=g_sig, finite_difference=fd,
                rel_error=rel, seconds=seconds,
                headline=f"gradient error {rel:.3e} against the central "
                         f"difference (< 0.05), backward {seconds:.3f} s")


def check(results):
    assert results["rel_error"] < 0.05, results


if __name__ == "__main__":
    run_cli(main, check, __doc__)
