"""Deterministically pack the reference NpT methane workload's start state.

The reference example loads a packmol-packed 1100-particle united-atom
methane configuration in a 4.275 nm cubic box (reference
Examples/LJ_MCMC.py:29-42, min spacing 0.4 nm).  This program (the port of
``examples/pack_methane.py``) produces an equivalent liquid configuration
deterministically: an 11^3 lattice restricted to 1100 sites, jittered (the
same numpy draws as the JAX program's, so the same start), then
equilibrated for 5000 BAOAB steps at 140 K with the TraPPE-UA methane
potential (a plain torch all-pairs force on the device).

The BAOAB noise comes from a ``torch.Generator``, not JAX's threefry, so the
packing differs from the committed ``chiron_tpu_torch/data/
methane_1100_box4p275.npy`` (a copy of the JAX program's) while passing the
same sanity bounds.  ``--write`` saves the packing as
``methane_1100_box4p275.npy`` under ``--out-dir`` (the current directory by
default); without it nothing is written.  The package's copy is never
replaced.
"""

import os
import sys

if __package__ in (None, ""):  # run as a script from a checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from examples_torch._common import require_device, run_cli, timed

BOX_L = 4.275021399280942   # nm (reference Examples/LJ_MCMC.py:33-40)
N = 1100
SIGMA = 0.373               # nm   (TraPPE-UA methane)
EPSILON = 148.0 * 0.008314462618  # kJ/mol (eps/kB = 148 K)
CUTOFF = 1.4                # nm
MASS = 16.04                # amu
T = 140.0                   # K
KB = 0.008314462618         # kJ/mol/K
DATA_FILE = "methane_1100_box4p275.npy"


def lattice(seed: int = 2026) -> np.ndarray:
    """The jittered lattice the chain starts from: 1100 of the 11^3 sites,
    drawn by numpy's ``default_rng(seed)`` as the JAX program draws them."""
    rng = np.random.default_rng(seed)
    side = 11
    g = (np.arange(side) + 0.5) * (BOX_L / side)
    sites = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1).reshape(-1, 3)
    keep = rng.permutation(side ** 3)[:N]
    return sites[np.sort(keep)] + rng.normal(0.0, 0.01, (N, 3))


def force(x: torch.Tensor) -> torch.Tensor:
    """All-pairs minimum-image LJ force within the cutoff, (N, 3)."""
    L = BOX_L
    d = x[:, None, :] - x[None, :, :]
    d = d - L * torch.round(d / L)
    r2 = (d * d).sum(-1)
    ids = torch.arange(x.shape[0], device=x.device)
    m = (r2 < CUTOFF * CUTOFF) & (ids[:, None] != ids[None, :])
    r2s = torch.where(m, r2, torch.ones_like(r2))
    s2 = (SIGMA * SIGMA) / r2s
    s6 = s2 * s2 * s2
    coef = torch.where(m, 24.0 * EPSILON * (2 * s6 * s6 - s6) / r2s,
                       torch.zeros_like(r2))
    return (coef[..., None] * d).sum(1)


def pack(seed: int = 2026, n_steps: int = 5000, device="cuda") -> np.ndarray:
    """``n_steps`` BAOAB steps (2 fs, 1/ps) from ``lattice(seed)``; the
    final positions, float32 (N, 3) in nm."""
    kT = KB * T
    dt = 0.002
    gamma = 1.0
    a = float(np.exp(-gamma * dt))
    b = float(np.sqrt(1.0 - a * a))
    sig_v = float(np.sqrt(kT / MASS))
    L = BOX_L
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.as_tensor(lattice(seed), dtype=torch.float32, device=device)
    v = torch.zeros_like(x)
    F = force(x)
    for _ in range(n_steps):
        v = v + (0.5 * dt) * F / MASS
        x = x + (0.5 * dt) * v
        v = a * v + b * sig_v * torch.randn(x.shape, generator=gen,
                                            device=device)
        x = x + (0.5 * dt) * v
        x = x - L * torch.floor(x / L)
        F = force(x)
        v = v + (0.5 * dt) * F / MASS
    return x.cpu().numpy()


def main(device="cuda", seed=2026, n_steps=5000, write=False, out_dir="."):
    dev = require_device(device)
    xf, seconds = timed(dev, lambda: pack(seed, n_steps, dev))
    d = xf[:, None, :].astype(np.float64) - xf[None, :, :]
    d = d - BOX_L * np.round(d / BOX_L)
    r = np.sqrt((d ** 2).sum(-1) + np.eye(N) * 1e3)
    results = dict(positions=xf, min_distance=float(r.min()),
                   steps_per_second=n_steps / seconds, path=None,
                   headline=f"{n_steps / seconds:.1f} steps/s, min image "
                            f"distance {r.min():.4f} nm (> 0.3)")
    print(f"{n_steps} BAOAB steps in {seconds:.2f} s; min image distance "
          f"{r.min():.4f} nm")
    if write:
        check(results)  # never write a packing that fails the bounds
        out = os.path.join(out_dir, DATA_FILE)
        np.save(out, xf.astype(np.float32))
        results["path"] = out
        print(f"wrote {out}, shape {xf.shape}")
    return results


def check(results):
    # sanity: liquid-like, no deep overlaps, inside the box
    xf = results["positions"]
    assert results["min_distance"] > 0.3, results["min_distance"]
    assert xf.min() >= 0.0 and xf.max() <= BOX_L


if __name__ == "__main__":
    run_cli(main, check, __doc__)
