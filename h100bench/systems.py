"""A configuration file's LJ fluid: its lattice, its box and its constants
in MD units (nm, ps, amu, kJ/mol), made by the harness from the file alone.
Both the program and the reference start from what this module makes."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .reference.lj import KB_KJ_PER_MOL_K, KCAL, LJ, Langevin


@dataclass(frozen=True)
class Fluid:
    n: int
    box: float            # cubic box length, nm
    lj: LJ
    lng: Langevin
    temperature: float    # K
    positions: np.ndarray  # (n, 3) float32 lattice sites, nm

    @property
    def kT(self) -> float:
        return KB_KJ_PER_MOL_K * self.temperature


def simple_cubic(n: int, box: float) -> np.ndarray:
    """The first ``n`` sites of the smallest simple-cubic grid that holds
    them, spaced to fill the box (``LennardJonesFluid``'s start)."""
    side = int(math.ceil(n ** (1.0 / 3.0)))
    grid = np.arange(side) * (box / side)
    xyz = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"), axis=-1)
    return np.asarray(xyz.reshape(-1, 3)[:n], dtype=np.float32)


def fcc(cells, box: float) -> np.ndarray:
    """The four-site fcc lattice of ``cells`` unit cells a side that fill a
    cubic box (LAMMPS ``lattice fcc``, ``create_atoms 1 box``)."""
    a = box / cells
    basis = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                      [0.0, 0.5, 0.5]])
    idx = np.arange(cells)
    corners = np.stack(np.meshgrid(idx, idx, idx, indexing="ij"),
                       axis=-1).reshape(-1, 1, 3)
    sites = (corners + basis[None]).reshape(-1, 3) * a
    return np.asarray(sites, dtype=np.float32)


def fluid(config: dict) -> Fluid:
    """The fluid of a configuration file."""
    sigma = config["sigma_nm"]
    n = config["n_particles"]
    box = sigma * (n / config["reduced_density"]) ** (1.0 / 3.0)
    lattice = config["lattice"]
    if lattice == "simple_cubic":
        pos = simple_cubic(n, box)
    elif lattice == "fcc":
        cells = config["unit_cells"]
        if 4 * cells ** 3 != n:
            raise ValueError(f"fcc: {cells} cells a side hold {4 * cells ** 3}"
                             f" sites, not {n}")
        pos = fcc(cells, box)
    else:
        raise ValueError(f"unknown lattice {lattice!r}")
    lj = LJ(sigma=sigma, epsilon=config["epsilon_kcal_per_mol"] * KCAL,
            cutoff=config["cutoff_sigma"] * sigma)
    lng = Langevin(dt=config["timestep_fs"] * 1e-3,
                   gamma=config["collision_rate_per_ps"],
                   mass=config["mass_amu"])
    return Fluid(n=n, box=box, lj=lj, lng=lng,
                 temperature=config["temperature_K"], positions=pos)
