"""LJ-fluid test system (port of ``chiron_tpu/testsystems.py:74-114``).

Positions and box vectors are float32 numpy arrays wrapped in
``units.Quantity``, identical to the JAX package's values; the runners'
``init`` moves them onto their device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import units
from .potential import LJPotential
from .topology import Topology


@dataclass
class LennardJonesFluid:
    """Periodic LJ fluid initialized on a cubic lattice.

    Mirrors openmmtools.testsystems.LennardJonesFluid(reduced_density, n):
    box volume V = N sigma^3 / rho*, particles on a simple cubic lattice
    (collision-free start), Argon-like parameters by default.
    """

    nparticles: int = 1000
    reduced_density: float = 0.1
    sigma: units.Quantity = field(default_factory=lambda: 0.34 * units.nanometer)
    epsilon: units.Quantity = field(
        default_factory=lambda: 0.238 * units.kilocalories_per_mole
    )
    cutoff_factor: float = 3.0
    mass: units.Quantity = field(default_factory=lambda: 39.948 * units.amu)

    def __post_init__(self):
        sigma_md = self.sigma.value_in_unit_system(units.md_unit_system)
        volume = self.nparticles * sigma_md ** 3 / self.reduced_density
        L = volume ** (1.0 / 3.0)
        self.box_length = L
        n_side = int(math.ceil(self.nparticles ** (1.0 / 3.0)))
        spacing = L / n_side
        grid = np.arange(n_side) * spacing
        xyz = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"), axis=-1)
        xyz = xyz.reshape(-1, 3)[: self.nparticles]
        self.positions = units.Quantity(
            np.asarray(xyz, dtype=np.float32), units.nanometer
        )
        self.box_vectors = units.Quantity(
            np.eye(3, dtype=np.float32) * L, units.nanometer
        )
        self.topology = Topology.uniform(
            self.nparticles, self.mass.value_in_unit_system(units.md_unit_system)
        )
        self.cutoff = self.cutoff_factor * self.sigma
        self.potential = LJPotential(
            self.topology, sigma=self.sigma, epsilon=self.epsilon, cutoff=self.cutoff
        )
