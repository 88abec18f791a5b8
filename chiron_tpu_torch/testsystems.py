"""Test systems with analytic expectations (port of
``chiron_tpu/testsystems.py``): the harmonic oscillator, the LJ fluid and
the ideal gas.

Positions and box vectors are float32 numpy arrays wrapped in
``units.Quantity``, identical to the JAX package's values; a
``SamplerState`` or a runner's ``init`` moves them onto its device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import units
from .potential import (
    HarmonicOscillatorPotential,
    IdealGasPotential,
    LJPotential,
)
from .topology import Topology


@dataclass
class HarmonicOscillator:
    """3D harmonic oscillator (openmmtools.testsystems.HarmonicOscillator).

    Analytic free energy: f = -(3/2) ln(2 pi kT / K) per oscillator.
    """

    k: units.Quantity = field(
        default_factory=lambda: 100.0 * units.kilojoule_per_mole / units.nanometer ** 2
    )
    U0: units.Quantity = field(
        default_factory=lambda: 0.0 * units.kilojoule_per_mole
    )
    mass: units.Quantity = field(default_factory=lambda: 39.948 * units.amu)

    def __post_init__(self):
        self.topology = Topology.uniform(
            1, self.mass.value_in_unit_system(units.md_unit_system)
        )
        self.positions = units.Quantity(np.zeros((1, 3), dtype=np.float32),
                                        units.nanometer)
        self.potential = HarmonicOscillatorPotential(
            self.topology,
            k=self.k,
            x0=units.Quantity(np.zeros((1, 3), dtype=np.float32),
                              units.nanometer),
            U0=self.U0,
        )

    def reduced_free_energy(self, temperature: units.Quantity) -> float:
        """Dimensionless configurational free energy, -ln Z / kT:
        f(beta) = -(3/2) ln(2 pi / (beta K))."""
        kT = units.kB_MD * units.strip_md(temperature, units.kelvin)
        K = self.k.value_in_unit_system(units.md_unit_system)
        return -1.5 * math.log(2.0 * math.pi * kT / K)

    def expectation_potential_energy(self, temperature: units.Quantity) -> float:
        """<U> = (3/2) kT in kJ/mol (equipartition)."""
        kT = units.kB_MD * units.strip_md(temperature, units.kelvin)
        return 1.5 * kT


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


@dataclass
class IdealGas:
    """Non-interacting gas in a periodic box (openmmtools.testsystems.IdealGas).

    Analytic NpT expectations: <V> = (N+1) kT / p and std(V) = sqrt(N+1) kT
    / p.
    """

    nparticles: int = 216
    temperature: units.Quantity = field(default_factory=lambda: 298.0 * units.kelvin)
    pressure: units.Quantity = field(default_factory=lambda: 1.0 * units.atmosphere)
    mass: units.Quantity = field(default_factory=lambda: 39.948 * units.amu)

    def __post_init__(self):
        kT = units.kB_MD * units.strip_md(self.temperature, units.kelvin)
        p = units.pressure_to_md(self.pressure)
        volume = (self.nparticles + 1) * kT / p  # expected NpT volume, nm^3
        L = volume ** (1.0 / 3.0)
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
        self.potential = IdealGasPotential(self.topology)

    def get_volume_expectation(self, thermodynamic_state) -> float:
        """<V> = (N+1) kT / p in nm^3."""
        kT = thermodynamic_state.kT_md
        p = thermodynamic_state.pressure_md
        return (self.nparticles + 1) * kT / p

    def get_volume_standard_deviation(self, thermodynamic_state) -> float:
        """std(V) = sqrt(N+1) kT / p in nm^3."""
        kT = thermodynamic_state.kT_md
        p = thermodynamic_state.pressure_md
        return math.sqrt(self.nparticles + 1) * kT / p
