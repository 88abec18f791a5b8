"""Lennard-Jones potential parameters (port of ``chiron_tpu/potential.py:137-174``).

Only the constructor's unit validation and the MD-unit floats are ported:
the fused engines in ``ops/`` take sigma, epsilon and cutoff as plain
floats.  The energy paths through neighbour lists are not ported yet.
"""

from __future__ import annotations

from typing import Optional

from . import units
from .topology import Topology


class LJPotential:
    """Lennard-Jones 12-6 potential: validated sigma, epsilon, cutoff."""

    def __init__(
        self,
        topology: Optional[Topology],
        sigma: units.Quantity = 3.350 * units.angstroms,
        epsilon: units.Quantity = 1.0 * units.kilocalories_per_mole,
        cutoff: units.Quantity = units.Quantity(1.0, units.nanometer),
    ):
        if topology is not None and not isinstance(topology, (Topology, property)):
            raise TypeError(
                f"Topology must be a Topology object or None, "
                f"type(topology) = {type(topology)}"
            )
        sigma = units.coerce(sigma)
        epsilon = units.coerce(epsilon)
        cutoff = units.coerce(cutoff)
        for name, q in (("sigma", sigma), ("epsilon", epsilon), ("cutoff", cutoff)):
            if not isinstance(q, units.Quantity):
                raise TypeError(
                    f"{name} must be a unit.Quantity, type({name}) = {type(q)}"
                )
        if not sigma.unit.is_compatible(units.angstrom):
            raise ValueError(f"sigma must have units of distance, got {sigma.unit}")
        if not epsilon.unit.is_compatible(units.kilocalories_per_mole):
            raise ValueError(f"epsilon must have units of energy, got {epsilon.unit}")
        if not cutoff.unit.is_compatible(units.nanometer):
            raise ValueError(f"cutoff must have units of distance, got {cutoff.unit}")

        self.sigma = float(sigma.value_in_unit_system(units.md_unit_system))
        self.epsilon = float(epsilon.value_in_unit_system(units.md_unit_system))
        self.cutoff = float(cutoff.value_in_unit_system(units.md_unit_system))
        self.topology = topology
