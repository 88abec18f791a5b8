"""Minimal molecular topology for the PyTorch port (a copy of
``chiron_tpu/topology.py``, which cannot be imported without jax).

The reference delegates topology handling to ``openmm.app.Topology`` (see
reference chiron/toplogy.py:11-48 and chiron/utils.py:101-113, which only ever
query the atom count and per-atom masses).  openmm is not a dependency of this
build, so we provide a light-weight standalone ``Topology`` capturing exactly
what the framework needs: particle names, element symbols, and masses.

The mass array is the single topology-derived quantity on the hot path (it
becomes a device array inside the integrator), so it is stored as a plain
numpy array in MD units (dalton).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence

import numpy as np

from . import units

# Masses (dalton) for the handful of elements the test systems use.
_ELEMENT_MASSES = {
    "H": 1.00794,
    "C": 12.011,
    "N": 14.007,
    "O": 15.999,
    "Ne": 20.1797,
    "Ar": 39.948,
    "CH4": 16.04,  # united-atom methane (TraPPE-UA), reference Examples/LJ_MCMC.py
}


@dataclass
class Atom:
    name: str
    element: str
    mass: float  # dalton
    index: int


class Topology:
    """Standalone topology: an ordered collection of atoms with masses.

    Mirrors the subset of ``openmm.app.Topology`` used by the reference:
    ``getNumAtoms()`` (reference chiron/utils.py:103) and iteration over
    atoms for masses (reference chiron/utils.py:106-113).
    """

    def __init__(self, atoms: Optional[Sequence[Atom]] = None):
        self._atoms: List[Atom] = list(atoms) if atoms else []

    # -- construction ------------------------------------------------------
    @classmethod
    def from_masses(
        cls, masses, names: Optional[Sequence[str]] = None, element: str = "Ar"
    ) -> "Topology":
        masses = units.strip_md(masses, units.amu)
        masses = np.atleast_1d(np.asarray(masses, dtype=np.float64))
        atoms = [
            Atom(
                name=(names[i] if names is not None else f"{element}{i}"),
                element=element,
                mass=float(m),
                index=i,
            )
            for i, m in enumerate(masses)
        ]
        return cls(atoms)

    @classmethod
    def uniform(cls, n_particles: int, mass=39.948, element: str = "Ar") -> "Topology":
        """Topology of ``n_particles`` identical particles (e.g. an LJ fluid)."""
        mass_md = units.strip_md(mass, units.amu)
        return cls.from_masses(np.full(n_particles, mass_md), element=element)

    def add_atom(self, name: str, element: str, mass=None) -> Atom:
        if mass is None:
            if element not in _ELEMENT_MASSES:
                raise ValueError(f"Unknown element {element!r}; pass mass explicitly")
            mass = _ELEMENT_MASSES[element]
        atom = Atom(name, element, units.strip_md(mass, units.amu), len(self._atoms))
        self._atoms.append(atom)
        return atom

    # -- queries (openmm-compatible naming) --------------------------------
    def getNumAtoms(self) -> int:
        return len(self._atoms)

    @property
    def n_atoms(self) -> int:
        return len(self._atoms)

    def atoms(self) -> Iterable[Atom]:
        return iter(self._atoms)

    def masses(self) -> np.ndarray:
        """Per-atom masses in dalton as a numpy array."""
        return np.array([a.mass for a in self._atoms], dtype=np.float64)

    def __len__(self) -> int:
        return len(self._atoms)

    def __repr__(self) -> str:
        return f"Topology(n_atoms={len(self._atoms)})"


class PerceivedTopology(Topology):
    """Topology with chemical-perception queries.

    The reference scaffolds these but implements none of them (reference
    chiron/toplogy.py:24-48, incl. the [sic] ``PerveivedTopology`` spelling);
    kept as documented placeholders so downstream code can target the API.
    """

    def get_water_molecules(self):
        raise NotImplementedError(
            "water perception is a placeholder (as upstream)"
        )

    def get_protein_atoms(self):
        raise NotImplementedError(
            "protein perception is a placeholder (as upstream)"
        )

    def get_ligand_atoms(self):
        raise NotImplementedError(
            "ligand perception is a placeholder (as upstream)"
        )

    def get_center_of_mass(self, positions):
        """COM of the system in the positions' units."""
        import numpy as _np

        m = self.masses()
        w = m / m.sum()
        return _np.asarray(positions).T @ w
