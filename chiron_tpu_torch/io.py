"""Structure file I/O: minimal PDB read/write and a V2000 SDF reader
(port of ``chiron_tpu/io.py``, numpy on the port's ``units`` and
``topology``).

The reference chiron ships PDB fixtures and relies on openmm for parsing.
This standalone reader and writer cover the subset the framework needs:
ATOM/HETATM records with names, elements, coordinates, and CRYST1 boxes.
Coordinates are converted between PDB Angstroms and the MD unit system
(nm).
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

from . import units
from .topology import Topology

log = logging.getLogger("chiron_tpu_torch")


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def read_pdb(path: str) -> Tuple[units.Quantity, Topology, Optional[units.Quantity]]:
    """Parse a PDB file.

    Returns (positions Quantity [nm], Topology, box Quantity [nm] or None).
    """
    positions = []
    names = []
    elements = []
    box = None
    with open(path) as fh:
        for line in fh:
            rec = line[:6]
            if rec in ("ATOM  ", "HETATM"):
                x = float(line[30:38])
                y = float(line[38:46])
                z = float(line[46:54])
                positions.append((x, y, z))
                name = line[12:16].strip()
                elem = line[76:78].strip() if len(line) >= 78 else ""
                if not elem:
                    # prefer the single-letter element before the two-letter
                    # guess: 'CA' is almost always an alpha carbon, not
                    # calcium, and 'HG1' a hydrogen, not mercury
                    from .topology import _ELEMENT_MASSES

                    letters = "".join(c for c in name if c.isalpha())
                    one = letters[:1].capitalize()
                    two = letters[:2].capitalize()
                    if one in _ELEMENT_MASSES:
                        elem = one
                    elif two in _ELEMENT_MASSES:
                        elem = two
                    else:
                        elem = two
                names.append(name)
                elements.append(elem)
            elif rec == "CRYST1":
                a = float(line[6:15])
                b = float(line[15:24])
                c = float(line[24:33])
                box = np.diag([a, b, c]) / 10.0  # A -> nm
            elif rec.startswith("ENDMDL"):
                # multi-model (NMR-style) files: read the first model only,
                # matching openmm/mdtraj default-frame semantics -- reading
                # on would silently concatenate every model's atoms
                break

    if not positions:
        raise ValueError(f"{path}: no ATOM/HETATM records found")
    topology = Topology()
    for name, elem in zip(names, elements):
        try:
            topology.add_atom(name, elem)
        except ValueError:
            log.warning(
                "read_pdb: unknown element %r for atom %r; assigning a "
                "12.0-dalton fallback mass", elem, name,
            )
            topology.add_atom(name, elem, mass=12.0)
    pos_nm = np.asarray(positions, dtype=np.float64) / 10.0
    box_q = units.Quantity(box, units.nanometer) if box is not None else None
    return units.Quantity(pos_nm, units.nanometer), topology, box_q


def write_pdb(path: str, positions, topology: Optional[Topology] = None,
              box_vectors=None) -> None:
    """Write a single-model PDB. Positions in nm (array, tensor or
    Quantity)."""
    pos = units.strip_md(positions, units.nanometer)
    pos = _host(pos).astype(np.float64) * 10.0  # nm -> A
    n = pos.shape[0]
    lines = []
    if box_vectors is not None:
        box = units.strip_md(box_vectors, units.nanometer)
        a, b, c = (np.diagonal(_host(box)) * 10.0).tolist()
        lines.append(
            f"CRYST1{a:9.3f}{b:9.3f}{c:9.3f}  90.00  90.00  90.00 P 1"
            "           1"
        )
    atoms = list(topology.atoms()) if topology is not None else None
    for i in range(n):
        name = atoms[i].name[:4] if atoms else f"Ar"
        elem = atoms[i].element[:2] if atoms else "Ar"
        lines.append(
            f"ATOM  {i + 1:5d} {name:<4s} UNK A{1:4d}    "
            f"{pos[i, 0]:8.3f}{pos[i, 1]:8.3f}{pos[i, 2]:8.3f}"
            f"  1.00  0.00          {elem:>2s}"
        )
    lines.append("END")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def read_sdf(path: str) -> Tuple[units.Quantity, Topology, list]:
    """Minimal V2000 SDF reader (the reference chiron ships ethanol.sdf and imports it
    through openff; this standalone parser
    covers the atom + bond blocks the framework needs).

    Returns (positions Quantity (N,3) in nm, Topology, bonds as (i, j)
    0-indexed pairs).
    """
    with open(path) as fh:
        lines = fh.read().splitlines()
    if len(lines) < 4:
        raise ValueError(f"{path}: not an SDF file (fewer than 4 lines)")
    counts = lines[3]
    try:
        n_atoms = int(counts[0:3])
        n_bonds = int(counts[3:6])
    except ValueError as e:
        raise ValueError(f"{path}: malformed V2000 counts line") from e
    if len(lines) < 4 + n_atoms + n_bonds:
        raise ValueError(
            f"{path}: truncated SDF (counts line claims {n_atoms} atoms + "
            f"{n_bonds} bonds but the file has {len(lines)} lines)"
        )
    topology = Topology()
    positions = []
    counts_per_elem: dict = {}
    for i in range(n_atoms):
        ln = lines[4 + i]
        x, y, z = float(ln[0:10]), float(ln[10:20]), float(ln[20:30])
        elem = ln[30:34].strip()
        counts_per_elem[elem] = counts_per_elem.get(elem, 0) + 1
        name = f"{elem}{counts_per_elem[elem]}"
        try:
            topology.add_atom(name, elem)
        except ValueError:
            log.warning(
                "read_sdf: unknown element %r for atom %r; assigning a "
                "12.0-dalton fallback mass", elem, name,
            )
            topology.add_atom(name, elem, mass=12.0)
        positions.append((x, y, z))
    bonds = []
    for i in range(n_bonds):
        ln = lines[4 + n_atoms + i]
        bonds.append((int(ln[0:3]) - 1, int(ln[3:6]) - 1))
    pos_nm = np.asarray(positions, dtype=np.float64) / 10.0  # A -> nm
    return units.Quantity(pos_nm, units.nanometer), topology, bonds
