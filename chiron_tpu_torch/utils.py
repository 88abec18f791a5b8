"""Utilities: PRNG keys, masses, velocity initialization
(port of ``chiron_tpu/utils.py``).

The JAX key becomes a plain 64-bit integer.  ``split`` derives children by
splitmix64 (the child ``i`` of ``key`` is the mix of ``key + (i + 1)
gamma``, gamma the golden-ratio increment), and a draw seeds a
``torch.Generator`` on the tensors' device from a key.  So the same seed
gives the same stream on the same backend, and a key is data that a
checkpoint can save, unlike a generator's state.  The stream differs from
JAX's threefry by design: the port's trajectories are not the JAX
package's bit for bit, and its PRNG goldens do not apply here (the tests
feed both packages the same noise instead).

``get_data_file_path`` resolves ``<file>`` in the port's own ``data/``
directory beside this module, and ``get_full_path`` a path relative to the
directory that holds the package.
JAX's ``enable_compilation_cache`` has no counterpart: PyTorch compiles
nothing on the path.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from . import units
from .topology import Topology

_MASK64 = (1 << 64) - 1
_GAMMA = 0x9E3779B97F4A7C15


def _splitmix64(x: int) -> int:
    z = (x + _GAMMA) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def prng_key(seed: int) -> int:
    """The root key of ``seed`` (``jax.random.PRNGKey``)."""
    return int(seed) & _MASK64


def split(key: int, num: int = 2) -> Tuple[int, ...]:
    """``num`` child keys of ``key`` (``jax.random.split``)."""
    return tuple(_splitmix64((int(key) + i * _GAMMA) & _MASK64)
                 for i in range(num))


def normal(key: int, shape, device, dtype=torch.float32) -> torch.Tensor:
    """Standard normal draws of ``shape`` on ``device``, from a
    ``torch.Generator`` there seeded with ``key``."""
    gen = torch.Generator(device=device).manual_seed(int(key))
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


class PRNG:
    """Global seeded key factory.

    ``set_seed`` installs a root key; each ``get_random_key`` splits it,
    advancing the stream deterministically.
    """

    _key = None
    _seed: int = None

    @classmethod
    def set_seed(cls, seed: int) -> None:
        cls._seed = seed
        cls._key = prng_key(seed)

    @classmethod
    def get_random_key(cls) -> int:
        if cls._key is None:
            raise RuntimeError("PRNG.set_seed(seed) must be called first")
        cls._key, subkey = split(cls._key)
        return subkey


def get_nr_of_particles(topology: Topology) -> int:
    """Number of particles in the system."""
    return topology.getNumAtoms()


def get_list_of_mass(topology: Topology) -> units.Quantity:
    """Per-atom masses as a Quantity in dalton."""
    return units.Quantity(topology.masses(), units.amu)


def masses_md(topology_or_masses, device=None) -> torch.Tensor:
    """Masses as an (N, 1) float32 tensor in MD units.

    A tensor keeps its device unless ``device`` is given; host data (a
    topology, a Quantity, an array) goes to ``device``, the CPU by default.
    """
    if isinstance(topology_or_masses, Topology):
        m = topology_or_masses.masses()
    else:
        m = units.strip_md(topology_or_masses, units.amu)
    if torch.is_tensor(m):
        return m.to(device=device or m.device, dtype=torch.float32).reshape(-1, 1)
    m = np.asarray(m, dtype=np.float64).astype(np.float32)
    return torch.as_tensor(m, device=device).reshape(-1, 1)


def initialize_velocities(temperature, topology_or_masses, key: int,
                          device=None) -> units.Quantity:
    """Maxwell-Boltzmann velocities at ``temperature``, sigma_v = sqrt(kB T
    / m) per particle, as a Quantity in nm/ps on the masses' device (see
    ``masses_md``)."""
    kbT = units.kB_MD * units.strip_md(temperature, units.kelvin)
    m = masses_md(topology_or_masses, device)
    v0 = torch.sqrt(kbT / m) * normal(key, (m.shape[0], 3), m.device)
    return units.Quantity(v0, units.nanometer / units.picosecond)


def initialize_velocities_md(temperature_md: float, masses: torch.Tensor,
                             key: int) -> torch.Tensor:
    """Maxwell-Boltzmann velocities in MD units on the device of ``masses``,
    an (N, 1) tensor."""
    sigma_v = torch.sqrt(temperature_md * units.kB_MD / masses)
    return sigma_v * normal(key, (masses.shape[0], 3), masses.device)


def get_data_file_path(relative_path: str) -> str:
    """Full path of a data file of the package (``chiron_tpu_torch/data/``),
    resolved from this file's place, so an installed package finds it."""
    path = Path(__file__).resolve().parent / "data" / relative_path
    if not path.exists():
        raise ValueError(f"Sorry! {path} does not exist.")
    return str(path)


def get_full_path(relative_path: str) -> str:
    """Path of a file relative to the directory that holds the package
    (the repository's root in a checkout)."""
    return f"{Path(__file__).resolve().parent}/../{relative_path}"


def slice_array(arr, start_column: int, end_column: int):
    """Column slice helper."""
    return arr[:, start_column:end_column]
