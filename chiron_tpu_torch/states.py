"""Sampler and thermodynamic state (port of ``chiron_tpu/states.py``).

``SamplerState`` is the host-facing shell of the per-replica dynamic state:
positions, velocities and box vectors as float32 tensors in MD units on one
device (the card unless the caller passes ``device="cpu"``), and the
integer PRNG key (``utils``).  Units are validated once, at construction;
everything downstream is unitless MD numerics.

``ThermodynamicState`` holds the potential and (T, V, p), and gives both
``get_reduced_potential`` and the closure ``make_reduced_potential_fn``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from . import units, utils
from .potential import NeuralNetworkPotential
from .utils import get_nr_of_particles

log = logging.getLogger("chiron_tpu_torch")


@dataclass(frozen=True)
class SamplerStateData:
    """The per-replica dynamic state as plain data (MD units)."""

    positions: torch.Tensor  # (N, 3) nm
    velocities: Optional[torch.Tensor]  # (N, 3) nm/ps or None
    box_vectors: Optional[torch.Tensor]  # (3, 3) nm or None
    key: int  # PRNG key

    @property
    def n_particles(self) -> int:
        return self.positions.shape[0]

    @property
    def volume(self) -> torch.Tensor:
        """Box volume in nm^3 (orthogonal boxes: product of the diagonal)."""
        return torch.prod(torch.diagonal(self.box_vectors))


def _md_tensor(value, device) -> torch.Tensor:
    """float32 tensor on ``device`` of a Quantity's (or a bare) MD value."""
    value = units.coerce(value)
    if isinstance(value, units.Quantity):
        value = value.value_in_unit_system(units.md_unit_system)
    if torch.is_tensor(value):
        return value.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(value, dtype=np.float32), device=device)


class SamplerState:
    """Unit-validated dynamic state, its tensors on ``device``."""

    def __init__(
        self,
        positions: units.Quantity,
        current_PRNG_key: int,
        velocities: Optional[units.Quantity] = None,
        box_vectors: Optional[units.Quantity] = None,
        device="cuda",
    ) -> None:
        positions = units.coerce(positions)
        velocities = units.coerce(velocities)
        box_vectors = units.coerce(box_vectors)
        if not isinstance(positions, units.Quantity):
            raise TypeError(
                f"positions must be a unit.Quantity, got {type(positions)} instead."
            )
        if velocities is not None and not isinstance(velocities, units.Quantity):
            raise TypeError(
                f"velocities must be a unit.Quantity, got {type(velocities)} instead."
            )
        if box_vectors is not None and not isinstance(box_vectors, units.Quantity):
            if isinstance(box_vectors, list):
                try:
                    box_vectors = self._convert_from_openmm_box(box_vectors)
                except Exception:
                    raise TypeError(f"Unable to parse box_vectors {box_vectors}.")
            else:
                raise TypeError(
                    f"box_vectors must be a unit.Quantity or openMM box, "
                    f"got {type(box_vectors)} instead."
                )
        if not positions.unit.is_compatible(units.nanometer):
            raise ValueError(
                f"positions must have units of distance, got {positions.unit} instead."
            )
        if velocities is not None and not velocities.unit.is_compatible(
            units.nanometer / units.picosecond
        ):
            raise ValueError(
                f"velocities must have units of distance/time, "
                f"got {velocities.unit} instead."
            )
        if box_vectors is not None and not box_vectors.unit.is_compatible(
            units.nanometer
        ):
            raise ValueError(
                f"box_vectors must have units of distance, "
                f"got {box_vectors.unit} instead."
            )
        if box_vectors is not None and tuple(box_vectors.shape) != (3, 3):
            raise ValueError(
                f"box_vectors must be a 3x3 array, got {box_vectors.shape} instead."
            )
        if velocities is not None and tuple(positions.shape) != tuple(velocities.shape):
            raise ValueError(
                f"positions and velocities must have the same shape, "
                f"got {positions.shape} and {velocities.shape} instead."
            )
        if current_PRNG_key is None:
            raise ValueError("random_seed must be set.")

        self.device = torch.device(device)
        self._positions = _md_tensor(positions, self.device)
        self._velocities = (None if velocities is None
                            else _md_tensor(velocities, self.device))
        self._box_vectors = (None if box_vectors is None
                             else _md_tensor(box_vectors, self.device))
        self._current_PRNG_key = current_PRNG_key
        self._distance_unit = units.nanometer
        self._time_unit = units.picosecond

    # -- properties return unitless MD tensors --------------------------------
    @property
    def number_of_particles(self) -> int:
        return self._positions.shape[0]

    @property
    def positions(self) -> torch.Tensor:
        return self._positions

    @positions.setter
    def positions(self, value) -> None:
        self._positions = _md_tensor(value, self.device)

    @property
    def velocities(self) -> Optional[torch.Tensor]:
        return self._velocities

    @velocities.setter
    def velocities(self, value) -> None:
        value = _md_tensor(value, self.device)
        if value.shape != self._positions.shape:
            raise ValueError(
                f"velocities must have the same shape as positions, "
                f"got {tuple(value.shape)} and {tuple(self._positions.shape)} "
                f"instead."
            )
        self._velocities = value

    @property
    def box_vectors(self) -> Optional[torch.Tensor]:
        return self._box_vectors

    @box_vectors.setter
    def box_vectors(self, value) -> None:
        self._box_vectors = _md_tensor(value, self.device)

    @property
    def distance_unit(self) -> units.Unit:
        return self._distance_unit

    def velocity_unit(self) -> units.Unit:
        return self._distance_unit / self._time_unit

    @property
    def current_PRNG_key(self) -> int:
        return self._current_PRNG_key

    @current_PRNG_key.setter
    def current_PRNG_key(self, key: int):
        self._current_PRNG_key = key

    @property
    def new_PRNG_key(self) -> int:
        """Split the stored key and return the fresh subkey."""
        self._current_PRNG_key, subkey = utils.split(self._current_PRNG_key)
        return subkey

    # -- plain-data bridge ----------------------------------------------------
    def as_data(self) -> SamplerStateData:
        return SamplerStateData(
            positions=self._positions,
            velocities=self._velocities,
            box_vectors=self._box_vectors,
            key=self._current_PRNG_key,
        )

    def update_from_data(self, data: SamplerStateData) -> "SamplerState":
        self._positions = data.positions
        if data.velocities is not None:
            self._velocities = data.velocities
        if data.box_vectors is not None:
            self._box_vectors = data.box_vectors
        self._current_PRNG_key = data.key
        return self

    @staticmethod
    def _convert_from_openmm_box(openmm_box_vectors: list) -> units.Quantity:
        """Three length-3 row quantities (openmm's
        getDefaultPeriodicBoxVectors layout, native or openmm-unit) -> one
        (3, 3) nm Quantity."""
        box_vec = []
        for i in range(3):
            row = units.coerce(openmm_box_vectors[i])
            box_vec.append([
                row[j].value_in_unit_system(units.md_unit_system)
                for j in range(3)
            ])
        return units.Quantity(np.array(box_vec, dtype=np.float32), units.nanometer)


class ThermodynamicState:
    """Potential + (T, V, p)."""

    def __init__(
        self,
        potential: Optional[NeuralNetworkPotential],
        temperature: Optional[units.Quantity] = None,
        volume: Optional[units.Quantity] = None,
        pressure: Optional[units.Quantity] = None,
    ):
        self.potential = potential

        temperature = units.coerce(temperature)
        volume = units.coerce(volume)
        pressure = units.coerce(pressure)
        if temperature is not None and not isinstance(temperature, units.Quantity):
            raise TypeError(
                f"temperature must be a unit.Quantity, "
                f"got {type(temperature)} instead."
            )
        if temperature is not None and not temperature.unit.is_compatible(
            units.kelvin
        ):
            raise ValueError(
                f"temperature must have units of temperature, "
                f"got {temperature.unit} instead."
            )
        if volume is not None and not isinstance(volume, units.Quantity):
            raise TypeError(
                f"volume must be a unit.Quantity, got {type(volume)} instead."
            )
        if volume is not None and not volume.unit.is_compatible(
            units.nanometer ** 3
        ):
            raise ValueError(
                f"volume must have units of distance**3, got {volume.unit} instead."
            )
        if pressure is not None and not isinstance(pressure, units.Quantity):
            raise TypeError(
                f"pressure must be a unit.Quantity, got {type(pressure)} instead."
            )
        if pressure is not None and not pressure.unit.is_compatible(units.atmosphere):
            raise ValueError(
                f"pressure must have units of pressure, got {pressure.unit} instead."
            )

        self.temperature = temperature
        if temperature is not None:
            self.beta = 1.0 / (units.BOLTZMANN_CONSTANT_kB * temperature)
        else:
            self.beta = None
        self.volume = volume
        self.pressure = pressure

        topology = getattr(potential, "topology", None)
        self.nr_of_particles = (
            get_nr_of_particles(topology) if topology is not None else None
        )
        self._log_ensemble()

    def _log_ensemble(self):
        set_vars = self.check_variables()
        if not set_vars:
            log.info("No variables are set.")
        for var in set_vars:
            log.info("%s is set.", var)
        if (self.temperature is not None and self.volume is not None
                and self.nr_of_particles):
            log.info("NVT ensemble simulated.")
        if (self.temperature is not None and self.pressure is not None
                and self.nr_of_particles):
            log.info("NpT ensemble is simulated.")

    def check_variables(self) -> List[str]:
        """Names of the (T, V, p) variables that are set."""
        variables = ["temperature", "volume", "pressure"]
        return [v for v in variables if getattr(self, v) is not None]

    # -- MD-unit scalars -----------------------------------------------------
    @property
    def kT_md(self) -> float:
        """kB*T in kJ/mol."""
        return units.kB_MD * float(
            self.temperature.value_in_unit_system(units.md_unit_system)
        )

    @property
    def beta_md(self) -> float:
        """1/(kB*T) in mol/kJ."""
        return 1.0 / self.kT_md

    @property
    def pressure_md(self) -> Optional[float]:
        """Molar pressure in kJ/mol/nm^3, or None for NVT."""
        if self.pressure is None:
            return None
        return units.pressure_to_md(self.pressure)

    # -- reduced potential ----------------------------------------------------
    def get_reduced_potential(self, sampler_state: SamplerState, nbr_list=None):
        """u = beta [U(x) + p V(x)]."""
        u = self.potential.compute_energy(sampler_state.positions, nbr_list)
        red = self.beta_md * u
        if self.pressure is not None:
            red = red + self.beta_md * self.pressure_md * _volume(sampler_state)
        return red

    def make_reduced_potential_fn(self, pairs=None) -> Callable:
        """Closure ``(positions, box_vectors, list_state) -> u``, the loop
        form of :meth:`get_reduced_potential`; the box is data, so an NpT
        move needs no new closure."""
        energy_fn = self.potential.make_energy_fn(pairs)
        beta = self.beta_md
        pressure = self.pressure_md

        if pressure is None:

            def reduced_fn(positions, box_vectors=None, list_state=None):
                return beta * energy_fn(positions, list_state)

        else:

            def reduced_fn(positions, box_vectors, list_state=None):
                volume = torch.prod(torch.diagonal(box_vectors))
                return beta * (energy_fn(positions, list_state) + pressure * volume)

        return reduced_fn

    def kT_to_kJ_per_mol(self, energy):
        """Convert an energy in kT units to kJ/mol."""
        return energy * self.kT_md


def _volume(sampler_state: SamplerState) -> torch.Tensor:
    b = sampler_state.box_vectors
    return b[0][0] * b[1][1] * b[2][2]


def calculate_reduced_potential_at_states(
    sampler_state: SamplerState,
    thermodynamic_states: List[ThermodynamicState],
    nbr_list=None,
) -> torch.Tensor:
    """Reduced potential of one configuration at every thermodynamic state.

    Where the states form a homogeneous potential family, the energies come
    from one ``torch.func.vmap`` over the states with the per-state
    parameters as data; otherwise the energy is evaluated once per distinct
    potential (memoized by ``cache_token``) and the (beta, p) scaling is
    vectorized.  The result lies on the positions' device.
    """
    from .potential import stack_homogeneous_params

    positions = sampler_state.positions
    device = positions.device
    stacked = stack_homogeneous_params(
        [s.potential for s in thermodynamic_states])
    if stacked is not None and nbr_list is None:
        param_energy_fn, params = stacked
        E = torch.func.vmap(lambda p: param_energy_fn(p, positions))(params)
        E = E.to(device)
        betas = torch.tensor([s.beta_md for s in thermodynamic_states],
                             dtype=torch.float32, device=device)
        u = betas * E
        pressures = [s.pressure_md for s in thermodynamic_states]
        if any(p is not None for p in pressures):
            pv = torch.tensor([0.0 if p is None else p for p in pressures],
                              dtype=torch.float32, device=device)
            u = u + betas * pv * _volume(sampler_state)
        return u

    energies = {}
    out = []
    for state in thermodynamic_states:
        # memoized by cache_token, not id(): copies of a state share the
        # token while their identities differ
        pot_id = state.potential.cache_token()
        if pot_id not in energies:
            energies[pot_id] = torch.as_tensor(
                state.potential.compute_energy(positions, nbr_list),
                dtype=torch.float32, device=device)
        u = state.beta_md * energies[pot_id]
        if state.pressure is not None:
            u = u + state.beta_md * state.pressure_md * _volume(sampler_state)
        out.append(u)
    return torch.stack(out)
