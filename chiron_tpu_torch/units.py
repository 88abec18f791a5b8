"""Minimal dimensional-analysis unit system for the PyTorch port.

A copy of ``chiron_tpu/units.py`` (numpy only): importing that module runs
``chiron_tpu/__init__.py``, which imports jax, so the port keeps its own.
The reference (choderalab/chiron) relies on ``openmm.unit`` for unit-validated
constructors and the MD unit system (reference chiron/states.py:42-43 and
chiron/potential.py:154-188).  openmm is not a dependency, so this is a
small, self-contained replacement that covers the API surface the framework
needs:

* ``Quantity`` arithmetic (``3.4 * nanometer``, ``q / NA``, ``q ** 2`` ...)
* ``Quantity.value_in_unit(unit)`` and ``Quantity.value_in_unit_system(md_unit_system)``
* ``Unit.is_compatible(other)`` dimension checks used by constructor validation
* the constants ``BOLTZMANN_CONSTANT_kB`` and ``AVOGADRO_CONSTANT_NA``

Internal convention (the "MD unit system", identical to the reference's):
length = nanometer, time = picosecond, mass = dalton (g/mol), temperature =
kelvin, energy = kilojoule/mole.  The identity 1 dalton * nm^2 / ps^2 ==
1 kJ/mol makes the system closed under the dynamics equations.

Dimensions are tracked as a 5-vector of exponents (length, mass, time,
temperature, amount).  ``dalton`` is defined as gram/mole -- dimensionally
(mass=1, amount=-1) -- which is exactly how the MD unit system stays
consistent for molar energies.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple, Union

import numpy as _np

# Exact 2019-SI Avogadro number.
_NA = 6.02214076e23

Dims = Tuple[int, int, int, int, int]  # (L, M, T, Theta, N)

_DIM_NAMES = ("length", "mass", "time", "temperature", "amount")


def _dims_add(a: Dims, b: Dims) -> Dims:
    return tuple(x + y for x, y in zip(a, b))  # type: ignore[return-value]


def _dims_sub(a: Dims, b: Dims) -> Dims:
    return tuple(x - y for x, y in zip(a, b))  # type: ignore[return-value]


_ZERO: Dims = (0, 0, 0, 0, 0)


@dataclass(frozen=True)
class Unit:
    """A physical unit: an SI scale factor plus dimension exponents."""

    scale: float  # value of 1 <unit> expressed in SI base units
    dims: Dims
    name: str = ""

    # Make numpy defer to Unit.__rmul__ for ndarray * unit.
    __array_priority__ = 200
    __array_ufunc__ = None

    # -- dimension queries -------------------------------------------------
    def is_compatible(self, other: "Unit") -> bool:
        """True when both units share the same dimension exponents.

        Mirrors ``openmm.unit.Unit.is_compatible`` used throughout the
        reference's constructor validation (e.g. reference
        chiron/neighbors.py:229, chiron/potential.py:173-178).
        """
        return self.dims == tuple(other.dims)

    def is_dimensionless(self) -> bool:
        return self.dims == _ZERO

    def conversion_factor_to(self, other: "Unit") -> float:
        if self.dims != tuple(other.dims):
            raise TypeError(f"Unit {self} is not compatible with {other}")
        return self.scale / other.scale

    # -- algebra -----------------------------------------------------------
    def __mul__(self, other):
        if isinstance(other, Unit):
            return Unit(self.scale * other.scale, _dims_add(self.dims, other.dims),
                        _join(self.name, other.name, "*"))
        # number * unit or array * unit handled in __rmul__ of Quantity path
        return Quantity(other, self)

    def __rmul__(self, other):
        return Quantity(other, self)

    def __truediv__(self, other):
        if isinstance(other, Unit):
            return Unit(self.scale / other.scale, _dims_sub(self.dims, other.dims),
                        _join(self.name, other.name, "/"))
        return Quantity(1.0 / other, self)

    def __rtruediv__(self, other):
        inv = Unit(1.0 / self.scale, tuple(-d for d in self.dims), f"1/({self.name})")
        if isinstance(other, Unit):  # pragma: no cover - symmetry
            return other * inv
        return Quantity(other, inv)

    def __pow__(self, p):
        dims = tuple(d * p for d in self.dims)
        dims = tuple(int(v) if float(v).is_integer() else v for v in dims)
        return Unit(self.scale ** p, dims, f"({self.name})**{p}")

    def __repr__(self):
        return self.name or f"Unit(scale={self.scale}, dims={self.dims})"

    def __eq__(self, other):
        return (
            isinstance(other, Unit)
            and self.dims == tuple(other.dims)
            and math.isclose(self.scale, other.scale, rel_tol=1e-12)
        )

    def __hash__(self):
        return hash((round(math.log(self.scale) if self.scale > 0 else 0.0, 9), self.dims))


def _join(a: str, b: str, op: str) -> str:
    a = a or "?"
    b = b or "?"
    return f"{a}{op}{b}"


class Quantity:
    """A value (scalar or array) with an attached :class:`Unit`.

    Replaces ``openmm.unit.Quantity`` for the purposes of this framework
    (see reference chiron/states.py:8-174 for the usage patterns covered).
    """

    __slots__ = ("_value", "unit")
    __array_priority__ = 200  # take precedence over numpy ufuncs
    __array_ufunc__ = None

    def __init__(self, value, unit: Unit):
        if isinstance(value, Quantity):
            value = value.value_in_unit(unit)
        self._value = value
        self.unit = unit

    # -- conversions -------------------------------------------------------
    def value_in_unit(self, unit: Unit):
        factor = self.unit.conversion_factor_to(unit)
        return self._value * factor

    def in_units_of(self, unit: Unit) -> "Quantity":
        return Quantity(self.value_in_unit(unit), unit)

    def value_in_unit_system(self, system: "UnitSystem"):
        """Numeric value expressed in the given unit system's base units."""
        return self._value * (self.unit.scale / system.factor(self.unit.dims))

    @property
    def shape(self):
        return _np.shape(self._value)

    def __len__(self):
        return len(self._value)

    # -- conversion guards ---------------------------------------------------
    # Quantity exposes __len__ + __getitem__, so np.asarray / jnp.asarray
    # would otherwise fall back to the SEQUENCE protocol: element-wise
    # recursive conversion that yields a useless object array at best and,
    # for a jax-backed value, dispatches one tiny gather per element and
    # effectively hangs with unbounded memory.  Fail fast with guidance
    # instead -- stripping units is an explicit construction-boundary act.
    def __array__(self, dtype=None, copy=None):
        raise TypeError(
            f"cannot implicitly convert a unit-bearing Quantity "
            f"({self.unit}) to a bare array; strip units explicitly, "
            "e.g. q.value_in_unit_system(md_unit_system)"
        )

    __jax_array__ = __array__

    def __bool__(self):
        return bool(_np.any(self._value))

    def __getitem__(self, idx):
        return Quantity(self._value[idx], self.unit)

    # -- arithmetic --------------------------------------------------------
    def __mul__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self._value * other._value, self.unit * other.unit)
        if isinstance(other, Unit):
            return Quantity(self._value, self.unit * other)
        return Quantity(self._value * other, self.unit)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self._value / other._value, self.unit / other.unit)
        if isinstance(other, Unit):
            return Quantity(self._value, self.unit / other)
        return Quantity(self._value / other, self.unit)

    def __rtruediv__(self, other):
        inv_unit = Unit(1.0 / self.unit.scale, tuple(-d for d in self.unit.dims),
                        f"1/({self.unit.name})")
        if isinstance(other, Quantity):  # pragma: no cover - symmetry
            return Quantity(other._value / self._value, other.unit / self.unit)
        return Quantity(other / self._value, inv_unit)

    def __add__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self._value + other.value_in_unit(self.unit), self.unit)
        if self.unit.is_dimensionless():
            return Quantity(self._value * self.unit.scale + other, dimensionless)
        raise TypeError(f"Cannot add bare number to quantity with unit {self.unit}")

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self._value - other.value_in_unit(self.unit), self.unit)
        raise TypeError(f"Cannot subtract bare number from quantity with unit {self.unit}")

    def __rsub__(self, other):
        if isinstance(other, Quantity):  # pragma: no cover - symmetry
            return other.__sub__(self)
        raise TypeError(f"Cannot subtract quantity with unit {self.unit} from bare number")

    def __neg__(self):
        return Quantity(-self._value, self.unit)

    def __abs__(self):
        return Quantity(abs(self._value), self.unit)

    def __pow__(self, p):
        return Quantity(self._value ** p, self.unit ** p)

    # -- comparisons (require compatible units) ----------------------------
    def _other_value(self, other):
        if isinstance(other, Quantity):
            return other.value_in_unit(self.unit)
        if self.unit.is_dimensionless():
            return other / self.unit.scale
        raise TypeError(f"Cannot compare quantity with unit {self.unit} to bare number")

    def __lt__(self, other):
        return self._value < self._other_value(other)

    def __le__(self, other):
        return self._value <= self._other_value(other)

    def __gt__(self, other):
        return self._value > self._other_value(other)

    def __ge__(self, other):
        return self._value >= self._other_value(other)

    def __eq__(self, other):
        if not isinstance(other, Quantity):
            return NotImplemented
        if self.unit.dims != tuple(other.unit.dims):
            return False
        return bool(_np.all(self._value == other.value_in_unit(self.unit)))

    def __repr__(self):
        return f"Quantity({self._value!r}, {self.unit!r})"

    def __format__(self, spec):
        return f"{self._value.__format__(spec)} {self.unit!r}"


class UnitSystem:
    """A set of base units: maps a dimension vector to a scale factor.

    ``md_unit_system`` reproduces openmm's MD unit system: nm / dalton / ps /
    kelvin, with the molar bookkeeping handled by dalton == gram/mole.
    """

    def __init__(self, length: float, mass: float, time: float,
                 temperature: float, amount: float, mass_amount: int = -1):
        # base unit scale factors in SI
        self._base = (length, mass, time, temperature, amount)
        # dims of the mass base unit in the amount axis (dalton = g/mol -> -1)
        self._mass_amount = mass_amount

    def factor(self, dims: Dims) -> float:
        l, m, t, th, n = dims
        # The mass base unit (dalton = g/mol) carries an amount exponent of
        # ``mass_amount`` per power of mass; compensate with the amount base.
        n_eff = n - self._mass_amount * m
        return (
            self._base[0] ** l
            * self._base[1] ** m
            * self._base[2] ** t
            * self._base[3] ** th
            * self._base[4] ** n_eff
        )


# ---------------------------------------------------------------------------
# Base + derived units
# ---------------------------------------------------------------------------

dimensionless = Unit(1.0, _ZERO, "dimensionless")

meter = Unit(1.0, (1, 0, 0, 0, 0), "meter")
nanometer = Unit(1e-9, (1, 0, 0, 0, 0), "nanometer")
nanometers = nanometer
angstrom = Unit(1e-10, (1, 0, 0, 0, 0), "angstrom")
angstroms = angstrom
centimeter = Unit(1e-2, (1, 0, 0, 0, 0), "centimeter")

second = Unit(1.0, (0, 0, 1, 0, 0), "second")
picosecond = Unit(1e-12, (0, 0, 1, 0, 0), "picosecond")
picoseconds = picosecond
femtosecond = Unit(1e-15, (0, 0, 1, 0, 0), "femtosecond")
femtoseconds = femtosecond
nanosecond = Unit(1e-9, (0, 0, 1, 0, 0), "nanosecond")

kilogram = Unit(1.0, (0, 1, 0, 0, 0), "kilogram")
gram = Unit(1e-3, (0, 1, 0, 0, 0), "gram")
# dalton == gram/mole: this is what closes the MD unit system for molar energy.
dalton = Unit(1e-3 / _NA, (0, 1, 0, 0, -1), "dalton")
daltons = dalton
amu = dalton

kelvin = Unit(1.0, (0, 0, 0, 1, 0), "kelvin")

mole = Unit(_NA, (0, 0, 0, 0, 1), "mole")
mol = mole

joule = Unit(1.0, (2, 1, -2, 0, 0), "joule")
kilojoule = Unit(1e3, (2, 1, -2, 0, 0), "kilojoule")
calorie = Unit(4.184, (2, 1, -2, 0, 0), "calorie")
kilocalorie = Unit(4184.0, (2, 1, -2, 0, 0), "kilocalorie")

kilojoule_per_mole = kilojoule / mole
kilojoules_per_mole = kilojoule_per_mole
kilocalorie_per_mole = kilocalorie / mole
kilocalories_per_mole = kilocalorie_per_mole

newton = Unit(1.0, (1, 1, -2, 0, 0), "newton")
pascal = Unit(1.0, (-1, 1, -2, 0, 0), "pascal")
bar = Unit(1e5, (-1, 1, -2, 0, 0), "bar")
atmosphere = Unit(101325.0, (-1, 1, -2, 0, 0), "atmosphere")

nanometer_cubed = nanometer ** 3
meter_cubed = meter ** 3

# Physical constants, matching openmm's definitions.
BOLTZMANN_CONSTANT_kB = Quantity(1.380649e-23, joule / kelvin)
AVOGADRO_CONSTANT_NA = Quantity(_NA, mole ** -1)
MOLAR_GAS_CONSTANT_R = BOLTZMANN_CONSTANT_kB * AVOGADRO_CONSTANT_NA

# The MD unit system: nm, dalton(=g/mol), ps, K.
md_unit_system = UnitSystem(
    length=1e-9, mass=1e-3 / _NA, time=1e-12, temperature=1.0, amount=_NA,
    mass_amount=-1,
)

# Handy constant: kB in kJ/(mol K) -- the value of (kB*NA) in the MD system.
kB_MD = MOLAR_GAS_CONSTANT_R.value_in_unit_system(md_unit_system)  # ~0.008314462618

# Pressure conversion helper: a *molar* pressure (p * NA) expressed in the MD
# system comes out in kJ/mol/nm^3, which is what the reduced potential
# u = beta [U + p V] needs (reference chiron/states.py:275-325).
PRESSURE_BAR_TO_MD = (Quantity(1.0, bar) * AVOGADRO_CONSTANT_NA).value_in_unit_system(
    md_unit_system
)  # ~0.0602214076 kJ/mol/nm^3 per bar


def pressure_to_md(pressure: "Quantity") -> float:
    """Convert a pressure Quantity to molar MD units (kJ/mol/nm^3)."""
    if not pressure.unit.is_compatible(bar):
        raise ValueError(f"pressure must have units of pressure, got {pressure.unit}")
    return (pressure * AVOGADRO_CONSTANT_NA).value_in_unit_system(md_unit_system)


def is_quantity(x) -> bool:
    return isinstance(x, Quantity)


# ---------------------------------------------------------------------------
# openmm.unit interop (construction-boundary adapter)
# ---------------------------------------------------------------------------
#
# Reference chiron constructors accept ``openmm.unit.Quantity`` everywhere
# (reference states.py:44-87, potential.py:154-178).  ``chiron_tpu`` scripts
# migrating from the reference can pass real openmm Quantities unmodified:
# every construction boundary coerces them through :func:`from_openmm`.
# The adapter duck-types on the openmm Quantity protocol
# (``value_in_unit_system`` + ``unit.iter_base_dimensions``) so it needs no
# openmm import of its own -- the md unit system is resolved from the
# quantity's OWN package (``openmm.unit`` / ``simtk.unit``), which is
# necessarily importable if such a quantity exists.

# openmm BaseDimension names -> axis in our (length, mass, time,
# temperature, amount) dims vector
_OPENMM_DIM_AXIS = {
    "length": 0, "mass": 1, "time": 2, "temperature": 3, "amount": 4,
}


def is_foreign_quantity(x) -> bool:
    """True for a unit-bearing object that is NOT ours but implements the
    openmm Quantity protocol (duck-typed; no openmm import).  The full
    protocol is required -- including ``unit.iter_base_dimensions`` -- so
    arbitrary unit-ish wrappers fall through to the constructors' normal
    validation errors instead of a confusing adapter failure."""
    return (
        not isinstance(x, Quantity)
        and hasattr(x, "value_in_unit_system")
        and hasattr(getattr(x, "unit", None), "iter_base_dimensions")
    )


def _openmm_md_system(q):
    """The ``md_unit_system`` singleton of the foreign quantity's own
    package: openmm.unit for openmm, simtk.unit for legacy simtk, or the
    defining module itself for protocol-compatible stand-ins (tests)."""
    import importlib
    import sys

    root = type(q).__module__.split(".")[0]
    candidates = []
    if root in ("openmm", "simtk"):
        candidates.append(root + ".unit")
    candidates.append(type(q).__module__)
    for name in candidates:
        try:
            mod = sys.modules.get(name) or importlib.import_module(name)
        except ImportError:
            continue
        system = getattr(mod, "md_unit_system", None)
        if system is not None:
            return system
    raise TypeError(
        f"cannot locate an md_unit_system for foreign quantity of type "
        f"{type(q).__qualname__} (module {type(q).__module__!r})"
    )


def from_openmm(q) -> "Quantity":
    """Convert an ``openmm.unit.Quantity`` (or any object implementing its
    protocol) to a :class:`Quantity`.

    The numeric value is taken in the openmm MD unit system (nm / dalton /
    ps / K, energies kJ/mol) -- numerically identical to ours by
    construction -- and the dimension vector is read from
    ``unit.iter_base_dimensions()``, so downstream unit validation and
    conversions behave exactly as for natively constructed quantities.
    """
    if isinstance(q, Quantity):
        return q
    if not is_foreign_quantity(q):
        raise TypeError(
            f"expected an openmm-style Quantity, got {type(q)} instead."
        )
    value = q.value_in_unit_system(_openmm_md_system(q))
    # openmm returns list-of-Vec3 for positions/box vectors (the default
    # State.getPositions() container): normalize plain sequences to an
    # ndarray so downstream arithmetic (value * factor) is array math,
    # never Python-sequence repetition.  Real arrays (numpy, jax) pass
    # through untouched.
    if isinstance(value, (list, tuple)) or not (
        isinstance(value, (int, float)) or hasattr(value, "shape")
    ):
        value = _np.asarray(value, dtype=_np.float64)
    dims = [0, 0, 0, 0, 0]
    for base_dim, exponent in q.unit.iter_base_dimensions():
        name = getattr(base_dim, "name", str(base_dim))
        if name == "angle":  # radians are dimensionless here
            continue
        axis = _OPENMM_DIM_AXIS.get(name)
        if axis is None:
            raise ValueError(
                f"foreign quantity carries unsupported base dimension "
                f"{name!r} (unit {q.unit})"
            )
        dims[axis] += exponent
    dims = tuple(dims)
    # a unit whose scale IS the md-system factor for these dims: the md
    # value round-trips exactly and compatibility checks see true dims
    return Quantity(
        value, Unit(md_unit_system.factor(dims), dims, f"md({q.unit})")
    )


def coerce(x):
    """Construction-boundary hook: pass our quantities (and bare values)
    through untouched; convert openmm-style quantities via
    :func:`from_openmm`."""
    if is_foreign_quantity(x):
        return from_openmm(x)
    return x


def strip_md(x, expected: Union[Unit, "Quantity", None] = None):
    """Return the numeric value of ``x`` in the MD unit system.

    Accepts a bare number/array (returned as-is), a :class:`Quantity`, or
    an openmm-style quantity (coerced via :func:`from_openmm`); if
    ``expected`` is given its dimensions are validated.  ``expected`` may
    itself be a Quantity (e.g. ``1.0 / picosecond``), in which case its
    unit is used.
    """
    x = coerce(x)
    if isinstance(expected, Quantity):
        expected = expected.unit
    if isinstance(x, Quantity):
        if expected is not None and not x.unit.is_compatible(expected):
            raise ValueError(
                f"expected a quantity compatible with {expected}, got {x.unit}"
            )
        return x.value_in_unit_system(md_unit_system)
    return x
