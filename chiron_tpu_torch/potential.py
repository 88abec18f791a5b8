"""Potential energy functions: LJ, harmonic oscillator, ideal gas
(port of ``chiron_tpu/potential.py``).

Every potential provides:

* ``compute_energy(positions, nbr_list)`` -- the host-facing API;
* ``compute_force(positions, nbr_list)`` -- exactly ``-grad`` of the energy
  under autograd, so any new potential is differentiable;
* ``make_energy_fn(pairs)`` -- a closure ``(positions, list_state) ->
  energy`` for the integrator's and the minimizers' loops.

Each follows the device of the positions.  On ``DensePairs`` the LJ energy
is K1's (``ops/lj_dense.LJDense.energy``): its gradient under autograd is
K1's force bit for bit.  The masked energy of the list schemes applies the
mask inside and outside the distance function, so padded slots add exactly
zero to the value and the gradient.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from . import units
from .neighbors import (
    DensePairs,
    NeighborListNsqrd,
    NeighborListState,
    PairListNsqrd,
    PairListState,
    PairsBase,
    neighbor_calculate_fn,
    pairlist_calculate_fn,
)
from .topology import Topology


class _SharedOps(dict):
    """A potential's K1 ops, by (cache_token, N, device): the deep copies
    that ``MCMCSampler.run`` and the multistate samplers make of a
    potential hold this same table, so they share its ops."""

    def __deepcopy__(self, memo):
        return self


def lj_energy_from_dist(dist, mask, sigma, epsilon):
    """Masked LJ energy sum, 4 eps [(sig/r)^12 - (sig/r)^6] over valid pairs;
    padded slots contribute exactly zero to the value and the gradient."""
    maskf = mask.to(dist.dtype)
    r_safe = torch.where(maskf > 0, dist, torch.ones_like(dist))
    sr6 = (sigma / r_safe) ** 6
    e = 4.0 * epsilon * (sr6 * sr6 - sr6)
    return torch.sum(maskf * e)


def grad_of(energy: torch.Tensor, positions: torch.Tensor,
            create_graph: bool = False) -> torch.Tensor:
    """d energy / d positions, zero where the energy does not depend on
    them (the ideal gas)."""
    if not (torch.is_tensor(energy) and energy.requires_grad):
        return torch.zeros_like(positions)
    (g,) = torch.autograd.grad(energy, positions, create_graph=create_graph,
                               allow_unused=True, materialize_grads=True)
    return g


def value_and_grad(energy_fn: Callable, positions: torch.Tensor):
    """(energy, d energy / d positions), both detached."""
    with torch.enable_grad():
        x = positions.detach().requires_grad_(True)
        energy = energy_fn(x)
        g = grad_of(energy, x)
    return torch.as_tensor(energy, device=x.device).detach(), g


class NeuralNetworkPotential:
    """Base potential.  Subclasses implement ``compute_energy``; the force is
    always the exact negative gradient."""

    def __init__(self, model=None, **kwargs):
        if model is not None:
            self.model = model
            self.topology = model.potential.topology

    def compute_energy(self, positions, nbr_list=None):
        raise NotImplementedError

    def compute_force(self, positions, nbr_list=None) -> torch.Tensor:
        """Force = -grad(E)."""
        _, g = value_and_grad(lambda x: self.compute_energy(x, nbr_list),
                              positions)
        return -g

    def cache_token(self):
        """Hashable token: two potentials with equal tokens give the same
        ``make_energy_fn`` closures, so step functions built from one serve
        the other."""
        return (type(self).__name__, id(self))

    def compute_pairlist(self, positions, cutoff):
        """Naive O(N^2) pairlist without PBC: (distances, displacement
        vectors, (2, n) pairs) of variable length (a host sync)."""
        n = positions.shape[0]
        # JAX's order: by the larger index, then the smaller
        hi, lo = torch.tril_indices(n, n, offset=-1, device=positions.device)
        displacement_vectors = positions[lo] - positions[hi]
        distance = torch.linalg.vector_norm(displacement_vectors, dim=1)
        interacting = distance < cutoff
        pairs = torch.stack((lo[interacting], hi[interacting]), dim=0)
        return distance[interacting], displacement_vectors[interacting], pairs


class IdealGasPotential(NeuralNetworkPotential):
    """U == 0 everywhere: for barostat and ensemble testing."""

    def __init__(self, topology: Optional[Topology]):
        if topology is not None and not isinstance(topology, (Topology, property)):
            raise TypeError(
                f"Topology must be a Topology object, a property, or None, "
                f"got type(topology) = {type(topology)}"
            )
        self.topology = topology

    def compute_energy(self, positions, nbr_list=None):
        return 0.0

    def compute_force(self, positions, nbr_list=None):
        return 0.0

    def cache_token(self):
        return ("IdealGasPotential",)

    def make_energy_fn(self, pairs=None) -> Callable:
        def energy_fn(positions, list_state=None):
            return torch.zeros((), dtype=positions.dtype, device=positions.device)

        return energy_fn


class LJPotential(NeuralNetworkPotential):
    """Lennard-Jones 12-6 potential."""

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
        self._dense_ops = _SharedOps()

    def cache_token(self):
        return ("LJPotential", self.sigma, self.epsilon, self.cutoff)

    def _dense_op(self, pairs: DensePairs, device):
        """K1 for the DensePairs scheme on ``device``, built once a
        (``cache_token()``, N, device), with JAX's tile rule (only the
        padding follows from it).  Deep copies of the potential share the
        table (``_SharedOps``), so they never copy or rebuild the op."""
        from .ops.lj_dense import LJDense

        if not math.isclose(pairs.cutoff_md, self.cutoff, rel_tol=1e-9):
            raise ValueError(
                f"DensePairs cutoff ({pairs.cutoff_md}) must equal the "
                f"potential cutoff ({self.cutoff})"
            )
        n = pairs.n_particles
        key = (self.cache_token(), n, torch.device(device))
        if key not in self._dense_ops:
            tm = 512 if n >= 2048 else 128
            self._dense_ops[key] = LJDense(n, self.sigma, self.epsilon,
                                           self.cutoff, tm=tm, tn=tm,
                                           device=key[2])
        return self._dense_ops[key]

    # -- host-facing API ----------------------------------------------------
    def compute_energy(self, positions: torch.Tensor, nbr_list=None):
        """Total LJ energy."""
        if nbr_list is None:
            # Debug path: naive O(N^2) pairlist without PBC.
            distances, _, _ = self.compute_pairlist(positions, self.cutoff)
            if distances.shape[0] == 0:
                return 0.0
            sr6 = (self.sigma / distances) ** 6
            return (4.0 * self.epsilon * (sr6 * sr6 - sr6)).sum()

        if not nbr_list.is_built:
            raise ValueError("Neighborlist must be built before use")
        nbr_cutoff = nbr_list.cutoff.value_in_unit_system(units.md_unit_system)
        if not math.isclose(nbr_cutoff, self.cutoff, rel_tol=1e-9):
            raise ValueError(
                f"Neighborlist cutoff ({nbr_list.cutoff}) must be the same as "
                f"the potential cutoff ({self.cutoff})"
            )
        if isinstance(nbr_list, DensePairs):
            op = self._dense_op(nbr_list, positions.device)
            return op.energy(positions, nbr_list.state.box_vectors)
        _, _, mask, dist, _ = nbr_list.calculate(positions)
        return lj_energy_from_dist(dist, mask, self.sigma, self.epsilon)

    def compute_force_analytical(self, positions: torch.Tensor) -> torch.Tensor:
        """Closed-form LJ force, for testing."""
        dist, displacement_vector, pairs = self.compute_pairlist(
            positions, self.cutoff)
        forces = (
            24.0
            * (self.epsilon / (dist * dist))
            * (2.0 * (self.sigma / dist) ** 12 - (self.sigma / dist) ** 6)
        ).reshape(-1, 1) * displacement_vector
        force_array = torch.zeros_like(positions)
        force_array.index_add_(0, pairs[0], forces)
        force_array.index_add_(0, pairs[1], -forces)
        return force_array

    # -- the closures of the device loops -----------------------------------
    def make_energy_fn(self, pairs: PairsBase) -> Callable:
        """Closure ``(positions, list_state) -> energy``.  The space, the
        cutoff and the scheme come from ``pairs``; the box travels in
        ``list_state``, so a barostat move needs no new closure."""
        sigma, epsilon, cutoff = self.sigma, self.epsilon, self.cutoff

        if pairs is None:
            # dense path without PBC, the closure form of the debug pairlist
            def energy_fn(positions, list_state=None):
                n = positions.shape[0]
                ids = torch.arange(n, device=positions.device)
                half = ids[:, None] < ids[None, :]
                diff = positions[:, None, :] - positions[None, :, :]
                r2 = torch.sum(diff * diff, dim=-1)
                # mask before the sqrt: its derivative at r=0 (the diagonal)
                # is not finite and would poison masked-out entries too
                r2_safe = torch.where(half, r2, torch.ones_like(r2))
                dist = torch.sqrt(r2_safe)
                mask = half & (dist < cutoff)
                return lj_energy_from_dist(dist, mask, sigma, epsilon)

            return energy_fn

        if isinstance(pairs, DensePairs):
            # K1: all pairs every evaluation; the box is data in the state
            def energy_fn(positions, list_state):
                box = (list_state.box_vectors if list_state is not None
                       else pairs.state.box_vectors)
                return self._dense_op(pairs, positions.device).energy(
                    positions, box)

            return energy_fn

        space = pairs.space

        if isinstance(pairs, NeighborListNsqrd):

            def energy_fn(positions, list_state: NeighborListState):
                _, mask, dist, _ = neighbor_calculate_fn(
                    list_state, positions, cutoff, space)
                return lj_energy_from_dist(dist, mask, sigma, epsilon)

        elif isinstance(pairs, PairListNsqrd):
            use_cutoff = pairs.cutoff is not None
            cut = pairs.cutoff_md if use_cutoff else float("inf")

            def energy_fn(positions, list_state: PairListState):
                _, mask, dist, _ = pairlist_calculate_fn(
                    list_state, positions, cut, space, use_cutoff)
                return lj_energy_from_dist(dist, mask, sigma, epsilon)

        else:
            raise TypeError(f"Unsupported pairs type: {type(pairs)}")

        return energy_fn


def _ho_energy(k, x0, U0, positions):
    d = positions - x0
    return 0.5 * k * torch.sum(d ** 2) + U0


class HarmonicOscillatorPotential(NeuralNetworkPotential):
    """U(x) = (k/2) sum (x - x0)^2 + U0.  ``k``, ``x0`` and ``U0`` are float32
    CPU tensors; the energy takes ``x0`` to the positions' device."""

    def __init__(
        self,
        topology: Optional[Topology],
        k: units.Quantity = 1.0 * units.kilocalories_per_mole / units.angstrom ** 2,
        x0: units.Quantity = None,
        U0: units.Quantity = 0.0 * units.kilocalories_per_mole,
    ):
        if x0 is None:
            x0 = units.Quantity(np.zeros((1, 3)), units.angstrom)
        if topology is not None and not isinstance(topology, (Topology, property)):
            raise TypeError(
                f"Topology must be a Topology object or None, "
                f"type(topology) = {type(topology)}"
            )
        k = units.coerce(k)
        x0 = units.coerce(x0)
        U0 = units.coerce(U0)
        for name, q in (("k", k), ("x0", x0), ("U0", U0)):
            if not isinstance(q, units.Quantity):
                raise TypeError(
                    f"{name} must be a unit.Quantity, type({name}) = {type(q)}"
                )
        if not k.unit.is_compatible(units.kilocalories_per_mole / units.angstrom ** 2):
            raise ValueError(
                f"k must be a unit.Quantity with units of energy per distance "
                f"squared, k.unit = {k.unit}"
            )
        if not x0.unit.is_compatible(units.angstrom):
            raise ValueError(
                f"positions must be a unit.Quantity with units of distance, "
                f"positions.unit = {x0.unit}"
            )
        if x0.shape[1] != 3:
            raise ValueError(
                f"positions must be a NX3 vector, positions.shape = {x0.shape}"
            )
        if not U0.unit.is_compatible(units.kilocalories_per_mole):
            raise ValueError(
                f"U0 must be a unit.Quantity with units of energy, U0.unit = {U0.unit}"
            )

        self.k = _f32_cpu(k.value_in_unit_system(units.md_unit_system))
        self.x0 = _f32_cpu(x0.value_in_unit_system(units.md_unit_system))
        self.U0 = _f32_cpu(U0.value_in_unit_system(units.md_unit_system))
        self.topology = topology

    def cache_token(self):
        return (
            "HarmonicOscillatorPotential",
            float(self.k),
            float(self.U0),
            self.x0.numpy().tobytes(),
        )

    def compute_energy(self, positions: torch.Tensor, nbr_list=None):
        return self.make_energy_fn()(positions)

    def make_energy_fn(self, pairs=None) -> Callable:
        k, x0, U0 = self.k, self.x0, self.U0  # 0-dim k, U0 mix with any device

        def energy_fn(positions, list_state=None):
            return _ho_energy(k, x0.to(positions.device), U0, positions)

        return energy_fn


def _f32_cpu(a) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.detach().to(device="cpu", dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def stack_homogeneous_params(potentials):
    """Stack a homogeneous potential family's parameters on a leading axis.

    Returns ``(param_energy_fn, stacked_params)``, where
    ``param_energy_fn(params_i, positions) -> energy`` takes one state's
    parameters as data, so that ``torch.func.vmap`` over the stacked
    parameters evaluates every state in one batched call; or ``None`` when
    the potentials are not a supported homogeneous family
    (:class:`HarmonicOscillatorPotential`: k, x0, U0 stacked;
    :class:`IdealGasPotential`).  The parameters are float32 CPU tensors:
    0-dim ones mix with any device, and ``x0`` follows the positions.
    """
    p0 = potentials[0]
    if not all(type(p) is type(p0) for p in potentials):
        return None
    if isinstance(p0, HarmonicOscillatorPotential):
        ks = torch.stack([p.k for p in potentials])
        x0s = torch.stack([p.x0 for p in potentials])
        U0s = torch.stack([p.U0 for p in potentials])

        def ho_energy(params, positions, list_state=None):
            k, x0, U0 = params
            return _ho_energy(k, x0.to(positions.device), U0, positions)

        return ho_energy, (ks, x0s, U0s)
    if isinstance(p0, IdealGasPotential):
        def ig_energy(params, positions, list_state=None):
            return torch.zeros_like(params[0])

        return ig_energy, (torch.zeros(len(potentials)),)
    return None


class PotentialKindSpec:
    """Registry entry for the stacked multistate path.

    ``params_of(potential) -> {name: array}`` extracts one state's
    parameters (shapes must agree across the states of a kind in a
    ladder); ``energy_fn(params, positions, box_diag)`` evaluates the
    potential with those parameters as data (``box_diag`` a (3,) tensor, or
    ``None`` for open space), in torch operations that ``torch.func.vmap``
    and autograd can carry.
    """

    def __init__(self, name, params_of, energy_fn):
        self.name = name
        self.params_of = params_of
        self.energy_fn = energy_fn


_POTENTIAL_KINDS: dict = {}


def register_potential_kind(cls, params_of, energy_fn, name=None):
    """Register a potential class for the stacked multistate path: any
    registered kind, user-defined ones too, can appear in a heterogeneous
    ladder that one batched program evaluates.

    >>> register_potential_kind(
    ...     MyWell,
    ...     params_of=lambda p: {"k": p.k, "x0": p.x0},
    ...     energy_fn=lambda prm, x, box: 0.5*prm["k"]*torch.sum((x-prm["x0"])**2),
    ... )
    """
    spec = PotentialKindSpec(name or cls.__name__, params_of, energy_fn)
    _POTENTIAL_KINDS[cls] = spec
    return spec


def _lj_allpairs_energy(prm, positions, box_diag):
    """Truncated-LJ energy over all pairs, with the minimum image when
    ``box_diag`` is given (open space otherwise): no neighbor capacity, so
    it is safe under vmap and autograd at the modest N of multistate
    workloads."""
    sigma, epsilon, cutoff = prm["sigma"], prm["epsilon"], prm["cutoff"]
    n = positions.shape[0]
    d = positions[:, None, :] - positions[None, :, :]
    if box_diag is not None:
        d = d - box_diag * torch.round(d / box_diag)
    r2 = torch.sum(d * d, dim=-1)
    ids = torch.arange(n, device=positions.device)
    mask = (r2 < cutoff * cutoff) & (ids[:, None] < ids[None, :])
    r2s = torch.where(mask, r2, torch.ones_like(r2))
    s2 = (sigma * sigma) / r2s
    s6 = s2 * s2 * s2
    return torch.sum(torch.where(mask, 4.0 * epsilon * (s6 * s6 - s6),
                                 torch.zeros_like(s6)))


register_potential_kind(
    HarmonicOscillatorPotential,
    params_of=lambda p: {"k": p.k, "x0": p.x0, "U0": p.U0},
    energy_fn=lambda prm, x, box: _ho_energy(prm["k"], prm["x0"].to(x.device),
                                             prm["U0"], x),
    name="harmonic",
)
register_potential_kind(
    IdealGasPotential,
    params_of=lambda p: {},
    energy_fn=lambda prm, x, box: torch.zeros((), dtype=torch.float32,
                                              device=x.device),
    name="ideal_gas",
)
register_potential_kind(
    LJPotential,
    params_of=lambda p: {
        "sigma": p.sigma, "epsilon": p.epsilon, "cutoff": p.cutoff,
    },
    energy_fn=_lj_allpairs_energy,
    name="lj",
)


def stack_registered_params(potentials, box_diag=None):
    """Stack a heterogeneous ladder over any mix of registered potential
    kinds.

    Returns ``(param_energy_fn, stacked_params)`` with the contract of
    :func:`stack_homogeneous_params`: every state's parameters are the
    superset ``(kind, {kind_name: {param: value}})``, zeros in the kinds it
    does not use, and ``param_energy_fn(params_i, positions)`` picks the
    state's kind by its ladder-local index.  Returns ``None`` when a
    potential's class is unregistered or a kind's parameter shapes differ
    across its states.

    JAX picks the kind with ``lax.switch``, which ``vmap`` lowers to every
    branch and a select; here that is the only form: each kind's branch is
    evaluated and ``torch.where`` selects, so ``torch.func.vmap`` over the
    states is one batched program.  ``branches`` and ``kind_list`` are
    exposed, so that a caller can evaluate each state group with its own
    branch alone.  The parameters are float32 tensors on the CPU (the
    device of ``box_diag`` when it is a tensor).
    """
    specs = []
    for p in potentials:
        spec = _POTENTIAL_KINDS.get(type(p))
        if spec is None:
            return None
        specs.append(spec)
    used = []
    for s in specs:
        if s not in used:
            used.append(s)
    kind_idx = [used.index(s) for s in specs]

    device = box_diag.device if torch.is_tensor(box_diag) else None
    box = (None if box_diag is None
           else torch.as_tensor(box_diag, dtype=torch.float32,
                                device=device).reshape(3))

    def as_f32(v):
        if torch.is_tensor(v):
            return v.detach().to(device=device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(v, dtype=np.float32), device=device)

    # each potential's parameters are extracted exactly once; the same
    # dicts feed the shape check and the stacking
    extracted = [{k: as_f32(v) for k, v in s.params_of(p).items()}
                 for p, s in zip(potentials, specs)]
    per_kind = {}
    for u in used:
        shapes = None
        for d, s in zip(extracted, specs):
            if s is not u:
                continue
            if shapes is None:
                shapes = {k: v.shape for k, v in d.items()}
            elif set(shapes) != set(d) or any(d[k].shape != shapes[k] for k in d):
                return None
        per_kind[u.name] = {
            k: torch.stack([
                d[k] if s is u else torch.zeros(shp, device=device)
                for d, s in zip(extracted, specs)
            ])
            for k, shp in shapes.items()
        }

    def make_branch(u):
        def branch(params, positions):
            return u.energy_fn(params[1][u.name], positions, box)
        return branch

    branches = tuple(make_branch(u) for u in used)
    kinds = torch.as_tensor(kind_idx, dtype=torch.float32, device=device)

    def energy(params, positions, list_state=None):
        if len(branches) == 1:
            return branches[0](params, positions)
        kind = params[0].to(torch.int32)
        out = branches[0](params, positions)
        for i, branch in enumerate(branches[1:], start=1):
            out = torch.where(kind == i, branch(params, positions), out)
        return out

    energy.branches = branches
    energy.kind_list = kind_idx
    return energy, (kinds, per_kind)


# the JAX package's earlier name for the closed {HO, IdealGas, LJ} set, now
# the registry's pre-registered kinds
stack_closed_set_params = stack_registered_params
