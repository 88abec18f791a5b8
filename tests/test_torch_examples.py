"""The example programs of ``examples_torch/`` against ``examples/``.

Each port example is held to the JAX one it ports:
- its wiring: the JAX example's objects, built here with ``chiron_tpu`` as
  ``examples/<name>.py`` builds them at a small size, and the port's, built
  by the example's own ``build``, give the same state point (N, box, T, P,
  dt, collision rate, sigma, epsilon, cutoff, move sizes, schedule, seeds,
  iteration counts) and the same initial potential energy (1e-5 relative);
- the functions a JAX example exposes (``differentiable_md.make_traj_energy``
  with JAX's noise fed in, ``pack_methane.pack``'s lattice, the analysis of
  ``differentiable_free_energy`` in f64), on the same inputs;
- each runs to its end on the CPU at a small size.  Their statistical
  checks hold at full size on the card (``chip_smoke.py`` [15]).

Also: the port's data files are byte copies of ``chiron_tpu/data/``, and no
file of the port or its examples imports ``jax`` or ``chiron_tpu`` or names
a path under ``chiron_tpu/``.
"""

import importlib.util
import inspect
import io
import math
import os
import re
import sys
import tokenize

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chiron_tpu.units as ju
import chiron_tpu_torch.units as tu
from chiron_tpu import mcmc as jmcmc
from chiron_tpu import neighbors as jnb
from chiron_tpu import potential as jpot
from chiron_tpu import runtime as jrt
from chiron_tpu import states as jst
from chiron_tpu import testsystems as jts
from chiron_tpu.topology import Topology as JTopology
from chiron_tpu.utils import PRNG as JPRNG
from examples_torch import (
    differentiable_free_energy,
    differentiable_md,
    fast_langevin,
    ho_multistate_mbar,
    ideal_gas,
    lj_hamiltonian_ladder,
    lj_langevin,
    lj_mcmc,
    lj_mcmove,
    npt_fast,
    pack_methane,
    parallel_tempering,
    spatial_large_n,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_FILES = ("ethanol.pdb", "ethanol.sdf", "methane_1100_box4p275.npy",
              "single_particle.pdb", "two_particles.pdb", "xtc_golden.xtc",
              "xtc_golden_coords.npy")
EXAMPLES = ("differentiable_free_energy", "differentiable_md", "fast_langevin",
            "ho_multistate_mbar", "ideal_gas", "lj_hamiltonian_ladder",
            "lj_langevin", "lj_mcmc", "lj_mcmove", "npt_fast", "pack_methane",
            "parallel_tempering", "spatial_large_n")
CPU = "cpu"


def _jax_example(name):
    """``examples/<name>.py`` as a module of its own name, so that it does
    not shadow the port's module of the same file name."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _defaults(main):
    return {k: p.default for k, p in inspect.signature(main).parameters.items()}


def _md(q, units):
    """A Quantity in MD units, or a state's array or tensor (already in
    them), as a float64 array."""
    if hasattr(q, "value_in_unit_system"):
        q = q.value_in_unit_system(units.md_unit_system)
    if torch.is_tensor(q):
        q = q.detach().cpu().numpy()
    return np.asarray(q, np.float64)


def _rel(a, b):
    a, b = (float(v.detach()) if torch.is_tensor(v) else float(v)
            for v in (a, b))
    return abs(a - b) / max(abs(b), 1e-12)


# ---------------------------------------------------------------------------
# The port's own data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DATA_FILES)
def test_data_file_is_a_byte_copy_of_the_jax_package(name):
    from chiron_tpu_torch.utils import get_data_file_path

    ours = get_data_file_path(name)
    assert os.path.dirname(ours) == os.path.join(ROOT, "chiron_tpu_torch", "data")
    with open(ours, "rb") as a, open(os.path.join(
            ROOT, "chiron_tpu", "data", name), "rb") as b:
        assert a.read() == b.read()


def _sources():
    for top in ("chiron_tpu_torch", "examples_torch"):
        for dirpath, _, files in os.walk(os.path.join(ROOT, top)):
            if "_build" in dirpath:
                continue
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(dirpath, f)


def test_port_and_examples_neither_import_jax_nor_read_chiron_tpu():
    imports = re.compile(r"^\s*(import|from)\s+(jax|chiron_tpu)\b")
    found = []
    for path in _sources():
        with open(path) as f:
            text = f.read()
        for i, line in enumerate(text.splitlines(), 1):
            if imports.match(line):
                found.append(f"{path}:{i}: {line.strip()}")
        # a string literal that is, or starts, a path under chiron_tpu/
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.STRING:
                body = re.sub(r"^[a-zA-Z]*('''|\"\"\"|'|\")", "", tok.string)
                if body.startswith(("chiron_tpu/", "chiron_tpu'",
                                    'chiron_tpu"')):
                    found.append(f"{path}:{tok.start[0]}: {tok.string}")
    assert not found, found


# ---------------------------------------------------------------------------
# Wiring: the same state point and initial energy as the JAX example
# ---------------------------------------------------------------------------


def _wire_fast_langevin():
    n = 256  # the dense runner's energy at a small N (the example's 4000)
    fluid = jts.LennardJonesFluid(nparticles=n, reduced_density=0.8)
    md = ju.md_unit_system
    fast = jrt.make_fast_lj_runner(
        potential=fluid.potential, n_particles=n, topology=fluid.topology,
        temperature=120.0 * ju.kelvin, timestep=2.0 * ju.femtoseconds)
    fs = fast.init(fluid.positions.value_in_unit_system(md),
                   fluid.box_vectors.value_in_unit_system(md), seed=1234)
    jax_side = dict(n=n, box=_md(fluid.box_vectors, ju), T=120.0, dt=0.002,
                    seed=1234, melt=2000, settle=2000, windows=5,
                    window_steps=2000, n_default=4000,
                    energy=float(fast.energy(fs)))
    tfluid, box, tfast, tfs = fast_langevin.build(CPU, n)
    d = _defaults(fast_langevin.main)
    port = dict(n=tfluid.nparticles, box=np.asarray(box, np.float64),
                T=_md(fast_langevin.TEMPERATURE, tu), dt=_md(
                    fast_langevin.TIMESTEP, tu), seed=fast_langevin.SEED,
                melt=d["melt_steps"], settle=d["settle_steps"],
                windows=d["windows"], window_steps=d["window_steps"],
                n_default=d["n"], energy=float(tfast.energy(tfs)))
    return jax_side, port


def _wire_npt_fast():
    from chiron_tpu.utils import get_data_file_path as jax_data

    n = 1100
    topology = JTopology.uniform(n, mass=16.04, element="C")
    pot = jpot.LJPotential(topology, sigma=0.373 * ju.nanometer,
                           epsilon=0.2941 * ju.kilocalories_per_mole,
                           cutoff=1.4 * ju.nanometer)
    positions = np.load(jax_data("methane_1100_box4p275.npy"))
    box0 = np.eye(3, dtype=np.float32) * 4.275021399280942
    runner = jrt.make_npt_lj_runner(
        pot, n, topology=topology, temperature=140.0 * ju.kelvin,
        pressure=13.00765 * ju.atmosphere, barostat_interval=25)
    state = runner.init(positions, box0, seed=2024)
    jax_side = dict(n=n, masses=np.asarray(topology.masses()),
                    sigma=pot.sigma, epsilon=pot.epsilon, cutoff=pot.cutoff,
                    volume=float(runner.volume(state)), seed=2024,
                    n_steps=20_000, energy=float(runner.energy(state)))
    trunner, tstate = npt_fast.build(CPU)
    port = dict(n=npt_fast.N, masses=trunner.m_lane[0, :npt_fast.N].numpy(),
                sigma=trunner.op.sigma, epsilon=trunner.op.epsilon,
                cutoff=trunner.op.cutoff, volume=float(trunner.volume(tstate)),
                seed=npt_fast.SEED, n_steps=_defaults(npt_fast.main)["n_steps"],
                energy=float(trunner.energy(tstate)))
    # the runner's barostat cadence, temperature and pressure
    jax_side.update(interval=25, kT=ju.kB_MD * 140.0,
                    pressure=ju.pressure_to_md(13.00765 * ju.atmosphere))
    port.update(interval=trunner.barostat_interval, kT=1.0 / trunner.beta,
                pressure=trunner.P_md)
    return jax_side, port


def _jax_pack_capture(monkeypatch, seed=2026):
    """JAX's ``pack`` up to its scan: the carry it would run from (the
    jittered lattice, zero velocities, the initial force), with ``jax.jit``
    replaced by a capture that returns the carry unchanged."""
    module = _jax_example("pack_methane")
    captured = {}

    def capture(fn):
        def run(carry):
            captured["carry"] = carry
            return carry
        return run

    monkeypatch.setattr(jax, "jit", capture)
    module.pack(seed)
    return module, captured["carry"]


def _wire_pack_methane(monkeypatch):
    module, carry = _jax_pack_capture(monkeypatch)
    x0 = torch.as_tensor(pack_methane.lattice(2026), dtype=torch.float32)
    names = ("BOX_L", "N", "SIGMA", "EPSILON", "CUTOFF", "MASS", "T", "KB")
    jax_side = {k: getattr(module, k) for k in names}
    port = {k: getattr(pack_methane, k) for k in names}
    jax_side.update(seed=2026, n_steps=5000, force=np.asarray(carry[2]))
    d = _defaults(pack_methane.main)
    port.update(seed=d["seed"], n_steps=d["n_steps"],
                force=pack_methane.force(x0).numpy())
    assert d["write"] is False  # the committed packing stays unless asked
    return jax_side, port


def _moves(schedule, units):
    """The move schedule's names and each move's parameters."""
    out = []
    for name, move in schedule:
        p = dict(name=name, kind=type(move).__name__,
                 n=move.number_of_moves)
        for attr in ("autotune", "autotune_interval", "volume_max_scale"):
            if hasattr(move, attr):
                p[attr] = getattr(move, attr)
        if move.reporter is not None:
            p["report_interval"] = move.report_interval
        if hasattr(move, "displacement_sigma"):
            p["displacement_sigma"] = float(_md(move.displacement_sigma, units))
        if hasattr(move, "timestep"):
            p["timestep"] = float(_md(move.timestep, units))
            p["collision_rate"] = float(_md(move.collision_rate, units))
        out.append(p)
    return out


def _lj_params(pot):
    return dict(sigma=float(pot.sigma), epsilon=float(pot.epsilon),
                cutoff=float(pot.cutoff))


def _wire_lj_mcmc():
    from chiron_tpu.topology import Topology
    from chiron_tpu.utils import get_data_file_path as jax_data

    sigma = 0.373 * ju.nanometer
    epsilon = ju.Quantity(148.0 * 0.008314462618, ju.kilojoule_per_mole)
    cutoff = 1.4 * ju.nanometer
    positions = ju.Quantity(jnp.asarray(np.load(jax_data(
        "methane_1100_box4p275.npy"))), ju.nanometer)
    box_vectors = ju.Quantity(jnp.diag(jnp.full(3, 4.275021399280942)),
                              ju.nanometer)
    lj = jpot.LJPotential(Topology.from_masses(np.full(1100, 16.04)),
                          sigma=sigma, epsilon=epsilon, cutoff=cutoff)
    thermo = jst.ThermodynamicState(potential=lj,
                                    temperature=140.0 * ju.kelvin,
                                    pressure=13.00765 * ju.atmosphere)
    JPRNG.set_seed(1234)
    ss = jst.SamplerState(positions=positions,
                          current_PRNG_key=JPRNG.get_random_key(),
                          box_vectors=box_vectors)
    nbr = jnb.DensePairs(jnb.OrthogonalPeriodicSpace(), cutoff=cutoff)
    nbr.build_from_state(ss)
    sched = [
        ("MonteCarloDisplacementMove", jmcmc.MonteCarloDisplacementMove(
            displacement_sigma=0.01 * ju.nanometer, number_of_moves=100,
            autotune=True, autotune_interval=100)),
        ("MonteCarloBarostatMove", jmcmc.MonteCarloBarostatMove(
            volume_max_scale=0.1, number_of_moves=20, reporter=object(),
            report_interval=1, autotune=True, autotune_interval=50)),
        ("LangevinDynamicsMove", jmcmc.LangevinDynamicsMove(
            timestep=1.0 * ju.femtoseconds, number_of_steps=200)),
    ]
    jax_side = dict(positions=_md(positions, ju), box=_md(box_vectors, ju),
                    T=_md(thermo.temperature, ju), P=thermo.pressure_md,
                    seed=JPRNG._seed, iterations=5, moves=_moves(sched, ju),
                    scheme="DensePairs", **_lj_params(lj),
                    energy=float(lj.compute_energy(ss.positions, nbr)))
    tlj, tthermo, tss, tnbr = lj_mcmc.build(CPU)
    d = _defaults(lj_mcmc.main)
    tsched = lj_mcmc.moves(object(), d["displacement_moves"],
                           d["barostat_moves"], d["langevin_steps"])
    from chiron_tpu_torch.utils import PRNG

    port = dict(positions=_md(tss.positions, tu), box=_md(tss.box_vectors, tu),
                T=_md(tthermo.temperature, tu), P=tthermo.pressure_md,
                seed=PRNG._seed, iterations=d["n_iterations"],
                moves=_moves(tsched.move_schedule, tu),
                scheme=type(tnbr).__name__, **_lj_params(tlj),
                energy=float(tlj.compute_energy(tss.positions, tnbr)))
    return jax_side, port


def _wire_spatial_large_n():
    from jax.sharding import Mesh

    n = 64
    fluid = jts.LennardJonesFluid(nparticles=n, reduced_density=0.8)
    md = ju.md_unit_system
    from chiron_tpu.parallel import make_spatial_lj_runner

    mesh = Mesh(np.array(jax.devices()[:1]), ("spatial",))
    runner = make_spatial_lj_runner(
        mesh, fluid.potential, n, temperature=120.0 * ju.kelvin,
        timestep=2.0 * ju.femtoseconds, topology=fluid.topology)
    state = runner.init(fluid.positions.value_in_unit_system(md),
                        fluid.box_vectors.value_in_unit_system(md), seed=2024)
    mass = float(fluid.mass.value_in_unit_system(md))
    jax_side = dict(n_default=4096, n_steps=200, kT=ju.kB_MD * 120.0,
                    dt=0.002, a=math.exp(-0.002), seed=2024,
                    energy=float(runner.energy(state)))
    tmesh, trunner, tstate = spatial_large_n.build(CPU, n, tm=32)
    d = _defaults(spatial_large_n.main)
    port = dict(n_default=d["n"], n_steps=d["n_steps"],
                kT=float(trunner.sigv[0, 0]) ** 2 * mass, dt=2 * trunner.half,
                a=trunner.a, seed=2024,
                energy=float(trunner.energy(tstate)))
    assert tmesh.size == 1 and d["tm"] == 256
    return jax_side, port


def _verlet(nb, space, fluid, skin, n_max, units):
    return nb.NeighborListNsqrd(space(), cutoff=fluid.cutoff,
                                skin=skin * units.nanometer,
                                n_max_neighbors=n_max)


def _nbr_params(nbr, units):
    return dict(cutoff=float(_md(nbr.cutoff, units)),
                skin=float(_md(nbr.skin, units)),
                n_max=nbr.n_max_neighbors)


def _wire_lj_langevin():
    n = 64
    fluid = jts.LennardJonesFluid(nparticles=n, reduced_density=0.1)
    JPRNG.set_seed(1234)
    ss = jst.SamplerState(positions=fluid.positions,
                          current_PRNG_key=JPRNG.get_random_key(),
                          box_vectors=fluid.box_vectors)
    nbr = _verlet(jnb, jnb.OrthogonalPeriodicSpace, fluid, 0.5, 180, ju)
    nbr.build_from_state(ss)
    from chiron_tpu.integrators import LangevinIntegrator

    integ = LangevinIntegrator(report_interval=100)
    jax_side = dict(box=_md(fluid.box_vectors, ju), T=300.0, seed=1234,
                    n_steps=1000, n_default=1000,
                    dt=float(_md(integ.timestep, ju)),
                    report=integ.report_interval, **_nbr_params(nbr, ju),
                    energy=float(fluid.potential.compute_energy(
                        ss.positions, nbr)))
    tfluid, tss, tthermo, tnbr = lj_langevin.build(CPU, n)
    from chiron_tpu_torch.integrators import LangevinIntegrator as TI
    from chiron_tpu_torch.utils import PRNG

    d = _defaults(lj_langevin.main)
    port = dict(box=_md(tss.box_vectors, tu), T=_md(tthermo.temperature, tu),
                seed=PRNG._seed, n_steps=d["n_steps"], n_default=d["n"],
                dt=float(_md(TI().timestep, tu)),
                report=lj_langevin.REPORT_INTERVAL, **_nbr_params(tnbr, tu),
                energy=float(tfluid.potential.compute_energy(
                    tss.positions, tnbr)))
    return jax_side, port


def _wire_lj_mcmove():
    n = 64
    fluid = jts.LennardJonesFluid(nparticles=n, reduced_density=0.1)
    JPRNG.set_seed(1234)
    ss = jst.SamplerState(positions=fluid.positions,
                          current_PRNG_key=JPRNG.get_random_key(),
                          box_vectors=fluid.box_vectors)
    nbr = _verlet(jnb, jnb.OrthogonalPeriodicSpace, fluid, 0.5, 180, ju)
    nbr.build_from_state(ss)
    move = jmcmc.MonteCarloDisplacementMove(
        displacement_sigma=0.01 * ju.nanometer, number_of_moves=1000,
        reporter=object(), report_interval=50, autotune=True,
        autotune_interval=100)
    jax_side = dict(box=_md(fluid.box_vectors, ju), T=300.0, seed=1234,
                    n_default=1100, moves=_moves([("m", move)], ju),
                    **_nbr_params(nbr, ju),
                    energy=float(fluid.potential.compute_energy(
                        ss.positions, nbr)))
    tfluid, tss, tthermo, tnbr = lj_mcmove.build(CPU, n)
    from chiron_tpu_torch.utils import PRNG

    d = _defaults(lj_mcmove.main)
    tmove = lj_mcmove.displacement_move(object(), d["number_of_moves"])
    port = dict(box=_md(tss.box_vectors, tu), T=_md(tthermo.temperature, tu),
                seed=PRNG._seed, n_default=d["n"],
                moves=_moves([("m", tmove)], tu), **_nbr_params(tnbr, tu),
                energy=float(tfluid.potential.compute_energy(
                    tss.positions, tnbr)))
    return jax_side, port


def _wire_ideal_gas():
    n = 64
    gas = jts.IdealGas(nparticles=n, temperature=298 * ju.kelvin,
                       pressure=1 * ju.atmosphere)
    thermo = jst.ThermodynamicState(potential=gas.potential,
                                    temperature=298 * ju.kelvin,
                                    pressure=1 * ju.atmosphere)
    JPRNG.set_seed(1234)
    ss = jst.SamplerState(positions=gas.positions,
                          current_PRNG_key=JPRNG.get_random_key(),
                          box_vectors=gas.box_vectors)
    nbr = jnb.PairListNsqrd(jnb.OrthogonalPeriodicSpace(), cutoff=None)
    nbr.build_from_state(ss)
    sched = [
        ("MonteCarloDisplacementMove", jmcmc.MonteCarloDisplacementMove(
            displacement_sigma=0.1 * ju.nanometer, number_of_moves=100,
            autotune=True, autotune_interval=100)),
        ("MonteCarloBarostatMove", jmcmc.MonteCarloBarostatMove(
            volume_max_scale=0.2, number_of_moves=1000, reporter=object(),
            report_interval=10, autotune=True, autotune_interval=100)),
    ]
    jax_side = dict(positions=_md(gas.positions, ju), box=_md(ss.box_vectors, ju),
                    T=298.0, P=thermo.pressure_md, seed=1234, iterations=10,
                    n_default=216, moves=_moves(sched, ju),
                    V=gas.get_volume_expectation(thermo),
                    sV=gas.get_volume_standard_deviation(thermo),
                    energy=float(gas.potential.compute_energy(ss.positions, nbr)))
    tgas, tthermo, tss, tnbr = ideal_gas.build(CPU, n)
    from chiron_tpu_torch.utils import PRNG

    d = _defaults(ideal_gas.main)
    port = dict(positions=_md(tss.positions, tu), box=_md(tss.box_vectors, tu),
                T=_md(tthermo.temperature, tu), P=tthermo.pressure_md,
                seed=PRNG._seed, iterations=d["n_iterations"],
                n_default=d["n_particles"],
                moves=_moves(ideal_gas.moves(
                    object(), d["barostat_moves"],
                    d["displacement_moves"]).move_schedule, tu),
                V=tgas.get_volume_expectation(tthermo),
                sV=tgas.get_volume_standard_deviation(tthermo),
                energy=float(tgas.potential.compute_energy(tss.positions, tnbr)))
    return jax_side, port


def _wire_ho_multistate_mbar():
    ho = jts.HarmonicOscillator()
    T = 300.0 * ju.kelvin
    kT = ju.BOLTZMANN_CONSTANT_kB * T * ju.AVOGADRO_CONSTANT_NA
    Ks = [kT / ju.Quantity(2.0 + 0.2 * i, ju.angstrom) ** 2 for i in range(4)]
    pots = [jpot.HarmonicOscillatorPotential(ho.topology, k=K) for K in Ks]
    x = ho.positions + 0.05 * ju.nanometer  # off the minimum: energy > 0
    nbr = jnb.PairListNsqrd(jnb.OrthogonalNonPeriodicSpace(), cutoff=None)
    move = jmcmc.LangevinDynamicsMove(timestep=1.0 * ju.femtoseconds,
                                      number_of_steps=500)
    jax_side = dict(k=[float(_md(p.k, ju)) for p in pots], T=300.0, seed=1234,
                    iterations=25, minimize=200, move=_moves([("m", move)], ju),
                    energy=[float(p.compute_energy(x.value_in_unit_system(
                        ju.md_unit_system), nbr)) for p in pots])
    from chiron_tpu_torch.utils import PRNG

    d = _defaults(ho_multistate_mbar.main)
    tstates, tss, tnbrs = ho_multistate_mbar.build(CPU, d["seed"])
    tx = torch.as_tensor(np.asarray(x.value_in_unit_system(ju.md_unit_system)),
                         dtype=torch.float32)
    port = dict(k=[float(_md(s.potential.k, tu)) for s in tstates],
                T=float(_md(tstates[0].temperature, tu)), seed=PRNG._seed,
                iterations=d["n_iterations"], minimize=d["minimize_iterations"],
                move=_moves([("m", ho_multistate_mbar.langevin_move(
                    d["number_of_steps"]))], tu),
                energy=[float(s.potential.compute_energy(tx, tnbrs[0]))
                        for s in tstates])
    assert all(isinstance(b, type(tnbrs[0])) and b.space.__class__.__name__
               == "OrthogonalNonPeriodicSpace" for b in tnbrs)
    return jax_side, port


def _wire_lj_hamiltonian_ladder():
    lambdas = [float(v) for v in np.round(np.linspace(0.25, 1.0, 11), 4)]
    fluid = jts.LennardJonesFluid(nparticles=27, reduced_density=0.4)
    pots = [jpot.LJPotential(fluid.topology, sigma=fluid.sigma,
                             epsilon=lam * fluid.epsilon, cutoff=fluid.cutoff)
            for lam in lambdas]
    JPRNG.set_seed(2024)
    ss = jst.SamplerState(fluid.positions,
                          current_PRNG_key=JPRNG.get_random_key(),
                          box_vectors=fluid.box_vectors)
    nbr = _verlet(jnb, jnb.OrthogonalPeriodicSpace, fluid, 0.3, 80, ju)
    nbr.build_from_state(ss)
    move = jmcmc.LangevinDynamicsMove(timestep=2.0 * ju.femtoseconds,
                                      number_of_steps=100)
    jax_side = dict(lambdas=lambdas, T=300.0, seed=2024, iterations=20,
                    move=_moves([("m", move)], ju), n=27,
                    **_nbr_params(nbr, ju),
                    params=[_lj_params(p) for p in pots],
                    energy=[float(p.compute_energy(ss.positions, nbr))
                            for p in pots])
    tstates, tss, tnbrs = lj_hamiltonian_ladder.build(CPU)
    tnbrs[0].build_from_state(tss[0])
    from chiron_tpu_torch.utils import PRNG

    d = _defaults(lj_hamiltonian_ladder.main)
    port = dict(lambdas=lj_hamiltonian_ladder.LAMBDAS,
                T=float(_md(tstates[0].temperature, tu)), seed=PRNG._seed,
                iterations=d["n_iterations"],
                move=_moves([("m", lj_hamiltonian_ladder.langevin_move(
                    d["number_of_steps"]))], tu),
                n=d["n"], **_nbr_params(tnbrs[0], tu),
                params=[_lj_params(s.potential) for s in tstates],
                energy=[float(s.potential.compute_energy(tss[0].positions,
                                                         tnbrs[0]))
                        for s in tstates])
    return jax_side, port


def _wire_parallel_tempering():
    from chiron_tpu.parallel import ParallelTemperingSampler, make_replica_mesh

    n = 64
    fluid = jts.LennardJonesFluid(nparticles=n, reduced_density=0.4)
    nbr = _verlet(jnb, jnb.OrthogonalPeriodicSpace, fluid, 0.3, 160, ju)
    temps = [120.0 * 1.08 ** i for i in range(8)]
    pt = ParallelTemperingSampler(
        potential=fluid.potential, temperatures=[t * ju.kelvin for t in temps],
        timestep=2.0 * ju.femtoseconds, pairs=nbr, mesh=make_replica_mesh(1))
    md = ju.md_unit_system
    pt.initialize(fluid.positions.value_in_unit_system(md),
                  box_vectors=fluid.box_vectors.value_in_unit_system(md),
                  seed=1234)
    ss = jst.SamplerState(fluid.positions,
                          current_PRNG_key=jax.random.PRNGKey(0),
                          box_vectors=fluid.box_vectors)
    nbr.build_from_state(ss)
    jax_side = dict(kTs=np.asarray(pt.kTs, np.float64), dt=pt.timestep,
                    gamma=pt.collision_rate, R=pt.n_replicas, warm=2,
                    iterations=20, steps=200, n_default=256,
                    **_nbr_params(nbr, ju),
                    energy=float(fluid.potential.compute_energy(
                        ss.positions, nbr)))
    tpt, tmesh = parallel_tempering.build(CPU, n)
    d = _defaults(parallel_tempering.main)
    tnbr = tpt.pairs
    from chiron_tpu_torch.states import SamplerState

    tss = SamplerState(tu.Quantity(fluid.positions.value_in_unit_system(md),
                                   tu.nanometer), current_PRNG_key=0,
                       box_vectors=tu.Quantity(
                           np.asarray(fluid.box_vectors.value_in_unit_system(md)),
                           tu.nanometer), device=CPU)
    tnbr.build_from_state(tss)
    port = dict(kTs=np.asarray(tpt.kTs, np.float64), dt=tpt.timestep,
                gamma=tpt.collision_rate, R=tpt.n_replicas,
                warm=d["warm_iterations"], iterations=d["n_iterations"],
                steps=d["steps_per_iteration"], n_default=d["n"],
                **_nbr_params(tnbr, tu),
                energy=float(tpt.potential.compute_energy(tss.positions, tnbr)))
    assert tmesh.size == 1
    return jax_side, port


def _dmd_inputs(n, units, fluid_cls, array):
    fluid = fluid_cls(nparticles=n, reduced_density=0.5)
    md = units.md_unit_system
    box = array(np.array(np.diagonal(fluid.box_vectors.value_in_unit_system(md))))
    x0 = array(np.asarray(fluid.positions.value_in_unit_system(md)))
    return box, x0


def _wire_differentiable_md():
    n = 27
    module = _jax_example("differentiable_md")
    box, x0 = _dmd_inputs(n, ju, jts.LennardJonesFluid,
                          lambda a: jnp.asarray(a, jnp.float32))
    kT = ju.kB_MD * 120.0
    loss0 = module.make_traj_energy(n, box, kT, jnp.full((n,), 39.9,
                                                         jnp.float32),
                                    n_steps=0)
    key = jax.random.PRNGKey(0)
    jax_side = dict(n_default=125, n_steps=200, T=120.0, mass=39.9,
                    eps=0.99579, sigma=0.34, density=0.5,
                    energy=float(loss0(jnp.float32(0.99579),
                                       jnp.float32(0.34), x0, key)))
    tbox, tx0 = _dmd_inputs(n, tu, differentiable_md.LennardJonesFluid,
                            lambda a: torch.as_tensor(a, dtype=torch.float32))
    tloss0 = differentiable_md.make_traj_energy(
        n, tbox, tu.kB_MD * differentiable_md.TEMPERATURE,
        torch.full((n,), differentiable_md.MASS), n_steps=0)
    d = _defaults(differentiable_md.main)
    noises, v_noise = differentiable_md.draw_noise(n, 0, 0, CPU)
    port = dict(n_default=d["n"], n_steps=d["n_steps"],
                T=differentiable_md.TEMPERATURE, mass=differentiable_md.MASS,
                eps=differentiable_md.EPS0, sigma=differentiable_md.SIG0,
                density=0.5,
                energy=float(tloss0(torch.tensor(differentiable_md.EPS0),
                                    torch.tensor(differentiable_md.SIG0), tx0,
                                    noises, v_noise)))
    # the make_traj_energy defaults: dt, gamma, n_steps, cutoff
    jd = inspect.signature(module.make_traj_energy).parameters
    td = inspect.signature(differentiable_md.make_traj_energy).parameters
    jax_side["defaults"] = {k: jd[k].default for k in ("dt", "gamma", "n_steps",
                                                        "cutoff")}
    port["defaults"] = {k: td[k].default for k in ("dt", "gamma", "n_steps",
                                                   "cutoff")}
    return jax_side, port


def _wire_differentiable_free_energy():
    fluid = jts.LennardJonesFluid(nparticles=27, reduced_density=0.4)
    md = ju.md_unit_system
    lambdas = [0.4, 0.6, 0.8, 1.0]
    nbr = jnb.PairListNsqrd(jnb.OrthogonalPeriodicSpace(), cutoff=fluid.cutoff)
    ss = jst.SamplerState(fluid.positions,
                          current_PRNG_key=jax.random.PRNGKey(0),
                          box_vectors=fluid.box_vectors)
    nbr.build_from_state(ss)
    move = jmcmc.MonteCarloDisplacementMove(
        displacement_sigma=0.05 * ju.nanometer, number_of_moves=100,
        autotune=True, autotune_interval=100)
    eps0 = float(fluid.epsilon.value_in_unit_system(md))
    jax_side = dict(lambdas=lambdas, lam_new=0.7, seed=7, snapshots=60,
                    moves=100, equil=20, newton=8, T=300.0,
                    move=_moves([("m", move)], ju),
                    energy=[float(jpot.LJPotential(
                        fluid.topology, sigma=fluid.sigma,
                        epsilon=lam * fluid.epsilon,
                        cutoff=fluid.cutoff).compute_energy(ss.positions, nbr))
                        for lam in lambdas])
    d = _defaults(differentiable_free_energy.main)
    tmove = differentiable_free_energy.displacement_move(d["moves_per_snapshot"])
    xs = torch.as_tensor(np.asarray(fluid.positions.value_in_unit_system(md)),
                         dtype=torch.float32)[None]
    box = torch.as_tensor(np.array(np.diagonal(
        fluid.box_vectors.value_in_unit_system(md))), dtype=torch.float32)
    cut = float(fluid.cutoff.value_in_unit_system(md))
    sig = float(fluid.sigma.value_in_unit_system(md))
    port = dict(lambdas=differentiable_free_energy.LAMBDAS,
                lam_new=differentiable_free_energy.LAMBDA_NEW, seed=7,
                snapshots=d["n_snapshots"], moves=d["moves_per_snapshot"],
                equil=d["n_equil_snapshots"], newton=d["newton_iterations"],
                T=300.0, move=_moves([("m", tmove)], tu),
                energy=[float(differentiable_free_energy.lj_energies(
                    xs, lam * eps0, sig, box, cut)[0]) for lam in
                    differentiable_free_energy.LAMBDAS])
    return jax_side, port


def _compare(jax_side, port, path=""):
    assert set(jax_side) == set(port), (path, set(jax_side) ^ set(port))
    for k, a in jax_side.items():
        b = port[k]
        where = f"{path}{k}"
        if k == "energy":
            for x, y in zip(np.ravel(a), np.ravel(b)):
                assert abs(x - y) <= 1e-5 * max(abs(x), 1e-6), (where, x, y)
        elif k == "force":
            scale = np.abs(a).max()
            assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 1e-5 * scale
        elif isinstance(a, dict):
            _compare(a, b, where + ".")
        elif isinstance(a, list) and a and isinstance(a[0], dict):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                _compare(x, y, f"{where}[{i}].")
        elif isinstance(a, (str, bool)) or a is None:
            assert a == b, (where, a, b)
        else:
            np.testing.assert_allclose(np.asarray(b, np.float64),
                                       np.asarray(a, np.float64), rtol=1e-6,
                                       atol=0, err_msg=where)


WIRING = {
    "fast_langevin": _wire_fast_langevin,
    "npt_fast": _wire_npt_fast,
    "pack_methane": _wire_pack_methane,
    "lj_mcmc": _wire_lj_mcmc,
    "spatial_large_n": _wire_spatial_large_n,
    "lj_langevin": _wire_lj_langevin,
    "lj_mcmove": _wire_lj_mcmove,
    "ideal_gas": _wire_ideal_gas,
    "ho_multistate_mbar": _wire_ho_multistate_mbar,
    "lj_hamiltonian_ladder": _wire_lj_hamiltonian_ladder,
    "parallel_tempering": _wire_parallel_tempering,
    "differentiable_md": _wire_differentiable_md,
    "differentiable_free_energy": _wire_differentiable_free_energy,
}


def test_every_jax_example_has_a_port():
    names = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "examples"))
                   if f.endswith(".py"))
    assert names == sorted(EXAMPLES) == sorted(WIRING)
    for name in names:
        assert os.path.exists(os.path.join(ROOT, "examples_torch", f"{name}.py"))


@pytest.mark.parametrize("name", sorted(WIRING))
def test_wiring_matches_the_jax_example(name, monkeypatch):
    wire = WIRING[name]
    args = (monkeypatch,) if "monkeypatch" in inspect.signature(wire).parameters else ()
    jax_side, port = wire(*args)
    _compare(jax_side, port)


# ---------------------------------------------------------------------------
# The functions the JAX examples expose, on the same inputs
# ---------------------------------------------------------------------------


def test_differentiable_md_loss_and_gradients_match_jax_on_its_noise():
    n, n_steps = 27, 25
    module = _jax_example("differentiable_md")
    box, x0 = _dmd_inputs(n, ju, jts.LennardJonesFluid,
                          lambda a: jnp.asarray(a, jnp.float32))
    kT = ju.kB_MD * 120.0
    loss = module.make_traj_energy(n, box, kT, jnp.full((n,), 39.9, jnp.float32),
                                   n_steps=n_steps)
    key = jax.random.PRNGKey(1234)
    eps0, sig0 = jnp.float32(0.99579), jnp.float32(0.34)
    j_loss = float(loss(eps0, sig0, x0, key))
    j_eps, j_sig = jax.grad(loss, argnums=(0, 1))(eps0, sig0, x0, key)
    # JAX's draws, as its loss makes them
    noises = np.array(jax.random.normal(key, (n_steps, n, 3)))
    v_noise = np.array(jax.random.normal(jax.random.fold_in(key, 1), (n, 3)))

    tbox, tx0 = _dmd_inputs(n, tu, differentiable_md.LennardJonesFluid,
                            lambda a: torch.as_tensor(a, dtype=torch.float32))
    tloss = differentiable_md.make_traj_energy(
        n, tbox, tu.kB_MD * 120.0, torch.full((n,), 39.9), n_steps=n_steps)
    eps = torch.tensor(0.99579, requires_grad=True)
    sig = torch.tensor(0.34, requires_grad=True)
    t_loss = tloss(eps, sig, tx0, torch.as_tensor(noises),
                   torch.as_tensor(v_noise))
    t_eps, t_sig = torch.autograd.grad(t_loss, (eps, sig))
    assert _rel(t_loss, j_loss) < 1e-5, (float(t_loss), j_loss)
    assert _rel(t_eps, j_eps) < 1e-3, (float(t_eps), float(j_eps))
    assert _rel(t_sig, j_sig) < 1e-3, (float(t_sig), float(j_sig))


def test_pack_methane_lattice_is_jax_bit_for_bit(monkeypatch):
    _, carry = _jax_pack_capture(monkeypatch, seed=2026)
    ours = pack_methane.lattice(2026)
    assert np.array_equal(np.asarray(carry[0]), ours.astype(np.float32))
    assert np.array_equal(np.asarray(carry[1]), np.zeros((1100, 3), np.float32))
    # and for another seed, by numpy's default_rng alone
    _, carry = _jax_pack_capture(monkeypatch, seed=5)
    assert np.array_equal(np.asarray(carry[0]),
                          pack_methane.lattice(5).astype(np.float32))


@pytest.fixture(scope="module")
def free_energy_samples():
    """One fixed sample set of the 4-rung ladder: the lattice jittered
    (numpy, seed 11), 6 configurations a rung, in f64."""
    fluid = jts.LennardJonesFluid(nparticles=27, reduced_density=0.4)
    md = ju.md_unit_system
    x0 = np.asarray(fluid.positions.value_in_unit_system(md), np.float64)
    box = np.array(np.diagonal(fluid.box_vectors.value_in_unit_system(md)),
                   np.float64)
    rng = np.random.default_rng(11)
    xs = (x0[None] + rng.normal(0.0, 0.02, (24, 27, 3))) % box
    return dict(xs=xs, box=box,
                sigma=float(fluid.sigma.value_in_unit_system(md)),
                eps0=float(fluid.epsilon.value_in_unit_system(md)),
                cut=float(fluid.cutoff.value_in_unit_system(md)),
                beta=1.0 / (ju.kB_MD * 300.0))


def test_differentiable_free_energy_analysis_matches_jax_in_f64(
        free_energy_samples):
    """The estimator gradient, the physical gradient and one Newton step,
    done with ``chiron_tpu.analysis`` as the JAX example does them, on one
    fixed sample set in f64: 1e-8."""
    from chiron_tpu.analysis import (mbar_perturbed_free_energies_jax,
                                     mbar_solve_implicit)

    s = free_energy_samples
    lambdas = differentiable_free_energy.LAMBDAS
    K, j = len(lambdas), len(lambdas) - 1
    eps_k = np.array([lam * s["eps0"] for lam in lambdas])
    with jax.enable_x64(True):
        xs, box = jnp.asarray(s["xs"]), jnp.asarray(s["box"])
        n = xs.shape[1]
        N_k = jnp.full(K, xs.shape[0] // K)
        beta, cut = s["beta"], s["cut"]

        def lj_energy(x, eps, sigma):  # as examples/differentiable_free_energy.py
            ids = jnp.arange(n)
            d = x[:, None, :] - x[None, :, :]
            d = d - box * jnp.round(d / box)
            r2 = jnp.sum(d * d, axis=-1)
            mask = (r2 < cut * cut) & (ids[:, None] < ids[None, :])
            s6 = ((sigma * sigma) / jnp.where(mask, r2, 1.0)) ** 3
            return jnp.sum(jnp.where(mask, 4.0 * eps * (s6 * s6 - s6), 0.0))

        def delta_f(e_k, sigma):
            u_kn = beta * jax.vmap(
                lambda e: jax.vmap(lambda x: lj_energy(x, e, sigma))(xs))(e_k)
            return mbar_solve_implicit(u_kn, N_k)[-1]

        j_df = float(delta_f(jnp.asarray(eps_k), s["sigma"]))
        j_ge, j_gs = jax.grad(delta_f, argnums=(0, 1))(jnp.asarray(eps_k),
                                                      jnp.float64(s["sigma"]))
        u_kn0 = beta * jax.vmap(lambda e: jax.vmap(
            lambda x: lj_energy(x, e, s["sigma"]))(xs))(jnp.asarray(eps_k))
        f_k = mbar_solve_implicit(u_kn0, N_k)

        def delta_f_phys(e_K):
            u_l = beta * jax.vmap(lambda x: lj_energy(x, e_K, s["sigma"]))(xs)
            return mbar_perturbed_free_energies_jax(u_kn0, N_k, f_k,
                                                    u_l[None, :])[0]

        e_K = jnp.float64(eps_k[j])
        j_phys = float(jax.grad(delta_f_phys)(e_K))
        target = j_df + 1.0
        j_newton = float(e_K - (delta_f_phys(e_K) - target)
                         / jax.grad(delta_f_phys)(e_K))

    ana = differentiable_free_energy.LadderAnalysis(
        torch.as_tensor(s["xs"]), K, torch.as_tensor(s["box"]), s["cut"],
        s["beta"])
    t_df, t_ge, t_gs = ana.estimator_gradient(
        torch.as_tensor(eps_k), torch.tensor(s["sigma"], dtype=torch.float64))
    assert t_df.dtype == torch.float64
    assert _rel(t_df, j_df) < 1e-8
    np.testing.assert_allclose(t_ge.numpy(), np.asarray(j_ge), rtol=1e-8,
                               atol=1e-8)
    assert _rel(t_gs, j_gs) < 1e-8
    ana.freeze(torch.as_tensor(eps_k), s["sigma"])
    _, t_phys = ana.physical_gradient(eps_k[j])
    assert _rel(t_phys, j_phys) < 1e-8
    t_newton = ana.newton_step(torch.tensor(eps_k[j], dtype=torch.float64),
                               float(t_df) + 1.0)
    assert _rel(t_newton, j_newton) < 1e-8
    # the reweighting identity the example checks holds to rounding in f64
    assert _rel(ana.reweighted_ti(eps_k[j]), t_phys) < 1e-10


# ---------------------------------------------------------------------------
# Each example runs to its end on the CPU at a small size
# ---------------------------------------------------------------------------

SMALL = {
    "fast_langevin": dict(n=2048, melt_steps=10, settle_steps=50, windows=1,
                          window_steps=50),
    "npt_fast": dict(n_steps=25),
    "pack_methane": dict(n_steps=10),
    "lj_mcmc": dict(n_iterations=1, displacement_moves=5, barostat_moves=5,
                    langevin_steps=5),
    "spatial_large_n": dict(n=64, n_steps=10, tm=32),
    "lj_langevin": dict(n=64, n_steps=50),
    "lj_mcmove": dict(n=64, number_of_moves=50),
    "ideal_gas": dict(n_particles=64, n_iterations=3, barostat_moves=20,
                      displacement_moves=10),
    "ho_multistate_mbar": dict(n_iterations=3, number_of_steps=10,
                               minimize_iterations=10),
    "lj_hamiltonian_ladder": dict(n_iterations=3, number_of_steps=5),
    "parallel_tempering": dict(n=64, warm_iterations=1, n_iterations=3,
                               steps_per_iteration=10),
    "differentiable_md": dict(n=27, n_steps=10),
    "differentiable_free_energy": dict(n_snapshots=3, moves_per_snapshot=10,
                                       n_equil_snapshots=1,
                                       newton_iterations=3),
}
# the checks that hold at this size too (the others are statistical and
# need the example's full size: chip_smoke.py [15] holds them on the card)
# the examples whose samplers flush their HDF5 reporter at the end (a single
# displacement move, as in lj_mcmove, writes once its buffer of 10 fills)
FLUSHED = ("lj_mcmc", "lj_langevin", "ideal_gas", "ho_multistate_mbar",
           "lj_hamiltonian_ladder")
SMALL_CHECKED = ("fast_langevin", "npt_fast", "pack_methane", "lj_mcmc",
                 "spatial_large_n", "lj_langevin", "lj_mcmove",
                 "differentiable_md", "differentiable_free_energy")


@pytest.mark.parametrize("name", sorted(SMALL))
def test_example_runs_to_its_end_on_the_cpu(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the HDF5 reporters write under output/
    module = sys.modules[f"examples_torch.{name}"]
    results = module.main(device="cpu", **SMALL[name])
    assert isinstance(results, dict) and isinstance(results["headline"], str)
    if name in SMALL_CHECKED:
        module.check(results)
    if name in FLUSHED:
        assert list(tmp_path.glob("output/*/*.h5")), "no HDF5 file written"


def test_pack_methane_writes_only_under_its_out_dir(tmp_path):
    """``--write`` saves the packing under ``--out-dir`` and leaves the
    package's copy (a byte copy of JAX's) alone."""
    from chiron_tpu_torch.utils import get_data_file_path

    packaged = get_data_file_path(pack_methane.DATA_FILE)
    with open(packaged, "rb") as f:
        before = f.read()
    r = pack_methane.main(device="cpu", n_steps=10, write=True,
                          out_dir=str(tmp_path))
    assert r["path"] == str(tmp_path / pack_methane.DATA_FILE)
    saved = np.load(r["path"])
    assert saved.dtype == np.float32 and saved.shape == (pack_methane.N, 3)
    np.testing.assert_array_equal(saved, r["positions"].astype(np.float32))
    with open(packaged, "rb") as f:
        assert f.read() == before


def test_an_example_without_a_card_fails_rather_than_run_on_the_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lj_mcmove.main()


def test_spatial_example_on_two_gloo_ranks_equals_one_process(tmp_path):
    """``spatial_large_n.main`` in a 2-rank gloo group (spawned, a
    ``FileStore``, no network port) gives every rank the positions and
    energy of one process."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.spawn(_spatial_rank, args=(str(tmp_path),), nprocs=2, join=False)
    deadline = time.monotonic() + 120.0
    while not ctx.join(timeout=5.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail("the two ranks did not finish within 120 s")
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    one = spatial_large_n.main(device="cpu", n=64, n_steps=10, tm=32)
    for r in ranks:
        assert r["world_size"] == 2 and r["rows_per_rank"] == 32
        assert float((r["positions"] - one["positions"]).abs().max()) < 1e-6
        assert _rel(r["energy"], one["energy"]) < 1e-6
    assert torch.equal(ranks[0]["positions"], ranks[1]["positions"])


def _spatial_rank(rank, out_dir):
    import torch.distributed as dist

    from chiron_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), 2)
    assert distributed.initialize_cluster(num_processes=2, process_id=rank,
                                          store=store, device="cpu")
    try:
        r = spatial_large_n.main(device="cpu", n=64, n_steps=10, tm=32)
        keep = ("world_size", "rows_per_rank", "positions", "energy")
        torch.save({k: r[k] for k in keep},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
