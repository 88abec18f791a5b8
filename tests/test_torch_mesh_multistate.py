"""The port's ``MeshMultiStateSampler`` (``chiron_tpu_torch.parallel.
multistate``) against the JAX package's, and its own invariants.

Mirrors the fast tests of ``tests/test_mesh_multistate.py`` (the
reduced-potential matrix against the loop, an energy matrix that leaves the
keys alone, pressure turning the batched u_kn off, the serial fallback's
sampling, supplied velocities kept) and holds the batched path to JAX's at
collision rate 0, where the two packages' noise streams drop out: a
harmonic k-ladder and a mixed registered ladder (harmonic, LJ, ideal gas),
positions after ``run(2)`` to 1e-5 nm and u_kn to 1e-5 relative.
"""

import jax
import numpy as np
import pytest
import torch

import chiron_tpu.mcmc as jm
import chiron_tpu.parallel as jpar
import chiron_tpu.potential as jp
import chiron_tpu.reporters as jr
import chiron_tpu.states as js
import chiron_tpu.testsystems as jts
import chiron_tpu.units as ju
import chiron_tpu_torch.mcmc as tm
import chiron_tpu_torch.parallel as tpar
import chiron_tpu_torch.potential as tp
import chiron_tpu_torch.reporters as tr
import chiron_tpu_torch.states as ts
import chiron_tpu_torch.testsystems as tts
import chiron_tpu_torch.units as tu
from chiron_tpu.topology import Topology as JTopology
from chiron_tpu_torch.topology import Topology as TTopology
from chiron_tpu_torch.utils import PRNG

JAX = dict(mcmc=jm, par=jpar, pot=jp, rep=jr, st=js, sys=jts, u=ju,
           top=JTopology, key=jax.random.PRNGKey)
PORT = dict(mcmc=tm, par=tpar, pot=tp, rep=tr, st=ts, sys=tts, u=tu,
            top=TTopology, key=int)


def _kT(u):
    return u.BOLTZMANN_CONSTANT_kB * (300.0 * u.kelvin) * u.AVOGADRO_CONSTANT_NA


def _sampler(pkg, states, sampler_states, tmp_dir, steps=2, collision=1.0,
             mesh=None):
    u = pkg["u"]
    pkg["rep"].BaseReporter.set_directory(str(tmp_dir))
    rep = pkg["rep"].MultistateReporter()
    rep.reset_reporter_file()
    move = pkg["mcmc"].LangevinDynamicsMove(
        timestep=2.0 * u.femtoseconds, collision_rate=collision / u.picoseconds,
        number_of_steps=steps)
    if mesh is None:
        mesh = (pkg["par"].make_replica_mesh(1) if pkg is JAX
                else pkg["par"].make_replica_mesh(device="cpu"))
    ms = pkg["par"].MeshMultiStateSampler(
        mcmc_sampler=pkg["mcmc"].MCMCSampler(pkg["mcmc"].MoveSchedule(
            [("LangevinDynamicsMove", move)])),
        reporter=rep, mesh=mesh)
    ms.create(states, sampler_states, [None] * len(states))
    return ms


def _tiny_ho(tmp_path, pressure=None, n_states=2, steps=2):
    """tests/test_mesh_multistate.py's tiny HO ladder, on the port."""
    ho = tts.HarmonicOscillator()
    T = 300.0 * tu.kelvin
    states = [
        ts.ThermodynamicState(
            tp.HarmonicOscillatorPotential(
                ho.topology,
                k=_kT(tu) / tu.Quantity(2.0 + 0.3 * i, tu.angstrom) ** 2),
            temperature=T, pressure=pressure,
            volume=1.0 * tu.nanometer ** 3 if pressure is not None else None)
        for i in range(n_states)
    ]
    PRNG.set_seed(3)
    box = (tu.Quantity(np.eye(3) * 3.0, tu.nanometer)
           if pressure is not None else None)
    sampler_states = [
        ts.SamplerState(ho.positions, current_PRNG_key=PRNG.get_random_key(),
                        box_vectors=box, device="cpu")
        for _ in range(n_states)
    ]
    return _sampler(PORT, states, sampler_states, tmp_path, steps=steps)


def test_reduced_potential_at_states_vmap_matches_loop():
    ho = tts.HarmonicOscillator()
    T = 300.0 * tu.kelvin
    states = [
        ts.ThermodynamicState(
            tp.HarmonicOscillatorPotential(
                ho.topology,
                k=_kT(tu) / tu.Quantity(2.0 + 0.2 * i, tu.angstrom) ** 2),
            temperature=T)
        for i in range(4)
    ]
    PRNG.set_seed(42)
    ss = ts.SamplerState(
        tu.Quantity(np.array([[0.31, -0.2, 0.12]], np.float32), tu.nanometer),
        current_PRNG_key=PRNG.get_random_key(), device="cpu")
    u_vmap = ts.calculate_reduced_potential_at_states(ss, states).numpy()
    u_loop = np.asarray([float(s.get_reduced_potential(ss)) for s in states])
    assert np.allclose(u_vmap, u_loop, rtol=1e-6)


def test_energy_matrix_does_not_advance_the_keys(tmp_path):
    ms = _tiny_ho(tmp_path)
    assert ms._ukn_fn is not None and ms._propagator is not None
    before = [s.current_PRNG_key for s in ms._sampler_states]
    ms._compute_energies()
    assert [s.current_PRNG_key for s in ms._sampler_states] == before
    assert np.isfinite(ms._energy_thermodynamic_states).all()


def test_pressure_turns_the_batched_energy_matrix_off(tmp_path):
    ms = _tiny_ho(tmp_path, pressure=1.0 * tu.atmosphere)
    assert ms._propagator is not None and ms._ukn_fn is None
    ms.run(1)
    u = ms._energy_thermodynamic_states
    assert np.isfinite(u).all()
    u_check = ts.calculate_reduced_potential_at_states(
        ms._sampler_states[0], ms._thermodynamic_states, None).numpy()
    np.testing.assert_allclose(u[0, :], u_check, rtol=1e-5, atol=1e-5)


def test_serial_fallback_samples_like_the_batched_path(tmp_path):
    batched = _tiny_ho(tmp_path / "a")
    assert batched._propagator is not None
    batched.run(3)
    serial = _tiny_ho(tmp_path / "b")
    serial._propagator = None  # the fallback
    serial.run(3)

    def attempts(ms):
        return [ms._mcmc_sampler[s].move.move_schedule[0][1]
                ._number_of_attempts_made
                for s in range(len(ms._thermodynamic_states))]

    # 3 iterations x 2 steps: 6 attempts a state on both paths
    assert attempts(batched) == attempts(serial) == [6, 6]


def test_supplied_velocities_are_kept_per_replica(tmp_path):
    """Two identical states and keys: the replicas diverge only if replica
    0's supplied velocities survive while replica 1's are drawn."""
    ho = tts.HarmonicOscillator()
    T = 300.0 * tu.kelvin
    k = _kT(tu) / tu.Quantity(2.0, tu.angstrom) ** 2
    states = [ts.ThermodynamicState(
        tp.HarmonicOscillatorPotential(ho.topology, k=k), temperature=T)
        for _ in range(2)]
    s0 = ts.SamplerState(ho.positions, current_PRNG_key=0, device="cpu")
    s0.velocities = torch.full_like(s0.positions, 0.37)
    s1 = ts.SamplerState(ho.positions, current_PRNG_key=0, device="cpu")
    assert s1.velocities is None
    ms = _sampler(PORT, states, [s0, s1], tmp_path)
    ms._propagate_replicas()
    x0 = ms._sampler_states[0].positions.numpy()
    x1 = ms._sampler_states[1].positions.numpy()
    assert np.isfinite(x0).all()
    assert np.isfinite(ms._sampler_states[1].velocities.numpy()).all()
    assert not np.allclose(x0, x1)


# ---------------------------------------------------------------------------
# Against JAX at collision rate 0
# ---------------------------------------------------------------------------


def _parity(tmp_path, make_states, positions, box, n_states):
    """Both packages' samplers on the same ladder, positions, box and
    velocities (collision rate 0, so no noise), ``run(2)``."""
    rng = np.random.default_rng(17)
    vel = rng.normal(0.0, 0.3, (n_states,) + positions.shape).astype(
        np.float32)
    out = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        u = pkg["u"]
        kw = {} if pkg is JAX else {"device": "cpu"}
        ss = [pkg["st"].SamplerState(
            u.Quantity(positions, u.nanometer),
            current_PRNG_key=pkg["key"](i),
            velocities=u.Quantity(vel[i], u.nanometer / u.picosecond),
            box_vectors=None if box is None else u.Quantity(box, u.nanometer),
            **kw) for i in range(n_states)]
        ms = _sampler(pkg, make_states(pkg), ss, tmp_path / name, steps=20,
                      collision=0.0)
        assert ms._propagator is not None and ms._ukn_fn is not None
        ms.run(2)
        out[name] = (np.stack([np.asarray(s.positions)
                               for s in ms._sampler_states]),
                     np.asarray(ms._energy_thermodynamic_states),
                     np.asarray(ms._replica_thermodynamic_states))
    (jx, ju_, jperm), (tx, tu_, tperm) = out["jax"], out["port"]
    assert np.abs(tx - jx).max() < 1e-5
    assert np.abs(tu_ - ju_).max() / np.abs(ju_).max() < 1e-5
    assert np.array_equal(tperm, jperm)
    return tx, tu_


def test_harmonic_k_ladder_matches_jax(tmp_path):
    n = 4

    def states(pkg):
        u, ho = pkg["u"], pkg["sys"].HarmonicOscillator()
        return [pkg["st"].ThermodynamicState(
            pkg["pot"].HarmonicOscillatorPotential(
                ho.topology,
                k=_kT(u) / u.Quantity(2.0 + 0.2 * i, u.angstrom) ** 2),
            temperature=300.0 * u.kelvin) for i in range(n)]

    pos = np.array([[0.05, -0.03, 0.02]], np.float32)
    _, u_kn = _parity(tmp_path, states, pos, None, n)
    assert np.isfinite(u_kn).all()


def test_mixed_registered_ladder_matches_jax(tmp_path):
    """Harmonic, LJ and ideal-gas states in one ladder: each replica runs
    its own kind's branch only."""
    fluid = jts.LennardJonesFluid(nparticles=8, reduced_density=0.3)
    md = ju.md_unit_system
    pos = np.asarray(fluid.positions.value_in_unit_system(md), np.float32)
    box = np.asarray(fluid.box_vectors.value_in_unit_system(md), np.float32)
    masses = np.asarray(fluid.topology.masses(), np.float64)

    def states(pkg):
        u = pkg["u"]
        top = pkg["top"].from_masses(masses)
        T = 300.0 * u.kelvin
        center = u.Quantity(np.full((1, 3), 0.5 * box[0, 0], np.float32),
                            u.nanometer)
        return [
            pkg["st"].ThermodynamicState(pkg["pot"].HarmonicOscillatorPotential(
                top, k=100.0 * u.kilojoule_per_mole / u.nanometer ** 2,
                x0=center), temperature=T),
            pkg["st"].ThermodynamicState(pkg["pot"].LJPotential(
                top, sigma=0.34 * u.nanometer,
                epsilon=0.5 * u.kilojoule_per_mole,
                cutoff=1.0 * u.nanometer), temperature=T),
            pkg["st"].ThermodynamicState(pkg["pot"].IdealGasPotential(top),
                                         temperature=T),
            pkg["st"].ThermodynamicState(pkg["pot"].LJPotential(
                top, sigma=0.34 * u.nanometer,
                epsilon=0.9 * u.kilojoule_per_mole,
                cutoff=1.0 * u.nanometer), temperature=T),
        ]

    tx, u_kn = _parity(tmp_path, states, pos, box, 4)
    assert np.isfinite(u_kn).all() and u_kn.shape == (4, 4)
    assert np.all(u_kn[:, 2] == 0.0)  # the ideal gas


def test_replica_count_must_divide_for_the_batched_path(tmp_path):
    mesh2 = tpar.Mesh("replica", None, 0, 2, torch.device("cpu"))
    ho = tts.HarmonicOscillator()
    states = [ts.ThermodynamicState(
        tp.HarmonicOscillatorPotential(ho.topology),
        temperature=300.0 * tu.kelvin) for _ in range(3)]
    ss = [ts.SamplerState(ho.positions, current_PRNG_key=i, device="cpu")
          for i in range(3)]
    ms = _sampler(PORT, states, ss, tmp_path, mesh=mesh2)
    assert ms._propagator is None  # 3 replicas over 2: the serial path
