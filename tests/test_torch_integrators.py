"""The port's integrator, runner and minimizers (``chiron_tpu_torch.
integrators``, ``runtime.make_langevin_runner``, ``minimize``) against the
JAX package's on the same inputs.

The two packages draw different random streams (the port's keys are
splitmix64 integers, JAX's threefry), so the trajectories are compared with
JAX's own noise fed to the port's step (``make_baoab_step_fn(...)(carry,
noise)``), or without noise (collision rate 0) through the whole
``LangevinIntegrator.run``: positions to 1e-5 nm, velocities to 1e-4 nm/ps,
the neighbor lists exactly.  The minimizers must stop at JAX's iteration
with its energy to 1e-5 relative.  JAX's ``DensePairs`` runs its Pallas
kernel in interpret mode; the port's runs K1's plain version on the CPU.
"""

import re
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chiron_tpu.integrators as ji
import chiron_tpu.minimize as jmin
import chiron_tpu.neighbors as jn
import chiron_tpu.potential as jp
import chiron_tpu.states as js
import chiron_tpu.testsystems as jts
import chiron_tpu.units as ju
import chiron_tpu_torch.integrators as ti
import chiron_tpu_torch.minimize as tmin
import chiron_tpu_torch.neighbors as tn
import chiron_tpu_torch.potential as tp
import chiron_tpu_torch.states as ts
import chiron_tpu_torch.testsystems as tts
import chiron_tpu_torch.units as tu
from chiron_tpu.topology import Topology as JTopology
from chiron_tpu_torch import interop
from chiron_tpu_torch.runtime import make_langevin_runner
from chiron_tpu_torch.topology import Topology as TTopology
from chiron_tpu_torch.utils import PRNG

N = 125
T_K = 120.0
DT = 0.002
STEPS = 20


def _np(a):
    return np.asarray(a)


@pytest.fixture(scope="module")
def melt():
    """A jittered N=125 lattice at rho* = 0.5 and Maxwell-Boltzmann
    velocities at 120 K, from a seed."""
    f = tts.LennardJonesFluid(nparticles=N, reduced_density=0.5)
    md = tu.md_unit_system
    box = f.box_vectors.value_in_unit_system(md).astype(np.float32)
    rng = np.random.default_rng(17)
    pos = f.positions.value_in_unit_system(md) + rng.normal(0, 0.02, (N, 3))
    pos = (pos % box[0, 0]).astype(np.float32)
    sig_v = np.sqrt(tu.kB_MD * T_K / 39.948)
    vel = (sig_v * rng.normal(size=(N, 3))).astype(np.float32)
    return pos, vel, box


def _pairs(pkg, units, scheme, skin=0.02):
    cut = 3 * 0.34 * units.nanometer
    space = pkg.OrthogonalPeriodicSpace()
    if scheme == "neighbor":
        return pkg.NeighborListNsqrd(space, cutoff=cut, skin=skin * units.nanometer,
                                     n_max_neighbors=90)
    if scheme == "pairlist":
        return pkg.PairListNsqrd(space, cutoff=cut)
    return pkg.DensePairs(space, cutoff=cut)


def _lj(pkg, units, topo):
    return pkg.LJPotential(topo.uniform(N, 39.948), sigma=0.34 * units.nanometer,
                           epsilon=0.238 * units.kilocalories_per_mole,
                           cutoff=3 * 0.34 * units.nanometer)


def _jax_list_state_in_port(state, scheme):
    if scheme == "neighbor":
        return interop.neighbor_list_state(
            _np(state.neighbor_list), _np(state.neighbor_mask),
            _np(state.n_neighbors), _np(state.ref_positions),
            _np(state.box_vectors), _np(state.overflow), "cpu")
    if scheme == "pairlist":
        return interop.pair_list_state(_np(state.all_pairs),
                                       _np(state.reduction_mask),
                                       _np(state.box_vectors), "cpu")
    return interop.dense_pairs_state(_np(state.box_vectors), "cpu")


@pytest.mark.parametrize("scheme", ["neighbor", "pairlist", "dense"])
def test_baoab_steps_with_jax_noise_match_jax(melt, scheme):
    """20 steps of ``make_baoab_step_fn`` from the JAX carry, carried over
    by ``interop``, each with the noise JAX draws from its key."""
    pos, vel, box = melt
    kT = tu.kB_MD * T_K
    masses = np.full((N, 1), 39.948, np.float32)

    jpairs = _pairs(jn, ju, scheme)
    jpairs.build(jnp.asarray(pos), jnp.asarray(box))
    jl = _lj(jp, ju, JTopology)
    jfn = jl.make_energy_fn(jpairs)
    jstep = ji.make_baoab_step_fn(jfn, jnp.asarray(masses), DT, 1.0, kT,
                                  pairs=jpairs)
    jstate = jpairs.state
    if scheme == "dense":
        jstate = jn.DensePairsState(box_vectors=jnp.asarray(box))
    jF = jax.grad(lambda x, s: -jfn(x, s))(jnp.asarray(pos), jstate)
    jc = ji.LangevinCarry(x=jnp.asarray(pos), v=jnp.asarray(vel), F=jF,
                          key=jax.random.PRNGKey(2), nbr_state=jstate,
                          box_vectors=jnp.asarray(box),
                          overflowed=jnp.asarray(False))

    tpairs = _pairs(tn, tu, scheme)
    tpairs.build(torch.from_numpy(pos), torch.from_numpy(box))
    tl = _lj(tp, tu, TTopology)
    tstep = ti.make_baoab_step_fn(tl.make_energy_fn(tpairs),
                                  torch.from_numpy(masses), DT, 1.0, kT,
                                  pairs=tpairs)
    tc = interop.general_langevin_carry(
        _np(jc.x), _np(jc.v), _np(jc.F), box, False, 0,
        _jax_list_state_in_port(jstate, scheme), "cpu")

    rebuilds = 0
    for _ in range(STEPS):
        _, sub = jax.random.split(jc.key)
        noise = jax.random.normal(sub, jc.x.shape, dtype=jc.x.dtype)
        before = jc.nbr_state
        jc = ji.run_chunk(jstep, jc, 1)
        tc = tstep(tc, torch.tensor(np.array(noise)))
        if scheme == "neighbor":
            rebuilds += int(not np.array_equal(_np(before.ref_positions),
                                               _np(jc.nbr_state.ref_positions)))
    assert np.abs(tc.x.numpy() - _np(jc.x)).max() < 1e-5
    assert np.abs(tc.v.numpy() - _np(jc.v)).max() < 1e-4
    assert bool(tc.overflowed) == bool(jc.overflowed) is False
    if scheme == "neighbor":
        assert rebuilds > 0  # the step's rebuild ran, at JAX's steps
        for name in ("neighbor_list", "neighbor_mask", "n_neighbors"):
            np.testing.assert_array_equal(getattr(tc.nbr_state, name).numpy(),
                                          _np(getattr(jc.nbr_state, name)))


@pytest.mark.parametrize("scheme", ["neighbor", "dense"])
def test_integrator_run_without_noise_matches_jax(melt, scheme):
    """The whole ``LangevinIntegrator.run`` (the list build, the step cache,
    the chunks, the write-back) at collision rate 0, where neither package
    draws noise into the trajectory."""
    pos, vel, box = melt
    jss = js.SamplerState(
        positions=ju.Quantity(jnp.asarray(pos), ju.nanometer),
        current_PRNG_key=jax.random.PRNGKey(0),
        velocities=ju.Quantity(jnp.asarray(vel), ju.nanometer / ju.picosecond),
        box_vectors=ju.Quantity(jnp.asarray(box), ju.nanometer))
    tss = interop.sampler_state(pos, 0, vel, box, device="cpu")
    jint = ji.LangevinIntegrator(timestep=2.0 * ju.femtoseconds,
                                 collision_rate=0.0 / ju.picoseconds,
                                 report_interval=10)
    tint = ti.LangevinIntegrator(timestep=2.0 * tu.femtoseconds,
                                 collision_rate=0.0 / tu.picoseconds,
                                 report_interval=10)
    jthermo = js.ThermodynamicState(_lj(jp, ju, JTopology), temperature=T_K * ju.kelvin)
    tthermo = ts.ThermodynamicState(_lj(tp, tu, TTopology), temperature=T_K * tu.kelvin)
    jss, jnl = jint.run(jss, jthermo, STEPS, nbr_list=_pairs(jn, ju, scheme))
    tss, tnl = tint.run(tss, tthermo, STEPS, nbr_list=_pairs(tn, tu, scheme))
    assert np.abs(tss.positions.numpy() - _np(jss.positions)).max() < 1e-5
    assert np.abs(tss.velocities.numpy() - _np(jss.velocities)).max() < 1e-4
    if scheme == "neighbor":
        np.testing.assert_array_equal(tnl.neighbor_list.numpy(),
                                      _np(jnl.neighbor_list))
    # particles stay wrapped in the box
    assert bool((tss.positions >= 0).all() and (tss.positions <= box[0, 0]).all())


def test_runner_step_fn_tracks_neighbor_capacity_regrowth():
    """``make_langevin_runner`` builds its step before ``init`` regrows the
    list's capacity: the step's rebuild must use the live capacity."""
    fluid = tts.LennardJonesFluid(nparticles=200, reduced_density=0.6)
    pairs = tn.NeighborListNsqrd(tn.OrthogonalPeriodicSpace(),
                                 cutoff=fluid.cutoff, skin=0.5 * tu.nanometer,
                                 n_max_neighbors=8)  # deliberately too small
    runner = make_langevin_runner(fluid.potential, pairs=pairs,
                                  topology=fluid.topology,
                                  temperature=120.0 * tu.kelvin, device="cpu")
    md = tu.md_unit_system
    state = runner.init(fluid.positions.value_in_unit_system(md),
                        fluid.box_vectors.value_in_unit_system(md), seed=0)
    assert pairs.n_max_neighbors > 8  # the regrow happened
    state = runner.run(state, 20)
    assert not bool(state.overflowed)
    assert bool(torch.isfinite(state.x).all())
    assert state.nbr_state.neighbor_list.shape[1] == pairs.n_max_neighbors


def _ho_setup(seed=1234):
    PRNG.set_seed(seed)
    ho = tts.HarmonicOscillator()
    ss = ts.SamplerState(positions=ho.positions,
                         current_PRNG_key=PRNG.get_random_key(), device="cpu")
    thermo = ts.ThermodynamicState(potential=ho.potential,
                                   temperature=300.0 * tu.kelvin)
    return ho, ss, thermo


def test_report_cadence():
    class Capture:
        def __init__(self):
            self.records = []

        def report(self, d):
            self.records.append(d)

    _, ss, thermo = _ho_setup()
    rep = Capture()
    integ = ti.LangevinIntegrator(timestep=1.0 * tu.femtoseconds,
                                  report_interval=50, reporter=rep,
                                  save_traj_in_memory=True)
    integ.run(ss, thermo, number_of_steps=200)
    assert [r["step"] for r in rep.records] == [0, 50, 100, 150]
    assert all("potential_energy" in r for r in rep.records)
    assert len(integ.traj) == 4


def test_same_seed_same_trajectory():
    _, ss1, thermo = _ho_setup()
    out1, _ = ti.LangevinIntegrator(timestep=2.0 * tu.femtoseconds).run(
        ss1, thermo, number_of_steps=100)
    _, ss2, thermo2 = _ho_setup()
    out2, _ = ti.LangevinIntegrator(timestep=2.0 * tu.femtoseconds).run(
        ss2, thermo2, number_of_steps=100)
    assert torch.equal(out1.positions, out2.positions)
    assert torch.equal(out1.velocities, out2.velocities)
    assert out1.current_PRNG_key == out2.current_PRNG_key
    _, ss3, thermo3 = _ho_setup(seed=4321)
    out3, _ = ti.LangevinIntegrator(timestep=2.0 * tu.femtoseconds).run(
        ss3, thermo3, number_of_steps=100)
    assert not torch.equal(out1.positions, out3.positions)
    # a refresh draws new velocities
    integ = ti.LangevinIntegrator(timestep=1.0 * tu.femtoseconds,
                                  refresh_velocities=True)
    out, _ = integ.run(out3, thermo3, number_of_steps=10)
    assert torch.isfinite(out.velocities).all()


def test_runner_repeats_bit_for_bit_from_one_carry(melt):
    pos, _, box = melt
    pairs = _pairs(tn, tu, "dense")
    pairs.build(torch.from_numpy(pos), torch.from_numpy(box))
    runner = make_langevin_runner(_lj(tp, tu, TTopology), pairs=pairs,
                                  temperature=T_K * tu.kelvin, device="cpu")
    s0 = runner.init(pos, box, seed=3)
    x0 = s0.x.clone()
    a, b = runner.run(s0, 10), runner.run(s0, 10)
    for name in ("x", "v", "F"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert torch.equal(s0.x, x0) and a.key == b.key != s0.key
    assert torch.isfinite(runner.energy(a))
    with pytest.raises(ValueError, match="build the DensePairs"):
        make_langevin_runner(_lj(tp, tu, TTopology), pairs=_pairs(tn, tu, "dense"),
                             device="cpu")


@pytest.mark.slow
def test_langevin_ho_equipartition():
    """<U> ~ (3/2) kT for the 3D HO (statistical convergence).

    The JAX test's one 20,000-step chain puts the mean's standard error
    near 8% (the spread of the port's chain means over 8 seeds); the
    port averages 4 chains (seeds 1234-1237), about 4%, against the same
    15% tolerance."""
    energies = []
    for seed in range(1234, 1238):
        ho, ss, thermo = _ho_setup(seed)
        integ = ti.LangevinIntegrator(timestep=4.0 * tu.femtoseconds,
                                      collision_rate=2.0 / tu.picoseconds,
                                      report_interval=10,
                                      save_traj_in_memory=True)
        ss, _ = integ.run(ss, thermo, number_of_steps=2000)
        integ.traj = []
        ss, _ = integ.run(ss, thermo, number_of_steps=20000)
        energies += [float(ho.potential.compute_energy(x)) for x in integ.traj]
    expected = ho.expectation_potential_energy(300.0 * tu.kelvin)
    assert sum(energies) / len(energies) == pytest.approx(expected, rel=0.15)


def test_gradient_through_trajectory_matches_finite_difference():
    """d U(x_25) / d epsilon through 25 BAOAB steps of the port's step,
    the carry's ``x`` requiring grad so that each force keeps its graph,
    against a central finite difference (5%)."""
    n = 27
    fluid = tts.LennardJonesFluid(nparticles=n, reduced_density=0.5)
    md = tu.md_unit_system
    box = torch.as_tensor(fluid.box_vectors.value_in_unit_system(md))
    box_diag = torch.diagonal(box)
    x0 = torch.as_tensor(fluid.positions.value_in_unit_system(md))
    masses = torch.full((n, 1), 39.9)
    kT = tu.kB_MD * 120.0
    rng = np.random.default_rng(3)
    noises = torch.from_numpy(rng.normal(size=(25, n, 3)).astype(np.float32))
    v0 = torch.sqrt(kT / masses) * torch.from_numpy(
        rng.normal(size=(n, 3)).astype(np.float32))
    sigma = torch.tensor(0.34)

    def loss(eps):
        def energy_fn(x, _state=None):
            return tp._lj_allpairs_energy(
                {"sigma": sigma, "epsilon": eps, "cutoff": 1.02}, x, box_diag)

        step = ti.make_baoab_step_fn(energy_fn, masses, DT, 1.0, kT)
        x = x0.clone().requires_grad_(True)
        carry = ti.LangevinCarry(x=x, v=v0, F=ti.force_of(energy_fn, x, None),
                                 box_vectors=None,
                                 overflowed=torch.zeros((), dtype=torch.bool),
                                 key=0)
        for k in range(25):
            carry = step(carry, noises[k])
        return energy_fn(carry.x)

    eps0 = torch.tensor(0.9, requires_grad=True)
    (g,) = torch.autograd.grad(loss(eps0), eps0)
    h = 1e-3
    fd = (float(loss(torch.tensor(0.9 + h)).detach())
          - float(loss(torch.tensor(0.9 - h)).detach())) / (2 * h)
    assert abs(fd - float(g)) / max(abs(fd), 1e-9) < 0.05, (float(g), fd)


def _two_particle_lj(pkg, units, topo):
    return pkg.LJPotential(topo.uniform(2, 39.948), sigma=0.34 * units.nanometer,
                           epsilon=0.238 * units.kilocalories_per_mole,
                           cutoff=3 * 0.34 * units.nanometer)


MIN_CASES = ["lj_open", "lj_neighbor", "ho"]


def _min_inputs(pkg, nbrs, units, topo, case):
    if case == "ho":
        pot = pkg.HarmonicOscillatorPotential(
            topo.uniform(1), k=100.0 * units.kilojoule_per_mole / units.nanometer ** 2,
            x0=units.Quantity(np.full((1, 3), 0.5, np.float32), units.nanometer))
        return np.zeros((1, 3), np.float32), pot, None
    x0 = np.array([[0.0, 0.0, 0.0], [0.4, 0.0, 0.0]], np.float32)
    pot = _two_particle_lj(pkg, units, topo)
    if case == "lj_open":
        return x0, pot, None
    nbr = nbrs.NeighborListNsqrd(nbrs.OrthogonalPeriodicSpace(),
                                cutoff=3 * 0.34 * units.nanometer,
                                skin=0.5 * units.nanometer, n_max_neighbors=5)
    return x0, pot, nbr


@pytest.mark.parametrize("method", ["minimize_energy", "fire_descent"])
@pytest.mark.parametrize("case", MIN_CASES)
def test_minimizers_match_jax(case, method):
    jx, jpot, jnbr = _min_inputs(jp, jn, ju, JTopology, case)
    tx, tpot, tnbr = _min_inputs(tp, tn, tu, TTopology, case)
    box = np.eye(3, dtype=np.float32) * 10.0
    if jnbr is not None:
        jnbr.build(jnp.asarray(jx), jnp.asarray(box))
        tnbr.build(torch.from_numpy(tx), torch.from_numpy(box))
    jr = getattr(jmin, method)(jnp.asarray(jx), jpot.compute_energy, jnbr,
                               maxiter=2000)
    tr = getattr(tmin, method)(torch.from_numpy(tx), tpot.compute_energy, tnbr,
                               maxiter=2000)
    assert int(tr.n_iterations) == int(jr.n_iterations)
    assert bool(tr.converged) == bool(jr.converged)
    e_j, e_t = float(jr.energy), float(tr.energy)
    assert abs(e_t - e_j) <= 1e-5 * max(abs(e_j), 1.0)
    np.testing.assert_allclose(tr.params.numpy(), _np(jr.params), atol=1e-5)
    if case != "ho":  # the reference's targets: E -> -eps, r -> 2^(1/6) sigma
        r = float(torch.linalg.vector_norm(tr.params[1] - tr.params[0]))
        assert abs(r - 0.34 * 2 ** (1 / 6)) < 1e-3


@pytest.mark.parametrize("every", [7, 5000])
def test_minimizer_flag_reads_do_not_change_the_result(monkeypatch, every):
    """The loop reads ``done`` every ``CHECK_EVERY`` iterations: another
    interval gives the iterations and the point of checking every one."""
    x0, pot, _ = _min_inputs(tp, tn, tu, TTopology, "lj_open")
    monkeypatch.setattr(tmin, "CHECK_EVERY", 1)
    ref = tmin.fire_descent(torch.from_numpy(x0), pot.compute_energy,
                            maxiter=2000)
    monkeypatch.setattr(tmin, "CHECK_EVERY", every)
    r = tmin.fire_descent(torch.from_numpy(x0), pot.compute_energy,
                          maxiter=2000)
    assert int(r.n_iterations) == int(ref.n_iterations)
    assert torch.equal(r.params, ref.params)


def test_readme_quick_start_runs_in_the_port_on_the_cpu():
    """The port's quick start in README.md, as written, on the CPU: its
    ``SamplerState`` asked for the CPU and its 10,000 steps cut to 300."""
    readme = pathlib.Path(__file__).parent.parent / "README.md"
    blocks = [b for b in re.findall(r"```python\n(.*?)```", readme.read_text(), re.S)
              if "import chiron_tpu_torch.units as unit" in b]
    assert len(blocks) == 1, "the port's quick-start block is not in README.md"
    code = blocks[0]
    code = code.replace("box_vectors=fluid.box_vectors)",
                        'box_vectors=fluid.box_vectors, device="cpu")')
    code = code.replace("number_of_steps=10_000", "number_of_steps=300")
    assert 'device="cpu"' in code and "number_of_steps=300" in code
    ns = {}
    exec(compile(code, "README.md", "exec"), ns)
    state = ns["state"]
    assert state.positions.device.type == "cpu"
    assert state.positions.shape == (1000, 3)
    assert bool(torch.isfinite(state.positions).all())
    assert not bool(ns["nbr"].state.overflow)
