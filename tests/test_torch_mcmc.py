"""The port's Metropolis moves (``chiron_tpu_torch.mcmc``) against the JAX
package's on the same inputs.

The packages draw different random streams (the port's keys are splitmix64
integers, JAX's threefry), so the chains are compared with JAX's own draws
fed to the port's (``run_mc_chain(..., draws)``, also inside
``MCMove.update``): the accept sequences and the autotuned sigma / vmax and the
statistics exactly, positions and boxes within 1e-5 nm, reduced potentials
within 1e-5 relative, and the neighbor lists exactly.  JAX's ``DensePairs``
runs its Pallas kernel in interpret mode on the CPU; the port's runs K1's
plain version.  The rest mirrors ``tests/test_mcmc.py`` on the port alone.
"""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chiron_tpu.mcmc as jm
import chiron_tpu.neighbors as jn
import chiron_tpu.potential as jp
import chiron_tpu.states as js
import chiron_tpu.units as ju
import chiron_tpu_torch.mcmc as tm
import chiron_tpu_torch.neighbors as tn
import chiron_tpu_torch.potential as tp
import chiron_tpu_torch.states as ts
import chiron_tpu_torch.units as tu
from chiron_tpu.topology import Topology as JTopology
from chiron_tpu_torch import interop
from chiron_tpu_torch.testsystems import (
    HarmonicOscillator,
    IdealGas,
    LennardJonesFluid,
)
from chiron_tpu_torch.topology import Topology as TTopology
from chiron_tpu_torch.utils import PRNG

N = 64
T_K = 140.0
SIGMA = 0.34
CUTOFF = 3 * SIGMA


def _np(a):
    return np.asarray(a)


@partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_draws(key, n, shape, displacement):
    """The draws of ``n`` JAX steps from the chain key ``key``, in the
    steps' own order: (noise or volume uniform, acceptance uniform)."""

    def body(k, _):
        k, kp, ka = jax.random.split(k, 3)
        if displacement:
            a = jax.random.normal(kp, shape, dtype=jnp.float32)
        else:
            a = jax.random.uniform(kp, minval=-1.0, maxval=1.0)
        return k, (a, jax.random.uniform(ka))

    return jax.lax.scan(body, key, length=n)[1]


def _port_draws(draws):
    return tuple(torch.tensor(_np(d)) for d in draws)


@pytest.fixture(scope="module")
def lattice():
    """A jittered N=64 lattice at rho* = 0.3, from a seed."""
    f = LennardJonesFluid(nparticles=N, reduced_density=0.3)
    md = tu.md_unit_system
    box = f.box_vectors.value_in_unit_system(md).astype(np.float32)
    rng = np.random.default_rng(5)
    pos = f.positions.value_in_unit_system(md) + rng.normal(0, 0.02, (N, 3))
    return (pos % box[0, 0]).astype(np.float32), box


def _lj(pkg, units, topo):
    return pkg.LJPotential(topo.uniform(N, 39.948), sigma=SIGMA * units.nanometer,
                           epsilon=0.238 * units.kilocalories_per_mole,
                           cutoff=CUTOFF * units.nanometer)


def _pairs(pkg, units, scheme, skin=0.05, capacity=40):
    space = pkg.OrthogonalPeriodicSpace()
    cut = CUTOFF * units.nanometer
    if scheme == "neighbor":
        return pkg.NeighborListNsqrd(space, cutoff=cut, skin=skin * units.nanometer,
                                     n_max_neighbors=capacity)
    if scheme == "pairlist":
        return pkg.PairListNsqrd(space, cutoff=cut)
    return pkg.DensePairs(space, cutoff=cut)


def _port_list_state(state, scheme):
    if scheme == "neighbor":
        return interop.neighbor_list_state(
            _np(state.neighbor_list), _np(state.neighbor_mask),
            _np(state.n_neighbors), _np(state.ref_positions),
            _np(state.box_vectors), _np(state.overflow), "cpu")
    if scheme == "pairlist":
        return interop.pair_list_state(_np(state.all_pairs),
                                       _np(state.reduction_mask),
                                       _np(state.box_vectors), "cpu")
    if scheme == "dense":
        return interop.dense_pairs_state(_np(state.box_vectors), "cpu")
    return None


def _run_both(kind, jpot, tpot, jpairs, tpairs, pos, box, n_steps, param,
              pressure=None, autotune=True, interval=10, key=3):
    """One chain of each package from one state, the port's on JAX's draws:
    returns ((JAX carry, records), (port carry, records))."""
    jts = js.ThermodynamicState(jpot, temperature=T_K * ju.kelvin,
                                pressure=None if pressure is None
                                else pressure * ju.atmosphere)
    tts = ts.ThermodynamicState(tpot, temperature=T_K * tu.kelvin,
                                pressure=None if pressure is None
                                else pressure * tu.atmosphere)
    jbox = None if box is None else jnp.asarray(box)
    if jpairs is not None:
        jpairs.build(jnp.asarray(pos), jbox)
        tpairs.build(torch.as_tensor(pos), None if box is None
                     else torch.as_tensor(box))
    jred = jts.make_reduced_potential_fn(jpairs)
    tred = tts.make_reduced_potential_fn(tpairs)
    if kind == "disp":
        jstep = jm.make_displacement_step_fn(jred, jpairs, None, autotune,
                                             interval)
        tstep = tm.make_displacement_step_fn(tred, tpairs, None, autotune,
                                             interval)
    else:
        jstep = jm.make_barostat_step_fn(jred, jpairs, pos.shape[0], autotune,
                                         interval)
        tstep = tm.make_barostat_step_fn(tred, tpairs, pos.shape[0], autotune,
                                         interval)
    jstate = None if jpairs is None else jpairs.state
    scheme = {jn.NeighborListNsqrd: "neighbor", jn.PairListNsqrd: "pairlist",
              jn.DensePairs: "dense"}.get(type(jpairs))
    u0 = jred(jnp.asarray(pos), jbox, jstate)
    jkey = jax.random.PRNGKey(key)
    jc = jm.MCCarry(positions=jnp.asarray(pos), box_vectors=jbox, key=jkey,
                    reduced_potential=jnp.asarray(u0, jnp.float32),
                    list_state=jstate, n_accepted=jnp.asarray(0, jnp.int32),
                    n_proposed=jnp.asarray(0, jnp.int32),
                    param=jnp.asarray(param, jnp.float32),
                    overflowed=jnp.asarray(False))
    jout = jm.run_mc_chain(jstep, jc, n_steps)
    draws = _jax_draws(jkey, n_steps, tuple(pos.shape), kind == "disp")
    tc = interop.mc_carry(pos, box, 0, _np(u0), _port_list_state(jstate, scheme),
                          0, 0, param, False, "cpu")
    tout = tm.run_mc_chain(tstep, tc, n_steps, _port_draws(draws))
    return jout, tout


def _assert_chains_equal(jout, tout, energy_rel=1e-5):
    (jc, jr), (tc, tr) = jout, tout
    acc_j = np.diff(_np(jr["n_accepted"]), prepend=0)
    acc_t = np.diff(tr["n_accepted"].numpy(), prepend=0)
    assert np.array_equal(acc_j, acc_t), "accept sequences differ"
    assert 0 < acc_j.sum() < acc_j.size
    assert np.array_equal(_np(jr["param"]), tr["param"].numpy())
    assert int(jc.n_accepted) == int(tc.n_accepted)
    assert int(jc.n_proposed) == int(tc.n_proposed)
    np.testing.assert_allclose(tc.positions.numpy(), _np(jc.positions),
                               rtol=0, atol=1e-5)
    if jc.box_vectors is not None:
        np.testing.assert_allclose(tc.box_vectors.numpy(),
                                   _np(jc.box_vectors), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tr["reduced_potential"].numpy(),
                               _np(jr["reduced_potential"]),
                               rtol=energy_rel, atol=1e-6)


# ---------------------------------------------------------------------------
# Chains on JAX's draws
# ---------------------------------------------------------------------------


def test_displacement_chain_ho_matches_jax():
    """200 proposals on a harmonic oscillator, sigma autotuned every 10
    (from 0.3 nm: it shrinks, then settles)."""
    jho = jp.HarmonicOscillatorPotential(
        JTopology.uniform(1), k=100.0 * ju.kilojoule_per_mole / ju.nanometer ** 2)
    tho = tp.HarmonicOscillatorPotential(
        TTopology.uniform(1), k=100.0 * tu.kilojoule_per_mole / tu.nanometer ** 2)
    pos = np.array([[0.05, -0.02, 0.01]], np.float32)
    jout, tout = _run_both("disp", jho, tho, None, None, pos, None, 200, 0.3)
    _assert_chains_equal(jout, tout)
    assert len(set(_np(jout[1]["param"]).tolist())) > 2  # the tune moved


def test_barostat_chain_ideal_gas_matches_jax():
    """150 volume moves of an ideal gas at 1 atm, vmax autotuned every 10
    (the increase branch runs into the cap of 0.3)."""
    n = 32
    jpot = jp.IdealGasPotential(JTopology.uniform(n))
    tpot = tp.IdealGasPotential(TTopology.uniform(n))
    rng = np.random.default_rng(2)
    box = np.eye(3, dtype=np.float32) * 3.0
    pos = rng.uniform(0, 3.0, (n, 3)).astype(np.float32)
    jpairs = jn.PairListNsqrd(jn.OrthogonalPeriodicSpace(), cutoff=None)
    tpairs = tn.PairListNsqrd(tn.OrthogonalPeriodicSpace(), cutoff=None)
    jout, tout = _run_both("baro", jpot, tpot, jpairs, tpairs, pos, box, 150,
                           0.25, pressure=1.0)
    _assert_chains_equal(jout, tout)


@pytest.mark.parametrize("kind", ["disp", "baro"])
def test_chains_lj_pairlist_match_jax(lattice, kind):
    """LJ at N=64 on PairListNsqrd: 100 displacement moves (sigma 0.02 nm)
    and 60 volume moves at 300 atm (vmax 0.02), each autotuned every 10."""
    pos, box = lattice
    jpot, tpot = _lj(jp, ju, JTopology), _lj(tp, tu, TTopology)
    jpairs, tpairs = _pairs(jn, ju, "pairlist"), _pairs(tn, tu, "pairlist")
    if kind == "disp":
        out = _run_both("disp", jpot, tpot, jpairs, tpairs, pos, box, 100, 0.02)
    else:
        out = _run_both("baro", jpot, tpot, jpairs, tpairs, pos, box, 60, 0.02,
                        pressure=300.0)
    _assert_chains_equal(*out)


def test_displacement_chain_neighbor_list_matches_jax(lattice):
    """100 displacement moves on NeighborListNsqrd with a 0.05 nm skin, so
    the chain rebuilds its list: the final lists equal JAX's exactly."""
    pos, box = lattice
    jpot, tpot = _lj(jp, ju, JTopology), _lj(tp, tu, TTopology)
    jpairs, tpairs = _pairs(jn, ju, "neighbor"), _pairs(tn, tu, "neighbor")
    jout, tout = _run_both("disp", jpot, tpot, jpairs, tpairs, pos, box, 100,
                           0.03)
    _assert_chains_equal(jout, tout)
    js_, ts_ = jout[0].list_state, tout[0].list_state
    assert not np.array_equal(_np(js_.ref_positions), pos)  # it rebuilt
    for name in ("neighbor_list", "neighbor_mask", "n_neighbors"):
        assert np.array_equal(getattr(ts_, name).numpy(), _np(getattr(js_, name))), name
    np.testing.assert_allclose(ts_.ref_positions.numpy(), _np(js_.ref_positions),
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def regrow_case():
    """JAX's grow-and-retry update: a dilute N=64 fluid with capacity 10,
    compressed at 5000 atm by 40 volume moves (vmax 0.25)."""
    f = LennardJonesFluid(nparticles=N, reduced_density=0.05)
    md = tu.md_unit_system
    pos = f.positions.value_in_unit_system(md).astype(np.float32)
    box = f.box_vectors.value_in_unit_system(md).astype(np.float32)
    jss = js.SamplerState(positions=ju.Quantity(jnp.asarray(pos), ju.nanometer),
                          current_PRNG_key=jax.random.PRNGKey(11),
                          box_vectors=ju.Quantity(jnp.asarray(box), ju.nanometer))
    chain_key = jax.random.split(jax.random.PRNGKey(11))[1]
    jts = js.ThermodynamicState(_lj(jp, ju, JTopology), temperature=T_K * ju.kelvin,
                                pressure=5000.0 * ju.atmosphere)
    jnl = _pairs(jn, ju, "neighbor", skin=0.4, capacity=10)
    jnl.build_from_state(jss)
    cap0 = jnl.n_max_neighbors
    move = jm.MonteCarloBarostatMove(volume_max_scale=0.25, number_of_moves=40)
    jss, _, jnl = move.update(jss, jts, jnl)
    draws = _jax_draws(chain_key, 40, (N, 3), False)
    return pos, box, cap0, move, jss, jnl, draws


def test_barostat_update_grow_and_retry_matches_jax(regrow_case, monkeypatch):
    """``MCMove.update``'s grow-and-retry on JAX's draws (each chain of the
    update, the retries too, is given them): the same grown capacity,
    statistics, box and lists as JAX's."""
    pos, box, cap0, jmove, jss, jnl, draws = regrow_case
    chain = tm.run_mc_chain
    monkeypatch.setattr(tm, "run_mc_chain", lambda step, carry, n: chain(
        step, carry, n, _port_draws(draws)))
    ss = interop.sampler_state(pos, 11, None, box, "cpu")
    tts = ts.ThermodynamicState(_lj(tp, tu, TTopology), temperature=T_K * tu.kelvin,
                                pressure=5000.0 * tu.atmosphere)
    nl = _pairs(tn, tu, "neighbor", skin=0.4, capacity=10)
    nl.build_from_state(ss)
    assert nl.n_max_neighbors == cap0
    move = tm.MonteCarloBarostatMove(volume_max_scale=0.25, number_of_moves=40)
    ss, _, nl = move.update(ss, tts, nl)
    assert nl.n_max_neighbors == jnl.n_max_neighbors > cap0
    assert (move.n_accepted, move.n_proposed) == (jmove.n_accepted, jmove.n_proposed)
    assert move.volume_max_scale == jmove.volume_max_scale
    np.testing.assert_allclose(ss.box_vectors.numpy(), _np(jss.box_vectors),
                               rtol=0, atol=1e-5)
    assert float(torch.det(ss.box_vectors.double())) < 0.7 * float(np.linalg.det(box))
    for name in ("neighbor_list", "neighbor_mask", "n_neighbors"):
        assert np.array_equal(getattr(nl.state, name).numpy(),
                              _np(getattr(jnl.state, name))), name


@pytest.fixture(scope="module")
def dense_case(lattice):
    """JAX's DensePairs chains at N=64 (Pallas interpret mode): 6
    displacement moves (sigma 0.045 nm) and 6 volume moves at 300 atm."""
    pos, box = lattice
    jpot = _lj(jp, ju, JTopology)
    out = {}
    for kind in ("disp", "baro"):
        jpairs = _pairs(jn, ju, "dense")
        out[kind] = _run_both(kind, jpot, _lj(tp, tu, TTopology), jpairs,
                              _pairs(tn, tu, "dense"), pos, box, 6,
                              0.045 if kind == "disp" else 0.05,
                              pressure=300.0, autotune=False)
    return out


@pytest.mark.parametrize("kind", ["disp", "baro"])
def test_dense_pairs_proposals_match_jax(dense_case, kind):
    """On K1 (DensePairs) the energies hold to 1e-5 relative and so the
    decisions hold too."""
    _assert_chains_equal(*dense_case[kind], energy_rel=1e-5)


def test_dense_pairs_log_ratios_match_jax(lattice):
    """Four displacement proposals (JAX's noise at sigma 0.045 nm) and four
    volume proposals (JAX's uniforms, vmax 0.05) from the lattice at 300
    atm: each package's reduced potential of the same proposal on
    DensePairs, and the log ratio of the proposal, within 1e-5 relative of
    JAX's."""
    pos, box = lattice
    jts = js.ThermodynamicState(_lj(jp, ju, JTopology), temperature=T_K * ju.kelvin,
                                pressure=300.0 * ju.atmosphere)
    tts = ts.ThermodynamicState(_lj(tp, tu, TTopology), temperature=T_K * tu.kelvin,
                                pressure=300.0 * tu.atmosphere)
    jpairs, tpairs = _pairs(jn, ju, "dense"), _pairs(tn, tu, "dense")
    jpairs.build(jnp.asarray(pos), jnp.asarray(box))
    tpairs.build(torch.tensor(pos), torch.tensor(box))
    jred = jts.make_reduced_potential_fn(jpairs)
    tred = tts.make_reduced_potential_fn(tpairs)
    u0 = float(jred(jnp.asarray(pos), jnp.asarray(box), jpairs.state))
    noise, _ = _jax_draws(jax.random.PRNGKey(6), 4, (N, 3), True)
    u_vol, _ = _jax_draws(jax.random.PRNGKey(7), 4, (N, 3), False)
    proposals = [((pos + 0.045 * np.asarray(d)) % box[0, 0], box) for d in noise]
    for u in np.asarray(u_vol):
        v = float(np.prod(np.diagonal(box)))
        s = np.float32(((v + u * 0.05 * v) / v) ** (1.0 / 3.0))
        proposals.append((pos * s, box * s))
    for x, b in proposals:
        x, b = x.astype(np.float32), b.astype(np.float32)
        uj = float(jred(jnp.asarray(x), jnp.asarray(b),
                        jn.DensePairsState(box_vectors=jnp.asarray(b))))
        ut = float(tred(torch.tensor(x), torch.tensor(b),
                        tn.DensePairsState(box_vectors=torch.tensor(b))))
        assert ut == pytest.approx(uj, rel=1e-5)
        assert (u0 - ut) == pytest.approx(u0 - uj, rel=1e-5, abs=1e-5 * abs(uj))


# ---------------------------------------------------------------------------
# The rest of tests/test_mcmc.py, on the port
# ---------------------------------------------------------------------------


def _ho_state(seed):
    PRNG.set_seed(seed)
    ho = HarmonicOscillator()
    ss = ts.SamplerState(positions=ho.positions,
                         current_PRNG_key=PRNG.get_random_key(), device="cpu")
    return ho, ss, ts.ThermodynamicState(potential=ho.potential,
                                         temperature=300.0 * tu.kelvin)


def test_move_schedule_validation():
    move = tm.MonteCarloDisplacementMove(number_of_moves=10)
    tm.MoveSchedule([("disp", move)])
    with pytest.raises(ValueError):
        tm.MoveSchedule([("bogus", 123)])


def test_displacement_move_ho():
    ho, ss, thermo = _ho_state(1234)
    move = tm.MonteCarloDisplacementMove(
        displacement_sigma=0.1 * tu.nanometer, number_of_moves=100)
    ss_out, _, _ = move.update(ss, thermo, None)
    assert move.n_proposed == 100
    assert 0 < move.n_accepted <= 100
    assert move.number_of_attemps_made == 100
    assert bool(torch.isfinite(ss_out.positions).all())
    move.update(ss_out, thermo, None)
    assert move.n_proposed == 200


def test_displacement_move_deterministic():
    outs = []
    for _ in range(2):
        ho, ss, thermo = _ho_state(42)
        m = tm.MonteCarloDisplacementMove(
            displacement_sigma=0.1 * tu.nanometer, number_of_moves=50)
        out, _, _ = m.update(ss, thermo, None)
        outs.append((out.positions.clone(), m.n_accepted))
    assert torch.equal(outs[0][0], outs[1][0]) and outs[0][1] == outs[1][1]


def test_displacement_autotune_shrinks_sigma():
    ho, ss, thermo = _ho_state(1234)
    move = tm.MonteCarloDisplacementMove(
        displacement_sigma=5.0 * tu.nanometer, number_of_moves=500,
        autotune=True, autotune_interval=50)
    move.update(ss, thermo, None)
    assert move.displacement_sigma.value_in_unit_system(tu.md_unit_system) < 5.0


@pytest.mark.parametrize("subset", [[1], np.array([1]), []])
def test_atom_subset_mask(subset):
    """Only the selected atom moves; an empty subset freezes all, and does
    not alias the no-mask chain."""
    PRNG.set_seed(7)
    pot = tp.IdealGasPotential(TTopology.uniform(3))
    ss = ts.SamplerState(positions=tu.Quantity(np.zeros((3, 3)), tu.nanometer),
                         current_PRNG_key=PRNG.get_random_key(), device="cpu")
    thermo = ts.ThermodynamicState(potential=pot, temperature=300.0 * tu.kelvin)
    move = tm.MonteCarloDisplacementMove(
        displacement_sigma=0.1 * tu.nanometer, number_of_moves=20,
        atom_subset=subset)
    out, _, _ = move.update(ss, thermo, None)
    moved = (out.positions != 0).any(dim=1).tolist()
    assert moved == [False, len(subset) > 0, False]


def test_barostat_requires_pressure():
    PRNG.set_seed(1234)
    gas = IdealGas(nparticles=8)
    ss = ts.SamplerState(positions=gas.positions,
                         current_PRNG_key=PRNG.get_random_key(),
                         box_vectors=gas.box_vectors, device="cpu")
    thermo = ts.ThermodynamicState(potential=gas.potential,
                                   temperature=298.0 * tu.kelvin)
    with pytest.raises(ValueError):
        tm.MonteCarloBarostatMove(number_of_moves=5).update(ss, thermo, None)


def test_langevin_dynamics_move_and_sampler_schedule():
    ho, ss, thermo = _ho_state(1234)
    move = tm.LangevinDynamicsMove(timestep=1.0 * tu.femtoseconds,
                                   number_of_steps=100)
    out, ts_out, _ = move.update(ss, thermo, None)
    assert ts_out is thermo and move.number_of_attemps_made == 100
    schedule = tm.MoveSchedule([
        ("disp", tm.MonteCarloDisplacementMove(
            displacement_sigma=0.1 * tu.nanometer, number_of_moves=20)),
        ("langevin", tm.LangevinDynamicsMove(timestep=1.0 * tu.femtoseconds,
                                             number_of_steps=50)),
    ])
    before = out.positions.clone()
    ss_out, _, _ = tm.MCMCSampler(schedule).run(out, thermo, n_iterations=2)
    assert bool(torch.isfinite(ss_out.positions).all())
    # run() works on copies: the input state is untouched
    assert torch.equal(out.positions, before)
    assert not torch.equal(ss_out.positions, before)


def test_dense_pairs_scheme_mc_and_deepcopy_shares_k1(lattice):
    """DensePairs drives displacement and barostat moves with the box
    flowing through the state; a deep-copied potential (``MCMCSampler.run``
    copies its thermodynamic state) reuses K1's op instead of copying or
    rebuilding it."""
    pos, box = lattice
    PRNG.set_seed(1234)
    pot = _lj(tp, tu, TTopology)
    ss = interop.sampler_state(pos, PRNG.get_random_key(), None, box, "cpu")
    thermo = ts.ThermodynamicState(potential=pot, temperature=T_K * tu.kelvin,
                                   pressure=10.0 * tu.atmosphere)
    pairs = _pairs(tn, tu, "dense")
    pairs.build_from_state(ss)
    nl = _pairs(tn, tu, "neighbor", skin=0.4, capacity=64)
    nl.build_from_state(ss)
    assert float(pot.compute_energy(ss.positions, pairs)) == pytest.approx(
        float(pot.compute_energy(ss.positions, nl)), rel=1e-5)

    early = copy.deepcopy(pot)  # a copy made before the op is built
    op = pot._dense_op(pairs, "cpu")
    assert early._dense_op(pairs, "cpu") is op
    clone = copy.deepcopy(pot)
    assert clone._dense_op(copy.deepcopy(pairs), "cpu") is op
    assert copy.deepcopy(thermo).potential._dense_op(pairs, "cpu") is op

    sampler = tm.MCMCSampler(tm.MoveSchedule([
        ("disp", tm.MonteCarloDisplacementMove(
            displacement_sigma=0.02 * tu.nanometer, number_of_moves=20)),
        ("baro", tm.MonteCarloBarostatMove(volume_max_scale=0.1,
                                           number_of_moves=20)),
    ]))
    ss2, _, pairs2 = sampler.run(ss, thermo, n_iterations=1, nbr_list=pairs)
    disp, baro = (m for _, m in sampler.move.move_schedule)
    assert disp.n_accepted > 0 and baro.n_proposed == 20
    assert not torch.equal(pairs2.state.box_vectors, torch.as_tensor(box))
    assert torch.equal(ss2.box_vectors, pairs2.state.box_vectors)
    assert bool(torch.isfinite(pot.compute_energy(ss2.positions, pairs2)))


def test_displacement_npt_report_logs_pure_potential(tmp_path):
    """With a pressure, the displacement move reports the pure potential
    (u/beta - P V): 0 for an ideal gas."""
    from chiron_tpu_torch.reporters import BaseReporter, MCReporter

    BaseReporter.set_directory(str(tmp_path))
    PRNG.set_seed(3)
    n = 8
    ss = ts.SamplerState(positions=tu.Quantity(np.zeros((n, 3)), tu.nanometer),
                         current_PRNG_key=PRNG.get_random_key(),
                         box_vectors=tu.Quantity(np.eye(3) * 2.0, tu.nanometer),
                         device="cpu")
    thermo = ts.ThermodynamicState(
        potential=tp.IdealGasPotential(TTopology.uniform(n)),
        temperature=300.0 * tu.kelvin, pressure=1.0 * tu.atmosphere,
        volume=8.0 * tu.nanometer ** 3)
    rep = MCReporter("npt_disp", buffer_size=100)
    move = tm.MonteCarloDisplacementMove(
        displacement_sigma=0.05 * tu.nanometer, number_of_moves=10,
        reporter=rep, report_interval=1)
    move.update(ss, thermo, None)
    pe = np.asarray(rep.get_property("potential_energy"))
    assert pe.shape == (10,) and np.allclose(pe, 0.0, atol=1e-5), pe


@pytest.mark.slow
def test_lj_mcmc_first_displacement_update_accepts_none_in_both_packages(
        monkeypatch):
    """The reference's Examples/LJ_MCMC.py state point (``examples/
    lj_mcmc.py``): 1100 packed methanes at 140 K and 13.00765 atm on
    ``DensePairs``.  The schedule's first displacement update (sigma 0.01
    nm, 100 moves, autotune every 100) moves all 1100 methanes a proposal
    and accepts none of them in JAX's package, in the port on JAX's draws,
    and in the port on its own stream, so the acceptance of that move
    cannot be strictly above 0 at this state point in either package; the
    autotune then shrinks sigma by 1.1 in both."""
    from chiron_tpu.utils import get_data_file_path as jax_data_path

    pos = np.load(jax_data_path("methane_1100_box4p275.npy")).astype(np.float32)
    box = np.eye(3, dtype=np.float32) * np.float32(4.275021399280942)
    n = pos.shape[0]

    def lj(pkg, units, topo):
        return pkg.LJPotential(
            topo.from_masses(np.full(n, 16.04)), sigma=0.373 * units.nanometer,
            epsilon=units.Quantity(148.0 * 0.008314462618,
                                   units.kilojoule_per_mole),
            cutoff=1.4 * units.nanometer)

    def move(pkg):
        return pkg.MonteCarloDisplacementMove(
            displacement_sigma=0.01 * (ju if pkg is jm else tu).nanometer,
            number_of_moves=100, autotune=True, autotune_interval=100)

    jkey = jax.random.PRNGKey(1234)
    jss = js.SamplerState(positions=ju.Quantity(jnp.asarray(pos), ju.nanometer),
                          current_PRNG_key=jkey,
                          box_vectors=ju.Quantity(jnp.asarray(box), ju.nanometer))
    jts = js.ThermodynamicState(lj(jp, ju, JTopology),
                                temperature=140.0 * ju.kelvin,
                                pressure=13.00765 * ju.atmosphere)
    jpairs = jn.DensePairs(jn.OrthogonalPeriodicSpace(), cutoff=1.4 * ju.nanometer)
    jpairs.build_from_state(jss)
    jmove = move(jm)
    jmove.update(jss, jts, jpairs)
    assert (jmove.n_accepted, jmove.n_proposed) == (0, 100)

    tts = ts.ThermodynamicState(lj(tp, tu, TTopology),
                                temperature=140.0 * tu.kelvin,
                                pressure=13.00765 * tu.atmosphere)
    draws = _jax_draws(jax.random.split(jkey)[1], 100, (n, 3), True)
    chain = tm.run_mc_chain
    sigma_j = jmove.displacement_sigma.value_in_unit(ju.nanometer)
    assert sigma_j < 0.01
    for given in (True, False):
        if given:
            monkeypatch.setattr(tm, "run_mc_chain", lambda step, carry, k:
                                chain(step, carry, k, _port_draws(draws)))
        else:
            monkeypatch.setattr(tm, "run_mc_chain", chain)
        ss = interop.sampler_state(pos, 1234, None, box, "cpu")
        pairs = tn.DensePairs(tn.OrthogonalPeriodicSpace(),
                              cutoff=1.4 * tu.nanometer)
        pairs.build_from_state(ss)
        tmove = move(tm)
        ss2, _, _ = tmove.update(ss, tts, pairs)
        assert (tmove.n_accepted, tmove.n_proposed) == (0, 100), given
        assert tmove.displacement_sigma.value_in_unit(tu.nanometer) == sigma_j
        assert torch.equal(ss2.positions, ss.positions)
