"""The port's multistate samplers (``chiron_tpu_torch.multistate``) against
the JAX package's.

* On one given energy matrix, the port's ``ReplicaExchangeSampler`` makes
  JAX's swap decisions, and fills JAX's accept and propose matrices, bit
  for bit over six sweeps (both draw from numpy's ``default_rng`` seeded per
  iteration).
* The energy matrix of an LJ ladder on ``DensePairs`` (K1's plain version
  here, JAX's kernel in interpret mode) equals JAX's within 1e-5 relative.
* A 3-state harmonic-oscillator replica-exchange run gives MBAR ``f_k``
  within JAX's tolerance (0.15 kT) of the analytic values.
* A session saved, restored into a fresh sampler and continued equals the
  uninterrupted run bit for bit.

Mirrors ``tests/test_multistate.py`` and the session tests of
``tests/test_restart.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chiron_tpu.mcmc as jm
import chiron_tpu.multistate as jms
import chiron_tpu.neighbors as jn
import chiron_tpu.potential as jp
import chiron_tpu.reporters as jr
import chiron_tpu.states as js
import chiron_tpu.testsystems as jts
import chiron_tpu.units as ju
import chiron_tpu.utils as jutils
import chiron_tpu_torch.mcmc as tm
import chiron_tpu_torch.multistate as tms
import chiron_tpu_torch.neighbors as tn
import chiron_tpu_torch.potential as tp
import chiron_tpu_torch.reporters as tr
import chiron_tpu_torch.states as ts
import chiron_tpu_torch.testsystems as tts
import chiron_tpu_torch.units as tu
import chiron_tpu_torch.utils as tutils
from chiron_tpu.topology import Topology as JTopology
from chiron_tpu_torch import interop
from chiron_tpu_torch.topology import Topology as TTopology


def _ho_ladder(pkg, units, testsystems, utils, n_states, seed, tmp_dir,
               cls_name, timestep_fs=1.0, steps=25, device=None):
    """The reference's HO ladder, k_i = kT / sigma_i^2 with sigma_i = (2.0 +
    0.2 i) A at 300 K, on one package."""
    ho = testsystems.HarmonicOscillator()
    T = 300.0 * units.kelvin
    kT = units.BOLTZMANN_CONSTANT_kB * T * units.AVOGADRO_CONSTANT_NA
    thermo = [
        pkg["states"].ThermodynamicState(
            pkg["potential"].HarmonicOscillatorPotential(
                ho.topology, k=kT / units.Quantity(2.0 + 0.2 * i, units.angstrom) ** 2),
            temperature=T)
        for i in range(n_states)
    ]
    utils.PRNG.set_seed(seed)
    kw = {} if device is None else {"device": device}
    samplers = [pkg["states"].SamplerState(ho.positions,
                                           current_PRNG_key=utils.PRNG.get_random_key(),
                                           **kw)
                for _ in range(n_states)]
    pkg["reporters"].BaseReporter.set_directory(str(tmp_dir))
    reporter = pkg["reporters"].MultistateReporter()
    reporter.reset_reporter_file()
    move = pkg["mcmc"].LangevinDynamicsMove(
        timestep=timestep_fs * units.femtoseconds, number_of_steps=steps)
    sampler = getattr(pkg["multistate"], cls_name)(
        mcmc_sampler=pkg["mcmc"].MCMCSampler(
            pkg["mcmc"].MoveSchedule([("LangevinDynamicsMove", move)])),
        reporter=reporter)
    sampler.create(thermo, samplers, [None] * n_states)
    return sampler


JAX = dict(states=js, potential=jp, reporters=jr, mcmc=jm, multistate=jms)
PORT = dict(states=ts, potential=tp, reporters=tr, mcmc=tm, multistate=tms)


def _jax_ladder(tmp_dir, n_states=4, cls="ReplicaExchangeSampler", **kw):
    return _ho_ladder(JAX, ju, jts, jutils, n_states, 1234, tmp_dir, cls, **kw)


def _port_ladder(tmp_dir, n_states=4, cls="ReplicaExchangeSampler", seed=1234,
                 **kw):
    return _ho_ladder(PORT, tu, tts, tutils, n_states, seed, tmp_dir, cls,
                      device="cpu", **kw)


def test_swap_decisions_and_matrices_equal_jax(tmp_path):
    """Six even/odd sweeps over one 5 x 5 energy matrix, one with a large
    gap (always rejected) and one at zero (always accepted)."""
    j = _jax_ladder(tmp_path / "j", n_states=5)
    t = _port_ladder(tmp_path / "t", n_states=5)
    u = np.random.default_rng(8).normal(0.0, 1.5, (5, 5))
    u[:, 3] += np.array([0.0, 0.0, 0.0, 40.0, 0.0])
    for sampler in (j, t):
        sampler._energy_thermodynamic_states = u.copy()
    seen_accept = seen_reject = False
    for it in range(1, 7):
        j._iteration = t._iteration = it
        j._mix_replicas()
        t._mix_replicas()
        assert np.array_equal(t._replica_thermodynamic_states,
                              j._replica_thermodynamic_states), it
        assert np.array_equal(t._n_accepted_matrix, j._n_accepted_matrix), it
        assert np.array_equal(t._n_proposed_matrix, j._n_proposed_matrix), it
        acc, prop = t._n_accepted_matrix.sum(), t._n_proposed_matrix.sum()
        seen_accept |= acc > 0
        seen_reject |= acc < prop
    assert seen_accept and seen_reject
    assert sorted(t._replica_thermodynamic_states) == list(range(5))


def test_multistate_create_and_minimize(tmp_path):
    s = _port_ladder(tmp_path, cls="MultiStateSampler")
    assert (s.number_of_replicas, s.number_of_thermodynamic_states) == (4, 4)
    assert s.iteration == 0 and not s.is_periodic
    assert len(s.sampler_states) == 4
    # create() made the samplers' per-state copies
    assert len(s._mcmc_sampler) == 4
    for st in s._sampler_states:
        st.positions = torch.full((1, 3), 0.05)
    s.minimize(max_iterations=200)
    for st in s._sampler_states:
        assert torch.allclose(st.positions, torch.zeros(1, 3), atol=1e-2)


def test_create_makes_a_reporter_when_none_is_given(tmp_path):
    tr.BaseReporter.set_directory(str(tmp_path))
    ho = tts.HarmonicOscillator()
    s = tms.MultiStateSampler(tm.MCMCSampler(tm.MoveSchedule([])))
    s.create([ts.ThermodynamicState(ho.potential, temperature=300 * tu.kelvin)],
             [ts.SamplerState(ho.positions, current_PRNG_key=1, device="cpu")],
             [None])
    assert isinstance(s._reporter, tr.MultistateReporter)
    assert s._reporter.log_file_path.parent == tmp_path


@pytest.fixture(scope="module")
def lj_ladder_energies(tmp_path_factory):
    """JAX's energy matrix of an N=27 LJ ladder at 120, 130 and 140 K on
    DensePairs, three replicas at jittered lattices."""
    f = tts.LennardJonesFluid(nparticles=27, reduced_density=0.4)
    md = tu.md_unit_system
    box = f.box_vectors.value_in_unit_system(md).astype(np.float32)
    rng = np.random.default_rng(12)
    pos = [(f.positions.value_in_unit_system(md) + rng.normal(0, 0.03, (27, 3)))
           .astype(np.float32) % box[0, 0] for _ in range(3)]
    temps = (120.0, 130.0, 140.0)
    sig, cut = 0.34, 1.02

    def lj(pkg, units, topo):
        return pkg.LJPotential(topo.uniform(27, 39.948), sigma=sig * units.nanometer,
                               epsilon=0.238 * units.kilocalories_per_mole,
                               cutoff=cut * units.nanometer)

    jpot = lj(jp, ju, JTopology)
    jstates = [js.ThermodynamicState(jpot, temperature=T * ju.kelvin) for T in temps]
    u = []
    for p in pos:
        ss = js.SamplerState(ju.Quantity(jnp.asarray(p), ju.nanometer),
                             current_PRNG_key=jax.random.PRNGKey(0),
                             box_vectors=ju.Quantity(jnp.asarray(box), ju.nanometer))
        dp = jn.DensePairs(jn.OrthogonalPeriodicSpace(), cutoff=cut * ju.nanometer)
        dp.build_from_state(ss)
        u.append(np.asarray(js.calculate_reduced_potential_at_states(ss, jstates, dp)))
    return pos, box, temps, lj(tp, tu, TTopology), np.stack(u)


def test_energy_matrix_on_dense_pairs_matches_jax(lj_ladder_energies, tmp_path):
    pos, box, temps, tpot, u_jax = lj_ladder_energies
    tr.BaseReporter.set_directory(str(tmp_path))
    thermo = [ts.ThermodynamicState(tpot, temperature=T * tu.kelvin) for T in temps]
    samplers = [interop.sampler_state(p, 1 + i, None, box, "cpu")
                for i, p in enumerate(pos)]
    pairs = [tn.DensePairs(tn.OrthogonalPeriodicSpace(), cutoff=1.02 * tu.nanometer)
             for _ in temps]
    s = tms.MultiStateSampler(tm.MCMCSampler(tm.MoveSchedule([])))
    s.create(thermo, samplers, pairs)
    s._compute_energies()
    np.testing.assert_allclose(s._energy_thermodynamic_states, u_jax,
                               rtol=1e-5, atol=0)


def test_replica_exchange_ho_f_k_matches_analytic(tmp_path):
    """run(12) of a 3-state HO ladder (10 fs, 200 Langevin steps a move;
    the reference's n_iterations**2 propagations a replica): the swaps are
    proposed, the assignment stays a permutation, and MBAR's f_k lies
    within 0.15 kT of the analytic ladder, JAX's tolerance."""
    s = _port_ladder(tmp_path, n_states=3, timestep_fs=10.0, steps=200, seed=3)
    s.run(12)
    assert s.iteration == 12
    u_kn = s._reporter.get_property("u_kn")
    assert u_kn.shape == (13, 3, 3)
    assert s._n_proposed_matrix.sum() > 0
    assert sorted(s._replica_thermodynamic_states) == [0, 1, 2]
    f_an = np.array([-1.5 * math.log(2 * math.pi * (2.0 + 0.2 * i) ** 2)
                     for i in range(3)])
    assert np.allclose(f_an - f_an[0], s.f_k, atol=0.15), s.f_k


def test_session_restart_matches_the_uninterrupted_run(tmp_path):
    """run(2), then run(3) (one iteration more) in one sampler, against
    run(2), ``save_session``, ``load_session`` into a fresh sampler, run(3):
    the replicas, the permutation, the swap matrices and the energy matrix
    bit for bit."""
    ref = _port_ladder(tmp_path / "ref", seed=77, timestep_fs=2.0)
    ref.run(2)
    ref.run(3)

    a = _port_ladder(tmp_path / "a", seed=77, timestep_fs=2.0)
    a.run(2)
    path = str(tmp_path / "session.npz")
    a.save_session(path)
    b = _port_ladder(tmp_path / "b", seed=5, timestep_fs=2.0)
    meta = b.load_session(path)
    assert meta["iteration"] == 2 and b._iteration == 2
    b.run(3)

    assert b._iteration == ref._iteration == 3
    assert np.array_equal(b._replica_thermodynamic_states,
                          ref._replica_thermodynamic_states)
    assert np.array_equal(b._energy_thermodynamic_states,
                          ref._energy_thermodynamic_states)
    assert np.array_equal(b._n_accepted_matrix, ref._n_accepted_matrix)
    for sb, sr in zip(b._sampler_states, ref._sampler_states):
        assert torch.equal(sb.positions, sr.positions)
        assert torch.equal(sb.velocities, sr.velocities)
        assert sb.current_PRNG_key == sr.current_PRNG_key


def test_readme_mc_and_replica_exchange_snippet_runs_on_the_cpu(tmp_path):
    """The port's MC and replica-exchange block of README.md, as written,
    on the CPU: its states asked for the CPU, its reporters in a tmp dir,
    N=1000 cut to 125 and the move lengths to 10."""
    import pathlib
    import re

    readme = pathlib.Path(__file__).parent.parent / "README.md"
    blocks = [b for b in re.findall(r"```python\n(.*?)```", readme.read_text(), re.S)
              if "from chiron_tpu_torch.multistate import" in b]
    assert len(blocks) == 1, "the port's MC block is not in README.md"
    code = blocks[0]
    for old, new in (("box_vectors=fluid.box_vectors)",
                      'box_vectors=fluid.box_vectors, device="cpu")'),
                     ('set_directory("output")', f"set_directory({str(tmp_path)!r})"),
                     ("nparticles=1000", "nparticles=125"),
                     ("number_of_moves=100", "number_of_moves=10"),
                     ("number_of_steps=100", "number_of_steps=10")):
        assert old in code, old
        code = code.replace(old, new)
    ns = {}
    exec(compile(code, "README.md", "exec"), ns)
    state, rex = ns["state"], ns["rex"]
    assert state.positions.device.type == "cpu"
    assert bool(torch.isfinite(state.positions).all())
    box0 = torch.as_tensor(ns["fluid"].box_vectors.value_in_unit_system(
        tu.md_unit_system), dtype=torch.float32)
    assert not torch.equal(state.box_vectors, box0)  # the barostat moved it
    f_k = ns["f_k"]
    assert f_k.shape == (3,) and f_k[0] == 0.0 and np.isfinite(f_k).all()
    assert rex.iteration == 3
    assert (tmp_path / "multistate_reporter.h5").exists()
