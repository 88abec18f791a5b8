"""The port's states and utilities (``chiron_tpu_torch.states``, ``utils``)
against the JAX package's: validation as the JAX tests hold it, the MD
conversion, the integer PRNG keys, and reduced potentials in NVT and NpT
and at several states to 1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chiron_tpu.neighbors as jn
import chiron_tpu.potential as jp
import chiron_tpu.states as js
import chiron_tpu.units as ju
import chiron_tpu_torch.neighbors as tn
import chiron_tpu_torch.potential as tp
import chiron_tpu_torch.states as ts
import chiron_tpu_torch.units as tu
import chiron_tpu_torch.utils as tutils
from chiron_tpu.topology import Topology as JTopology
from chiron_tpu_torch import interop
from chiron_tpu_torch.topology import Topology as TTopology


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _state(pos, key=7, box=None, units=tu):
    return ts.SamplerState(
        positions=units.Quantity(pos, units.nanometer), current_PRNG_key=key,
        box_vectors=None if box is None else units.Quantity(box, units.nanometer),
        device="cpu")


def test_sampler_state_validation():
    pos = np.zeros((3, 3), np.float32)
    with pytest.raises(TypeError):
        ts.SamplerState(positions=pos, current_PRNG_key=1, device="cpu")
    with pytest.raises(ValueError):
        ts.SamplerState(positions=tu.Quantity(pos, tu.picosecond),
                        current_PRNG_key=1, device="cpu")
    with pytest.raises(ValueError):
        ts.SamplerState(positions=tu.Quantity(pos, tu.nanometer),
                        current_PRNG_key=1, device="cpu",
                        velocities=tu.Quantity(pos, tu.nanometer))
    with pytest.raises(ValueError):
        ts.SamplerState(positions=tu.Quantity(pos, tu.nanometer),
                        current_PRNG_key=1, device="cpu",
                        velocities=tu.Quantity(np.zeros((4, 3)),
                                               tu.nanometer / tu.picosecond))
    with pytest.raises(ValueError):
        ts.SamplerState(positions=tu.Quantity(pos, tu.nanometer),
                        current_PRNG_key=1, device="cpu",
                        box_vectors=tu.Quantity(np.zeros((4, 3)), tu.nanometer))
    with pytest.raises(TypeError):
        ts.SamplerState(positions=tu.Quantity(pos, tu.nanometer),
                        current_PRNG_key=1, device="cpu", box_vectors=np.eye(3))
    with pytest.raises(ValueError):
        ts.SamplerState(positions=tu.Quantity(pos, tu.nanometer),
                        current_PRNG_key=None, device="cpu")


def test_sampler_state_md_conversion_device_and_dtype():
    ss = ts.SamplerState(positions=tu.Quantity(np.ones((2, 3)) * 10.0, tu.angstrom),
                         current_PRNG_key=1, device="cpu")
    assert torch.allclose(ss.positions, torch.ones(2, 3))
    assert ss.positions.dtype == torch.float32
    assert ss.positions.device.type == "cpu"
    assert ss.number_of_particles == 2
    assert ss.velocities is None and ss.box_vectors is None
    ss.velocities = tu.Quantity(np.ones((2, 3)), tu.angstrom / tu.picosecond)
    assert torch.allclose(ss.velocities, torch.full((2, 3), 0.1))
    with pytest.raises(ValueError):
        ss.velocities = np.zeros((5, 3))
    # the openmm row layout of a box
    rows = [tu.Quantity(np.array(r, np.float32), tu.angstrom)
            for r in np.eye(3) * 20.0]
    sb = ts.SamplerState(positions=tu.Quantity(np.zeros((1, 3)), tu.nanometer),
                         current_PRNG_key=1, box_vectors=rows, device="cpu")
    assert torch.equal(sb.box_vectors, torch.eye(3) * 2.0)


def test_keys_split_deterministically_and_apart():
    tutils.PRNG.set_seed(1234)
    a = [tutils.PRNG.get_random_key() for _ in range(3)]
    tutils.PRNG.set_seed(1234)
    assert [tutils.PRNG.get_random_key() for _ in range(3)] == a
    assert len(set(a)) == 3 and all(0 <= k < 2 ** 64 for k in a)
    ss = _state(np.zeros((2, 3), np.float32), key=a[0])
    k1, k2 = ss.new_PRNG_key, ss.new_PRNG_key
    assert k1 != k2 and ss.current_PRNG_key not in (a[0], k1, k2)
    assert tutils.split(5, 3)[:2] == tutils.split(5)
    x = tutils.normal(k1, (1000,), "cpu")
    assert torch.equal(x, tutils.normal(k1, (1000,), "cpu"))
    assert abs(float(x.mean())) < 0.1 and abs(float(x.std()) - 1.0) < 0.1


def test_sampler_state_data_roundtrip():
    ss = _state(np.zeros((2, 3), np.float32), box=np.eye(3, dtype=np.float32))
    data = ss.as_data()
    assert data.n_particles == 2 and float(data.volume) == pytest.approx(1.0)
    moved = ts.SamplerStateData(positions=data.positions + 1.0,
                                velocities=None, box_vectors=None, key=99)
    ss.update_from_data(moved)
    assert torch.equal(ss.positions, torch.ones(2, 3))
    assert ss.current_PRNG_key == 99 and ss.box_vectors is not None


def test_thermodynamic_state_validation_and_scalars():
    ho = tp.HarmonicOscillatorPotential(TTopology.uniform(1))
    with pytest.raises(TypeError):
        ts.ThermodynamicState(potential=ho, temperature=300.0)
    with pytest.raises(ValueError):
        ts.ThermodynamicState(potential=ho, temperature=300.0 * tu.nanometer)
    with pytest.raises(TypeError):
        ts.ThermodynamicState(potential=ho, temperature=300.0 * tu.kelvin,
                              pressure=1.0)
    with pytest.raises(ValueError):
        ts.ThermodynamicState(potential=ho, temperature=300.0 * tu.kelvin,
                              pressure=1.0 * tu.kelvin)
    with pytest.raises(ValueError):
        ts.ThermodynamicState(potential=ho, temperature=300.0 * tu.kelvin,
                              volume=1.0 * tu.kelvin)
    t = ts.ThermodynamicState(potential=ho, temperature=300.0 * tu.kelvin,
                              pressure=1.0 * tu.bar)
    j = js.ThermodynamicState(potential=jp.HarmonicOscillatorPotential(
        JTopology.uniform(1)), temperature=300.0 * ju.kelvin,
        pressure=1.0 * ju.bar)
    assert t.check_variables() == j.check_variables() == ["temperature", "pressure"]
    assert t.kT_md == pytest.approx(j.kT_md, rel=1e-12)
    assert t.beta_md == pytest.approx(j.beta_md, rel=1e-12)
    assert t.pressure_md == pytest.approx(j.pressure_md, rel=1e-12)
    assert t.kT_to_kJ_per_mol(2.0) == pytest.approx(2.0 * j.kT_md, rel=1e-12)


@pytest.fixture(scope="module")
def lj_pair():
    rng = np.random.default_rng(21)
    n, L = 40, 2.4
    pos = rng.uniform(0, L, size=(n, 3)).astype(np.float32)
    box = (np.eye(3) * L).astype(np.float32)
    kw = dict(sigma=0.3, epsilon=0.8, cutoff=0.9)

    def lj(pkg, u, topo):
        return pkg.LJPotential(topo.uniform(n), sigma=kw["sigma"] * u.nanometer,
                               epsilon=kw["epsilon"] * u.kilojoule_per_mole,
                               cutoff=kw["cutoff"] * u.nanometer)

    return pos, box, lj(jp, ju, JTopology), lj(tp, tu, TTopology)


@pytest.mark.parametrize("ensemble", ["nvt", "npt"])
def test_reduced_potential_matches_jax(lj_pair, ensemble):
    pos, box, jl, tl = lj_pair
    p = None if ensemble == "nvt" else 10.0
    jt = js.ThermodynamicState(potential=jl, temperature=250.0 * ju.kelvin,
                               pressure=None if p is None else p * ju.atmosphere)
    tt = ts.ThermodynamicState(potential=tl, temperature=250.0 * tu.kelvin,
                               pressure=None if p is None else p * tu.atmosphere)
    jss = js.SamplerState(positions=ju.Quantity(jnp.asarray(pos), ju.nanometer),
                          current_PRNG_key=jax.random.PRNGKey(0),
                          box_vectors=ju.Quantity(jnp.asarray(box), ju.nanometer))
    tss = _state(pos, box=box)
    jnl = jn.NeighborListNsqrd(jn.OrthogonalPeriodicSpace(),
                               cutoff=0.9 * ju.nanometer, n_max_neighbors=40)
    tnl = tn.NeighborListNsqrd(tn.OrthogonalPeriodicSpace(),
                               cutoff=0.9 * tu.nanometer, n_max_neighbors=40)
    jnl.build_from_state(jss)
    tnl.build_from_state(tss)
    u_j = jt.get_reduced_potential(jss, jnl)
    u_t = tt.get_reduced_potential(tss, tnl)
    assert _rel(u_t, u_j) < 1e-6
    fn = tt.make_reduced_potential_fn(tnl)
    assert _rel(fn(tss.positions, tss.box_vectors, tnl.state), u_t) < 1e-6


def test_reduced_potential_reference_values():
    """The JAX tests' closed forms: u = U / kT in NVT, beta (U + pV) in NpT."""
    ho = tp.HarmonicOscillatorPotential(
        TTopology.uniform(1), k=1.0 * tu.kilocalories_per_mole / tu.angstrom ** 2)
    t = ts.ThermodynamicState(potential=ho, temperature=300.0 * tu.kelvin)
    ss = _state(np.array([[0.1, 0.0, 0.0]], np.float32))
    U = 0.5 * 4.184 * 100 * 0.01
    assert float(t.get_reduced_potential(ss)) == \
        pytest.approx(U / 2.494338785, rel=1e-4)
    lj = tp.LJPotential(TTopology.uniform(2))
    tnpt = ts.ThermodynamicState(potential=lj, temperature=300.0 * tu.kelvin,
                                 pressure=1.0 * tu.bar)
    pos = np.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0]], np.float32)
    s2 = _state(pos, box=(np.eye(3) * 2.0).astype(np.float32))
    U = float(lj.compute_energy(torch.from_numpy(pos)))
    assert float(tnpt.get_reduced_potential(s2)) == pytest.approx(
        (U + 0.0602214076 * 8.0) / 2.494338785, rel=1e-4)


def test_reduced_potential_at_states_batched_matches_jax():
    """A homogeneous HO family (one vmap over the states) at three
    temperatures and two pressures."""
    def states(pkg_s, pkg_p, u, topo):
        out = []
        for k, t, p in ((50.0, 200.0, None), (100.0, 300.0, 1.0),
                        (400.0, 400.0, 5.0)):
            ho = pkg_p.HarmonicOscillatorPotential(
                topo.uniform(1), k=k * u.kilojoule_per_mole / u.nanometer ** 2)
            out.append(pkg_s.ThermodynamicState(
                potential=ho, temperature=t * u.kelvin,
                pressure=None if p is None else p * u.atmosphere))
        return out

    pos = np.array([[0.2, -0.1, 0.05]], np.float32)
    box = (np.eye(3) * 1.7).astype(np.float32)
    jss = js.SamplerState(positions=ju.Quantity(jnp.asarray(pos), ju.nanometer),
                          current_PRNG_key=jax.random.PRNGKey(0),
                          box_vectors=ju.Quantity(jnp.asarray(box), ju.nanometer))
    u_j = np.asarray(js.calculate_reduced_potential_at_states(
        jss, states(js, jp, ju, JTopology)))
    u_t = ts.calculate_reduced_potential_at_states(
        _state(pos, box=box), states(ts, tp, tu, TTopology))
    assert u_t.shape == (3,) and u_t.dtype == torch.float32
    np.testing.assert_allclose(u_t.numpy(), u_j, rtol=1e-6)


def test_reduced_potential_at_states_per_potential_matches_jax(lj_pair):
    """LJ states on a neighbor list: one energy per distinct potential."""
    pos, box, jl, tl = lj_pair
    jst = [js.ThermodynamicState(potential=jl, temperature=t * ju.kelvin)
           for t in (150.0, 300.0)]
    tst = [ts.ThermodynamicState(potential=tl, temperature=t * tu.kelvin)
           for t in (150.0, 300.0)]
    jss = js.SamplerState(positions=ju.Quantity(jnp.asarray(pos), ju.nanometer),
                          current_PRNG_key=jax.random.PRNGKey(0),
                          box_vectors=ju.Quantity(jnp.asarray(box), ju.nanometer))
    tss = _state(pos, box=box)
    jnl = jn.PairListNsqrd(jn.OrthogonalPeriodicSpace(), cutoff=0.9 * ju.nanometer)
    tnl = tn.PairListNsqrd(tn.OrthogonalPeriodicSpace(), cutoff=0.9 * tu.nanometer)
    jnl.build_from_state(jss)
    tnl.build_from_state(tss)
    u_j = np.asarray(js.calculate_reduced_potential_at_states(jss, jst, jnl))
    u_t = ts.calculate_reduced_potential_at_states(tss, tst, tnl)
    np.testing.assert_allclose(u_t.numpy(), u_j, rtol=1e-6)


def test_velocities_and_masses():
    top = TTopology.uniform(3000, 39.948)
    m = tutils.masses_md(top)
    assert m.shape == (3000, 1) and m.dtype == torch.float32
    v = tutils.initialize_velocities(300.0 * tu.kelvin, top, 5)
    vv = v.value_in_unit_system(tu.md_unit_system)
    assert vv.shape == (3000, 3) and vv.device.type == "cpu"
    T = 39.948 * float((vv.double() ** 2).sum()) / (3 * 3000 * tu.kB_MD)
    assert T == pytest.approx(300.0, rel=0.05)
    again = tutils.initialize_velocities_md(300.0, m, 5)
    assert torch.equal(again, vv)
    assert tutils.get_list_of_mass(top).value_in_unit(tu.amu)[0] == 39.948
    assert tutils.get_nr_of_particles(top) == 3000
    assert tutils.slice_array(torch.arange(12).reshape(3, 4), 1, 3).shape == (3, 2)


def test_data_file_path_resolves_the_repository_data():
    path = tutils.get_data_file_path("two_particles.pdb")
    assert path.endswith("chiron_tpu_torch/data/two_particles.pdb")
    with open(path) as f:
        assert f.read(6)
    with pytest.raises(ValueError):
        tutils.get_data_file_path("no_such_file.npy")


def test_interop_sampler_state():
    ss = interop.sampler_state(np.zeros((4, 3)), 11,
                               velocities=np.ones((4, 3)),
                               box_vectors=np.eye(3) * 2.0, device="cpu")
    assert ss.positions.dtype == torch.float32
    assert torch.equal(ss.velocities, torch.ones(4, 3))
    assert ss.current_PRNG_key == 11
    assert float(ss.as_data().volume) == pytest.approx(8.0)
