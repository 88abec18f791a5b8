"""The port's potentials (``chiron_tpu_torch.potential``) against the JAX
package's on the same inputs, on every pair scheme: energies and forces to
1e-5 relative (forces relative to the largest), the stacked-parameter
helpers to 1e-6, and the committed OpenMM-fixture goldens on all three
schemes to 1e-6, as ``tests/test_goldens.py`` holds the JAX package.  JAX's
``DensePairs`` runs its Pallas kernel in interpret mode; the port's runs
K1's plain version on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chiron_tpu.neighbors as jn
import chiron_tpu.potential as jp
import chiron_tpu.testsystems as jts
import chiron_tpu.units as ju
import chiron_tpu_torch.neighbors as tn
import chiron_tpu_torch.potential as tp
import chiron_tpu_torch.testsystems as tts
import chiron_tpu_torch.units as tu
from chiron_tpu.topology import Topology as JTopology
from chiron_tpu_torch.topology import Topology as TTopology

SIGMA = 0.34
EPS_KCAL = 0.238
CUT = 3.0 * SIGMA
N = 125


def _np(a):
    return np.asarray(a)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _lj(pkg_units, topology_cls, n):
    pot_mod = jp if pkg_units is ju else tp
    return pot_mod.LJPotential(
        topology_cls.uniform(n, 39.948), sigma=SIGMA * pkg_units.nanometer,
        epsilon=EPS_KCAL * pkg_units.kilocalories_per_mole,
        cutoff=CUT * pkg_units.nanometer)


@pytest.fixture(scope="module")
def fluid():
    """A jittered N=125 lattice at rho* = 0.4 (no overlaps)."""
    f = tts.LennardJonesFluid(nparticles=N, reduced_density=0.4)
    md = tu.md_unit_system
    pos = f.positions.value_in_unit_system(md)
    box = f.box_vectors.value_in_unit_system(md)
    rng = np.random.default_rng(3)
    pos = ((pos + rng.normal(0, 0.03, pos.shape)) % box[0, 0]).astype(np.float32)
    return pos, box.astype(np.float32)


def _schemes(pkg):
    """The three pair schemes of one package, unbuilt."""
    u = ju if pkg is jn else tu
    space = pkg.OrthogonalPeriodicSpace()
    return {
        "neighbor": pkg.NeighborListNsqrd(space, cutoff=CUT * u.nanometer,
                                          skin=0.3 * u.nanometer,
                                          n_max_neighbors=80),
        "pairlist": pkg.PairListNsqrd(space, cutoff=CUT * u.nanometer),
        "dense": pkg.DensePairs(space, cutoff=CUT * u.nanometer),
    }


@pytest.fixture(scope="module")
def lj_both(fluid):
    pos, box = fluid
    out = {}
    for name in ("neighbor", "pairlist", "dense"):
        j, t = _schemes(jn)[name], _schemes(tn)[name]
        j.build(jnp.asarray(pos), jnp.asarray(box))
        t.build(torch.from_numpy(pos), torch.from_numpy(box))
        jl, tl = _lj(ju, JTopology, N), _lj(tu, TTopology, N)
        out[name] = (jl, j, tl, t)
    return out


@pytest.mark.parametrize("scheme", ["neighbor", "pairlist", "dense"])
def test_lj_energy_and_force_match_jax(lj_both, fluid, scheme):
    pos, _ = fluid
    jl, j, tl, t = lj_both[scheme]
    x = torch.from_numpy(pos)
    e_j = jl.compute_energy(jnp.asarray(pos), j)
    e_t = tl.compute_energy(x, t)
    assert _rel(e_t, e_j) < 1e-5
    F_j = _np(jl.compute_force(jnp.asarray(pos), j))
    F_t = tl.compute_force(x, t).numpy()
    assert np.abs(F_t - F_j).max() / np.abs(F_j).max() < 1e-5
    # the closure on the list's state gives the same energy
    e_fn = tl.make_energy_fn(t)(x, t.state)
    assert _rel(e_fn, e_t) < 1e-6


def test_lj_open_space_energy_force_and_analytic_force_match_jax():
    pos = np.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.2, 0.45, 0.1],
                    [0.9, 0.7, 0.3]], np.float32)
    jl, tl = _lj(ju, JTopology, 4), _lj(tu, TTopology, 4)
    x = torch.from_numpy(pos)
    assert _rel(tl.compute_energy(x), jl.compute_energy(jnp.asarray(pos))) < 1e-5
    F_j = _np(jl.compute_force(jnp.asarray(pos)))
    for F_t in (tl.compute_force(x), tl.compute_force_analytical(x)):
        assert np.abs(F_t.numpy() - F_j).max() / np.abs(F_j).max() < 1e-5
    # the jittable open-space closure agrees with the debug pair list
    assert _rel(tl.make_energy_fn(None)(x), tl.compute_energy(x)) < 1e-6


def test_dense_pairs_gradient_is_exactly_minus_k1_force(lj_both, fluid):
    pos, box = fluid
    _, _, tl, t = lj_both["dense"]
    x = torch.from_numpy(pos)
    op = tl._dense_op(t, x.device)
    F_k1, E_k1 = op.force_energy(x, torch.from_numpy(box))
    assert torch.equal(tl.compute_force(x, t), F_k1)
    assert torch.equal(tl.compute_energy(x, t), E_k1)
    assert op.n_pad == 128  # JAX's tile rule: 128 below N = 2048
    assert op is tl._dense_op(t, x.device)  # built once a (N, device)


@pytest.mark.parametrize("scheme", ["neighbor", "pairlist", "dense"])
def test_cutoff_mismatch_and_unbuilt_list_raise(scheme, fluid):
    pos, box = fluid
    x = torch.from_numpy(pos)
    lj = _lj(tu, TTopology, N)
    space = tn.OrthogonalPeriodicSpace()
    other = {"neighbor": lambda c: tn.NeighborListNsqrd(space, cutoff=c,
                                                        n_max_neighbors=80),
             "pairlist": lambda c: tn.PairListNsqrd(space, cutoff=c),
             "dense": lambda c: tn.DensePairs(space, cutoff=c)}[scheme]
    unbuilt = other(CUT * tu.nanometer)
    with pytest.raises(ValueError, match="built"):
        lj.compute_energy(x, unbuilt)
    wrong = other(1.2 * tu.nanometer)
    wrong.build(x, torch.from_numpy(box))
    with pytest.raises(ValueError, match="cutoff"):
        lj.compute_energy(x, wrong)


def test_lj_validation():
    top = TTopology.uniform(2)
    for kw in ({"sigma": 0.34}, {"epsilon": 1.0}, {"cutoff": 1.0}):
        with pytest.raises(TypeError):
            tp.LJPotential(top, **kw)
    for kw in ({"sigma": 1.0 * tu.kelvin}, {"epsilon": 1.0 * tu.kelvin},
               {"cutoff": 1.0 * tu.kelvin}):
        with pytest.raises(ValueError):
            tp.LJPotential(top, **kw)
    with pytest.raises(TypeError):
        tp.LJPotential(topology=123)


def test_harmonic_oscillator_matches_jax():
    k = 100.0
    x0 = np.array([[0.1, -0.2, 0.3], [0.0, 0.5, 0.0]], np.float32)
    jh = jp.HarmonicOscillatorPotential(
        JTopology.uniform(2), k=k * ju.kilojoule_per_mole / ju.nanometer ** 2,
        x0=ju.Quantity(jnp.asarray(x0), ju.nanometer),
        U0=1.5 * ju.kilojoule_per_mole)
    th = tp.HarmonicOscillatorPotential(
        TTopology.uniform(2), k=k * tu.kilojoule_per_mole / tu.nanometer ** 2,
        x0=tu.Quantity(x0, tu.nanometer), U0=1.5 * tu.kilojoule_per_mole)
    pos = np.array([[0.4, 0.1, -0.2], [0.3, 0.2, 0.1]], np.float32)
    assert _rel(th.compute_energy(torch.from_numpy(pos)),
                jh.compute_energy(jnp.asarray(pos))) < 1e-6
    np.testing.assert_allclose(th.compute_force(torch.from_numpy(pos)).numpy(),
                               _np(jh.compute_force(jnp.asarray(pos))),
                               rtol=1e-5, atol=1e-5)
    # the reference's own values: U = 0.5 * 100 * 0.09 + 1 = 5.5
    one = tp.HarmonicOscillatorPotential(
        TTopology.uniform(1), k=k * tu.kilojoule_per_mole / tu.nanometer ** 2,
        U0=1.0 * tu.kilojoule_per_mole)
    p = torch.tensor([[0.3, 0.0, 0.0]])
    assert float(one.compute_energy(p)) == pytest.approx(5.5, rel=1e-6)
    assert torch.allclose(one.compute_force(p), torch.tensor([[-30.0, 0, 0]]),
                          atol=1e-4)
    assert th.cache_token() == th.cache_token()
    with pytest.raises(TypeError):
        tp.HarmonicOscillatorPotential(TTopology.uniform(1), k=1.0)
    with pytest.raises(ValueError):
        tp.HarmonicOscillatorPotential(TTopology.uniform(1), k=1.0 * tu.kelvin)
    with pytest.raises(ValueError):
        tp.HarmonicOscillatorPotential(TTopology.uniform(1),
                                       U0=1.0 * tu.nanometer)


@pytest.mark.parametrize("scheme", [None, "neighbor", "pairlist", "dense"])
def test_harmonic_and_ideal_gas_closures_on_each_scheme_match_jax(lj_both, fluid,
                                                                 scheme):
    """HO and ideal-gas energies and forces through ``make_energy_fn(pairs)``
    (the schemes carry no information these potentials use)."""
    pos, _ = fluid
    j, t = (None, None) if scheme is None else lj_both[scheme][1::2]
    x0 = np.full((N, 3), 1.5, np.float32)
    jh = jp.HarmonicOscillatorPotential(
        JTopology.uniform(N), k=50.0 * ju.kilojoule_per_mole / ju.nanometer ** 2,
        x0=ju.Quantity(jnp.asarray(x0), ju.nanometer))
    th = tp.HarmonicOscillatorPotential(
        TTopology.uniform(N), k=50.0 * tu.kilojoule_per_mole / tu.nanometer ** 2,
        x0=tu.Quantity(x0, tu.nanometer))
    x = torch.from_numpy(pos)
    for jpot, tpot in ((jh, th), (jp.IdealGasPotential(None),
                                  tp.IdealGasPotential(None))):
        jfn, tfn = jpot.make_energy_fn(j), tpot.make_energy_fn(t)
        e_j = float(jfn(jnp.asarray(pos), None))
        e_t = float(tfn(x, None))
        assert e_t == pytest.approx(e_j, rel=1e-5, abs=1e-6)
        F_j = _np(jax.grad(lambda p: -jfn(p, None))(jnp.asarray(pos)))
        F_t = tp.value_and_grad(lambda p: tfn(p, None), x)[1].neg().numpy()
        np.testing.assert_allclose(F_t, F_j, rtol=1e-5, atol=1e-5)


def test_ideal_gas_matches_jax():
    ig = tp.IdealGasPotential(TTopology.uniform(10))
    x = torch.zeros(10, 3)
    assert ig.compute_energy(x) == 0.0 == jp.IdealGasPotential(None).compute_energy(0)
    assert ig.compute_force(x) == 0.0
    e = ig.make_energy_fn()(x)
    assert e.dtype == torch.float32 and float(e) == 0.0
    with pytest.raises(TypeError):
        tp.IdealGasPotential(topology=123)


def _ho_ladder(pkg, units, topo, ks, x0s, u0s):
    return [pkg.HarmonicOscillatorPotential(
        topo.uniform(1), k=k * units.kilojoule_per_mole / units.nanometer ** 2,
        x0=units.Quantity(np.array([x0], np.float32), units.nanometer),
        U0=u0 * units.kilojoule_per_mole) for k, x0, u0 in zip(ks, x0s, u0s)]


def test_stack_homogeneous_params_matches_jax():
    ks, x0s, u0s = (50.0, 100.0, 400.0), ([0, 0, 0], [0.1, 0, 0], [0, 0.2, 0.1]), \
        (0.0, 1.0, -2.0)
    jf, jparams = jp.stack_homogeneous_params(_ho_ladder(jp, ju, JTopology, ks, x0s, u0s))
    tf, tparams = tp.stack_homogeneous_params(_ho_ladder(tp, tu, TTopology, ks, x0s, u0s))
    pos = np.array([[0.3, -0.1, 0.2]], np.float32)
    e_j = _np(jax.vmap(lambda p: jf(p, jnp.asarray(pos)))(jparams))
    e_t = torch.func.vmap(lambda p: tf(p, torch.from_numpy(pos)))(tparams)
    np.testing.assert_allclose(e_t.numpy(), e_j, rtol=1e-6)
    # the ideal gas stacks to zeros; a mixed ladder does not stack
    ig, igp = tp.stack_homogeneous_params([tp.IdealGasPotential(None)] * 3)
    assert torch.func.vmap(lambda p: ig(p, torch.from_numpy(pos)))(igp).tolist() \
        == [0.0, 0.0, 0.0]
    assert tp.stack_homogeneous_params(
        [tp.IdealGasPotential(None), _lj(tu, TTopology, 1)]) is None


def test_stack_registered_params_matches_jax():
    """A mixed ladder (HO, LJ, ideal gas, LJ) with a box: each state's
    energy through the batched select equals JAX's switch."""
    rng = np.random.default_rng(4)
    n = 12
    pos = rng.uniform(0, 1.6, size=(n, 3)).astype(np.float32)
    box = np.array([1.6, 1.6, 1.6], np.float32)

    def ladder(pkg, units, topo):
        ho = pkg.HarmonicOscillatorPotential(
            topo.uniform(n), k=80.0 * units.kilojoule_per_mole / units.nanometer ** 2,
            x0=units.Quantity(np.full((n, 3), 0.8, np.float32), units.nanometer))
        lj1 = pkg.LJPotential(topo.uniform(n), sigma=0.3 * units.nanometer,
                              epsilon=0.9 * units.kilojoule_per_mole,
                              cutoff=0.7 * units.nanometer)
        lj2 = pkg.LJPotential(topo.uniform(n), sigma=0.32 * units.nanometer,
                              epsilon=1.1 * units.kilojoule_per_mole,
                              cutoff=0.7 * units.nanometer)
        return [ho, lj1, pkg.IdealGasPotential(None), lj2]

    jf, jparams = jp.stack_registered_params(ladder(jp, ju, JTopology), box)
    tf, tparams = tp.stack_registered_params(ladder(tp, tu, TTopology), box)
    assert tf.kind_list == jf.kind_list == [0, 1, 2, 1]
    np.testing.assert_array_equal(tparams[0].numpy(), _np(jparams[0]))
    e_j = _np(jax.vmap(lambda p: jf(p, jnp.asarray(pos)))(jparams))
    e_t = torch.func.vmap(lambda p: tf(p, torch.from_numpy(pos)))(tparams)
    np.testing.assert_allclose(e_t.numpy(), e_j, rtol=1e-6, atol=1e-6)
    # one state alone, outside vmap
    one_j = jax.tree_util.tree_map(lambda a: a[1], jparams)
    one_t = torch.utils._pytree.tree_map(lambda a: a[1], tparams)
    assert _rel(tf(one_t, torch.from_numpy(pos)),
                jf(one_j, jnp.asarray(pos))) < 1e-6

    class Unregistered:
        pass

    assert tp.stack_registered_params([Unregistered()]) is None


def test_register_potential_kind_takes_a_user_kind():
    class Well:
        def __init__(self, k):
            self.k = k

    tp.register_potential_kind(
        Well, params_of=lambda p: {"k": p.k},
        energy_fn=lambda prm, x, box: 0.5 * prm["k"] * torch.sum(x * x))
    try:
        f, params = tp.stack_registered_params([Well(1.0), Well(3.0)])
        x = torch.ones(2, 3)
        assert torch.func.vmap(lambda p: f(p, x))(params).tolist() == [3.0, 9.0]
    finally:
        del tp._POTENTIAL_KINDS[Well]


with open(os.path.join(os.path.dirname(__file__), "data",
                       "openmm_goldens.json")) as _f:
    _GOLDENS = {float(k): v for k, v in json.load(_f)["lj_fixture"][
        "energies_kj_per_mole"].items()}


@pytest.mark.parametrize("rho", sorted(_GOLDENS))
def test_lj_fixture_goldens_on_all_three_schemes(rho):
    """The committed f64 goldens of the 1000-particle fixture, on the port's
    three schemes, at ``tests/test_goldens.py``'s tolerance."""
    from chiron_tpu_torch.states import SamplerState

    E0 = _GOLDENS[rho]
    f = tts.LennardJonesFluid(nparticles=1000, reduced_density=rho)
    ss = SamplerState(positions=f.positions, current_PRNG_key=1234,
                      box_vectors=f.box_vectors, device="cpu")
    space = tn.OrthogonalPeriodicSpace()
    for pairs in (tn.NeighborListNsqrd(space, cutoff=f.cutoff,
                                       skin=0.5 * tu.nanometer,
                                       n_max_neighbors=180),
                  tn.PairListNsqrd(space, cutoff=f.cutoff),
                  tn.DensePairs(space, cutoff=f.cutoff)):
        pairs.build_from_state(ss)
        E = float(f.potential.compute_energy(ss.positions, pairs))
        assert E == pytest.approx(E0, rel=1e-6, abs=30e-6), (type(pairs), E, E0)


def test_test_systems_match_jax():
    jho, tho = jts.HarmonicOscillator(), tts.HarmonicOscillator()
    T = 300.0
    assert tho.reduced_free_energy(T * tu.kelvin) == pytest.approx(
        jho.reduced_free_energy(T * ju.kelvin), rel=1e-12)
    assert tho.expectation_potential_energy(T * tu.kelvin) == pytest.approx(
        jho.expectation_potential_energy(T * ju.kelvin), rel=1e-12)
    jig, tig = jts.IdealGas(nparticles=64), tts.IdealGas(nparticles=64)
    md = tu.md_unit_system
    np.testing.assert_array_equal(
        tig.positions.value_in_unit_system(md),
        _np(jig.positions.value_in_unit_system(ju.md_unit_system)))
    np.testing.assert_array_equal(
        tig.box_vectors.value_in_unit_system(md),
        _np(jig.box_vectors.value_in_unit_system(ju.md_unit_system)))
    assert isinstance(tig.potential, tp.IdealGasPotential)
