"""The port's spaces and pair schemes (``chiron_tpu_torch.space``,
``neighbors``) against the JAX package's on the same inputs, made with
numpy from a seed.

The integer structures (neighbor ids with their padding, masks, counts,
overflow, the all-pairs list and its reduction mask) and the rebuild
predicate must equal JAX's exactly; displacements and distances agree to
1e-6 nm (and are JAX's bit for bit: the floor-mod is computed as XLA does).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chiron_tpu.neighbors as jn
import chiron_tpu.units as ju
import chiron_tpu_torch.neighbors as tn
import chiron_tpu_torch.units as tu
from chiron_tpu_torch import interop

L = 3.0
BOX = np.eye(3, dtype=np.float32) * L


def _np(a):
    return np.asarray(a)


def _fluid(n, seed, length=L):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, length, size=(n, 3)).astype(np.float32)


SPACES = [(jn.OrthogonalPeriodicSpace, tn.OrthogonalPeriodicSpace),
          (jn.OrthogonalNonPeriodicSpace, tn.OrthogonalNonPeriodicSpace)]


@pytest.mark.parametrize("spaces", SPACES, ids=["periodic", "open"])
def test_displacement_and_wrap_match_jax(spaces):
    js, ts = spaces[0](), spaces[1]()
    rng = np.random.default_rng(11)
    # points inside, outside and on the box's edges and half-lengths
    a = rng.uniform(-2 * L, 3 * L, size=(64, 3)).astype(np.float32)
    b = rng.uniform(-2 * L, 3 * L, size=(64, 3)).astype(np.float32)
    a[:6] = np.array([0.0, L / 2, L, -L / 2, 1.5 * L, -0.0], np.float32)[:, None]
    b[:6] = 0.0
    jr, jd = js.displacement(jnp.asarray(a), jnp.asarray(b), jnp.asarray(BOX))
    tr, td = ts.displacement(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(BOX))
    np.testing.assert_allclose(tr.numpy(), _np(jr), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), _np(jd), atol=1e-6)
    jw = js.wrap(jnp.asarray(a), jnp.asarray(BOX))
    tw = ts.wrap(torch.from_numpy(a), torch.from_numpy(BOX))
    np.testing.assert_allclose(tw.numpy(), _np(jw), atol=1e-6)


def test_periodic_minimum_image_is_jax_floor_mod_bit_for_bit():
    """The floor-mod is fmod plus JAX's sign fix, so the image is XLA's to
    the bit, where ``torch.remainder`` rounds differently."""
    rng = np.random.default_rng(5)
    d = rng.uniform(-40.0, 40.0, size=(4096, 3)).astype(np.float32)
    box = np.diag(rng.uniform(0.7, 9.0, size=3)).astype(np.float32)
    jr, _ = jn.OrthogonalPeriodicSpace().displacement(
        jnp.asarray(d), jnp.zeros(3), jnp.asarray(box))
    tr, _ = tn.OrthogonalPeriodicSpace().displacement(
        torch.from_numpy(d), torch.zeros(3), torch.from_numpy(box))
    np.testing.assert_array_equal(tr.numpy(), _np(jr))


def test_space_reference_values_and_errors():
    space = tn.OrthogonalPeriodicSpace()
    box = torch.eye(3) * 10.0
    p1 = torch.tensor([[0.0, 0, 0], [0, 0, 0]])
    p2 = torch.tensor([[1.0, 0, 0], [6, 0, 0]])
    r_ij, dist = space.displacement(p1, p2, box)
    assert torch.equal(r_ij, torch.tensor([[-1.0, 0, 0], [4.0, 0, 0]]))
    assert torch.equal(dist, torch.tensor([1.0, 4.0]))
    assert torch.equal(space.wrap(torch.tensor([5.0, 12, -1]), box),
                       torch.tensor([5.0, 2, 9]))
    with pytest.raises(ValueError):
        space.displacement(p1, p2, None)
    assert tn.OrthogonalPeriodicSpace() == space
    assert tn.OrthogonalNonPeriodicSpace() != space
    assert len({space, tn.OrthogonalPeriodicSpace()}) == 1


def _build_both(pos, box, **kw):
    j = jn.NeighborListNsqrd(jn.OrthogonalPeriodicSpace(),
                             cutoff=kw["cutoff"] * ju.nanometer,
                             skin=kw["skin"] * ju.nanometer,
                             n_max_neighbors=kw["n_max"])
    t = tn.NeighborListNsqrd(tn.OrthogonalPeriodicSpace(),
                             cutoff=kw["cutoff"] * tu.nanometer,
                             skin=kw["skin"] * tu.nanometer,
                             n_max_neighbors=kw["n_max"])
    j.build(jnp.asarray(pos), None if box is None else jnp.asarray(box))
    t.build(torch.from_numpy(pos), None if box is None else torch.from_numpy(box))
    return j, t


NEIGHBOR_CASES = {
    # n, seed, cutoff, skin, capacity (8 regrows to max + 10)
    "dense": (150, 1, 1.02, 0.3, 200),
    "regrow": (150, 2, 1.02, 0.3, 8),
    "sparse": (60, 3, 0.4, 0.1, 12),
}


@pytest.mark.parametrize("case", sorted(NEIGHBOR_CASES))
def test_neighbor_list_structures_equal_jax_exactly(case):
    n, seed, cutoff, skin, n_max = NEIGHBOR_CASES[case]
    pos = _fluid(n, seed)
    j, t = _build_both(pos, BOX, cutoff=cutoff, skin=skin, n_max=n_max)
    assert t.n_max_neighbors == j.n_max_neighbors
    if case == "regrow":
        assert t.n_max_neighbors == int(_np(j.n_neighbors).max()) + 10
    for name in ("neighbor_list", "neighbor_mask", "n_neighbors"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      _np(getattr(j, name)), err_msg=name)
    assert t.neighbor_list.dtype == torch.int32
    assert bool(t.state.overflow) == bool(j.state.overflow) is False
    # an empty row (the last, always) is padded with 0
    assert int(t.n_neighbors[-1]) == 0
    assert not t.neighbor_list[-1].any()
    if case == "sparse":
        empty = (t.n_neighbors == 0).nonzero().flatten().tolist()
        assert len(empty) > 1  # rows other than the last are empty too
    tc = t.calculate(torch.from_numpy(pos))
    jc = j.calculate(jnp.asarray(pos))
    for k in (0, 1, 2):
        np.testing.assert_array_equal(tc[k].numpy(), _np(jc[k]))
    np.testing.assert_allclose(tc[3].numpy(), _np(jc[3]), atol=1e-6)
    np.testing.assert_allclose(tc[4].numpy(), _np(jc[4]), atol=1e-6)


def test_fill_rule_row_zero_empty_and_self_bump():
    """Row 0 with no neighbor is filled with 1 (0 bumped off itself); a row
    whose first neighbor is the next particle is filled with it."""
    pos = np.array([[0.0, 0, 0], [1.5, 1.5, 1.5], [1.6, 1.5, 1.5],
                    [2.6, 0.2, 0.2]], np.float32)
    j, t = _build_both(pos, BOX, cutoff=0.2, skin=0.05, n_max=4)
    np.testing.assert_array_equal(t.neighbor_list.numpy(), _np(j.neighbor_list))
    assert t.neighbor_list.tolist() == [[1] * 4, [2] * 4, [0] * 4, [0] * 4]
    assert t.n_neighbors.tolist() == [0, 1, 0, 0]


def test_overflow_flag_and_truncation_equal_jax():
    pos = _fluid(100, 4)
    jstate = jn.neighbor_build_fn(jnp.asarray(pos), jnp.asarray(BOX), 1.3,
                                  jn.OrthogonalPeriodicSpace(), 6)
    tstate = tn.neighbor_build_fn(torch.from_numpy(pos), torch.from_numpy(BOX),
                                  1.3, tn.OrthogonalPeriodicSpace(), 6)
    assert bool(tstate.overflow) == bool(jstate.overflow) is True
    for name in ("neighbor_list", "neighbor_mask", "n_neighbors"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      _np(getattr(jstate, name)), err_msg=name)


def test_rebuild_predicate_equals_jax():
    pos = _fluid(80, 6)
    j, t = _build_both(pos, BOX, cutoff=1.02, skin=0.3, n_max=100)
    rng = np.random.default_rng(7)
    for scale in (0.0, 0.05, 0.149, 0.151, 0.3):
        step = rng.normal(0, 1, size=pos.shape).astype(np.float32)
        step = scale * step / np.linalg.norm(step, axis=1, keepdims=True)
        moved = ((pos + step) % L).astype(np.float32)
        expect = j.check(jnp.asarray(moved))
        assert t.check(torch.from_numpy(moved)) is expect
        st = tn.neighbor_check_fn(t.state, torch.from_numpy(moved), 0.3,
                                  tn.OrthogonalPeriodicSpace())
        assert st.dtype == torch.bool and bool(st) is expect
    assert t.check(torch.zeros(3, 3)) is True  # N changed


def test_two_particle_neighbor_list_reference_values():
    t = tn.NeighborListNsqrd(tn.OrthogonalPeriodicSpace(),
                             cutoff=1.1 * tu.nanometer, skin=0.1 * tu.nanometer,
                             n_max_neighbors=5)
    x = torch.tensor([[0.0, 0, 0], [1.0, 0, 0]])
    t.build(x, torch.eye(3) * 10.0)
    assert t.neighbor_list.tolist() == [[1] * 5, [0] * 5]
    assert t.neighbor_mask.tolist() == [[1, 0, 0, 0, 0], [0] * 5]
    n, _, mask, dist, r_ij = t.calculate(x)
    assert n.tolist() == [1, 0]
    assert torch.equal(dist, torch.ones(2, 5))
    assert torch.equal(r_ij[0, 0], torch.tensor([-1.0, 0, 0]))
    assert t.check(x) is False and t.check(x + 0.1) is True


def test_neighbor_list_input_validation():
    space = tn.OrthogonalPeriodicSpace()
    nbr = tn.NeighborListNsqrd(space, cutoff=2.1 * tu.nanometer,
                               skin=0.1 * tu.nanometer, n_max_neighbors=5)
    x = torch.tensor([[1.0, 2, 3], [0.0, 0, 0]])
    with pytest.raises(TypeError):
        nbr.build_from_state(123)
    with pytest.raises(ValueError):
        nbr.build(x, None)  # a periodic space needs the box
    with pytest.raises(ValueError):
        nbr.build(x, torch.zeros(4, 3))
    with pytest.raises(ValueError):
        nbr.build(tu.Quantity(x, tu.picosecond), torch.eye(3))
    with pytest.raises(TypeError):
        tn.NeighborListNsqrd(123, cutoff=1.0 * tu.nanometer)
    with pytest.raises(ValueError):
        tn.NeighborListNsqrd(space, cutoff=tu.Quantity(1.0, tu.picosecond))
    with pytest.raises(TypeError, match="cutoff"):
        tn.NeighborListNsqrd(space, cutoff=1.2, skin=0.1 * tu.nanometer)
    with pytest.raises(TypeError, match="skin"):
        nbr.skin = 0.3
    with pytest.raises(ValueError, match="built"):
        tn.NeighborListNsqrd(space).state


@pytest.mark.parametrize("cutoff", [1.02, None, 0.5])
def test_pair_list_equals_jax(cutoff):
    pos = _fluid(70, 8)
    jc = None if cutoff is None else cutoff * ju.nanometer
    tc = None if cutoff is None else cutoff * tu.nanometer
    j = jn.PairListNsqrd(jn.OrthogonalPeriodicSpace(), cutoff=jc)
    t = tn.PairListNsqrd(tn.OrthogonalPeriodicSpace(), cutoff=tc)
    j.build(jnp.asarray(pos), jnp.asarray(BOX))
    t.build(torch.from_numpy(pos), torch.from_numpy(BOX))
    np.testing.assert_array_equal(t.all_pairs.numpy(), _np(j.all_pairs))
    np.testing.assert_array_equal(t.reduction_mask.numpy(),
                                  _np(j.reduction_mask))
    tcalc = t.calculate(torch.from_numpy(pos))
    jcalc = j.calculate(jnp.asarray(pos))
    for k in (0, 1, 2):
        np.testing.assert_array_equal(tcalc[k].numpy(), _np(jcalc[k]))
    np.testing.assert_allclose(tcalc[3].numpy(), _np(jcalc[3]), atol=1e-6)
    assert t.check(torch.from_numpy(pos)) is False
    with pytest.raises(ValueError):
        t.calculate(torch.zeros(5, 3))


def test_dense_pairs_equal_jax():
    pos = _fluid(50, 9)
    j = jn.DensePairs(jn.OrthogonalPeriodicSpace(), cutoff=1.02 * ju.nanometer)
    t = tn.DensePairs(tn.OrthogonalPeriodicSpace(), cutoff=1.02 * tu.nanometer)
    j.build(jnp.asarray(pos), jnp.asarray(BOX))
    t.build(torch.from_numpy(pos), torch.from_numpy(BOX))
    tcalc = t.calculate(torch.from_numpy(pos))
    jcalc = j.calculate(jnp.asarray(pos))
    for k in (0, 1, 2):
        np.testing.assert_array_equal(tcalc[k].numpy(), _np(jcalc[k]))
    np.testing.assert_allclose(tcalc[3].numpy(), _np(jcalc[3]), atol=1e-6)
    assert t.check(torch.from_numpy(pos)) is False
    with pytest.raises(TypeError):
        tn.DensePairs(tn.OrthogonalNonPeriodicSpace())
    with pytest.raises(ValueError):
        t.build(torch.from_numpy(pos), None)


def test_mesh_lists_and_schemes_agree():
    """The 8-particle mesh of the JAX package's test: every particle listed,
    a subset within the cutoff, and the two schemes' masked sums equal."""
    grid = np.mgrid[0:2, 0:2, 0:2].reshape(3, -1).T.astype(np.float32) * 1.0
    box = torch.eye(3) * 10.0
    nbr = tn.NeighborListNsqrd(tn.OrthogonalPeriodicSpace(),
                               cutoff=1.1 * tu.nanometer,
                               skin=1.1 * tu.nanometer, n_max_neighbors=5)
    nbr.build(torch.from_numpy(grid), box)
    assert nbr.n_neighbors.tolist() == [7, 6, 5, 4, 3, 2, 1, 0]
    assert tuple(nbr.neighbor_list.shape) == (8, 17)
    n_int, _, _, _, _ = nbr.calculate(torch.from_numpy(grid))
    assert n_int.tolist() == [3, 2, 2, 1, 2, 1, 1, 0]
    pl = tn.PairListNsqrd(tn.OrthogonalPeriodicSpace(), cutoff=1.1 * tu.nanometer)
    pl.build(torch.from_numpy(grid), box)
    _, _, m1, d1, _ = nbr.calculate(torch.from_numpy(grid))
    _, _, m2, d2, _ = pl.calculate(torch.from_numpy(grid))
    assert float(torch.where(m1 > 0, d1, 0).sum()) == pytest.approx(
        float(torch.where(m2 > 0, d2, 0).sum()), rel=1e-6)


def test_interop_carries_the_jax_list_states():
    pos = _fluid(40, 10)
    j, _ = _build_both(pos, BOX, cutoff=1.02, skin=0.3, n_max=50)
    s = j.state
    t = interop.neighbor_list_state(
        _np(s.neighbor_list), _np(s.neighbor_mask), _np(s.n_neighbors),
        _np(s.ref_positions), _np(s.box_vectors), _np(s.overflow), "cpu")
    out = tn.neighbor_calculate_fn(t, torch.from_numpy(pos), 1.02,
                                   tn.OrthogonalPeriodicSpace())
    ref = jn.neighbor_calculate_fn(s, jnp.asarray(pos), 1.02,
                                   jn.OrthogonalPeriodicSpace())
    np.testing.assert_array_equal(out[1].numpy(), _np(ref[1]))
    pj = jn.pairlist_build_fn(jnp.asarray(pos), jnp.asarray(BOX))
    pt = interop.pair_list_state(_np(pj.all_pairs), _np(pj.reduction_mask),
                                 _np(pj.box_vectors), "cpu")
    assert torch.equal(pt.all_pairs, tn.pairlist_build_fn(
        torch.from_numpy(pos), None).all_pairs)
    d = interop.dense_pairs_state(BOX, "cpu")
    assert d.box_vectors.dtype == torch.float32
