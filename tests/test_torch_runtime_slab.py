"""The culled runner's (x-slab, y) sort regime, port (plain versions on the
CPU) against the JAX runner in interpret mode: LJ fluid N=1000 at rho*=0.8,
tiles 8 x 16, segments of 4 steps, slack 0.15, exact forces,
``sort_mode="slab"``.  The bench size resolves to the pure-x key, which
tests/test_torch_runtime.py covers; this file drives the slab branch of the
layout init and the slab key inside the segment."""

import numpy as np
import pytest

import chiron_tpu.runtime as jrt
import chiron_tpu.testsystems as jts
import chiron_tpu.units as ju
import chiron_tpu_torch.runtime as trt
import chiron_tpu_torch.testsystems as tts
import chiron_tpu_torch.units as tu
from chiron_tpu_torch import interop

N = 1000
CULL = dict(tm=8, tn=16, slack=0.15, segment_steps=4, exact_forces=True)
SEED = 11


def _np(a):
    return np.array(a)


def _common(ts, units):
    fluid = ts.LennardJonesFluid(nparticles=N, reduced_density=0.8)
    md = units.md_unit_system
    kw = dict(potential=fluid.potential, n_particles=N,
              topology=fluid.topology, temperature=120.0 * units.kelvin,
              timestep=2.0 * units.femtoseconds, **CULL)
    return kw, fluid.positions.value_in_unit_system(md), \
        fluid.box_vectors.value_in_unit_system(md)


@pytest.fixture(scope="module")
def slab():
    jkw, jpos, jbox = _common(jts, ju)
    jr = jrt.make_culled_lj_runner(sort_mode="slab", **jkw)
    js0 = jr.init(jpos, jbox, seed=SEED)
    js4 = jr.run(js0, 4)
    tkw, tpos, tbox = _common(tts, tu)
    tr = trt.make_culled_lj_runner(sort_mode="slab", device="cpu", **tkw)
    ts0 = tr.init(tpos, tbox, seed=SEED)
    return dict(jr=jr, js0=js0, js4=js4, tr=tr, ts0=ts0, tkw=tkw,
                tpos=tpos, tbox=tbox)


def test_slab_init_layout_and_list_equal(slab):
    jr, js0, tr, ts0 = slab["jr"], slab["js0"], slab["tr"], slab["ts0"]
    assert tr.nslab > 0
    assert (tr.nslab, tr.capacity) == (jr.nslab, jr.capacity)
    np.testing.assert_array_equal(ts0.x.numpy(), _np(js0.x))
    for name in ("rows", "cols", "ccx", "ptr2", "rowcx", "count"):
        np.testing.assert_array_equal(getattr(ts0.pairs, name).numpy(),
                                      _np(getattr(js0.pairs, name)),
                                      err_msg=name)
    assert bool(ts0.overflowed) == bool(js0.overflowed) is False


def test_slab_segment_from_carried_state_matches_jax(slab):
    js0, js4, tr = slab["js0"], slab["js4"], slab["tr"]
    pairs = {k: _np(v) for k, v in js0.pairs._asdict().items()}
    ts = interop.cull_carry(
        _np(js0.x), _np(js0.v), _np(js0.F), _np(js0.step), _np(js0.box_diag),
        _np(js0.overflowed), pairs, _np(js0.x_anchor), "cpu")
    ts4 = tr.run(ts, 4)
    assert np.abs(ts4.x.numpy() - _np(js4.x)).max() < 1e-4
    assert np.abs(ts4.v.numpy() - _np(js4.v)).max() < 1e-3
    for name in ("rows", "cols", "ptr2", "count"):
        np.testing.assert_array_equal(getattr(ts4.pairs, name).numpy(),
                                      _np(getattr(js4.pairs, name)),
                                      err_msg=name)
    assert bool(ts4.overflowed) == bool(js4.overflowed) is False
    tr.check(ts4)
    e_ref = float(slab["jr"].energy(js4))
    assert abs(float(tr.energy(ts4)) - e_ref) / abs(e_ref) < 1e-5


@pytest.mark.parametrize("mode, nslab", [("auto", 0), ("x", 0)])
def test_pure_x_modes_resolve_to_no_slabs(slab, mode, nslab):
    tr = trt.make_culled_lj_runner(sort_mode=mode, device="cpu", **slab["tkw"])
    tr.init(slab["tpos"], slab["tbox"], seed=SEED)
    assert tr.nslab == nslab


def test_unknown_sort_mode_raises(slab):
    with pytest.raises(ValueError, match="sort_mode"):
        trt.make_culled_lj_runner(sort_mode="y", device="cpu", **slab["tkw"])
