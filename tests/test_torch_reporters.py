"""The port's files against the JAX package's: reporters (HDF5 datasets, DCD
and XTC bytes), the native XTC codec, structure I/O, the run configuration,
checkpoints (the ``.npz`` layout both ways, a sampler checkpoint written by
JAX loaded into the port) and restarts, and the profiling helpers.

Each writer of the port is fed the same data as its JAX twin -- the port's
as tensors where the integrator reports tensors -- and the files must be
equal: the datasets' values and dtypes exactly, the trajectory files byte
for byte.  Restarts of the port must continue bit for bit.  Mirrors
``tests/test_reporters.py``, ``test_io.py``, ``test_native_xtc.py`` and
``test_restart.py``.
"""

import json
import os
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chiron_tpu.checkpoint as jck
import chiron_tpu.config as jcfg
import chiron_tpu.io as jio
import chiron_tpu.mcmc as jm
import chiron_tpu.reporters as jr
import chiron_tpu.states as js
import chiron_tpu.units as ju
import chiron_tpu_torch.checkpoint as tck
import chiron_tpu_torch.config as tcfg
import chiron_tpu_torch.io as tio
import chiron_tpu_torch.mcmc as tm
import chiron_tpu_torch.profiling as tprof
import chiron_tpu_torch.reporters as tr
import chiron_tpu_torch.states as ts
import chiron_tpu_torch.units as tu
from chiron_tpu.native.xtc_io import XTCWriter as JXTCWriter
from chiron_tpu.topology import Topology as JTopology
from chiron_tpu_torch import interop
from chiron_tpu_torch.integrators import LangevinIntegrator
from chiron_tpu_torch.native import has_native_xtc
from chiron_tpu_torch.native.xtc_io import XTCWriter, read_xtc
from chiron_tpu_torch.testsystems import HarmonicOscillator, LennardJonesFluid
from chiron_tpu_torch.topology import Topology
from chiron_tpu_torch.utils import PRNG, get_data_file_path


def _datasets(path):
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f}


def _assert_same_datasets(a, b):
    da, db = _datasets(a), _datasets(b)
    assert sorted(da) == sorted(db)
    for k in da:
        assert da[k].dtype == db[k].dtype, k
        assert np.array_equal(da[k], db[k]), k


def _both_dirs(tmp_path):
    jd, td = tmp_path / "jax", tmp_path / "port"
    jr.BaseReporter.set_directory(str(jd))
    tr.BaseReporter.set_directory(str(td))
    return jd, td


# ---------------------------------------------------------------------------
# Reporters: the same files as JAX's
# ---------------------------------------------------------------------------


def test_buffered_hdf5_datasets_equal_jax(tmp_path):
    jd, td = _both_dirs(tmp_path)
    jrep = jr.MCReporter(buffer_size=3)
    trep = tr.MCReporter(buffer_size=3)
    assert trep.log_file_path.name == "mc_reporter.h5"
    for i in range(10):
        d = {"step": i, "potential_energy": 0.5 * i, "volume": 8.0 + i,
             "acceptance_probability": i / 10}
        jrep.report(d)
        trep.report(d)
    jrep.flush_buffer()
    trep.flush_buffer()
    _assert_same_datasets(jrep.log_file_path, trep.log_file_path)
    assert np.allclose(trep.get_property("volume"), 8.0 + np.arange(10))
    assert set(trep.get_available_keys()) == {
        "step", "potential_energy", "volume", "acceptance_probability"}


def test_buffer_vs_flushed_reads(tmp_path):
    tr.BaseReporter.set_directory(str(tmp_path))
    rep = tr._SimulationReporter("test_buffer", buffer_size=100)
    rep.report({"x": torch.tensor(1.0)})
    rep.report({"x": 2.0})
    assert np.allclose(rep.get_property("x"), [1.0, 2.0])
    assert rep.get_property("missing") is None


def _frames(n_frames, n_atoms, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 3.0, (n_frames, n_atoms, 3)).astype(np.float32)


@pytest.mark.skipif(not has_native_xtc(), reason="no C compiler for the codec")
def test_langevin_reporter_files_equal_jax(tmp_path):
    """The integrator's report (tensors, in the port) gives the same .h5,
    the same .dcd and the same .xtc bytes as JAX's."""
    jd, td = _both_dirs(tmp_path)
    jrep = jr.LangevinDynamicsReporter("lang", buffer_size=2)
    trep = tr.LangevinDynamicsReporter("lang", buffer_size=2)
    box = (np.eye(3) * 3.0).astype(np.float32)
    for i, f in enumerate(_frames(5, 7)):
        jrep.report({"positions": jnp.asarray(f), "box_vectors": jnp.asarray(box),
                     "potential_energy": jnp.float32(0.25 * i), "step": i,
                     "iteration": 0, "elapsed_step": i})
        trep.report({"positions": torch.tensor(f), "box_vectors": torch.tensor(box),
                     "potential_energy": torch.tensor(0.25 * i), "step": i,
                     "iteration": 0, "elapsed_step": i})
    jrep.flush_buffer()
    trep.flush_buffer()
    _assert_same_datasets(jrep.log_file_path, trep.log_file_path)
    for ext in ("dcd", "xtc"):
        a, b = (jd / f"lang.{ext}").read_bytes(), (td / f"lang.{ext}").read_bytes()
        assert len(a) > 0 and a == b, ext
    xyz = trep.read_from_trajectory()
    assert xyz.shape == (5, 7, 3)
    np.testing.assert_allclose(xyz, _frames(5, 7), atol=1e-6)
    pos, boxes, _, _ = read_xtc(str(td / "lang.xtc"))
    assert np.abs(pos - _frames(5, 7)).max() < 0.5e-3 * 1.05
    np.testing.assert_allclose(boxes[0], box)


def test_multistate_reporter_files_equal_jax(tmp_path):
    """The per-replica fan-out: the same u_kn datasets and replica DCD bytes,
    and every iteration's frames reach the replica files at the one final
    flush."""
    jd, td = _both_dirs(tmp_path)
    jrep, trep = jr.MultistateReporter(buffer_size=10), tr.MultistateReporter(buffer_size=10)
    rng = np.random.default_rng(1)
    for t in range(3):
        d = {"positions": rng.normal(size=(2, 4, 3)),
             "box_vectors": np.stack([np.eye(3) * 4.0] * 2),
             "u_kn": rng.normal(size=(2, 2)), "state_index": np.arange(2),
             "step": np.asarray(t)}
        jrep.report(d)
        trep.report(d)
    jrep.flush_buffer()
    trep.flush_buffer()
    _assert_same_datasets(jrep.log_file_path, trep.log_file_path)
    assert trep.get_property("u_kn").shape == (3, 2, 2)
    for r in range(2):
        a = (jd / f"replica_{r}.dcd").read_bytes()
        assert a == (td / f"replica_{r}.dcd").read_bytes()
        assert tr.read_dcd(str(td / f"replica_{r}.dcd")).shape[0] == 3


def test_dcd_writer_bytes_equal_jax(tmp_path):
    frames = _frames(5, 10)
    for pkg, name in ((jr, "j.dcd"), (tr, "t.dcd")):
        w = pkg.DCDWriter(str(tmp_path / name), n_atoms=10, with_unitcell=True)
        for f in frames:
            w.write(f, box_lengths=np.array([20.0, 20.0, 20.0]))
        w.close()
    assert (tmp_path / "j.dcd").read_bytes() == (tmp_path / "t.dcd").read_bytes()
    back = tr.read_dcd(str(tmp_path / "t.dcd"))
    assert back.shape == (5, 10, 3) and np.allclose(back, frames, atol=1e-6)


def test_langevin_positions_readable_before_first_flush(tmp_path):
    tr.BaseReporter.set_directory(str(tmp_path))
    rep = tr.LangevinDynamicsReporter("preflush", buffer_size=100)
    frames = _frames(3, 5, seed=2)
    for i, f in enumerate(frames):
        rep.report({"positions": torch.tensor(f), "potential_energy": float(i),
                    "step": i})
    np.testing.assert_allclose(rep.get_property("positions"), frames, rtol=1e-6)
    rep.flush_buffer()
    rep.report({"positions": frames[0], "potential_energy": 9.0, "step": 3})
    assert rep.get_property("positions").shape == (4, 5, 3)


# ---------------------------------------------------------------------------
# The native XTC codec
# ---------------------------------------------------------------------------

pytestmark_xtc = pytest.mark.skipif(not has_native_xtc(),
                                    reason="no C compiler for the codec")


@pytestmark_xtc
def test_xtc_source_is_the_jax_packages_and_builds_under_the_port():
    import chiron_tpu_torch.native as tnat

    here = os.path.dirname(os.path.abspath(tnat.__file__))
    jsrc = os.path.join(os.path.dirname(here), "..", "chiron_tpu", "native", "xtc.c")
    assert open(os.path.join(here, "xtc.c"), "rb").read() == open(jsrc, "rb").read()
    assert any(p.suffix == ".so" for p in tnat.BUILD_DIR.iterdir())


@pytestmark_xtc
@pytest.mark.parametrize("n, precision", [(4, 1000.0), (1000, 1000.0),
                                          (517, 100.0)])
def test_xtc_bytes_equal_jax_and_roundtrip(tmp_path, n, precision):
    """The port's writer gives JAX's bytes (the uncompressed branch at
    n <= 9 too); its reader recovers the frames to half a grid cell, and
    the spec oracle decodes them."""
    import xtc_spec_oracle as oracle

    frames = _frames(4, n, seed=n)
    box = np.eye(3, dtype=np.float32) * 3.0
    for cls, name in ((JXTCWriter, "j.xtc"), (XTCWriter, "t.xtc")):
        w = cls(str(tmp_path / name), precision=precision)
        for i, f in enumerate(frames):
            w.write(f, box, step=i * 10, time_ps=i * 0.02)
        w.close()
    data = (tmp_path / "t.xtc").read_bytes()
    assert data == (tmp_path / "j.xtc").read_bytes()
    pos, boxes, times, steps = read_xtc(str(tmp_path / "t.xtc"))
    assert pos.shape == frames.shape and steps.tolist() == [0, 10, 20, 30]
    assert np.abs(pos - frames).max() <= 0.5 / precision * 1.05
    dec = oracle.decode_file(str(tmp_path / "t.xtc"))
    assert len(dec) == 4
    for f, d in zip(frames, dec):
        assert np.abs(np.asarray(d["coords"], np.float64) - f).max() \
            <= 0.5 / precision + 1e-6


@pytestmark_xtc
def test_xtc_golden_bytes_pinned(tmp_path):
    coords = np.load(get_data_file_path("xtc_golden_coords.npy"))
    path = str(tmp_path / "g.xtc")
    w = XTCWriter(path, precision=1000.0)
    for f in range(coords.shape[0]):
        w.write(coords[f], np.diag([2.5] * 3).astype(np.float32), step=f * 5,
                time_ps=f * 0.001)
    w.close()
    assert open(path, "rb").read() == open(get_data_file_path("xtc_golden.xtc"),
                                           "rb").read()


@pytestmark_xtc
def test_xtc_encode_rejects_nonfinite(tmp_path):
    w = XTCWriter(str(tmp_path / "bad.xtc"))
    x = _frames(1, 20)[0]
    x[3, 1] = np.nan
    with pytest.raises(RuntimeError):
        w.write(x, None)


# ---------------------------------------------------------------------------
# Structure I/O and the run configuration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["two_particles.pdb", "ethanol.pdb",
                                  "single_particle.pdb"])
def test_read_pdb_equals_jax(name):
    path = get_data_file_path(name)
    jpos, jtop, jbox = jio.read_pdb(path)
    tpos, ttop, tbox = tio.read_pdb(path)
    md = tu.md_unit_system
    assert np.array_equal(tpos.value_in_unit_system(md),
                          np.asarray(jpos.value_in_unit_system(md)))
    assert [a.name for a in ttop.atoms()] == [a.name for a in jtop.atoms()]
    assert np.array_equal(np.asarray(ttop.masses()), np.asarray(jtop.masses()))
    assert (tbox is None) == (jbox is None)


def test_read_sdf_equals_jax():
    path = get_data_file_path("ethanol.sdf")
    jpos, jtop, jbonds = jio.read_sdf(path)
    tpos, ttop, tbonds = tio.read_sdf(path)
    assert tbonds == jbonds and ttop.n_atoms == jtop.n_atoms == 9
    assert np.array_equal(np.asarray(tpos._value), np.asarray(jpos._value))


def test_write_pdb_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 3.0, (17, 3))
    box = np.eye(3) * 3.0
    jio.write_pdb(str(tmp_path / "j.pdb"), pos,
                  JTopology.uniform(17, 39.948, element="Ar"), box_vectors=box)
    tio.write_pdb(str(tmp_path / "t.pdb"), torch.tensor(pos),
                  Topology.uniform(17, 39.948, element="Ar"),
                  box_vectors=torch.tensor(box))
    assert (tmp_path / "t.pdb").read_text() == (tmp_path / "j.pdb").read_text()
    pos2, top2, box2 = tio.read_pdb(str(tmp_path / "t.pdb"))
    assert np.allclose(pos2.value_in_unit_system(tu.md_unit_system), pos, atol=1e-3)
    assert top2.getNumAtoms() == 17


def test_pdb_and_sdf_guards(tmp_path):
    p = tmp_path / "empty.pdb"
    p.write_text("REMARK nothing\nEND\n")
    with pytest.raises(ValueError, match="no ATOM"):
        tio.read_pdb(str(p))
    s = tmp_path / "t.sdf"
    s.write_text("x\n\n\n  9  8  0  0  0  0  0  0  0  0999 V2000\n"
                 "    0.0000    0.0000    0.0000 C   0  0\n")
    with pytest.raises(ValueError, match="truncated SDF"):
        tio.read_sdf(str(s))


def test_run_config_json_equals_jax(tmp_path):
    cfg = tcfg.RunConfig(output_dir=str(tmp_path))
    cfg.system.n_particles = 4000
    jc = jcfg.RunConfig(output_dir=str(tmp_path))
    jc.system.n_particles = 4000
    assert cfg.to_json() == jc.to_json()
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    assert tcfg.RunConfig.from_file(str(path)) == cfg


# ---------------------------------------------------------------------------
# Checkpoints: the layout both ways, JAX's sampler checkpoint in the port
# ---------------------------------------------------------------------------


def test_checkpoint_layout_equals_jax(tmp_path):
    """The port writes JAX's structure string and leaf order, and each
    package loads the other's file."""
    rng = np.random.default_rng(3)
    a, c = rng.normal(size=5).astype(np.float32), np.eye(2, dtype=np.float32)
    jtree = {"b": {"c": jnp.asarray(c)}, "a": jnp.asarray(a), "n": None,
             "t": (jnp.asarray(a),)}
    ttree = {"b": {"c": torch.tensor(c)}, "a": torch.tensor(a), "n": None,
             "t": (torch.tensor(a),)}
    jck.save_checkpoint(str(tmp_path / "j.npz"), jtree, metadata={"i": 7})
    tck.save_checkpoint(str(tmp_path / "t.npz"), ttree, metadata={"i": 7})
    for p in ("j.npz", "t.npz"):
        with np.load(tmp_path / p) as z:
            header = json.loads(bytes(z["__header__"]).decode())
            if p == "j.npz":
                want = header
            else:
                assert header == want
    restored, meta = tck.load_checkpoint(str(tmp_path / "j.npz"), like=ttree)
    assert meta["i"] == 7 and torch.equal(restored["b"]["c"], torch.tensor(c))
    jrest, _ = jck.load_checkpoint(str(tmp_path / "t.npz"), like=jtree)
    assert np.array_equal(np.asarray(jrest["a"]), a)


def test_checkpoint_atomic_verbatim_and_structure_guard(tmp_path):
    path = str(tmp_path / "run.ckpt")  # no .npz suffix
    tck.save_checkpoint(path, {"a": torch.arange(3.0)}, metadata={"i": 1})
    assert os.path.exists(path) and not os.path.exists(path + ".npz")
    assert not os.path.exists(path + ".tmp")
    tck.save_checkpoint(path, {"x": torch.zeros(4, 3), "v": torch.ones(4, 3)})
    with pytest.raises(ValueError, match="structure"):
        tck.load_checkpoint(path, like={"x": torch.zeros(4, 3),
                                        "box": torch.zeros(4, 3)})


def _jax_checkpoint(path, with_box=True):
    """A sampler checkpoint written by JAX: 5 particles with velocities, a
    box, iteration 12 and a tuned displacement move's statistics."""
    rng = np.random.default_rng(4)
    pos = rng.uniform(0, 2.0, (5, 3)).astype(np.float32)
    vel = rng.normal(size=(5, 3)).astype(np.float32)
    box = (np.eye(3) * 2.0).astype(np.float32)
    state = js.SamplerState(
        ju.Quantity(jnp.asarray(pos), ju.nanometer),
        current_PRNG_key=jax.random.PRNGKey(3),
        velocities=ju.Quantity(jnp.asarray(vel), ju.nanometer / ju.picosecond),
        box_vectors=ju.Quantity(jnp.asarray(box), ju.nanometer) if with_box else None)
    move = jm.MonteCarloDisplacementMove(displacement_sigma=0.1 * ju.nanometer,
                                         number_of_moves=10, autotune=True)
    move.n_accepted, move.n_proposed = 37, 50
    move._number_of_attempts_made, move._move_iteration = 50, 5
    move._set_param_value(0.271)
    jck.save_sampler_checkpoint(path, state, iteration=12, moves={"disp": move})
    return pos, vel, box


def test_jax_sampler_checkpoint_loads_into_the_port(tmp_path):
    path = str(tmp_path / "jax.npz")
    pos, vel, box = _jax_checkpoint(path)
    move = tm.MonteCarloDisplacementMove(displacement_sigma=0.1 * tu.nanometer,
                                         number_of_moves=10, autotune=True)
    state, meta = interop.sampler_state_from_checkpoint(
        path, key=99, device="cpu", moves={"disp": move})
    assert meta["iteration"] == 12 and state.current_PRNG_key == 99
    assert np.array_equal(state.positions.numpy(), pos)
    assert np.array_equal(state.velocities.numpy(), vel)
    assert np.array_equal(state.box_vectors.numpy(), box)
    assert (move.n_accepted, move.n_proposed) == (37, 50)
    assert move._number_of_attempts_made == 50 and move._move_iteration == 5
    assert move._param_value() == pytest.approx(0.271)

    # into a state made by the caller; without a key it refuses
    template = interop.sampler_state(np.zeros((5, 3)), 1, None, None, "cpu")
    with pytest.raises(ValueError, match="key"):
        tck.load_sampler_checkpoint(path, template)
    tck.load_sampler_checkpoint(path, template, key=7)
    assert torch.equal(template.velocities, state.velocities)


def test_sampler_checkpoint_field_mismatch_raises(tmp_path):
    path = str(tmp_path / "nobox.npz")
    _jax_checkpoint(path, with_box=False)
    with_box = interop.sampler_state(np.zeros((5, 3)), 1, None, np.eye(3), "cpu")
    with pytest.raises(ValueError, match="box"):
        tck.load_sampler_checkpoint(path, with_box, key=1)


# ---------------------------------------------------------------------------
# Restarts of the port: bit for bit
# ---------------------------------------------------------------------------


def test_langevin_restart_is_bitwise_identical(tmp_path):
    """100 + 100 Langevin steps in one process == 100, checkpoint, restore
    into a fresh state, 100."""
    ho = HarmonicOscillator()
    thermo = ts.ThermodynamicState(potential=ho.potential,
                                   temperature=300.0 * tu.kelvin)

    def fresh(seed):
        PRNG.set_seed(seed)
        return ts.SamplerState(positions=ho.positions,
                               current_PRNG_key=PRNG.get_random_key(),
                               device="cpu")

    integ = LangevinIntegrator(timestep=2.0 * tu.femtoseconds)
    cont, _ = integ.run(fresh(99), thermo, number_of_steps=100)
    cont, _ = integ.run(cont, thermo, number_of_steps=100)

    mid, _ = LangevinIntegrator(timestep=2.0 * tu.femtoseconds).run(
        fresh(99), thermo, number_of_steps=100)
    path = str(tmp_path / "mid.npz")
    tck.save_sampler_checkpoint(path, mid, iteration=100)
    restored = fresh(1)
    assert tck.load_sampler_checkpoint(path, restored)["iteration"] == 100
    out, _ = LangevinIntegrator(timestep=2.0 * tu.femtoseconds).run(
        restored, thermo, number_of_steps=100)
    assert torch.equal(out.positions, cont.positions)
    assert torch.equal(out.velocities, cont.velocities)


def test_mc_restart_with_statistics_is_bitwise_identical(tmp_path):
    """Two autotuned displacement updates on LJ (N=27, PairListNsqrd) in
    one process == one, a checkpoint with the move, a restore, one."""
    from chiron_tpu_torch.neighbors import OrthogonalPeriodicSpace, PairListNsqrd

    fluid = LennardJonesFluid(nparticles=27, reduced_density=0.3)
    thermo = ts.ThermodynamicState(potential=fluid.potential,
                                   temperature=120.0 * tu.kelvin)

    def fresh(seed):
        PRNG.set_seed(seed)
        ss = ts.SamplerState(positions=fluid.positions,
                             current_PRNG_key=PRNG.get_random_key(),
                             box_vectors=fluid.box_vectors, device="cpu")
        pl = PairListNsqrd(OrthogonalPeriodicSpace(), cutoff=fluid.cutoff)
        pl.build_from_state(ss)
        move = tm.MonteCarloDisplacementMove(
            displacement_sigma=0.05 * tu.nanometer, number_of_moves=40,
            autotune=True, autotune_interval=10)
        return ss, pl, move

    ss, pl, move = fresh(5)
    for _ in range(2):
        ss, _, pl = move.update(ss, thermo, pl)

    ss2, pl2, move2 = fresh(5)
    ss2, _, pl2 = move2.update(ss2, thermo, pl2)
    path = str(tmp_path / "mc.npz")
    tck.save_sampler_checkpoint(path, ss2, iteration=1, moves={"disp": move2})
    ss3, pl3, move3 = fresh(8)
    tck.load_sampler_checkpoint(path, ss3, moves={"disp": move3})
    pl3.build_from_state(ss3)
    ss3, _, _ = move3.update(ss3, thermo, pl3)
    assert torch.equal(ss3.positions, ss.positions)
    assert move3.statistics == move.statistics
    assert move3.displacement_sigma == move.displacement_sigma
    assert ss3.current_PRNG_key == ss.current_PRNG_key


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------


def test_profiling_helpers(tmp_path):
    tp_ = tprof.Throughput()
    with tp_.measure(n_steps=10, sync=torch.zeros(1)):
        sum(range(1000))
    assert tp_.total_steps == 10 and tp_.steps_per_second > 0
    assert set(tp_.report()) == {"total_steps", "total_seconds",
                                 "steps_per_second", "steps_per_minute"}
    with tprof.timed("section", sync=True):
        pass
    with tprof.trace(str(tmp_path / "tr")) as prof:
        torch.ones(8).sum()
    assert (tmp_path / "tr" / "trace.json").exists()
    assert len(prof.key_averages()) > 0
    tprof.enable_nan_debugging(True)
    assert torch.is_anomaly_enabled()
    tprof.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
