"""The port's substrate against the JAX package: units, topology, the LJ
fluid, the LJ parameters, and the rule that the port never imports jax."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chiron_tpu.potential as jpot
import chiron_tpu.testsystems as jts
import chiron_tpu.topology as jtop
import chiron_tpu.units as ju
import chiron_tpu_torch.potential as tpot
import chiron_tpu_torch.testsystems as tts
import chiron_tpu_torch.topology as ttop
import chiron_tpu_torch.units as tu

REPO = Path(__file__).resolve().parent.parent


def _public(mod, kind):
    return sorted(n for n in dir(mod)
                  if not n.startswith("_") and isinstance(getattr(mod, n), kind))


def test_units_constants_and_units_identical():
    assert _public(tu, tu.Unit) == _public(ju, ju.Unit)
    for name in _public(ju, ju.Unit):
        a, b = getattr(ju, name), getattr(tu, name)
        assert (a.scale, tuple(a.dims), a.name) == (b.scale, tuple(b.dims), b.name), name
    for name in _public(ju, float):
        assert getattr(tu, name) == getattr(ju, name), name
    for name in _public(ju, ju.Quantity):
        a, b = getattr(ju, name), getattr(tu, name)
        assert a.value_in_unit_system(ju.md_unit_system) == b.value_in_unit_system(
            tu.md_unit_system), name


@pytest.mark.parametrize("expr, unit", [
    ("2.0 * U.femtoseconds", "picosecond"),
    ("120.0 * U.kelvin", "kelvin"),
    ("0.238 * U.kilocalories_per_mole", "kilojoule_per_mole"),
    ("1.0 / U.picoseconds", None),
    ("1.0 * U.atmosphere", None),
])
def test_units_conversions_identical(expr, unit):
    qa = eval(expr, {"U": ju})
    qb = eval(expr, {"U": tu})
    if unit is None:
        assert qa.value_in_unit_system(ju.md_unit_system) == \
            qb.value_in_unit_system(tu.md_unit_system)
    else:
        assert ju.strip_md(qa, getattr(ju, unit)) == tu.strip_md(qb, getattr(tu, unit))
    if "atmosphere" in expr:
        assert ju.pressure_to_md(qa) == tu.pressure_to_md(qb)


def test_topology_identical():
    for mod in (jtop, ttop):
        assert mod.Topology.uniform(7, 39.948).n_atoms == 7
    a = jtop.Topology.uniform(5, 39.948 * ju.amu)
    b = ttop.Topology.uniform(5, 39.948 * tu.amu)
    np.testing.assert_array_equal(a.masses(), b.masses())
    a.add_atom("c", "C")
    b.add_atom("c", "C")
    np.testing.assert_array_equal(a.masses(), b.masses())
    assert [x.name for x in a.atoms()] == [x.name for x in b.atoms()]


@pytest.mark.parametrize("n, rho", [(1000, 0.8), (4000, 0.8), (256, 0.4)])
def test_lj_fluid_identical(n, rho):
    a = jts.LennardJonesFluid(nparticles=n, reduced_density=rho)
    b = tts.LennardJonesFluid(nparticles=n, reduced_density=rho)
    md_a, md_b = ju.md_unit_system, tu.md_unit_system
    pa = np.asarray(a.positions.value_in_unit_system(md_a))
    pb = b.positions.value_in_unit_system(md_b)
    assert pa.dtype == pb.dtype == np.float32
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(
        np.asarray(a.box_vectors.value_in_unit_system(md_a)),
        b.box_vectors.value_in_unit_system(md_b))
    np.testing.assert_array_equal(a.topology.masses(), b.topology.masses())
    assert a.box_length == b.box_length
    for attr in ("sigma", "epsilon", "cutoff"):
        assert getattr(a.potential, attr) == getattr(b.potential, attr)


def test_lj_potential_validation():
    top = ttop.Topology.uniform(3, 39.948)
    kw = dict(sigma=0.34 * tu.nanometer, epsilon=1.0 * tu.kilojoule_per_mole,
              cutoff=1.0 * tu.nanometer)
    p = tpot.LJPotential(top, **kw)
    q = jpot.LJPotential(jtop.Topology.uniform(3, 39.948),
                         sigma=0.34 * ju.nanometer,
                         epsilon=1.0 * ju.kilojoule_per_mole,
                         cutoff=1.0 * ju.nanometer)
    assert (p.sigma, p.epsilon, p.cutoff) == (q.sigma, q.epsilon, q.cutoff)
    with pytest.raises(ValueError, match="sigma"):
        tpot.LJPotential(top, **{**kw, "sigma": 1.0 * tu.kelvin})
    with pytest.raises(ValueError, match="epsilon"):
        tpot.LJPotential(top, **{**kw, "epsilon": 1.0 * tu.nanometer})
    with pytest.raises(TypeError):
        tpot.LJPotential("not a topology", **kw)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import chiron_tpu_torch.runtime, chiron_tpu_torch.ops.lj_cull\n"
        "import chiron_tpu_torch.interop, chiron_tpu_torch.oracles\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'chiron_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_name_no_jax_import():
    pattern = re.compile(
        r"^\s*(import\s+(jax|chiron_tpu)\b|from\s+(jax|chiron_tpu)\b)", re.M)
    # _build/ holds build outputs (gitignored), not package sources
    files = sorted(f for f in (REPO / "chiron_tpu_torch").rglob("*.py")
                   if "_build" not in f.relative_to(REPO).parts[1:2])
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_torch_runs_one_intra_op_thread_in_each_test_process():
    # The root conftest.py pins it: each xdist worker would otherwise start
    # one torch thread per core, and the workers would contend for the cores.
    assert torch.get_num_threads() == 1
