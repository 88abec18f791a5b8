"""The last public names of ``chiron_tpu`` that the port had lacked, each held
to the JAX package's: the package-level ``Space``,
``OrthogonalPeriodicSpace``, ``OrthogonalNonPeriodicSpace`` and ``PRNG``,
``utils.get_full_path``, ``potential.stack_closed_set_params`` and
``runtime.band_run_chunk``."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chiron_tpu
import chiron_tpu.potential as jp
import chiron_tpu.runtime as jrt
import chiron_tpu.units as ju
import chiron_tpu_torch
import chiron_tpu_torch.potential as tp
import chiron_tpu_torch.runtime as trt
import chiron_tpu_torch.testsystems as tts
import chiron_tpu_torch.units as tu
from chiron_tpu.topology import Topology as JTopology
from chiron_tpu_torch.topology import Topology as TTopology

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_package_names_equal_the_references():
    from chiron_tpu_torch import space, utils

    assert chiron_tpu_torch.__all__ == chiron_tpu.__all__
    for name in ("Space", "OrthogonalPeriodicSpace",
                 "OrthogonalNonPeriodicSpace"):
        assert getattr(chiron_tpu_torch, name) is getattr(space, name)
    assert chiron_tpu_torch.PRNG is utils.PRNG
    with pytest.raises(AttributeError):
        chiron_tpu_torch.NoSuchName  # noqa: B018


def test_importing_the_package_imports_no_torch():
    """The names resolve lazily: ``import chiron_tpu_torch`` stays free of
    torch until one is asked for."""
    code = ("import sys, chiron_tpu_torch; assert 'torch' not in sys.modules; "
            "chiron_tpu_torch.OrthogonalPeriodicSpace; "
            "assert 'torch' in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


@pytest.mark.parametrize("name", ["OrthogonalPeriodicSpace",
                                  "OrthogonalNonPeriodicSpace"])
def test_package_spaces_match_jax(name):
    rng = np.random.default_rng(2)
    box = np.diag([2.0, 2.5, 3.0]).astype(np.float32)
    xa = rng.uniform(-1.0, 4.0, (16, 3)).astype(np.float32)
    xb = rng.uniform(-1.0, 4.0, (16, 3)).astype(np.float32)
    js = getattr(chiron_tpu, name)()
    ts = getattr(chiron_tpu_torch, name)()
    assert isinstance(ts, chiron_tpu_torch.Space)
    rj, dj = js.displacement(jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(box))
    rt, dt = ts.displacement(torch.from_numpy(xa), torch.from_numpy(xb),
                             torch.from_numpy(box))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
    np.testing.assert_allclose(
        ts.wrap(torch.from_numpy(xa), torch.from_numpy(box)).numpy(),
        np.asarray(js.wrap(jnp.asarray(xa), jnp.asarray(box))), atol=1e-6)


def test_package_prng_follows_the_references_contract():
    """The port's keys are integers split by splitmix64, JAX's threefry keys
    (not the same stream, by design): both refuse a draw before a seed, and
    a seed gives the same keys again, each distinct."""
    for prng in (chiron_tpu.PRNG, chiron_tpu_torch.PRNG):
        saved = prng._key, prng._seed  # the class is process-global
        try:
            prng._key = None
            with pytest.raises(RuntimeError, match="set_seed"):
                prng.get_random_key()
            keys = []
            for _ in range(2):
                prng.set_seed(1234)
                keys.append([np.asarray(prng.get_random_key()).tolist()
                             for _ in range(3)])
            assert keys[0] == keys[1]
            assert len({str(k) for k in keys[0]}) == 3
            assert prng._seed == 1234
        finally:
            prng._key, prng._seed = saved


def test_get_full_path_resolves_from_the_repository_root():
    """tests/test_units.py:108-111 for the port: the same file as JAX's."""
    from chiron_tpu.utils import get_full_path as jax_path
    from chiron_tpu_torch.utils import get_full_path

    path = get_full_path("README.md")
    assert path.endswith("README.md") and os.path.isfile(path)
    assert os.path.normpath(path) == os.path.normpath(jax_path("README.md"))


def test_stack_closed_set_params_is_the_registry_as_in_jax():
    assert tp.stack_closed_set_params is tp.stack_registered_params
    assert jp.stack_closed_set_params is jp.stack_registered_params
    n = 8
    rng = np.random.default_rng(6)
    pos = rng.uniform(0, 1.5, size=(n, 3)).astype(np.float32)
    box = np.array([1.5, 1.5, 1.5], np.float32)

    def ladder(pkg, units, topo):
        return [pkg.HarmonicOscillatorPotential(
                    topo.uniform(n),
                    k=k * units.kilojoule_per_mole / units.nanometer ** 2,
                    x0=units.Quantity(np.full((n, 3), 0.7, np.float32),
                                      units.nanometer))
                for k in (50.0, 90.0)] + [pkg.IdealGasPotential(None)]

    jf, jparams = jp.stack_closed_set_params(ladder(jp, ju, JTopology), box)
    tf, tparams = tp.stack_closed_set_params(ladder(tp, tu, TTopology), box)
    assert tf.kind_list == jf.kind_list
    e_j = np.asarray(jax.vmap(lambda p: jf(p, jnp.asarray(pos)))(jparams))
    e_t = torch.func.vmap(lambda p: tf(p, torch.from_numpy(pos)))(tparams)
    np.testing.assert_allclose(e_t.numpy(), e_j, rtol=1e-6, atol=1e-6)


def test_band_run_chunk_is_the_references_scan():
    """A scan-style step ``(carry, None) -> (carry, out)`` over a few steps
    gives JAX's ``lax.scan`` result; on the band runner it is its ``run``
    with the noise of each step given."""
    def jstep(c, _):
        return (0.5 * c[0] + c[1], c[1] * 1.25), None

    def tstep(c, _):
        return (0.5 * c[0] + c[1], c[1] * 1.25), None

    x0 = np.linspace(-1.0, 1.0, 12, dtype=np.float32)
    jc = jrt.band_run_chunk(jstep, (jnp.asarray(x0), jnp.asarray(x0[::-1])), 7)
    tc = trt.band_run_chunk(tstep, (torch.from_numpy(x0),
                                    torch.from_numpy(x0[::-1].copy())), 7)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)

    fluid = tts.LennardJonesFluid(nparticles=2000, reduced_density=0.3)
    md = tu.md_unit_system
    band = trt.make_band_lj_runner(fluid.potential, 2000,
                                   topology=fluid.topology, tm=64,
                                   device="cpu")
    s0 = band.init(fluid.positions.value_in_unit_system(md),
                   fluid.box_vectors.value_in_unit_system(md), seed=1)
    gen = torch.Generator().manual_seed(9)
    noise = torch.randn((3, 3, band.n_pad), generator=gen)
    it = iter(noise)
    chunk = trt.band_run_chunk(lambda c, _: (band.step(c, next(it)), None),
                               s0, 3)
    ref = s0
    for k in range(3):
        ref = band.step(ref, noise[k])
    assert torch.equal(chunk.x, ref.x) and torch.equal(chunk.v, ref.v)
