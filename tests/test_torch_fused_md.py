"""The port's fused dense MD (K9's plain version on the CPU) against the JAX
package's ``FusedLJMD`` in interpret mode, on tests/test_fused_md.py's
system (LJ fluid n=216, rho*=0.5, 90 K, 1 fs, tm=64, n_pad 256), with
gamma > 0 so that the noise stream is exercised."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chiron_tpu.runtime as jrt
import chiron_tpu.testsystems as jts
import chiron_tpu.units as ju
import chiron_tpu_torch.runtime as trt
import chiron_tpu_torch.testsystems as tts
import chiron_tpu_torch.units as tu
from chiron_tpu.ops import lj_dense as jld
from chiron_tpu.ops.lj_md_fused import FusedLJMD as JFusedLJMD
from chiron_tpu_torch.ops import lj_cull as tlc
from chiron_tpu_torch.ops import lj_md_fused as tmf

N, TM, MASS = 216, 64, 39.948
SEED = 5


def _np(a):
    return np.array(a)


def _fluid(ts, units, n=N, rho=0.5):
    fluid = ts.LennardJonesFluid(nparticles=n, reduced_density=rho)
    md = units.md_unit_system
    return (fluid, fluid.positions.value_in_unit_system(md),
            fluid.box_vectors.value_in_unit_system(md))


def _lj():
    fluid = tts.LennardJonesFluid(nparticles=N, reduced_density=0.5)
    pot = fluid.potential
    return pot.sigma, pot.epsilon, pot.cutoff


def _md(cls, fluid, n, n_pad, gamma, T, **kw):
    pot = fluid.potential
    return cls(n, pot.sigma, pot.epsilon, pot.cutoff,
               masses_lane=np.full((1, n_pad), MASS), dt=0.001, gamma=gamma,
               kT=ju.kB_MD * T, tm=TM, **kw)


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions run (3, 256) arrays step by step: one thread is
    faster than several."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX state 50 dense steps off the lattice (where the forces are
    not ~0), and JAX FusedLJMD (gamma 1/ps) after 1, 3 and 20 steps from
    it."""
    fluid, pos, box = _fluid(jts, ju)
    runner = jrt.make_fast_lj_runner(
        fluid.potential, n_particles=N, topology=fluid.topology,
        temperature=90.0 * ju.kelvin, timestep=1.0 * ju.femtoseconds,
        collision_rate=1.0 / ju.picoseconds, tm=TM)
    st = runner.run(runner.init(pos, box, seed=3), 50)
    md = _md(JFusedLJMD, fluid, N, runner.op.n_pad, 1.0, 90.0)
    out = {k: md.run(st.x, st.v, st.F, st.box_vectors, seed=SEED, n_steps=k,
                     step_offset=7) for k in (1, 3, 20)}
    state = tuple(_np(a) for a in (st.x, st.v, st.F, st.box_vectors))
    return state, {k: tuple(_np(a) for a in v) for k, v in out.items()}, md


@pytest.fixture(scope="module")
def port_md():
    fluid, _, _ = _fluid(tts, tu)
    return _md(tmf.FusedLJMD, fluid, N, 256, 1.0, 90.0, device="cpu")


def test_fused_md_matches_jax(jax_runs, port_md):
    (x, v, F, box), ref, jmd = jax_runs
    assert port_md.n_pad == jmd.n_pad == x.shape[1] == 256
    assert (port_md.a, port_md.b) == (jmd.a, jmd.b)  # f32, as JAX has them
    np.testing.assert_array_equal(port_md.minv.numpy(), _np(jmd.minv))
    np.testing.assert_array_equal(port_md.sigv.numpy(), _np(jmd.sigv))
    exact = jld.LJDensePallas(N, *_lj(), tm=TM, tn=TM, n_pad=256)
    t = [torch.from_numpy(a) for a in (x, v, F, box)]
    for k, (jx, jv, jF) in ref.items():
        tx, tv, tF = port_md.run(*t, seed=SEED, n_steps=k, step_offset=7)
        ex = np.abs(tx.numpy() - jx).max()
        ev = np.abs(tv.numpy() - jv).max()
        assert np.abs(tF.numpy()[:, N:]).max() == 0.0
        if k > 3:
            # 20 chaotic steps: the JAX test's bounds
            assert ex < 5e-3 and ev < 5e-1, (k, ex, ev)
            continue
        # JAX in interpret mode takes pl.reciprocal(approx=True) as a bf16
        # reciprocal (jax/_src/pallas/primitives.py), about 2^-8 relative,
        # which moves each pair force by up to ~1.6%: x and v see it only
        # through dt^2/m and dt/2m
        assert ex < 1e-5 and ev < 1e-3, (k, ex, ev)
        scale = np.abs(jF).max()
        dF = np.abs(tF.numpy() - jF)
        assert np.percentile(dF, 99.0) / scale < 0.05, (k, dF.max())
        # the plain force is K9's function with the exact division: JAX's
        # exact dense force at the same positions, up to pairs at the
        # cutoff (each flip moves a force by at most |coef(rc)| rc ~ 0.033)
        F_ref = _np(exact.force_only_t(jnp.asarray(tx.numpy()),
                                       jnp.asarray(box), approx_recip=False))
        dF = np.abs(tF.numpy() - F_ref)
        assert dF.max() < 0.05, (k, dF.max())
        assert np.percentile(dF, 99.0) / scale < 1e-5, k


def test_step_offset_continues_the_stream(jax_runs, port_md):
    """3 steps equal 1 step then 2 more at step_offset + 1, bit for bit."""
    (x, v, F, box), _, _ = jax_runs
    t = [torch.from_numpy(a) for a in (x, v, F, box)]
    a = port_md.run(*t, seed=SEED, n_steps=3, step_offset=7)
    b = port_md.run(*t, seed=SEED, n_steps=1, step_offset=7)
    b = port_md.run(*b, t[3], seed=SEED, n_steps=2, step_offset=8)
    for p, q in zip(a, b):
        assert torch.equal(p, q)


def test_gamma_zero_matches_the_dense_runner():
    """gamma = 0: the port's fused segment follows the port's dense runner
    step for step up to f32 reassociation (tests/test_fused_md.py:39)."""
    fluid, pos, box = _fluid(tts, tu)
    runner = trt.make_fast_lj_runner(
        fluid.potential, n_particles=N, topology=fluid.topology,
        temperature=90.0 * tu.kelvin, timestep=1.0 * tu.femtoseconds,
        collision_rate=0.0 / tu.picoseconds, tm=TM, device="cpu")
    st = runner.init(pos, box, seed=3)
    md = _md(tmf.FusedLJMD, fluid, N, runner.op.n_pad, 0.0, 90.0,
             device="cpu")
    s_scan = runner.run(st, 20)
    x_f, v_f, _ = md.run(st.x, st.v, st.F, st.box_vectors, seed=0, n_steps=20)
    assert float((x_f - s_scan.x).abs().max()) < 5e-3
    assert float((v_f - s_scan.v).abs().max()) < 5e-1


@pytest.mark.parametrize("seed, step", [(5, 7), (-3, 2 ** 31 - 1),
                                        (2 ** 31 - 1, 123456)])
def test_noise_bits_match_the_jax_kernel(seed, step):
    """The (3, n_pad) counters of ``lj_md_fused.py:83-121``, transcribed in
    numpy (uint32 arithmetic wraps), equal the port's, uint32 exact."""
    n_pad = 256
    u32 = np.uint32
    with np.errstate(over="ignore"):
        lane = (np.arange(3, dtype=u32)[:, None] * u32(n_pad)
                + np.arange(n_pad, dtype=u32)[None, :])
        base = (np.array(seed, np.int32).astype(u32) * u32(0x9E3779B9)
                + np.array(step, np.int32).astype(u32) * u32(0x85EBCA6B))

        def mix(z):
            z = z ^ (z >> u32(16))
            z = z * u32(0x85EBCA6B)
            z = z ^ (z >> u32(13))
            z = z * u32(0xC2B2AE35)
            return z ^ (z >> u32(16))

        c1 = (lane * u32(2)) * u32(0x9E3779B9) + base
        c2 = (lane * u32(2) + u32(1)) * u32(0x9E3779B9) + base
        bits = mix(c1), mix(c2)
    tc1, tc2 = tlc.lane_counters(seed, step, (3, n_pad))
    for a, b in ((tc1, c1), (tc2, c2), (tlc._mix32(tc1), bits[0]),
                 (tlc._mix32(tc2), bits[1])):
        np.testing.assert_array_equal(a.numpy(), b.astype(np.int64))
    u1, u2 = tlc.counter_uniforms(tc1, tc2)
    ref = [(b >> u32(8)).astype(np.int32).astype(np.float32)
           * np.float32(1.0 / 16777216.0) for b in bits]
    np.testing.assert_array_equal(u1.numpy(), np.maximum(ref[0], 1e-7))
    np.testing.assert_array_equal(u2.numpy(), ref[1])


def test_energy_conservation_gamma_zero():
    """Total energy held by the fused velocity-Verlet limit
    (tests/test_fused_md.py:58, n=125, rho*=0.4, 60 K): drift under 1% of
    the kinetic energy over 1500 steps."""
    fluid, pos, box = _fluid(tts, tu, n=125, rho=0.4)
    runner = trt.make_fast_lj_runner(
        fluid.potential, n_particles=125, topology=fluid.topology,
        temperature=60.0 * tu.kelvin, timestep=1.0 * tu.femtoseconds,
        collision_rate=0.0 / tu.picoseconds, tm=TM, device="cpu")
    st = runner.init(pos, box, seed=3)
    md = _md(tmf.FusedLJMD, fluid, 125, runner.op.n_pad, 0.0, 60.0,
             device="cpu")
    op = runner.op

    def total(x3, v3):
        v = op.unpad(v3).double()
        return 0.5 * MASS * float((v * v).sum()) + float(
            op.force_energy_t(x3, st.box_vectors)[1])

    x3, v3, f3 = md.run(st.x, st.v, st.F, st.box_vectors, seed=0, n_steps=500)
    e0 = total(x3, v3)
    ke = 0.5 * MASS * float((op.unpad(v3).double() ** 2).sum())
    x3, v3, _ = md.run(x3, v3, f3, st.box_vectors, seed=1, n_steps=1500)
    assert abs(total(x3, v3) - e0) / max(ke, 1.0) < 0.01


def test_thermostat_equipartition():
    """<KE> = 3/2 N kT within 5% from the fused O step's noise
    (tests/test_fused_md.py:80, n=216, rho*=0.4, 120 K, gamma 2/ps; 1000
    steps to equilibrate and 20 samples 150 steps apart, where JAX's takes
    2000 and 25 x 200)."""
    fluid, pos, box = _fluid(tts, tu, rho=0.4)
    runner = trt.make_fast_lj_runner(
        fluid.potential, n_particles=N, topology=fluid.topology,
        temperature=120.0 * tu.kelvin, timestep=1.0 * tu.femtoseconds,
        collision_rate=2.0 / tu.picoseconds, tm=TM, device="cpu")
    st = runner.init(pos, box, seed=3)
    md = _md(tmf.FusedLJMD, fluid, N, runner.op.n_pad, 2.0, 120.0,
             device="cpu")
    x3, v3, f3 = md.run(st.x, st.v, st.F, st.box_vectors, seed=0,
                        n_steps=1000)
    kes = []
    for i in range(20):
        x3, v3, f3 = md.run(x3, v3, f3, st.box_vectors, seed=100 + i,
                            n_steps=150)
        v = runner.op.unpad(v3).double()
        kes.append(0.5 * MASS * float((v * v).sum()))
    assert np.mean(kes) == pytest.approx(1.5 * N * tu.kB_MD * 120.0, rel=0.05)

