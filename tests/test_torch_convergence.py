"""Statistical-physics checks of the port's runners, as the JAX package holds
its own (``tests/test_convergence.py:18, 49``, ``tests/test_lj_cull.py:426``):

* the kinetic temperature under ``FastLJRunner``'s own noise -> (3/2) N kT;
* BAOAB at gamma = 0 is velocity Verlet: the total energy is conserved;
* the same through the whole culled engine (sort, tile-pair list, K3's
  segment), from a thermostatted liquid.

Each runs on the card (``gpu``; it skips where no CUDA device is visible)
and on the CPU, where the kernels' plain versions run (``slow`` there for
the first and the last).  They import no jax.
"""

import numpy as np
import pytest
import torch

from chiron_tpu_torch import units
from chiron_tpu_torch.runtime import make_culled_lj_runner, make_fast_lj_runner
from chiron_tpu_torch.testsystems import LennardJonesFluid

MASS = 39.948
CUDA = pytest.param("cuda", id="cuda", marks=pytest.mark.gpu)
DEVICES = [pytest.param("cpu", id="cpu"), CUDA]
# on the CPU these take 15-35 s on one core: too long for tier 1
SLOW_ON_CPU = [pytest.param("cpu", id="cpu", marks=pytest.mark.slow), CUDA]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device(name)


def _lattice(fluid):
    md = units.md_unit_system
    return (fluid.positions.value_in_unit_system(md),
            fluid.box_vectors.value_in_unit_system(md))


def _ke(v):
    return 0.5 * MASS * float((v.double() ** 2).sum())


@pytest.mark.parametrize("device", SLOW_ON_CPU)
def test_lj_fluid_kinetic_temperature(device):
    """<KE> = (3/2) N kT within 3% under the dense runner's own noise
    (N=256, rho*=0.4, 120 K, 2 fs; 2000 steps to equilibrate, then 30
    samples 200 steps apart)."""
    dev = _device(device)
    n, T = 256, 120.0
    fluid = LennardJonesFluid(nparticles=n, reduced_density=0.4)
    runner = make_fast_lj_runner(
        fluid.potential, n_particles=n, topology=fluid.topology,
        temperature=T * units.kelvin, timestep=2.0 * units.femtoseconds,
        tm=64, device=dev)
    state = runner.run(runner.init(*_lattice(fluid), seed=3), 2000)
    kes = []
    for _ in range(30):
        state = runner.run(state, 200)
        kes.append(_ke(runner.velocities(state)))
    expected = 1.5 * n * units.kB_MD * T
    assert np.mean(kes) == pytest.approx(expected, rel=0.03)


@pytest.mark.parametrize("device", DEVICES)
def test_baoab_gamma_zero_conserves_energy(device):
    """gamma = 0: velocity Verlet on the dense runner (N=125, rho*=0.4,
    1 fs, exact forces); after 1000 steps of the lattice's transient, the
    total energy moves under 1% of the kinetic energy over 2000 steps."""
    dev = _device(device)
    n = 125
    fluid = LennardJonesFluid(nparticles=n, reduced_density=0.4)
    runner = make_fast_lj_runner(
        fluid.potential, n_particles=n, topology=fluid.topology,
        temperature=60.0 * units.kelvin, timestep=1.0 * units.femtoseconds,
        collision_rate=0.0 / units.picoseconds, tm=64, exact_forces=True,
        device=dev)

    def total_energy(st):
        ke = _ke(runner.velocities(st))
        return ke + float(runner.energy(st)), ke

    state = runner.run(runner.init(*_lattice(fluid), seed=5), 1000)
    e0, _ = total_energy(state)
    state = runner.run(state, 2000)
    e1, ke = total_energy(state)
    assert abs(e1 - e0) / max(abs(ke), 1.0) < 0.01


@pytest.mark.parametrize("device", SLOW_ON_CPU)
def test_culled_runner_nve_energy_conservation(device):
    """gamma = 0 through the whole culled engine (N=512, rho*=0.64, 60 K,
    tiles 16 x 16, the card's smallest row tile, where the JAX test takes
    8 x 16; S=20, slack 0.3, exact forces), from a liquid that the
    dense runner melted for 1000 steps: KE + PE moves under 0.5% of
    (3/2) N kT over 1000 steps, and ``check()`` stays clean."""
    dev = _device(device)
    n = 512
    fluid = LennardJonesFluid(nparticles=n, reduced_density=0.64)
    pos, box = _lattice(fluid)
    eq = make_fast_lj_runner(fluid.potential, n_particles=n,
                             topology=fluid.topology,
                             temperature=60.0 * units.kelvin, device=dev)
    est = eq.run(eq.init(pos, box, seed=5), 1000)
    nve = make_culled_lj_runner(
        potential=fluid.potential, n_particles=n, topology=fluid.topology,
        temperature=60.0 * units.kelvin,
        collision_rate=0.0 / units.picoseconds, exact_forces=True, tm=16,
        tn=16, segment_steps=20, slack=0.3, device=dev)
    state = nve.init(eq.positions(est).cpu().numpy(), box, seed=6)

    def total_energy(st):
        return _ke(nve.velocities(st)) + float(nve.energy(st))

    state = nve.run(state, 20)  # E0 measured on the engine itself
    e0 = total_energy(state)
    state = nve.run(state, 1000)
    nve.check(state)
    e1 = total_energy(state)
    ke_scale = 1.5 * n * units.kB_MD * 60.0
    assert abs(e1 - e0) / ke_scale < 0.005, (e0, e1)
