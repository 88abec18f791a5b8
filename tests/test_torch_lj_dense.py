"""The port's dense LJ engine (K1's plain version on the CPU) against the
JAX triangle kernel in interpret mode, at the sizes of tests/test_ops.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiron_tpu.ops.lj_dense import LJDensePallas
from chiron_tpu.oracles import lj_dense_oracle as jax_oracle
from chiron_tpu_torch.ops.lj_dense import LJDense, lj_dense_force_energy
from chiron_tpu_torch.oracles import lj_dense_oracle

N = 192  # not a tile multiple: exercises padding and masking
SIGMA, EPS, CUTOFF = 0.34, 0.99579, 1.02
L = 4.0


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(0)
    n_side = int(np.ceil(N ** (1 / 3)))
    g = (np.arange(n_side) + 0.5) * L / n_side
    xyz = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)[:N]
    xyz = (xyz + rng.normal(0, 0.02, xyz.shape)).astype(np.float32)
    box = (np.eye(3) * L).astype(np.float32)
    jop = LJDensePallas(N, SIGMA, EPS, CUTOFF, tm=64, tn=128, triangle=True)
    F, E = jop.force_energy(jnp.asarray(xyz), jnp.asarray(box))
    return xyz, box, np.asarray(F), float(E), jop


def _op():
    return LJDense(N, SIGMA, EPS, CUTOFF, tm=64, tn=128, device="cpu")


def test_force_and_energy_match_jax_triangle_kernel(system):
    xyz, box, F_ref, E_ref, _ = system
    F, E = _op().force_energy(torch.from_numpy(xyz), torch.from_numpy(box))
    scale = np.abs(F_ref).max()
    assert np.abs(F.numpy() - F_ref).max() / scale < 1e-5
    assert abs(float(E) - E_ref) / abs(E_ref) < 1e-5


def test_lane_layout_surface_matches_jax(system):
    """force_only_t / force_energy_t on the (3, n_pad) layout, padding
    columns zero, as LJDensePallas's zero-copy surface."""
    xyz, box, _, E_ref, jop = system
    op = _op()
    assert op.n_pad == jop.n_pad
    pos3 = op.pad_positions(xyz)
    np.testing.assert_array_equal(pos3.numpy(),
                                  np.asarray(jop.pad_positions(jnp.asarray(xyz))))
    box_diag = torch.from_numpy(np.diagonal(box).reshape(1, 3).copy())
    F3 = op.force_only_t(pos3, box_diag, approx_recip=False)
    F3_ref = np.asarray(jop.force_only_t(jnp.asarray(pos3.numpy()),
                                         jnp.asarray(box_diag.numpy()),
                                         approx_recip=False))
    assert np.abs(F3.numpy() - F3_ref).max() / np.abs(F3_ref).max() < 1e-5
    assert float(F3[:, N:].abs().max()) == 0.0
    F3e, E = op.force_energy_t(pos3, box_diag)
    torch.testing.assert_close(F3e, F3, rtol=0, atol=0)
    assert abs(float(E) - E_ref) / abs(E_ref) < 1e-5
    np.testing.assert_array_equal(op.unpad(pos3).numpy(), xyz)


def test_energy_gradient_is_exactly_negative_force(system):
    xyz, box, _, _, _ = system
    op = _op()
    x = torch.from_numpy(xyz).requires_grad_(True)
    E = op.energy(x, torch.from_numpy(box))
    (g,) = torch.autograd.grad(E, x)
    F, E2 = op.force_energy(torch.from_numpy(xyz), torch.from_numpy(box))
    assert float(E.detach()) == float(E2)
    assert torch.equal(g, -F)


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-5)])
def test_torch_oracle_matches_jax_oracle(system, dtype, tol):
    xyz, box, F_ref, E_ref, _ = system
    Fo, Eo = jax_oracle(jnp.asarray(xyz), jnp.asarray(box), SIGMA, EPS, CUTOFF)
    F, E = lj_dense_oracle(torch.from_numpy(xyz).to(dtype),
                           torch.from_numpy(box).to(dtype), SIGMA, EPS, CUTOFF)
    assert F.dtype == dtype
    Fo = np.asarray(Fo)
    assert np.abs(F.double().numpy() - Fo).max() / np.abs(Fo).max() < tol
    assert abs(float(E) - float(Eo)) / abs(float(Eo)) < tol
    # the f64 oracle also anchors the JAX kernel's force and energy
    if dtype == torch.float64:
        assert np.abs(F.numpy() - F_ref).max() / np.abs(Fo).max() < 1e-5
        assert abs(float(E) - E_ref) / abs(float(E)) < 1e-5


def test_kernel_wrapper_rejects_unsupported_devices(system):
    """A wrapper takes the plain version only for CPU tensors; any other
    device goes to the kernel path, which refuses what it cannot run."""
    xyz, box, _, _, _ = system
    pos3 = torch.zeros((3, 256), device="meta")
    box_diag = torch.ones((1, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        lj_dense_force_energy(pos3, box_diag, N, SIGMA, EPS, CUTOFF)

