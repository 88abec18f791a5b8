"""Fused dense BAOAB segments (port of ``chiron_tpu/ops/lj_md_fused.py``).

``FusedLJMD.run`` advances S Langevin steps on the dense all-pairs LJ force
in one host call.  On a CUDA tensor ``fused_md`` calls
``csrc/lj_md_fused.cu``, which replaces the TPU kernel K9
(``_make_md_kernel`` :43, ``fused_md_raw`` :203, ``pallas_call`` :212): S
times the update (the merged full kick, the drifts, the O step and the
divide-wrap) and the triangle force with the approximate reciprocal, all
enqueued on the current stream by one C entry, counted as ``fused_md``.  On
a CPU tensor it runs ``fused_md_plain``, the same arithmetic with the exact
division.

The O-step noise is splitmix32 over the (3, n_pad) lanes, lane = row n_pad
+ col, counters 2 lane and 2 lane + 1 at step ``step_offset + s``, the cos
branch of Box-Muller only (``lj_md_fused.py:80-124``; the JAX module's
docstring still names the TPU's hardware generator).  Inside a segment the
velocity is w = v - dt/2 F/m, the velocity before the trailing half-kick, so
that one full kick a step equals the scan integrator's B-O-B composition;
``run`` converts on the way in and out (:287-303).
"""

from __future__ import annotations

import torch

from . import _build
from .lj_cull import _MASK32, _TWO_PI, counter_uniforms, lane_counters
from .lj_dense import lj_rows_plain


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def fused_update_plain(x, w, F, minv, sigv, box_diag, seed: int, step: int,
                       dt: float, a: float, b: float):
    """The update of one fused step (the TPU kernel's ``t == 0`` program):
    returns the new (x, w)."""
    v = w + dt * F * minv
    x = x + (dt * 0.5) * v
    u1, u2 = counter_uniforms(*lane_counters(seed, step, tuple(x.shape),
                                             x.device))
    noise = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)
    v = a * v + b * sigv * noise
    x = x + (dt * 0.5) * v
    L = box_diag.reshape(3, 1)
    return x - torch.floor(x / L) * L, v


def fused_md_plain(x3, w3, f3, box_diag, minv, sigv, seed: int,
                   step_offset: int, n: int, n_steps: int, sigma: float,
                   epsilon: float, cutoff: float, dt: float, a: float,
                   b: float):
    """Plain version of K9: ``n_steps`` fused steps from (x, w, F), each the
    update and the dense force (minimum image by division, exact
    reciprocal).  Returns the new (x, w, F)."""
    x, w, F = x3, w3, f3
    for s in range(n_steps):
        x, w = fused_update_plain(x, w, F, minv, sigv, box_diag, seed,
                                  step_offset + s, dt, a, b)
        F, _ = lj_rows_plain(x, x, box_diag, 0, n, sigma, epsilon, cutoff,
                             with_energy=False, divide=True)
    return x, w, F


def fused_md(x3, w3, f3, box_diag, minv, sigv, seed: int, step_offset: int,
             n: int, n_steps: int, sigma: float, epsilon: float,
             cutoff: float, dt: float, a: float, b: float):
    """K9: ``n_steps`` fused BAOAB steps from (x3, w3, f3), each (3, n_pad)
    f32 with w the velocity before the trailing half-kick; ``minv`` and
    ``sigv`` (1, n_pad).  Returns new (x, w, F) tensors.  On a CUDA tensor
    one launch sequence of ``csrc/lj_md_fused.cu``, counted as
    ``fused_md``."""
    if x3.device.type == "cpu":
        return fused_md_plain(x3, w3, f3, box_diag, minv, sigv, seed,
                              step_offset, n, n_steps, sigma, epsilon,
                              cutoff, dt, a, b)
    _build.check_cuda(x3, "x3")
    dev = x3.device
    n_pad = x3.shape[1]
    for name, t, shape in (("x3", x3, (3, n_pad)), ("w3", w3, (3, n_pad)),
                           ("f3", f3, (3, n_pad)), ("minv", minv, (1, n_pad)),
                           ("sigv", sigv, (1, n_pad))):
        _build.require(t, name, shape, torch.float32, dev)
    _build.require(box_diag, "box_diag", None, torch.float32, dev)
    if box_diag.numel() != 3 or n_pad % 32 or not 0 < n <= n_pad:
        raise ValueError(
            f"fused_md: needs 3 box lengths and n_pad % 32 == 0 with "
            f"0 < n <= n_pad (got {box_diag.numel()}, n_pad={n_pad}, n={n})")
    x, w, F = x3.clone(), w3.clone(), f3.clone()
    sigma2 = sigma * sigma
    _build.launch(
        "fused_md", "chiron_fused_md",
        x.data_ptr(), w.data_ptr(), F.data_ptr(), minv.data_ptr(),
        sigv.data_ptr(), box_diag.data_ptr(), seed & _MASK32,
        step_offset & _MASK32, n_steps, n, n_pad, dt, dt * 0.5, a, b, sigma2,
        24.0 * epsilon, cutoff * cutoff, 1e-4 * sigma2, _build.stream_of(x),
    )
    return x, w, F


class FusedLJMD:
    """S-step fused BAOAB Langevin segments on the dense LJ force
    (``lj_md_fused.py:242``).

    >>> md = FusedLJMD(n, sigma, eps, cutoff, masses, dt, gamma, kT)
    >>> x3, v3, f3 = md.run(x3, v3, f3, box_diag, seed=1, n_steps=1000)
    >>> # continue the same noise stream in the next segment:
    >>> x3, v3, f3 = md.run(x3, v3, f3, box_diag, seed=1, n_steps=1000,
    ...                     step_offset=1000)

    ``n_pad`` is n rounded up to ``tm``, as the JAX class has it in
    interpret mode (on the TPU it raises ``tm`` to 128 first).
    """

    def __init__(self, n, sigma, epsilon, cutoff, masses_lane, dt, gamma, kT,
                 tm: int = 512, *, device="cuda"):
        self.n = n
        self.sigma, self.epsilon, self.cutoff = (
            float(sigma), float(epsilon), float(cutoff)
        )
        self.dt = float(dt)
        # f32 coefficients, computed as the JAX class computes them
        f32 = torch.float32
        self.a = float(torch.exp(torch.tensor(-gamma * dt, dtype=f32)))
        self.b = float(torch.sqrt(
            1.0 - torch.exp(torch.tensor(-2.0 * gamma * dt, dtype=f32))
        ))
        self.kT = float(kT)
        self.tm = tm
        self.n_pad = _round_up(n, tm)
        self.device = torch.device(device)
        m = torch.as_tensor(masses_lane, dtype=f32).reshape(1, -1)
        if m.shape[1] != self.n_pad:
            mm = torch.ones((1, self.n_pad), dtype=f32)
            mm[0, :m.shape[1]] = m[0]
            m = mm
        m = m.to(self.device)
        self.minv = 1.0 / m
        self.sigv = torch.sqrt(self.kT / m)

    def run(self, x3, v3, f3, box_diag, seed: int, n_steps: int,
            step_offset: int = 0):
        """Advance ``n_steps``; returns (x3, v3, f3) in the BAOAB convention.

        ``step_offset`` advances the per-step noise counter, so that
        consecutive segments with one seed draw fresh noise (pass the
        cumulative step count).
        """
        half_dt = 0.5 * self.dt
        box = box_diag.reshape(3).contiguous()
        w_in = v3 - half_dt * f3 * self.minv
        x, w, F = fused_md(x3, w_in, f3, box, self.minv, self.sigv, seed,
                           step_offset, self.n, n_steps, self.sigma,
                           self.epsilon, self.cutoff, self.dt, self.a, self.b)
        return x, w + half_dt * F * self.minv, F
