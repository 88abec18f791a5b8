"""Halo-strip LJ engine (port of ``chiron_tpu/ops/lj_strip.py``).

With particles sorted by x, every in-cutoff partner of row tile i lies
within H forward ranks, so a row's interaction set is one contiguous strip
of the sorted array.  The cyclic wrap is unrolled into a rank-space halo:
the (3, n_pad + H) extended array repeats ranks 0..H-1 with x shifted by
+Lx, so x takes no minimum image.  Padding lanes carry the ``_PAD_X``
sentinel on every axis, which puts every pair with padding beyond the
cutoff.

x is continuous between sorts: the steps of a segment do not wrap it (a
particle wrapped across x = 0 or x = L mid-segment would keep its rank at
the other end and meet none of its partners until the next sort, as in the
JAX package, whose steps wrap x), and ``StripLJMD.run_segment`` wraps it
once after the segment's last force, so a carry holds x in [0, L) as the
JAX carry does.  y and z stay wrapped every step (the pass takes their
minimum image).

Kernel K7 (``csrc/lj_strip.cu``) replaces ``strip_md_raw``,
``strip_force_raw`` and ``strip_force_energy_raw``: ``strip_baoab_`` is a
step's BAOAB phase with the halo refresh, ``strip_force`` and
``strip_force_energy`` the strip force pass with the halo fold, one launch
in which each particle meets every pair it is in from its own end (its
strip ahead as a row, the rows whose strips cover it as a column), so no
column reactions are gathered; ``strip_wrap`` the wrap of the live x with
the halo refresh, once a segment.  On a CPU tensor each runs its plain
version (``strip_baoab_plain``, ``strip_force_plain``,
``strip_wrap_plain``).
"""

from __future__ import annotations

import torch

from . import _build
from .diff import energy_with_force_gradient
from .lj_cull import (_MASK32, _TWO_PI, counter_uniforms, lane_counters,
                      sort_by_key)
from .lj_dense import _round_up

_PAD_X = 1.0e18  # padding-slot sentinel: any pair with padding -> r2 ~ 1e36
_BIG = 1.0e18    # additive r2 mask for col <= row slots and beyond the cutoff
# the kernel's blocks (csrc/lj_strip.cu) own STRIP_ROWS particles each and
# leave one energy partial each
STRIP_ROWS = 32
# the strip width tm + H is a whole number of these once it exceeds one
# (lj_strip.py:64): part of the function, since H sets the pair set
_SUBW = 2048


def sort_by_key_strip(pos3, payloads):
    """Stable sort of the (3, n_pad) layout and each payload by x
    (``lj_strip.py:53``); the padding must already hold ``_PAD_X``."""
    return sort_by_key(pos3[0], pos3, payloads)


def strip_counters(seed: int, step: int, n_pad: int, device="cpu"):
    """The counters of every (3, n_pad) lane, lane = axis n_pad + col
    (``lj_strip.py:215-237``)."""
    return lane_counters(seed, step, (3, n_pad), device)


def strip_noise_plain(seed: int, step: int, n_pad: int, device="cpu"):
    """The (3, n_pad) standard-normal noise of one strip step: one
    Box-Muller draw a lane, its cos branch only (``lj_strip.py:238-247``)."""
    u1, u2 = counter_uniforms(*strip_counters(seed, step, n_pad, device))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def strip_baoab_plain(xe, w, F, minv, sigv, box_diag, seed: int, step: int,
                      n: int, H: int, dt: float, a: float, b: float):
    """Plain version of one step's BAOAB phase (``lj_strip.py:209-265``):
    merged kick, drift, O step with the strip noise, drift, the wrap of the
    live lanes' y and z (x stays continuous until the segment's end), then
    the halo refresh.  Returns the new (xe, w)."""
    n_pad = w.shape[1]
    box = box_diag.reshape(3, 1)
    v = w + dt * F * minv
    x = xe[:, :n_pad] + (dt * 0.5) * v
    noise = strip_noise_plain(seed, step, n_pad, xe.device)
    v = a * v + b * sigv * noise
    x = x + (dt * 0.5) * v
    live = torch.arange(n_pad, device=xe.device) < n
    yz = torch.arange(3, device=xe.device)[:, None] > 0
    x = torch.where(live & yz, x - torch.floor(x / box) * box, x)
    halo = x[:, :H].clone()
    halo[0] = halo[0] + box[0, 0]
    return torch.cat([x, halo], dim=1), v


def strip_baoab_(xe, w, F, minv, sigv, box_diag, seed: int, step_offset,
                 s: int, n: int, H: int, dt: float, a: float, b: float):
    """One BAOAB phase in place on (xe, w) at step ``step_offset + s``
    (``step_offset`` a (1, 1) int32 device tensor)."""
    n_pad = w.shape[1]
    if xe.device.type == "cpu":
        step = int(step_offset.reshape(-1)[0]) + s
        xe_new, w_new = strip_baoab_plain(xe, w, F, minv, sigv, box_diag,
                                          seed, step, n, H, dt, a, b)
        xe.copy_(xe_new)
        w.copy_(w_new)
        return
    _build.check_cuda(xe, "xe")
    dev = xe.device
    for name, t, shape in (("xe", xe, (3, n_pad + H)), ("w", w, (3, n_pad)),
                           ("F", F, (3, n_pad)), ("minv", minv, (1, n_pad)),
                           ("sigv", sigv, (1, n_pad))):
        _build.require(t, name, shape, torch.float32, dev)
    _build.require(box_diag, "box_diag", None, torch.float32, dev)
    _build.require(step_offset, "step_offset", (1, 1), torch.int32, dev)
    if box_diag.numel() != 3 or not 0 < H < n_pad or not 0 < n <= n_pad:
        raise ValueError("strip baoab: 3 box lengths, 0 < H < n_pad, 0 < n <= n_pad")
    _build.launch(
        "strip_baoab", "chiron_strip_baoab",
        xe.data_ptr(), w.data_ptr(), F.data_ptr(), minv.data_ptr(),
        sigv.data_ptr(), box_diag.data_ptr(), step_offset.data_ptr(), s,
        seed & _MASK32, n, n_pad, H, dt, dt * 0.5, a, b, _build.stream_of(xe),
    )


def strip_wrap_plain(xe, box_diag, n: int, n_pad: int, H: int,
                     sentinel: bool = False):
    """Plain version of ``strip_wrap``: the (3, n_pad + H) array of the
    center of ``xe`` with the live lanes' x wrapped into [0, L) (y and z
    copied), the padding copied or, with ``sentinel``, set to ``_PAD_X``,
    and the halo the shifted center."""
    x = xe[:, :n_pad].clone()
    Lx = box_diag.reshape(3)[0]
    live = torch.arange(n_pad, device=xe.device) < n
    x[0] = torch.where(live, x[0] - torch.floor(x[0] / Lx) * Lx, x[0])
    if sentinel:
        x = torch.where(live, x, _PAD_X)
    halo = x[:, :H].clone()
    halo[0] = halo[0] + Lx
    return torch.cat([x, halo], dim=1)


def strip_wrap(xe, box_diag, n: int, n_pad: int, H: int,
               sentinel: bool = False, out=None):
    """Wrap the live lanes' x of ``xe``'s center into [0, L) and refresh a
    halo of H: returns ``out`` ((3, n_pad + H); ``xe`` itself to wrap in
    place, else a new array), the padding copied or, with ``sentinel``, set
    to ``_PAD_X``.  In place without ``sentinel`` only the live x lanes and
    their halo copies are written: y, z, their halo and the padding must
    already be as the plain version leaves them, as the steps keep them.
    On a CUDA tensor one launch, counted as ``strip_wrap``."""
    if xe.device.type == "cpu":
        new = strip_wrap_plain(xe, box_diag, n, n_pad, H, sentinel)
        if out is None:
            return new
        out.copy_(new)
        return out
    _build.check_cuda(xe, "xe")
    dev = xe.device
    _build.require(xe, "xe", None, torch.float32, dev)
    _build.require(box_diag, "box_diag", None, torch.float32, dev)
    if (xe.dim() != 2 or xe.shape[0] != 3 or xe.shape[1] < n_pad
            or box_diag.numel() != 3 or H < 0 or not 0 < n <= n_pad):
        raise ValueError("strip wrap: xe (3, >= n_pad), 3 box lengths, "
                         "H >= 0, 0 < n <= n_pad")
    if out is None:
        out = torch.empty((3, n_pad + H), dtype=torch.float32, device=dev)
    _build.require(out, "out", (3, n_pad + H), torch.float32, dev)
    if out.data_ptr() == xe.data_ptr() and xe.shape[1] != n_pad + H:
        raise ValueError("strip wrap: in place needs xe of (3, n_pad + H)")
    _build.launch(
        "strip_wrap", "chiron_strip_wrap", xe.data_ptr(), xe.shape[1],
        out.data_ptr(), box_diag.data_ptr(), n, n_pad, H, int(sentinel),
        _build.stream_of(xe),
    )
    return out


def strip_slots(n_pad: int, tm: int, H: int, device="cpu"):
    """The slots of the strip pass (``_strip_force_pass``): each row tile
    i's rows ``rid`` (n_pad / tm, tm) and extended columns ``cid``
    (n_pad / tm, tm + H), and the (tm, tm + H) mask ``tri`` of the leading
    tile's col <= row slots, which take no pair."""
    tiles = torch.arange(n_pad // tm, device=device)[:, None] * tm
    rid = tiles + torch.arange(tm, device=device)
    cid = tiles + torch.arange(tm + H, device=device)
    tri = (torch.arange(tm + H, device=device)[None, :]
           <= torch.arange(tm, device=device)[:, None])
    return rid, cid, tri


def strip_force_plain(xe, box_diag, n: int, tm: int, H: int, sigma: float,
                      epsilon: float, cutoff: float, with_energy: bool = False):
    """Plain version of the strip force pass and fold
    (``_strip_force_pass``, ``lj_strip.py:69``, and :273-280).

    Row tile i is paired with the extended columns [i tm, i tm + tm + H);
    y and z take the minimum image by floor(d/L + 1/2), x none; the leading
    tile's col <= row slots and the pairs beyond the cutoff get r^2 + 1e18,
    so their terms underflow to 0; r^2 is clamped at 1e-4 sigma^2 and the
    reciprocal is exact.  The energy counts a slot only where r^2 > 0
    before the clamp (padding against padding has r^2 == 0).  The halo's
    reactions fold onto ranks 0..H-1.  Returns ((3, n_pad) force, energy or
    None), the energy summed in float64.
    """
    dev = xe.device
    n_ext = xe.shape[1]
    n_pad = n_ext - H
    sigma2 = sigma * sigma
    box = box_diag.reshape(3)
    Ly, Lz = box[1], box[2]
    iLy, iLz = 1.0 / Ly, 1.0 / Lz
    rid, cid, tri = strip_slots(n_pad, tm, H, dev)
    xi = xe[:, rid][..., None]        # (3, nr, tm, 1)
    xj = xe[:, cid][:, :, None, :]    # (3, nr, 1, tm + H)
    dx = xi[0] - xj[0]
    dy = xi[1] - xj[1]
    dy = dy - Ly * torch.floor(dy * iLy + 0.5)
    dz = xi[2] - xj[2]
    dz = dz - Lz * torch.floor(dz * iLz + 0.5)
    r2 = dx * dx + dy * dy + dz * dz
    r2 = r2 + torch.where(tri, _BIG, 0.0)
    r2 = r2 + torch.where(r2 < cutoff * cutoff, 0.0, _BIG)
    pair_ok = r2 > 0.0
    inv = 1.0 / torch.clamp_min(r2, 1e-4 * sigma2)
    i2 = sigma2 * inv
    i6 = i2 * i2 * i2
    coef = (2.0 * (i6 * i6) - i6) * inv
    fext = torch.zeros((3, n_ext), dtype=xe.dtype, device=dev)
    for a, d in enumerate((dx, dy, dz)):
        t = coef * d
        fext[a].index_add_(0, rid.reshape(-1), t.sum(dim=2).reshape(-1))
        fext[a].index_add_(0, cid.reshape(-1), -t.sum(dim=1).reshape(-1))
    F = fext[:, :n_pad].clone()
    F[:, :H] += fext[:, n_pad:]
    F = (24.0 * epsilon) * F
    if not with_energy:
        return F, None
    zero = torch.zeros((), dtype=xe.dtype, device=dev)
    e = torch.sum(torch.where(pair_ok, i6 * i6 - i6, zero), dtype=torch.float64)
    return F, ((4.0 * epsilon) * e).to(xe.dtype)


def check_strip_tiles(n_pad: int, tm: int, H: int):
    """Raise unless K7 takes row tile ``tm`` and halo ``H`` at ``n_pad``: tm
    16, 32, 64 or a multiple of 128 dividing n_pad, H > 0 (any width: the
    reference rounds it to whole ``_SUBW`` strips), n_pad a multiple of
    ``STRIP_ROWS`` and at least 2 (tm + H)."""
    if (not (tm in (16, 32, 64) or (tm > 0 and tm % 128 == 0)) or H <= 0
            or n_pad % tm or n_pad % STRIP_ROWS or n_pad < 2 * (tm + H)):
        raise ValueError(
            f"strip kernel takes tm in (16, 32, 64) or a multiple of 128 "
            f"dividing n_pad, H > 0, and n_pad a multiple of {STRIP_ROWS} "
            f"and >= 2 (tm + H) (got tm={tm}, H={H}, n_pad={n_pad})"
        )


def _strip_launch(kernel: str, xe, box_diag, n: int, tm: int, H: int,
                  sigma: float, epsilon: float, cutoff: float,
                  approx_recip: bool, with_energy: bool):
    """Check the inputs and launch ``csrc/lj_strip.cu``'s force pass,
    counted under ``kernel``.  Returns ((3, n_pad) force, () energy or
    None)."""
    _build.check_cuda(xe, "xe")
    dev = xe.device
    n_ext = xe.shape[1]
    n_pad = n_ext - H
    _build.require(xe, "xe", (3, n_ext), torch.float32)
    _build.require(box_diag, "box_diag", None, torch.float32, dev)
    check_strip_tiles(n_pad, tm, H)
    if box_diag.numel() != 3:
        raise ValueError("strip kernel takes 3 box lengths")
    f32 = dict(dtype=torch.float32, device=dev)
    F = torch.empty((3, n_pad), **f32)
    e_part = torch.empty(n_pad // STRIP_ROWS, **f32) if with_energy else None
    energy = torch.empty(1, **f32) if with_energy else None
    sigma2 = sigma * sigma
    _build.launch(
        kernel, "chiron_strip_force",
        xe.data_ptr(), box_diag.data_ptr(), F.data_ptr(),
        None if e_part is None else e_part.data_ptr(),
        None if energy is None else energy.data_ptr(),
        n_pad, tm, H, sigma2, cutoff * cutoff, 1e-4 * sigma2, 24.0 * epsilon,
        # each pair is met from both ends
        0.5 * 4.0 * epsilon, int(approx_recip), _build.stream_of(xe),
    )
    return F, (energy[0] if with_energy else None)


def strip_force(xe, box_diag, n: int, tm: int, H: int, sigma: float,
                epsilon: float, cutoff: float, approx_recip: bool = True):
    """K7's force (``strip_force_raw``, and the force phase of
    ``strip_md_raw``): the folded (3, n_pad) force of extended positions."""
    if xe.device.type == "cpu":
        return strip_force_plain(xe, box_diag, n, tm, H, sigma, epsilon,
                                 cutoff)[0]
    return _strip_launch("strip_force", xe, box_diag, n, tm, H, sigma,
                         epsilon, cutoff, approx_recip, False)[0]


def strip_force_energy(xe, box_diag, n: int, tm: int, H: int, sigma: float,
                       epsilon: float, cutoff: float):
    """K7's force and () energy in one pass (``strip_force_energy_raw``),
    with the exact reciprocal."""
    if xe.device.type == "cpu":
        return strip_force_plain(xe, box_diag, n, tm, H, sigma, epsilon,
                                 cutoff, with_energy=True)
    return _strip_launch("strip_force_energy", xe, box_diag, n, tm, H, sigma,
                         epsilon, cutoff, False, True)


class StripLJMD:
    """S-step BAOAB segments on the halo-strip force (``lj_strip.py:334``):
    half-kick convention w = v - dt/2 F/m inside, standard (x, v, F) at both
    ends.  The caller owns sorting, the halo width and the band checks
    (``runtime.make_strip_lj_runner``).  On the card ``tm`` is raised to at
    least 128, as on the TPU; on the CPU it is kept as given."""

    def __init__(self, n, sigma, epsilon, cutoff, masses_lane, dt, gamma, kT,
                 tm: int = 128, H: int = None, slack: float = 0.2, *,
                 device="cuda"):
        self.n = n
        self.sigma, self.epsilon, self.cutoff = (
            float(sigma), float(epsilon), float(cutoff)
        )
        self.dt = float(dt)
        f32 = torch.float32
        self.a = float(torch.exp(torch.tensor(-gamma * dt, dtype=f32)))
        self.b = float(torch.sqrt(
            1.0 - torch.exp(torch.tensor(-2.0 * gamma * dt, dtype=f32))
        ))
        self.kT = float(kT)
        self.slack = float(slack)
        self.device = torch.device(device)
        if self.device.type != "cpu":
            tm = max(tm, 128)
        self.tm = tm
        self.n_pad = _round_up(n, max(tm, 128))
        self.H = H  # set by the runner from the band width
        m = torch.ones((1, self.n_pad), dtype=f32)
        m[0, :n] = torch.as_tensor(masses_lane, dtype=f32).reshape(-1)[:n]
        m = m.to(self.device)
        self.minv = 1.0 / m
        self.sigv = torch.sqrt(self.kT / m)
        # the latch threshold, on the device once for every segment
        self.slack_t = torch.full((), self.slack, dtype=f32, device=self.device)

    def set_halo(self, H: int):
        """Fix the halo width: at least the band width, a multiple of tm,
        and the strip a whole number of ``_SUBW`` blocks once wider."""
        H = _round_up(H, self.tm)
        if self.tm + H > _SUBW:
            H = _round_up(self.tm + H, _SUBW) - self.tm
        if self.n_pad < 2 * (self.tm + H):
            raise ValueError(
                f"halo {H} too wide for n_pad={self.n_pad}: pairs would "
                "be double-counted across the wrap -- use LJDense for boxes "
                "this small"
            )
        self.H = H

    def extend(self, pos3_sorted, box_diag):
        """The (3, n_pad + H) extended array of sorted positions."""
        halo = pos3_sorted[:, :self.H].clone()
        halo[0] = halo[0] + box_diag.reshape(-1)[0]
        return torch.cat([pos3_sorted, halo], dim=1)

    def force(self, xe, box_diag, approx_recip: bool = True):
        """Folded (3, n_pad) force over extended positions."""
        return strip_force(xe, box_diag, self.n, self.tm, self.H, self.sigma,
                           self.epsilon, self.cutoff, approx_recip)

    def force_energy(self, xe, box_diag):
        """Force and () energy in one pass, exact reciprocal."""
        return strip_force_energy(xe, box_diag, self.n, self.tm, self.H,
                                  self.sigma, self.epsilon, self.cutoff)

    def energy_differentiable(self, pos3_sorted, box_diag):
        """Strip energy of the sorted CENTER positions (3, n_pad), the halo
        built inside; its autograd gradient is exactly ``-force`` of one
        exact pass (the halo width is constant data)."""
        return energy_with_force_gradient(
            lambda p: self.force_energy(self.extend(p, box_diag), box_diag),
            pos3_sorted)

    def run_segment(self, xe, v3, f3, box_diag, seed: int, step_offset,
                    n_steps: int, approx_recip: bool = True):
        """Advance ``n_steps`` from (xe, v3, f3) (K7's ``strip_md_raw``);
        ``step_offset`` is the (1, 1) int32 step counter of the noise
        stream.  x stays continuous over the steps and is wrapped into
        [0, L) after the last force, with the halo refreshed (one
        ``strip_wrap``, in place).  Returns new (xe, v, F) tensors."""
        if not torch.is_tensor(step_offset):
            step_offset = torch.tensor([[step_offset]], dtype=torch.int32,
                                       device=xe.device)
        half_dt = 0.5 * self.dt
        box = box_diag.reshape(-1).contiguous()
        w = v3 - half_dt * f3 * self.minv
        xe = xe.clone()
        F = f3
        for s in range(n_steps):
            strip_baoab_(xe, w, F, self.minv, self.sigv, box, seed,
                         step_offset, s, self.n, self.H, self.dt, self.a,
                         self.b)
            F = self.force(xe, box, approx_recip)
        strip_wrap(xe, box, self.n, self.n_pad, self.H, out=xe)
        return xe, w + half_dt * F * self.minv, F

