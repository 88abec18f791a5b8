"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a): they build the kernels
of chiron_tpu_torch/csrc and skip where no CUDA device is visible.  On the
GPU machine run them with

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q

They import no jax, so they run where jax is not installed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chiron_tpu_torch import units
from chiron_tpu_torch.ops import _build
from chiron_tpu_torch.ops import lj_cull as lc
from chiron_tpu_torch.ops.lj_dense import lj_dense_force_energy, lj_dense_plain
from chiron_tpu_torch.runtime import (
    make_culled_lj_runner,
    make_culled_npt_lj_runner,
    make_npt_lj_runner,
)
from chiron_tpu_torch.testsystems import LennardJonesFluid

pytestmark = pytest.mark.gpu

N = 2000  # the smallest bench-density fluid that takes 128 x 256 tiles


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def carry(cuda):
    fluid = LennardJonesFluid(nparticles=N, reduced_density=0.8)
    md = units.md_unit_system
    rng = np.random.default_rng(1)
    box = fluid.box_vectors.value_in_unit_system(md)
    pos = fluid.positions.value_in_unit_system(md)
    pos = ((pos + rng.normal(0, 0.01, pos.shape)) % box[0, 0]).astype(np.float32)
    runner = make_culled_lj_runner(
        potential=fluid.potential, n_particles=N, topology=fluid.topology,
        temperature=120.0 * units.kelvin, slack=0.15, segment_steps=8,
        device=cuda)
    c0 = runner.init(pos, box, seed=2)
    return runner, c0, fluid.potential


def test_dense_kernel_matches_plain(carry):
    _, c0, pot = carry
    x, box = c0.x, c0.box_diag
    args = (N, pot.sigma, pot.epsilon, pot.cutoff)
    Fp, Ep = lj_dense_plain(x, box, *args)
    Fk, Ek = lj_dense_force_energy(x, box, *args, approx_recip=False)
    Fa, Ea = lj_dense_force_energy(x, box, *args, approx_recip=True,
                                   with_energy=False)
    scale = float(Fp.abs().max())
    assert float((Fk - Fp).abs().max()) / scale < 1e-5
    assert float((Fa - Fp).abs().max()) / scale < 1e-4
    assert abs(float(Ek) - float(Ep)) / abs(float(Ep)) < 1e-5
    assert Ea is None
    assert float(Fk[:, N:].abs().max()) == 0.0


def test_culled_force_kernel_matches_plain(carry):
    runner, c0, pot = carry
    md = runner.md
    args = (c0.x, c0.box_diag, c0.pairs, N, md.tm, md.tn, pot.sigma,
            pot.epsilon, pot.cutoff)
    Fp, Ep = lc.row_force_pass_plain(*args, with_energy=True)
    Fk, Ek = lc.culled_force_pass(*args, approx_recip=False, with_energy=True)
    err = (Fk - Fp)[:, :N].abs()
    scale = float(Fp.abs().max())
    assert float(err.max()) < 0.05
    assert float(torch.quantile(err.flatten(), 0.99)) / scale < 1e-5
    assert float(Fk[:, N:].abs().max()) == 0.0
    assert abs(float(Ek) - float(Ep)) / abs(float(Ep)) < 1e-5


def test_baoab_kernel_matches_plain(carry):
    runner, c0, _ = carry
    md = runner.md
    w = c0.v - (0.5 * md.dt) * c0.F * md.minv
    xk, wk, Fk = c0.x.clone(), w.clone(), c0.F.clone()
    step = torch.full((1, 1), 17, dtype=torch.int32, device=c0.x.device)
    lc.baoab_phase_(xk, wk, Fk, md.minv, md.sigv, c0.box_diag, 99, step, 2,
                    md.dt, md.a, md.b)
    xp, wp, Fp = lc.baoab_phase_plain(c0.x, w, c0.F, md.minv, md.sigv,
                                      c0.box_diag, 99, 19, md.dt, md.a, md.b)
    assert float((xk - xp).abs().max()) < 1e-5
    assert float((wk - wp).abs().max()) < 1e-4
    assert float(Fk.abs().max()) == 0.0 == float(Fp.abs().max())


def test_drift_kernel_matches_plain(carry):
    runner, c0, _ = carry
    c1 = runner.segment_fn(8)(c0)
    tripped = c1.x_anchor.clone()
    tripped[0, 3] += 0.1
    tripped[1, 9] += 0.1
    nan = c1.x.clone()
    nan[2, 4] = float("nan")
    for x, anchor in ((c1.x, c1.x_anchor), (c1.x, tripped), (nan, c1.x_anchor)):
        k = lc.tile_skin_drift_bad(x, anchor, N, 0.15, c0.box_diag)
        p = lc.tile_skin_drift_bad_plain(x, anchor, N, 0.15, c0.box_diag)
        assert bool(k) == bool(p)
    assert bool(lc.tile_skin_drift_bad(nan, c1.x_anchor, N, 0.15, c0.box_diag))


def test_segment_is_bitwise_repeatable_and_counted(carry):
    runner, c0, _ = carry
    _build.reset_launch_counts()
    a = runner.segment_fn(8)(c0)
    b = runner.segment_fn(8)(c0)
    for name in ("x", "v", "F", "overflowed"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    # each segment: one C call, which enqueues the BAOAB phase once, the
    # force pass 8 times (the gather's epilogue takes the other updates)
    # and the latch
    assert dict(_build.launches) == {"culled_md": 2, "baoab": 2,
                                     "culled_force": 16,
                                     "tile_skin_drift": 2}


def test_k5_force_energy_kernel_matches_plain(carry):
    runner, c0, pot = carry
    md = runner.md
    args = (c0.x, c0.box_diag, c0.pairs, N, md.tm, md.tn, pot.sigma,
            pot.epsilon, pot.cutoff)
    Fp, Ep = lc.row_force_pass_plain(*args, with_energy=True)
    _build.reset_launch_counts()
    Fk, Ek = lc.culled_force_energy(*args)
    assert dict(_build.launches) == {"culled_force_energy": 1}
    err = (Fk - Fp)[:, :N].abs()
    assert float(err.max()) < 0.05
    assert float(torch.quantile(err.flatten(), 0.99)) / float(Fp.abs().max()) < 1e-5
    assert abs(float(Ek) - float(Ep)) / abs(float(Ep)) < 1e-5
    # the differentiable surface: autograd gives the kernel's force
    pos = c0.x.clone().requires_grad_(True)
    md.energy_differentiable(pos, c0.box_diag, c0.pairs).backward()
    assert torch.equal(pos.grad, -Fk)


def test_exact_energy_mode_equals_k5_bitwise(carry):
    """K3's final_energy step (approximate force, with the energy): the
    force of a force-only pass and the energy of a K5 pass, bit for bit."""
    runner, c0, pot = carry
    md = runner.md
    args = (c0.x, c0.box_diag, c0.pairs, N, md.tm, md.tn, pot.sigma,
            pot.epsilon, pot.cutoff)
    F_mix, E_mix = lc.culled_force_pass(*args, approx_recip=True,
                                        with_energy=True)
    F_approx, _ = lc.culled_force_pass(*args, approx_recip=True)
    _, E_k5 = lc.culled_force_energy(*args)
    assert torch.equal(F_mix, F_approx)
    assert torch.equal(E_mix, E_k5)
    # and run_segment's carried energy is K5's on its final configuration
    x1, _, _, E_seg = md.run_segment(c0.x, c0.v, c0.F, c0.box_diag, c0.pairs,
                                     seed=3, step_offset=0, n_steps=4,
                                     final_energy=True)
    assert torch.equal(E_seg, md.force_energy(x1, c0.box_diag, c0.pairs)[1])


def test_budgeted_drift_kernel_matches_plain(carry):
    runner, c0, _ = carry
    c1 = runner.segment_fn(8)(c0)
    top2 = float(lc.skin_drift_top2_plain(c1.x, c1.x_anchor, N, c0.box_diag))
    nan = c1.x.clone()
    nan[0, 7] = float("nan")
    for x, scale, expect in ((c1.x, 0.999, True), (c1.x, 1.001, False),
                             (nan, 1.001, True)):
        budget = torch.tensor(top2 * scale, device=c0.x.device)
        k = lc.tile_skin_drift_bad(x, c1.x_anchor, N, budget, c0.box_diag)
        p = lc.tile_skin_drift_bad_plain(x, c1.x_anchor, N, budget,
                                         c0.box_diag)
        assert bool(k) == bool(p) == expect, (scale, expect)


def _same_bits(a, b):
    """Equal bit for bit, where a NaN equals a NaN in the same place."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.mark.parametrize("tm", [64, 128, 256])
@pytest.mark.parametrize("mode", ["nvt", "npt"])
def test_culled_segment_equals_the_stepwise_sequence(cuda, tm, mode):
    """K3's segment in one C call against the step-by-step sequence of the
    same kernels (baoab_phase_ and culled_force_pass S times, then
    tile_skin_drift_bad) from the same inputs: x, v, F, the flag and the
    energy bit for bit at S = 1, 2 and 40, with either reciprocal, and a
    NaN coordinate latching both."""
    runner, c0, _ = _culled_on_card(cuda, 4000, tm)
    md = runner.md
    if mode == "nvt":
        kw = dict(drift_slack=md.slack_t)
    else:
        kw = dict(final_energy=True, drift_anchor=c0.x * 1.0001,
                  drift_budget=torch.tensor(0.1, device=cuda))
    ws = lc.SegmentWorkspace(md, runner.capacity)
    nan = c0.x.clone()
    nan[2, 11] = float("nan")
    for x3, steps, approx in ((c0.x, 1, True), (c0.x, 2, False),
                              (c0.x, 40, True), (c0.x, 40, False),
                              (nan, 40, True)):
        args = (x3, c0.v, c0.F, c0.box_diag, c0.pairs, 5, c0.step + 3, steps,
                approx)
        one = md.run_segment(*args, workspace=ws, **kw)
        seq = md.run_segment_stepwise(*args, **kw)
        assert len(one) == len(seq) == (5 if mode == "npt" else 4)
        for a, b in zip(one, seq):
            assert _same_bits(a, b), (steps, approx)
        if x3 is nan:
            assert bool(one[3])


def test_culled_segment_at_an_n_pad_off_the_runners_grain(cuda):
    """An engine that pads only to lcm(tm, tn) (tm = tn = 64 at N=4000:
    n_pad 4032, not a multiple of 128, as the runners pad): its one-call
    segment is still the step-by-step sequence bit for bit, in NVT and in
    NpT with the final energy."""
    runner, c0, pot = _culled_on_card(cuda, 4000, 64, tn=64)
    md = runner.md
    n_pad = 4032
    eng = lc.CulledLJMD(
        4000, pot.sigma, pot.epsilon, pot.cutoff,
        masses_lane=(1.0 / md.minv[0, :4000]).cpu().numpy(), dt=md.dt,
        gamma=-np.log(md.a) / md.dt, kT=md.kT, tm=64, tn=64,
        slack=md.slack, device=cuda)
    assert eng.n_pad == n_pad
    x, v, F = (t[:, :n_pad].contiguous() for t in (c0.x, c0.v, c0.F))
    pairs = eng.build_pairs(x, c0.box_diag, runner.capacity)
    assert int(pairs.count) > 0
    ws = lc.SegmentWorkspace(eng, runner.capacity)
    budget = torch.tensor(0.1, device=cuda)
    for steps, kw in ((1, dict(drift_slack=eng.slack_t)),
                      (40, dict(drift_slack=eng.slack_t)),
                      (40, dict(final_energy=True, drift_anchor=x,
                                drift_budget=budget))):
        args = (x, v, F, c0.box_diag, pairs, 5, c0.step, steps)
        one = eng.run_segment(*args, workspace=ws, **kw)
        seq = eng.run_segment_stepwise(*args, **kw)
        assert len(one) == len(seq)
        for a, b in zip(one, seq):
            assert _same_bits(a, b), steps


def test_culled_segment_never_waits_and_reuses_its_workspace(carry):
    """The segment's one call queues device work only (under the sync
    debug mode any host synchronisation raises), in NVT and NpT, and a
    repeated call on one workspace is bitwise equal."""
    runner, c0, _ = carry
    md = runner.md
    ws = lc.SegmentWorkspace(md, runner.capacity)
    budget = torch.tensor(0.1, device=c0.x.device)
    args = (c0.x, c0.v, c0.F, c0.box_diag, c0.pairs, 5, c0.step, 8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = md.run_segment(*args, drift_slack=md.slack_t, workspace=ws)
        b = md.run_segment(*args, final_energy=True, drift_anchor=c0.x,
                           drift_budget=budget, workspace=ws)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    again = md.run_segment(*args, drift_slack=md.slack_t, workspace=ws)
    assert all(torch.equal(p, q) for p, q in zip(a, again))
    assert torch.equal(a[0], b[0]) and torch.isfinite(b[4])


def _drift_pair(n, n_pad, device, seed=5):
    """Entry positions and positions a segment later at N = n: small moves,
    two lanes tied at the largest drift, padding at 3e38."""
    rng = np.random.default_rng(seed)
    L = 17.0
    anchor = rng.uniform(0, L, (3, n_pad)).astype(np.float32)
    x = ((anchor + rng.normal(0, 0.02, (3, n_pad))) % L).astype(np.float32)
    anchor[:, n - 1] = anchor[:, 3]
    x[:, 3] = x[:, n - 1] = (anchor[:, 3] + 0.2) % L
    x[:, n:] = anchor[:, n:] = 3.0e38
    box = torch.full((1, 3), L, device=device)
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(anchor).to(device), box)


@pytest.mark.parametrize("n,n_pad", [(4000, 4096), (100_000, 100_096)])
def test_latch_kernel_is_the_plain_latch_bit_for_bit(cuda, n, n_pad):
    """The one-pass latch (several blocks and a ticket at N=100,000)
    against the plain version: its top-2 sum is the plain one, so the flag
    holds at that sum and latches one ulp under it; ties count twice; a NaN
    in a live lane latches and one in a padding lane does not."""
    x, anchor, box = _drift_pair(n, n_pad, cuda)
    top2 = lc.skin_drift_top2_plain(x, anchor, n, box)
    d = lc.skin_drift_plain(x, anchor, n, box)
    assert float(top2) == 2 * float(d.max())  # the tie
    scratch = lc.LatchScratch(n_pad, cuda)
    below = torch.nextafter(top2, torch.zeros_like(top2))
    for thr, expect in ((top2, False), (below, True), (0.05, True),
                        (1.0, False)):
        for _ in range(2):  # the ticket is ready again after each launch
            k = lc.tile_skin_drift_bad(x, anchor, n, thr, box, scratch)
            p = lc.tile_skin_drift_bad_plain(x, anchor, n, thr, box)
            assert bool(k) == bool(p) == expect, thr
    for lane, expect in ((n // 2, True), (n + 1, False)):
        bad = x.clone()
        bad[1, lane] = float("nan")
        k = lc.tile_skin_drift_bad(bad, anchor, n, 1.0, box, scratch)
        assert bool(k) == bool(lc.tile_skin_drift_bad_plain(
            bad, anchor, n, 1.0, box)) == expect, lane


def test_npt_runners_never_wait_for_the_device(carry):
    """Between init and check the NpT runners queue device work only:
    under the sync debug mode, any host synchronisation raises."""
    runner, c0, pot = carry
    kw = dict(potential=pot, n_particles=N, temperature=120.0 * units.kelvin,
              pressure=100.0 * units.atmosphere, barostat_interval=25,
              device=c0.x.device)
    npt = make_culled_npt_lj_runner(slack=0.2, segment_steps=50, **kw)
    dense = make_npt_lj_runner(**kw)
    pos = runner.positions(c0)
    st, ds = npt.init(pos, c0.box_diag, seed=4), dense.init(pos, c0.box_diag)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = npt.run(st, 50)
        ds = dense.run(ds, 25)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    npt.check(st)
    dense.check(ds)
    assert int(st.n_proposed) == 2 and int(ds.n_proposed) == 1


def test_kernel_wrappers_refuse_bad_inputs(carry):
    _, c0, pot = carry
    with pytest.raises(ValueError, match="contiguous"):
        lj_dense_force_energy(c0.x.t().contiguous().t(), c0.box_diag, N,
                              pot.sigma, pot.epsilon, pot.cutoff)
    with pytest.raises(ValueError, match="dtype"):
        lj_dense_force_energy(c0.x.double(), c0.box_diag, N, pot.sigma,
                              pot.epsilon, pot.cutoff)


def _jittered_fluid(n, seed=1):
    fluid = LennardJonesFluid(nparticles=n, reduced_density=0.8)
    md = units.md_unit_system
    rng = np.random.default_rng(seed)
    box = fluid.box_vectors.value_in_unit_system(md)
    pos = fluid.positions.value_in_unit_system(md)
    pos = ((pos + rng.normal(0, 0.01, pos.shape)) % box[0, 0]).astype(np.float32)
    return fluid, pos, box


@pytest.fixture(scope="module")
def band_state(cuda):
    from chiron_tpu_torch.runtime import make_band_lj_runner

    n = 20000
    fluid, pos, box = _jittered_fluid(n)
    runner = make_band_lj_runner(
        fluid.potential, n_particles=n, topology=fluid.topology,
        temperature=120.0 * units.kelvin, device=cuda)
    return runner, runner.init(pos, box, seed=2), fluid.potential


def test_band_kernel_matches_plain(band_state):
    from chiron_tpu_torch.ops import lj_band as lb

    runner, st, pot = band_state
    band = runner.band
    args = (st.x, st.box_diag, band.n, band.w, pot.sigma, pot.epsilon,
            pot.cutoff, band.tm)
    Fp, Ep = lb.band_force_plain(*args, with_energy=True)
    _build.reset_launch_counts()
    Fk, Ek = lb.band_force_energy(*args)
    Fa = lb.band_force(*args, approx_recip=True)
    assert dict(_build.launches) == {"band_force_energy": 1, "band_force": 1}
    scale = float(Fp.abs().max())
    err = (Fk - Fp)[:, :band.n].abs()
    assert float(err.max()) < 0.05
    assert float(torch.quantile(err.flatten()[::7], 0.99)) / scale < 1e-5
    assert float((Fa - Fk).abs().max()) / scale < 1e-4
    assert float(Fk[:, band.n:].abs().max()) == 0.0
    assert abs(float(Ek) - float(Ep)) / abs(float(Ep)) < 1e-5
    _, E1 = lj_dense_force_energy(st.x, st.box_diag, band.n, pot.sigma,
                                  pot.epsilon, pot.cutoff)
    assert abs(float(Ek) - float(E1)) / abs(float(E1)) < 1e-5
    # bitwise repeatable, and the differentiable surface
    assert torch.equal(lb.band_force(*args, approx_recip=True), Fa)
    assert torch.equal(lb.band_force_energy(*args)[1], Ek)
    pos = st.x.clone().requires_grad_(True)
    band.energy_differentiable(pos, st.box_diag).backward()
    assert torch.equal(pos.grad, -Fk)


def test_band_step_is_bitwise_repeatable_and_never_waits(band_state):
    runner, st, _ = band_state
    noise = torch.randn(st.x.shape, device=st.x.device,
                        generator=torch.Generator(st.x.device).manual_seed(5))
    # an offset anchor forces the re-sort on the device-chosen path
    stale = dataclasses.replace(st, ref_x=st.ref_x - 1.0)
    for s in (st, stale):
        a, b = runner.step(s, noise), runner.step(s, noise)
        for name in ("x", "v", "F", "ref_x", "overflowed"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert not torch.equal(runner.step(stale, noise).ref_x, st.ref_x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = runner.run(st, 5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    runner.check(out)


@pytest.fixture(scope="module")
def strip_state(cuda):
    from chiron_tpu_torch.runtime import make_strip_lj_runner

    n = 4000
    fluid, pos, box = _jittered_fluid(n)
    runner = make_strip_lj_runner(
        potential=fluid.potential, n_particles=n, topology=fluid.topology,
        temperature=120.0 * units.kelvin, device=cuda)
    return runner, runner.init(pos, box, seed=2), fluid.potential


def test_strip_kernels_match_plain(strip_state):
    from chiron_tpu_torch.ops import lj_strip as ls

    runner, st, pot = strip_state
    md = runner.md
    n, n_pad, H = md.n, md.n_pad, md.H
    args = (st.x, st.box_diag, n, md.tm, H, pot.sigma, pot.epsilon, pot.cutoff)
    Fp, Ep = ls.strip_force_plain(*args, with_energy=True)
    _build.reset_launch_counts()
    Fk, Ek = ls.strip_force_energy(*args)
    Fa = ls.strip_force(*args, approx_recip=True)
    assert dict(_build.launches) == {"strip_force_energy": 1, "strip_force": 1}
    scale = float(Fp.abs().max())
    err = (Fk - Fp)[:, :n].abs()
    assert float(err.max()) < 0.05
    assert float(torch.quantile(err.flatten(), 0.99)) / scale < 1e-5
    assert float((Fa - Fk).abs().max()) / scale < 1e-4
    assert float(Fk[:, n:].abs().max()) == 0.0
    assert abs(float(Ek) - float(Ep)) / abs(float(Ep)) < 1e-5
    # one BAOAB phase with the halo refresh
    w = st.v - (0.5 * md.dt) * st.F * md.minv
    xk, wk = st.x.clone(), w.clone()
    step = torch.full((1, 1), 40, dtype=torch.int32, device=st.x.device)
    box = st.box_diag.reshape(-1)
    ls.strip_baoab_(xk, wk, st.F, md.minv, md.sigv, box, 77, step, 3, n, H,
                    md.dt, md.a, md.b)
    xp, wp = ls.strip_baoab_plain(st.x, w, st.F, md.minv, md.sigv, box, 77,
                                  43, n, H, md.dt, md.a, md.b)
    assert float((xk - xp)[:, :n].abs().max()) < 1e-5
    assert float((wk - wp).abs().max()) < 1e-4
    assert float((xk[0, n_pad:] - (xk[0, :H] + box[0])).abs().max()) < 1e-4
    assert torch.equal(xk[1:, n_pad:], xk[1:, :H])


def test_strip_segment_is_bitwise_repeatable_and_counted(strip_state):
    runner, st, _ = strip_state
    _build.reset_launch_counts()
    a, b = runner.segment(st, 8), runner.segment(st, 8)
    for name in ("x", "v", "F", "step", "overflowed"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert dict(_build.launches) == {"strip_baoab": 16, "strip_force": 16,
                                     "tile_skin_drift": 2}
    runner.check(a)


@pytest.fixture(scope="module")
def spatial_state(cuda):
    """The banded spatial runner on a one-process mesh at N=20,000 (tm 256,
    n_pad 20,224: four slabs of 5,056 rows), and its first state."""
    from chiron_tpu_torch.parallel import (make_replica_mesh,
                                           make_spatial_band_lj_runner)

    n = 20000
    fluid, pos, box = _jittered_fluid(n)
    mesh = make_replica_mesh(axis_name="spatial", device=cuda)
    kw = dict(potential=fluid.potential, n_particles=n,
              temperature=120.0 * units.kelvin,
              timestep=2.0 * units.femtoseconds, topology=fluid.topology)
    runner = make_spatial_band_lj_runner(mesh, **kw)
    return runner, runner.init(pos, box, seed=2), kw


def _p99(diff, scale):
    return float(torch.quantile(diff.flatten()[::7], 0.99)) / scale


def test_row_slab_kernel_matches_plain_and_slabs_concatenate(spatial_state):
    from chiron_tpu_torch.parallel import spatial as sp

    runner, st, kw = spatial_state
    pot, n, n_pad = kw["potential"], runner.n, runner.n_pad
    x, box = st.x, st.box_diag
    args = (n, pot.sigma, pot.epsilon, pot.cutoff)
    r = n_pad // 4
    Fp, Ep = sp.row_slab_force_plain(x, x, box, 0, *args, with_energy=True)
    _build.reset_launch_counts()
    F1, E1 = sp.row_slab_force(x, x, box, 0, *args, with_energy=True)
    Ff, _ = sp.row_slab_force(x, x, box, 0, *args)
    slabs = [sp.row_slab_force(x[:, k * r:(k + 1) * r].contiguous(), x, box,
                               k * r, *args, with_energy=True)
             for k in range(4)]
    slabs_f = [sp.row_slab_force(x[:, k * r:(k + 1) * r].contiguous(), x,
                                 box, k * r, *args)[0] for k in range(4)]
    assert dict(_build.launches) == {"row_slab_force_energy": 5,
                                     "row_slab_force": 5}
    scale = float(Fp.abs().max())
    for F in (F1, Ff):
        diff = (F - Fp).abs()
        assert float(diff.max()) / scale < 1e-5 and _p99(diff, scale) < 1e-5
    assert float(F1[:, n:].abs().max()) == 0.0
    assert abs(float(E1) - float(Ep)) / abs(float(Ep)) < 1e-5
    assert torch.equal(torch.cat([s[0] for s in slabs], dim=1), F1)
    assert torch.equal(torch.cat(slabs_f, dim=1), Ff)
    E4 = sum(float(s[1]) for s in slabs)
    assert abs(E4 - float(E1)) / abs(float(E1)) < 1e-6
    # and one slab's energy against its plain version (the padded slab)
    _, Ep3 = sp.row_slab_force_plain(x[:, 3 * r:], x, box, 3 * r, *args,
                                     with_energy=True)
    assert abs(float(slabs[3][1]) - float(Ep3)) / abs(float(Ep3)) < 1e-5


def test_row_band_kernel_matches_plain_and_slabs_concatenate(spatial_state):
    from chiron_tpu_torch.parallel import spatial as sp

    runner, st, kw = spatial_state
    pot, n, n_pad, w, tm = (kw["potential"], runner.n, runner.n_pad,
                            runner.w, runner.tm)
    x, box = st.x, st.box_diag
    args = (n, w)
    lj = (pot.sigma, pot.epsilon, pot.cutoff)
    r = n_pad // 4
    _build.reset_launch_counts()
    F1 = sp.row_band_force(x, box, 0, n_pad, *args, tm, *lj)
    slabs = [sp.row_band_force(x, box, k * r, r, *args, tm, *lj)
             for k in range(4)]
    assert dict(_build.launches) == {"row_band_force": 5}
    Fp = sp.row_band_force_plain(x, box, 0, n_pad, *args, *lj)
    scale = float(Fp.abs().max())
    diff = (F1 - Fp).abs()
    assert float(diff.max()) / scale < 1e-5 and _p99(diff, scale) < 1e-5
    assert torch.equal(torch.cat(slabs, dim=1), F1)
    assert torch.equal(st.F, F1)  # the runner's force at init
    # the band holds every pair within the cutoff: K2's force
    F2, _ = runner.op.force_energy_t(x, box)
    assert float((F1 - F2).abs().max()) / scale < 1e-5


def test_k2_and_the_sharded_force_on_the_card(spatial_state):
    from chiron_tpu_torch.parallel import make_replica_mesh, make_sharded_lj_force

    runner, st, kw = spatial_state
    pot, n = kw["potential"], runner.n
    x, box = st.x, st.box_diag
    _build.reset_launch_counts()
    F2, E2 = runner.op.force_energy_t(x, box)
    assert dict(_build.launches) == {"lj_dense_square": 1}
    Fp, Ep = lj_dense_plain(x, box, n, pot.sigma, pot.epsilon, pot.cutoff)
    scale = float(Fp.abs().max())
    assert float((F2 - Fp).abs().max()) / scale < 1e-5
    assert abs(float(E2) - float(Ep)) / abs(float(Ep)) < 1e-5
    f = make_sharded_lj_force(make_replica_mesh(device=x.device), n,
                              pot.sigma, pot.epsilon, pot.cutoff)
    assert f.n_pad == runner.n_pad
    F, E = f.force_energy(x, box)
    assert float((F - F2).abs().max()) / scale < 1e-5
    assert abs(float(E) - float(E2)) / abs(float(E2)) < 1e-5
    assert torch.equal(f(x, box), F)
    p = x.clone().requires_grad_(True)
    f.energy_differentiable(p, box).backward()
    assert torch.equal(p.grad, -F)


def test_spatial_runners_never_wait_and_repeat_bitwise(spatial_state):
    from chiron_tpu_torch.parallel import make_replica_mesh, make_spatial_lj_runner

    runner, st, kw = spatial_state
    dev = st.x.device
    dense = make_spatial_lj_runner(
        make_replica_mesh(axis_name="spatial", device=dev), **kw)
    ds = dense.init(runner.positions(st), st.box_diag, seed=5)
    noise = torch.randn((runner.segment_steps, 3, runner.n_pad), device=dev,
                        generator=torch.Generator(dev).manual_seed(6))
    a, b = runner.segment(st, noise), runner.segment(st, noise)
    for name in ("x", "v", "F", "overflowed"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    a, b = dense.step(ds, noise[0]), dense.step(ds, noise[0])
    assert torch.equal(a.x, b.x) and torch.equal(a.v, b.v)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bs = runner.run(st, 2 * runner.segment_steps)
        ds = dense.run(ds, 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    runner.check(bs)
    assert torch.isfinite(ds.x).all() and torch.isfinite(ds.v).all()


def test_spatial_band_segment_in_a_one_rank_nccl_group(spatial_state,
                                                       tmp_path):
    """The collectives on the card: a 1-rank NCCL group runs the gathers
    and reaches the group-free state bit for bit."""
    import torch.distributed as dist

    from chiron_tpu_torch.parallel import (distributed, make_replica_mesh,
                                           make_spatial_band_lj_runner)

    runner, st, kw = spatial_state
    dev = st.x.device
    noise = torch.randn((runner.segment_steps, 3, runner.n_pad), device=dev,
                        generator=torch.Generator(dev).manual_seed(7))
    alone = runner.segment(st, noise)
    pos = runner.positions(st)
    assert distributed.initialize_cluster(
        num_processes=1, process_id=0, device=dev,
        store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        mesh = make_replica_mesh(axis_name="spatial", device=dev)
        assert mesh.group is not None and mesh.size == 1
        grouped = make_spatial_band_lj_runner(mesh, **kw)
        g0 = grouped.init(pos, st.box_diag, seed=2)
        assert grouped.w == runner.w and torch.equal(g0.F, st.F)
        g1 = grouped.segment(g0, noise)
    finally:
        dist.destroy_process_group()
    for name in ("x", "v", "F", "overflowed"):
        assert torch.equal(getattr(g1, name), getattr(alone, name)), name


def test_fused_md_kernel_matches_plain_and_repeats(carry):
    """K9 against its plain version: F after one step within 1e-4 of the
    largest force (the approximate reciprocal), x after 3 steps within 1e-5
    nm; a repeated call is bitwise equal and counted once."""
    from chiron_tpu_torch.ops import lj_md_fused as mf

    runner, c0, pot = carry
    md = mf.FusedLJMD(N, pot.sigma, pot.epsilon, pot.cutoff, np.full(N, 39.948),
                      0.002, 1.0, units.kB_MD * 120.0, device=c0.x.device)
    assert md.n_pad == c0.x.shape[1]
    box = c0.box_diag.reshape(3).contiguous()
    w = c0.v - 0.001 * c0.F * md.minv
    lj = (pot.sigma, pot.epsilon, pot.cutoff, md.dt, md.a, md.b)
    args = (c0.x, w, c0.F, box, md.minv, md.sigv, 11, 40, N)
    _build.reset_launch_counts()
    k1 = mf.fused_md(*args, 1, *lj)
    k3 = mf.fused_md(*args, 3, *lj)
    again = mf.fused_md(*args, 3, *lj)
    assert dict(_build.launches) == {"fused_md": 3}
    p1 = mf.fused_md_plain(*args, 1, *lj)
    p3 = mf.fused_md_plain(*args, 3, *lj)
    assert float((k1[2] - p1[2]).abs().max()) / float(p1[2].abs().max()) < 1e-4
    assert float((k3[0] - p3[0]).abs().max()) < 1e-5
    assert float((k3[1] - p3[1]).abs().max()) < 1e-4
    assert all(torch.equal(a, b) for a, b in zip(k3, again))
    assert float(k3[2][:, N:].abs().max()) == 0.0


def _shuffled(c0, seed=3):
    g = torch.Generator(device=c0.x.device).manual_seed(seed)
    perm = torch.randperm(N, generator=g, device=c0.x.device)
    perm = torch.cat([perm, torch.arange(N, c0.x.shape[1], device=c0.x.device)])
    return c0.x[:, perm], c0.v[:, perm], c0.F[:, perm]


@pytest.mark.parametrize("nslab", [0, 4])
def test_sort_build_kernel_equals_plain_bitwise(carry, nslab):
    """K10 on a shuffled state: x', v', F' and every list array (rows
    included) equal to the plain version bit for bit, and repeatable."""
    from chiron_tpu_torch.ops import sortbuild as sb

    runner, c0, pot = carry
    md = runner.md
    cap = (md.n_pad // md.tm) * (md.n_pad // md.tn)
    a = (*_shuffled(c0), c0.box_diag[0], N, md.tm, md.tn, nslab, md.cutoff,
         md.slack, cap)
    _build.reset_launch_counts()
    ko, again = sb.sort_build(*a), sb.sort_build(*a)
    assert dict(_build.launches) == {"sort_build": 2}
    po = sb.sort_build_plain(*a)
    for k, q, p in zip(ko[:3], again[:3], po[:3]):
        assert torch.equal(k, p) and torch.equal(k, q)
    for f in lc.TilePairList._fields:
        assert torch.equal(getattr(ko[3], f), getattr(po[3], f)), f
        assert torch.equal(getattr(ko[3], f), getattr(again[3], f)), f


def _chip_smoke():
    """chip_smoke.py as a module: its list-build states and replicas."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_pad", [1024, 2048, 4096])
@pytest.mark.parametrize("nslab", [0, 4])
@pytest.mark.parametrize("kind", ["ties", "nan"])
def test_sort_build_kernel_bitwise_on_ties_nan_overflow_and_latch(
        cuda, n_pad, nslab, kind):
    """K10 (8 lanes a thread in its network) against the plain version bit
    for bit on every output, and repeatable: with the whole capacity, with a
    capacity of 3 (overflow) and at a cutoff over L/2 (the shift latch)."""
    from chiron_tpu_torch.ops import sortbuild as sb

    n = n_pad - 96
    x, v, F = _chip_smoke()._listbuild_state(cuda, n, n_pad, kind)
    box = torch.full((3,), 5.8, device=cuda)
    tm, tn = 128, 256
    full = (n_pad // tm) * (n_pad // tn)
    for cutoff, cap, over in ((1.02, full, None), (1.02, 3, True),
                              (2.9, full, True)):
        a = (x, v, F, box, n, tm, tn, nslab, cutoff, 0.15, cap)
        _build.reset_launch_counts()
        ko, again = sb.sort_build(*a), sb.sort_build(*a)
        assert dict(_build.launches) == {"sort_build": 2}
        po = sb.sort_build_plain(*a)
        for k, q, p in zip(ko[:3], again[:3], po[:3]):
            assert _same_bits(k, p) and _same_bits(k, q)
        for f in lc.TilePairList._fields:
            assert _same_bits(getattr(ko[3], f), getattr(po[3], f)), f
            assert _same_bits(getattr(ko[3], f), getattr(again[3], f)), f
        if over is not None:
            assert bool(po[3].overflowed)


@pytest.mark.parametrize("n,n_pad", [(8000, 8192), (20000, 20224)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_tile_build_kernel_beyond_one_pass(cuda, n, n_pad, shuffle):
    """K11's build over 64 x 32 = 2048 (row tile, column tile) pairs, two
    passes of the pair stage, and over 158 x 79 pairs, 25 passes: bit for
    bit equal to build_tile_pairs and repeatable; shuffled, every kept
    rectangle trips the shift latch."""
    from chiron_tpu_torch.ops import lj_mega as lm

    runner, c0, _ = _culled_on_card(cuda, n, 128)
    md = runner.md
    assert (md.n_pad, md.tm, md.tn) == (n_pad, 128, 256)
    x = c0.x
    if shuffle:
        g = torch.Generator(device=cuda).manual_seed(5)
        perm = torch.cat([torch.randperm(n, generator=g, device=cuda),
                          torch.arange(n, md.n_pad, device=cuda)])
        x = x[:, perm].contiguous()
    box = c0.box_diag[0]
    for cap in (runner.capacity, 20):
        args = (x, n, md.tm, md.tn, box, md.cutoff, md.slack, cap)
        _build.reset_launch_counts()
        kt, again = lm.tile_build(*args), lm.tile_build(*args)
        assert dict(_build.launches) == {"tile_build": 2}
        pt = lc.build_tile_pairs(*args)
        for f in lc.TilePairList._fields:
            assert torch.equal(getattr(kt, f), getattr(pt, f)), f
            assert torch.equal(getattr(kt, f), getattr(again, f)), f
        assert bool(pt.overflowed) == (shuffle or cap == 20)


def test_tile_build_and_repair_kernels_equal_plain_bitwise(carry):
    from chiron_tpu_torch.ops import lj_mega as lm

    runner, c0, _ = carry
    md = runner.md
    c1 = runner.segment_fn(8)(c0)  # a little out of order
    box = c0.box_diag[0]
    _build.reset_launch_counts()
    kt = lm.tile_build(c1.x, N, md.tm, md.tn, box, md.cutoff, md.slack,
                       runner.capacity)
    kr = lm.mega_repair(c1.x, c1.v, c1.F, N, box, 16)
    assert dict(_build.launches) == {"tile_build": 1, "mega_repair": 1}
    pt = lc.build_tile_pairs(c1.x, N, md.tm, md.tn, box, md.cutoff, md.slack,
                             runner.capacity)
    for f in lc.TilePairList._fields:
        assert torch.equal(getattr(kt, f), getattr(pt, f)), f
    for k, p in zip(kr, lm.repair_plain(c1.x, c1.v, c1.F, N, box, 16)):
        assert torch.equal(k, p)
    xs = _shuffled(c0)
    for k, p in zip(lm.mega_repair(*xs, N, box, 16),
                    lm.repair_plain(*xs, N, box, 16)):
        assert torch.equal(k, p)


def test_mega_segment_p0_is_the_classic_path_and_repeats(carry):
    """A P=0 segment from the sorted init state equals the classic kernel
    path bit for bit; P=16 permutes it; a repeated call is equal."""
    from chiron_tpu_torch.ops import lj_mega as lm

    runner, c0, _ = carry
    md = runner.md
    half = 0.5 * md.dt
    w = c0.v - half * c0.F * md.minv
    pairs = md.build_pairs(c0.x, c0.box_diag[0], runner.capacity)
    xc, vc, Fc, stale = md.run_segment(
        c0.x, c0.v, c0.F, c0.box_diag, pairs, seed=2, step_offset=c0.step,
        n_steps=8, drift_slack=md.slack_t)
    ws = lm.MegaWorkspace(md, runner.capacity)
    args = (md, c0.x, w, c0.F, c0.box_diag, runner.capacity, 2, c0.step, 8)
    _build.reset_launch_counts()
    m0 = lm.mega_segment(*args, 0, workspace=ws)
    m16 = lm.mega_segment(*args, 16, workspace=ws)
    again = lm.mega_segment(*args, 16, workspace=ws)
    assert ws.repair_pointers(16) == (None, None)  # P=16 fits shared memory
    assert dict(_build.launches) == {
        "mega_md": 3, "tile_build": 3, "baoab": 3, "culled_force": 24,
        "tile_skin_drift": 3, "mega_repair": 3}
    assert torch.equal(m0[0], xc) and torch.equal(m0[2], Fc)
    assert torch.equal(m0[1] + half * m0[2] * md.minv, vc)
    assert bool(m0[3]) == bool(stale)
    assert all(torch.equal(a, b) for a, b in zip(m16, again))
    for a, b in zip(m0[:3], m16[:3]):
        assert torch.equal(a[:, N:], b[:, N:])
        assert torch.equal(torch.sort(a[:, :N].flatten()).values,
                           torch.sort(b[:, :N].flatten()).values)


def _nearly_sorted(n, n_pad, device, seed=9):
    """x in cyclic order with local disorder, some lanes wrapped across x
    and ties; padding at 3e38."""
    rng = np.random.default_rng(seed)
    L = 17.0
    x0 = ((np.arange(n) + 0.5) * L / n + rng.normal(0, 4 * L / n, n)) % L
    x0[rng.choice(n, 50, replace=False)] = x0[10]
    x0[:8] = (x0[:8] + L - 0.01) % L
    x = rng.uniform(0, L, (3, n_pad)).astype(np.float32)
    x[0, :n] = x0
    x[:, n:] = 3.0e38
    w = rng.normal(0, 1, (3, n_pad)).astype(np.float32)
    F = rng.normal(0, 100, (3, n_pad)).astype(np.float32)
    return (*(torch.from_numpy(a).to(device) for a in (x, w, F)),
            torch.full((3,), L, device=device))


@pytest.mark.parametrize("n,n_pad", [(4000, 4096), (100_000, 100_096)])
def test_windowed_repair_is_repair_plain_bitwise(cuda, n, n_pad):
    """The repair in one launch of many blocks (128 at n_pad 4096, P=16),
    each on its own window: bitwise repair_plain at P = 1, 16 and 256,
    padding unmoved."""
    from chiron_tpu_torch.ops import lj_mega as lm

    x, w, F, box = _nearly_sorted(n, n_pad, cuda)
    for passes in (1, 16, 256):
        _build.reset_launch_counts()
        got = lm.mega_repair(x, w, F, n, box, passes)
        assert dict(_build.launches) == {"mega_repair": 1}
        want = lm.repair_plain(x, w, F, n, box, passes)
        for a, b in zip(got, want):
            assert torch.equal(a, b), passes
        assert torch.equal(got[0][:, n:], x[:, n:])
        assert not torch.equal(got[0], x)


def test_repair_beyond_shared_memory_is_repair_plain_bitwise(cuda):
    """Where the window outgrows shared memory (n_pad 26,624, P = 12,560:
    512 + 2 P lanes above 25,600), the repair runs in one block on global
    scratch, which is allocated only then: bitwise repair_plain."""
    from chiron_tpu_torch.ops import lj_mega as lm

    n, n_pad, passes = 26_000, 26_624, 12_560
    assert lm.repair_scratch(n_pad, 256, cuda) is None
    keys, idx = lm.repair_scratch(n_pad, passes, cuda)
    assert keys.numel() == idx.numel() == n_pad
    x, w, F, box = _nearly_sorted(n, n_pad, cuda)
    got = lm.mega_repair(x, w, F, n, box, passes)
    want = lm.repair_plain(x, w, F, n, box, passes)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[0][:, n:], x[:, n:])
    assert not torch.equal(got[0], x)


@pytest.mark.parametrize("path", ["fused_rebuild", "megakernel"])
def test_new_culled_paths_never_wait_for_the_device(carry, path):
    runner, c0, pot = carry
    r = make_culled_lj_runner(
        potential=pot, n_particles=N, temperature=120.0 * units.kelvin,
        slack=0.15, segment_steps=8, sort_mode="x", device=c0.x.device,
        **{path: True})
    assert r.path == path
    st = r.init(runner.positions(c0), c0.box_diag, seed=4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = r.run(st, 24)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    r.check(st)
    assert int(st.step[0, 0]) == 24


def _culled_on_card(cuda, n, tm, tn=256, slack=0.15, segment_steps=8, seed=1):
    fluid, pos, box = _jittered_fluid(n, seed)
    runner = make_culled_lj_runner(
        potential=fluid.potential, n_particles=n, topology=fluid.topology,
        temperature=120.0 * units.kelvin, slack=slack, tm=tm, tn=tn,
        segment_steps=segment_steps, device=cuda)
    return runner, runner.init(pos, box, seed=2), fluid.potential


@pytest.mark.parametrize("tm", [64, 128, 256])
def test_culled_force_kernel_at_each_row_tile(cuda, tm):
    """The culled pass against its plain version at tm 64, 128 and 256 (the
    widest row tile it takes): force max abs 0.05 and p99 1e-5 relative,
    energy 1e-5; a repeated call bitwise equal; the exact-energy step equal
    to K5 bit for bit; and the runner stepping latch-clean on the card."""
    runner, c0, pot = _culled_on_card(cuda, N, tm)
    md = runner.md
    assert md.tm == tm and int(c0.pairs.count) > 0
    args = (c0.x, c0.box_diag, c0.pairs, N, tm, md.tn, pot.sigma, pot.epsilon,
            pot.cutoff)
    Fp, Ep = lc.row_force_pass_plain(*args, with_energy=True)
    Fk, Ek = lc.culled_force_energy(*args)
    err = (Fk - Fp)[:, :N].abs()
    scale = float(Fp.abs().max())
    assert float(err.max()) < 0.05
    assert float(torch.quantile(err.flatten(), 0.99)) / scale < 1e-5
    assert float(Fk[:, N:].abs().max()) == 0.0
    assert abs(float(Ek) - float(Ep)) / abs(float(Ep)) < 1e-5
    Fa, _ = lc.culled_force_pass(*args, approx_recip=True)
    assert float((Fa - Fk).abs().max()) / scale < 1e-4
    assert torch.equal(lc.culled_force_pass(*args, approx_recip=True)[0], Fa)
    assert torch.equal(lc.culled_force_energy(*args)[1], Ek)
    F_mix, E_mix = lc.culled_force_pass(*args, approx_recip=True,
                                        with_energy=True)
    assert torch.equal(F_mix, Fa) and torch.equal(E_mix, Ek)
    st = runner.run(c0, 3 * runner.segment_steps)
    runner.check(st)
    assert torch.isfinite(st.x).all()


def test_culled_force_kernel_at_n100000(cuda):
    """The pass and its gather at N=100,000 (the slab key, about 15,000
    entries), against the plain version, and bitwise repeatable."""
    n = 100_000
    runner, c0, pot = _culled_on_card(cuda, n, 128, slack=0.2,
                                      segment_steps=50)
    md = runner.md
    args = (c0.x, c0.box_diag, c0.pairs, n, md.tm, md.tn, pot.sigma,
            pot.epsilon, pot.cutoff)
    Fk, Ek = lc.culled_force_energy(*args)
    Fp, Ep = lc.row_force_pass_plain(*args, with_energy=True)
    err = (Fk - Fp)[:, :n].abs()
    scale = float(Fp.abs().max())
    assert float(err.max()) < 0.05
    assert _p99(err, scale) < 1e-5
    assert abs(float(Ek) - float(Ep)) / abs(float(Ep)) < 1e-5
    del Fp, err
    Fa, _ = lc.culled_force_pass(*args, approx_recip=True)
    assert torch.equal(lc.culled_force_pass(*args, approx_recip=True)[0], Fa)
    assert float((Fa - Fk).abs().max()) / scale < 1e-4


def test_dense_kernel_culls_chunks_and_matches_plain(cuda):
    """K1 at N=4000 in three orders (the lattice's, x-sorted, shuffled),
    which cull most, many and almost no column chunks: exact force 1e-5
    relative, approximate 1e-4, energy 1e-5, a repeated call bitwise equal;
    a NaN coordinate reaches every live row's force, as in the plain
    version (a NaN y reaches every row's y component); and K9's first step
    on the x-sorted positions within 1e-4."""
    from chiron_tpu_torch.ops import lj_md_fused as mf

    n = 4000
    fluid, pos, box = _jittered_fluid(n)
    pot = fluid.potential
    lj = (n, pot.sigma, pot.epsilon, pot.cutoff)
    x0 = torch.zeros((3, 4096), device=cuda)
    x0[:, :n] = torch.from_numpy(pos.T).to(cuda)
    box_diag = torch.from_numpy(np.diagonal(box).copy()).reshape(1, 3).to(cuda)
    order = torch.argsort(x0[0, :n])
    shuffle = torch.randperm(n, generator=torch.Generator().manual_seed(4))
    for name, perm in (("lattice", None), ("x-sorted", order),
                       ("shuffled", shuffle.to(cuda))):
        x = x0.clone()
        if perm is not None:
            x[:, :n] = x0[:, perm]
        Fp, Ep = lj_dense_plain(x, box_diag, *lj)
        Fk, Ek = lj_dense_force_energy(x, box_diag, *lj, approx_recip=False)
        Fa, _ = lj_dense_force_energy(x, box_diag, *lj, approx_recip=True,
                                      with_energy=False)
        scale = float(Fp.abs().max())
        assert float((Fk - Fp).abs().max()) / scale < 1e-5, name
        assert float((Fa - Fp).abs().max()) / scale < 1e-4, name
        assert abs(float(Ek) - float(Ep)) / abs(float(Ep)) < 1e-5, name
        again = lj_dense_force_energy(x, box_diag, *lj, approx_recip=False)
        assert torch.equal(again[0], Fk) and torch.equal(again[1], Ek), name
    nan = x.clone()
    nan[1, 123] = float("nan")
    Fk, _ = lj_dense_force_energy(nan, box_diag, *lj, with_energy=False)
    Fp, _ = lj_dense_plain(nan, box_diag, *lj, with_energy=False)
    assert torch.equal(torch.isnan(Fk), torch.isnan(Fp))
    assert bool(torch.isnan(Fk[1, :n]).all())
    md = mf.FusedLJMD(n, pot.sigma, pot.epsilon, pot.cutoff,
                      np.full(n, 39.948), 0.002, 1.0, units.kB_MD * 120.0,
                      device=cuda)
    x = x0.clone()
    x[:, :n] = x0[:, order]
    F0, _ = lj_dense_force_energy(x, box_diag, *lj, with_energy=False)
    args = (x, torch.zeros_like(x), F0, box_diag.reshape(3), md.minv, md.sigv,
            11, 0, n, 1, pot.sigma, pot.epsilon, pot.cutoff, md.dt, md.a,
            md.b)
    k1, p1 = mf.fused_md(*args), mf.fused_md_plain(*args)
    assert float((k1[2] - p1[2]).abs().max()) / float(p1[2].abs().max()) < 1e-4


def test_band_energy_and_k2_at_n100000(cuda):
    """At n_pad 100,096 K1's kernel serves the band runner's energy and K2
    (no other kernel and no shape rule): both within 1e-5 of the plain
    version, and K2's force too."""
    from chiron_tpu_torch.ops.lj_dense import LJDense
    from chiron_tpu_torch.runtime import make_band_lj_runner

    n = 100_000
    fluid, pos, box = _jittered_fluid(n)
    pot = fluid.potential
    runner = make_band_lj_runner(pot, n_particles=n, topology=fluid.topology,
                                 temperature=120.0 * units.kelvin,
                                 device=cuda)
    st = runner.init(pos, box, seed=2)
    assert runner.n_pad == 100_096
    _build.reset_launch_counts()
    e_band = float(runner.energy(st))
    k2 = LJDense(n, pot.sigma, pot.epsilon, pot.cutoff, n_pad=runner.n_pad,
                 triangle=False, device=cuda)
    F2, E2 = k2.force_energy_t(st.x, st.box_diag)
    assert dict(_build.launches) == {"lj_dense": 1, "lj_dense_square": 1}
    Fp, Ep = lj_dense_plain(st.x, st.box_diag, n, pot.sigma, pot.epsilon,
                            pot.cutoff)
    scale = float(Fp.abs().max())
    assert float((F2 - Fp).abs().max()) / scale < 1e-5
    assert abs(e_band - float(Ep)) / abs(float(Ep)) < 1e-5
    assert abs(float(E2) - float(Ep)) / abs(float(Ep)) < 1e-5


class _NoSync:
    """Raise on any host synchronisation inside the block."""

    def __enter__(self):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")


def _sorted_fluid(cuda, n, n_pad, seed=1):
    """A jittered bench-density fluid of n particles, wrapped into the box
    and x-sorted on the card: ((3, n_pad) positions, (1, 3) box, the
    potential)."""
    from chiron_tpu_torch.ops.lj_band import sort_by_x

    fluid, pos, box = _jittered_fluid(n, seed)
    x3 = torch.zeros((3, n_pad), device=cuda)
    x3[:, :n] = torch.from_numpy(pos.T).to(cuda)
    box_diag = torch.from_numpy(np.diagonal(box).copy()).reshape(1, 3).to(cuda)
    return sort_by_x(x3, (), n)[0].contiguous(), box_diag, fluid.potential


# K6 at each row tile: n = 2000 leaves a padding gap of 48 ranks (n_pad
# 2048), and w one rank below, at and above a multiple of tm puts the band's
# end inside, at and just past a tile edge; the last row tiles wrap to tile 0.
@pytest.mark.parametrize("tm,w", [(64, 575), (64, 576), (64, 577),
                                  (128, 639), (128, 640), (128, 641),
                                  (256, 511), (256, 512), (256, 513)])
def test_band_kernel_edges_and_every_slot_bitwise(cuda, tm, w):
    """K6 (visits skipped by x, the LJ term only on flagged rows, the rank
    mask on edge visits only, the compare image) against its plain version:
    force max abs 0.05 and p99 1e-5 relative, approximate within 1e-4,
    energy 1e-5; bitwise equal to the kernel taking every slot
    (``skip=False``), on the wrapped state and with one coordinate moved a
    box length out (its visits take every slot); a repeated call bitwise
    equal; no host sync."""
    from chiron_tpu_torch.ops import lj_band as lb

    n = 2000
    x, box, pot = _sorted_fluid(cuda, n, 2048)
    far = x.clone()
    far[1, 700] += float(box[0, 1])
    for state in (x, far):
        args = (state, box.reshape(3), n, w, pot.sigma, pot.epsilon,
                pot.cutoff, tm)
        with _NoSync():
            Fk, Ek = lb.band_force_energy(*args)
            Fk0, Ek0 = lb.band_force_energy(*args, skip=False)
            Fa = lb.band_force(*args)
            Fa0 = lb.band_force(*args, skip=False)
            Fe = lb.band_force(*args, approx_recip=False)
            Fe0 = lb.band_force(*args, approx_recip=False, skip=False)
            again = lb.band_force_energy(*args)
        Fp, Ep = lb.band_force_plain(*args, with_energy=True)
        scale = float(Fp.abs().max())
        err = (Fk - Fp)[:, :n].abs()
        assert float(err.max()) < 0.05
        assert float(torch.quantile(err.flatten(), 0.99)) / scale < 1e-5
        assert float((Fa - Fk).abs().max()) / scale < 1e-4
        assert float(Fk[:, n:].abs().max()) == 0.0
        assert abs(float(Ek) - float(Ep)) / abs(float(Ep)) < 1e-5
        for a, b in ((Fk, Fk0), (Ek, Ek0), (Fa, Fa0), (Fe, Fe0), (Fe, Fk),
                     (again[0], Fk), (again[1], Ek)):
            assert torch.equal(a, b)


def test_band_kernel_nan_reaches_the_rows_of_plain(cuda):
    """A NaN y coordinate reaches, through K6's masked 0 times NaN, the same
    force components as in the plain version, and the rest keeps the bits
    of the kernel taking every slot."""
    from chiron_tpu_torch.ops import lj_band as lb

    n, tm, w = 2000, 128, 640
    x, box, pot = _sorted_fluid(cuda, n, 2048)
    x[1, 1234] = float("nan")
    args = (x, box.reshape(3), n, w, pot.sigma, pot.epsilon, pot.cutoff, tm)
    Fk = lb.band_force(*args, approx_recip=False)
    Fk0 = lb.band_force(*args, approx_recip=False, skip=False)
    Fp, _ = lb.band_force_plain(*args)
    assert torch.equal(torch.isnan(Fk), torch.isnan(Fp))
    assert bool(torch.isnan(Fk[1]).any()) and not bool(torch.isnan(Fk[0]).any())
    assert torch.equal(torch.nan_to_num(Fk), torch.nan_to_num(Fk0))


# K8b at each row tile, at 1 and 4 slabs: w one rank below, at and above
# 3 x 256 (6 x 128), n = 4000 in n_pad 4096 (a padding gap of 96 ranks).
@pytest.mark.parametrize("tm", [128, 256])
@pytest.mark.parametrize("w", [767, 768, 769])
def test_row_band_kernel_edges_and_every_slot_bitwise(cuda, tm, w):
    """K8b (the window of each 32-row block, the vote, the
    edge mask, the compare image) against its plain version, 1e-5 relative
    (max and p99); 4 slabs equal to 1 bit for bit; bitwise equal to the
    kernel taking every slot of the window (``skip=False``), on the wrapped
    state and with one coordinate a box length out; no host sync."""
    from chiron_tpu_torch.parallel import spatial as sp

    n, n_pad = 4000, 4096
    x, box, pot = _sorted_fluid(cuda, n, n_pad)
    far = x.clone()
    far[2, 3000] -= float(box[0, 2])
    lj = (pot.sigma, pot.epsilon, pot.cutoff)
    r = n_pad // 4
    for state in (x, far):
        with _NoSync():
            F1 = sp.row_band_force(state, box, 0, n_pad, n, w, tm, *lj)
            F0 = sp.row_band_force(state, box, 0, n_pad, n, w, tm, *lj,
                                   skip=False)
            slabs = [sp.row_band_force(state, box, k * r, r, n, w, tm, *lj)
                     for k in range(4)]
        Fp = sp.row_band_force_plain(state, box, 0, n_pad, n, w, *lj)
        scale = float(Fp.abs().max())
        diff = (F1 - Fp).abs()
        assert float(diff.max()) / scale < 1e-5 and _p99(diff, scale) < 1e-5
        assert torch.equal(F1, F0)
        assert torch.equal(torch.cat(slabs, dim=1), F1)


def test_row_band_kernel_nan_keeps_the_rows_of_every_slot(cuda):
    """A NaN y coordinate reaches the same rows of K8b as in the kernel
    taking every slot of its window (bitwise elsewhere).  The plain version
    pairs each row with every column, so there the NaN reaches every row;
    the kernels' rows are among them."""
    from chiron_tpu_torch.parallel import spatial as sp

    n, n_pad, tm, w = 4000, 4096, 256, 768
    x, box, pot = _sorted_fluid(cuda, n, n_pad)
    x[1, 2345] = float("nan")
    lj = (pot.sigma, pot.epsilon, pot.cutoff)
    F1 = sp.row_band_force(x, box, 0, n_pad, n, w, tm, *lj)
    F0 = sp.row_band_force(x, box, 0, n_pad, n, w, tm, *lj, skip=False)
    Fp = sp.row_band_force_plain(x, box, 0, n_pad, n, w, *lj)
    nan1 = torch.isnan(F1)
    assert torch.equal(nan1, torch.isnan(F0))
    assert torch.equal(torch.nan_to_num(F1), torch.nan_to_num(F0))
    assert bool(nan1[1, 2345]) and not bool((nan1 & ~torch.isnan(Fp)).any())
    assert 0 < int(nan1[1].sum()) < n_pad


def test_row_slab_kernel_is_k2_bitwise(spatial_state):
    """K8a runs K1's kernel on a slab of rows: one slab of every row equals
    K2 (the same kernel on the same rows) bit for bit, force only and with
    the energy, whose half equals K2's energy; 4 slabs equal 1; no host
    sync; a NaN y coordinate reaches the rows and components K2's reaches,
    and the rest keeps K2's bits."""
    from chiron_tpu_torch.parallel import spatial as sp

    runner, st, kw = spatial_state
    pot, n, n_pad = kw["potential"], runner.n, runner.n_pad
    args = (n, pot.sigma, pot.epsilon, pot.cutoff)
    r = n_pad // 4
    nan = st.x.clone()
    nan[1, 4321] = float("nan")
    for x in (st.x, nan):
        box = st.box_diag
        _build.reset_launch_counts()
        with _NoSync():
            Ff, _ = sp.row_slab_force(x, x, box, 0, *args)
            F1, E1 = sp.row_slab_force(x, x, box, 0, *args, with_energy=True)
            slabs = [sp.row_slab_force(x[:, k * r:(k + 1) * r].contiguous(),
                                       x, box, k * r, *args)[0]
                     for k in range(4)]
            F2f = runner.op.force_only_t(x, box, approx_recip=False)
            F2, E2 = runner.op.force_energy_t(x, box)
        assert dict(_build.launches) == {"row_slab_force": 5,
                                         "row_slab_force_energy": 1,
                                         "lj_dense_square": 2}
        for a, b in ((Ff, F2f), (F1, F2), (torch.cat(slabs, dim=1), Ff)):
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
        if x is nan:
            assert bool(torch.isnan(Ff[1, :n]).all())
            assert not bool(torch.isnan(Ff[0]).any())
        else:
            assert torch.equal(0.5 * E1, E2)


def _strip_layout(cuda, n, tm, narrow, seed=1):
    """A jittered bench-density fluid of n particles in the strip layout:
    x-sorted with the padding at the sentinel, extended by a halo that
    covers the band the cutoff needs (the padding gap included), rounded up
    to tm, or with ``narrow`` one strip-runner tile (128 ranks) less than
    that band, rounded down to 128, so that the rows next to the wrap lose
    partners within the cutoff.  Returns (xe, box, H, the potential, the
    covering halo's xe and H)."""
    from chiron_tpu_torch.ops import lj_band as lb
    from chiron_tpu_torch.ops import lj_strip as ls

    fluid, pos, box = _jittered_fluid(n, seed)
    pot = fluid.potential
    n_pad = -(-n // 128) * 128
    x3 = torch.full((3, n_pad), ls._PAD_X, device=cuda)
    x3[:, :n] = torch.from_numpy(pos.T).to(cuda)
    box_diag = torch.from_numpy(np.diagonal(box).copy()).reshape(1, 3).to(cuda)
    xs = ls.sort_by_key_strip(x3, ())[0]
    valid = torch.arange(n_pad, device=cuda) < n
    W = int(lb.band_width_needed(torch.where(valid, xs[0], 3.0e38), n,
                                 pot.cutoff, box_diag[0, 0]))
    full = -(-(W + n_pad - n) // tm) * tm

    def extend(h):
        halo = xs[:, :h].clone()
        halo[0] = halo[0] + box_diag[0, 0]
        return torch.cat([xs, halo], dim=1)

    H = ((W + n_pad - n) // 128 - 1) * 128 if narrow else full
    return extend(H), box_diag, H, pot, extend(full), full


@pytest.mark.parametrize("tm", [16, 32, 64, 128])
@pytest.mark.parametrize("narrow", [False, True])
def test_strip_kernel_at_each_tile_matches_plain_and_repeats(cuda, tm,
                                                             narrow):
    """K7 at N=4000 against ``strip_force_plain`` at every row tile, with a
    halo covering the band and a tile narrower: exact force max abs 0.05
    and p99 1e-5 relative, approximate within 1e-4, energy 1e-5, zero
    padding rows, a repeated call bitwise equal, one counted launch a call,
    no host sync.  The narrow strip misses pairs within the cutoff (one
    such pair moves a force by 0.03-0.08), and the kernel must miss the
    same ones: its change from the covering halo equals the plain
    version's within 0.02."""
    from chiron_tpu_torch.ops import lj_strip as ls

    n = 4000
    xe, box, H, pot, xe_full, full = _strip_layout(cuda, n, tm, narrow)
    args = (xe, box, n, tm, H, pot.sigma, pot.epsilon, pot.cutoff)
    _build.reset_launch_counts()
    with _NoSync():
        Fk, Ek = ls.strip_force_energy(*args)
        Fa = ls.strip_force(*args, approx_recip=True)
        Fe = ls.strip_force(*args, approx_recip=False)
        again = ls.strip_force_energy(*args)
        Fa2 = ls.strip_force(*args, approx_recip=True)
    assert dict(_build.launches) == {"strip_force_energy": 2,
                                     "strip_force": 3}
    Fp, Ep = ls.strip_force_plain(*args, with_energy=True)
    scale = float(Fp.abs().max())
    err = (Fk - Fp)[:, :n].abs()
    assert float(err.max()) < 0.05
    assert float(torch.quantile(err.flatten(), 0.99)) / scale < 1e-5
    assert float((Fa - Fk).abs().max()) / scale < 1e-4
    assert float(Fk[:, n:].abs().max()) == 0.0
    assert abs(float(Ek) - float(Ep)) / abs(float(Ep)) < 1e-5
    for a, b in ((again[0], Fk), (again[1], Ek), (Fa2, Fa), (Fe, Fk)):
        assert torch.equal(a, b)
    if narrow:
        full_args = (xe_full, box, n, tm, full, pot.sigma, pot.epsilon,
                     pot.cutoff)
        Fpf, _ = ls.strip_force_plain(*full_args)
        Fkf = ls.strip_force(*full_args, approx_recip=False)
        assert float((Fp - Fpf).abs().max()) > 0.02
        assert float(((Fk - Fkf) - (Fp - Fpf)).abs().max()) < 0.02


def test_strip_kernel_nan_reaches_the_entries_of_plain(cuda):
    """A NaN y coordinate (one at a rank with a halo copy, one past it)
    reaches, through the LJ term a NaN distance takes, the same force
    entries as in the plain version (every component of both ends of each
    slot), and the energy skips those slots as the plain version's does."""
    from chiron_tpu_torch.ops import lj_strip as ls

    n, tm = 4000, 128
    xe, box, H, pot, _, _ = _strip_layout(cuda, n, tm, False)
    n_pad = xe.shape[1] - H
    for rank in (5, 2345):
        x = xe.clone()
        x[1, rank] = float("nan")
        if rank < H:
            x[1, n_pad + rank] = float("nan")
        args = (x, box, n, tm, H, pot.sigma, pot.epsilon, pot.cutoff)
        Fk, Ek = ls.strip_force_energy(*args)
        Fp, Ep = ls.strip_force_plain(*args, with_energy=True)
        assert torch.equal(torch.isnan(Fk), torch.isnan(Fp))
        assert 0 < int(torch.isnan(Fk[0]).sum()) < n
        assert abs(float(Ek) - float(Ep)) / abs(float(Ep)) < 1e-5
