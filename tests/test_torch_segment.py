"""chip_smoke.py's replicas of K3's segment and K11's repair on the CPU.

The CUDA kernels run only on the card (tests/test_torch_kernels_gpu.py);
here their algorithms, as torch replicas that chip_smoke.py also runs,
are held to the port's plain versions:

* the windowed repair (csrc/lj_mega.cu, mega_repair): a block's chunk with
  a halo of P lanes each side, passes by the global lane's parity, equals
  ``repair_plain`` exactly;
* the one-pass drift latch (csrc/drift.cu): partials (m1, m2, the count at
  m1) over any split of the lanes, merged in any order, give
  ``tile_skin_drift_bad_plain``'s flag and ``skin_drift_top2_plain``'s sum
  bit for bit;
* the culled gather's BAOAB epilogue (csrc/lj_cull_force.cu): particle q's
  noise on axis a, lane a n_pad/2 + q mod n_pad/2 with the cos branch below
  n_pad/2 and the sin branch above, is ``splitmix_noise_plain``'s.
"""

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from chiron_tpu_torch.ops import lj_cull as lc
from chiron_tpu_torch.ops import lj_mega as lm


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()

L = 5.0
N, N_PAD = 600, 640  # n not a multiple of any chunk below; 40 padding lanes


def _nearly_sorted(seed, n=N, n_pad=N_PAD):
    """x in cyclic order with local disorder: live lanes near their rank's
    place, some wrapped across x, and ties; padding at 3e38 as the sorting
    runners leave it."""
    rng = np.random.default_rng(seed)
    base = (np.arange(n) + 0.5) * L / n
    x0 = (base + rng.normal(0, 0.04, n)) % L
    x0[rng.choice(n, 20, replace=False)] = x0[10]          # ties
    x0[:8] = (x0[:8] + L - 0.01) % L                       # wrapped
    x = rng.uniform(0, L, (3, n_pad)).astype(np.float32)
    x[0, :n] = x0
    x[:, n:] = 3.0e38
    w = rng.normal(0, 1, (3, n_pad)).astype(np.float32)
    F = rng.normal(0, 100, (3, n_pad)).astype(np.float32)
    return (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(F),
            torch.full((1, 3), L, dtype=torch.float32))


@pytest.mark.parametrize("chunk", [32, 64, 256])
@pytest.mark.parametrize("passes", [1, 2, 16, 255, 256])
def test_windowed_repair_replica_equals_plain(chunk, passes):
    x, w, F, box = _nearly_sorted(chunk + passes)
    want = lm.repair_plain(x, w, F, N, box, passes)
    got = cs._repair_windows(x, w, F, N, box, passes, chunk)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the padding never moves, and the passes did reorder something
    assert torch.equal(got[0][:, N:], x[:, N:])
    assert not torch.equal(got[0], x)


def test_repair_geometry_fills_the_card_and_covers_every_lane():
    """The kernel's chunk at the main path's shapes: 128 blocks at n_pad
    4096 and P = 16; one block over global scratch only where the window
    outgrows shared memory; chunks always cover n_pad."""
    assert cs._repair_geometry(4096, 16) == (32, 128, 64)
    assert cs._repair_geometry(4096, 256) == (256, 16, 768)
    assert cs._repair_geometry(100_096, 16) == (32, 3128, 64)
    assert cs._repair_geometry(100_096, 20_000) == (100_096, 1, 100_096)
    for n_pad, passes in ((640, 0), (640, 1), (4096, 600), (100_096, 256)):
        chunk, blocks, window = cs._repair_geometry(n_pad, passes)
        assert chunk * blocks >= n_pad > chunk * (blocks - 1)
        assert window <= n_pad and 8 * window <= cs.REPAIR_SMEM


def _drift_case(kind, seed=3, n=N, n_pad=N_PAD):
    rng = np.random.default_rng(seed)
    anchor = rng.uniform(0, L, (3, n_pad)).astype(np.float32)
    step = rng.normal(0, 0.02, (3, n_pad)).astype(np.float32)
    if kind == "tied":  # two lanes with the largest drift, bit for bit
        step[:, 7] = step[:, 300] = 0.3
        anchor[:, 300] = anchor[:, 7]
    elif kind == "equal":
        step[:] = 0.01
    x = ((anchor + step) % L).astype(np.float32)
    if kind == "nan":
        x[1, 42] = np.nan
    elif kind == "inf":
        x[2, 5] = np.inf
    elif kind == "nan_pad":
        x[0, n + 3] = np.nan
    return torch.from_numpy(x), torch.from_numpy(anchor)


def _random_splits(rng, n_pad):
    lanes = torch.from_numpy(rng.permutation(n_pad))
    cuts = np.sort(rng.choice(np.arange(1, n_pad), rng.integers(1, 40),
                              replace=False))
    parts = list(torch.tensor_split(lanes, torch.from_numpy(cuts)))
    rng.shuffle(parts)
    return parts


@pytest.mark.parametrize("kind", ["random", "tied", "equal", "nan", "inf",
                                  "nan_pad"])
def test_latch_merge_replica_is_the_plain_latch_bit_for_bit(kind):
    x, anchor = _drift_case(kind)
    box = torch.full((1, 3), L, dtype=torch.float32)
    want_top2 = lc.skin_drift_top2_plain(x, anchor, N, box)
    rng = np.random.default_rng(11)
    splits = [cs._latch_splits(N_PAD)] + [_random_splits(rng, N_PAD)
                                          for _ in range(4)]
    nan = math.isnan(float(want_top2))
    assert nan == (kind in ("nan", "inf"))
    # thresholds on either side of the sum (and the NpT budget as a 0-dim
    # tensor), so that the flag is tested where it flips
    top = float(want_top2) if not nan else 0.1
    for thr in (0.15, top, float(np.nextafter(np.float32(top), 0)),
                torch.tensor(top, dtype=torch.float32)):
        want_flag = lc.tile_skin_drift_bad_plain(x, anchor, N, thr, box)
        for parts in splits:
            flag, top2 = cs._latch_replica(x, anchor, N, thr, box, parts)
            assert bool(flag) == bool(want_flag), (kind, thr)
            assert (torch.isnan(top2) and nan) or torch.equal(top2,
                                                              want_top2)
    if kind == "tied":
        assert float(want_top2) == 2 * float(lc.skin_drift_plain(
            x, anchor, N, box).max())
    if kind in ("nan", "inf"):
        assert bool(lc.tile_skin_drift_bad_plain(x, anchor, N, 10.0, box))
    if kind == "nan_pad":
        assert not bool(lc.tile_skin_drift_bad_plain(x, anchor, N, 10.0, box))


@pytest.mark.parametrize("seed,step", [(0, 0), (1234, 77), (2**32 - 1, 2999)])
def test_epilogue_lane_map_is_the_phase_noise(seed, step):
    got = cs._epilogue_noise(seed, step, N_PAD)
    assert torch.equal(got, lc.splitmix_noise_plain(seed, step, N_PAD))
