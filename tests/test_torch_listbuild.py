"""chip_smoke.py's replicas of the redesigned list build on the CPU.

The CUDA kernels (csrc/sortbuild.cu, K10, and csrc/tile_build.cuh, shared
with K11's tile_build) run only on the card (tests/test_torch_kernels_gpu.py).
Here their index math, as torch replicas that chip_smoke.py also runs, is
held exactly to the port's plain versions:

* the build's pair stage: a pass of whole rows, a word of 32 column tiles a
  warp, the two ballots a word, each row's counts and prefixes by popcount,
  the rows' scan over the earlier passes' total and each kept pair's slot
  equal ``build_tile_pairs``'s list, array for array;
* K10's network: (key, lane) pairs held 8 adjacent lanes a thread, each
  stage in a thread, by a shuffle in the warp or through shared memory, give
  ``bitonic_permutation``'s permutation, ties and NaN keys included;
* the build's round(d / L) by two compares against the float after L/2
  equals the correctly rounded division's, bit for bit;
* ``scripts/list_build_split.py`` finds every anchor of its phase stamps in
  this checkout's kernels.
"""

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from chiron_tpu_torch.ops import lj_cull as lc
from chiron_tpu_torch.ops import sortbuild as sb


ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load(relpath):
    path = ROOT / relpath
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke.py")

L = 5.8
CUTOFF, SLACK = 1.02, 0.15


def _positions(n, n_pad, seed, ordered):
    """(3, n_pad) f32 positions in a box of L: in x order (a sorted
    runner's layout) or shuffled; the padding at 3e38."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, L, (3, n_pad)).astype(np.float32)
    if ordered:
        x[:, :n] = x[:, np.argsort(x[0, :n])]
    x[:, n:] = 3.0e38
    return torch.from_numpy(x)


def _same(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in lc.TilePairList._fields)


BOX = torch.full((3,), L, dtype=torch.float32)


@pytest.mark.parametrize("nr,nc", [(8, 8), (32, 16), (32, 32), (64, 32)])
@pytest.mark.parametrize("n_pad", [1024, 2048, 4096])
def test_build_replica_is_build_tile_pairs(nr, nc, n_pad):
    """Ordered: no latch and a list under capacity; then the same capacity
    overflowed; shuffled: every kept rectangle over the shift bound."""
    tm, tn = n_pad // nr, n_pad // nc
    n = n_pad - 37
    x = _positions(n, n_pad, nr * nc + n_pad, ordered=True)
    full = lc.build_tile_pairs(x, n, tm, tn, BOX, CUTOFF, SLACK, nr * nc)
    count = int(full.count)
    assert 0 < count < nr * nc and not bool(full.overflowed)
    for cap in (nr * nc, count // 2):
        plain = lc.build_tile_pairs(x, n, tm, tn, BOX, CUTOFF, SLACK, cap)
        assert _same(cs._list_replica(x, n, tm, tn, BOX, CUTOFF, SLACK, cap),
                     plain)
    assert bool(plain.overflowed)
    xs = _positions(n, n_pad, 7, ordered=False)
    plain = lc.build_tile_pairs(xs, n, tm, tn, BOX, CUTOFF, SLACK, nr * nc)
    assert bool(plain.overflowed) and int(plain.count) <= nr * nc
    assert _same(cs._list_replica(xs, n, tm, tn, BOX, CUTOFF, SLACK, nr * nc),
                 plain)


def test_build_replica_takes_rows_wider_than_a_warp_in_passes():
    """nc = 40 (two words a row) and nr = 300 (ten passes of 32 rows at
    most): the chunk loop's running total and the words' prefixes, with a
    NaN coordinate reaching the geometry."""
    n_pad, tm, tn = 6000, 20, 150
    assert cs._build_grid(n_pad // tm, n_pad // tn) == (2, 32)
    x = _positions(5990, n_pad, 3, ordered=True)
    x[1, 411] = float("nan")
    cap = (n_pad // tm) * (n_pad // tn)
    for c in (cap, 200):
        plain = lc.build_tile_pairs(x, 5990, tm, tn, BOX, CUTOFF, SLACK, c)
        assert _same(cs._list_replica(x, 5990, tm, tn, BOX, CUTOFF, SLACK, c),
                     plain)


def _keys(n, n_pad, seed, kind):
    rng = np.random.default_rng(seed)
    key = rng.uniform(0, L, n_pad).astype(np.float32)
    if kind == "ties":  # a coarse grid: hundreds of live keys tie
        key = np.round(key / 0.05) * np.float32(0.05)
        key[[7, 11, 13]] = -0.0, 0.0, -0.0  # zeros of both signs tie too
    elif kind == "nan":
        key[[3, n // 2]] = np.nan
    key[n:] = 3.0e38
    return torch.from_numpy(key.astype(np.float32))


@pytest.mark.parametrize("n_pad", [128, 1024, 2048, 4096])
@pytest.mark.parametrize("kind", ["distinct", "ties", "nan"])
def test_network_replica_is_bitonic_permutation(n_pad, kind):
    n = n_pad - 96 if n_pad > 128 else 100
    key = _keys(n, n_pad, n_pad, kind)
    if kind == "ties":
        assert n - torch.unique(key[:n]).numel() >= 256 or n_pad < 1024
    perm, routes = cs._network_replica(key)
    assert torch.equal(perm, sb.bitonic_permutation(key))
    assert sum(routes.values()) == sum(range(1, n_pad.bit_length()))


def test_network_schedule_at_n_pad_4096():
    """8 lanes a thread: 33 stages in registers, 35 by shuffles and 10 (j of
    256 and above) through shared memory, 78 in all."""
    _, routes = cs._network_replica(_keys(4000, 4096, 1, "distinct"))
    assert routes == {"thread": 33, "warp": 35, "shared": 10}
    assert cs._network_route(128) == "warp" and cs._network_route(256) == "shared"


@pytest.mark.parametrize("L", [5.8, 17.0, 1.0, 0.34, 3.0e-3, 7.5e4])
def test_rint_div_by_compares_is_the_division_bit_for_bit(L):
    """round(d / L) by two compares against the float after L/2 gives the
    correctly rounded division's bits for |d| <= L, zero signs included,
    and the division itself beyond: random d, every float within 300 ulps
    of 0, +-L/2 and +-L, and NaN, infinities and 1.5 L."""
    Lt = torch.tensor(L, dtype=torch.float32)
    rng = np.random.default_rng(int(L * 1000) % 2**31)
    centres = torch.stack([Lt * 0, 0.5 * Lt, -0.5 * Lt, Lt, -Lt])
    steps = torch.arange(-300, 301, dtype=torch.int32)
    near = (centres.view(torch.int32)[:, None] + steps).flatten()
    near = torch.cat([near.view(torch.float32),
                      -near.view(torch.float32)])  # both signs of each
    d = torch.cat([
        torch.from_numpy(rng.uniform(-1.2 * L, 1.2 * L, 20000)).float(),
        near[torch.isfinite(near)],
        torch.tensor([0.0, -0.0, math.nan, math.inf, -math.inf]),
        1.5 * Lt[None], -1.5 * Lt[None]])
    want = torch.round(d / Lt)
    got = cs._rint_div(d, Lt.expand_as(d))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (d.abs() <= Lt).sum() > 20000 // 2


def test_split_script_stamps_every_phase_of_this_checkout(tmp_path):
    """The phase-time script's edits apply to the kernels as they are: each
    anchor is found, and every stamp its phase tables read is written."""
    split = _load("scripts/list_build_split.py")
    split.instrument(ROOT, tmp_path)
    csrc = tmp_path / "chiron_tpu_torch" / "csrc"
    text = {f: (csrc / f).read_text()
            for f in ("sortbuild.cu", "tile_build.cuh", "lj_mega.cu")}
    for path, _, new in split.EDITS:
        assert new in text[path]
    for kernel, phases, entry in (
            ("sortbuild.cu", split.K10_PHASES, "chiron_sort_stamps"),
            ("lj_mega.cu", split.TILE_PHASES, "chiron_tile_stamps")):
        code = text[kernel] + text["tile_build.cuh"]
        assert entry in text[kernel] and "START();" in text[kernel]
        for k in [k for _, k in phases]:
            assert f"STAMP({k});" in code, (kernel, k)
        assert f"END({split.LAST});" in code
