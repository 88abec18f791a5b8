"""The culled runner's rebuild in one call: the spatial sort of the MD state
and the tile-pair list build (port of ``chiron_tpu/ops/sortbuild.py``).

``sort_build`` is the wrapper of K10 (``csrc/sortbuild.cu``, replacing
``_make_sort_build_kernel`` :127 via ``sort_build_raw`` :327,
``pallas_call`` :351): one block sorts (key, lane) with the TPU kernel's
bitonic network, gathers x, v and F through the permutation and builds the
list of the sorted positions, counted as ``sort_build``.  On a CPU tensor it
runs ``sort_build_plain``: the same network in plain PyTorch
(``bitonic_permutation``), then ``build_tile_pairs``.  Both fill the list's
``rows``, which the port's plain force pass reads (the JAX kernel returns
zeros there, since its MD kernel never reads them).
"""

from __future__ import annotations

import torch

from ..profiling import spanned
from . import _build
from .lj_cull import TilePairList, build_tile_pairs, list_pointers, slab_y_key

# the sort runs in one block's shared memory
MAX_N_PAD = 4096


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def bitonic_permutation(key):
    """The permutation that ``_bitonic_sort`` (``sortbuild.py:73-104``)
    applies to a power-of-two-long ``key``: for k = 2 .. n and j = k/2 .. 1,
    lanes i and i ^ j exchange when out of order in their block's direction.
    Equal keys and NaN keys never swap.  Returns int64 lane indices."""
    n = key.shape[0]
    lane = torch.arange(n, device=key.device)
    perm = lane.clone()
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            partner = lane ^ j
            pkey = key[partner]
            keep_min = ((lane & j) == 0) == ((lane & k) == 0)
            swap = (keep_min & (pkey < key)) | (~keep_min & (pkey > key))
            key = torch.where(swap, pkey, key)
            perm = torch.where(swap, perm[partner], perm)
            j //= 2
        k *= 2
    return perm


def _check(n_pad: int, tm: int, tn: int):
    if not (_is_pow2(n_pad) and tm % 128 == 0 and tn % 128 == 0):
        raise ValueError(
            "sort_build needs power-of-two n_pad and 128-multiple tiles "
            f"(n_pad={n_pad}, tm={tm}, tn={tn})")


def sort_build_plain(x3, v3, f3, box_diag, n: int, tm: int, tn: int,
                     nslab: int, cutoff: float, slack: float, capacity: int):
    """Plain version of K10: returns (x', v', F', TilePairList)."""
    _check(x3.shape[1], tm, tn)
    box = box_diag.reshape(3)
    perm = bitonic_permutation(slab_y_key(x3, n, nslab, box[0], Ly=box[1]))
    xs, vs, fs = x3[:, perm], v3[:, perm], f3[:, perm]
    return xs, vs, fs, build_tile_pairs(xs, n, tm, tn, box, cutoff, slack,
                                        capacity)


def list_buffers(n_pad: int, tm: int, capacity: int, device) -> TilePairList:
    """Uninitialised outputs of a list build (K10, and K11's build)."""
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    nr = n_pad // tm
    return TilePairList(
        rows=torch.empty((1, capacity), **i32),
        cols=torch.empty((1, capacity), **i32),
        ccx=torch.empty((1, capacity), **f32),
        ptr2=torch.empty((1, 2 * nr + 1), **i32),
        rowcx=torch.empty((1, nr), **f32),
        count=torch.empty((1, 1), **i32),
        overflowed=torch.empty((), dtype=torch.bool, device=device),
    )


@spanned("chiron.op.sort_build")
def sort_build(x3, v3, f3, box_diag, n: int, tm: int, tn: int, nslab: int,
               cutoff: float, slack: float, capacity: int):
    """K10: sort (x3, v3, f3) by the spatial key (``slab_y_key``) and build
    the tile-pair list of the sorted positions.  Returns (x', v', F',
    TilePairList) as ``sort_by_key`` and ``build_tile_pairs`` give them, up
    to the order of equal keys.  Needs a power-of-two n_pad and tiles that
    are multiples of 128, and on the card n_pad <= 4096."""
    if x3.device.type == "cpu":
        return sort_build_plain(x3, v3, f3, box_diag, n, tm, tn, nslab,
                                cutoff, slack, capacity)
    _build.check_cuda(x3, "x3")
    dev = x3.device
    n_pad = x3.shape[1]
    _check(n_pad, tm, tn)
    if n_pad > MAX_N_PAD:
        raise ValueError(
            f"sort_build sorts in one block's shared memory: n_pad <= "
            f"{MAX_N_PAD} (got {n_pad})")
    for name, t in (("x3", x3), ("v3", v3), ("f3", f3)):
        _build.require(t, name, (3, n_pad), torch.float32, dev)
    _build.require(box_diag, "box_diag", None, torch.float32, dev)
    if box_diag.numel() != 3 or not 0 < n <= n_pad or capacity < 1:
        raise ValueError(
            f"sort_build: needs 3 box lengths, 0 < n <= n_pad and a "
            f"capacity (got {box_diag.numel()}, n={n}, capacity={capacity})")
    xs, vs, fs = (torch.empty_like(x3) for _ in range(3))
    pairs = list_buffers(n_pad, tm, capacity, dev)
    _build.launch(
        "sort_build", "chiron_sort_build",
        x3.data_ptr(), v3.data_ptr(), f3.data_ptr(), box_diag.data_ptr(),
        xs.data_ptr(), vs.data_ptr(), fs.data_ptr(), *list_pointers(pairs),
        n, n_pad, tm, tn, nslab, cutoff, slack, (cutoff + slack) ** 2,
        capacity, _build.stream_of(x3),
    )
    return xs, vs, fs, pairs
