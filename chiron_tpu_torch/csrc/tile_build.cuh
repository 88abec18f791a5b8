// The tile-pair list build in one block, shared by the fused sort + build
// (sortbuild.cu, K10) and the megakernel segment (lj_mega.cu, K11).
//
// The function of chiron_tpu/ops/sortbuild.py:192-316 and
// lj_mega.py:123-259 (itself lj_cull.build_tile_pairs): the padding lanes
// read as lane n-1; each row tile (tm lanes) and column tile (tn lanes) gets
// its circular bounding box from min-imaged offsets to its first lane; the
// (row, col) rectangle is kept when the boxes' minimum-image gap is under
// cutoff + slack and it can hold a pair with col rank > row rank; kept
// entries are placed row by row, general before fast, in column order.  The
// shift bound (a kept rectangle with summed x half-widths over
// L/2 - cutoff - slack) and a capacity overflow latch `over`.
//
// Every float expression is written op by op with the _rn intrinsics and
// rintf (half to even, as torch.round and jnp.round): an FMA contraction
// could flip a `near2 < reach2` or `hsum_x > bound_x` decision against the
// plain version.  min and max propagate NaN, as torch.amin and jnp.min do.
// The integer parts (counts, scans, slots) are exact.  The boxes take a warp
// each; a thread takes a row tile, counting its kept entries in one pass
// and placing them in a second, after one thread scans the row counts.
#pragma once

#include "common.cuh"

namespace tile_build {

// d - L round(d / L), op by op.
__device__ __forceinline__ float min_image(float d, float L) {
  return __fsub_rn(d, __fmul_rn(L, rintf(__fdiv_rn(d, L))));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Params {
  const float* x;  // (3, n_pad) positions; read, never through __ldg: K10
                   // writes them in the same launch
  const float* box;
  int* rows;       // (capacity,)
  int* cols;       // (capacity,)
  float* ccx;      // (capacity,)
  int* ptr2;       // (2 nr + 1,)
  float* rowcx;    // (nr,)
  int* count;      // (1,)
  bool* over;      // (1,)
  int n, n_pad, tm, tn, capacity;
  float cutoff, slack, reach2;  // reach2 = (cutoff + slack)^2, rounded once
};

// Bytes of shared memory build() takes.
__host__ __device__ inline size_t smem_bytes(int n_pad, int tm, int tn) {
  const int nr = n_pad / tm, nc = n_pad / tn;
  return sizeof(float) * 6 * static_cast<size_t>(nr + nc) +
         sizeof(int) * (3 * static_cast<size_t>(nr) + 1);
}

struct Boxes {
  const float* rcen;  // [3][nr]
  const float* rhal;
  const float* ccen;  // [3][nc]
  const float* chal;
  int nr, nc;
};

// Whether rectangle (r, c) is kept; `general` and the summed x half-width
// on the side.
__device__ __forceinline__ bool kept(const Params& p, const Boxes& b,
                                     const float (&L)[3], int r, int c,
                                     bool& general, float& hsum_x) {
  float near2 = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float dc =
        min_image(__fsub_rn(b.rcen[a * b.nr + r], b.ccen[a * b.nc + c]), L[a]);
    const float hs = __fadd_rn(b.rhal[a * b.nr + r], b.chal[a * b.nc + c]);
    if (a == 0) hsum_x = hs;
    const float dmin = nan_max(__fsub_rn(fabsf(dc), hs), 0.0f);
    const float sq = __fmul_rn(dmin, dmin);
    near2 = a == 0 ? sq : __fadd_rn(near2, sq);
  }
  const int tm = p.tm, tn = p.tn, n = p.n;
  const bool useful = (c * tn + (tn - 1) > r * tm) && (r * tm < n) && (c * tn < n);
  general = (c * tn < r * tm + tm) || (c >= (n - 1) / tn) || (r >= (n - 1) / tm);
  return (near2 < p.reach2) && useful;
}

// The whole build, run by every thread of one block (blockDim.x a multiple
// of 32); `sh` holds smem_bytes(n_pad, tm, tn) bytes.
__device__ inline void build(const Params& p, float* sh) {
  const int nr = p.n_pad / p.tm, nc = p.n_pad / p.tn;
  float* rcen = sh;
  float* rhal = rcen + 3 * nr;
  float* ccen = rhal + 3 * nr;
  float* chal = ccen + 3 * nc;
  int* gen = reinterpret_cast<int*>(chal + 3 * nc);
  int* fast = gen + nr;
  int* base = fast + nr;
  int* shift_bad = base + nr;
  const int tid = threadIdx.x, nth = blockDim.x;
  const float L[3] = {p.box[0], p.box[1], p.box[2]};

  for (int k = tid; k < p.capacity; k += nth) {
    p.rows[k] = 0;
    p.cols[k] = 0;
    p.ccx[k] = 0.0f;
  }
  if (tid == 0) *shift_bad = 0;

  // bounding boxes: a warp per (tile, axis), row tiles first
  const int warp = tid / 32, lane = tid % 32;
  for (int task = warp; task < 3 * (nr + nc); task += nth / 32) {
    const int a = task % 3, t = task / 3;
    const bool is_row = t < nr;
    const int tile = is_row ? t : t - nr;
    const int width = is_row ? p.tm : p.tn;
    const float* xa = p.x + static_cast<size_t>(a) * p.n_pad;
    const int first = tile * width;
    const float ref = xa[first < p.n ? first : p.n - 1];
    float lo = __int_as_float(0x7f800000), hi = -lo;  // +inf, -inf
    for (int i = first + lane; i < first + width; i += 32) {
      const float d = min_image(__fsub_rn(xa[i < p.n ? i : p.n - 1], ref), L[a]);
      lo = nan_min(lo, d);
      hi = nan_max(hi, d);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {
      float* cen = is_row ? rcen + a * nr : ccen + a * nc;
      float* hal = is_row ? rhal + a * nr : chal + a * nc;
      cen[tile] = __fadd_rn(ref, __fmul_rn(0.5f, __fadd_rn(lo, hi)));
      hal[tile] = __fmul_rn(0.5f, __fsub_rn(hi, lo));
    }
  }
  __syncthreads();

  const Boxes b{rcen, rhal, ccen, chal, nr, nc};
  const float bound_x =
      __fsub_rn(__fsub_rn(__fmul_rn(0.5f, L[0]), p.cutoff), p.slack);
  for (int r = tid; r < nr; r += nth) {
    int g = 0, f = 0;
    bool bad = false;
    for (int c = 0; c < nc; ++c) {
      bool general;
      float hx;
      if (!kept(p, b, L, r, c, general, hx)) continue;
      if (general) ++g; else ++f;
      bad = bad || hx > bound_x;
    }
    gen[r] = g;
    fast[r] = f;
    if (bad) atomicOr(shift_bad, 1);
    p.rowcx[r] = rcen[r];
  }
  __syncthreads();

  if (tid == 0) {
    int incl = 0;
    p.ptr2[0] = 0;
    for (int r = 0; r < nr; ++r) {
      base[r] = incl;
      incl += gen[r] + fast[r];
      p.ptr2[2 * r + 1] = min(incl - fast[r], p.capacity);
      p.ptr2[2 * r + 2] = min(incl, p.capacity);
    }
    p.count[0] = min(incl, p.capacity);
    p.over[0] = incl > p.capacity || *shift_bad != 0;
  }
  __syncthreads();

  for (int r = tid; r < nr; r += nth) {
    int slot_g = base[r], slot_f = base[r] + gen[r];
    for (int c = 0; c < nc; ++c) {
      bool general;
      float hx;
      if (!kept(p, b, L, r, c, general, hx)) continue;
      const int slot = general ? slot_g++ : slot_f++;
      if (slot >= p.capacity) continue;
      const float cx = ccen[c];
      p.rows[slot] = r;
      p.cols[slot] = c;
      p.ccx[slot] = __fadd_rn(
          cx, __fmul_rn(rintf(__fdiv_rn(__fsub_rn(rcen[r], cx), L[0])), L[0]));
    }
  }
}

}  // namespace tile_build
