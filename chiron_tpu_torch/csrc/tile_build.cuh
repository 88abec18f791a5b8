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
// plain version.  The minimum image's round(d / L) is taken by two compares
// where they give the division's bits (rint_by_compares, below), else by
// the division.  min and max propagate NaN, as torch.amin and jnp.min do.
// The integer parts (counts, scans, slots) are exact.
//
// Design.  The boxes take a warp a tile, its three axes at once, half the
// warps on the row tiles and half on the column tiles.  The rectangles
// are decided once each, one thread a (row tile, column tile) pair: a row's
// nc columns lie in ceil(nc / 32) words of 32 lanes, columns fastest, and a
// pass takes whole rows, at most 32 and at most kPassWords words of them.
// In a pass every warp decides its words' pairs and ballots two masks a
// word, the kept general and the kept fast entries, into shared memory;
// warp 0 then counts each row with __popc, takes each word's prefix within
// its row, and scans the rows' counts with shuffles on top of the running
// total of the earlier passes (ptr2 is written here, capped as before);
// then each kept pair writes its own slot, base + its rank among the row's
// general (or, after them, fast) entries: a __popc of the mask below its
// lane.  The shift bound is one __syncthreads_or over every kept pair; the
// slots from count to capacity are zeroed once, at the end.  At the main
// path's shapes (nr, nc <= 32) that is one pass of three barriers.
//
// Bound: the build reads x once and writes the list once (about 0.02 us at
// 3.35 TB/s); no design in one block reaches it.  What bounds this one is
// that block's SM: the boxes' 6 n_pad minimum images and their xor trees
// (60% of the launch at N=4000), then the pair stage's chain of one kept()
// a thread and its three barriers; beyond a block's threads of pairs, a
// pass a group of rows.
#pragma once

#include "common.cuh"

namespace tile_build {

constexpr unsigned kFull = 0xffffffffu;
// words of (kept, general) masks a pass of the pair stage takes at most
constexpr int kPassWords = 512;

// A box axis for the images below: L, and lim = L where the compares stand
// in for the division (L positive and normal), else -1; t = nextafter(L/2,
// +inf).
struct Axis {
  float L, lim, t;
};

__device__ __forceinline__ Axis axis(float L) {
  const bool ok = L >= 1.0e-30f && L <= 1.0e30f;
  // the float after L/2, a positive normal float where ok
  return Axis{L, ok ? L : -1.0f,
              __int_as_float(__float_as_int(__fmul_rn(0.5f, L)) + 1)};
}

// round(d / L) (rintf of the correctly rounded division, __fdiv_rn) by
// compares, where |d| <= L: copysign([d >= t] - [d <= -t], d).  The
// quotient lies in [-1, 1] and rounds above 1/2 exactly when d / L >
// 1/2 + 2^-25, that is d > L/2 + L 2^-25, whose least float is t =
// L/2 + ulp(L/2) (L 2^-25 lies in [ulp(L/2)/2, ulp(L/2))); the division is
// odd; and rintf keeps the quotient's sign, the sign of d, on a zero.  So
// the compares give the division's bits.  Outside that domain (a NaN, an
// infinity, |d| > L, an L not positive and normal) the caller takes the
// division: the image loops below fold a warp's lanes by compares and do it
// again by the division where any lane of the warp left the domain.
__device__ __forceinline__ float rint_by_compares(float d, const Axis& a) {
  return copysignf(__fsub_rn(d >= a.t ? 1.0f : 0.0f, d <= -a.t ? 1.0f : 0.0f),
                   d);
}

// round(d / L), by compares where they hold, else by the division.
__device__ __forceinline__ float rint_div(float d, const Axis& a) {
  float q = rint_by_compares(d, a);
  if (!(fabsf(d) <= a.lim)) q = rintf(__fdiv_rn(d, a.L));
  return q;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The pair stage's geometry: nr row tiles, nc column tiles in ncw words a
// row, `rows` rows (`words` words) a pass.
struct Grid {
  int nr, nc, ncw, rows, words;
};

__host__ __device__ inline Grid grid(int n_pad, int tm, int tn) {
  const int nr = n_pad / tm, nc = n_pad / tn, ncw = (nc + 31) / 32;
  int rows = kPassWords / ncw;
  rows = rows < 1 ? 1 : (rows > 32 ? 32 : rows);
  return Grid{nr, nc, ncw, rows, rows * ncw};
}

struct Params {
  const float* x;  // (3, n_pad) positions, in global or shared memory; read,
                   // never through __ldg
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
  Grid g;                       // grid(n_pad, tm, tn), worked out once
};

// A pass's shared arrays, two sets (passes alternate): the general and fast
// masks and their prefixes within the row, a word each, and the rows' bases
// and general counts.
__host__ __device__ inline int pass_ints(const Grid& g) {
  return 4 * g.words + 2 * 32;
}

// Bytes of shared memory build() takes.
__host__ __device__ inline size_t smem_bytes(const Grid& g) {
  return sizeof(float) * 6 * static_cast<size_t>(g.nr + g.nc) +
         sizeof(int) * (2 * static_cast<size_t>(pass_ints(g)) + 1);
}

struct Boxes {
  const float* rcen;  // [3][nr]
  const float* rhal;
  const float* ccen;  // [3][nc]
  const float* chal;
  int nr, nc;
};

// Whether rectangle (r, c) is kept; `general` and the summed x half-width
// on the side.  round_div(d, a) is round(d / L[a]).
template <class RoundDiv>
__device__ __forceinline__ bool kept(const Params& p, const Boxes& b,
                                     const Axis (&L)[3], int r, int c,
                                     RoundDiv round_div, bool& general,
                                     float& hsum_x) {
  float near2 = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float d = __fsub_rn(b.rcen[a * b.nr + r], b.ccen[a * b.nc + c]);
    const float dc = __fsub_rn(d, __fmul_rn(L[a].L, round_div(d, a)));
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
// of 64); tm and tn multiples of 128; `sh` holds smem_bytes(p.g) bytes;
// box: p.box's three lengths, loaded by the caller ahead of time.
__device__ inline void build(const Params& p, float* sh,
                             const float (&box)[3]) {
  const Grid g = p.g;
  const int nr = g.nr, nc = g.nc;
  float* rcen = sh;
  float* rhal = rcen + 3 * nr;
  float* ccen = rhal + 3 * nr;
  float* chal = ccen + 3 * nc;
  int* pass_sh = reinterpret_cast<int*>(chal + 3 * nc);
  int* total_sh = pass_sh + 2 * pass_ints(g);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, warps = nth / 32;
  const Axis L[3] = {axis(box[0]), axis(box[1]), axis(box[2])};

  // bounding boxes: a warp a tile and its three axes, half the warps on
  // the row tiles and half on the column tiles (each tiling covers the
  // n_pad lanes); lane l folds the tile's lanes l, l + 32, ... in order,
  // then the warp's xor tree
  const int row_warps = warps / 2;
  const bool rows_here = warp < row_warps;
  for (int tile = rows_here ? warp : warp - row_warps;
       tile < (rows_here ? nr : nc);
       tile += rows_here ? row_warps : warps - row_warps) {
    const int width = rows_here ? p.tm : p.tn;
    const int first = tile * width;
    float ref[3], lo[3], hi[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      ref[a] = p.x[a * p.n_pad + (first < p.n ? first : p.n - 1)];
    }
    // the fold with round(d / L) by compares, then, where a lane of the
    // warp met a displacement outside their domain, again by the division
    auto fold = [&](auto round_div) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a] = __int_as_float(0x7f800000);  // +inf
        hi[a] = -lo[a];
      }
      for (int i0 = first + lane; i0 < first + width; i0 += 128) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + 32 * e;
          const int src = i < p.n ? i : p.n - 1;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float d0 = __fsub_rn(p.x[a * p.n_pad + src], ref[a]);
            const float d = __fsub_rn(d0, __fmul_rn(L[a].L, round_div(d0, a)));
            lo[a] = nan_min(lo[a], d);
            hi[a] = nan_max(hi[a], d);
          }
        }
      }
    };
    unsigned outside = 0;
    fold([&](float d, int a) {
      outside |= fabsf(d) <= L[a].lim ? 0u : 1u;
      return rint_by_compares(d, L[a]);
    });
    if (__any_sync(kFull, outside != 0)) {
      fold([&](float d, int a) { return rintf(__fdiv_rn(d, L[a].L)); });
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a] = nan_min(lo[a], __shfl_xor_sync(kFull, lo[a], off));
        hi[a] = nan_max(hi[a], __shfl_xor_sync(kFull, hi[a], off));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float* cen = rows_here ? rcen + a * nr : ccen + a * nc;
        float* hal = rows_here ? rhal + a * nr : chal + a * nc;
        cen[tile] = __fadd_rn(ref[a], __fmul_rn(0.5f, __fadd_rn(lo[a], hi[a])));
        hal[tile] = __fmul_rn(0.5f, __fsub_rn(hi[a], lo[a]));
      }
    }
  }
  if (tid == 0) p.ptr2[0] = 0;
  __syncthreads();

  const Boxes b{rcen, rhal, ccen, chal, nr, nc};
  const float bound_x =
      __fsub_rn(__fsub_rn(__fmul_rn(0.5f, L[0].L), p.cutoff), p.slack);
  const unsigned below = (1u << lane) - 1u;
  bool bad = false;  // a kept pair of this thread over the shift bound
  int run = 0;       // entries of the earlier passes (warp 0)
  for (int r0 = 0, pass = 0; r0 < nr; r0 += g.rows, ++pass) {
    int* set = pass_sh + (pass & 1) * pass_ints(g);
    unsigned* gmask = reinterpret_cast<unsigned*>(set);
    unsigned* fmask = gmask + g.words;
    int* gpre = set + 2 * g.words;
    int* fpre = gpre + g.words;
    int* base = fpre + g.words;
    int* gen = base + 32;
    const int rows = min(g.rows, nr - r0), words = rows * g.ncw;

    // one kept() a pair: warp w takes word w of the pass, a lane a column
    for (int w = warp; w < words; w += warps) {
      const int r = r0 + w / g.ncw, c = (w % g.ncw) * 32 + lane;
      bool keep = false, general = false;
      float hx = 0.0f;
      unsigned outside = 0;
      if (c < nc) {
        keep = kept(p, b, L, r, c, [&](float d, int a) {
          outside |= fabsf(d) <= L[a].lim ? 0u : 1u;
          return rint_by_compares(d, L[a]);
        }, general, hx);
      }
      if (__any_sync(kFull, outside != 0) && c < nc) {
        keep = kept(p, b, L, r, c, [&](float d, int a) {
          return rintf(__fdiv_rn(d, L[a].L));
        }, general, hx);
      }
      bad = bad || (keep && hx > bound_x);
      const unsigned gm = __ballot_sync(kFull, keep && general);
      const unsigned fm = __ballot_sync(kFull, keep && !general);
      if (lane == 0) {
        gmask[w] = gm;
        fmask[w] = fm;
      }
    }
    __syncthreads();

    // warp 0: a lane a row, its counts and its words' prefixes, then the
    // exclusive scan of the rows' entries over the running total
    if (warp == 0) {
      int gsum = 0, fsum = 0;
      if (lane < rows) {
        for (int k = lane * g.ncw; k < (lane + 1) * g.ncw; ++k) {
          gpre[k] = gsum;
          fpre[k] = fsum;
          gsum += __popc(gmask[k]);
          fsum += __popc(fmask[k]);
        }
      }
      int incl = gsum + fsum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += up;
      }
      incl += run;
      if (lane < rows) {
        const int r = r0 + lane;
        base[lane] = incl - gsum - fsum;
        gen[lane] = gsum;
        p.ptr2[2 * r + 1] = min(incl - fsum, p.capacity);
        p.ptr2[2 * r + 2] = min(incl, p.capacity);
        p.rowcx[r] = rcen[r];
      }
      run = __shfl_sync(kFull, incl, 31);
    }
    __syncthreads();

    // each kept pair writes its own slot, general entries before fast ones
    for (int w = warp; w < words; w += warps) {
      const unsigned gm = gmask[w], fm = fmask[w], bit = 1u << lane;
      if (((gm | fm) & bit) == 0) continue;
      const int i = w / g.ncw, r = r0 + i, c = (w % g.ncw) * 32 + lane;
      const int slot = (gm & bit) != 0
                           ? base[i] + gpre[w] + __popc(gm & below)
                           : base[i] + gen[i] + fpre[w] + __popc(fm & below);
      if (slot >= p.capacity) continue;
      const float cx = ccen[c];
      p.rows[slot] = r;
      p.cols[slot] = c;
      p.ccx[slot] = __fadd_rn(
          cx, __fmul_rn(rint_div(__fsub_rn(rcen[r], cx), L[0]), L[0].L));
    }
  }

  if (tid == 0) *total_sh = run;
  const bool any_bad = __syncthreads_or(bad) != 0;
  const int total = *total_sh;
  const int count = min(total, p.capacity);
  if (tid == 0) {
    p.count[0] = count;
    p.over[0] = total > p.capacity || any_bad;
  }
  for (int k = count + tid; k < p.capacity; k += nth) {
    p.rows[k] = 0;
    p.cols[k] = 0;
    p.ccx[k] = 0.0f;
  }
}

}  // namespace tile_build
