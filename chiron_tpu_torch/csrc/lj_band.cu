// Banded LJ force (and single-count energy) over x-sorted particles (K6).
//
// Replaces chiron_tpu/ops/lj_band.py: _make_band_kernel (:40), launched by
// band_force_raw (pallas_call at :160) and band_force_energy_raw (:188).
// Semantics as there: row tile i visits the n_band column tiles
// (i + k) mod n_tiles, k < n_band; a pair counts when both ranks are live
// (< n) and the cyclic rank distance (cid - rid + n) mod n is in [1, w], so
// each unordered pair is taken once; full minimum image on all three axes;
// r^2 clamped at 1e-4 sigma^2; coef = 24 eps (2 i6^2 - i6) / r^2 with
// i6 = (sigma^2 / r^2)^3; the row gets +coef d and the column -coef d.
//
// The TPU kernel subtracts the column reactions straight from the force
// block of other tiles, race-free only because its grid runs in order.
// Here, as in lj_cull_force.cu and with its reductions (common.cuh), on
// square sub-tiles of ts = tm rows up to 256 (ts = 256 where it divides a
// wider tm, else 128; C = tm / ts of them a tile), so that a thread's rows
// and the block's shared memory stay those of tm = 256 whatever the tile:
//   1. band_rows: block (x, s) owns row sub-tile x (chunk x mod C of row
//      tile i = x / C) and visits k = s, s + S, ...: each visit (i, k)
//      is C sub-visits, column chunks b = 0 .. C-1 of tile (i + k) mod
//      n_tiles.  A thread holds RPT rows against every kCG-th column; each
//      sub-visit's column partials are reduced over the kRG row groups in a
//      fixed order into R[(x n_band + k) C + b] (3 x ts), and the row sums
//      into P[s].
//   2. band_gather: each particle, in chunk b of its tile c, sums P[0..S)
//      and subtracts, for k in order and then a, the partial of sub-tile
//      a of row tile (c - k) mod n_tiles.
// Every sum has one order, so a repeated call is bitwise identical; at
// C = 1 the layout is that of one block a row tile.  The scratch R is
// n_tiles x n_band x 3 x tm x C floats (54 MB at N = 100,000, tm = 256,
// w = 10,859): written once and read once a call.
//
// Bound: pair arithmetic, the distance test on the band pairs within the
// cutoff in x and the LJ term on the few (about 0.4% of the slots at
// N = 100,000) within the cutoff.  The kernel visits n_tiles x n_band x tm^2
// slots, and the design makes a slot cost about a distance test:
//   * a visit whose x ranges show every pair to lie at least the cutoff
//     apart in x (band::x_apart; about a third of them at N = 100,000, where
//     the band reaches past the cutoff) is skipped whole: its column sums
//     are 0;
//   * the LJ term runs only on the rows a warp needs: for each column each
//     lane takes its RPT distances first, with no branch, into a bit a row
//     of the live pairs within the cutoff; the warp ORs its bits (one
//     reduction) and takes the reciprocal, the powers and the sums, in row
//     order, only on the rows whose bit is set (about one in six);
//   * the rank mask is taken per visit: a visit whose every rank pair is
//     live and in the band takes no per-slot mask, and only the edge visits
//     (the diagonal tile, the band's end, the padding and the wrap) take the
//     integer mask;
//   * the minimum image by compares (band::compare_image) where the visit's
//     coordinates lie in [-L/8, 9L/8], as the runners' wrapped positions
//     do, and none at all in x where the visit's x ranges show that every
//     x displacement takes the image 0;
//   * the row sums live in shared memory (only an LJ term touches them), so
//     that a thread's rows take 128 registers and two blocks share an SM.
// A skipped slot would have added +-0 to sums that never hold -0, so on a
// finite state the result has the bits of taking every slot (kWhole, which
// skip = 0 selects for tests): each slot's arithmetic is written op for op
// in _rn intrinsics (r^2 = fma(dz, dz, fma(dx, dx, dy dy)), the coefficient
// fma(i6 + i6, i6, -i6) coef_scale inv, the products and sums unfused), in
// one order.  A visit with a coordinate out of that range, or not finite,
// takes every slot (floor images, the mask and the LJ term on each), so a
// NaN reaches every sum a masked 0 times NaN reaches.  The energy
// instantiation sums eps4 (i6^2 - i6) over the same pairs with the exact
// reciprocal (two Newton steps on the rcp.approx seed, lj_newton2), in
// compensated per-thread sums folded in a fixed order; a 0 term is skipped
// only where it would not move the compensated sum.
#include "common.cuh"

using namespace pair_pass;

namespace {

using band::kFull;
using band::Visit;
using band::kInterior;
using band::kEdge;
using band::kWhole;
using band::kApart;
constexpr int kWarps = kThreads / 32;

struct Params {
  const float* x;   // (3, n_pad) x-sorted positions
  const float* box; // (3,)
  float* P;         // (S, 3, n_pad) row partials
  float* R;         // (n_tiles C n_band C, 3, ts) column partials
  float* e_part;    // (n_tiles C S,) energy partials
  float* F;         // (3, n_pad) output force
  float* energy;    // (1,) output energy, or null
  int n, n_pad, tm, ts, n_sub, w, n_tiles, n_band;  // n_sub = C = tm / ts
  float sigma2, cutoff2, r2_floor, coef_scale, eps4;
  int approx;
  int skip;  // 0: every visit as kWhole, the reference for tests
};

// What a block knows of a set of points it holds, one or none a thread:
// whether all lie where compare_image holds, and their least and greatest x.
struct Points {
  bool ok = true;
  int lo = 0x7fffffff, hi = static_cast<int>(0x80000000);

  __device__ __forceinline__ void add(float x, float y, float z,
                                      const band::Geometry& g) {
    ok = ok && band::in_range(x, y, z, g);
    lo = min(lo, band::order_key(x));
    hi = max(hi, band::order_key(x));
  }

  // Each warp's values to vis[warp]; after the caller's __syncthreads,
  // gather() reads the block's.
  __device__ __forceinline__ void publish(int (*vis)[3]) const {
    const bool all = __all_sync(kFull, ok);
    const int l = __reduce_min_sync(kFull, lo);
    const int h = __reduce_max_sync(kFull, hi);
    if ((threadIdx.x & 31) == 0) {
      vis[threadIdx.x >> 5][0] = all;
      vis[threadIdx.x >> 5][1] = l;
      vis[threadIdx.x >> 5][2] = h;
    }
  }

  __device__ __forceinline__ void gather(const int (*vis)[3]) {
    for (int v = 0; v < kWarps; ++v) {
      ok = ok && vis[v][0] != 0;
      lo = min(lo, vis[v][1]);
      hi = max(hi, vis[v][2]);
    }
  }
};

// Whether every (row, column) rank pair of the visit is live and its cyclic
// distance in [1, w]: the distances cid - rid run over D - (tm-1) .. D +
// (tm-1), D = col0 - row0, each taken + n where negative.
__device__ __forceinline__ bool rank_interior(int row0, int col0, int tm,
                                              int n, int w) {
  if (row0 + tm > n || col0 + tm > n) return false;
  int lo = col0 - row0 - (tm - 1), hi = col0 - row0 + (tm - 1);
  if (hi < 0) {
    lo += n;
    hi += n;
  }
  return lo >= 1 && hi <= w;
}

// One slot's LJ term and its sums, one rounding an op: coef is 0 where m is
// false, so such a slot adds +-0 to the sums
// and, with kEnergy, a 0 term to the compensated energy.
template <bool kEnergy>
__device__ __forceinline__ void slot_term(const Params& p, float r2, bool m,
                                          float dx, float dy, float dz,
                                          float& fx, float& fy, float& fz,
                                          float& cx, float& cy, float& cz,
                                          float& ea, float& ec) {
  const float r2s = fmaxf(r2, p.r2_floor);
  const float seed = rcp_approx(r2s);
  const float inv = p.approx != 0 ? seed : lj_newton2(r2s, seed);
  const float i2 = __fmul_rn(p.sigma2, inv);
  const float i6 = __fmul_rn(i2, __fmul_rn(i2, i2));
  const float lj = __fmaf_rn(__fadd_rn(i6, i6), i6, -i6);
  const float coef = m ? __fmul_rn(__fmul_rn(lj, p.coef_scale), inv) : 0.0f;
  const float tx = __fmul_rn(coef, dx);
  const float ty = __fmul_rn(coef, dy);
  const float tz = __fmul_rn(coef, dz);
  fx = __fadd_rn(fx, tx);
  fy = __fadd_rn(fy, ty);
  fz = __fadd_rn(fz, tz);
  cx = __fadd_rn(cx, tx);
  cy = __fadd_rn(cy, ty);
  cz = __fadd_rn(cz, tz);
  if constexpr (kEnergy) {
    const float inv_e = p.approx != 0 ? lj_newton2(r2s, seed) : inv;
    const float i2e = __fmul_rn(p.sigma2, inv_e);
    const float i6e = __fmul_rn(i2e, __fmul_rn(i2e, i2e));
    kahan_add(ea, ec,
              m ? __fmul_rn(__fmaf_rn(i6e, i6e, -i6e), p.eps4) : 0.0f);
  }
}

// Whether a 0 term would move the compensated sum (ea, ec): it adds
// RN(0 - ec) to ea, and leaves ec as it is where ea does not move.
__device__ __forceinline__ bool zero_moves(float ea, float ec) {
  return __fadd_rn(ea, __fsub_rn(0.0f, ec)) != ea;
}

// Whether rank pair (rid, cid) counts: both live and (cid - rid + n) mod n
// in [1, w], without the division.
__device__ __forceinline__ bool in_band(int rid, int cid, int n, int w) {
  const int d = cid - rid;
  const int delta = d < 0 ? d + n : d;
  return rid < n && cid < n && delta >= 1 && delta <= w;
}

// The thread's RPT rows against its columns of one staged sub-tile, the
// visit's column sums of each column to red[rg][3][ts].  kWhole takes every
// slot in order.  The other kinds take,
// for each column, the RPT distances first (independent chains, with no
// branch) into a bit a row of the pairs within the cutoff, OR the warp's
// bits (one reduction), and take the LJ term, in row order, only on the
// rows whose bit some lane of the warp has set: the displacement again
// (the same bits) from the staged rows, the term, and its sums.
template <Visit kMode, int RPT, bool kEnergy>
__device__ __forceinline__ void visit_tile(
    const Params& p, const band::Geometry& g, const float* sx,
    const float* sy, const float* sz, const float* srow, float* red,
    int row0, int col0, const float (&xi)[RPT], const float (&yi)[RPT],
    const float (&zi)[RPT], float* fs, float& ea, float& ec, bool& moves) {
  constexpr unsigned kAll = (1u << RPT) - 1u;
  const int ts = p.ts, n = p.n;
  const int rg = threadIdx.x / kCG, cg = threadIdx.x % kCG;
  const int rid0 = row0 + rg * RPT;
  const float* rx = srow + rg * RPT;
  for (int t = cg; t < ts; t += kCG) {
    const int cid = col0 + t;
    const float xj = sx[t], yj = sy[t], zj = sz[t];
    float cx = 0.0f, cy = 0.0f, cz = 0.0f;
    float dx, dy, dz;
    if constexpr (kMode == kWhole) {
#pragma unroll
      for (int u = 0; u < RPT; ++u) {
        band::displacement<kWhole>(xi[u], yi[u], zi[u], xj, yj, zj, g, dx,
                                   dy, dz);
        const float r2 = band::norm2(dx, dy, dz);
        const bool m = r2 < p.cutoff2 && in_band(rid0 + u, cid, n, p.w);
        slot_term<kEnergy>(p, r2, m, dx, dy, dz, fs[u * kThreads],
                           fs[(RPT + u) * kThreads],
                           fs[(2 * RPT + u) * kThreads], cx, cy, cz, ea, ec);
        if constexpr (kEnergy) moves = zero_moves(ea, ec);
      }
    } else {
      unsigned bits = 0;
#pragma unroll
      for (int u = 0; u < RPT; ++u) {
        band::displacement<kMode>(xi[u], yi[u], zi[u], xj, yj, zj, g, dx, dy,
                                  dz);
        bool m = band::norm2(dx, dy, dz) < p.cutoff2;
        if constexpr (kMode == kEdge) m = m && in_band(rid0 + u, cid, n, p.w);
        bits |= m ? 1u << u : 0u;
      }
      unsigned fired = __reduce_or_sync(kFull, bits);
      // with kEnergy, a 0 term that would move a compensated sum is taken
      if (kEnergy && __any_sync(kFull, moves)) fired = kAll;
      while (fired != 0) {
        const int u = __ffs(fired) - 1;
        fired &= fired - 1;
        band::displacement<kMode>(rx[u], rx[ts + u], rx[2 * ts + u], xj, yj,
                                  zj, g, dx, dy, dz);
        slot_term<kEnergy>(p, band::norm2(dx, dy, dz), (bits >> u) & 1u, dx,
                           dy, dz, fs[u * kThreads], fs[(RPT + u) * kThreads],
                           fs[(2 * RPT + u) * kThreads], cx, cy, cz, ea, ec);
        if constexpr (kEnergy) {
          moves = zero_moves(ea, ec);
          if (__any_sync(kFull, moves)) fired |= kAll & ~((2u << u) - 1u);
        }
      }
    }
    red[(rg * 3 + 0) * ts + t] = cx;
    red[(rg * 3 + 1) * ts + t] = cy;
    red[(rg * 3 + 2) * ts + t] = cz;
  }
}

template <int RPT, bool kEnergy>
__global__ void __launch_bounds__(kThreads, 2) band_rows(Params p) {
  extern __shared__ float smem[];
  __shared__ int vis[kWarps][3];
  const int tm = p.tm, ts = p.ts, C = p.n_sub, n_pad = p.n_pad, n = p.n;
  float* sx = smem;
  float* sy = sx + ts;
  float* sz = sy + ts;
  float* red = sz + ts;  // [kRG][3][ts] columns, then [kCG][3][ts] rows
  // the thread's row sums, [3][RPT][kThreads]: only an LJ term touches them
  float* fs = red + kRG * 3 * ts + threadIdx.x;
  float* srow = fs - threadIdx.x + 3 * 16 * ts;  // the row sub-tile, [3][ts]
  const int sub = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int i = sub / C;  // the row tile
  const int tid = threadIdx.x, rg = tid / kCG;
  const int row0 = sub * ts;
  const band::Geometry g = band::geometry(p.box);

  float xi[RPT], yi[RPT], zi[RPT];
  Points rows;
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int r = row0 + rg * RPT + u;
    xi[u] = p.x[r];
    yi[u] = p.x[n_pad + r];
    zi[u] = p.x[2 * n_pad + r];
#pragma unroll
    for (int a = 0; a < 3; ++a) fs[(a * RPT + u) * kThreads] = 0.0f;
    rows.add(xi[u], yi[u], zi[u], g);
  }
  for (int t = tid; t < ts; t += kThreads) {
#pragma unroll
    for (int a = 0; a < 3; ++a) srow[a * ts + t] = p.x[a * n_pad + row0 + t];
  }
  rows.publish(vis);
  __syncthreads();
  rows.gather(vis);
  [[maybe_unused]] float ea = 0.0f, ec = 0.0f;
  bool moves = false;

  for (int k = split; k < p.n_band; k += n_split) {
    for (int b = 0; b < C; ++b) {
      const int col0 = ((i + k) % p.n_tiles) * tm + b * ts;
      __syncthreads();  // the previous visit's staging, flags and partials
      Points cols;
      for (int t = tid; t < ts; t += kThreads) {
        const float x = p.x[col0 + t], y = p.x[n_pad + col0 + t];
        const float z = p.x[2 * n_pad + col0 + t];
        sx[t] = x;
        sy[t] = y;
        sz[t] = z;
        cols.add(x, y, z, g);
      }
      cols.publish(vis);
      // with kEnergy, a 0 term that would move some thread's compensated
      // sum keeps its visit's slots
      const bool pinned = kEnergy ? __syncthreads_or(moves) : false;
      if constexpr (!kEnergy) __syncthreads();
      cols.gather(vis);
      const float rlo = band::key_value(rows.lo);
      const float rhi = band::key_value(rows.hi);
      const float clo = band::key_value(cols.lo);
      const float chi = band::key_value(cols.hi);
      const bool fast = p.skip && g.ok && rows.ok && cols.ok;
      const bool x0 = fast && band::x_image_zero(rlo, rhi, clo, chi, g.a[0]);
      const Visit mode =
          !fast ? kWhole
          : x0 && !pinned && band::x_apart(rlo, rhi, clo, chi, p.cutoff2)
              ? kApart
          : x0 && rank_interior(row0, col0, ts, n, p.w) ? kInterior
                                                        : kEdge;
      if (mode == kApart) {
        for (int t = tid % kCG; t < ts; t += kCG) {
#pragma unroll
          for (int a = 0; a < 3; ++a) red[(rg * 3 + a) * ts + t] = 0.0f;
        }
      } else if (mode == kInterior) {
        visit_tile<kInterior, RPT, kEnergy>(p, g, sx, sy, sz, srow, red, row0,
                                            col0, xi, yi, zi, fs, ea, ec,
                                            moves);
      } else if (mode == kEdge) {
        visit_tile<kEdge, RPT, kEnergy>(p, g, sx, sy, sz, srow, red, row0,
                                        col0, xi, yi, zi, fs, ea, ec, moves);
      } else {
        visit_tile<kWhole, RPT, kEnergy>(p, g, sx, sy, sz, srow, red, row0,
                                         col0, xi, yi, zi, fs, ea, ec, moves);
      }
      __syncthreads();
      store_col_partials(
          red, ts,
          p.R + ((static_cast<size_t>(sub) * p.n_band + k) * C + b) * 3 * ts);
    }
  }
  float fx[RPT], fy[RPT], fz[RPT];
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    fx[u] = fs[(0 * RPT + u) * kThreads];
    fy[u] = fs[(1 * RPT + u) * kThreads];
    fz[u] = fs[(2 * RPT + u) * kThreads];
  }
  store_row_partials<RPT>(
      red, ts, fx, fy, fz, p.P + static_cast<size_t>(split) * 3 * n_pad + row0,
      n_pad);
  if constexpr (kEnergy)
    store_energy_partial(red, ea - ec, p.e_part + sub * n_split + split);
}

__global__ void band_gather(Params p, int n_split, int n_parts) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p.n_pad) return;
  const int tm = p.tm, ts = p.ts, C = p.n_sub;
  const int c = q / tm, b = (q - c * tm) / ts, t = q - c * tm - b * ts;
  float f[3];
  sum_row_partials(p.P, n_split, p.n_pad, q, f);
  for (int k = 0; k < p.n_band; ++k) {
    const int i = (c - k + p.n_tiles) % p.n_tiles;
    for (int a = 0; a < C; ++a) {
      const float* Rk =
          p.R +
          ((static_cast<size_t>(i * C + a) * p.n_band + k) * C + b) * 3 * ts;
      f[0] -= Rk[t];
      f[1] -= Rk[ts + t];
      f[2] -= Rk[2 * ts + t];
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) p.F[a * p.n_pad + q] = f[a];
  if (p.energy != nullptr && q == 0)
    p.energy[0] = sum_energy_partials(p.e_part, n_parts);
}

template <int RPT>
cudaError_t launch_rows(const Params& p, int n_split, size_t smem,
                        cudaStream_t s) {
  const dim3 grid(p.n_tiles * p.n_sub, n_split);
  return p.energy != nullptr
             ? launch_pass(band_rows<RPT, true>, grid, smem, s, p)
             : launch_pass(band_rows<RPT, false>, grid, smem, s, p);
}

}  // namespace

// x, F: (3, n_pad) f32; box: (3,) f32; P: (n_split, 3, n_pad) f32; with
// ts = row_chunk(tm) and C = tm / ts: R: (n_pad / ts * n_band * C, 3,
// ts) f32; e_part: (n_pad / ts * n_split,) f32; energy: (1,) f32 or null
// (then the force-only instantiation runs).  tm must be 64 or a multiple of
// 128 and divide n_pad.  approx sets the force's reciprocal; the energy's
// is always exact.  skip = 0 takes every slot (kWhole): the reference whose
// bits the skips keep on a finite state (for tests).
CHIRON_EXPORT int chiron_band_force(
    const float* x, const float* box, float* P, float* R, float* e_part,
    float* F, float* energy, int n, int n_pad, int tm, int w, int n_band,
    int n_split, float sigma2, float cutoff2, float r2_floor,
    float coef_scale, float eps4, int approx, int skip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((tm != 64 && (tm <= 0 || tm % 128 != 0)) || n_pad % tm != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ts = row_chunk(tm);
  const int n_tiles = n_pad / tm;
  Params p{x,      box,    P,       R,        e_part,     F,    energy,
           n,      n_pad,  tm,      ts,       tm / ts,    w,    n_tiles,
           n_band, sigma2, cutoff2, r2_floor, coef_scale, eps4, approx,
           skip};
  // the staged sub-tile, red (kRG == kCG: the rows fit where the columns
  // were), the row sums (3 x RPT x kThreads = 3 x 16 ts) and the row
  // sub-tile
  const int floats = 3 * ts + kRG * 3 * ts + 3 * 16 * ts + 3 * ts;
  const size_t smem = static_cast<size_t>(floats) * sizeof(float);
  cudaError_t err;
  switch (ts / kRG) {
    case 4: err = launch_rows<4>(p, n_split, smem, s); break;
    case 8: err = launch_rows<8>(p, n_split, smem, s); break;
    case 16: err = launch_rows<16>(p, n_split, smem, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kGather = 256;
  band_gather<<<(n_pad + kGather - 1) / kGather, kGather, 0, s>>>(
      p, n_split, n_pad / ts * n_split);
  return static_cast<int>(cudaGetLastError());
}
