// The per-device banded pair kernel of particle-axis sharding (K8b).
//
// Replaces chiron_tpu/parallel/spatial.py: _make_row_band_force (pallas_call
// at :547).  K8a (_make_row_slab_force, :126) runs K1's kernel: see
// chiron_row_slab_force in lj_dense.cu.
//
// K8b takes a slab of rows_per_dev rows at global row offset `off` and
// writes only those rows' forces.  A block owns 32 rows (one a lane) and 8
// column groups (one warp each): no reaction writes, no atomics, and a
// row's force depends only on its global index, so slabs at any offsets
// (multiples of 32) concatenate to the one-slab result bit for bit.
//
// The rows of the x-sorted layout against the cyclic rank band
// 1 <= delta <= w or delta >= n - w over the n live ranks, both directions.
// The JAX kernel takes, for each tm-row tile, the window of nbt column tiles
// starting at tile (rt - K) mod n_tiles.  Here each warp walks that
// window's chunks of kColTile columns, taking columns g * 32 .. g * 32 + 31
// of each in order (the order of every row's sum), and computes only
// the chunks that hold a band pair of a row of its block (about 2w + 32 of
// the nbt x tm columns) and, by the x ranges of its rows and columns
// (band::x_apart), a pair within the cutoff in x (about six in ten of
// those at N = 100,000).  The loads of a chunk are issued while the chunk
// before is computed; each warp stages its own 32 columns, so no block
// barrier is taken.  Within a chunk, as in lj_band.cu: the distances of
// kDist columns first, then a warp vote a column (32 rows against one
// broadcast column) and the LJ term only under it, the rank mask only on
// chunks at the band's edge, the minimum image by compares where the
// chunk's and the rows' coordinates lie in [-L/8, 9L/8], and none in x
// where their x ranges show every x image to be 0.  A chunk with a
// coordinate outside that range, or not finite, takes every slot (kWhole:
// floor images, the mask and the LJ term on each, also on a chunk outside
// the band), so a NaN reaches every row a masked 0 times NaN reaches; on a
// finite state the result has the bits of taking every slot.
//
// It takes the Newton-refined reciprocal (approx_recip=False in JAX).
// Bound: pair arithmetic.  The positions stay in L2.
#include "common.cuh"

namespace {

constexpr int kRows = 32;       // row particles per block: one per lane
constexpr int kGroups = 8;      // column groups per block: one warp each
constexpr int kColTile = 256;   // window columns a block takes per pass
constexpr int kPerGroup = kColTile / kGroups;
static_assert(kPerGroup == kRows, "K8b stages a column a lane");

struct LJ {
  float sigma2, coef_scale, cutoff2, r2_floor;
};

// One pair of K8b from the row's side after the image, one rounding an op
// (the coefficient (2 i12 - i6) coef_scale inv, the sums fused): coef is 0
// where m is false, so such a pair adds +-0 to sums that never hold -0.
__device__ __forceinline__ void band_term(float r2, bool m, float dx,
                                          float dy, float dz, const LJ& lj,
                                          float& fx, float& fy, float& fz) {
  const float r2s = fmaxf(r2, lj.r2_floor);
  const float inv = lj_recip(r2s, false);
  const float ir2 = __fmul_rn(lj.sigma2, inv);
  const float i6 = __fmul_rn(ir2, __fmul_rn(ir2, ir2));
  const float i12 = __fmul_rn(i6, i6);
  const float coef =
      m ? __fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(2.0f, i12), i6),
                              lj.coef_scale),
                    inv)
        : 0.0f;
  fx = __fmaf_rn(coef, dx, fx);
  fy = __fmaf_rn(coef, dy, fy);
  fz = __fmaf_rn(coef, dz, fz);
}

// The block's live rows [r0, r0 + m) against the column of rank col: whether
// col is in the band of some row, and (all) of every row.  The distances
// (col - r) mod n of the rows run down from d0 = (col - r0) mod n over m
// values.
__device__ __forceinline__ bool band_column(int col, int r0, int m, int n,
                                            int w, bool& all) {
  all = false;
  if (m <= 0 || col >= n) return false;
  int d0 = col - r0;
  if (d0 < 0) d0 += n;
  const int lo = d0 - (m - 1);
  if (lo < 0) return true;  // down through 0 to n - 1, which is in the band
  const bool gap = w + 1 <= n - w - 1;  // the distances no row takes
  all = lo >= 1 && !(gap && lo <= n - w - 1 && d0 >= w + 1);
  return (lo <= w && d0 >= 1) || d0 >= n - w;
}

// The lane's column of the window chunk at c0 (window-local): (x, y, z,
// rank); beyond the window the position 0 and the dead rank n.
__device__ __forceinline__ float4 window_column(const float* pos, int n,
                                                int n_pad, int base,
                                                int width, int c0) {
  const int cl = c0 + threadIdx.y * kPerGroup + threadIdx.x;
  if (cl >= width) return make_float4(0.0f, 0.0f, 0.0f, __int_as_float(n));
  int c = base + cl;
  if (c >= n_pad) c -= n_pad;  // width <= n_pad: one wrap at most
  return make_float4(pos[c], pos[n_pad + c], pos[2 * n_pad + c],
                     __int_as_float(c));
}

// Whether column rank col counts for row gid: live, and the cyclic rank
// distance over the n live ranks in the band (row_ok is in c2_row).
__device__ __forceinline__ bool in_band(int col, int gid, int n, int w) {
  int delta = col - gid;
  if (delta < 0) delta += n;
  return col < n && delta >= 1 && (delta <= w || delta >= n - w);
}

// A warp's row (one a lane) against its 32 staged columns of one chunk.
// kWhole takes every pair in order.  The
// other kinds take kDist columns at a time: their distances first
// (independent chains; a pair outside the band gets r^2 = cutoff^2, which
// no vote takes), then for each column a warp vote, and under it the
// displacement again (the same bits) and the LJ term.
template <band::Visit kMode>
__device__ __forceinline__ void band_chunk(const float4* cols, int gid, int n,
                                           int w, float xi, float yi,
                                           float zi, float c2_row,
                                           const band::Geometry& geo,
                                           const LJ& lj, float& fx,
                                           float& fy, float& fz) {
  constexpr int kDist = 4;
  float dx, dy, dz;
  if constexpr (kMode == band::kWhole) {
    for (int q = 0; q < kPerGroup; ++q) {
      const float4 c = cols[q];
      band::displacement<band::kWhole>(xi, yi, zi, c.x, c.y, c.z, geo, dx,
                                       dy, dz);
      const float r2 = band::norm2(dx, dy, dz);
      const bool m = r2 < c2_row && in_band(__float_as_int(c.w), gid, n, w);
      band_term(r2, m, dx, dy, dz, lj, fx, fy, fz);
    }
  } else {
    for (int q0 = 0; q0 < kPerGroup; q0 += kDist) {
      float r2[kDist];
#pragma unroll
      for (int j = 0; j < kDist; ++j) {
        const float4 c = cols[q0 + j];
        band::displacement<kMode>(xi, yi, zi, c.x, c.y, c.z, geo, dx, dy, dz);
        r2[j] = band::norm2(dx, dy, dz);
        if constexpr (kMode == band::kEdge)
          if (!in_band(__float_as_int(c.w), gid, n, w)) r2[j] = lj.cutoff2;
      }
#pragma unroll
      for (int j = 0; j < kDist; ++j) {
        const bool m = r2[j] < c2_row;  // c2_row < 0 on a padding row
        if (__any_sync(band::kFull, m)) {
          const float4 c = cols[q0 + j];
          band::displacement<kMode>(xi, yi, zi, c.x, c.y, c.z, geo, dx, dy,
                                    dz);
          band_term(r2[j], m, dx, dy, dz, lj, fx, fy, fz);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kRows * kGroups)
row_band_rows(const float* __restrict__ pos, const float* __restrict__ box,
              float* __restrict__ force, int n, int n_pad, int rows_per_dev,
              int off, int tm, int w, int K, int nbt, int skip, LJ lj) {
  using band::kFull;
  __shared__ float4 stage[kGroups][kPerGroup];
  __shared__ float red[kGroups][3][kRows];
  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int r = blockIdx.x * kRows + lane;
  const int gid = off + r;
  const band::Geometry geo = band::geometry(box);
  const float xi = pos[gid], yi = pos[n_pad + gid], zi = pos[2 * n_pad + gid];
  const bool row_ok = gid < n;
  const float c2_row = row_ok ? lj.cutoff2 : -1.0f;
  const bool rows_ok =
      __all_sync(kFull, band::in_range(xi, yi, zi, geo)) && geo.ok;
  // the live rows' x range (a padding row's x image never reaches a sum)
  const float rlo = band::key_value(__reduce_min_sync(
      kFull, row_ok ? band::order_key(xi) : 0x7fffffff));
  const float rhi = band::key_value(__reduce_max_sync(
      kFull, row_ok ? band::order_key(xi) : static_cast<int>(0x80000000)));
  const int r0 = off + blockIdx.x * kRows;
  const int m_rows = min(max(n - r0, 0), kRows);
  // the window of the row tile this block lies in (tm is a multiple of 32)
  const int n_tiles = n_pad / tm;
  const int rt = r0 / tm;
  const int first = ((rt - K) % n_tiles + n_tiles) % n_tiles;
  const int width = nbt * tm;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;

  float4 next = window_column(pos, n, n_pad, first * tm, width, 0);
  for (int c0 = 0; c0 < width; c0 += kColTile) {
    const float4 mine = next;
    if (c0 + kColTile < width)
      next = window_column(pos, n, n_pad, first * tm, width, c0 + kColTile);
    band::Visit mode = band::kWhole;
    if (skip && rows_ok &&
        __all_sync(kFull, band::in_range(mine.x, mine.y, mine.z, geo))) {
      bool all;
      const bool any =
          band_column(__float_as_int(mine.w), r0, m_rows, n, w, all);
      if (!__any_sync(kFull, any)) continue;  // no pair of the band, or
      // none within the cutoff by x alone
      const float clo = band::key_value(
          __reduce_min_sync(kFull, band::order_key(mine.x)));
      const float chi = band::key_value(
          __reduce_max_sync(kFull, band::order_key(mine.x)));
      const bool x0 = band::x_image_zero(rlo, rhi, clo, chi, geo.a[0]);
      if (x0 && band::x_apart(rlo, rhi, clo, chi, lj.cutoff2)) continue;
      mode = x0 && __all_sync(kFull, all) ? band::kInterior : band::kEdge;
    }
    __syncwarp();  // the previous chunk's columns have been read
    stage[g][lane] = mine;
    __syncwarp();
    if (mode == band::kInterior) {
      band_chunk<band::kInterior>(stage[g], gid, n, w, xi, yi, zi, c2_row,
                                  geo, lj, fx, fy, fz);
    } else if (mode == band::kEdge) {
      band_chunk<band::kEdge>(stage[g], gid, n, w, xi, yi, zi, c2_row, geo,
                              lj, fx, fy, fz);
    } else {
      band_chunk<band::kWhole>(stage[g], gid, n, w, xi, yi, zi, c2_row, geo,
                               lj, fx, fy, fz);
    }
  }
  // the column groups' sums of each row, added in group order
  red[g][0][lane] = fx;
  red[g][1][lane] = fy;
  red[g][2][lane] = fz;
  __syncthreads();
  if (g == 0) {
    float sfx = 0.0f, sfy = 0.0f, sfz = 0.0f;
    for (int k = 0; k < kGroups; ++k) {
      sfx += red[k][0][lane];
      sfy += red[k][1][lane];
      sfz += red[k][2][lane];
    }
    force[r] = sfx;
    force[rows_per_dev + r] = sfy;
    force[2 * rows_per_dev + r] = sfz;
  }
}

}  // namespace

// K8b.  pos: (3, n_pad) f32, x-sorted; box: (3,) f32; force: (3,
// rows_per_dev) f32 for rows [off, off + rows_per_dev).  tm divides n_pad
// and is a multiple of 32, rows_per_dev and off are multiples of 32, and the
// window is nbt <= n_pad / tm column tiles.  skip = 0 takes every slot of
// the window (kWhole): the reference whose bits the skips keep on a finite
// state (for tests).
CHIRON_EXPORT int chiron_row_band_force(const float* pos, const float* box,
                                        float* force, int n, int n_pad,
                                        int rows_per_dev, int off, int tm,
                                        int w, int K, int nbt, float sigma2,
                                        float coef_scale, float cutoff2,
                                        float r2_floor, int skip,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LJ lj{sigma2, coef_scale, cutoff2, r2_floor};
  row_band_rows<<<rows_per_dev / kRows, dim3(kRows, kGroups), 0, s>>>(
      pos, box, force, n, n_pad, rows_per_dev, off, tm, w, K, nbt, skip, lj);
  return static_cast<int>(cudaGetLastError());
}
