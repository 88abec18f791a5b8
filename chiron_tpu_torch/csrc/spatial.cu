// The per-device pair kernels of particle-axis sharding (K8).
//
// Replaces chiron_tpu/parallel/spatial.py: _make_row_slab_force (K8a,
// pallas_call at :126) and _make_row_band_force (K8b, pallas_call at :547).
//
// Both take a slab of rows_per_dev rows at global row offset `off` and write
// only those rows' forces.  A block owns 32 rows (one a lane) and 8 column
// groups (one warp each), as lj_dense_rows does: no reaction writes, no
// atomics, and a row's force depends only on its global index, so slabs at
// any offsets (multiples of 32) concatenate to the one-slab result bit for
// bit.
//
// K8a: the slab (its own array) against every column of the gathered
// positions.  The kEnergy instantiation also sums the slab's pair energy,
// every pair counted from its row's side only and not halved: the caller
// halves the rank-ordered total over the slabs.  Each thread keeps a
// compensated sum, a block folds its threads' sums in a fixed order into a
// slot of e_part, and one thread sums the slots in order.
//
// K8b: the rows of the x-sorted layout against the cyclic rank band
// 1 <= delta <= w or delta >= n - w over the n live ranks, both directions.
// A block takes the column window of the tm-row tile it lies in, nbt column
// tiles starting at tile (rt - K) mod n_tiles, as the JAX kernel does, so
// every row sees the pairs the JAX program sees.
//
// Both take the Newton-refined reciprocal (approx_recip=False in JAX).
// Bound: pair arithmetic.  The positions stay in L2, and each block stages
// kColTile columns at a time in shared memory, which all lanes of a warp
// read at one address (a broadcast).
#include "common.cuh"

namespace {

constexpr int kRows = 32;       // row particles per block: one per lane
constexpr int kGroups = 8;      // column groups per block: one warp each
constexpr int kColTile = 256;   // columns staged in shared memory per pass
constexpr int kPerGroup = kColTile / kGroups;

struct LJ {
  float sigma2, coef_scale, eps4, cutoff2, r2_floor;
};

struct Box {
  float Lx, Ly, Lz, iLx, iLy, iLz;
};

__device__ __forceinline__ Box load_box(const float* box) {
  const float Lx = box[0], Ly = box[1], Lz = box[2];
  return {Lx, Ly, Lz, 1.0f / Lx, 1.0f / Ly, 1.0f / Lz};
}

// One pair from the row's side: the minimum image by floor(d/L + 1/2), r^2
// clamped before the reciprocal, the LJ force (and energy) where `live`
// and r^2 < cutoff^2.
template <bool kEnergy>
__device__ __forceinline__ void pair_term(float xi, float yi, float zi,
                                          float xj, float yj, float zj,
                                          bool live, const Box& b,
                                          const LJ& lj, float& fx, float& fy,
                                          float& fz, float& e, float& ec) {
  float dx = xi - xj;
  float dy = yi - yj;
  float dz = zi - zj;
  dx = dx - b.Lx * floorf(dx * b.iLx + 0.5f);
  dy = dy - b.Ly * floorf(dy * b.iLy + 0.5f);
  dz = dz - b.Lz * floorf(dz * b.iLz + 0.5f);
  const float r2 = dx * dx + dy * dy + dz * dz;
  const bool m = (r2 < lj.cutoff2) && live;
  const float r2s = fmaxf(r2, lj.r2_floor);
  const float inv = lj_recip(r2s, false);
  const float ir2 = lj.sigma2 * inv;
  const float i6 = ir2 * ir2 * ir2;
  const float i12 = i6 * i6;
  const float coef = m ? lj.coef_scale * (2.0f * i12 - i6) * inv : 0.0f;
  fx += coef * dx;
  fy += coef * dy;
  fz += coef * dz;
  if (kEnergy) kahan_add(e, ec, m ? lj.eps4 * (i12 - i6) : 0.0f);
}

// The block's closing: the kGroups column groups' sums of each row, added
// in group order, to the slab's force (three rows of stride rows_per_dev);
// with kEnergy the block's energy, Kahan-added in thread order, to *e_out.
template <bool kEnergy>
__device__ __forceinline__ void store_rows(float (&red)[kGroups][4][kRows],
                                           float fx, float fy, float fz,
                                           float e, float* force,
                                           int rows_per_dev, int r,
                                           float* e_out) {
  const int lane = threadIdx.x, g = threadIdx.y;
  red[g][0][lane] = fx;
  red[g][1][lane] = fy;
  red[g][2][lane] = fz;
  red[g][3][lane] = e;
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
  if (kEnergy && g == 0 && lane == 0) {
    float acc = 0.0f, comp = 0.0f;
    for (int k = 0; k < kGroups; ++k)
      for (int l = 0; l < kRows; ++l) kahan_add(acc, comp, red[k][3][l]);
    *e_out = acc - comp;
  }
}

template <bool kEnergy>
__global__ void __launch_bounds__(kRows * kGroups)
row_slab_rows(const float* __restrict__ rows, const float* __restrict__ pos,
              const float* __restrict__ box, float* __restrict__ force,
              float* __restrict__ e_part, int n, int n_pad, int rows_per_dev,
              int off, LJ lj) {
  __shared__ float sx[kColTile], sy[kColTile], sz[kColTile];
  __shared__ float red[kGroups][4][kRows];
  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int tid = g * kRows + lane;
  const int r = blockIdx.x * kRows + lane;
  const int gid = off + r;
  const Box b = load_box(box);
  const float xi = rows[r], yi = rows[rows_per_dev + r];
  const float zi = rows[2 * rows_per_dev + r];
  const bool row_ok = gid < n;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f, e = 0.0f, ec = 0.0f;

  for (int c0 = 0; c0 < n_pad; c0 += kColTile) {
    __syncthreads();  // the previous tile has been consumed
    for (int t = tid; t < kColTile; t += kRows * kGroups) {
      const int c = c0 + t;
      const bool in = c < n_pad;
      sx[t] = in ? pos[c] : 0.0f;
      sy[t] = in ? pos[n_pad + c] : 0.0f;
      sz[t] = in ? pos[2 * n_pad + c] : 0.0f;
    }
    __syncthreads();
    for (int q = 0; q < kPerGroup; ++q) {
      const int t = g * kPerGroup + q;
      const int col = c0 + t;
      pair_term<kEnergy>(xi, yi, zi, sx[t], sy[t], sz[t],
                         row_ok && col < n && col != gid, b, lj, fx, fy, fz,
                         e, ec);
    }
  }
  store_rows<kEnergy>(red, fx, fy, fz, e - ec, force, rows_per_dev, r,
                      kEnergy ? e_part + blockIdx.x : nullptr);
}

__global__ void slab_energy_sum(const float* __restrict__ e_part, int n_parts,
                                float* __restrict__ energy) {
  energy[0] = pair_pass::sum_energy_partials(e_part, n_parts);
}

__global__ void __launch_bounds__(kRows * kGroups)
row_band_rows(const float* __restrict__ pos, const float* __restrict__ box,
              float* __restrict__ force, int n, int n_pad, int rows_per_dev,
              int off, int tm, int w, int K, int nbt, LJ lj) {
  __shared__ float sx[kColTile], sy[kColTile], sz[kColTile];
  __shared__ int scol[kColTile];
  __shared__ float red[kGroups][4][kRows];
  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int tid = g * kRows + lane;
  const int r = blockIdx.x * kRows + lane;
  const int gid = off + r;
  const Box b = load_box(box);
  const float xi = pos[gid], yi = pos[n_pad + gid], zi = pos[2 * n_pad + gid];
  const bool row_ok = gid < n;
  // the window of the row tile this block lies in (tm is a multiple of 32)
  const int n_tiles = n_pad / tm;
  const int rt = (off + blockIdx.x * kRows) / tm;
  const int first = ((rt - K) % n_tiles + n_tiles) % n_tiles;
  const int width = nbt * tm;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f, e = 0.0f, ec = 0.0f;

  for (int c0 = 0; c0 < width; c0 += kColTile) {
    __syncthreads();
    for (int t = tid; t < kColTile; t += kRows * kGroups) {
      const int cl = c0 + t;
      const bool in = cl < width;
      int c = first * tm + cl;
      if (c >= n_pad) c -= n_pad;  // width <= n_pad: one wrap at most
      sx[t] = in ? pos[c] : 0.0f;
      sy[t] = in ? pos[n_pad + c] : 0.0f;
      sz[t] = in ? pos[2 * n_pad + c] : 0.0f;
      scol[t] = in ? c : n;  // outside the window: a dead column
    }
    __syncthreads();
    for (int q = 0; q < kPerGroup; ++q) {
      const int t = g * kPerGroup + q;
      const int col = scol[t];
      int delta = col - gid;  // cyclic rank distance over the n live ranks
      if (delta < 0) delta += n;
      const bool live = row_ok && col < n && delta >= 1 &&
                        (delta <= w || delta >= n - w);
      pair_term<false>(xi, yi, zi, sx[t], sy[t], sz[t], live, b, lj, fx, fy,
                       fz, e, ec);
    }
  }
  store_rows<false>(red, fx, fy, fz, 0.0f, force, rows_per_dev, r, nullptr);
}

}  // namespace

// K8a.  rows, force: (3, rows_per_dev) f32; pos: (3, n_pad) f32; box: (3,)
// f32; e_part: (rows_per_dev / 32,) f32 scratch and energy: (1,) f32, both
// used only with_energy.  rows_per_dev and off are multiples of 32 and
// off + rows_per_dev <= n_pad.
CHIRON_EXPORT int chiron_row_slab_force(const float* rows, const float* pos,
                                        const float* box, float* force,
                                        float* e_part, float* energy, int n,
                                        int n_pad, int rows_per_dev, int off,
                                        float sigma2, float coef_scale,
                                        float eps4, float cutoff2,
                                        float r2_floor, int with_energy,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = rows_per_dev / kRows;
  const LJ lj{sigma2, coef_scale, eps4, cutoff2, r2_floor};
  const dim3 threads(kRows, kGroups);
  if (with_energy) {
    row_slab_rows<true><<<blocks, threads, 0, s>>>(
        rows, pos, box, force, e_part, n, n_pad, rows_per_dev, off, lj);
    slab_energy_sum<<<1, 1, 0, s>>>(e_part, blocks, energy);
  } else {
    row_slab_rows<false><<<blocks, threads, 0, s>>>(
        rows, pos, box, force, e_part, n, n_pad, rows_per_dev, off, lj);
  }
  return static_cast<int>(cudaGetLastError());
}

// K8b.  pos: (3, n_pad) f32, x-sorted; box: (3,) f32; force: (3,
// rows_per_dev) f32 for rows [off, off + rows_per_dev).  tm divides n_pad
// and is a multiple of 32, rows_per_dev and off are multiples of 32, and the
// window is nbt <= n_pad / tm column tiles.
CHIRON_EXPORT int chiron_row_band_force(const float* pos, const float* box,
                                        float* force, int n, int n_pad,
                                        int rows_per_dev, int off, int tm,
                                        int w, int K, int nbt, float sigma2,
                                        float coef_scale, float cutoff2,
                                        float r2_floor, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LJ lj{sigma2, coef_scale, 0.0f, cutoff2, r2_floor};
  row_band_rows<<<rows_per_dev / kRows, dim3(kRows, kGroups), 0, s>>>(
      pos, box, force, n, n_pad, rows_per_dev, off, tm, w, K, nbt, lj);
  return static_cast<int>(cudaGetLastError());
}
