// All-pairs minimum-image Lennard-Jones force and energy (K1).
//
// Replaces chiron_tpu/ops/lj_dense.py: _make_triangle_kernel with
// _lj_tile_math, launched by _lj_dense_raw (pallas_call at :340).
//
// The TPU kernel visits each unordered tile pair once and writes the
// column reaction into one force block shared by its in-order grid.  Blocks
// on Hopper run in no order, so that reaction would race.  Here each block
// owns kRows row particles and visits every column: it writes only its own
// rows, so there are no reaction writes and no atomics, and the result is
// the same bit for bit on every run.  The price is twice the pair work of
// the triangle.
//
// Bound: pair arithmetic (about 30 f32 operations a pair, n_pad^2 pairs),
// not memory: the positions (3 x n_pad floats) stay in L2, and each
// block stages kColTile columns at a time in shared memory, which all
// threads of a warp read at one address (a broadcast).  A warp takes 32
// rows against one column group, so its accumulators stay in registers and
// the only reduction is a fixed-order sum over the kGroups column groups.
//
// Energy: every thread keeps a compensated sum over its columns; a block
// folds its threads' sums in a fixed order into one slot of e_part, and a
// second one-thread pass sums the slots in order (the 1e-6 design bar of
// lj_dense.py:195-201).  Each pair is seen from both sides, hence the 0.5.
//
// kDivide takes the minimum image as d - L floor(d / L + 1/2), the form of
// the fused MD kernel's force phase (chiron_tpu/ops/lj_md_fused.py:157-159),
// which lj_md_fused.cu launches through lj_dense_force_divide; K1 and K2
// multiply by 1/L (lj_dense.py:56-58).
#include "common.cuh"

namespace {

constexpr int kRows = 32;       // row particles per block: one per lane
constexpr int kGroups = 8;      // column groups per block: one warp each
constexpr int kColTile = 256;   // columns staged in shared memory per pass
constexpr int kPerGroup = kColTile / kGroups;

template <bool kDivide>
__global__ void __launch_bounds__(kRows * kGroups)
lj_dense_rows(const float* __restrict__ pos, const float* __restrict__ box,
              float* __restrict__ force, float* __restrict__ e_part, int n,
              int n_pad, float sigma2, float coef_scale, float eps4,
              float cutoff2, float r2_floor, int approx, int with_energy) {
  __shared__ float sx[kColTile], sy[kColTile], sz[kColTile];
  __shared__ float red[kGroups][4][kRows];
  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int tid = g * kRows + lane;
  const int row = blockIdx.x * kRows + lane;
  const float Lx = box[0], Ly = box[1], Lz = box[2];
  const float iLx = 1.0f / Lx, iLy = 1.0f / Ly, iLz = 1.0f / Lz;
  const float xi = pos[row], yi = pos[n_pad + row], zi = pos[2 * n_pad + row];
  const bool row_ok = row < n;
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
      float dx = xi - sx[t];
      float dy = yi - sy[t];
      float dz = zi - sz[t];
      if constexpr (kDivide) {
        dx = dx - Lx * floorf(dx / Lx + 0.5f);
        dy = dy - Ly * floorf(dy / Ly + 0.5f);
        dz = dz - Lz * floorf(dz / Lz + 0.5f);
      } else {
        dx = dx - Lx * floorf(dx * iLx + 0.5f);
        dy = dy - Ly * floorf(dy * iLy + 0.5f);
        dz = dz - Lz * floorf(dz * iLz + 0.5f);
      }
      const float r2 = dx * dx + dy * dy + dz * dz;
      const bool m = (r2 < cutoff2) && row_ok && (col < n) && (col != row);
      const float r2s = fmaxf(r2, r2_floor);
      const float inv = lj_recip(r2s, approx != 0);
      const float ir2 = sigma2 * inv;
      const float i6 = ir2 * ir2 * ir2;
      const float i12 = i6 * i6;
      const float coef = m ? coef_scale * (2.0f * i12 - i6) * inv : 0.0f;
      fx += coef * dx;
      fy += coef * dy;
      fz += coef * dz;
      if (with_energy) kahan_add(e, ec, m ? eps4 * (i12 - i6) : 0.0f);
    }
  }

  red[g][0][lane] = fx;
  red[g][1][lane] = fy;
  red[g][2][lane] = fz;
  red[g][3][lane] = e - ec;
  __syncthreads();
  if (g == 0) {
    float sfx = 0.0f, sfy = 0.0f, sfz = 0.0f;
    for (int k = 0; k < kGroups; ++k) {
      sfx += red[k][0][lane];
      sfy += red[k][1][lane];
      sfz += red[k][2][lane];
    }
    force[row] = sfx;
    force[n_pad + row] = sfy;
    force[2 * n_pad + row] = sfz;
  }
  if (with_energy && tid == 0) {
    float acc = 0.0f, comp = 0.0f;
    for (int k = 0; k < kGroups; ++k)
      for (int l = 0; l < kRows; ++l) kahan_add(acc, comp, red[k][3][l]);
    e_part[blockIdx.x] = acc - comp;
  }
}

__global__ void lj_dense_energy_sum(const float* __restrict__ e_part,
                                    int n_parts, float* __restrict__ energy) {
  float acc = 0.0f, comp = 0.0f;
  for (int k = 0; k < n_parts; ++k) kahan_add(acc, comp, e_part[k]);
  energy[0] = 0.5f * (acc - comp);
}

}  // namespace

cudaError_t lj_dense_force_divide(const float* pos, const float* box,
                                  float* force, int n, int n_pad, float sigma2,
                                  float coef_scale, float cutoff2,
                                  float r2_floor, cudaStream_t s) {
  lj_dense_rows<true><<<n_pad / kRows, dim3(kRows, kGroups), 0, s>>>(
      pos, box, force, nullptr, n, n_pad, sigma2, coef_scale, 0.0f, cutoff2,
      r2_floor, 1, 0);
  return cudaGetLastError();
}

// pos, force: (3, n_pad) f32; box: (3,) f32; e_part: (n_pad / 32,) f32
// scratch; energy: (1,) f32, written only when with_energy.  n_pad must be
// a multiple of 32.
CHIRON_EXPORT int chiron_lj_dense(const float* pos, const float* box,
                                  float* force, float* e_part, float* energy,
                                  int n, int n_pad, float sigma2,
                                  float coef_scale, float eps4, float cutoff2,
                                  float r2_floor, int approx, int with_energy,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = n_pad / kRows;
  lj_dense_rows<false><<<blocks, dim3(kRows, kGroups), 0, s>>>(
      pos, box, force, e_part, n, n_pad, sigma2, coef_scale, eps4, cutoff2,
      r2_floor, approx, with_energy);
  if (with_energy) lj_dense_energy_sum<<<1, 1, 0, s>>>(e_part, blocks, energy);
  return static_cast<int>(cudaGetLastError());
}
