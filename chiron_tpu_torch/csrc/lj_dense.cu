// All-pairs minimum-image Lennard-Jones force and energy (K1, K2 and K8a).
//
// Replaces chiron_tpu/ops/lj_dense.py: _make_triangle_kernel with
// _lj_tile_math, launched by _lj_dense_raw (pallas_call at :340), the square
// kernel _make_kernel (:231) that computes the same function, and
// chiron_tpu/parallel/spatial.py: _make_row_slab_force (pallas_call at :126),
// a slab of rows against every column.
//
// The TPU kernel visits each unordered tile pair once and writes the
// column reaction into one force block shared by its in-order grid.  Blocks
// on Hopper run in no order, so that reaction would race.  Here each block
// owns kRows row particles (one a lane) and its kWarps warps split the
// columns: it writes only its own rows, so there are no reaction writes, no
// atomics and no gather pass, and the result is the same bit for bit on
// every run.  Every pair is therefore met from both sides.  Visiting each
// pair once would halve the pair work but add per-block column slots and a
// fixed-order gather launch; with the culling below most pairs never reach
// the pair loop at all, and the gather would cost about what it saves.
//
// Rows: a block's rows are off + blockIdx.x * 32 + lane of the layout,
// read from `rows` with row stride rs (pos and n_pad for K1 and K2; K8a's
// slab, rows_per_dev wide, at global offset off), and their force goes to
// `force` with the same stride.  A row's sum depends only on its global
// index and the columns (the warps take the same chunks in the same order,
// the cull box is the block's own 32 rows), so K8a's slabs at any offsets
// concatenate to the one-slab result, which is K2's, bit for bit.
//
// Bound: pair arithmetic (about 21 f32 operations a distance test on
// n(n-1)/2 pairs, the LJ term on the few within the cutoff), not memory:
// the positions (3 x n_pad floats) stay in L2.  What the design does about
// it, for this card:
//   * occupancy: a block is 32 rows x 32 warps (1024 threads), so at
//     n_pad = 4096 the 128 blocks fill 128 of the 132 SMs with 32 warps
//     each, eight a scheduler to hide the latency of each lane's dependent
//     accumulator chain;
//   * culling: a warp takes its columns 32 at a time, and first holds the
//     bounding box of those 32 (csrc/common.cuh, cull::) against the box of
//     the block's rows: where the boxes are farther apart than the cutoff
//     the 1024 pairs are skipped whole.  Positions kept in a spatial order
//     (the lattice order of a fresh fluid, the x-sorted order of the culled
//     and band runners) skip most chunks;
//   * a warp takes the chunk's columns four at a time, their distances
//     first as independent chains, and the LJ term only where some lane
//     has one of the four within the cutoff (or a NaN distance, which must
//     reach the sums as it did before), decided warp-uniformly with
//     __any_sync; each chunk's columns are loaded during the one before.
// A culled pair or a skipped LJ term adds nothing where the full pass would
// add zero, so the function is unchanged.
//
// Where the caller gives `work` (the profiling counters), each block adds
// the chunks its warps visited and those that passed the cull (the chunks
// tested) to work[0] and work[1], one integer atomic each; the counts are
// kept either way, so the force and energy do not depend on it.
//
// Replicas (chiron_lj_dense's n_rep): blockIdx.y is the replica, and a block
// first moves pos, box, rows, force and e_part to its replica's arrays, so
// block (x, r) does what block x of a single-system launch on replica r's
// arrays does, and a replica's force and energy are that launch's bit for
// bit.  A single system is n_rep = 1 (gridDim.y = 1, no offset), as are the
// other entries.
// This is JAX's vmap of the pallas_call (chiron_tpu/parallel/tempering.py:
// 387-390 over lj_dense.py:340), a grid axis written out: one launch for R
// replicas fills the card where one system leaves most SMs idle (N=1000 is
// 32 blocks on 132 SMs).
//
// Energy: every thread keeps a compensated sum over its columns; a block
// folds its threads' sums in a fixed order into one slot of e_part, and a
// second pass sums the slots in a fixed order (the 1e-6 design bar of
// lj_dense.py:195-201) and scales the total: 0.5 for K1 and K2, where every
// pair is seen from both sides, 1 for a K8a slab, whose caller halves the
// sum over the slabs.
//
// kDivide takes the minimum image as d - L floor(d / L + 1/2), the form of
// the fused MD kernel's force phase (chiron_tpu/ops/lj_md_fused.py:157-159),
// which lj_md_fused.cu launches through lj_dense_force_divide; K1, K2 and
// K8a multiply by 1/L (lj_dense.py:56-58).
#include "common.cuh"

namespace {

constexpr int kRows = 32;    // row particles per block: one per lane
constexpr int kWarps = 32;   // warps per block, each a column group
constexpr int kChunk = 32;   // columns a warp takes at a time: one a lane
constexpr int kGroup = 4;    // columns of a chunk taken together
using cull::kFull;

struct Lj {
  float sigma2, coef_scale, eps4, cutoff2, r2_floor, cull2;
};

template <bool kDivide>
__device__ __forceinline__ float min_image(float d, float L, float iL) {
  if constexpr (kDivide) {
    return d - L * floorf(d / L + 0.5f);
  } else {
    return d - L * floorf(d * iL + 0.5f);
  }
}

// A warp's 32 rows (one a lane) against the 32 staged columns of one chunk,
// whose first column is col0, kGroup columns at a time: their distances
// first (independent chains), then the LJ term where any lane needs it.
// kEdge adds the col < n and col != row masks (the chunk of the block's own
// rows, and a chunk holding padding).
template <bool kDivide, bool kApprox, bool kEnergy, bool kEdge>
__device__ __forceinline__ void chunk_pairs(
    const float4* __restrict__ cols, int col0, int row, int n, float xi,
    float yi, float zi, float c2_row, const float (&L)[3],
    const float (&iL)[3], const Lj& lj, float& fx, float& fy, float& fz,
    float& e, float& ec) {
  for (int j0 = 0; j0 < kChunk; j0 += kGroup) {
    float dx[kGroup], dy[kGroup], dz[kGroup], r2[kGroup];
    bool m[kGroup];
    bool any = false;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const float4 q = cols[j0 + u];
      dx[u] = min_image<kDivide>(xi - q.x, L[0], iL[0]);
      dy[u] = min_image<kDivide>(yi - q.y, L[1], iL[1]);
      dz[u] = min_image<kDivide>(zi - q.z, L[2], iL[2]);
      r2[u] = dx[u] * dx[u] + dy[u] * dy[u] + dz[u] * dz[u];
      m[u] = r2[u] < c2_row;  // c2_row < 0 on a padding row
      if constexpr (kEdge) {
        const int col = col0 + j0 + u;
        m[u] = m[u] && col < n && col != row;
      }
      any = any || m[u] || r2[u] != r2[u];
    }
    if (!__any_sync(kFull, any)) continue;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const float r2s = fmaxf(r2[u], lj.r2_floor);
      const float inv = lj_recip(r2s, kApprox);
      const float ir2 = lj.sigma2 * inv;
      const float i6 = ir2 * ir2 * ir2;
      const float i12 = i6 * i6;
      const float coef =
          m[u] ? lj.coef_scale * (2.0f * i12 - i6) * inv : 0.0f;
      fx += coef * dx[u];
      fy += coef * dy[u];
      fz += coef * dz[u];
      if constexpr (kEnergy) {
        kahan_add(e, ec, m[u] ? lj.eps4 * (i12 - i6) : 0.0f);
      }
    }
  }
}

// The rows of a launch are rows [off, off + gridDim.x * kRows) of the
// layout, read from `rows` (and their force written to `force`), arrays of
// row stride rs; blockIdx.y is the replica, whose arrays follow each other.
template <bool kDivide, bool kApprox, bool kEnergy>
__global__ void __launch_bounds__(kRows * kWarps, 1)
lj_dense_rows(const float* __restrict__ pos, const float* __restrict__ box,
              const float* __restrict__ rows, float* __restrict__ force,
              int rs, int off, float* __restrict__ e_part, int n, int n_pad,
              Lj lj, unsigned long long* __restrict__ work) {
  __shared__ float4 stage[kWarps][kChunk];
  __shared__ float red[kWarps][4][kRows];
  __shared__ unsigned swork[2][kWarps];
  const size_t rep = blockIdx.y;
  pos += rep * 3 * n_pad;
  box += rep * 3;
  rows += rep * 3 * rs;
  force += rep * 3 * rs;
  if constexpr (kEnergy) e_part += rep * gridDim.x;
  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int r = blockIdx.x * kRows + lane;  // the row in the launch's arrays
  const int row = off + r;                  // its global index
  const float L[3] = {box[0], box[1], box[2]};
  const float iL[3] = {1.0f / L[0], 1.0f / L[1], 1.0f / L[2]};
  const float xi = rows[r], yi = rows[rs + r], zi = rows[2 * rs + r];
  const float c2_row = row < n ? lj.cutoff2 : -1.0f;
  cull::BoxAcc racc(__shfl_sync(kFull, xi, 0), __shfl_sync(kFull, yi, 0),
                    __shfl_sync(kFull, zi, 0));
  racc.add(xi, yi, zi, L, iL);
  const cull::Box rbox = racc.reduce();
  float fx = 0.0f, fy = 0.0f, fz = 0.0f, e = 0.0f, ec = 0.0f;

  // each chunk's columns are loaded while the one before is processed
  const int n_chunks = n_pad / kChunk;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  if (g < n_chunks) {
    const int col = g * kChunk + lane;
    nx = pos[col];
    ny = pos[n_pad + col];
    nz = pos[2 * n_pad + col];
  }
  unsigned visited = 0, tested = 0;
  for (int c = g; c < n_chunks; c += kWarps) {
    const float xj = nx, yj = ny, zj = nz;
    if (c + kWarps < n_chunks) {
      const int col = (c + kWarps) * kChunk + lane;
      nx = pos[col];
      ny = pos[n_pad + col];
      nz = pos[2 * n_pad + col];
    }
    cull::BoxAcc cacc(__shfl_sync(kFull, xj, 0), __shfl_sync(kFull, yj, 0),
                      __shfl_sync(kFull, zj, 0));
    cacc.add(xj, yj, zj, L, iL);
    ++visited;
    if (cull::apart(rbox, cacc.reduce(), L, iL, lj.cull2)) continue;
    ++tested;
    __syncwarp();  // the previous chunk's columns have been read
    stage[g][lane] = make_float4(xj, yj, zj, 0.0f);
    __syncwarp();
    const int col0 = c * kChunk;
    if (col0 == row - lane || col0 + kChunk > n) {  // the block's own rows
      chunk_pairs<kDivide, kApprox, kEnergy, true>(
          stage[g], col0, row, n, xi, yi, zi, c2_row, L, iL, lj, fx, fy, fz, e,
          ec);
    } else {
      chunk_pairs<kDivide, kApprox, kEnergy, false>(
          stage[g], col0, row, n, xi, yi, zi, c2_row, L, iL, lj, fx, fy, fz, e,
          ec);
    }
  }

  red[g][0][lane] = fx;
  red[g][1][lane] = fy;
  red[g][2][lane] = fz;
  red[g][3][lane] = e - ec;
  if (lane == 0) {
    swork[0][g] = visited;
    swork[1][g] = tested;
  }
  __syncthreads();
  if (g == 0) {
    float sfx = 0.0f, sfy = 0.0f, sfz = 0.0f;
    for (int k = 0; k < kWarps; ++k) {
      sfx += red[k][0][lane];
      sfy += red[k][1][lane];
      sfz += red[k][2][lane];
    }
    force[r] = sfx;
    force[rs + r] = sfy;
    force[2 * rs + r] = sfz;
  } else if (kEnergy && g == 1) {
    // each lane's energy over the warps, then the lanes in order
    float acc = 0.0f, comp = 0.0f;
    for (int k = 0; k < kWarps; ++k) kahan_add(acc, comp, red[k][3][lane]);
    const float mine = acc - comp;
    acc = comp = 0.0f;
    for (int l = 0; l < kRows; ++l)
      kahan_add(acc, comp, __shfl_sync(kFull, mine, l));
    if (lane == 0) e_part[blockIdx.x] = acc - comp;
  }
  if (work != nullptr && g == kWarps - 1 && lane == 0) {
    unsigned long long v = 0, t = 0;
    for (int k = 0; k < kWarps; ++k) {
      v += swork[0][k];
      t += swork[1][k];
    }
    atomicAdd(work, v);
    atomicAdd(work + 1, t);
  }
}

// The rows [off, off + n_rows) of a launch: their positions, their force
// and the row stride of both.
struct Rows {
  const float* pos;
  float* force;
  int rs, off;
};

template <bool kDivide, bool kApprox, bool kEnergy>
cudaError_t launch_rows(const float* pos, const float* box, const Rows& rows,
                        int n_rows, int n_rep, float* e_part, int n, int n_pad,
                        const Lj& lj, unsigned long long* work,
                        cudaStream_t s) {
  lj_dense_rows<kDivide, kApprox, kEnergy>
      <<<dim3(n_rows / kRows, n_rep), dim3(kRows, kWarps), 0, s>>>(
          pos, box, rows.pos, rows.force, rows.rs, rows.off, e_part, n, n_pad,
          lj, work);
  return cudaGetLastError();
}

// A launch's rows for n_rep replicas, with each replica's energy (scaled by
// e_scale) into energy[r] when with_energy, else the force only.
template <bool kApprox>
cudaError_t launch_pass(const float* pos, const float* box, const Rows& rows,
                        int n_rows, int n_rep, float* e_part, float* energy,
                        int n, int n_pad, const Lj& lj, int with_energy,
                        float e_scale, unsigned long long* work,
                        cudaStream_t s) {
  if (!with_energy)
    return launch_rows<false, kApprox, false>(pos, box, rows, n_rows, n_rep,
                                              e_part, n, n_pad, lj, work, s);
  cudaError_t err = launch_rows<false, kApprox, true>(
      pos, box, rows, n_rows, n_rep, e_part, n, n_pad, lj, work, s);
  if (err != cudaSuccess) return err;
  partial_sum<kSumThreads><<<n_rep, kSumThreads, 0, s>>>(
      e_part, n_rows / kRows, e_scale, energy);
  return cudaGetLastError();
}

}  // namespace

cudaError_t lj_dense_force_divide(const float* pos, const float* box,
                                  float* force, int n, int n_pad, float sigma2,
                                  float coef_scale, float cutoff2,
                                  float r2_floor, cudaStream_t s) {
  const Lj lj{sigma2, coef_scale, 0.0f, cutoff2, r2_floor,
              cutoff2 * cull::kRaise};
  return launch_rows<true, true, false>(pos, box, Rows{pos, force, n_pad, 0},
                                        n_pad, 1, nullptr, n, n_pad, lj,
                                        nullptr, s);
}

// K1 and K2 over n_rep replicas in one launch (n_rep = 1 for a single
// system; JAX's vmap of K1 in the dense tempering chain for more): pos, force
// (n_rep, 3, n_pad) f32; box (n_rep, 3) f32, a box a replica; e_part (n_rep,
// n_pad / 32) f32 scratch; energy (n_rep,) f32, written only when
// with_energy.  Replica r's force and energy equal a one-replica launch's on
// its own arrays, bit for bit.  n_pad must be a multiple of 32 and 0 < n_rep
// <= 65535.  work: (2,) u64, chunks visited and tested added to it, or null.
CHIRON_EXPORT int chiron_lj_dense(const float* pos, const float* box,
                                  float* force, float* e_part, float* energy,
                                  int n, int n_pad, int n_rep, float sigma2,
                                  float coef_scale, float eps4, float cutoff2,
                                  float r2_floor, int approx, int with_energy,
                                  unsigned long long* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Lj lj{sigma2, coef_scale, eps4, cutoff2, r2_floor,
              cutoff2 * cull::kRaise};
  const Rows rows{pos, force, n_pad, 0};
  return static_cast<int>(
      approx ? launch_pass<true>(pos, box, rows, n_pad, n_rep, e_part, energy,
                                 n, n_pad, lj, with_energy, 0.5f, work, s)
             : launch_pass<false>(pos, box, rows, n_pad, n_rep, e_part, energy,
                                  n, n_pad, lj, with_energy, 0.5f, work, s));
}

// K8a: the slab rows (3, rows_per_dev) f32 at global rows [off, off +
// rows_per_dev) against every column of pos (3, n_pad) f32, exact
// reciprocal; force: (3, rows_per_dev) f32.  With with_energy also the
// slab's pair energy, every pair from its row's side, not halved, into
// energy (1,) f32, through e_part (rows_per_dev / 32,) f32 scratch.
// rows_per_dev and off are multiples of 32 and off + rows_per_dev <= n_pad.
CHIRON_EXPORT int chiron_row_slab_force(const float* rows, const float* pos,
                                        const float* box, float* force,
                                        float* e_part, float* energy, int n,
                                        int n_pad, int rows_per_dev, int off,
                                        float sigma2, float coef_scale,
                                        float eps4, float cutoff2,
                                        float r2_floor, int with_energy,
                                        void* stream) {
  const Lj lj{sigma2, coef_scale, eps4, cutoff2, r2_floor,
              cutoff2 * cull::kRaise};
  return static_cast<int>(launch_pass<false>(
      pos, box, Rows{rows, force, rows_per_dev, off}, rows_per_dev, 1, e_part,
      energy, n, n_pad, lj, with_energy, 1.0f, nullptr,
      static_cast<cudaStream_t>(stream)));
}
