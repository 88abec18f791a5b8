// One culled MD segment enqueued by one host call: the list build from the
// current order, S BAOAB steps on the culled force, the drift latch and the
// odd-even repair of the spatial order (K11).
//
// Replaces chiron_tpu/ops/lj_mega.py: _make_mega_kernel (:82), launched by
// mega_md_raw (pallas_call at :368).  The TPU kernel is one grid over the S
// steps with the list in SMEM scratch.  Hopper has no grid-wide barrier
// inside a launch, so chiron_mega_segment enqueues the segment's launches
// back to back on the caller's stream, with no host work between them:
//   1. tile_build: the list of the entry positions in the current order
//      (:121-259), the build of K10 without the sort (tile_build.cuh), into
//      buffers the caller allocates once;
//   2. S times K3's BAOAB phase and culled force (baoab.cu,
//      lj_cull_force.cu; the TPU kernel shares _baoab_phase and
//      _row_force_pass with the classic one the same way, :264-275);
//   3. the drift latch against the entry positions (drift.cu, :282-286);
//   4. mega_repair: P odd-even transposition passes over the lane order
//      (:300-335), the comparator the minimum-image x difference
//      d - L round(d / L) (d times 1/L, as the TPU kernel has it), so that a
//      particle that wrapped in x stays cyclically near its rank; the
//      padding lanes never move.  It runs in one block, in place, with a
//      barrier between passes, for any n_pad; its first thread ORs the
//      build's latch and the drift latch into the segment's flag.
// With P = 0 the segment is the classic path's bit for bit: the same
// kernels on a list equal to build_tile_pairs'.
//
// Bound: the build reads x once (12 n_pad B), each step is K3's (BAOAB's
// bytes, the culled force's pair operations), the latch reads two (3,
// n_pad) rows and the repair moves nine rows P times; at the main path's
// n_pad the steps' force passes dominate.
#include "tile_build.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
tile_build_kernel(tile_build::Params p) {
  extern __shared__ float smem[];
  tile_build::build(p, smem);
}

__global__ void __launch_bounds__(kThreads)
mega_repair(float* __restrict__ x, float* __restrict__ w,
            float* __restrict__ F, const float* __restrict__ box, int n,
            int n_pad, int passes, const bool* build_over,
            const bool* drift_bad, bool* flag) {
  const float Lx = box[0];
  const float inv_Lx = __fdiv_rn(1.0f, Lx);
  float* rows[3] = {x, w, F};
  for (int p = 0; p < passes; ++p) {
    for (int i = (p & 1) + 2 * threadIdx.x; i < n - 1; i += 2 * kThreads) {
      float d = __fsub_rn(x[i], x[i + 1]);
      d = __fsub_rn(d, __fmul_rn(Lx, rintf(__fmul_rn(d, inv_Lx))));
      if (!(d > 0.0f)) continue;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          float* row = rows[q] + static_cast<size_t>(a) * n_pad;
          const float t = row[i];
          row[i] = row[i + 1];
          row[i + 1] = t;
        }
      }
    }
    __syncthreads();
  }
  if (flag != nullptr && threadIdx.x == 0) flag[0] = build_over[0] || drift_bad[0];
}

cudaError_t launch_tile_build(const tile_build::Params& p, cudaStream_t s) {
  const size_t smem = tile_build::smem_bytes(p.n_pad, p.tm, p.tn);
  cudaError_t err = cudaFuncSetAttribute(
      tile_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  tile_build_kernel<<<1, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The list of x in its current order: arrays as chiron_sort_build's.
CHIRON_EXPORT int chiron_tile_build(const float* x, const float* box, int* rows,
                                    int* cols, float* ccx, int* ptr2,
                                    float* rowcx, int* count, bool* over,
                                    int n, int n_pad, int tm, int tn,
                                    float cutoff, float slack, float reach2,
                                    int capacity, void* stream) {
  const tile_build::Params p{x, box, rows, cols, ccx, ptr2, rowcx, count, over,
                             n, n_pad, tm, tn, capacity, cutoff, slack, reach2};
  return static_cast<int>(
      launch_tile_build(p, static_cast<cudaStream_t>(stream)));
}

// P repair passes in place on x, w, F: (3, n_pad) f32; box: (3,) f32.
CHIRON_EXPORT int chiron_mega_repair(float* x, float* w, float* F,
                                     const float* box, int n, int n_pad,
                                     int passes, void* stream) {
  mega_repair<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, F, box, n, n_pad, passes, nullptr, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// One segment in place on x, w, F ((3, n_pad) f32, w the velocity before
// the trailing half-kick); anchor: the entry positions, not aliasing x.
// The list (rows .. count, build_over) and the force pass's scratch (P, R,
// e_part, as chiron_cull_force takes them at this capacity) are the
// caller's buffers; threshold: (1,) f32 drift slack on the device;
// drift_bad: (1,) bool scratch; flag: (1,) bool, the build's latch or the
// drift latch.
CHIRON_EXPORT int chiron_mega_segment(
    float* x, float* w, float* F, const float* anchor, const float* minv,
    const float* sigv, const float* box, const int* step_offset, uint32_t seed,
    int n_steps, int* rows, int* cols, float* ccx, int* ptr2, float* rowcx,
    int* count, bool* build_over, float* P, float* R, float* e_part,
    const float* threshold, bool* drift_bad, bool* flag, int n, int n_pad,
    int tm, int tn, int capacity, float cutoff, float slack, float reach2,
    float dt, float half_dt, float a, float b, float inv_sigma,
    float sigma_fold, float cutoff2_s, float eps_scale, int approx,
    int repair_passes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const tile_build::Params bp{x, box, rows, cols, ccx, ptr2, rowcx, count,
                              build_over, n, n_pad, tm, tn, capacity, cutoff,
                              slack, reach2};
  cudaError_t err = launch_tile_build(bp, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int k = 0; k < n_steps; ++k) {
    int rc = chiron_baoab(x, w, F, minv, sigv, box, step_offset, k, seed, n_pad,
                          dt, half_dt, a, b, stream);
    if (rc != 0) return rc;
    rc = chiron_cull_force(x, box, rows, cols, ccx, ptr2, rowcx, count, P, R,
                           e_part, F, nullptr, n, n_pad, tm, tn, capacity,
                           inv_sigma, sigma_fold, cutoff2_s, eps_scale, 0.0f,
                           approx, stream);
    if (rc != 0) return rc;
  }
  int rc = chiron_drift(x, anchor, box, n, n_pad, threshold, drift_bad, stream);
  if (rc != 0) return rc;
  mega_repair<<<1, kThreads, 0, s>>>(x, w, F, box, n, n_pad, repair_passes,
                                     build_over, drift_bad, flag);
  return static_cast<int>(cudaGetLastError());
}
