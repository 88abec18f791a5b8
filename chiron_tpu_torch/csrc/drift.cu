// Tile-skin drift latch at the end of a culled MD segment (K3, last step).
//
// Replaces chiron_tpu/ops/lj_cull.py: _tile_skin_drift_bad (:622), run in
// the final grid step of _make_md_kernel (pallas_call at :984).  Over the
// live lanes (lane < n) it takes the minimum-image drift d from the segment
// anchor, the largest m1 and the second largest m2 (when two lanes tie at
// m1, the second is m1), and latches when m1 + m2 > threshold or any live
// coordinate is not finite (|x| < 3e38 fails for NaN too).  The threshold
// is read on the device: the slack in NVT, the remaining budget
// slack - eval_peak in NpT (the anchor3/budget mode, :804-816 and
// :884-893), so no sub-segment waits for the host.
//
// Bound: two passes over 2 x (3, n_pad) floats, well under 0.1 us of
// memory time.  One block of kThreads strides over the lanes twice and
// reduces the max and the tie count in shared memory, so the time is that
// one block's serial passes and tree reductions, not the bytes.  Both
// reductions are independent of the order, so the flag is deterministic.
// Padding lanes count with d = 0, as in the JAX kernel.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float lane_drift(const float* x, const float* anchor,
                                            int lane, int n, int n_pad,
                                            const float* L, const float* invL) {
  if (lane >= n) return 0.0f;
  float d2 = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float d = x[a * n_pad + lane] - anchor[a * n_pad + lane];
    d = d - L[a] * floorf(d * invL[a] + 0.5f);
    d2 = d2 + d * d;
  }
  return sqrtf(d2);
}

__global__ void __launch_bounds__(kThreads)
tile_skin_drift(const float* __restrict__ x, const float* __restrict__ anchor,
                const float* __restrict__ box, int n, int n_pad,
                const float* __restrict__ threshold, bool* __restrict__ flag) {
  __shared__ float smax[kThreads];
  __shared__ int sint[kThreads];
  const int tid = threadIdx.x;
  const float L[3] = {box[0], box[1], box[2]};
  const float invL[3] = {1.0f / L[0], 1.0f / L[1], 1.0f / L[2]};

  float m = 0.0f;
  int finite = 1;
  for (int lane = tid; lane < n_pad; lane += kThreads) {
    m = fmaxf(m, lane_drift(x, anchor, lane, n, n_pad, L, invL));
    if (lane < n) {
      for (int a = 0; a < 3; ++a)
        finite &= fabsf(x[a * n_pad + lane]) < 3.0e38f ? 1 : 0;
    }
  }
  smax[tid] = m;
  sint[tid] = finite;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) {
      smax[tid] = fmaxf(smax[tid], smax[tid + w]);
      sint[tid] &= sint[tid + w];
    }
    __syncthreads();
  }
  const float m1 = smax[0];
  const int all_finite = sint[0];
  __syncthreads();

  float m2 = -1.0f;
  int ties = 0;
  for (int lane = tid; lane < n_pad; lane += kThreads) {
    const float d = lane_drift(x, anchor, lane, n, n_pad, L, invL);
    if (d == m1) {
      ++ties;
    } else {
      m2 = fmaxf(m2, d);
    }
  }
  smax[tid] = m2;
  sint[tid] = ties;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) {
      smax[tid] = fmaxf(smax[tid], smax[tid + w]);
      sint[tid] += sint[tid + w];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float second = sint[0] > 1 ? m1 : fmaxf(smax[0], 0.0f);
    flag[0] = (m1 + second > threshold[0]) || !all_finite;
  }
}

}  // namespace

// x, anchor: (3, n_pad) f32; box: (3,) f32; threshold: (1,) f32; flag:
// (1,) bool (true = latched).
CHIRON_EXPORT int chiron_drift(const float* x, const float* anchor,
                               const float* box, int n, int n_pad,
                               const float* threshold, bool* flag,
                               void* stream) {
  tile_skin_drift<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, anchor, box, n, n_pad, threshold, flag);
  return static_cast<int>(cudaGetLastError());
}
