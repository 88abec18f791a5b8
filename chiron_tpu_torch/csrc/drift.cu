// Tile-skin drift latch at the end of a culled MD segment (K3's last step;
// also K11's and the strip runner's latch).
//
// Replaces chiron_tpu/ops/lj_cull.py: _tile_skin_drift_bad (:622), run in
// the final grid step of _make_md_kernel (pallas_call at :984).  Over the
// live lanes (lane < n) it takes the minimum-image drift d from the segment
// anchor, the largest m1 and the second largest m2 (when two lanes tie at
// m1, the second is m1), and latches when m1 + m2 > threshold or any live
// coordinate is not finite (|x| < 3e38 fails for NaN too).  The threshold
// is read on the device: the slack in NVT, the remaining budget
// slack - eval_peak in NpT (the anchor3/budget mode, :804-816 and
// :884-893), so no sub-segment waits for the host.  Padding lanes count
// with d = 0, as in the JAX kernel.
//
// d is computed op by op as the plain version computes it
// (tile_skin_drift_bad_plain: x - anchor, its image by floor(d (1/L) +
// 1/2), the squares summed x, y, z, a correctly rounded sqrt), so the top-2
// sum, and with it the flag, is the plain version's bit for bit; a NaN d (a
// non-finite x or anchor) makes the sum NaN there, and here.
//
// Bound: one read of two (3, n_pad) arrays, well under 0.1 us of memory
// time; the time is the launch and the reduction's latency.  One pass: each
// thread folds 4 lanes into a partial (m1, m2, the count of lanes at m1),
// warps merge partials by shuffles and then through shared memory.  Up to
// n_pad = 4096 one block of 1024 threads decides alone; above, blocks of 256
// threads (98 at N=100,000) leave their partials, which meet in the block
// that takes the last ticket of an integer atomic.  The merge is exact and independent of the
// order (equal m1: the counts add and the larger m2 stays; otherwise the
// larger m1 wins and the other joins m2), so the flag does not depend on the
// split or on which block is last.  No float atomics.
#include "common.cuh"

namespace {

constexpr int kLanes = 4;          // lanes a thread
constexpr int kOneBlock = 4096;    // lanes one block takes alone
using cull::kFull;

// The two largest drifts of a set of lanes, with the count of lanes at the
// largest; m1 = NaN once any drift is NaN, m1 = m2 = -1 for no lanes.
struct Top2 {
  float m1, m2;
  int c;
};

__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  if (a.m1 != a.m1) return a;
  if (b.m1 != b.m1) return b;
  if (a.m1 == b.m1) return Top2{a.m1, fmaxf(a.m2, b.m2), a.c + b.c};
  if (a.m1 > b.m1) return Top2{a.m1, fmaxf(a.m2, b.m1), a.c};
  return Top2{b.m1, fmaxf(b.m2, a.m1), b.c};
}

__device__ __forceinline__ Top2 warp_merge(Top2 t) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Top2 u{__shfl_xor_sync(kFull, t.m1, o),
                 __shfl_xor_sync(kFull, t.m2, o),
                 __shfl_xor_sync(kFull, t.c, o)};
    t = merge(t, u);
  }
  return t;
}

// The block's merge of its threads' partials (every thread gets it) and
// whether every thread's lanes were finite.
template <int kThreads>
__device__ __forceinline__ Top2 block_merge(Top2 t, int& finite, Top2* sp,
                                            int* sf) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  t = warp_merge(t);
  finite = __all_sync(kFull, finite);
  if (lane == 0) {
    sp[warp] = t;
    sf[warp] = finite;
  }
  __syncthreads();
  t = lane < kThreads / 32 ? sp[lane] : Top2{-1.0f, -1.0f, 0};
  finite = lane < kThreads / 32 ? sf[lane] : 1;
  t = warp_merge(t);
  finite = __all_sync(kFull, finite);
  return t;
}

__device__ __forceinline__ float lane_drift(const float* x, const float* anchor,
                                            int lane, int n, int n_pad,
                                            const float* L, const float* invL) {
  if (lane >= n) return 0.0f;
  float d2 = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float d = __fsub_rn(x[a * n_pad + lane], anchor[a * n_pad + lane]);
    d = __fsub_rn(d, __fmul_rn(L[a], floorf(__fadd_rn(__fmul_rn(d, invL[a]),
                                                        0.5f))));
    d2 = a == 0 ? __fmul_rn(d, d) : __fadd_rn(d2, __fmul_rn(d, d));
  }
  return __fsqrt_rn(d2);
}

__device__ __forceinline__ bool latched(const Top2& t, int finite,
                                        float threshold) {
  const float second = t.c > 1 ? t.m1 : fmaxf(t.m2, 0.0f);
  return __fadd_rn(t.m1, second) > threshold || !finite;
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
tile_skin_drift(const float* __restrict__ x, const float* __restrict__ anchor,
                const float* __restrict__ box, int n, int n_pad,
                const float* __restrict__ threshold, int* __restrict__ part,
                unsigned* __restrict__ ticket, bool* __restrict__ flag) {
  __shared__ Top2 sp[kThreads / 32];
  __shared__ int sf[kThreads / 32];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const float L[3] = {box[0], box[1], box[2]};
  const float invL[3] = {__fdiv_rn(1.0f, L[0]), __fdiv_rn(1.0f, L[1]),
                         __fdiv_rn(1.0f, L[2])};
  Top2 t{-1.0f, -1.0f, 0};
  int finite = 1;
  const int base = blockIdx.x * kThreads * kLanes + tid;
#pragma unroll
  for (int u = 0; u < kLanes; ++u) {
    const int lane = base + u * kThreads;
    if (lane >= n_pad) break;
    const float d = lane_drift(x, anchor, lane, n, n_pad, L, invL);
    t = merge(t, d != d ? Top2{d, 0.0f, 0} : Top2{d, -1.0f, 1});
    if (lane < n) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
        finite &= fabsf(x[a * n_pad + lane]) < 3.0e38f ? 1 : 0;
    }
  }
  t = block_merge<kThreads>(t, finite, sp, sf);
  if (gridDim.x == 1) {
    if (tid == 0) flag[0] = latched(t, finite, threshold[0]);
    return;
  }
  if (tid == 0) {
    int* mine = part + 4 * blockIdx.x;
    mine[0] = __float_as_int(t.m1);
    mine[1] = __float_as_int(t.m2);
    mine[2] = t.c;
    mine[3] = finite;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every block's partial, read past the L1
  t = Top2{-1.0f, -1.0f, 0};
  finite = 1;
  for (int k = tid; k < gridDim.x; k += kThreads) {
    const int* other = part + 4 * k;
    t = merge(t, Top2{__int_as_float(__ldcg(other)),
                      __int_as_float(__ldcg(other + 1)), __ldcg(other + 2)});
    finite &= __ldcg(other + 3);
  }
  t = block_merge<kThreads>(t, finite, sp, sf);
  if (tid == 0) {
    flag[0] = latched(t, finite, threshold[0]);
    ticket[0] = 0u;  // ready for the next launch on this stream
  }
}

}  // namespace

cudaError_t drift_latch(const float* x, const float* anchor, const float* box,
                        int n, int n_pad, const float* threshold, int* part,
                        unsigned* ticket, bool* flag, cudaStream_t s) {
  if (n_pad <= kOneBlock) {
    tile_skin_drift<1024><<<1, 1024, 0, s>>>(x, anchor, box, n, n_pad,
                                             threshold, part, ticket, flag);
  } else {
    const int blocks = (n_pad + kLatchBlockLanes - 1) / kLatchBlockLanes;
    tile_skin_drift<kLatchBlockLanes / kLanes><<<blocks,
        kLatchBlockLanes / kLanes, 0, s>>>(x, anchor, box, n, n_pad,
                                           threshold, part, ticket, flag);
  }
  return cudaGetLastError();
}

// x, anchor: (3, n_pad) f32; box: (3,) f32; threshold: (1,) f32; part: 4
// ints a block of kLatchBlockLanes lanes; ticket: (1,) u32, 0 before and
// after; flag: (1,) bool (true = latched).
CHIRON_EXPORT int chiron_drift(const float* x, const float* anchor,
                               const float* box, int n, int n_pad,
                               const float* threshold, int* part,
                               unsigned* ticket, bool* flag, void* stream) {
  return static_cast<int>(drift_latch(x, anchor, box, n, n_pad, threshold,
                                      part, ticket, flag,
                                      static_cast<cudaStream_t>(stream)));
}
