// The culled runner's rebuild in one launch: the spatial sort of the MD
// state and the tile-pair list build (K10).
//
// Replaces chiron_tpu/ops/sortbuild.py: _make_sort_build_kernel (:127),
// launched by sort_build_raw (pallas_call at :351).  One block of 1024
// threads:
//   1. the sort key of every lane (pure x, or the (x-slab, y) key of
//      lj_cull.slab_y_key; 3e38 on the padding), then the bitonic network of
//      _bitonic_sort (:73-104) over (key, lane) pairs: for k = 2 .. n_pad and
//      j = k/2 .. 1, lanes i and i ^ j exchange when the pair is out of
//      order in the block's direction ((i & k) == 0 ascending), by strict
//      comparisons, so equal keys and NaN keys never swap and the
//      permutation is the TPU kernel's (a radix or merge sort would order
//      ties, such as the padding's 3e38, another way);
//   2. the nine payload rows x, v and F gathered through the permutation
//      into x', v', F' (written as they are: only the build reads the
//      padding as lane n-1, :176-184), x' also into shared memory;
//   3. the list build on x' in shared memory (tile_build.cuh), with the
//      placement always in the kernel: the TPU kernel's split at
//      _KERNEL_PLACE_LIMIT (:120-124) is a VMEM limit and gives the same
//      arrays either way.
//
// The network's design.  A thread holds kLanes adjacent lanes (key and lane
// index) in registers, n_pad / kLanes threads in all.  A stage whose j is
// under kLanes compares within a thread, unrolled: the blocks up to kLanes
// first, then the last log2(kLanes) stages of each larger block, in one
// direction a thread; a stage whose j is under 32 kLanes takes its
// partner's values from a lane of its own warp (__shfl_xor_sync); only the
// stages with j >= 32 kLanes (10 of the 78 at n_pad 4096) pass through
// shared memory, one barrier each, alternating two buffers so that no
// second barrier guards their reuse.  The permutation and x' then take the
// exchange buffers' shared memory.
//
// Bound: bytes, each input read once and each output written once: x, v, F
// in and x', v', F' out, 2 x 147,456 B at n_pad 4096, about 0.09 us at 3.35
// TB/s; the sort needs the whole array, so one block.  What bounds this
// design is that SM: the cross-thread stages (shuffles and shared-memory
// exchanges, about 60% of the launch at n_pad 4096), the build's boxes and
// the gather's scattered reads.
#include "tile_build.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kLanes = 8;  // adjacent lanes a thread holds in the network
constexpr unsigned kFull = 0xffffffffu;
static_assert(kLanes % 4 == 0, "a thread's lanes move as whole float4s");

struct SortParams {
  const float* x;  // (3, n_pad) each
  const float* v;
  const float* F;
  float* xo;
  float* vo;
  float* Fo;
  int nslab;
};

__device__ __forceinline__ float sort_key(const float* x, float Lx, float Ly,
                                          int i, int n, int n_pad, int nslab) {
  if (i >= n) return 3.0e38f;
  const float x0 = x[i];
  if (nslab == 0) return x0;
  const float slab_w = __fdiv_rn(Lx, static_cast<float>(nslab));
  float slab = floorf(__fdiv_rn(x0, slab_w));
  if (slab == slab) slab = fminf(fmaxf(slab, 0.0f), static_cast<float>(nslab - 1));
  return __fadd_rn(__fmul_rn(slab, __fmul_rn(2.0f, Ly)), x[n_pad + i]);
}

// The (key, lane) pairs a thread holds, lanes first .. first + kLanes - 1.
struct Held {
  float key[kLanes];
  int idx[kLanes];
};

// One compare-exchange of lanes lo < hi of a k-block, ascending or not: the
// TPU kernel's strict comparison (lo's key > hi's ascending, < descending),
// so equal keys and NaN keys never swap.
__device__ __forceinline__ void compare_exchange(float& klo, float& khi,
                                                 int& ilo, int& ihi,
                                                 bool ascending) {
  // the pair's first and second in the block's order, compared as floats
  const float a = ascending ? khi : klo, b = ascending ? klo : khi;
  const bool swap = a < b;
  const float k0 = swap ? khi : klo, k1 = swap ? klo : khi;
  klo = k0;
  khi = k1;
  const int i0 = swap ? ihi : ilo, i1 = swap ? ilo : ihi;
  ilo = i0;
  ihi = i1;
}

// The stages j = J, J/2, .., 1 of a k-block on the lanes a thread holds,
// each pair ascending where (first + u) & K == 0 (K = k, or 0 where the
// caller gives the direction).
template <int K, int J>
__device__ __forceinline__ void stages_held(Held& h, int first,
                                            bool ascending) {
#pragma unroll
  for (int u = 0; u < kLanes; ++u) {
    if ((u & J) != 0) continue;
    compare_exchange(h.key[u], h.key[u + J], h.idx[u], h.idx[u + J],
                           K == 0 ? ascending : ((first + u) & K) == 0);
  }
  if constexpr (J > 1) stages_held<K, J / 2>(h, first, ascending);
}

// k = 2 .. K: the network's first stages, each thread's lanes alone.
template <int K>
__device__ __forceinline__ void sort_held(Held& h, int first) {
  if constexpr (K > 2) sort_held<K / 2>(h, first);
  stages_held<K, K / 2>(h, first, true);
}

// Held lane u against its partner's lane at the same u (key pk, lane pi)
// in a stage with j >= kLanes: the lane that keeps the smaller of the pair
// (the lower lane of an ascending block, the upper of a descending one)
// takes the partner's when it is strictly smaller, the other lane when it
// is strictly larger (compare_exchange's comparison, seen from each lane).
__device__ __forceinline__ void exchange(Held& h, int u, float pk, int pi,
                                         bool keep_min) {
  const float lo = keep_min ? pk : h.key[u], hi = keep_min ? h.key[u] : pk;
  const bool swap = lo < hi;
  h.key[u] = swap ? pk : h.key[u];
  h.idx[u] = swap ? pi : h.idx[u];
}

// Where the network's exchanges go: two buffers of n_pad keys (kbuf) and
// n_pad lanes (ibuf), float4 or int4 q of thread t at [q holders + t].
struct Exchange {
  float4* kbuf;
  int4* ibuf;
  int n_pad, holders;
  unsigned hmask;  // the holding lanes of a warp, for the shuffles
};

// The network from its stage k = 2 on, over the (key, lane) pairs of the
// threads under holders.
__device__ __forceinline__ void network(Held& h, const Exchange& x, int tid) {
  const bool holds = tid < x.holders;
  const int first = tid * kLanes, n_pad = x.n_pad, holders = x.holders;
  if (holds) sort_held<kLanes>(h, first);
  int swaps = 0;  // stages through shared memory so far
  for (int k = 2 * kLanes; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j >= kLanes; j >>= 1) {
      const bool keep_min = ((first & j) == 0) == ((first & k) == 0);
      if (j >= 32 * kLanes) {  // the partner is in another warp
        const int off = (swaps & 1) * (n_pad / 4);
        ++swaps;
        float4* kb = x.kbuf + off;
        int4* ib = x.ibuf + off;
        if (holds) {
#pragma unroll
          for (int q = 0; q < kLanes / 4; ++q) {
            kb[q * holders + tid] =
                make_float4(h.key[4 * q], h.key[4 * q + 1], h.key[4 * q + 2],
                            h.key[4 * q + 3]);
            ib[q * holders + tid] =
                make_int4(h.idx[4 * q], h.idx[4 * q + 1], h.idx[4 * q + 2],
                          h.idx[4 * q + 3]);
          }
        }
        __syncthreads();
        if (holds) {
          const int other = tid ^ (j / kLanes);
#pragma unroll
          for (int q = 0; q < kLanes / 4; ++q) {
            const float4 a = kb[q * holders + other];
            const int4 b = ib[q * holders + other];
            exchange(h, 4 * q, a.x, b.x, keep_min);
            exchange(h, 4 * q + 1, a.y, b.y, keep_min);
            exchange(h, 4 * q + 2, a.z, b.z, keep_min);
            exchange(h, 4 * q + 3, a.w, b.w, keep_min);
          }
        }
      } else if (holds) {  // the partner is in this warp
        const int m = j / kLanes;
#pragma unroll
        for (int u = 0; u < kLanes; ++u) {
          const float pk = __shfl_xor_sync(x.hmask, h.key[u], m);
          const int pi = __shfl_xor_sync(x.hmask, h.idx[u], m);
          exchange(h, u, pk, pi, keep_min);
        }
      }
    }
    if (holds) stages_held<0, kLanes / 2>(h, first, (first & k) == 0);
  }
}

__global__ void __launch_bounds__(kThreads)
sort_build(SortParams sp, tile_build::Params bp) {
  extern __shared__ float4 smem4[];
  const int n_pad = bp.n_pad, n = bp.n, tid = threadIdx.x;
  const float box[3] = {bp.box[0], bp.box[1], bp.box[2]};
  const int holders = n_pad / kLanes;
  const bool holds = tid < holders;
  const unsigned hmask = holders >= 32 ? kFull : (1u << holders) - 1u;
  const int first = tid * kLanes;
  // shared memory: the network's two exchange buffers (Exchange), then in
  // the same 16 n_pad bytes the permutation and x' (3, n_pad); the build's
  float4* kbuf = smem4;
  int4* ibuf = reinterpret_cast<int4*>(kbuf + 2 * n_pad / 4);
  int* perm = reinterpret_cast<int*>(smem4);
  float* xs = reinterpret_cast<float*>(perm + n_pad);
  float* build_sh = reinterpret_cast<float*>(smem4 + n_pad);

  Held h;
  if (holds) {
#pragma unroll
    for (int u = 0; u < kLanes; ++u) {
      h.key[u] = sort_key(sp.x, box[0], box[1], first + u, n, n_pad, sp.nslab);
      h.idx[u] = first + u;
    }
  }
  network(h, Exchange{kbuf, ibuf, n_pad, holders, hmask}, tid);
  __syncthreads();  // the exchange buffers are read no more
  if (holds) {
#pragma unroll
    for (int q = 0; q < kLanes / 4; ++q) {
      reinterpret_cast<int4*>(perm + first)[q] =
          make_int4(h.idx[4 * q], h.idx[4 * q + 1], h.idx[4 * q + 2],
                    h.idx[4 * q + 3]);
    }
  }
  __syncthreads();
  // the gather: a thread a lane of each pass, every load issued first
  for (int t0 = 0; t0 < n_pad; t0 += 4 * kThreads) {
    float val[4][9];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int t = t0 + s * kThreads + tid;
      if (t >= n_pad) continue;
      const int src = perm[t];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const size_t o = static_cast<size_t>(a) * n_pad + src;
        val[s][a] = sp.x[o];
        val[s][3 + a] = sp.v[o];
        val[s][6 + a] = sp.F[o];
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int t = t0 + s * kThreads + tid;
      if (t >= n_pad) continue;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const size_t o = static_cast<size_t>(a) * n_pad + t;
        xs[o] = val[s][a];
        sp.xo[o] = val[s][a];
        sp.vo[o] = val[s][3 + a];
        sp.Fo[o] = val[s][6 + a];
      }
    }
  }
  __syncthreads();  // x' is read by the whole block below
  tile_build::Params q = bp;
  q.x = xs;
  tile_build::build(q, build_sh, box);
}

}  // namespace

// x, v, F, xo, vo, Fo: (3, n_pad) f32; box: (3,) f32; rows, cols, ccx:
// (capacity,); ptr2: (2 nr + 1,) i32; rowcx: (nr,) f32; count: (1,) i32;
// over: (1,) bool.  n_pad a power of two from kLanes to 4096, tm and tn
// multiples of 128 dividing it.
CHIRON_EXPORT int chiron_sort_build(
    const float* x, const float* v, const float* F, const float* box,
    float* xo, float* vo, float* Fo, int* rows, int* cols, float* ccx,
    int* ptr2, float* rowcx, int* count, bool* over, int n, int n_pad, int tm,
    int tn, int nslab, float cutoff, float slack, float reach2, int capacity,
    void* stream) {
  if (n_pad < kLanes || n_pad > 4096 || (n_pad & (n_pad - 1)) != 0 ||
      tm % 128 != 0 || tn % 128 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SortParams sp{x, v, F, xo, vo, Fo, nslab};
  const tile_build::Params bp{xo, box, rows, cols, ccx, ptr2, rowcx, count,
                              over, n, n_pad, tm, tn, capacity, cutoff, slack,
                              reach2, tile_build::grid(n_pad, tm, tn)};
  // the exchange buffers, or the permutation and x'; the build's
  const size_t smem = 4 * sizeof(float4) * static_cast<size_t>(n_pad / 4) +
                      tile_build::smem_bytes(bp.g);
  cudaError_t err = cudaFuncSetAttribute(
      sort_build, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sort_build<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(sp, bp);
  return static_cast<int>(cudaGetLastError());
}
