// The culled runner's rebuild in one launch: the spatial sort of the MD
// state and the tile-pair list build (K10).
//
// Replaces chiron_tpu/ops/sortbuild.py: _make_sort_build_kernel (:127),
// launched by sort_build_raw (pallas_call at :351).  One block of 1024
// threads:
//   1. the sort key of every lane (pure x, or the (x-slab, y) key of
//      lj_cull.slab_y_key; 3e38 on the padding), then the bitonic network of
//      _bitonic_sort (:73-104) over (key, lane) pairs in shared memory: for
//      k = 2 .. n_pad and j = k/2 .. 1, lanes i and i ^ j exchange when the
//      pair is out of order in the block's direction, so equal keys and NaN
//      keys never swap and the permutation is the TPU kernel's;
//   2. the nine payload rows x, v and F gathered through the permutation
//      into x', v', F' (written as they are: only the build reads the
//      padding as lane n-1, :176-184);
//   3. the list build on x' (tile_build.cuh), with the placement always in
//      the kernel: the TPU kernel's split at _KERNEL_PLACE_LIMIT (:120-124)
//      is a VMEM limit and gives the same arrays either way.
// The TPU kernel moves all ten rows through the network (160 KB at n_pad
// 4096); moving the lane index alone takes 32 KB of shared memory and one
// gather at the end.
//
// Bound: bytes, each input read once and each output written once: x, v, F
// in and x', v', F' out, 2 x 147,456 B at n_pad 4096, about 0.09 us at 3.35
// TB/s.  The network's 78 dependent stages, each a __syncthreads of one
// block, and the build's serial row scan are what this design costs: one
// launch in place of a radix sort and about 60 small torch ops a segment.
#include "tile_build.cuh"

namespace {

constexpr int kThreads = 1024;

struct SortParams {
  const float* x;  // (3, n_pad) each
  const float* v;
  const float* F;
  float* xo;
  float* vo;
  float* Fo;
  int nslab;
};

__device__ __forceinline__ float sort_key(const float* x, const float* box,
                                          int i, int n, int n_pad, int nslab) {
  if (i >= n) return 3.0e38f;
  const float x0 = x[i];
  if (nslab == 0) return x0;
  const float slab_w = __fdiv_rn(box[0], static_cast<float>(nslab));
  float slab = floorf(__fdiv_rn(x0, slab_w));
  if (slab == slab) slab = fminf(fmaxf(slab, 0.0f), static_cast<float>(nslab - 1));
  return __fadd_rn(__fmul_rn(slab, __fmul_rn(2.0f, box[1])), x[n_pad + i]);
}

__global__ void __launch_bounds__(kThreads)
sort_build(SortParams sp, tile_build::Params bp) {
  extern __shared__ float smem[];
  const int n_pad = bp.n_pad, n = bp.n, tid = threadIdx.x;
  float* key = smem;
  int* idx = reinterpret_cast<int*>(key + n_pad);
  float* build_sh = reinterpret_cast<float*>(idx + n_pad);

  for (int i = tid; i < n_pad; i += kThreads) {
    key[i] = sort_key(sp.x, bp.box, i, n, n_pad, sp.nslab);
    idx[i] = i;
  }
  __syncthreads();
  for (int k = 2; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = tid; q < n_pad / 2; q += kThreads) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));  // bit j clear
        const int l = i | j;
        const float a = key[i], b = key[l];
        if ((i & k) == 0 ? (a > b) : (a < b)) {
          key[i] = b;
          key[l] = a;
          const int t = idx[i];
          idx[i] = idx[l];
          idx[l] = t;
        }
      }
      __syncthreads();
    }
  }
  for (int t = tid; t < n_pad; t += kThreads) {
    const int src = idx[t];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const size_t o = static_cast<size_t>(a) * n_pad;
      sp.xo[o + t] = sp.x[o + src];
      sp.vo[o + t] = sp.v[o + src];
      sp.Fo[o + t] = sp.F[o + src];
    }
  }
  __syncthreads();  // x' is read by the whole block below
  tile_build::build(bp, build_sh);
}

}  // namespace

// x, v, F, xo, vo, Fo: (3, n_pad) f32; box: (3,) f32; rows, cols, ccx:
// (capacity,); ptr2: (2 nr + 1,) i32; rowcx: (nr,) f32; count: (1,) i32;
// over: (1,) bool.  n_pad a power of two, tm and tn dividing it.
CHIRON_EXPORT int chiron_sort_build(
    const float* x, const float* v, const float* F, const float* box,
    float* xo, float* vo, float* Fo, int* rows, int* cols, float* ccx,
    int* ptr2, float* rowcx, int* count, bool* over, int n, int n_pad, int tm,
    int tn, int nslab, float cutoff, float slack, float reach2, int capacity,
    void* stream) {
  const SortParams sp{x, v, F, xo, vo, Fo, nslab};
  const tile_build::Params bp{xo, box, rows, cols, ccx, ptr2, rowcx, count,
                              over, n, n_pad, tm, tn, capacity, cutoff, slack,
                              reach2};
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(n_pad) +
                      tile_build::smem_bytes(n_pad, tm, tn);
  cudaError_t err = cudaFuncSetAttribute(
      sort_build, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sort_build<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(sp, bp);
  return static_cast<int>(cudaGetLastError());
}
