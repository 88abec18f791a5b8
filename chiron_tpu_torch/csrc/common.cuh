// Shared device helpers for the chiron_tpu_torch kernels.
//
// Every exported entry point is a plain C function: it takes raw device
// pointers and the caller's CUDA stream, launches on that stream, never
// synchronises or allocates, and returns cudaGetLastError() so that the
// Python wrapper (chiron_tpu_torch/ops/_build.py) raises on a refused launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define CHIRON_EXPORT extern "C" __attribute__((visibility("default")))

// The hardware reciprocal (rcp.approx: about 1 ulp), the counterpart of
// pl.reciprocal(approx=True).
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two Newton steps on a reciprocal seed of x (the JAX kernels' f32-exact
// scheme, lj_dense.py:66-75 and lj_cull.py:425-437).  Written with explicit
// rounding intrinsics so that every caller gets the same instructions and
// the same bits, whatever the compiler would contract around it.
__device__ __forceinline__ float lj_newton2(float x, float inv) {
  inv = __fmul_rn(inv, __fmaf_rn(-x, inv, 2.0f));
  return __fmul_rn(inv, __fmaf_rn(-x, inv, 2.0f));
}

// The LJ engines' reciprocal: the fast seed, or the seed refined by
// lj_newton2.
__device__ __forceinline__ float lj_recip(float x, bool approx) {
  const float inv = rcp_approx(x);
  return approx ? inv : lj_newton2(x, inv);
}

// One compensated (Kahan) accumulation step (lj_dense.py:108-119).
__device__ __forceinline__ void kahan_add(float& acc, float& comp, float term) {
  float y = term - comp;
  float t = acc + y;
  comp = (t - acc) - y;
  acc = t;
}

// The O-step noise of the JAX MD kernels (lj_cull.py:545, lj_strip.py:215):
// splitmix32 counters 2 lane and 2 lane + 1, times 0x9E3779B9, plus
// seed 0x9E3779B9 + step 0x85EBCA6B; the finaliser below; (mix >> 8) 2^-24.
// The callers differ in how lanes are numbered and which Box-Muller
// branches they keep.
constexpr float kTwoPi = 6.2831853071795864f;

__device__ __forceinline__ uint32_t mix32(uint32_t z) {
  z = z ^ (z >> 16);
  z = z * 0x85EBCA6Bu;
  z = z ^ (z >> 13);
  z = z * 0xC2B2AE35u;
  z = z ^ (z >> 16);
  return z;
}

// The uniform pair of `lane` at `step`, u1 clamped at 1e-7 for the log.
__device__ __forceinline__ void lane_uniforms(uint32_t seed, uint32_t step,
                                              uint32_t lane, float& u1,
                                              float& u2) {
  const uint32_t base = seed * 0x9E3779B9u + step * 0x85EBCA6Bu;
  const uint32_t c1 = (lane * 2u) * 0x9E3779B9u + base;
  const uint32_t c2 = (lane * 2u + 1u) * 0x9E3779B9u + base;
  u1 = fmaxf(static_cast<float>(static_cast<int>(mix32(c1) >> 8)) *
                 (1.0f / 16777216.0f),
             1e-7f);
  u2 = static_cast<float>(static_cast<int>(mix32(c2) >> 8)) *
       (1.0f / 16777216.0f);
}

// The radius and angle of a lane's two-output Box-Muller draw.
__device__ __forceinline__ void box_muller(uint32_t seed, uint32_t step,
                                           uint32_t lane, float& r,
                                           float& theta) {
  float u1, u2;
  lane_uniforms(seed, step, lane, u1, u2);
  r = __fsqrt_rn(__fmul_rn(-2.0f, logf(u1)));
  theta = __fmul_rn(kTwoPi, u2);
}

// One lane's BAOAB update of K3 (lj_cull.py:545, _baoab_phase), in the
// half-kick convention w = v - dt/2 F/m, given the lane's force F and noise:
//   v = w + dt F minv; x += dt/2 v; v = a v + b sigv noise; x += dt/2 v;
//   x wrapped by x - floor(x invL) L.
// The standalone BAOAB phase (baoab.cu) and the culled gather's epilogue
// (lj_cull_force.cu) both call it; every op is an explicit _rn intrinsic in
// the order and contraction the parent's SASS of baoab_phase had, so that
// both kernels round alike and as before.
__device__ __forceinline__ void baoab_lane(float& x, float& w, float F,
                                           float minv, float sigv,
                                           float noise, float L, float invL,
                                           float dt, float half_dt, float a,
                                           float b) {
  float v = __fmaf_rn(__fmul_rn(dt, F), minv, w);
  float xx = __fmaf_rn(half_dt, v, x);
  v = __fmaf_rn(a, v, __fmul_rn(__fmul_rn(b, sigv), noise));
  xx = __fmaf_rn(half_dt, v, xx);
  xx = __fmaf_rn(-floorf(__fmul_rn(xx, invL)), L, xx);
  x = xx;
  w = v;
}

// Entry points that other entries enqueue: the fused MD segment
// (lj_md_fused.cu) runs K1's pair kernel with the divide, and the culled
// and megakernel segments (lj_cull_force.cu, lj_mega.cu) run K3's kernels.
cudaError_t lj_dense_force_divide(const float* pos, const float* box,
                                  float* force, int n, int n_pad, float sigma2,
                                  float coef_scale, float cutoff2,
                                  float r2_floor, cudaStream_t s);
CHIRON_EXPORT int chiron_baoab(float* x, float* w, float* F, const float* minv,
                               const float* sigv, const float* box,
                               const int* step_offset, int s, uint32_t seed,
                               int n_pad, float dt, float half_dt, float a,
                               float b, void* stream);

// The steps of one culled MD segment (K3's grid over the steps,
// lj_cull.py:984), enqueued back to back on one stream: step 0's BAOAB
// phase alone, then for each step k the culled pair pass and the gather,
// whose epilogue applies step k + 1's BAOAB update to the lanes it has just
// written (not on the last step).  x, w, F are updated in place; energy,
// when not null, takes the last step's exact-reciprocal energy.
struct CullMD {
  float* x;
  float* w;
  float* F;
  const float* minv;
  const float* sigv;
  const float* box;
  const int* step_offset;
  uint32_t seed;
  int n_steps;
  const int* rows;
  const int* cols;
  const float* ccx;
  const int* ptr2;
  const float* rowcx;
  const int* count;
  float* P;
  float* R;
  float* e_part;
  float* energy;
  int n, n_pad, tm, tn, capacity;
  float dt, half_dt, a, b;
  float inv_sigma, sigma_fold, cutoff2_s, eps_scale, e_scale;
  int approx;
  unsigned long long* work;  // (2,) the pair passes' work counts, or null
};
cudaError_t cull_md_steps(const CullMD& m, cudaStream_t s);

// The drift latch (drift.cu) on one stream: `part` holds 4 ints for each
// kLatchBlockLanes lanes, `ticket` one int that is 0 before the launch and
// after it.
constexpr int kLatchBlockLanes = 1024;
cudaError_t drift_latch(const float* x, const float* anchor, const float* box,
                        int n, int n_pad, const float* threshold, int* part,
                        unsigned* ticket, bool* flag, cudaStream_t s);

// The rows of a row tile of tm that one block of the culled and band passes
// takes (lj_cull_force.cu, lj_band.cu; ops/lj_cull.py row_chunk): the whole
// tile up to 256, else 256 where they divide it, else 128, so that a
// block's registers and shared memory stay those of tm = 256 whatever the
// tile.
inline int row_chunk(int tm) {
  return tm <= 256 ? tm : (tm % 256 == 0 ? 256 : 128);
}

// Culling a warp's whole block of pairs at once (lj_dense.cu,
// lj_cull_force.cu).  A warp gathers the bounding box of its particles:
// each point's offsets from one reference point, min-imaged on the periodic
// axes, give per axis a center and a half-width that hold every point up to
// whole periods.  Two boxes are apart when the summed squares of the axis
// gaps |min-image(center difference)| - both half-widths, floored at 0,
// exceed a threshold: every pair between them is then at least that far
// apart, since on an axis of period P with |d| <= P/2 no image of a point of
// one box comes closer to the other than |d| - hA - hB.  The callers pass the
// squared cutoff raised by 2e-3, so that the float rounding of the boxes
// (about 1e-6 of the coordinates) never culls a pair inside the cutoff.  A
// non-finite coordinate anywhere in either box forbids culling, so a NaN
// reaches the same sums it reaches without culling.
namespace cull {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kRaise = 1.002f;  // the squared cutoff's margin for culling

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

struct Box {
  float c[3], h[3];
  bool finite;
};

// One warp's box, built point by point: every lane of the warp constructs it
// with the same reference point (lane 0's first point, say), adds its own
// points, and calls reduce() together with the others.  per[a] is the
// period of axis a and iper[a] its inverse; per[a] == 0 leaves the axis open.
struct BoxAcc {
  float ref[3], lo[3], hi[3];
  bool finite;

  __device__ __forceinline__ BoxAcc(float rx, float ry, float rz)
      : ref{rx, ry, rz}, finite(true) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = __int_as_float(0x7f800000);  // +inf
      hi[a] = -lo[a];
    }
  }

  __device__ __forceinline__ void add(float x, float y, float z,
                                      const float (&per)[3],
                                      const float (&iper)[3]) {
    const float p[3] = {x, y, z};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float o = p[a] - ref[a];
      if (per[a] > 0.0f) o -= per[a] * rintf(o * iper[a]);
      lo[a] = fminf(lo[a], o);
      hi[a] = fmaxf(hi[a], o);
      finite = finite && isfinite(p[a]);
    }
  }

  __device__ __forceinline__ Box reduce() const {
    Box b;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float l = warp_min(lo[a]), h = warp_max(hi[a]);
      b.c[a] = ref[a] + 0.5f * (l + h);
      b.h[a] = 0.5f * (h - l);
    }
    b.finite = __all_sync(kFull, finite);
    return b;
  }
};

__device__ __forceinline__ bool apart(const Box& A, const Box& B,
                                      const float (&per)[3],
                                      const float (&iper)[3], float thr2) {
  if (!(A.finite && B.finite)) return false;
  float g2 = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float d = A.c[a] - B.c[a];
    if (per[a] > 0.0f) d -= per[a] * rintf(d * iper[a]);
    const float g = fabsf(d) - A.h[a] - B.h[a];
    if (g > 0.0f) g2 += g * g;
  }
  return g2 > thr2;
}

// The sum of one float a thread over a block of kThreads threads (a
// multiple of 32), in one fixed order: a butterfly in each warp, then the
// warps' sums in warp order.  Every thread gets the total; `scratch` holds
// kThreads / 32 floats; tid is the thread's linear index in the block.
template <int kThreads>
__device__ __forceinline__ float block_sum(float v, float* scratch, int tid) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();  // scratch may still be read by an earlier call
  if ((tid & 31) == 0) scratch[tid >> 5] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += scratch[w];
  return s;
}

}  // namespace cull

// The sum of n_parts partials in one fixed order, times scale, into *out:
// each thread a strided compensated sum, then the threads in order
// (cull::block_sum).  A block of kSumThreads threads a sum (lj_dense.cu's and
// lj_strip.cu's energies): block b sums parts[b n_parts ..] into out[b], so
// one launch of R blocks sums R replicas' partials, each as one block alone.
constexpr int kSumThreads = 256;

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
partial_sum(const float* __restrict__ parts, int n_parts, float scale,
            float* __restrict__ out) {
  __shared__ float scratch[kThreads / 32];
  parts += static_cast<size_t>(blockIdx.x) * n_parts;
  out += blockIdx.x;
  float acc = 0.0f, comp = 0.0f;
  for (int k = threadIdx.x; k < n_parts; k += kThreads)
    kahan_add(acc, comp, parts[k]);
  const float s = cull::block_sum<kThreads>(acc - comp, scratch, threadIdx.x);
  if (threadIdx.x == 0) out[0] = scale * s;
}

// What the banded pair kernels (lj_band.cu, K8b in spatial.cu) share: the
// minimum image, the range test that allows its cheap form, and block or
// warp bounds of x (the strip pass of lj_strip.cu takes the last, r^2 and
// x_apart too).
//
// Their minimum image of a displacement d on an axis of period L is
// fma(-L, floor(fma(d, 1/L, 1/2)), d), one rounding an op (floor_image).
// Where both coordinates lie in [-L/8, 9L/8],
// the floor takes only -1, 0 or 1, and each is decided by one compare of d:
// fma(d, 1/L, 1/2) is monotone in d, so it is >= 1 exactly from hi, the least
// float that takes it there, and < 0 exactly below lo, the least float that
// keeps it at 0 or above.  So compare_image, fma(-L, (d >= hi) - (d < lo), d),
// has the bits of floor_image without its FRND, and where every x
// displacement of a visit lies in [lo, hi) the x image is d itself.
namespace band {

constexpr unsigned kFull = 0xffffffffu;

// How a visit (a block of rows against a staged tile of columns) takes its
// slots.
enum Visit {
  kInterior,  // every pair live and in the band, no x image: the vote only
  kEdge,      // the per-slot rank mask and the compare image on x too
  kWhole,     // every slot: floor images, the mask and the LJ term on each
  kApart,     // every pair at least the cutoff apart in x: nothing to take
};

struct Axis {
  float L, iL, lo, hi, cmin, cmax;  // cmin, cmax: -L/8 and 9L/8
};

struct Geometry {
  Axis a[3];
  bool ok;  // every threshold was found: compare_image may be taken
};

// The least float d with fma(d, iL, 1/2) >= level, by a walk from an
// estimate a few ulps away; false if the walk does not settle.
__device__ __forceinline__ bool least_reaching(float L, float iL, float level,
                                               float& out) {
  float d = __fmul_rn(__fsub_rn(level, 0.5f), L);
  for (int it = 0; it < 64; ++it) {
    const float below = nextafterf(d, __int_as_float(0xff800000));  // -inf
    if (__fmaf_rn(d, iL, 0.5f) < level) {
      d = nextafterf(d, __int_as_float(0x7f800000));
    } else if (__fmaf_rn(below, iL, 0.5f) >= level) {
      d = below;
    } else {
      out = d;
      return true;
    }
  }
  return false;
}

__device__ __forceinline__ Geometry geometry(const float* box) {
  Geometry g;
  g.ok = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    Axis& x = g.a[a];
    x.L = box[a];
    x.iL = __fdiv_rn(1.0f, x.L);
    x.lo = x.hi = 0.0f;
    g.ok = g.ok && x.L > 0.0f && least_reaching(x.L, x.iL, 1.0f, x.hi) &&
           least_reaching(x.L, x.iL, 0.0f, x.lo);
    x.cmin = __fmul_rn(-0.125f, x.L);
    x.cmax = __fmul_rn(1.125f, x.L);
  }
  return g;
}

__device__ __forceinline__ float floor_image(float d, const Axis& a) {
  return __fmaf_rn(-a.L, floorf(__fmaf_rn(d, a.iL, 0.5f)), d);
}

__device__ __forceinline__ float set_ge(float a, float b) {  // 1 or 0
  float r;
  asm("set.ge.f32.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float set_lt(float a, float b) {  // 1 or 0
  float r;
  asm("set.lt.f32.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float compare_image(float d, const Axis& a) {
  return __fmaf_rn(-a.L, __fsub_rn(set_ge(d, a.hi), set_lt(d, a.lo)), d);
}

// The minimum-imaged displacement (xi - xj, ...) of a visit of kind kMode.
template <Visit kMode>
__device__ __forceinline__ void displacement(float xi, float yi, float zi,
                                             float xj, float yj, float zj,
                                             const Geometry& g, float& dx,
                                             float& dy, float& dz) {
  dx = __fsub_rn(xi, xj);
  dy = __fsub_rn(yi, yj);
  dz = __fsub_rn(zi, zj);
  if constexpr (kMode == kWhole) {
    dx = floor_image(dx, g.a[0]);
    dy = floor_image(dy, g.a[1]);
    dz = floor_image(dz, g.a[2]);
  } else {
    if constexpr (kMode == kEdge) dx = compare_image(dx, g.a[0]);
    dy = compare_image(dy, g.a[1]);
    dz = compare_image(dz, g.a[2]);
  }
}

// r^2, one rounding an op.
__device__ __forceinline__ float norm2(float dx, float dy, float dz) {
  return __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
}

// Whether a point lies where compare_image holds (false for a NaN or an
// infinite coordinate).
__device__ __forceinline__ bool in_range(float x, float y, float z,
                                         const Geometry& g) {
  return x >= g.a[0].cmin && x <= g.a[0].cmax && y >= g.a[1].cmin &&
         y <= g.a[1].cmax && z >= g.a[2].cmin && z <= g.a[2].cmax;
}

// Floats as ints of the same order (for finite values), so that a warp takes
// their least and greatest with __reduce_min_sync / __reduce_max_sync.
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// Whether every x displacement RN(xi - xj), xi in [rmin, rmax] and xj in
// [cmin, cmax], lies in [lo, hi): RN(a - b) is monotone in a and in -b.
__device__ __forceinline__ bool x_image_zero(float rmin, float rmax,
                                             float cmin, float cmax,
                                             const Axis& a) {
  return __fsub_rn(rmin, cmax) >= a.lo && __fsub_rn(rmax, cmin) < a.hi;
}

// Given x_image_zero: whether every pair is at least the cutoff apart in x
// alone, so that none is within it.  Every x displacement then has
// |dx| >= |d| for the bound d nearer 0, and r^2 = fma(dz, dz, fma(dx, dx,
// dy dy)) >= RN(dx dx) >= RN(d d) >= cutoff^2, each step monotone.
__device__ __forceinline__ bool x_apart(float rmin, float rmax, float cmin,
                                        float cmax, float cutoff2) {
  const float hi = __fsub_rn(rmax, cmin), lo = __fsub_rn(rmin, cmax);
  return (hi < 0.0f && __fmul_rn(hi, hi) >= cutoff2) ||
         (lo > 0.0f && __fmul_rn(lo, lo) >= cutoff2);
}

}  // namespace band

// The tiled pair pass of lj_band.cu runs
// kThreads threads a block as kRG row groups by kCG column groups.  A block
// writes partial sums to slots of its own, and a gather kernel adds them
// per particle.  Every sum below has one order, so a repeated call is
// bitwise identical.
namespace pair_pass {

constexpr int kRG = 16;              // row groups per block
constexpr int kCG = 16;              // column groups per block
constexpr int kThreads = kRG * kCG;  // 256

// After a column tile of width w: red[kRG][3][w] holds each row group's
// column sums; write their total over the row groups to R (3 x w).
__device__ __forceinline__ void store_col_partials(const float* red, int w,
                                                   float* R) {
  for (int t = threadIdx.x; t < w; t += kThreads) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float s = 0.0f;
      for (int g = 0; g < kRG; ++g) s += red[(g * 3 + a) * w + t];
      R[a * w + t] = s;
    }
  }
}

// After the last column tile: the thread's RPT row sums go through
// red[kCG][3][tm], and their total over the column groups to P (three rows
// of stride n_pad, starting at the row tile's first row).
template <int RPT>
__device__ __forceinline__ void store_row_partials(
    float* red, int tm, const float (&fx)[RPT], const float (&fy)[RPT],
    const float (&fz)[RPT], float* P, int n_pad) {
  const int rg = threadIdx.x / kCG, cg = threadIdx.x % kCG;
  __syncthreads();
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int r = rg * RPT + u;
    red[(cg * 3 + 0) * tm + r] = fx[u];
    red[(cg * 3 + 1) * tm + r] = fy[u];
    red[(cg * 3 + 2) * tm + r] = fz[u];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < tm; r += kThreads) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float s = 0.0f;
      for (int g = 0; g < kCG; ++g) s += red[(g * 3 + a) * tm + r];
      P[static_cast<size_t>(a) * n_pad + r] = s;
    }
  }
}

// The block's energy: the threads' sums, Kahan-added in thread order, to
// *out.
__device__ __forceinline__ void store_energy_partial(float* red, float e,
                                                     float* out) {
  __syncthreads();
  red[threadIdx.x] = e;
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.0f, comp = 0.0f;
    for (int t = 0; t < kThreads; ++t) kahan_add(acc, comp, red[t]);
    *out = acc - comp;
  }
}

// In the gather: particle q's row partials from the n_split blocks of its
// row tile, in block order.
__device__ __forceinline__ void sum_row_partials(const float* P, int n_split,
                                                 int n_pad, int q,
                                                 float (&f)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float s = 0.0f;
    for (int sp = 0; sp < n_split; ++sp)
      s += P[(static_cast<size_t>(sp) * 3 + a) * n_pad + q];
    f[a] = s;
  }
}

// The call's energy: the blocks' partials, Kahan-added in order.
__device__ __forceinline__ float sum_energy_partials(const float* e_part,
                                                     int n_parts) {
  float acc = 0.0f, comp = 0.0f;
  for (int k = 0; k < n_parts; ++k) kahan_add(acc, comp, e_part[k]);
  return acc - comp;
}

// Launch a pass kernel of kThreads threads with `smem` bytes of dynamic
// shared memory (more than the default 48 KB needs the attribute).
template <typename Params>
cudaError_t launch_pass(void (*kernel)(Params), dim3 grid, size_t smem,
                        cudaStream_t s, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace pair_pass
