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
