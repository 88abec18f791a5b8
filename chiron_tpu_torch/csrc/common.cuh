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

// The LJ engines' reciprocal: the fast seed, or the seed refined by two
// Newton steps (the JAX kernels' f32-exact scheme, lj_dense.py:66-75 and
// lj_cull.py:425-437).
__device__ __forceinline__ float lj_recip(float x, bool approx) {
  float inv = rcp_approx(x);
  if (!approx) {
    inv = inv * (2.0f - x * inv);
    inv = inv * (2.0f - x * inv);
  }
  return inv;
}

// One compensated (Kahan) accumulation step (lj_dense.py:108-119).
__device__ __forceinline__ void kahan_add(float& acc, float& comp, float term) {
  float y = term - comp;
  float t = acc + y;
  comp = (t - acc) - y;
  acc = t;
}
