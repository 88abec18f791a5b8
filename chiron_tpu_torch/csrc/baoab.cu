// One BAOAB step's update phase of the culled MD segment (K3, first half).
//
// Replaces chiron_tpu/ops/lj_cull.py: _baoab_phase (:545), run once a grid
// step inside _make_md_kernel (pallas_call at :984).  Per lane, in the
// half-kick convention w = v - dt/2 F/m:
//   v = w + dt F minv; x += dt/2 v;
//   v = a v + b sigv noise; x += dt/2 v; x wrapped by x - floor(x invL) L;
//   F = 0 (the force pass that follows overwrites every lane).
// The noise is the JAX kernel's stream bit for bit: splitmix32 counters
// 2 lane and 2 lane + 1 (lane over (3, n_pad/2)) times 0x9E3779B9 plus
// base = seed 0x9E3779B9 + (s + offset) 0x85EBCA6B, the mix finaliser,
// (mix >> 8) 2^-24, and a two-output Box-Muller: cos into the first half of
// each row, sin into the second.  The transcendentals are the full-precision
// logf, sqrtf, cosf and sinf (the library is built without fast math).
//
// Bound: memory, 7 floats read and 3 written a lane, all of it L2-resident
// at the main path's n_pad; at that size the launch itself dominates.  A
// culled segment (lj_cull_force.cu, cull_md_steps) launches it once, for
// its first step: the gather's epilogue applies every later step's update
// through the same baoab_lane (common.cuh), so both round alike.  One
// thread takes the two lanes that share a uniform pair, so the counters and
// the logarithm run once for both.  The step offset is read from device
// memory so that the segment loop never waits on the host.
#include "common.cuh"

namespace {

__global__ void baoab_phase(float* __restrict__ x, float* __restrict__ w,
                            float* __restrict__ F,
                            const float* __restrict__ minv,
                            const float* __restrict__ sigv,
                            const float* __restrict__ box,
                            const int* __restrict__ step_offset, int s,
                            uint32_t seed, int n_pad, float dt, float half_dt,
                            float a, float b) {
  const int half = n_pad / 2;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;  // over (3, half)
  if (lane >= 3 * half) return;
  const int row = lane / half;
  const int col = lane - row * half;
  const uint32_t step = static_cast<uint32_t>(s) +
                        static_cast<uint32_t>(step_offset[0]);
  float r, theta;
  box_muller(seed, step, static_cast<uint32_t>(lane), r, theta);
  const float noise[2] = {__fmul_rn(r, cosf(theta)),
                          __fmul_rn(r, sinf(theta))};
  const float L = box[row];
  const float invL = __fdiv_rn(1.0f, L);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = col + h * half;
    const int j = row * n_pad + c;
    float xx = x[j], v = w[j];
    baoab_lane(xx, v, F[j], minv[c], sigv[c], noise[h], L, invL, dt, half_dt,
               a, b);
    x[j] = xx;
    w[j] = v;
    F[j] = 0.0f;
  }
}

}  // namespace

// x, w, F: (3, n_pad) f32, updated in place; minv, sigv: (n_pad,) f32;
// box: (3,) f32; step_offset: (1,) i32.  n_pad must be even.
CHIRON_EXPORT int chiron_baoab(float* x, float* w, float* F, const float* minv,
                               const float* sigv, const float* box,
                               const int* step_offset, int s, uint32_t seed,
                               int n_pad, float dt, float half_dt, float a,
                               float b, void* stream) {
  constexpr int kThreads = 256;
  const int lanes = 3 * (n_pad / 2);
  baoab_phase<<<(lanes + kThreads - 1) / kThreads, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      x, w, F, minv, sigv, box, step_offset, s, seed, n_pad, dt, half_dt, a, b);
  return static_cast<int>(cudaGetLastError());
}
