// S fused BAOAB steps on the dense LJ force (K9).
//
// Replaces chiron_tpu/ops/lj_md_fused.py: _make_md_kernel (:43), launched by
// fused_md_raw (pallas_call at :212).  The TPU kernel keeps (x, v, F) in
// VMEM for the whole segment: its grid is (step, row tile), and program
// t == 0 of each step runs the update that every row tile of that step then
// reads.  Hopper has no grid-wide barrier inside a launch, so each step is
// two launches on the caller's stream, enqueued by one C entry:
//   1. fused_update, the t == 0 program: v += dt F / m (the merged full
//      kick, w convention), x += dt/2 v, the O step with the splitmix32
//      noise over (3, n_pad) lanes (lane = row n_pad + col, cos branch of
//      Box-Muller only, lj_md_fused.py:83-124), x += dt/2 v, and the wrap
//      x - floor(x / L) L with the divide (:132);
//   2. the triangle force of the step: lj_dense.cu's kernel (K1's blocks
//      of 32 rows against every column, with its chunk culling; no
//      reaction writes, no atomics) with the approximate reciprocal and the
//      minimum image by division (:157-159), writing every lane of F.
// The update writes its arithmetic op by op (no FMA contraction), so it
// repeats the plain version's rounding; the force differs from the plain
// exact-division force by the approximate reciprocal and the sum order.
//
// Bound: per step, the force's pair arithmetic (about 21 f32 operations a
// distance test on n(n-1)/2 pairs, the LJ term on the pairs within the
// cutoff) and the update's 10 (3, n_pad) rows of memory traffic, all
// L2-resident at the main path's n_pad; the launches themselves are
// enqueued back to back with no host work between them.
#include "common.cuh"

namespace {

__global__ void fused_update(float* __restrict__ x, float* __restrict__ w,
                             const float* __restrict__ F,
                             const float* __restrict__ minv,
                             const float* __restrict__ sigv,
                             const float* __restrict__ box, uint32_t seed,
                             uint32_t step, int n_pad, float dt, float half_dt,
                             float a, float b) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;  // over (3, n_pad)
  if (lane >= 3 * n_pad) return;
  const int row = lane / n_pad;
  const int col = lane - row * n_pad;
  float u1, u2;
  lane_uniforms(seed, step, static_cast<uint32_t>(lane), u1, u2);
  const float noise =
      __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))), cosf(__fmul_rn(kTwoPi, u2)));
  const float L = box[row];
  float v = __fadd_rn(w[lane], __fmul_rn(__fmul_rn(dt, F[lane]), minv[col]));
  float xx = __fadd_rn(x[lane], __fmul_rn(half_dt, v));
  v = __fadd_rn(__fmul_rn(a, v), __fmul_rn(__fmul_rn(b, sigv[col]), noise));
  xx = __fadd_rn(xx, __fmul_rn(half_dt, v));
  xx = __fsub_rn(xx, __fmul_rn(floorf(__fdiv_rn(xx, L)), L));
  x[lane] = xx;
  w[lane] = v;
}

}  // namespace

// x, w, F: (3, n_pad) f32, advanced in place (w is the velocity before the
// trailing half-kick); minv, sigv: (n_pad,) f32; box: (3,) f32.  Step s of
// the segment draws the noise of step step_offset + s.  n_pad must be a
// multiple of 32.
CHIRON_EXPORT int chiron_fused_md(float* x, float* w, float* F,
                                  const float* minv, const float* sigv,
                                  const float* box, uint32_t seed,
                                  uint32_t step_offset, int n_steps, int n,
                                  int n_pad, float dt, float half_dt, float a,
                                  float b, float sigma2, float coef_scale,
                                  float cutoff2, float r2_floor, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = 256;
  const int blocks = (3 * n_pad + kThreads - 1) / kThreads;
  for (int k = 0; k < n_steps; ++k) {
    fused_update<<<blocks, kThreads, 0, s>>>(
        x, w, F, minv, sigv, box, seed, step_offset + static_cast<uint32_t>(k),
        n_pad, dt, half_dt, a, b);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = lj_dense_force_divide(x, box, F, n, n_pad, sigma2, coef_scale,
                                cutoff2, r2_floor, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
