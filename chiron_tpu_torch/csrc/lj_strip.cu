// Halo-strip LJ MD: a step's BAOAB phase with the halo refresh, and the
// strip force pass with the halo fold (K7).
//
// Replaces chiron_tpu/ops/lj_strip.py: _make_strip_md_kernel (:184) via
// strip_md_raw (pallas_call at :308), strip_force_raw (:477) and
// strip_force_energy_raw (:526), all on _strip_force_pass (:69).  The TPU
// kernel runs S whole steps in one call; here a step is a sequence of
// launches on one stream: chiron_strip_baoab, then chiron_strip_force.
//
// strip_baoab, per lane (axis, col) of (3, n_pad), in the half-kick
// convention w = v - dt/2 F/m (:209-265):
//   v = w + dt F minv; x += dt/2 v; v = a v + b sigv noise; x += dt/2 v;
//   live lanes (col < n) wrapped by x - floor(x / L) L, padding left at its
//   1e18 sentinel; and a lane with col < H also writes its halo copy at
//   n_pad + col, shifted by +Lx on x.  The noise is the JAX stream bit for
//   bit: counters 2 lane and 2 lane + 1 with lane = axis n_pad + col, times
//   0x9E3779B9, plus seed 0x9E3779B9 + step 0x85EBCA6B; the splitmix32
//   finaliser, (mix >> 8) 2^-24, and the cos branch of Box-Muller only.
//   Bound: memory (7 floats read, 2 written a lane, plus the halo).
//
// strip_rows / strip_gather: row tile i (rows i tm .. i tm + tm) against
// the extended columns [i tm, i tm + tm + H), in chunks of tm columns.
// x takes no minimum image (the halo carries it), y and z take
// floor(d/L + 1/2); chunk 0's col <= row slots and the pairs at or beyond
// the cutoff get r^2 + 1e18, so their terms underflow to exactly 0; the
// energy counts a slot only where r^2 > 0 before the clamp (padding
// against padding has r^2 == 0 exactly and would add the clamp's value).
// The TPU kernel writes the column reactions into the extended force in
// grid order; on Hopper block (i, s) takes chunks s, s + S, ... and writes
// each chunk's column partials, reduced over its row groups in a fixed
// order, to R[i n_chunks + j], and its row sums to P[s].  strip_gather then
// gives each rank q its row partials, minus the partials of every chunk
// that covers extended column q and, for q < H, column n_pad + q (the halo
// fold), in a fixed order, times 24 eps.  A repeated call is bitwise
// identical.  Bound: pair arithmetic, n_pad (tm + H) candidate slots less
// the leading triangle, of which the LJ term is needed only within the
// cutoff; this kernel takes it on every slot.
#include "common.cuh"

using namespace pair_pass;

namespace {

__global__ void strip_baoab(float* __restrict__ xe, float* __restrict__ w,
                            const float* __restrict__ F,
                            const float* __restrict__ minv,
                            const float* __restrict__ sigv,
                            const float* __restrict__ box,
                            const int* __restrict__ step_offset, int s,
                            uint32_t seed, int n, int n_pad, int H, float dt,
                            float half_dt, float a, float b) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;  // over (3, n_pad)
  if (lane >= 3 * n_pad) return;
  const int axis = lane / n_pad;
  const int col = lane - axis * n_pad;
  const int n_ext = n_pad + H;
  const uint32_t step = static_cast<uint32_t>(s) +
                        static_cast<uint32_t>(step_offset[0]);
  float u1, u2;
  lane_uniforms(seed, step, static_cast<uint32_t>(lane), u1, u2);
  const float noise = sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
  float v = w[lane] + dt * F[lane] * minv[col];
  float x = xe[axis * n_ext + col] + half_dt * v;
  v = a * v + b * sigv[col] * noise;
  x = x + half_dt * v;
  if (col < n) {
    const float L = box[axis];
    x = x - floorf(x / L) * L;
  }
  xe[axis * n_ext + col] = x;
  w[lane] = v;
  if (col < H) xe[axis * n_ext + n_pad + col] = axis == 0 ? x + box[0] : x;
}

struct Params {
  const float* xe;  // (3, n_pad + H) extended positions
  const float* box; // (3,)
  float* P;         // (S, 3, n_pad) row partials
  float* R;         // (nr n_chunks, 3, tm) column partials
  float* e_part;    // (nr S,) energy partials
  float* F;         // (3, n_pad) folded output force
  float* energy;    // (1,) output energy, or null
  int n_pad, tm, H, nr, n_chunks;
  float sigma2, cutoff2, r2_floor, big, coef_scale, e_scale;
  int approx;
};

template <int RPT, bool kEnergy>
__global__ void __launch_bounds__(kThreads) strip_rows(Params p) {
  extern __shared__ float smem[];
  const int tm = p.tm, n_ext = p.n_pad + p.H;
  float* sx = smem;
  float* sy = sx + tm;
  float* sz = sy + tm;
  float* red = sz + tm;  // [kRG][3][tm] columns, then [kCG][3][tm] rows
  const int i = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int tid = threadIdx.x, rg = tid / kCG, cg = tid % kCG;
  const int row0 = i * tm;
  const float Ly = p.box[1], Lz = p.box[2];
  const float iLy = 1.0f / Ly, iLz = 1.0f / Lz;

  float xi[RPT], yi[RPT], zi[RPT], fx[RPT], fy[RPT], fz[RPT];
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int r = row0 + rg * RPT + u;
    xi[u] = p.xe[r];
    yi[u] = p.xe[n_ext + r];
    zi[u] = p.xe[2 * n_ext + r];
    fx[u] = fy[u] = fz[u] = 0.0f;
  }
  [[maybe_unused]] float ea = 0.0f, ec = 0.0f;

  for (int j = split; j < p.n_chunks; j += n_split) {
    const int col0 = row0 + j * tm;
    __syncthreads();  // the previous chunk's staging and partials are read
    for (int t = tid; t < tm; t += kThreads) {
      sx[t] = p.xe[col0 + t];
      sy[t] = p.xe[n_ext + col0 + t];
      sz[t] = p.xe[2 * n_ext + col0 + t];
    }
    __syncthreads();
    for (int t = cg; t < tm; t += kCG) {
      const float xj = sx[t], yj = sy[t], zj = sz[t];
      float cx_sum = 0.0f, cy_sum = 0.0f, cz_sum = 0.0f;
#pragma unroll
      for (int u = 0; u < RPT; ++u) {
        const float dx = xi[u] - xj;
        float dy = yi[u] - yj;
        dy = dy - Ly * floorf(dy * iLy + 0.5f);
        float dz = zi[u] - zj;
        dz = dz - Lz * floorf(dz * iLz + 0.5f);
        float r2 = dx * dx + dy * dy + dz * dz;
        if (j == 0 && t <= rg * RPT + u) r2 = r2 + p.big;
        r2 = r2 + (r2 < p.cutoff2 ? 0.0f : p.big);
        [[maybe_unused]] const bool pair_ok = r2 > 0.0f;
        r2 = fmaxf(r2, p.r2_floor);
        const float seed = rcp_approx(r2);
        const float inv = p.approx != 0 ? seed : lj_newton2(r2, seed);
        const float i2 = p.sigma2 * inv;
        const float i6 = i2 * i2 * i2;
        const float coef = (2.0f * (i6 * i6) - i6) * inv;
        const float tx = coef * dx, ty = coef * dy, tz = coef * dz;
        fx[u] += tx;
        fy[u] += ty;
        fz[u] += tz;
        cx_sum += tx;
        cy_sum += ty;
        cz_sum += tz;
        if constexpr (kEnergy) {
          const float inv_e = p.approx != 0 ? lj_newton2(r2, seed) : inv;
          const float i2e = p.sigma2 * inv_e;
          const float i6e = i2e * i2e * i2e;
          kahan_add(ea, ec, pair_ok ? i6e * i6e - i6e : 0.0f);
        }
      }
      red[(rg * 3 + 0) * tm + t] = cx_sum;
      red[(rg * 3 + 1) * tm + t] = cy_sum;
      red[(rg * 3 + 2) * tm + t] = cz_sum;
    }
    __syncthreads();
    store_col_partials(
        red, tm, p.R + (static_cast<size_t>(i) * p.n_chunks + j) * 3 * tm);
  }
  store_row_partials<RPT>(
      red, tm, fx, fy, fz,
      p.P + static_cast<size_t>(split) * 3 * p.n_pad + row0, p.n_pad);
  if constexpr (kEnergy)
    store_energy_partial(red, ea - ec, p.e_part + i * n_split + split);
}

// Subtract from f the column partials of every chunk that covers extended
// column c, row tile by row tile in increasing order.
__device__ __forceinline__ void sub_column(const Params& p, int c, float* f) {
  const int tm = p.tm, ct = c / tm, t = c - ct * tm;
  const int i0 = ct - p.n_chunks + 1 > 0 ? ct - p.n_chunks + 1 : 0;
  const int i1 = ct < p.nr - 1 ? ct : p.nr - 1;
  for (int i = i0; i <= i1; ++i) {
    const float* Rj =
        p.R + (static_cast<size_t>(i) * p.n_chunks + (ct - i)) * 3 * tm;
    f[0] -= Rj[t];
    f[1] -= Rj[tm + t];
    f[2] -= Rj[2 * tm + t];
  }
}

__global__ void strip_gather(Params p, int n_split, int n_parts) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p.n_pad) return;
  float f[3];
  sum_row_partials(p.P, n_split, p.n_pad, q, f);
  sub_column(p, q, f);
  if (q < p.H) sub_column(p, p.n_pad + q, f);
#pragma unroll
  for (int a = 0; a < 3; ++a) p.F[a * p.n_pad + q] = p.coef_scale * f[a];
  if (p.energy != nullptr && q == 0)
    p.energy[0] = p.e_scale * sum_energy_partials(p.e_part, n_parts);
}

template <int RPT>
cudaError_t launch_rows(const Params& p, int n_split, size_t smem,
                        cudaStream_t s) {
  const dim3 grid(p.nr, n_split);
  return p.energy != nullptr
             ? launch_pass(strip_rows<RPT, true>, grid, smem, s, p)
             : launch_pass(strip_rows<RPT, false>, grid, smem, s, p);
}

}  // namespace

// xe, w: (3, n_pad + H) and (3, n_pad) f32, updated in place; F: (3, n_pad)
// f32; minv, sigv: (n_pad,) f32; box: (3,) f32; step_offset: (1,) i32.
CHIRON_EXPORT int chiron_strip_baoab(float* xe, float* w, const float* F,
                                     const float* minv, const float* sigv,
                                     const float* box, const int* step_offset,
                                     int s, uint32_t seed, int n, int n_pad,
                                     int H, float dt, float half_dt, float a,
                                     float b, void* stream) {
  constexpr int kBlock = 256;
  const int lanes = 3 * n_pad;
  strip_baoab<<<(lanes + kBlock - 1) / kBlock, kBlock, 0,
                static_cast<cudaStream_t>(stream)>>>(
      xe, w, F, minv, sigv, box, step_offset, s, seed, n, n_pad, H, dt,
      half_dt, a, b);
  return static_cast<int>(cudaGetLastError());
}

// xe: (3, n_pad + H) f32; box: (3,) f32; P: (n_split, 3, n_pad) f32;
// R: (n_pad / tm * (tm + H) / tm, 3, tm) f32; e_part: (n_pad / tm *
// n_split,) f32; F: (3, n_pad) f32; energy: (1,) f32 or null.  tm must be
// 16, 32, 64 or 128 and divide n_pad and H.  approx sets the force's
// reciprocal; the energy's is always exact.
CHIRON_EXPORT int chiron_strip_force(
    const float* xe, const float* box, float* P, float* R, float* e_part,
    float* F, float* energy, int n_pad, int tm, int H, int n_split,
    float sigma2, float cutoff2, float r2_floor, float big, float coef_scale,
    float e_scale, int approx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nr = n_pad / tm;
  Params p{xe, box, P, R, e_part, F, energy, n_pad, tm, H, nr, (tm + H) / tm,
           sigma2, cutoff2, r2_floor, big, coef_scale, e_scale, approx};
  const int red_floats = kRG * 3 * tm;  // kRG == kCG: rows fit the same
  const int floats = 3 * tm + (red_floats > kThreads ? red_floats : kThreads);
  const size_t smem = static_cast<size_t>(floats) * sizeof(float);
  cudaError_t err;
  switch (tm / kRG) {
    case 1: err = launch_rows<1>(p, n_split, smem, s); break;
    case 2: err = launch_rows<2>(p, n_split, smem, s); break;
    case 4: err = launch_rows<4>(p, n_split, smem, s); break;
    case 8: err = launch_rows<8>(p, n_split, smem, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kGather = 256;
  strip_gather<<<(n_pad + kGather - 1) / kGather, kGather, 0, s>>>(
      p, n_split, nr * n_split);
  return static_cast<int>(cudaGetLastError());
}
