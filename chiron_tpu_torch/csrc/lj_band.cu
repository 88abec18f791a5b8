// Banded LJ force (and single-count energy) over x-sorted particles (K6).
//
// Replaces chiron_tpu/ops/lj_band.py: _make_band_kernel (:40), launched by
// band_force_raw (pallas_call at :160) and band_force_energy_raw (:188).
// Semantics as there: row tile i visits the n_band column tiles
// (i + k) mod n_tiles, k < n_band; a pair counts when both ranks are live
// (< n) and the cyclic rank distance (cid - rid + n) mod n is in [1, w], so
// each unordered pair is taken once; full minimum image on all three axes;
// r^2 clamped at 1e-4 sigma^2; coef = 24 eps (2 i6^2 - i6) / r^2 with
// i6 = (sigma^2 / r^2)^3; the row gets +coef d and the column -coef d.
//
// The TPU kernel subtracts the column reactions straight from the force
// block of other tiles, race-free only because its grid runs in order.
// Here, as in lj_cull_force.cu and with its reductions (common.cuh):
//   1. band_rows: block (i, s) owns row tile i and visits k = s, s + S, ...
//      A thread holds RPT rows against every kCG-th column; each visit's
//      column partials are reduced over the kRG row groups in a fixed
//      order into R[i n_band + k] (3 x tm), and the row sums into P[s].
//   2. band_gather: each particle sums P[0..S) and subtracts, for k in
//      order, the partial of the row tile (c - k) mod n_tiles, where c is
//      its own tile.
// Every sum has one order, so a repeated call is bitwise identical.  The
// scratch R is n_tiles x n_band x 3 x tm floats (54 MB at N = 100,000,
// tm = 256, w = 10,859): written once and read once a call.
//
// Bound: pair arithmetic.  The function needs the distance test on each of
// the n x w band pairs and the LJ term on the few within the cutoff; this
// kernel runs without branches over whole tiles, n_tiles x n_band x tm^2
// pair slots, and takes the LJ term on every one.  The energy
// instantiation sums eps4 (i6^2 - i6) over the same pairs with the exact
// reciprocal (two Newton steps on the rcp.approx seed, lj_newton2), in
// compensated per-thread sums folded in a fixed order.
#include "common.cuh"

using namespace pair_pass;

namespace {

struct Params {
  const float* x;   // (3, n_pad) x-sorted positions
  const float* box; // (3,)
  float* P;         // (S, 3, n_pad) row partials
  float* R;         // (n_tiles n_band, 3, tm) column partials
  float* e_part;    // (n_tiles S,) energy partials
  float* F;         // (3, n_pad) output force
  float* energy;    // (1,) output energy, or null
  int n, n_pad, tm, w, n_tiles, n_band;
  float sigma2, cutoff2, r2_floor, coef_scale, eps4;
  int approx;
};

template <int RPT, bool kEnergy>
__global__ void __launch_bounds__(kThreads) band_rows(Params p) {
  extern __shared__ float smem[];
  const int tm = p.tm, n_pad = p.n_pad, n = p.n;
  float* sx = smem;
  float* sy = sx + tm;
  float* sz = sy + tm;
  float* red = sz + tm;  // [kRG][3][tm] columns, then [kCG][3][tm] rows
  const int i = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int tid = threadIdx.x, rg = tid / kCG, cg = tid % kCG;
  const int row0 = i * tm;
  const float Lx = p.box[0], Ly = p.box[1], Lz = p.box[2];
  const float iLx = 1.0f / Lx, iLy = 1.0f / Ly, iLz = 1.0f / Lz;

  float xi[RPT], yi[RPT], zi[RPT], fx[RPT], fy[RPT], fz[RPT];
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int r = row0 + rg * RPT + u;
    xi[u] = p.x[r];
    yi[u] = p.x[n_pad + r];
    zi[u] = p.x[2 * n_pad + r];
    fx[u] = fy[u] = fz[u] = 0.0f;
  }
  [[maybe_unused]] float ea = 0.0f, ec = 0.0f;

  for (int k = split; k < p.n_band; k += n_split) {
    const int col0 = ((i + k) % p.n_tiles) * tm;
    __syncthreads();  // the previous visit's staging and partials are read
    for (int t = tid; t < tm; t += kThreads) {
      sx[t] = p.x[col0 + t];
      sy[t] = p.x[n_pad + col0 + t];
      sz[t] = p.x[2 * n_pad + col0 + t];
    }
    __syncthreads();
    for (int t = cg; t < tm; t += kCG) {
      const int cid = col0 + t;
      const float xj = sx[t], yj = sy[t], zj = sz[t];
      float cx_sum = 0.0f, cy_sum = 0.0f, cz_sum = 0.0f;
#pragma unroll
      for (int u = 0; u < RPT; ++u) {
        const int rid = row0 + rg * RPT + u;
        float dx = xi[u] - xj;
        float dy = yi[u] - yj;
        float dz = zi[u] - zj;
        dx = dx - Lx * floorf(dx * iLx + 0.5f);
        dy = dy - Ly * floorf(dy * iLy + 0.5f);
        dz = dz - Lz * floorf(dz * iLz + 0.5f);
        const float r2 = dx * dx + dy * dy + dz * dz;
        // (cid - rid + n) mod n for live ranks, without the division
        const int d = cid - rid;
        const int delta = d < 0 ? d + n : d;
        const bool m = (r2 < p.cutoff2) && (rid < n) && (cid < n) &&
                       (delta >= 1) && (delta <= p.w);
        const float r2s = fmaxf(r2, p.r2_floor);
        const float seed = rcp_approx(r2s);
        const float inv = p.approx != 0 ? seed : lj_newton2(r2s, seed);
        const float i2 = p.sigma2 * inv;
        const float i6 = i2 * i2 * i2;
        const float coef = m ? p.coef_scale * (2.0f * i6 * i6 - i6) * inv : 0.0f;
        const float tx = coef * dx, ty = coef * dy, tz = coef * dz;
        fx[u] += tx;
        fy[u] += ty;
        fz[u] += tz;
        cx_sum += tx;
        cy_sum += ty;
        cz_sum += tz;
        if constexpr (kEnergy) {
          const float inv_e = p.approx != 0 ? lj_newton2(r2s, seed) : inv;
          const float i2e = p.sigma2 * inv_e;
          const float i6e = i2e * i2e * i2e;
          kahan_add(ea, ec, m ? p.eps4 * (i6e * i6e - i6e) : 0.0f);
        }
      }
      red[(rg * 3 + 0) * tm + t] = cx_sum;
      red[(rg * 3 + 1) * tm + t] = cy_sum;
      red[(rg * 3 + 2) * tm + t] = cz_sum;
    }
    __syncthreads();
    store_col_partials(
        red, tm, p.R + (static_cast<size_t>(i) * p.n_band + k) * 3 * tm);
  }
  store_row_partials<RPT>(
      red, tm, fx, fy, fz, p.P + static_cast<size_t>(split) * 3 * n_pad + row0,
      n_pad);
  if constexpr (kEnergy)
    store_energy_partial(red, ea - ec, p.e_part + i * n_split + split);
}

__global__ void band_gather(Params p, int n_split, int n_parts) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p.n_pad) return;
  const int tm = p.tm, c = q / tm, t = q - c * tm;
  float f[3];
  sum_row_partials(p.P, n_split, p.n_pad, q, f);
  for (int k = 0; k < p.n_band; ++k) {
    const int i = (c - k + p.n_tiles) % p.n_tiles;
    const float* Rk = p.R + (static_cast<size_t>(i) * p.n_band + k) * 3 * tm;
    f[0] -= Rk[t];
    f[1] -= Rk[tm + t];
    f[2] -= Rk[2 * tm + t];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) p.F[a * p.n_pad + q] = f[a];
  if (p.energy != nullptr && q == 0)
    p.energy[0] = sum_energy_partials(p.e_part, n_parts);
}

template <int RPT>
cudaError_t launch_rows(const Params& p, int n_split, size_t smem,
                        cudaStream_t s) {
  const dim3 grid(p.n_tiles, n_split);
  return p.energy != nullptr
             ? launch_pass(band_rows<RPT, true>, grid, smem, s, p)
             : launch_pass(band_rows<RPT, false>, grid, smem, s, p);
}

}  // namespace

// x, F: (3, n_pad) f32; box: (3,) f32; P: (n_split, 3, n_pad) f32;
// R: (n_pad / tm * n_band, 3, tm) f32; e_part: (n_pad / tm * n_split,) f32;
// energy: (1,) f32 or null (then the force-only instantiation runs).  tm
// must be 64, 128 or 256 and divide n_pad.  approx sets the force's
// reciprocal; the energy's is always exact.
CHIRON_EXPORT int chiron_band_force(
    const float* x, const float* box, float* P, float* R, float* e_part,
    float* F, float* energy, int n, int n_pad, int tm, int w, int n_band,
    int n_split, float sigma2, float cutoff2, float r2_floor,
    float coef_scale, float eps4, int approx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_pad / tm;
  Params p{x, box, P, R, e_part, F, energy, n, n_pad, tm, w, n_tiles,
           n_band, sigma2, cutoff2, r2_floor, coef_scale, eps4, approx};
  const int red_floats = kRG * 3 * tm;  // kRG == kCG: rows fit the same
  const int floats = 3 * tm + (red_floats > kThreads ? red_floats : kThreads);
  const size_t smem = static_cast<size_t>(floats) * sizeof(float);
  cudaError_t err;
  switch (tm / kRG) {
    case 4: err = launch_rows<4>(p, n_split, smem, s); break;
    case 8: err = launch_rows<8>(p, n_split, smem, s); break;
    case 16: err = launch_rows<16>(p, n_split, smem, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kGather = 256;
  band_gather<<<(n_pad + kGather - 1) / kGather, kGather, 0, s>>>(
      p, n_split, n_tiles * n_split);
  return static_cast<int>(cudaGetLastError());
}
