// Culled LJ force over the tile-pair list (K4, and the force phase of K3).
//
// Replaces chiron_tpu/ops/lj_cull.py: _row_force_pass (:318), launched
// alone by culled_force_raw (pallas_call at :700) and once a step inside
// culled_md_raw (pallas_call at :984).  Semantics as there: sigma-prescaled
// coordinates; row and column x folded into the entry's frame through rowcx
// and ccx; y and z minimum image by trunc(2d/L); general entries
// [ptr2[2i], ptr2[2i+1]) take the col>row & col<n mask and the r^2 clamp,
// fast entries the cutoff mask alone; the factored (i6-1/2) i6 inv
// coefficient, scaled once by 48 eps / sigma.
//
// The TPU kernel subtracts each entry's column reaction straight from the
// force block, race-free only because its grid runs in order.  On Hopper
// the column sums are where a parallel force pass races, and float atomics
// would make the trajectory depend on the schedule.  Instead:
//   1. cull_rows: block (i, s) owns row tile i and walks the entries
//      g0+s, g0+s+S, ... of that tile in slot order.  A thread holds RPT
//      rows against every kCG-th column, so row sums stay in registers
//      across the entries; each entry's column partials are reduced over
//      the kRG row groups in a fixed order into R[k] (capacity x 3 x tn),
//      and the row sums over the kCG column groups into P[s].
//   2. cull_gather: each particle sums its row partials P[0..S) and then
//      subtracts R[k] for the entries k < count whose column tile is its
//      own, in slot order.
// Every sum has one order, so a repeated call is bitwise identical.
//
// Bound: pair arithmetic.  The function needs the distance test on each of
// the count x tm x tn listed pairs and the LJ term only on the few within
// the cutoff; this kernel runs without branches, so it takes the LJ term
// on every listed pair.  Splitting each row tile's entries over S blocks
// gives the grid nr x S blocks, enough to occupy the card at nr = 32.
// The energy instantiation accumulates (i6-1) i6 over the same pairs into
// one partial per block, summed in order by cull_gather, always with the
// exact reciprocal (two Newton steps on the rcp.approx seed, lj_newton2).
// With approx = 0 this is K5 (culled_force_energy_raw, pallas_call at
// :766); with approx = 1 it is K3's final_energy step (:845-870), whose
// force keeps the fast seed.  Both sum the same bits in the same order, so
// that step's energy equals a K5 pass on the same list bit for bit.
#include "common.cuh"

using namespace pair_pass;

namespace {

struct Params {
  const float* x;       // (3, n_pad) wrapped positions
  const float* box;     // (3,)
  const int* cols;      // (capacity,)
  const float* ccx;     // (capacity,)
  const int* ptr2;      // (2 nr + 1,)
  const float* rowcx;   // (nr,)
  const int* count;     // (1,)
  float* P;             // (S, 3, n_pad) row partials
  float* R;             // (capacity, 3, tn) column partials
  float* e_part;        // (nr * S,) energy partials
  float* F;             // (3, n_pad) output force
  float* energy;        // (1,) output energy, or null
  int n, n_pad, tm, tn;
  float inv_sigma, sigma_fold, cutoff2_s, eps_scale, e_scale;
  int approx;
};

// kEnergy instantiates the energy sum; the force-only pass carries none of
// its code (a runtime flag in the pair loop cost the force-only pass 7%).
template <int RPT, bool kEnergy>
__global__ void __launch_bounds__(kThreads) cull_rows(Params p) {
  extern __shared__ float smem[];
  const int tn = p.tn, tm = p.tm, n_pad = p.n_pad;
  float* sx = smem;
  float* sy = sx + tn;
  float* sz = sy + tn;
  float* red = sz + tn;  // [kRG][3][tn] columns, then [kCG][3][tm] rows
  const int i = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int tid = threadIdx.x, rg = tid / kCG, cg = tid % kCG;
  const int row0 = i * tm;
  const float Lx = p.box[0], Ly = p.box[1], Lz = p.box[2];
  const float iLx = 1.0f / Lx, iLy = 1.0f / Ly, iLz = 1.0f / Lz;
  const float inv_sigma = p.inv_sigma;
  const float Lys = Ly * inv_sigma, Lzs = Lz * inv_sigma;
  const float two_inv_Lys = (2.0f * iLy) * p.sigma_fold;
  const float two_inv_Lzs = (2.0f * iLz) * p.sigma_fold;
  const float rcx = p.rowcx[i];

  float xi[RPT], yi[RPT], zi[RPT], fx[RPT], fy[RPT], fz[RPT];
  int rid[RPT];
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int r = row0 + rg * RPT + u;
    rid[u] = r;
    const float x = p.x[r];
    xi[u] = (x - Lx * floorf((x - rcx) * iLx + 0.5f)) * inv_sigma;
    yi[u] = p.x[n_pad + r] * inv_sigma;
    zi[u] = p.x[2 * n_pad + r] * inv_sigma;
    fx[u] = fy[u] = fz[u] = 0.0f;
  }
  [[maybe_unused]] float ea = 0.0f;
  const int g0 = p.ptr2[2 * i], g1 = p.ptr2[2 * i + 1], g2 = p.ptr2[2 * i + 2];

  for (int k = g0 + split; k < g2; k += n_split) {
    const int col0 = p.cols[k] * tn;
    const float cx = p.ccx[k];
    const bool general = k < g1;
    __syncthreads();  // the previous entry's staging and partials are read
    for (int t = tid; t < tn; t += kThreads) {
      const float x = p.x[col0 + t];
      sx[t] = (x - Lx * floorf((x - cx) * iLx + 0.5f)) * inv_sigma;
      sy[t] = p.x[n_pad + col0 + t] * inv_sigma;
      sz[t] = p.x[2 * n_pad + col0 + t] * inv_sigma;
    }
    __syncthreads();
    for (int t = cg; t < tn; t += kCG) {
      const int cid = col0 + t;
      const float xj = sx[t], yj = sy[t], zj = sz[t];
      float cx_sum = 0.0f, cy_sum = 0.0f, cz_sum = 0.0f;
#pragma unroll
      for (int u = 0; u < RPT; ++u) {
        const float dx = xi[u] - xj;
        float dy = yi[u] - yj;
        dy = dy - Lys * truncf(dy * two_inv_Lys);
        float dz = zi[u] - zj;
        dz = dz - Lzs * truncf(dz * two_inv_Lzs);
        const float r2 = dx * dx + dy * dy + dz * dz;
        bool m = r2 < p.cutoff2_s;
        float r2s = r2;
        if (general) {
          m = m && (cid > rid[u]) && (cid < p.n);
          r2s = fmaxf(r2, 1e-4f);
        }
        const float seed = rcp_approx(r2s);
        const float inv = p.approx != 0 ? seed : lj_newton2(r2s, seed);
        const float i6 = inv * inv * inv;
        const float coef = m ? (i6 - 0.5f) * i6 * inv : 0.0f;
        const float tx = coef * dx, ty = coef * dy, tz = coef * dz;
        fx[u] += tx;
        fy[u] += ty;
        fz[u] += tz;
        cx_sum += tx;
        cy_sum += ty;
        cz_sum += tz;
        if constexpr (kEnergy) {
          const float inv_e = p.approx != 0 ? lj_newton2(r2s, seed) : inv;
          const float i6e = __fmul_rn(__fmul_rn(inv_e, inv_e), inv_e);
          // pinned rounding: K5 and the final_energy step sum equal bits
          ea = __fadd_rn(ea, m ? __fmul_rn(__fsub_rn(i6e, 1.0f), i6e) : 0.0f);
        }
      }
      red[(rg * 3 + 0) * tn + t] = cx_sum;
      red[(rg * 3 + 1) * tn + t] = cy_sum;
      red[(rg * 3 + 2) * tn + t] = cz_sum;
    }
    __syncthreads();
    store_col_partials(red, tn, p.R + static_cast<size_t>(k) * 3 * tn);
  }
  store_row_partials<RPT>(
      red, tm, fx, fy, fz, p.P + static_cast<size_t>(split) * 3 * n_pad + row0,
      n_pad);
  if constexpr (kEnergy)
    store_energy_partial(red, ea, p.e_part + i * n_split + split);
}

__global__ void cull_gather(Params p, int n_split, int n_parts) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p.n_pad) return;
  const int c = q / p.tn, t = q - c * p.tn;
  float f[3];
  sum_row_partials(p.P, n_split, p.n_pad, q, f);
  const int count = p.count[0];
  for (int k = 0; k < count; ++k) {
    if (p.cols[k] != c) continue;
    const float* Rk = p.R + static_cast<size_t>(k) * 3 * p.tn;
    f[0] -= Rk[t];
    f[1] -= Rk[p.tn + t];
    f[2] -= Rk[2 * p.tn + t];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) p.F[a * p.n_pad + q] = p.eps_scale * f[a];
  if (p.energy != nullptr && q == 0)
    p.energy[0] = p.e_scale * sum_energy_partials(p.e_part, n_parts);
}

template <int RPT>
cudaError_t launch_rows(const Params& p, int nr, int n_split, size_t smem,
                        cudaStream_t s) {
  const dim3 grid(nr, n_split);
  return p.energy != nullptr
             ? launch_pass(cull_rows<RPT, true>, grid, smem, s, p)
             : launch_pass(cull_rows<RPT, false>, grid, smem, s, p);
}

}  // namespace

// x, F: (3, n_pad) f32; box (3,) f32; cols, ccx: (capacity,); ptr2:
// (2 nr + 1,) i32; rowcx: (nr,) f32; count: (1,) i32; P: (n_split, 3, n_pad)
// f32; R: (capacity, 3, tn) f32; e_part: (nr * n_split,) f32; energy: (1,)
// f32 or null.  tm must be 16, 32, 64 or 128 and tn a multiple of 16.
// approx sets the force's reciprocal; the energy's is always exact.
CHIRON_EXPORT int chiron_cull_force(
    const float* x, const float* box, const int* cols, const float* ccx,
    const int* ptr2, const float* rowcx, const int* count, float* P, float* R,
    float* e_part, float* F, float* energy, int n, int n_pad, int tm, int tn,
    int n_split, float inv_sigma, float sigma_fold, float cutoff2_s,
    float eps_scale, float e_scale, int approx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{x, box, cols, ccx, ptr2, rowcx, count, P, R, e_part, F, energy,
           n, n_pad, tm, tn, inv_sigma, sigma_fold, cutoff2_s, eps_scale,
           e_scale, approx};
  const int nr = n_pad / tm;
  const int red_floats = (kRG * 3 * tn > kCG * 3 * tm) ? kRG * 3 * tn : kCG * 3 * tm;
  const int floats = 3 * tn + (red_floats > kThreads ? red_floats : kThreads);
  const size_t smem = static_cast<size_t>(floats) * sizeof(float);
  cudaError_t err;
  switch (tm / kRG) {
    case 1: err = launch_rows<1>(p, nr, n_split, smem, s); break;
    case 2: err = launch_rows<2>(p, nr, n_split, smem, s); break;
    case 4: err = launch_rows<4>(p, nr, n_split, smem, s); break;
    case 8: err = launch_rows<8>(p, nr, n_split, smem, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kGather = 256;
  cull_gather<<<(n_pad + kGather - 1) / kGather, kGather, 0, s>>>(
      p, n_split, nr * n_split);
  return static_cast<int>(cudaGetLastError());
}
