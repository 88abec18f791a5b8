// Culled LJ force over the tile-pair list (K4, the force phase of K3, K5).
//
// Replaces chiron_tpu/ops/lj_cull.py: _row_force_pass (:318), launched
// alone by culled_force_raw (pallas_call at :700), with the energy by
// culled_force_energy_raw (:766), and once a step inside culled_md_raw
// (:984).  Semantics as there: sigma-prescaled coordinates; row and column x
// folded into the entry's frame through rowcx and ccx; y and z minimum image
// by trunc(2d/L); general entries [ptr2[2i], ptr2[2i+1]) take the col>row &
// col<n mask and the r^2 clamp, fast entries the cutoff mask alone; the
// factored (i6-1/2) i6 inv coefficient, scaled once by 48 eps / sigma.
//
// The TPU kernel walks each row tile's entries in order and subtracts each
// entry's column reaction straight from the force block, race-free only
// because its grid runs in order.  On Hopper the work is cut so that it
// fills the card, and every partial sum goes to a slot of its own:
//   1. cull_pairs: one block of 128 threads per work item (entry k, column
//      slice s, row chunk c), the slices being the entry's column tile cut
//      into kSlice = 64 columns (S = ceil(tn / 64) of them) and the chunks
//      its row tile cut into C = tm / tr chunks of tr rows (tr = tm up to
//      256, else 256 where it divides tm, else 128: RPT = tr / 32 rows a
//      thread stay in registers whatever the tile).  The grid is capacity x
//      S x C; items past the device-side count exit at once, so the host
//      never reads the count, and no row tile's entry count sets the time:
//      at N=4000 the 143 entries give 572 blocks, four to five an SM.  A
//      block stages its slice's columns once, a thread holds RPT rows of the
//      chunk in registers against every KCG-th column of the slice, and the
//      block writes its row partials to rows [c tr, c tr + tr) of P[k S + s]
//      (3 x tm) and its column partials to R[k C + c] (3 x tn, the slice's
//      64 columns), each reduced over its thread groups in one fixed order
//      through shared memory.
//   2. cull_gather: one block per 128 particles.  A particle adds the row
//      partials of its row tile's items (contiguous in P, since the list is
//      ordered by row tile), then subtracts the column partials of the
//      entries whose column tile is its own, each entry's C chunks in
//      order: the block reads `cols` once, a round of 512 entries at a
//      time, compacts the entries of its column tiles in slot order into
//      shared memory, and each particle walks that short list, never the
//      whole list.
// Every sum has one order and no float atomics, so a repeated call is
// bitwise identical.
//
// K3's segment (culled_md_raw, :984, one pallas_call with a grid over the
// steps) is chiron_cull_md_segment: one host call that enqueues the whole
// segment on the caller's stream (cull_md_steps, shared with the megakernel
// segment of lj_mega.cu, as the TPU kernels share _baoab_phase and
// _row_force_pass): step 0's BAOAB phase alone (baoab.cu), then each step's
// cull_pairs and cull_gather, and the drift latch (drift.cu).  The gather's
// epilogue takes step k + 1's BAOAB update: a thread that has written its
// particle's force goes on to update that particle's x and w in place
// (baoab_lane, common.cuh, as baoab_phase does), with the JAX kernel's noise
// lane a (n_pad/2) + q mod n_pad/2, its cos branch below n_pad/2 and its sin
// branch above.  That is safe because nothing in the gather reads x, and
// the step's cull_pairs, which does, has finished before it on the stream;
// F needs no zeroing, since the next gather overwrites every lane.  The last
// step's gather, and with it the energy step, runs without the epilogue.
// So a segment of S steps is one host call and 2 S + 2 kernels, where the
// step-by-step sequence was 2 S + 1 host calls and 3 S + 1 kernels.
//
// Bound: pair arithmetic, the distance test on each of the count x tm x tn
// listed pairs and the LJ term on the few within the cutoff.  What the
// design does about the pairs it need not compute: each warp holds the
// bounding box of its rows (32 consecutive rows of the tile) against that
// of the slice (cull:: in common.cuh) and skips the slice where they are
// farther apart than the cutoff (in x alone, about a third of the listed
// pairs at N=4000); inside, the LJ term runs only where some lane has a pair
// within the cutoff (or a NaN distance, which must reach the sums as it did
// before), decided warp-uniformly with __any_sync.
//
// The pair arithmetic is written op by op with the _rn intrinsics, so that
// every instantiation rounds alike: the force of the energy instantiation
// equals the force-only pass's, and its energy, always taken with the exact
// reciprocal (two Newton steps on the rcp.approx seed, lj_newton2) and
// summed in pinned order, is the same whatever the force's reciprocal.  So
// K3's final_energy step (approximate force, with the energy) returns a K5
// pass's energy bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // threads a pair block
constexpr int kSlice = 64;     // columns a pair block takes from its entry
constexpr int kGather = 128;   // particles a gather block takes
using cull::kFull;

struct Params {
  const float* x;       // (3, n_pad) wrapped positions
  const float* box;     // (3,)
  const int* rows;      // (capacity,) row tile of each entry
  const int* cols;      // (capacity,)
  const float* ccx;     // (capacity,)
  const int* ptr2;      // (2 nr + 1,)
  const float* rowcx;   // (nr,)
  const int* count;     // (1,)
  float* P;             // (capacity S, 3, tm) row partials
  float* R;             // (capacity C, 3, tn) column partials
  float* e_part;        // (capacity S C,) energy partials
  float* F;             // (3, n_pad) output force
  float* energy;        // (1,) output energy, or null
  int n, n_pad, tm, tn, n_slices, n_chunks;
  float inv_sigma, sigma_fold, cutoff2_s, cull2_s, eps_scale, e_scale;
};

// x folded into the frame centered on cx and prescaled: the plain
// version's (x - Lx floor((x - cx) / Lx + 1/2)) / sigma, op by op.
__device__ __forceinline__ float fold_x(float x, float cx, float Lx, float iLx,
                                        float inv_sigma) {
  const float k = floorf(__fadd_rn(__fmul_rn(__fsub_rn(x, cx), iLx), 0.5f));
  return __fmul_rn(__fsub_rn(x, __fmul_rn(Lx, k)), inv_sigma);
}

// The y or z minimum image d - Ls trunc(2 d / Ls) of prescaled coordinates.
__device__ __forceinline__ float fold_yz(float d, float Ls, float two_inv_Ls) {
  return __fsub_rn(d, __fmul_rn(Ls, truncf(__fmul_rn(d, two_inv_Ls))));
}

// Per-block constants of the pair arithmetic.
struct Geometry {
  float Lys, Lzs, two_inv_Lys, two_inv_Lzs, cutoff2_s;
  int n;
};

// The thread's RPT rows against its columns t = cg + KCG q of the staged
// slice; the row sums stay in fx/fy/fz, each column's sum over the RPT rows
// goes to red[(rg 3 + a) kSlice + t].  kGeneral adds the col > row, col < n
// mask and the r^2 clamp.  skip (warp-uniform) writes zero column sums.
template <int RPT, int KRG, bool kEnergy, bool kApprox, bool kGeneral>
__device__ __forceinline__ void slice_pairs(
    const float4* __restrict__ sc, float* __restrict__ red, int width,
    int rg, int cg, int rid0, int cid0, bool skip, const Geometry& g,
    const float (&xi)[RPT], const float (&yi)[RPT], const float (&zi)[RPT],
    float (&fx)[RPT], float (&fy)[RPT], float (&fz)[RPT], float& ea) {
  constexpr int KCG = kThreads / KRG;
  for (int q = 0; q < width / KCG; ++q) {
    const int t = cg + KCG * q;
    float cxs = 0.0f, cys = 0.0f, czs = 0.0f;
    if (!skip) {
      const float4 c = sc[t];
      float dx[RPT], dy[RPT], dz[RPT], r2[RPT];
      bool m[RPT];
      bool any = false;
#pragma unroll
      for (int u = 0; u < RPT; ++u) {
        dx[u] = __fsub_rn(xi[u], c.x);
        dy[u] = fold_yz(__fsub_rn(yi[u], c.y), g.Lys, g.two_inv_Lys);
        dz[u] = fold_yz(__fsub_rn(zi[u], c.z), g.Lzs, g.two_inv_Lzs);
        r2[u] = __fmaf_rn(dz[u], dz[u],
                          __fmaf_rn(dy[u], dy[u], __fmul_rn(dx[u], dx[u])));
        m[u] = r2[u] < g.cutoff2_s;
        if constexpr (kGeneral) {
          const int cid = cid0 + t;
          m[u] = m[u] && cid > rid0 + u && cid < g.n;
        }
        any = any || m[u] || r2[u] != r2[u];
      }
      if (__any_sync(kFull, any)) {
#pragma unroll
        for (int u = 0; u < RPT; ++u) {
          const float r2s = kGeneral ? fmaxf(r2[u], 1e-4f) : r2[u];
          const float seed = rcp_approx(r2s);
          const float inv = kApprox ? seed : lj_newton2(r2s, seed);
          const float i6 = __fmul_rn(__fmul_rn(inv, inv), inv);
          const float coef =
              m[u] ? __fmul_rn(__fmul_rn(__fsub_rn(i6, 0.5f), i6), inv) : 0.0f;
          fx[u] = __fmaf_rn(coef, dx[u], fx[u]);
          fy[u] = __fmaf_rn(coef, dy[u], fy[u]);
          fz[u] = __fmaf_rn(coef, dz[u], fz[u]);
          cxs = __fmaf_rn(coef, dx[u], cxs);
          cys = __fmaf_rn(coef, dy[u], cys);
          czs = __fmaf_rn(coef, dz[u], czs);
          if constexpr (kEnergy) {
            const float inv_e = kApprox ? lj_newton2(r2s, seed) : inv;
            const float i6e = __fmul_rn(__fmul_rn(inv_e, inv_e), inv_e);
            ea = __fadd_rn(ea, m[u] ? __fmul_rn(__fsub_rn(i6e, 1.0f), i6e)
                                    : 0.0f);
          }
        }
      }
    }
    red[(rg * 3 + 0) * kSlice + t] = cxs;
    red[(rg * 3 + 1) * kSlice + t] = cys;
    red[(rg * 3 + 2) * kSlice + t] = czs;
  }
}

// A block of KRG row groups x KCG column groups, RPT rows a row group
// (a chunk of TR = KRG RPT rows of the row tile); thread tid is row group
// tid / KCG, so a warp holds 32 / KCG row groups: 32 RPT / KCG consecutive
// rows.
template <int RPT, int KRG, bool kEnergy, bool kApprox>
__global__ void __launch_bounds__(kThreads) cull_pairs(Params p) {
  constexpr int KCG = kThreads / KRG;
  constexpr int TR = KRG * RPT;
  static_assert(KCG * RPT <= kSlice, "row partials must fit the buffer");
  __shared__ float4 sc[kSlice];
  __shared__ float red[KRG * 3 * kSlice];
  __shared__ float sbox[7];
  __shared__ float scratch[kThreads / 32];
  const int item = blockIdx.x / p.n_chunks;
  const int chunk = blockIdx.x - item * p.n_chunks;
  const int k = item / p.n_slices;  // < capacity: the list's arrays hold it
  const int s = item - k * p.n_slices;
  // issued together, before the count decides: one load latency, not four
  const int count = p.count[0];
  const int i = p.rows[k];
  const int col_tile = p.cols[k];
  const float cx = p.ccx[k];
  if (k >= count) return;
  const int tid = threadIdx.x;
  const int rg = tid / KCG, cg = tid - rg * KCG;
  const int tm = p.tm, tn = p.tn, n_pad = p.n_pad;
  const bool general = k < p.ptr2[2 * i + 1];
  const int row0 = i * tm + chunk * TR;
  const int c0 = s * kSlice;
  const int width = min(kSlice, tn - c0);
  const int col0 = col_tile * tn + c0;
  const float Lx = p.box[0], Ly = p.box[1], Lz = p.box[2];
  const float iLx = 1.0f / Lx, iLy = 1.0f / Ly, iLz = 1.0f / Lz;
  const float inv_sigma = p.inv_sigma;
  Geometry g;
  g.Lys = Ly * inv_sigma;
  g.Lzs = Lz * inv_sigma;
  g.two_inv_Lys = (2.0f * iLy) * p.sigma_fold;
  g.two_inv_Lzs = (2.0f * iLz) * p.sigma_fold;
  g.cutoff2_s = p.cutoff2_s;
  g.n = p.n;
  // x is open (folded into the entry's frame), y and z periodic
  const float per[3] = {0.0f, g.Lys, g.Lzs};
  const float iper[3] = {0.0f, iLy * p.sigma_fold, iLz * p.sigma_fold};

  // the first warp stages the slice (two columns a lane) and boxes it
  if (tid < 32) {
    float px[2], py[2], pz[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = tid + 32 * h;
      const int col = col0 + min(t, width - 1);
      px[h] = fold_x(p.x[col], cx, Lx, iLx, inv_sigma);
      py[h] = __fmul_rn(p.x[n_pad + col], inv_sigma);
      pz[h] = __fmul_rn(p.x[2 * n_pad + col], inv_sigma);
      if (t < width) sc[t] = make_float4(px[h], py[h], pz[h], 0.0f);
    }
    cull::BoxAcc acc(__shfl_sync(kFull, px[0], 0), __shfl_sync(kFull, py[0], 0),
                     __shfl_sync(kFull, pz[0], 0));
    acc.add(px[0], py[0], pz[0], per, iper);
    acc.add(px[1], py[1], pz[1], per, iper);
    const cull::Box b = acc.reduce();
    if (tid == 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        sbox[a] = b.c[a];
        sbox[3 + a] = b.h[a];
      }
      sbox[6] = b.finite ? 1.0f : 0.0f;
    }
  }

  float xi[RPT], yi[RPT], zi[RPT], fx[RPT], fy[RPT], fz[RPT];
  const float rcx = p.rowcx[i];
  const int rid0 = row0 + rg * RPT;
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int r = rid0 + u;
    xi[u] = fold_x(p.x[r], rcx, Lx, iLx, inv_sigma);
    yi[u] = __fmul_rn(p.x[n_pad + r], inv_sigma);
    zi[u] = __fmul_rn(p.x[2 * n_pad + r], inv_sigma);
    fx[u] = fy[u] = fz[u] = 0.0f;
  }
  cull::BoxAcc racc(__shfl_sync(kFull, xi[0], 0), __shfl_sync(kFull, yi[0], 0),
                    __shfl_sync(kFull, zi[0], 0));
#pragma unroll
  for (int u = 0; u < RPT; ++u) racc.add(xi[u], yi[u], zi[u], per, iper);
  const cull::Box rbox = racc.reduce();
  __syncthreads();  // the slice and its box are staged
  cull::Box cbox;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    cbox.c[a] = sbox[a];
    cbox.h[a] = sbox[3 + a];
  }
  cbox.finite = sbox[6] != 0.0f;
  const bool skip = cull::apart(rbox, cbox, per, iper, p.cull2_s);

  [[maybe_unused]] float ea = 0.0f;
  if (general) {
    slice_pairs<RPT, KRG, kEnergy, kApprox, true>(
        sc, red, width, rg, cg, rid0, col0, skip, g, xi, yi, zi, fx, fy, fz,
        ea);
  } else {
    slice_pairs<RPT, KRG, kEnergy, kApprox, false>(
        sc, red, width, rg, cg, rid0, col0, skip, g, xi, yi, zi, fx, fy, fz,
        ea);
  }
  __syncthreads();
  // the slice's column sums over the row groups, in order
  float* Rk =
      p.R + static_cast<size_t>(k * p.n_chunks + chunk) * 3 * tn + c0;
  for (int idx = tid; idx < 3 * width; idx += kThreads) {
    const int a = idx / width, t = idx - a * width;
    float sum = 0.0f;
    for (int r = 0; r < KRG; ++r) sum += red[(r * 3 + a) * kSlice + t];
    Rk[a * tn + t] = sum;
  }
  __syncthreads();
  // the chunk's rows' sums over the column groups, in order
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int r = rg * RPT + u;
    red[(cg * 3 + 0) * TR + r] = fx[u];
    red[(cg * 3 + 1) * TR + r] = fy[u];
    red[(cg * 3 + 2) * TR + r] = fz[u];
  }
  __syncthreads();
  float* Pk = p.P + static_cast<size_t>(item) * 3 * tm + chunk * TR;
  for (int idx = tid; idx < 3 * TR; idx += kThreads) {
    const int a = idx / TR, r = idx - a * TR;
    float sum = 0.0f;
    for (int c = 0; c < KCG; ++c) sum += red[(c * 3 + a) * TR + r];
    Pk[a * tm + r] = sum;
  }
  if constexpr (kEnergy) {
    const float e = cull::block_sum<kThreads>(ea, scratch, tid);
    if (tid == 0) p.e_part[blockIdx.x] = e;
  }
}

// The gather's chains of dependent loads are its cost at N=4000, so it
// issues the loads of kBatch slots before it adds them, in slot order.
constexpr int kBatch = 4;
constexpr int kScan = kBatch * kGather;  // list entries scanned a round

// The epilogue's BAOAB update of step s (kBaoab); x is the pair pass's
// input, written here only after that pass has run.
struct Step {
  float* x;
  float* w;
  const float* minv;
  const float* sigv;
  const int* step_offset;
  uint32_t seed;
  int s;
  float dt, half_dt, a, b;
};

template <bool kBaoab>
__global__ void __launch_bounds__(kGather) cull_gather(Params p, Step st) {
  __shared__ int hit_k[kScan];
  __shared__ int hit_c[kScan];
  __shared__ int wsum[kGather / 32];
  __shared__ float scratch[kGather / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tm = p.tm, tn = p.tn, n_pad = p.n_pad, S = p.n_slices;
  const int C = p.n_chunks;
  const float* __restrict__ P = p.P;
  const float* __restrict__ R = p.R;
  const int q0 = blockIdx.x * kGather;
  const int q = min(q0 + tid, n_pad - 1);
  const int i = q / tm, r = q - i * tm;
  const int c = q / tn, t = q - c * tn;
  const int count = p.count[0];
  float f[3] = {0.0f, 0.0f, 0.0f};
  // the row partials of the row tile's items, in slot order
  const int j1 = p.ptr2[2 * i + 2] * S;
  int j = p.ptr2[2 * i] * S;
  for (; j + kBatch <= j1; j += kBatch) {
    float v[kBatch][3];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const float* Pj = P + static_cast<size_t>(j + u) * 3 * tm + r;
      v[u][0] = Pj[0];
      v[u][1] = Pj[tm];
      v[u][2] = Pj[2 * tm];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      f[0] += v[u][0];
      f[1] += v[u][1];
      f[2] += v[u][2];
    }
  }
  for (; j < j1; ++j) {
    const float* Pj = P + static_cast<size_t>(j) * 3 * tm + r;
    f[0] += Pj[0];
    f[1] += Pj[tm];
    f[2] += Pj[2 * tm];
  }
  // the column partials of the entries on this block's column tiles, in
  // slot order: each round, a thread tests kBatch consecutive entries, and
  // a block scan places the hits in slot order
  const int c_lo = q0 / tn;
  const int c_hi = (min(q0 + kGather, n_pad) - 1) / tn;
  for (int base = 0; base < count; base += kScan) {
    const int k0 = base + kBatch * tid;
    int ck[kBatch];
    int mine = 0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      ck[u] = k0 + u < count ? p.cols[k0 + u] : -1;
      mine += ck[u] >= c_lo && ck[u] <= c_hi;
    }
    int incl = mine;  // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += up;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int at = incl - mine, total = 0;
#pragma unroll
    for (int w = 0; w < kGather / 32; ++w) {
      at += w < warp ? wsum[w] : 0;
      total += wsum[w];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (ck[u] >= c_lo && ck[u] <= c_hi) {
        hit_k[at] = k0 + u;
        hit_c[at] = ck[u];
        ++at;
      }
    }
    __syncthreads();
    // the hits' chunks in order: item h is chunk h mod C of hit h / C
    const int n_items = total * C;
    int h = 0;
    for (; h + kBatch <= n_items; h += kBatch) {
      float v[kBatch][3];
      bool own[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int hit = (h + u) / C, ch = h + u - hit * C;
        own[u] = hit_c[hit] == c;
        const float* Rk =
            R + static_cast<size_t>(hit_k[hit] * C + ch) * 3 * tn + t;
#pragma unroll
        for (int a = 0; a < 3; ++a) v[u][a] = own[u] ? Rk[a * tn] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (!own[u]) continue;
#pragma unroll
        for (int a = 0; a < 3; ++a) f[a] -= v[u][a];
      }
    }
    for (; h < n_items; ++h) {
      const int hit = h / C, ch = h - hit * C;
      if (hit_c[hit] != c) continue;
      const float* Rk =
          R + static_cast<size_t>(hit_k[hit] * C + ch) * 3 * tn + t;
      f[0] -= Rk[0];
      f[1] -= Rk[tn];
      f[2] -= Rk[2 * tn];
    }
    __syncthreads();
  }
  if (q0 + tid < n_pad) {
    float Fq[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      Fq[a] = __fmul_rn(p.eps_scale, f[a]);
      p.F[a * n_pad + q] = Fq[a];
    }
    if constexpr (kBaoab) {
      const int half = n_pad / 2;
      // warp-uniform where half is a multiple of 32, as the runners pad it
      const bool second = q >= half;
      const uint32_t col = static_cast<uint32_t>(second ? q - half : q);
      const uint32_t step = static_cast<uint32_t>(st.s) +
                            static_cast<uint32_t>(st.step_offset[0]);
      const float minv = st.minv[q], sigv = st.sigv[q];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float r, theta;
        box_muller(st.seed, step, static_cast<uint32_t>(a * half) + col, r,
                   theta);
        const float noise = __fmul_rn(r, second ? sinf(theta) : cosf(theta));
        const float L = p.box[a];
        const int j = a * n_pad + q;
        float xx = st.x[j], v = st.w[j];
        baoab_lane(xx, v, Fq[a], minv, sigv, noise, L, __fdiv_rn(1.0f, L),
                   st.dt, st.half_dt, st.a, st.b);
        st.x[j] = xx;
        st.w[j] = v;
      }
    }
  }
  if (p.energy != nullptr && blockIdx.x == 0) {
    const int n_parts = count * S * C;
    float acc = 0.0f, comp = 0.0f;
    for (int j = tid; j < n_parts; j += kGather)
      kahan_add(acc, comp, p.e_part[j]);
    const float e = cull::block_sum<kGather>(acc - comp, scratch, tid);
    if (tid == 0) p.energy[0] = p.e_scale * e;
  }
}

template <int RPT, int KRG>
cudaError_t launch_pairs_at(const Params& p, int blocks, bool approx,
                            cudaStream_t s) {
  if (p.energy != nullptr) {
    if (approx) {
      cull_pairs<RPT, KRG, true, true><<<blocks, kThreads, 0, s>>>(p);
    } else {
      cull_pairs<RPT, KRG, true, false><<<blocks, kThreads, 0, s>>>(p);
    }
  } else if (approx) {
    cull_pairs<RPT, KRG, false, true><<<blocks, kThreads, 0, s>>>(p);
  } else {
    cull_pairs<RPT, KRG, false, false><<<blocks, kThreads, 0, s>>>(p);
  }
  return cudaGetLastError();
}

// The pair pass over chunks of tr rows (16, 32, 64, 128 or 256).
cudaError_t launch_pairs(const Params& p, int blocks, bool approx,
                         cudaStream_t s) {
  switch (row_chunk(p.tm)) {
    case 16: return launch_pairs_at<1, 16>(p, blocks, approx, s);
    case 32: return launch_pairs_at<1, 32>(p, blocks, approx, s);
    case 64: return launch_pairs_at<2, 32>(p, blocks, approx, s);
    case 128: return launch_pairs_at<4, 32>(p, blocks, approx, s);
    case 256: return launch_pairs_at<8, 32>(p, blocks, approx, s);
    default: return cudaErrorInvalidValue;
  }
}

// tm 16, 32, 64 or a multiple of 128; tn a multiple of 16.
bool tiles_ok(int tm, int tn, int capacity) {
  return capacity >= 1 && tn > 0 && tn % 16 == 0 &&
         (tm == 16 || tm == 32 || tm == 64 || (tm > 0 && tm % 128 == 0));
}

int gather_blocks(int n_pad) { return (n_pad + kGather - 1) / kGather; }

}  // namespace

// Enqueues step 0's BAOAB phase and n_steps culled force passes (lj_cull.py's
// segment_launches lists them for the launch counts).
cudaError_t cull_md_steps(const CullMD& m, cudaStream_t s) {
  if (m.n_steps < 1 || m.n_pad % 2 != 0 ||
      !tiles_ok(m.tm, m.tn, m.capacity)) {
    return cudaErrorInvalidValue;
  }
  int rc = chiron_baoab(m.x, m.w, m.F, m.minv, m.sigv, m.box, m.step_offset,
                        0, m.seed, m.n_pad, m.dt, m.half_dt, m.a, m.b, s);
  if (rc != 0) return static_cast<cudaError_t>(rc);
  const int n_slices = (m.tn + kSlice - 1) / kSlice;
  const int n_chunks = m.tm / row_chunk(m.tm);
  Params p{m.x, m.box, m.rows, m.cols, m.ccx, m.ptr2, m.rowcx, m.count, m.P,
           m.R, m.e_part, m.F, nullptr, m.n, m.n_pad, m.tm, m.tn, n_slices,
           n_chunks, m.inv_sigma, m.sigma_fold, m.cutoff2_s,
           m.cutoff2_s * cull::kRaise, m.eps_scale, m.e_scale};
  Step st{m.x, m.w, m.minv, m.sigv, m.step_offset, m.seed, 0,
          m.dt, m.half_dt, m.a, m.b};
  const int blocks = m.capacity * n_slices * n_chunks;
  for (int k = 0; k < m.n_steps; ++k) {
    const bool last = k == m.n_steps - 1;
    p.energy = last ? m.energy : nullptr;
    cudaError_t err = launch_pairs(p, blocks, m.approx != 0, s);
    if (err != cudaSuccess) return err;
    if (last) {
      cull_gather<false><<<gather_blocks(m.n_pad), kGather, 0, s>>>(p, st);
    } else {
      st.s = k + 1;
      cull_gather<true><<<gather_blocks(m.n_pad), kGather, 0, s>>>(p, st);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// x, F: (3, n_pad) f32; box (3,) f32; rows, cols, ccx: (capacity,); ptr2:
// (2 nr + 1,) i32; rowcx: (nr,) f32; count: (1,) i32; with S = ceil(tn /
// 64) and C = tm / row_chunk(tm): P: (capacity S, 3, tm) f32; R: (capacity
// C, 3, tn) f32; e_part: (capacity S C,) f32; energy: (1,) f32 or null.  tm
// must be 16, 32, 64 or a multiple of 128 and tn a multiple of 16.  approx
// sets the force's reciprocal; the energy's is always exact.
CHIRON_EXPORT int chiron_cull_force(
    const float* x, const float* box, const int* rows, const int* cols,
    const float* ccx, const int* ptr2, const float* rowcx, const int* count,
    float* P, float* R, float* e_part, float* F, float* energy, int n,
    int n_pad, int tm, int tn, int capacity, float inv_sigma,
    float sigma_fold, float cutoff2_s, float eps_scale, float e_scale,
    int approx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!tiles_ok(tm, tn, capacity)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_slices = (tn + kSlice - 1) / kSlice;
  const int n_chunks = tm / row_chunk(tm);
  const Params p{x, box, rows, cols, ccx, ptr2, rowcx, count, P, R, e_part,
                 F, energy, n, n_pad, tm, tn, n_slices, n_chunks, inv_sigma,
                 sigma_fold, cutoff2_s, cutoff2_s * cull::kRaise, eps_scale,
                 e_scale};
  const cudaError_t err =
      launch_pairs(p, capacity * n_slices * n_chunks, approx != 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  cull_gather<false><<<gather_blocks(n_pad), kGather, 0, s>>>(p, Step{});
  return static_cast<int>(cudaGetLastError());
}

// One culled MD segment of n_steps >= 1 on a fixed list (K3): copies x_in
// and F_in into x and F, takes w in place (the velocity before the trailing
// half-kick), runs cull_md_steps and, where flag is not null, the drift
// latch of the final x against anchor with the device-side threshold (the
// engine's slack, or the NpT runner's remaining budget).  The list and the
// pass's scratch (P, R, e_part) are as chiron_cull_force takes them;
// latch_part and ticket as drift_latch takes them; energy: (1,) f32, the
// last step's exact energy, or null.  x, w, F: (3, n_pad) f32, none
// aliasing x_in, F_in or anchor; n_pad even.
CHIRON_EXPORT int chiron_cull_md_segment(
    const float* x_in, const float* F_in, float* x, float* w, float* F,
    const float* minv, const float* sigv, const float* box,
    const int* step_offset, uint32_t seed, int n_steps, const int* rows,
    const int* cols, const float* ccx, const int* ptr2, const float* rowcx,
    const int* count, float* P, float* R, float* e_part, float* energy,
    const float* anchor, const float* threshold, int* latch_part,
    unsigned* ticket, bool* flag, int n, int n_pad, int tm, int tn,
    int capacity, float dt, float half_dt, float a, float b, float inv_sigma,
    float sigma_fold, float cutoff2_s, float eps_scale, float e_scale,
    int approx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = sizeof(float) * 3 * static_cast<size_t>(n_pad);
  cudaError_t err =
      cudaMemcpyAsync(x, x_in, bytes, cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess) {
    err = cudaMemcpyAsync(F, F_in, bytes, cudaMemcpyDeviceToDevice, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const CullMD m{x, w, F, minv, sigv, box, step_offset, seed, n_steps, rows,
                 cols, ccx, ptr2, rowcx, count, P, R, e_part, energy, n,
                 n_pad, tm, tn, capacity, dt, half_dt, a, b, inv_sigma,
                 sigma_fold, cutoff2_s, eps_scale, e_scale, approx};
  err = cull_md_steps(m, s);
  if (err == cudaSuccess && flag != nullptr) {
    err = drift_latch(x, anchor, box, n, n_pad, threshold, latch_part, ticket,
                      flag, s);
  }
  return static_cast<int>(err);
}
