// Halo-strip LJ MD: a step's BAOAB phase with the halo refresh, and the
// strip force pass with the halo fold (K7).
//
// Replaces chiron_tpu/ops/lj_strip.py: _make_strip_md_kernel (:184) via
// strip_md_raw (pallas_call at :308), strip_force_raw (:477) and
// strip_force_energy_raw (:526), all on _strip_force_pass (:69).  The TPU
// kernel runs S whole steps in one call; here a step is a sequence of
// launches on one stream: chiron_strip_baoab, then chiron_strip_force; and
// chiron_strip_wrap once at the segment's end, on the x row.
//
// x is continuous between sorts.  The halo carries the x image of the order
// the sort left, so the pass takes x with no minimum image; a particle that
// crossed x = 0 or x = L and was wrapped at once would keep its rank at the
// other end of the box and meet none of its partners until the next sort
// (the TPU kernel wraps every step and loses those pairs).  So the steps do
// not wrap x, and strip_wrap wraps it once the segment's last force is
// taken, and again before a sort for a carry from elsewhere.
//
// strip_baoab, per lane (axis, col) of (3, n_pad), in the half-kick
// convention w = v - dt/2 F/m (:209-265):
//   v = w + dt F minv; x += dt/2 v; v = a v + b sigv noise; x += dt/2 v;
//   live lanes' (col < n) y and z wrapped by x - floor(x / L) L (the pass
//   takes their minimum image either way), x left unwrapped, padding left at
//   its 1e18 sentinel; and a lane with col < H also writes its halo copy at
//   n_pad + col, shifted by +Lx on x.  The noise is the JAX stream bit for
//   bit: counters 2 lane and 2 lane + 1 with lane = axis n_pad + col, times
//   0x9E3779B9, plus seed 0x9E3779B9 + step 0x85EBCA6B; the splitmix32
//   finaliser, (mix >> 8) 2^-24, and the cos branch of Box-Muller only.
//   Bound: memory (7 floats read, 2 written a lane, plus the halo).
//
// strip_wrap, in place (the segment's end): per live lane of the x row, x
// wrapped by x - floor(x / L) L, one rounding an op, as the plain version,
// and a lane with col < H rewrites its halo copy as x + Lx; y, z, their
// halo and the padding are left as they are (the steps keep them so).
// Bound: memory (n floats read, n + H written).
//
// strip_wrap_copy, per lane (axis, col) of (3, n_pad), from src into dst
// (a new array, or src itself): the live x wrapped as above; y, z and the
// padding copied, or the padding set to the 1e18 sentinel; the halo
// (col < H) rewritten as the shifted center.  Bound: memory (one float read
// and one written a lane, plus the halo).
//
// strip_pairs: the function of the TPU pass.  Row tile i (rows i tm ..
// i tm + tm) meets the extended columns [i tm, i tm + tm + H), except the
// leading tile's col <= row slots; x takes no minimum image (the halo
// carries it), y and z take floor(d/L + 1/2); only pairs within the cutoff
// add a term, r^2 clamped at r2_floor; the energy counts a pair only where
// r^2 > 0 (padding against padding has r^2 == 0 exactly); the reaction on an
// extended column n_pad + q folds onto rank q.  The TPU kernel writes the
// column reactions into the extended force in grid order.  Here each
// particle q owns its sum and meets every pair it is in from its own side,
// so there are no reactions, no partials and no gather launch:
//   * as a row, its forward strip: ranks (q, ts + tm + H), ts = q - q mod tm,
//     the extended columns past n_pad being the halo copies;
//   * as a column, the rows of the tiles whose strip covers it, those whose
//     first rank lies past q - tm - H: ranks [lo, q) with lo = tm floor((q -
//     H) / tm), which is ts - H where tm divides H, and where a rank j < 0
//     is row n_pad + j against q's halo copy (x + Lx, the column n_pad + q
//     of the TPU pass).
// So its candidates are the ranks [lo, ts + tm + H) but q, and every
// pair term is coef(r^2) (p_q - p_j) with the lane's own point first (its
// halo copy for j < 0): a pair is taken from its two ends with r^2 of the
// same bits, since RN(a - b) = -RN(b - a) and the y and z images are odd
// but where |d| is half a box, beyond the cutoff.  Each particle's sum has
// one order, so a repeated call is bitwise identical.
//
// Bound: pair arithmetic (about 17 f32 operations a distance test on the
// n_pad (tm + H) slots less the leading triangles, the LJ term on the pairs
// within the cutoff), not memory: xe (3 x (n_pad + H) floats) stays in L2.
// Visiting each pair from both sides doubles the distance tests; in return
// the pass needs no column partials, no block barrier a chunk and no second
// launch.  For this card:
//   * occupancy: a block is 32 particles (one a lane) x 32 warps, the warps
//     splitting the particles' candidate ranks in chunks of 32 (warp g the
//     chunks g, g + 32, ...), so N = 4000 gives 128 blocks of 32 warps;
//   * culling: the layout is x-sorted, so a chunk's x range is narrow; a
//     chunk whose every pair is at least the cutoff apart in x alone
//     (band::x_apart: with no x image and r^2 = fma(dz, dz, fma(dx, dx,
//     dy dy)), r^2 >= RN(dx dx) >= cutoff^2) is skipped whole, unless some
//     coordinate of the chunk or of the lanes' points is not finite;
//   * distances first: each lane takes a chunk's 32 columns (broadcast from
//     shared memory, each warp staging its own chunk, loaded during the one
//     before) into a bit a column where r^2 < cutoff^2 or r^2 is NaN, and
//     the rank tests only on chunks at a lane's range edges or holding its
//     own rank; then the LJ term only on the set bits (__ffs), a loop as
//     long as the warp's largest count, a few a chunk where under 3% of the
//     candidates lie within the cutoff.
// A NaN distance takes the term (its r^2 clamp keeps the NaN), so a NaN
// reaches every component of both ends of every slot it lies in, as in the
// plain version.  The approximate reciprocal is the hardware seed, the
// exact one the seed with two Newton steps; the energy instantiation takes
// the exact one.  The energy: a compensated sum a lane, the block's lanes
// folded in a fixed order into e_part, then one block sums e_part in a fixed
// order, halved (each pair was met twice).
#include "common.cuh"

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
  if (col < n && axis != 0) {
    const float L = box[axis];
    x = x - floorf(x / L) * L;
  }
  xe[axis * n_ext + col] = x;
  w[lane] = v;
  if (col < H) xe[axis * n_ext + n_pad + col] = axis == 0 ? x + box[0] : x;
}

constexpr float kPadX = 1.0e18f;  // the padding sentinel (lj_strip.py _PAD_X)

__device__ __forceinline__ float wrap_x(float x, float L) {
  return __fsub_rn(x, __fmul_rn(floorf(__fdiv_rn(x, L)), L));
}

// xe: (3, n_pad + H), in place; only the live x lanes and their halo.
__global__ void strip_wrap(float* __restrict__ xe,
                           const float* __restrict__ box, int n, int n_pad,
                           int H) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const float x = wrap_x(xe[col], box[0]);
  xe[col] = x;
  if (col < H) xe[n_pad + col] = __fadd_rn(x, box[0]);
}

// src: (3, src_ext), dst: (3, n_pad + H); both may be one array.
__global__ void strip_wrap_copy(const float* src, int src_ext, float* dst,
                                const float* __restrict__ box, int n,
                                int n_pad, int H, bool pad) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;  // over (3, n_pad)
  if (lane >= 3 * n_pad) return;
  const int axis = lane / n_pad;
  const int col = lane - axis * n_pad;
  const int dst_ext = n_pad + H;
  float x = src[axis * src_ext + col];
  if (col >= n) {
    if (pad) x = kPadX;
  } else if (axis == 0) {
    x = wrap_x(x, box[0]);
  }
  dst[axis * dst_ext + col] = x;
  if (col < H)
    dst[axis * dst_ext + n_pad + col] = axis == 0 ? __fadd_rn(x, box[0]) : x;
}

constexpr int kLanes = 32;  // particles per block: one a lane
constexpr int kWarps = 32;  // warps per block, each a column group
constexpr int kChunk = 32;  // candidate ranks a warp takes at a time
using band::kFull;

struct Strip {
  const float* xe;   // (3, n_pad + H) extended positions
  const float* box;  // (3,)
  float* F;          // (3, n_pad) output force
  float* e_part;     // (n_pad / 32,) energy partials, or null
  int n_pad, tm, H;
  float sigma2, cutoff2, r2_floor, coef_scale;
};

// The periods of y and z and their inverses.
struct YZ {
  float Ly, Lz, iLy, iLz;
};

// The lane's point minus column c, y and z min-imaged by floor(d/L + 1/2),
// one rounding an op; returns r^2 = fma(dz, dz, fma(dx, dx, dy dy)).
__device__ __forceinline__ float strip_delta(float x, float y, float z,
                                             const float4& c, const YZ& b,
                                             float& dx, float& dy, float& dz) {
  dx = __fsub_rn(x, c.x);
  dy = __fsub_rn(y, c.y);
  dz = __fsub_rn(z, c.z);
  dy = __fmaf_rn(-b.Ly, floorf(__fmaf_rn(dy, b.iLy, 0.5f)), dy);
  dz = __fmaf_rn(-b.Lz, floorf(__fmaf_rn(dz, b.iLz, 0.5f)), dz);
  return band::norm2(dx, dy, dz);
}

// One chunk of 32 candidate ranks from c0 against the lane's point:
// the distances into a bit a rank, then the LJ term on the set bits.
// kEdge also tests each rank against the lane's range [lo, hi) and rank q.
template <bool kApprox, bool kEnergy, bool kEdge>
__device__ __forceinline__ void strip_chunk(const float4* cols, int c0, int q,
                                            int lo, int hi, float x, float y,
                                            float z, const YZ& b,
                                            const Strip& p, float& fx,
                                            float& fy, float& fz, float& e,
                                            float& ec) {
  unsigned mask = 0u;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    float dx, dy, dz;
    const float r2 = strip_delta(x, y, z, cols[k], b, dx, dy, dz);
    bool hit = !(r2 >= p.cutoff2);  // within the cutoff, or NaN
    if constexpr (kEdge) {
      const int j = c0 + k;
      hit = hit && j >= lo && j < hi && j != q;
    }
    mask |= static_cast<unsigned>(hit) << k;
  }
  while (mask != 0u) {
    const int k = __ffs(mask) - 1;
    mask &= mask - 1u;
    float dx, dy, dz;
    const float r2 = strip_delta(x, y, z, cols[k], b, dx, dy, dz);
    const float r2s = r2 < p.r2_floor ? p.r2_floor : r2;  // keeps a NaN
    const float inv = lj_recip(r2s, kApprox);
    const float i2 = __fmul_rn(p.sigma2, inv);
    const float i6 = __fmul_rn(i2, __fmul_rn(i2, i2));
    const float i12 = __fmul_rn(i6, i6);
    const float coef = __fmul_rn(__fsub_rn(__fmul_rn(2.0f, i12), i6), inv);
    fx = __fmaf_rn(coef, dx, fx);
    fy = __fmaf_rn(coef, dy, fy);
    fz = __fmaf_rn(coef, dz, fz);
    if constexpr (kEnergy) {
      if (r2 > 0.0f) kahan_add(e, ec, __fsub_rn(i12, i6));
    }
  }
}

// A warp's x range (as order keys) and whether every point is finite.
__device__ __forceinline__ void warp_x_range(float x, float y, float z,
                                             float& lo, float& hi,
                                             bool& finite) {
  finite = __all_sync(kFull, isfinite(x) && isfinite(y) && isfinite(z));
  lo = band::key_value(__reduce_min_sync(kFull, band::order_key(x)));
  hi = band::key_value(__reduce_max_sync(kFull, band::order_key(x)));
}

template <bool kApprox, bool kEnergy>
__global__ void __launch_bounds__(kLanes * kWarps, 1)
strip_pairs(Strip p) {
  __shared__ float4 stage[kWarps][kChunk];
  __shared__ float red[kWarps][4][kLanes];
  const int lane = threadIdx.x, g = threadIdx.y;
  const int n_pad = p.n_pad, H = p.H, n_ext = n_pad + H;
  const int q = blockIdx.x * kLanes + lane;
  const float* xe = p.xe;
  const YZ b{p.box[1], p.box[2], __fdiv_rn(1.0f, p.box[1]),
             __fdiv_rn(1.0f, p.box[2])};
  // the lane's point, and its halo copy where it has one (q < H)
  const float xq = xe[q], yq = xe[n_ext + q], zq = xe[2 * n_ext + q];
  const float xh = q < H ? xe[n_pad + q] : xq;
  const int ts = q - q % p.tm;
  // the lane's ranks, q aside: lo = tm floor((q - H) / tm), q - H >= -H >
  // -n_pad
  const int lo = ((q - H + n_pad) / p.tm) * p.tm - n_pad;
  const int hi = ts + p.tm + H;
  // the warp's ranks in chunks aligned to multiples of 32: a chunk is all
  // below 0 (rows n_pad + j against the halo copies) or all at or above
  const int base = __shfl_sync(kFull, lo, 0) & ~(kChunk - 1);
  const int n_chunks = (__shfl_sync(kFull, hi, kLanes - 1) - base +
                        kChunk - 1) / kChunk;
  float qlo, qhi, hlo, hhi;
  bool q_fin, h_fin;
  warp_x_range(xq, yq, zq, qlo, qhi, q_fin);
  warp_x_range(xh, yq, zq, hlo, hhi, h_fin);
  float fx = 0.0f, fy = 0.0f, fz = 0.0f, e = 0.0f, ec = 0.0f;

  // rank j's column: xe[j], or xe[n_pad + j] below 0; past the extended
  // array (tm = 16 with H an odd number of tiles) a rank no lane takes
  auto load = [&](int c0) {
    int j = c0 + lane;
    if (j < 0) j += n_pad;
    if (j >= n_ext) j = 0;
    return make_float4(xe[j], xe[n_ext + j], xe[2 * n_ext + j], 0.0f);
  };
  float4 next = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (g < n_chunks) next = load(base + g * kChunk);
  for (int k = g; k < n_chunks; k += kWarps) {
    const float4 mine = next;
    const int c0 = base + k * kChunk;
    if (k + kWarps < n_chunks) next = load(c0 + kWarps * kChunk);
    const bool wrapped = c0 < 0;
    const float x = wrapped ? xh : xq;
    float clo, chi;
    bool c_fin;
    warp_x_range(mine.x, mine.y, mine.z, clo, chi, c_fin);
    if (c_fin && (wrapped ? h_fin : q_fin) &&
        band::x_apart(wrapped ? hlo : qlo, wrapped ? hhi : qhi, clo, chi,
                      p.cutoff2))
      continue;
    __syncwarp();  // the previous chunk's columns have been read
    stage[g][lane] = mine;
    __syncwarp();
    const bool inner = __all_sync(
        kFull, lo <= c0 && c0 + kChunk <= hi && (q < c0 || q >= c0 + kChunk));
    if (inner) {
      strip_chunk<kApprox, kEnergy, false>(stage[g], c0, q, lo, hi, x, yq, zq,
                                           b, p, fx, fy, fz, e, ec);
    } else {
      strip_chunk<kApprox, kEnergy, true>(stage[g], c0, q, lo, hi, x, yq, zq,
                                          b, p, fx, fy, fz, e, ec);
    }
  }

  // the warps' sums of each particle, added in warp order: warp a the
  // component a, warp 3 the energy
  red[g][0][lane] = fx;
  red[g][1][lane] = fy;
  red[g][2][lane] = fz;
  red[g][3][lane] = e - ec;
  __syncthreads();
  if (g < 3) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, red[w][g][lane]);
    p.F[g * n_pad + q] = __fmul_rn(p.coef_scale, s);
  } else if (kEnergy && g == 3) {
    // each lane's energy over the warps, then the lanes in order
    float acc = 0.0f, comp = 0.0f;
    for (int w = 0; w < kWarps; ++w) kahan_add(acc, comp, red[w][3][lane]);
    const float mine = acc - comp;
    acc = comp = 0.0f;
    for (int l = 0; l < kLanes; ++l)
      kahan_add(acc, comp, __shfl_sync(kFull, mine, l));
    if (lane == 0) p.e_part[blockIdx.x] = acc - comp;
  }
}

template <bool kApprox, bool kEnergy>
cudaError_t launch_pairs(const Strip& p, cudaStream_t s) {
  strip_pairs<kApprox, kEnergy>
      <<<p.n_pad / kLanes, dim3(kLanes, kWarps), 0, s>>>(p);
  return cudaGetLastError();
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

// src: (3, src_ext) f32 with src_ext >= n_pad; dst: (3, n_pad + H) f32, src
// itself where src_ext == n_pad + H (in place); box: (3,) f32; pad sets the
// padding lanes to the sentinel.  In place without pad, one launch over the
// live x lanes; else one over every lane of (3, n_pad).
CHIRON_EXPORT int chiron_strip_wrap(const float* src, int src_ext, float* dst,
                                    const float* box, int n, int n_pad, int H,
                                    int pad, void* stream) {
  if (src_ext < n_pad || H < 0 || n < 0 || n > n_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kBlock = 256;
  const auto st = static_cast<cudaStream_t>(stream);
  if (src == dst && pad == 0) {
    if (src_ext != n_pad + H) return static_cast<int>(cudaErrorInvalidValue);
    if (n > 0)
      strip_wrap<<<(n + kBlock - 1) / kBlock, kBlock, 0, st>>>(dst, box, n,
                                                               n_pad, H);
  } else {
    const int lanes = 3 * n_pad;
    strip_wrap_copy<<<(lanes + kBlock - 1) / kBlock, kBlock, 0, st>>>(
        src, src_ext, dst, box, n, n_pad, H, pad != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// xe: (3, n_pad + H) f32; box: (3,) f32; F: (3, n_pad) f32; e_part:
// (n_pad / 32,) f32 scratch and energy (1,) f32, or both null for the force
// alone.  tm must be 16, 32, 64 or a multiple of 128 and divide n_pad, n_pad
// a multiple of 32 and H > 0.  approx sets the force's reciprocal; with the
// energy both take the exact one.  e_scale scales the energy sum (each pair
// counted twice).
CHIRON_EXPORT int chiron_strip_force(const float* xe, const float* box,
                                     float* F, float* e_part, float* energy,
                                     int n_pad, int tm, int H, float sigma2,
                                     float cutoff2, float r2_floor,
                                     float coef_scale, float e_scale,
                                     int approx, void* stream) {
  if ((tm != 16 && tm != 32 && tm != 64 && (tm <= 0 || tm % 128 != 0)) ||
      H <= 0 || n_pad % tm || n_pad % kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strip p{xe,  box,    F,       e_part,   n_pad,     tm,
                H,   sigma2, cutoff2, r2_floor, coef_scale};
  cudaError_t err;
  if (energy != nullptr) {
    err = launch_pairs<false, true>(p, s);
    if (err == cudaSuccess) {
      partial_sum<kSumThreads><<<1, kSumThreads, 0, s>>>(
          e_part, n_pad / kLanes, e_scale, energy);
      err = cudaGetLastError();
    }
  } else {
    err = approx ? launch_pairs<true, false>(p, s)
                 : launch_pairs<false, false>(p, s);
  }
  return static_cast<int>(err);
}
