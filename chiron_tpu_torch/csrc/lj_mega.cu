// One culled MD segment enqueued by one host call: the list build from the
// current order, S BAOAB steps on the culled force, the drift latch and the
// odd-even repair of the spatial order (K11).
//
// Replaces chiron_tpu/ops/lj_mega.py: _make_mega_kernel (:82), launched by
// mega_md_raw (pallas_call at :368).  The TPU kernel is one grid over the S
// steps with the list in SMEM scratch.  Hopper has no grid-wide barrier
// inside a launch, so chiron_mega_segment enqueues the segment's launches
// back to back on the caller's stream, with no host work between them:
//   1. tile_build: the list of the entry positions in the current order
//      (:121-259), the build of K10 without the sort (tile_build.cuh), into
//      buffers the caller allocates once;
//   2. the S steps of K3's segment (cull_md_steps, lj_cull_force.cu: the
//      BAOAB phase of step 0, then each step's culled force with the next
//      step's BAOAB update in its gather's epilogue; the TPU kernel shares
//      _baoab_phase and _row_force_pass with the classic one the same way,
//      :264-275);
//   3. the drift latch against the entry positions (drift.cu, :282-286);
//   4. mega_repair: P odd-even transposition passes over the lane order
//      (:300-335), the comparator the minimum-image x difference
//      d - L round(d / L) (d times 1/L, as the TPU kernel has it), so that a
//      particle that wrapped in x stays cyclically near its rank; the
//      padding lanes never move.  Its block 0 ORs the build's latch and the
//      drift latch into the segment's flag.
// With P = 0 the segment is the classic path's bit for bit: the same
// kernels on a list equal to build_tile_pairs'.
//
// The repair.  After P passes, lane i depends only on lanes [i - P, i + P]
// at the start, so the passes need no grid-wide barrier: a block owns a
// chunk [c0, c1) of lanes, loads the keys (x's first row) and lane indices
// of the window [c0 - P, c1 + P) clipped to [0, n_pad) into shared memory,
// runs the P passes there (the parity from the global lane index, the pair
// (i, i + 1) only for i < n - 1, so padding never moves), and writes the
// nine rows of its own lanes, gathered from their source lanes, to the
// output.  An error at the window's edge moves inward one lane a pass, so
// the owned lanes are exact: the same permutation of the same values as
// repair_plain.  Chunks of 32 lanes at P <= 32 (128 blocks at n_pad 4096,
// P = 16), of round_up(P, 32) up to 512 lanes above; a window too wide for
// shared memory (above 25,600 lanes: P above 12,544 at an n_pad above that)
// runs in one block on global scratch.
//
// Bound: the build reads x once (12 n_pad B), each step is K3's (BAOAB's
// bytes, the culled force's pair operations), the latch reads two (3,
// n_pad) rows and the repair reads and writes nine; at the main path's
// n_pad the steps' force passes dominate.
#include "tile_build.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
tile_build_kernel(tile_build::Params p) {
  extern __shared__ float smem[];
  const float box[3] = {p.box[0], p.box[1], p.box[2]};
  tile_build::build(p, smem, box);
}

constexpr int kMaxRepairSmem = 200 * 1024;

__global__ void __launch_bounds__(1024)
mega_repair(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ F, float* __restrict__ xo,
            float* __restrict__ wo, float* __restrict__ Fo,
            const float* __restrict__ box, int n, int n_pad, int passes,
            int chunk, float* gkeys, int* gidx, const bool* build_over,
            const bool* drift_bad, bool* flag) {
  extern __shared__ float4 window_smem[];
  const int c0 = blockIdx.x * chunk;
  const int c1 = min(c0 + chunk, n_pad);
  const int halo = min(passes, n_pad);
  const int w0 = max(0, c0 - halo), w1 = min(n_pad, c1 + halo);
  const int wn = w1 - w0;
  float* keys = gkeys != nullptr ? gkeys : reinterpret_cast<float*>(window_smem);
  int* idx = gidx != nullptr ? gidx : reinterpret_cast<int*>(keys + wn);
  for (int t = threadIdx.x; t < wn; t += blockDim.x) {
    keys[t] = x[w0 + t];
    idx[t] = w0 + t;
  }
  __syncthreads();
  const float Lx = box[0];
  const float inv_Lx = __fdiv_rn(1.0f, Lx);
  const int hi = min(w1 - 1, n - 1);  // the pairs (i, i + 1), w0 <= i < hi
  for (int p = 0; p < passes; ++p) {
    const int first = w0 + ((w0 ^ p) & 1);  // i = p mod 2
    for (int i = first + 2 * static_cast<int>(threadIdx.x); i < hi;
         i += 2 * blockDim.x) {
      const int t = i - w0;
      const float a = keys[t], b = keys[t + 1];
      float d = __fsub_rn(a, b);
      d = __fsub_rn(d, __fmul_rn(Lx, rintf(__fmul_rn(d, inv_Lx))));
      if (d > 0.0f) {
        keys[t] = b;
        keys[t + 1] = a;
        const int k = idx[t];
        idx[t] = idx[t + 1];
        idx[t + 1] = k;
      }
    }
    __syncthreads();
  }
  const float* rows[3] = {x, w, F};
  float* outs[3] = {xo, wo, Fo};
  for (int j = c0 + threadIdx.x; j < c1; j += blockDim.x) {
    const int src = idx[j - w0];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const size_t row = static_cast<size_t>(a) * n_pad;
        outs[q][row + j] = rows[q][row + src];
      }
    }
  }
  if (flag != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    flag[0] = build_over[0] || drift_bad[0];
  }
}

// The repair's geometry at n_pad and P: chunks of round_up(P, 32) lanes,
// 32 to 512, each block on its own window in shared memory; where the
// window outgrows shared memory, one block over the whole order on global
// scratch (keys, idx: n_pad each).
struct RepairGeometry {
  int chunk, blocks, threads;
  size_t smem;
  bool global_scratch;
};

RepairGeometry repair_geometry(int n_pad, int passes) {
  const int halo = passes < n_pad ? passes : n_pad;
  int chunk = ((halo + 31) / 32) * 32;
  chunk = chunk < 32 ? 32 : (chunk > 512 ? 512 : chunk);
  const long long span = chunk + 2LL * halo;
  const int window = static_cast<int>(span < n_pad ? span : n_pad);
  RepairGeometry g{chunk, (n_pad + chunk - 1) / chunk, 0,
                   2 * sizeof(float) * static_cast<size_t>(window), false};
  if (g.smem > static_cast<size_t>(kMaxRepairSmem)) {
    g = RepairGeometry{n_pad, 1, 0, 0, true};
  }
  const int pairs = ((g.chunk < n_pad ? window : n_pad) + 1) / 2;
  const int threads = ((pairs + 31) / 32) * 32;
  g.threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  return g;
}

// The repair's launch; keys and idx are read only where the geometry takes
// global scratch, and must then be given.
cudaError_t launch_repair(const float* x, const float* w, const float* F,
                          float* xo, float* wo, float* Fo, const float* box,
                          int n, int n_pad, int passes, float* keys, int* idx,
                          const bool* build_over, const bool* drift_bad,
                          bool* flag, cudaStream_t s) {
  if (passes < 0 || n_pad < 1) return cudaErrorInvalidValue;
  const RepairGeometry g = repair_geometry(n_pad, passes);
  if (!g.global_scratch) {
    keys = nullptr;
    idx = nullptr;
  } else if (keys == nullptr || idx == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (g.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mega_repair, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(g.smem));
    if (err != cudaSuccess) return err;
  }
  mega_repair<<<g.blocks, g.threads, g.smem, s>>>(
      x, w, F, xo, wo, Fo, box, n, n_pad, passes, g.chunk, keys, idx,
      build_over, drift_bad, flag);
  return cudaGetLastError();
}

cudaError_t launch_tile_build(const tile_build::Params& p, cudaStream_t s) {
  if (p.tm % 128 != 0 || p.tn % 128 != 0) return cudaErrorInvalidValue;
  const size_t smem = tile_build::smem_bytes(p.g);
  cudaError_t err = cudaFuncSetAttribute(
      tile_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  tile_build_kernel<<<1, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The list of x in its current order: arrays as chiron_sort_build's.
CHIRON_EXPORT int chiron_tile_build(const float* x, const float* box, int* rows,
                                    int* cols, float* ccx, int* ptr2,
                                    float* rowcx, int* count, bool* over,
                                    int n, int n_pad, int tm, int tn,
                                    float cutoff, float slack, float reach2,
                                    int capacity, void* stream) {
  const tile_build::Params p{x, box, rows, cols, ccx, ptr2, rowcx, count, over,
                             n, n_pad, tm, tn, capacity, cutoff, slack, reach2,
                             tile_build::grid(n_pad, tm, tn)};
  return static_cast<int>(
      launch_tile_build(p, static_cast<cudaStream_t>(stream)));
}

// The lanes of global scratch (keys and idx each) that the repair takes at
// n_pad and P: n_pad where its window outgrows shared memory, else 0.
CHIRON_EXPORT int chiron_repair_scratch_lanes(int n_pad, int passes) {
  return passes >= 0 && n_pad >= 1 &&
                 repair_geometry(n_pad, passes).global_scratch
             ? n_pad
             : 0;
}

// P repair passes over x, w, F ((3, n_pad) f32) into xo, wo, Fo; box:
// (3,) f32; keys, idx: (n_pad,) scratch where chiron_repair_scratch_lanes
// asks for it, else null.
CHIRON_EXPORT int chiron_mega_repair(const float* x, const float* w,
                                     const float* F, float* xo, float* wo,
                                     float* Fo, const float* box, int n,
                                     int n_pad, int passes, float* keys,
                                     int* idx, void* stream) {
  return static_cast<int>(launch_repair(
      x, w, F, xo, wo, Fo, box, n, n_pad, passes, keys, idx, nullptr,
      nullptr, nullptr, static_cast<cudaStream_t>(stream)));
}

// One segment from (x_in, w_in, F_in) ((3, n_pad) f32, w the velocity
// before the trailing half-kick, x_in the latch's anchor): the steps run in
// place on the caller's buffers x, w, F, and the repaired order goes to xo,
// wo, Fo.  The list (rows .. count, build_over), the force pass's scratch
// (P, R, e_part, as chiron_cull_force takes them at this capacity), the
// latch's (latch_part, ticket, as chiron_drift takes them) and the repair's
// (keys, idx, or null where chiron_repair_scratch_lanes is 0) are the
// caller's; threshold: (1,) f32 drift slack on the device; drift_bad: (1,)
// bool scratch; flag: (1,) bool, the build's latch or the drift latch;
// work: (2,) u64 pair-work counts as chiron_cull_force takes them, or null.
CHIRON_EXPORT int chiron_mega_segment(
    const float* x_in, const float* w_in, const float* F_in, float* x,
    float* w, float* F, float* xo, float* wo, float* Fo, const float* minv,
    const float* sigv, const float* box, const int* step_offset, uint32_t seed,
    int n_steps, int* rows, int* cols, float* ccx, int* ptr2, float* rowcx,
    int* count, bool* build_over, float* P, float* R, float* e_part,
    const float* threshold, int* latch_part, unsigned* ticket,
    bool* drift_bad, float* keys, int* idx, bool* flag, int n, int n_pad,
    int tm, int tn, int capacity, float cutoff, float slack, float reach2,
    float dt, float half_dt, float a, float b, float inv_sigma,
    float sigma_fold, float cutoff2_s, float eps_scale, int approx,
    int repair_passes, unsigned long long* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = sizeof(float) * 3 * static_cast<size_t>(n_pad);
  cudaError_t err = cudaSuccess;
  const float* ins[3] = {x_in, w_in, F_in};
  float* outs[3] = {x, w, F};
  for (int q = 0; q < 3 && err == cudaSuccess; ++q) {
    err = cudaMemcpyAsync(outs[q], ins[q], bytes, cudaMemcpyDeviceToDevice, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const tile_build::Params bp{x_in, box, rows, cols, ccx, ptr2, rowcx, count,
                              build_over, n, n_pad, tm, tn, capacity, cutoff,
                              slack, reach2, tile_build::grid(n_pad, tm, tn)};
  err = launch_tile_build(bp, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CullMD m{x, w, F, minv, sigv, box, step_offset, seed, n_steps, rows,
                 cols, ccx, ptr2, rowcx, count, P, R, e_part, nullptr, n,
                 n_pad, tm, tn, capacity, dt, half_dt, a, b, inv_sigma,
                 sigma_fold, cutoff2_s, eps_scale, 0.0f, approx, work};
  err = cull_md_steps(m, s);
  if (err == cudaSuccess) {
    err = drift_latch(x, x_in, box, n, n_pad, threshold, latch_part, ticket,
                      drift_bad, s);
  }
  if (err == cudaSuccess) {
    err = launch_repair(x, w, F, xo, wo, Fo, box, n, n_pad, repair_passes,
                        keys, idx, build_over, drift_bad, flag, s);
  }
  return static_cast<int>(err);
}
