// G4: CP-level encode, backward (line-table gradients).
//
// Replaces: the Pallas TPU kernel nerfacc_tpu/ops/cp_level.py::_bwd_kernel,
// which rebuilds the dense (BLK, R) hat matrices of a sample block and
// contracts them with the product cotangents on the matrix unit, carrying
// the (R, rank) sums from one grid step to the next:
//
//     dL_a[i, r] = sum_n hat_a[n, i] * (g[n, r] * prod_{b != a} f_b[n, r])
//     f_b[n, r]  = w_b0 * L_b[i_b0, r] + w_b1 * L_b[i_b1, r]
//
// with the taps and weights of G1 (csrc/cp_level.cu), recomputed the same
// way.  A hat row has two nonzeros, so each sample adds into two rows of each
// axis's table: a scatter-add.  No gradient for the coordinates (the TPU
// kernel's contract: sample positions carry none).
//
// Numerics: in bf16 mode the hat weights and table values are rounded to
// bf16 as in G1, the product cotangent g * f_b * f_c is rounded to bf16 (the
// TPU kernel's `da.astype(bf16)`), and the sums are f32.  In f32 mode nothing
// is rounded.  The products are evaluated in the TPU kernel's order
// ((g * f_first) * f_second, axes in increasing order).
//
// Bound on this card: not the bytes (0.011 ms at 2^18 samples, R = 512) but
// the per-sample work and the scatter.  2^18 samples x 2 taps land on as few
// as 16 rows per axis, so adding straight into device memory would
// serialise on a few addresses.
//
// Design: a block of 1024 threads holds a private f32 copy of all three
// (R, rank) tables in dynamic shared memory (192 KiB at (512, 32), one block
// per SM; opted into once per device), and a bitmask of the rows it
// touched.  The block's samples are cut into one contiguous run per warp
// (per rank / 32 warps past rank 32), each thread on one feature r; a warp
// takes 32 / lanes samples at a time, lanes being the rank's next power of
// two up to 32.  A warp walks its run in tiles of 32 samples: lane j
// computes the taps and hat weights of the tile's sample j once for the
// warp and hands them out with __shfl_sync.  Per sample a thread computes
// the three axes' lerps once, reads g and the six table rows once, and
// forms the three product cotangents (K2's single visit per sample).  It
// keeps, per axis, a register sum for each of the current pair of rows and
// adds them into shared memory only when the sample's first row changes, so
// the ray-ordered samples of a train step (consecutive samples on the same
// rows) cost one shared add per row crossing instead of one per sample.  At
// the end the block adds the rows it touched into the zeroed global output
// with atomicAdd (coalesced, one row of rank words at a time).  The grid is
// as many blocks as the card holds at once, capped so that each run gets at
// least one tile.  Where the three tables do not fit in shared memory but
// one does, the axes go in turn: blockIdx.y picks the axis whose table the
// block keeps (the taps and lerps of all three are still computed per
// sample).  A table past the opt-in limit is refused with
// cudaErrorInvalidValue.
//
// Variants timed on an H100 while this design was chosen, each slower or no
// faster: four features a thread (16-byte loads, 512 threads), batches of
// 16 cotangent loads in flight, a cotangent load one sample ahead.  Removing
// the shared adds, the table loads or the bf16 roundings each saved a small
// share; the bulk is the per-sample instruction stream of a warp, and at
// R = 512 the flush of every touched row from 132 blocks.
//
// Atomics make the order of the f32 sums vary from run to run; results agree
// with the plain twin to f32 rounding of a reordered sum, not bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Taps of one axis, exactly as G1 computes them.
struct Taps {
  int i0, i1;
  float w0, w1;
};

template <bool kBf16>
__device__ __forceinline__ Taps taps(float u, int R) {
  const float pos = __fmul_rn(u, (float)(R - 1));
  int i0 = (int)floorf(pos);
  i0 = min(max(i0, 0), R - 1);
  const int i1 = i0 + 1;
  float w0 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(pos, (float)i0))));
  float w1 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(pos, (float)i1))));
  Taps t;
  t.i0 = i0;
  t.i1 = i1 < R ? i1 : R - 1;
  if (i1 >= R) w1 = 0.0f;  // u = 1: the tap at row R is dropped
  t.w0 = kBf16 ? round_bf16(w0) : w0;
  t.w1 = kBf16 ? round_bf16(w1) : w1;
  return t;
}

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// One axis's pending register sums: rows i0 and i1 of the current run.
struct RowRun {
  int i0, i1;
  float s0, s1;
};

__device__ __forceinline__ void mark_row(unsigned* touched, int row) {
  const unsigned bit = 1u << (row & 31);
  if (!(touched[row >> 5] & bit)) atomicOr(&touched[row >> 5], bit);
}

// Adds a run's sums into the block's table and marks its rows.
__device__ __forceinline__ void flush_run(const RowRun& run, float* acc,
                                          unsigned* touched, int rank, int r) {
  if (run.i0 < 0) return;
  atomicAdd(&acc[run.i0 * rank + r], run.s0);
  atomicAdd(&acc[run.i1 * rank + r], run.s1);
  if (r == 0) {
    mark_row(touched, run.i0);
    mark_row(touched, run.i1);
  }
}

// axes = 3: the block keeps all three tables; axes = 1: only blockIdx.y's.
// A run of samples belongs to warps_per_run warps, warp k of them on
// features 32 k + (lane % lanes), where lanes (a power of two, at most 32)
// covers the rank; a warp takes 32 / lanes samples at a time.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1) cp_level_bwd_kernel(
    const float* __restrict__ u, const float* __restrict__ g,
    const float* __restrict__ lines, float* __restrict__ dlines, int64_t n,
    int R, int rank, int axes, int lanes, int warps_per_run, int64_t per_block,
    int64_t per_run) {
  extern __shared__ float acc[];  // [axes][R][rank], then the row bitmasks
  const int table = R * rank;
  const int words = (R + 31) / 32;
  unsigned* touched = reinterpret_cast<unsigned*>(acc + axes * table);
  const int a_lo = axes == 3 ? 0 : blockIdx.y;
  for (int i = threadIdx.x; i < axes * table; i += blockDim.x) acc[i] = 0.0f;
  for (int i = threadIdx.x; i < axes * words; i += blockDim.x) touched[i] = 0u;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int run_id = warp / warps_per_run;
  const int per_pass = 32 / lanes;  // samples a warp takes at a time
  const int sub = lane / lanes;
  const int r = (warp % warps_per_run) * 32 + lane % lanes;
  const int64_t block_end = min(n, (int64_t)(blockIdx.x + 1) * per_block);
  int64_t s_begin = blockIdx.x * per_block + run_id * per_run;
  if (run_id >= kWarps / warps_per_run) s_begin = block_end;  // spare warps
  const int64_t s_end = min(block_end, s_begin + per_run);
  RowRun run[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) run[a] = {-1, -1, 0.0f, 0.0f};
  for (int64_t base = s_begin; base < s_end; base += 32) {
    // lane j computes the taps of sample base + j once for the whole warp
    const int tile = (int)min((int64_t)32, s_end - base);
    Taps mine[3] = {};
    if (lane < tile) {
#pragma unroll
      for (int b = 0; b < 3; ++b) mine[b] = taps<kBf16>(u[(base + lane) * 3 + b], R);
    }
    for (int p = 0; p < tile; p += per_pass) {
      const int t = p + sub;
      Taps tp[3];
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        tp[b].i0 = __shfl_sync(kFull, mine[b].i0, t);
        tp[b].i1 = __shfl_sync(kFull, mine[b].i1, t);
        tp[b].w0 = __shfl_sync(kFull, mine[b].w0, t);
        tp[b].w1 = __shfl_sync(kFull, mine[b].w1, t);
      }
      if (t >= tile || r >= rank) continue;
      const int64_t s = base + t;
      float f[3];
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const float* line = lines + (int64_t)b * table + r;
        float l0 = line[tp[b].i0 * rank];
        float l1 = line[tp[b].i1 * rank];
        if (kBf16) {
          l0 = round_bf16(l0);
          l1 = round_bf16(l1);
        }
        f[b] = __fadd_rn(__fmul_rn(tp[b].w0, l0), __fmul_rn(tp[b].w1, l1));
      }
      const float gs = g[s * rank + r];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        if (axes == 1 && a != a_lo) continue;
        // the other two axes in increasing order: (g * f_first) * f_second
        float da = __fmul_rn(__fmul_rn(gs, f[a == 0 ? 1 : 0]), f[a == 2 ? 1 : 2]);
        if (kBf16) da = round_bf16(da);
        if (tp[a].i0 != run[a].i0) {
          flush_run(run[a], acc + (a - a_lo) * table, touched + (a - a_lo) * words, rank, r);
          run[a] = {tp[a].i0, tp[a].i1, 0.0f, 0.0f};
        }
        run[a].s0 = __fadd_rn(run[a].s0, __fmul_rn(tp[a].w0, da));
        if (tp[a].w1 != 0.0f) run[a].s1 = __fadd_rn(run[a].s1, __fmul_rn(tp[a].w1, da));
      }
    }
  }
  if (r < rank) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (axes == 1 && a != a_lo) continue;
      flush_run(run[a], acc + (a - a_lo) * table, touched + (a - a_lo) * words, rank, r);
    }
  }
  __syncthreads();

  // the touched rows into the global tables, one row of rank words at a time
  const int rows = axes * R;
  for (int i = threadIdx.x; i < rows * rank; i += blockDim.x) {
    const int row = i / rank;
    if (touched[(row / R) * words + (row % R) / 32] & (1u << ((row % R) & 31)))
      atomicAdd(&dlines[(int64_t)a_lo * table + i], acc[i]);
  }
}

// Per-device launch limits, read once, and the shared-memory opt-in.
struct DeviceLimits {
  int sms, smem_optin;
};

cudaError_t device_limits(DeviceLimits* out) {
  constexpr int kMaxDevices = 64;
  static DeviceLimits cache[kMaxDevices];
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    DeviceLimits l;
    err = cudaDeviceGetAttribute(&l.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&l.smem_optin,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const void* kernels[2] = {(const void*)cp_level_bwd_kernel<false>,
                              (const void*)cp_level_bwd_kernel<true>};
    for (const void* fn : kernels)
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   l.smem_optin);
    if (err != cudaSuccess) return err;
    cache[dev] = l;
    ready[dev] = true;
  }
  *out = cache[dev];
  return cudaSuccess;
}

}  // namespace

// u (n, 3), g (n, rank), lines (3, R, rank) f32; dlines (3, R, rank) f32,
// zeroed by the caller, receives the sums.
extern "C" int cp_level_bwd(const void* u, const void* g, const void* lines,
                            void* dlines, int64_t n, int R, int rank, int bf16,
                            void* stream) {
  if (n == 0) return (int)cudaSuccess;
  DeviceLimits lim;
  cudaError_t err = device_limits(&lim);
  if (err != cudaSuccess) return (int)err;
  if (rank < 1 || rank > kThreads || R < 1) return (int)cudaErrorInvalidValue;
  const size_t words = (size_t)(R + 31) / 32;
  auto smem_for = [&](int axes) {
    return (size_t)axes * ((size_t)R * rank * sizeof(float) + words * sizeof(unsigned));
  };
  const int axes = smem_for(3) <= (size_t)lim.smem_optin ? 3 : 1;
  const size_t smem = smem_for(axes);
  if (smem > (size_t)lim.smem_optin) return (int)cudaErrorInvalidValue;
  // lanes per sample: the rank's next power of two up to 32; past 32 a
  // sample's features span warps_per_run warps
  int lanes = 1;
  while (lanes < rank && lanes < 32) lanes *= 2;
  const int warps_per_run = (rank + 31) / 32;
  const int runs = kWarps / warps_per_run;
  const void* kernel = bf16 ? (const void*)cp_level_bwd_kernel<true>
                            : (const void*)cp_level_bwd_kernel<false>;
  int per_sm = 0;  // blocks resident at once on one SM
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  per_sm = per_sm < 1 ? 1 : per_sm;
  const int grid_y = axes == 3 ? 1 : 3;
  int64_t blocks_x = (int64_t)lim.sms * per_sm / grid_y;
  // at least one tile of 32 samples per run
  const int64_t most = (n + (int64_t)runs * 32 - 1) / ((int64_t)runs * 32);
  blocks_x = blocks_x < most ? blocks_x : most;
  blocks_x = blocks_x < 1 ? 1 : blocks_x;
  const int64_t per_block = (n + blocks_x - 1) / blocks_x;
  const int64_t per_run = (per_block + runs - 1) / runs;
  const dim3 grid((unsigned)blocks_x, grid_y);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    cp_level_bwd_kernel<true><<<grid, kThreads, smem, st>>>(
        (const float*)u, (const float*)g, (const float*)lines, (float*)dlines,
        n, R, rank, axes, lanes, warps_per_run, per_block, per_run);
  else
    cp_level_bwd_kernel<false><<<grid, kThreads, smem, st>>>(
        (const float*)u, (const float*)g, (const float*)lines, (float*)dlines,
        n, R, rank, axes, lanes, warps_per_run, per_block, per_run);
  return (int)cudaGetLastError();
}
