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
// Bound on this card: the scatter.  2^18 samples x 2 taps land on as few as
// 32 rows per axis (R = 32), so adding straight into device memory would
// serialise on a few addresses.  Design: one block handles one axis (blockIdx.y)
// over a contiguous run of samples (blockIdx.x), one thread per (sample,
// feature) as in G1 (at rank 32 a warp is one sample, so the 32 lanes of a
// shared-memory atomic hit 32 distinct words).  The block accumulates into a
// private (R, rank) f32 table in dynamic shared memory (64 KiB at R = 512,
// above the 48 KB static limit, opted into with
// cudaFuncAttributeMaxDynamicSharedMemorySize), then flushes its nonzero
// entries once with atomicAdd into the zeroed global output.  A table larger
// than the card's opt-in shared memory (227 KB on the H100; the field's
// largest is 64 KiB) is refused with cudaErrorInvalidValue.  A block takes a
// run of about 4 R samples (more where 2 blocks per SM and axis would not
// cover n), so its flush (R x rank atomics) is small next to its 8 R x rank
// shared-memory adds.
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

__device__ __forceinline__ Taps taps(float u, int R, int bf16) {
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
  t.w0 = bf16 ? round_bf16(w0) : w0;
  t.w1 = bf16 ? round_bf16(w1) : w1;
  return t;
}

__global__ void cp_level_bwd_kernel(const float* __restrict__ u,
                                    const float* __restrict__ g,
                                    const float* __restrict__ lines,
                                    float* __restrict__ dlines, int64_t n,
                                    int R, int rank, int bf16,
                                    int64_t per_block) {
  extern __shared__ float acc[];
  const int a = blockIdx.y;
  const int table = R * rank;
  float* out = dlines + (int64_t)a * table;
  for (int i = threadIdx.x; i < table; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  const int64_t s0 = blockIdx.x * per_block;
  const int64_t s1 = min(n, s0 + per_block);
  const int elems = (int)((s1 - s0) * rank);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int64_t s = s0 + e / rank;
    const int r = e % rank;
    Taps own = {0, 0, 0.0f, 0.0f};
    float da = g[s * rank + r];
    for (int b = 0; b < 3; ++b) {
      const Taps t = taps(u[s * 3 + b], R, bf16);
      if (b == a) {
        own = t;
        continue;
      }
      const float* line = lines + (int64_t)b * table;
      float l0 = line[t.i0 * rank + r];
      float l1 = line[t.i1 * rank + r];
      if (bf16) {
        l0 = round_bf16(l0);
        l1 = round_bf16(l1);
      }
      da = __fmul_rn(da, __fadd_rn(__fmul_rn(t.w0, l0), __fmul_rn(t.w1, l1)));
    }
    if (bf16) da = round_bf16(da);
    atomicAdd(&acc[own.i0 * rank + r], __fmul_rn(own.w0, da));
    if (own.w1 != 0.0f) atomicAdd(&acc[own.i1 * rank + r], __fmul_rn(own.w1, da));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < table; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.0f) atomicAdd(&out[i], v);
  }
}

}  // namespace

// u (n, 3), g (n, rank), lines (3, R, rank) f32; dlines (3, R, rank) f32,
// zeroed by the caller, receives the sums.
extern "C" int cp_level_bwd(const void* u, const void* g, const void* lines,
                            void* dlines, int64_t n, int R, int rank, int bf16,
                            void* stream) {
  if (n == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0, smem_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  int64_t blocks_x = (n + 4 * (int64_t)R - 1) / (4 * (int64_t)R);
  blocks_x = blocks_x < 1 ? 1 : (blocks_x > 2 * sms ? 2 * sms : blocks_x);
  const int64_t per_block = (n + blocks_x - 1) / blocks_x;
  if (per_block * rank > INT32_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks_x, 3);
  const size_t smem = (size_t)R * rank * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (smem > (size_t)smem_optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(cp_level_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cp_level_bwd_kernel<<<grid, threads, smem, st>>>(
      (const float*)u, (const float*)g, (const float*)lines, (float*)dlines, n,
      R, rank, bf16, per_block);
  return (int)cudaGetLastError();
}
