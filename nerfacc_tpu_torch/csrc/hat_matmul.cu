// G8, G9, G10: the hat-interpolation matmul of one line table, forward and
// both backward passes.
//
// Replaces the Pallas TPU kernels of nerfacc_tpu/ops/hat_matmul.py, which
// build a dense (BLK, R) hat matrix W per sample block and feed it to the
// matrix unit:
//
//   G8  hat_fwd       (K3  _fwd_kernel)       out  = bf16(W) @ bf16(line)
//   G9  hat_bwd_line  (K3b _bwd_line_kernel)  dline = bf16(W)^T @ bf16(g)
//   G10 hat_bwd_x     (K3c _bwd_x_kernel)     dx[n] = (R-1) sum_i dW[n,i] S[n,i],
//                                             S = bf16(g) @ bf16(line)^T
//
// with W[n, i] = max(0, 1 - |pos_n - i|), pos_n = x_n (R - 1), and
// dW[n, i] = -sign(pos_n - i) where |pos_n - i| < 1, else 0.  A hat row has
// at most two nonzeros, at i0 = clamp(floor(pos), 0, R-1) and i0 + 1 (when
// that is a row of the table), so each kernel reads or writes two table rows
// per sample instead of a dense tile: the taps of G1 (csrc/cp_level.cu).
//
// Numerics.  G8: the weights and table values are rounded to bf16, their
// products are exact in f32, and w0 L0 + w1 L1 is one rounded f32 addition,
// the same value as the TPU's bf16-operand, f32-accumulate dot (its other
// terms are exact zeros): bitwise equal to the PyTorch version.  G9: g is
// rounded to bf16, each product w g is exact; each block sums its samples'
// products in f32 (atomic order), the blocks' partial sums are added in f64
// and the total rounded to f32 once, so the result lies within a few f32
// roundings of the block partials from the exact sum, which the PyTorch
// version rounds once.  G10: g and the table are rounded to bf16, S at each
// tap is an f32
// sum over the rank (in this kernel's order), then dx = (dW0 S0 + dW1 S1)
// (R - 1).  dW is exactly 0 at a grid point (pos - i = 0, and the
// neighbours at distance exactly 1 are excluded), so dx is 0 there, x = 0 and
// x = 1 included: the TPU kernel's rule, not the one-sided slope that
// autograd of the hat would give.
//
// Bounds on this card: device-memory traffic.  G8 writes 4 rank bytes per
// sample, G9 and G10 read as many; the (R, rank) table (64 KiB at R = 512,
// rank 32) stays in L2 and L1.
//
// Designs.  G8: one thread per output element (n, r), as G1: at rank 32 a
// warp is one sample, its row loads and its store are single 128-byte
// transactions.  G9: the scatter of G4 (csrc/cp_level_bwd.cu): at R = 32,
// 2^18 samples land on 32 rows, so each block adds a contiguous run of
// samples into a private (R, rank) f32 table in dynamic shared memory and
// flushes its nonzero entries once with f64 atomicAdd into a zeroed scratch
// table, which a second launch rounds into the f32 output.  The f64 flush
// keeps the order of the cross-block sums (a few hundred partials per
// entry) out of the result.
// G10: one thread per sample, the two rank-long dot products in registers
// (any rank); the sample's g row is read once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The two taps of one coordinate: rows i0 and i1 (i1 clamped into the
// table, with weight 0 where it is row R), their bf16 hat weights and the
// hat's slopes there.
struct Taps {
  int i0, i1;
  float w0, w1;    // bf16-rounded weights
  float dw0, dw1;  // -sign(pos - i) where |pos - i| < 1, else 0
};

__device__ __forceinline__ float slope(float delta) {
  if (!(fabsf(delta) < 1.0f)) return 0.0f;
  return delta > 0.0f ? -1.0f : (delta < 0.0f ? 1.0f : 0.0f);
}

__device__ __forceinline__ Taps taps(float x, int R) {
  const float pos = __fmul_rn(x, (float)(R - 1));
  int i0 = (int)floorf(pos);
  i0 = min(max(i0, 0), R - 1);
  const int i1 = i0 + 1;
  const float d0 = __fsub_rn(pos, (float)i0);
  const float d1 = __fsub_rn(pos, (float)i1);
  Taps t;
  t.i0 = i0;
  t.i1 = i1 < R ? i1 : R - 1;
  t.w0 = round_bf16(fmaxf(0.0f, __fsub_rn(1.0f, fabsf(d0))));
  t.w1 = i1 < R ? round_bf16(fmaxf(0.0f, __fsub_rn(1.0f, fabsf(d1)))) : 0.0f;
  t.dw0 = slope(d0);
  t.dw1 = i1 < R ? slope(d1) : 0.0f;
  return t;
}

__global__ void hat_fwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ line,
                               float* __restrict__ out, int64_t n, int R,
                               int rank) {
  const int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (idx >= n * rank) return;
  const int64_t s = idx / rank;
  const int r = (int)(idx - s * rank);
  const Taps t = taps(x[s], R);
  const float l0 = round_bf16(line[(int64_t)t.i0 * rank + r]);
  const float l1 = round_bf16(line[(int64_t)t.i1 * rank + r]);
  out[idx] = __fadd_rn(__fmul_rn(t.w0, l0), __fmul_rn(t.w1, l1));
}

__global__ void hat_bwd_line_kernel(const float* __restrict__ x,
                                    const float* __restrict__ g,
                                    double* __restrict__ sums, int64_t n,
                                    int R, int rank, int64_t per_block) {
  extern __shared__ float acc[];
  const int table = R * rank;
  for (int i = threadIdx.x; i < table; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  const int64_t s0 = blockIdx.x * per_block;
  const int64_t s1 = min(n, s0 + per_block);
  const int elems = (int)((s1 - s0) * rank);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int64_t s = s0 + e / rank;
    const int r = e % rank;
    const Taps t = taps(x[s], R);
    const float gb = round_bf16(g[s * rank + r]);
    if (t.w0 != 0.0f) atomicAdd(&acc[t.i0 * rank + r], __fmul_rn(t.w0, gb));
    if (t.w1 != 0.0f) atomicAdd(&acc[t.i1 * rank + r], __fmul_rn(t.w1, gb));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < table; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.0f) atomicAdd(&sums[i], (double)v);
  }
}

__global__ void round_to_f32_kernel(const double* __restrict__ in,
                                    float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (float)in[i];
}

__global__ void hat_bwd_x_kernel(const float* __restrict__ x,
                                 const float* __restrict__ g,
                                 const float* __restrict__ line,
                                 float* __restrict__ dx, int64_t n, int R,
                                 int rank) {
  const int64_t s = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (s >= n) return;
  const Taps t = taps(x[s], R);
  if (t.dw0 == 0.0f && t.dw1 == 0.0f) {
    dx[s] = 0.0f;
    return;
  }
  const float* gs = g + s * rank;
  const float* l0 = line + (int64_t)t.i0 * rank;
  const float* l1 = line + (int64_t)t.i1 * rank;
  float s0 = 0.0f, s1 = 0.0f;
  for (int r = 0; r < rank; ++r) {
    const float gb = round_bf16(gs[r]);
    s0 = __fmaf_rn(gb, round_bf16(__ldg(l0 + r)), s0);
    s1 = __fmaf_rn(gb, round_bf16(__ldg(l1 + r)), s1);
  }
  const float sum = __fadd_rn(__fmul_rn(t.dw0, s0), __fmul_rn(t.dw1, s1));
  dx[s] = __fmul_rn(sum, (float)(R - 1));
}

}  // namespace

// x (n,), line (R, rank) f32; out (n, rank) f32.
extern "C" int hat_fwd(const void* x, const void* line, void* out, int64_t n,
                       int R, int rank, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (n * rank + threads - 1) / threads;
  hat_fwd_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)line, (float*)out, n, R, rank);
  return (int)cudaGetLastError();
}

// x (n,), g (n, rank) f32; sums (R, rank) f64 scratch, zeroed by the
// caller; dline (R, rank) f32 receives the sums rounded.  A table past the
// card's opt-in shared memory is refused with cudaErrorInvalidValue.
extern "C" int hat_bwd_line(const void* x, const void* g, void* sums,
                            void* dline, int64_t n, int R, int rank,
                            void* stream) {
  int dev = 0, sms = 0, smem_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)R * rank * sizeof(float);
  if (smem > (size_t)smem_optin) return (int)cudaErrorInvalidValue;
  // about 4 R samples per block, at most 2 blocks per SM: a block's flush
  // (R x rank atomics) stays small next to its 8 R x rank shared adds
  int64_t blocks = (n + 4 * (int64_t)R - 1) / (4 * (int64_t)R);
  blocks = blocks < 1 ? 1 : (blocks > 2 * sms ? 2 * sms : blocks);
  const int64_t per_block = (n + blocks - 1) / blocks;
  if (per_block * rank > INT32_MAX) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(hat_bwd_line_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) {
    hat_bwd_line_kernel<<<(unsigned)blocks, 256, smem, st>>>(
        (const float*)x, (const float*)g, (double*)sums, n, R, rank,
        per_block);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int table = R * rank;
  if (table == 0) return (int)cudaSuccess;
  round_to_f32_kernel<<<(table + 255) / 256, 256, 0, st>>>(
      (const double*)sums, (float*)dline, table);
  return (int)cudaGetLastError();
}

// x (n,), g (n, rank), line (R, rank) f32; dx (n,) f32.
extern "C" int hat_bwd_x(const void* x, const void* g, const void* line,
                         void* dx, int64_t n, int R, int rank, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  hat_bwd_x_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)g, (const float*)line, (float*)dx, n, R,
      rank);
  return (int)cudaGetLastError();
}
