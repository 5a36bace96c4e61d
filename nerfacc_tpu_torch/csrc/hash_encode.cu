// G6: multiresolution hash encode, forward.  G7: its table gradient.
//
// Replaces: G6 the Pallas TPU kernel
// nerfacc_tpu/ops/hash_vmem.py::_make_kernel.kernel, which folds an (L, T, 2)
// table into 128 lanes of VMEM (capping T at 2^15 for 16 levels) and gathers
// each corner with tpu.dynamic_gather, and the XLA path it is held equal to
// (models/encoders.py::_hash_corners + take + blend), which runs at any T.
// G7 the XLA backward of that path: _vmem_encode_bwd + the sorted-block
// scatter-free accumulator ops/table_grad.py::accumulate_table_rows.
//
// For level l at resolution res[l], with pos = x * res[l], i0 = floor(pos),
// frac = pos - i0 (pos rounded first, no fused multiply-add), and the
// corner sum one fused multiply-add per corner, as XLA's CPU backend
// computes the JAX encoder (the PyTorch twin does the same, so kernel, twin
// and JAX agree bit for bit):
//
//     h_c = ((i0x+dx)*1 ^ (i0y+dy)*2654435761 ^ (i0z+dz)*805459861) & (T-1)
//     w_c = ((dx ? fx : 1-fx) * (dy ? fy : 1-fy)) * (dz ? fz : 1-fz)
//     out[n, 2l + f]     = fma(w_c, table[l, h_c, f], out), c = 0..7     (G6)
//     g_table[l, h_c, f] += w_c * cot[n, 2l + f]                         (G7)
//
// in uint32 arithmetic (a corner below 0 wraps, as JAX's uint32 cast does),
// corners dx-major (c = 4 dx + 2 dy + dz).  No position gradient: the contract
// of the TPU kernel's path; sample positions carry none.
//
// Bound on this card: random 8-byte row gathers (G6) and random 8-byte atomic
// adds (G7).  At the field's shape (2^18 samples, 16 levels, T = 2^19) a call
// touches 2^25 corner rows spread over a 64 MiB table: each costs a 32-byte
// sector of which 8 bytes are used, and the table exceeds the 50 MB L2.  The
// bytes the function itself must move (x, the output or cotangent, the table
// rows it touches) are ~100 MiB, ~30 us at 3.35 TB/s.  G7 adds contention:
// level 0 (resolution 16) has ~17^3 = 4,913 distinct rows for 2^21 corner
// updates, so ~400 atomics land on each of its rows and serialise in L2.
//
// Design (simple and right first): one thread per (sample, level), the level
// fastest, so a warp covers two samples x 16 levels: the x loads are
// broadcasts and G6's float2 stores of a warp are one contiguous 256-byte
// run, and G7's cotangent loads likewise.  The eight hashes and weights stay
// in registers; each corner's F = 2 row is one float2 load (G6) or one float2
// atomicAdd (compute capability 9.x, G7) into the zeroed gradient.  G6 sums
// the corners in the order c = 0..7 with explicitly rounded intrinsics, so
// it is bitwise equal to the PyTorch twin (nerfacc_tpu_torch/ops/
// hash_encode.py); G7's sums run in atomic order, which varies from run to
// run.  Left for later: warp-aggregated or shared-memory accumulation for
// the coarse levels whose (res+1)^3 rows fit a block, level-major blocks for
// L2 locality.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Corners {
  uint32_t row[8];  // row of the (L*T, 2) flat table
  float w[8];
};

__device__ __forceinline__ Corners corners(const float* __restrict__ x,
                                           const float* __restrict__ res,
                                           int64_t s, int l, int log2T) {
  const float r = res[l];
  int i0[3];
  float f[3];
  for (int a = 0; a < 3; ++a) {
    const float pos = __fmul_rn(x[s * 3 + a], r);
    const float fl = floorf(pos);
    i0[a] = (int)fl;
    f[a] = __fsub_rn(pos, fl);
  }
  const uint32_t mask = (1u << log2T) - 1u;
  const uint32_t base = (uint32_t)l << log2T;
  Corners c;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = (k >> 2) & 1, dy = (k >> 1) & 1, dz = k & 1;
    const uint32_t h = ((uint32_t)(i0[0] + dx) * 1u) ^
                       ((uint32_t)(i0[1] + dy) * 2654435761u) ^
                       ((uint32_t)(i0[2] + dz) * 805459861u);
    c.row[k] = base + (h & mask);
    const float wx = dx ? f[0] : __fsub_rn(1.0f, f[0]);
    const float wy = dy ? f[1] : __fsub_rn(1.0f, f[1]);
    const float wz = dz ? f[2] : __fsub_rn(1.0f, f[2]);
    c.w[k] = __fmul_rn(__fmul_rn(wx, wy), wz);
  }
  return c;
}

__global__ void hash_fwd_kernel(const float* __restrict__ x,
                                const float2* __restrict__ table,
                                const float* __restrict__ res,
                                float2* __restrict__ out, int64_t n, int L,
                                int log2T) {
  const int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (idx >= n * L) return;
  const int64_t s = idx / L;
  const int l = (int)(idx - s * L);
  const Corners c = corners(x, res, s, l, log2T);
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float2 v = table[c.row[k]];
    a0 = __fmaf_rn(c.w[k], v.x, a0);
    a1 = __fmaf_rn(c.w[k], v.y, a1);
  }
  out[idx] = make_float2(a0, a1);
}

__global__ void hash_bwd_kernel(const float* __restrict__ x,
                                const float2* __restrict__ cot,
                                const float* __restrict__ res,
                                float2* __restrict__ g_table, int64_t n, int L,
                                int log2T) {
  const int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (idx >= n * L) return;
  const int64_t s = idx / L;
  const int l = (int)(idx - s * L);
  const Corners c = corners(x, res, s, l, log2T);
  const float2 g = cot[idx];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    atomicAdd(g_table + c.row[k],
              make_float2(__fmul_rn(c.w[k], g.x), __fmul_rn(c.w[k], g.y)));
  }
}

constexpr int kThreads = 256;

// Row ids of the (L * 2^log2T)-row flat table must fit in 32 bits.
bool shape_ok(int L, int log2T) {
  return L > 0 && log2T >= 0 && log2T <= 31 &&
         ((int64_t)L << log2T) <= (int64_t(1) << 32);
}

}  // namespace

// x (n, 3) f32, table (L, 2^log2T, 2) f32, res (L,) f32 -> out (n, 2L) f32.
extern "C" int hash_fwd(const void* x, const void* table, const void* res,
                        void* out, int64_t n, int L, int log2T, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (!shape_ok(L, log2T)) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n * L + kThreads - 1) / kThreads;
  hash_fwd_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float2*)table, (const float*)res, (float2*)out, n,
      L, log2T);
  return (int)cudaGetLastError();
}

// x (n, 3) f32, cot (n, 2L) f32, res (L,) f32; g_table (L, 2^log2T, 2) f32,
// zeroed by the caller, receives the sums.
extern "C" int hash_bwd(const void* x, const void* cot, const void* res,
                        void* g_table, int64_t n, int L, int log2T,
                        void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (!shape_ok(L, log2T)) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n * L + kThreads - 1) / kThreads;
  hash_bwd_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float2*)cot, (const float*)res,
      (float2*)g_table, n, L, log2T);
  return (int)cudaGetLastError();
}
