// G11: coarse-occupancy lookup.  G12: per-lane gather.  G13: row gather.
//
// Replaces three TPU gather formulations, each written around the TPU's lack
// of a fast random-access load:
//   G11 the Pallas kernel nerfacc_tpu/ops/coarse_occ.py::_kernel (K5), which
//       reads out[n] = S[row[n], lane[n]] as a bf16 one-hot row matmul on the
//       matrix unit and an iota-compare lane mask, in blocks of 512;
//   G12 the Pallas kernel nerfacc_tpu/ops/lane_gather.py::_kernel (K6) and
//       the probe scripts/pallas_gather_probe2.py::gather_kernel (P2):
//       out[i, l] = src[idx[i, l], l] over 128 lanes (Mosaic's same-shape
//       tpu.dynamic_gather);
//   G13 the four pallas_calls of scripts/pallas_gather_probe.py (P1), each a
//       formulation of the row gather out[i, :] = tab[idx[i], :].
// On this card each is what it computes: one indexed load per output.
//
//   G11: out[n] = f32(bf16(S[row[n], lane[n]])), 0 where row or lane lies
//        outside the table (what the one-hot contraction gives: no one-hot
//        column matches).  The bf16 rounding is the TPU kernel's, which
//        multiplies S.astype(bf16).
//   G12, G13: JAX's gather semantics (jnp.take / take_along_axis): an index
//        in [-T, 0) counts from the end, and one outside [-T, T) reads NaN.
//
// Bound on this card: device-memory traffic.  Each output element is one
// read of its index (or indices) and one store, both coalesced; the source
// rows are read at random.  G11's table (at most ~1M f32 = 4 MB) and P1's
// (2^14 x 128 f32 = 8 MB) stay in the 50 MB L2; G12's (T, 128) source does up
// to T = 2^16 (32 MB).
//
// Design: one thread per output element (G11, G12), or per 16-byte chunk of
// an output row (G13, when the row length and alignment allow float4, else
// one element), so a warp's index loads and stores are contiguous.  No
// shared memory: nothing is reused within a block that L1 and L2 do not
// already keep.  G12 copies elements as raw 2- or 4-byte words, so it serves
// f32 and bf16 sources alike and is exact by construction.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void coarse_occ_kernel(const int* __restrict__ row,
                                  const int* __restrict__ lane,
                                  const float* __restrict__ summary,
                                  float* __restrict__ out, int64_t n, int rows,
                                  int lanes) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = row[i], l = lane[i];
  float v = 0.0f;
  if (r >= 0 && r < rows && l >= 0 && l < lanes) {
    v = __bfloat162float(__float2bfloat16_rn(summary[(int64_t)r * lanes + l]));
  }
  out[i] = v;
}

// JAX's gather index rule: [-T, 0) wraps once, anything else outside reads
// the fill value.
__device__ __forceinline__ bool take_index(int idx, int T, int* row) {
  const int r = idx < 0 ? idx + T : idx;
  *row = r;
  return r >= 0 && r < T;
}

// Word is uint16_t for bf16 and uint32_t for f32: the bits are copied.
template <typename Word>
__global__ void lane_gather_kernel(const Word* __restrict__ src,
                                   const int* __restrict__ idx,
                                   Word* __restrict__ out, int64_t n_elems,
                                   int T, Word nan_bits) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n_elems) return;
  const int l = (int)(i & 127);
  int r;
  out[i] = take_index(idx[i], T, &r) ? src[(int64_t)r * 128 + l] : nan_bits;
}

// Vec is float4, float2 or float; each thread copies one Vec of a row.
template <typename Vec>
__global__ void row_gather_kernel(const Vec* __restrict__ tab,
                                  const int* __restrict__ idx,
                                  Vec* __restrict__ out, int64_t n, int T,
                                  int vecs_per_row) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n * vecs_per_row) return;
  const int64_t s = i / vecs_per_row;
  const int c = (int)(i - s * vecs_per_row);
  int r;
  if (take_index(idx[s], T, &r)) {
    out[i] = tab[(int64_t)r * vecs_per_row + c];
  } else {
    const float q = __int_as_float(0x7fc00000);  // quiet NaN
    float* o = reinterpret_cast<float*>(out + i);
    for (int k = 0; k < (int)(sizeof(Vec) / sizeof(float)); ++k) o[k] = q;
  }
}

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int coarse_occ_lookup(const void* row, const void* lane,
                                 const void* summary, void* out, int64_t n,
                                 int rows, int lanes, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  coarse_occ_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)row, (const int*)lane, (const float*)summary, (float*)out, n,
      rows, lanes);
  return (int)cudaGetLastError();
}

// elem_bytes: 4 (f32) or 2 (bf16).
extern "C" int lane_gather(const void* src, const void* idx, void* out,
                           int64_t n_rows, int T, int elem_bytes,
                           void* stream) {
  const int64_t n = n_rows * 128;
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4) {
    lane_gather_kernel<uint32_t><<<blocks_for(n), kThreads, 0, s>>>(
        (const uint32_t*)src, (const int*)idx, (uint32_t*)out, n, T,
        0x7fc00000u);
  } else if (elem_bytes == 2) {
    lane_gather_kernel<uint16_t><<<blocks_for(n), kThreads, 0, s>>>(
        (const uint16_t*)src, (const int*)idx, (uint16_t*)out, n, T,
        (uint16_t)0x7fc0u);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// tab (T, F) f32, idx (n,) int32, out (n, F) f32.  vec: 4, 2 or 1 floats per
// thread; the wrapper picks the widest that divides F and the alignment.
extern "C" int row_gather(const void* tab, const void* idx, void* out,
                          int64_t n, int T, int F, int vec, void* stream) {
  if (n == 0 || F == 0) return (int)cudaSuccess;
  if (vec <= 0 || F % vec != 0) return (int)cudaErrorInvalidValue;
  const int per_row = F / vec;
  const int64_t total = n * per_row;
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec == 4) {
    row_gather_kernel<float4><<<blocks_for(total), kThreads, 0, s>>>(
        (const float4*)tab, (const int*)idx, (float4*)out, n, T, per_row);
  } else if (vec == 2) {
    row_gather_kernel<float2><<<blocks_for(total), kThreads, 0, s>>>(
        (const float2*)tab, (const int*)idx, (float2*)out, n, T, per_row);
  } else if (vec == 1) {
    row_gather_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
        (const float*)tab, (const int*)idx, (float*)out, n, T, per_row);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
