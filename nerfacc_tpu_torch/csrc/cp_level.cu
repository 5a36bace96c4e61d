// G1: CP-level encode, forward.
//
// Replaces: the Pallas TPU kernel nerfacc_tpu/ops/cp_level.py::_fwd_kernel,
// which builds a dense (BLK, R) hat-weight matrix per axis and contracts it
// with the (R, rank) line table on the matrix unit.  A hat row has only two
// nonzeros, so here each axis is a two-tap lerp:
//
//     out[n, r] = prod_a (w_a0 * L_a[i_a, r] + w_a1 * L_a[i_a + 1, r])
//     w_aj = max(0, 1 - |u[n, a] * (R - 1) - (i_a + j)|),  i_a = floor(...)
//
// Bound on this card: device-memory traffic.  A sample reads 12 B of
// coordinates and writes 4 * rank B of features (128 B at rank 32); six
// table rows are read per sample, but the tables ((3, R, rank) f32, at most
// 192 KiB at R = 512) stay resident in L2 and L1.
//
// Design: a group of lanes per sample, ceil(rank / 4) rounded up to a power
// of two and at most 32 (8 at rank 32, 4 at rank 16), a template parameter;
// lane c of a group owns rank columns 4 c .. 4 c + 3 (and every 4 * group
// further), so each tap row is one 16-byte load a lane and the output one
// 16-byte store (a group's stores are one 128-byte line at rank 32).  A rank
// that is not a multiple of 4, or a misaligned table or output, takes masked
// 4-byte loads and stores.  The sample index is a block and lane split (no
// division); each lane computes its sample's taps once, then issues its six
// row loads together.  No shared memory.  Its parent design, one thread per
// output element, spent about a hundred instructions per 4-byte output: a
// 64-bit division, the three taps again for each of the rank columns, six
// 4-byte loads and a 4-byte store.  Two or four samples a lane in flight
// (every row load of all of them issued before the first product) were
// 1.1-1.5x slower on an H100 than one (96-128 registers a thread at two):
// the occupancy they cost outweighed the loads they put in flight (PERF.md,
// the findings on G1).
//
// Numerics: in bf16 mode the hat weights and table values are rounded to
// bf16 (round to nearest even) and all products and sums are f32, as the TPU
// kernel's bf16-operand, f32-accumulate dot does.  The explicitly rounded
// intrinsics keep the compiler from contracting multiply-adds into FMAs, so
// the result is bitwise equal to the PyTorch twin in
// nerfacc_tpu_torch/ops/cp_level.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;  // rank columns a lane

// The two taps of one axis: offsets of their rows in the axis's table.
struct Tap {
  int r0, r1;
  float w0, w1;
};

template <bool kBf16>
__device__ __forceinline__ Tap tap(float u, int R, int rank) {
  const float pos = __fmul_rn(u, (float)(R - 1));
  int i0 = (int)floorf(pos);
  i0 = min(max(i0, 0), R - 1);
  const int i1 = i0 + 1;
  float w0 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(pos, (float)i0))));
  float w1 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(pos, (float)i1))));
  // At u = 1 the second tap is row R, past the table: drop it.
  const int i1c = i1 < R ? i1 : R - 1;
  if (i1 >= R) w1 = 0.0f;
  Tap t;
  t.r0 = i0 * rank;
  t.r1 = i1c * rank;
  t.w0 = kBf16 ? round_bf16(w0) : w0;
  t.w1 = kBf16 ? round_bf16(w1) : w1;
  return t;
}

// Columns col .. col + 3 of a row: one 16-byte load (kVec), else one load
// per column inside the rank.
template <bool kVec>
__device__ __forceinline__ float4 load_cols(const float* __restrict__ row,
                                            int col, int rank) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const float4*>(row + col));
  } else {
    float v[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) v[k] = col + k < rank ? __ldg(row + col + k) : 0.0f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool kBf16>
__device__ __forceinline__ float lerp(const Tap& t, float l0, float l1) {
  if (kBf16) {
    l0 = round_bf16(l0);
    l1 = round_bf16(l1);
  }
  return __fadd_rn(__fmul_rn(t.w0, l0), __fmul_rn(t.w1, l1));
}

// A warp takes 32 / kCw samples, one to each group of kCw lanes.
template <int kCw, bool kVec, bool kBf16>
__global__ void __launch_bounds__(kThreads) cp_level_fwd_kernel(
    const float* __restrict__ u, const float* __restrict__ lines,
    float* __restrict__ out, int64_t n, int R, int rank) {
  const int lane = threadIdx.x & 31;
  const int c = lane & (kCw - 1);
  const int64_t s =
      ((int64_t)blockIdx.x * kWarps + threadIdx.x / 32) * (32 / kCw) + lane / kCw;
  if (s >= n) return;
  const int64_t table = (int64_t)R * rank;
  Tap t[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) t[a] = tap<kBf16>(u[s * 3 + a], R, rank);
  for (int col = kCols * c; col < rank; col += kCols * kCw) {
    float4 l0[3], l1[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float* line = lines + a * table;
      l0[a] = load_cols<kVec>(line + t[a].r0, col, rank);
      l1[a] = load_cols<kVec>(line + t[a].r1, col, rank);
    }
    float acc[kCols] = {1.0f, 1.0f, 1.0f, 1.0f};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      acc[0] = __fmul_rn(acc[0], lerp<kBf16>(t[a], l0[a].x, l1[a].x));
      acc[1] = __fmul_rn(acc[1], lerp<kBf16>(t[a], l0[a].y, l1[a].y));
      acc[2] = __fmul_rn(acc[2], lerp<kBf16>(t[a], l0[a].z, l1[a].z));
      acc[3] = __fmul_rn(acc[3], lerp<kBf16>(t[a], l0[a].w, l1[a].w));
    }
    float* o = out + s * rank + col;
    if constexpr (kVec) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (col + k < rank) o[k] = acc[k];
    }
  }
}

template <int kCw>
cudaError_t launch(const float* u, const float* lines, float* out, int64_t n,
                   int R, int rank, bool vec, bool bf16, cudaStream_t st) {
  constexpr int64_t per_block = (int64_t)kWarps * (32 / kCw);
  const int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  if (vec && bf16)
    cp_level_fwd_kernel<kCw, true, true><<<grid, kThreads, 0, st>>>(u, lines, out, n, R, rank);
  else if (vec)
    cp_level_fwd_kernel<kCw, true, false><<<grid, kThreads, 0, st>>>(u, lines, out, n, R, rank);
  else if (bf16)
    cp_level_fwd_kernel<kCw, false, true><<<grid, kThreads, 0, st>>>(u, lines, out, n, R, rank);
  else
    cp_level_fwd_kernel<kCw, false, false><<<grid, kThreads, 0, st>>>(u, lines, out, n, R, rank);
  return cudaGetLastError();
}

}  // namespace

// u (n, 3), lines (3, R, rank) f32 -> out (n, rank) f32.
extern "C" int cp_level_fwd(const void* u, const void* lines, void* out,
                            int64_t n, int R, int rank, int bf16,
                            void* stream) {
  if (n == 0) return (int)cudaSuccess;
  // row offsets within a table are 32-bit
  if (R < 1 || rank < 1 || (int64_t)R * rank > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // lanes a sample: ceil(rank / 4) rounded up to a power of two, at most 32
  int cw = 1;
  while (kCols * cw < rank && cw < 32) cw *= 2;
  const bool vec = rank % kCols == 0 && ((uintptr_t)lines | (uintptr_t)out) % 16 == 0;
  const float* pu = (const float*)u;
  const float* pl = (const float*)lines;
  float* po = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (cw) {
    case 1: err = launch<1>(pu, pl, po, n, R, rank, vec, bf16, st); break;
    case 2: err = launch<2>(pu, pl, po, n, R, rank, vec, bf16, st); break;
    case 4: err = launch<4>(pu, pl, po, n, R, rank, vec, bf16, st); break;
    case 8: err = launch<8>(pu, pl, po, n, R, rank, vec, bf16, st); break;
    case 16: err = launch<16>(pu, pl, po, n, R, rank, vec, bf16, st); break;
    default: err = launch<32>(pu, pl, po, n, R, rank, vec, bf16, st); break;
  }
  return (int)err;
}

extern "C" const char* nerfacc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
