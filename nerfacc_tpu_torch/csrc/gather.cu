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
//
//   G11: out[n] = f32(bf16(S[row[n], lane[n]])), 0 where row or lane lies
//        outside the table (what the one-hot contraction gives: no one-hot
//        column matches).  The bf16 rounding is the TPU kernel's, which
//        multiplies S.astype(bf16).
//   G12, G13: JAX's gather semantics (jnp.take / take_along_axis): an index
//        in [-T, 0) counts from the end, and one outside [-T, T) reads NaN.
//
// G11.  Bound: 4.2 MB at N = 2^18 (the two index streams, the output, the
// 1 MB table once), 1.25 us at 3.35 TB/s; its lookups touch ~8.4 MB of
// 32-byte L2 sectors of the L2-resident table.  The kernel is a few
// microseconds of latency (index load, then table load) plus the launch.
// Design: one lookup a thread, so a warp's index loads and stores are
// contiguous.  Four lookups a thread through 16-byte loads, their table
// reads in flight together, measured no faster: the time is the two
// dependent memory trips and the launch.  A cluster-staged table was not
// built: each cluster would read the 512 KB bf16 table to stage it, ~16 MB
// over the card against the 8.4 MB of sectors it saves.
//
// G12.  Bound: the idx stream read once and the output written once (4 + e
// bytes an element for e-byte words) plus the table, 1.08 GB at T = 2^14
// f32 (0.323 ms).  The route of one thread an element (the first design,
// kept as route 0) reads src[r, l] for a random r per element: a 32-byte L2
// sector for 4 bytes, 2^27 sectors (4.3 GB) at that shape, so L2 sector
// throughput bounds it, not device memory.  Design (the shared-memory
// route): blockIdx.y picks a group of columns, 32 or 16 bytes of each table
// row (8 f32 or 16 bf16 columns, or 8 bf16 columns); a block keeps the
// group's first Ts table rows, column-major, in shared memory (the byte
// budget the wrapper passes, SHARED_TABLE_BYTES in ops/lane_gather.py:
// 224 KB, Ts = 7168 rows of 32 bytes, 14336 of 16) and walks one chunk of
// idx rows, a thread a 16-byte piece of a row's group: four lookups, from
// shared memory for table rows below Ts and through L2 for the rest, and
// one 16- or 8-byte store, so that a warp's idx loads are whole sectors.
// Chunks: as many blocks as the card holds at once, each chunk at least
// Ts * sizeof(word) / 2 rows, so that staging the table costs at most half
// the chunk's idx bytes.  Where the routes end
// (ops/lane_gather.py::lane_gather_route): f32 takes 32-byte rows while
// half the table's rows fit (T <= 14336); bf16 takes them while three
// quarters fit (T <= 9557), then 16-byte rows (whose 8 int32 indices still
// fill a sector, all rows kept up to T = 14336) while half fit
// (T <= 28672).  Past that route 0 is the faster: each column group's
// 32-byte pieces of the 512-byte idx rows move slower than route 0's whole
// rows, and the lookups past Ts still pay their sectors.  So T = 2^14 f32,
// where a group's rows fit less than half, stays on route 0 and L2-bound.
// 16-byte rows of an f32 table (half-sector idx pieces) are no route: the
// launch refuses them.
//
// Also built while this design was chosen, and slower than route 0 at
// T = 2^14 f32: a cluster of 2-8 blocks keeping a group's 8 columns between
// them, with the lookups through distributed shared memory; with each
// tile's idx and results exchanged through distributed shared memory by
// stores; by TMA multicast or cp.async with bulk copies and mbarrier
// pipelines of 2-8 stages (a fixed cost of microseconds a tile); and a
// block keeping 4 f32 columns, reading and writing half sectors.
//
// No path of either package runs G11 or G12; they run at their own entry
// points and in chip_smoke.py's gather probe.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

__host__ __device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

// JAX's gather index rule: [-T, 0) wraps once, anything else outside reads
// the fill value.
__device__ __forceinline__ bool take_index(int idx, int T, int* row) {
  const int r = idx < 0 ? idx + T : idx;
  *row = r;
  return r >= 0 && r < T;
}

// ---------------------------------------------------------------- G11

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

// ---------------------------------------------------------------- G12

// Route 0: one thread an element.  Word is uint16_t for bf16 and uint32_t
// for f32: the bits are copied.
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

constexpr int kMaxDevices = 64;
constexpr int kGatherThreads = 512;
constexpr int kUnroll = 4;                 // pieces in flight a thread

__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t (&v)[4]) {
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store_words(uint16_t* p, const uint16_t (&v)[4]) {
  __stcs(reinterpret_cast<uint2*>(p),
         make_uint2(v[0] | ((uint32_t)v[1] << 16), v[2] | ((uint32_t)v[3] << 16)));
}

// The shared-memory route: the G columns of group blockIdx.y (G * sizeof(Word)
// = 32 or 16 bytes of a table row), the first Ts rows kept column-major in
// shared memory, the rest read through L2.
template <typename Word, int G>
__global__ void __launch_bounds__(kGatherThreads)
lane_gather_shared_kernel(const Word* __restrict__ src, const int* __restrict__ idx,
                          Word* __restrict__ out, int64_t n_rows, int T, int Ts,
                          int64_t rows_per_chunk, Word nan_bits) {
  constexpr int P = G / 4;  // 16-byte idx pieces a row
  extern __shared__ __align__(16) unsigned char smem[];
  Word* tab = reinterpret_cast<Word*>(smem);  // [G][Ts]
  const int col0 = blockIdx.y * G;
  for (int e = threadIdx.x; e < Ts * G; e += kGatherThreads) {
    const int r = e / G, j = e - r * G;
    tab[j * Ts + r] = src[(int64_t)r * 128 + col0 + j];
  }
  __syncthreads();
  const int64_t begin = blockIdx.x * rows_per_chunk;
  const int64_t pieces = P * imax(0, imin(n_rows, begin + rows_per_chunk) - begin);
  const int part = threadIdx.x % P;  // the strides are multiples of P
  const Word* cols = tab + 4 * part * Ts;
  const Word* src_g = src + col0 + 4 * part;
  const int* idx_g = idx + begin * 128 + col0 + 4 * part;
  Word* out_g = out + begin * 128 + col0 + 4 * part;
  for (int64_t u0 = threadIdx.x; u0 < pieces; u0 += kUnroll * kGatherThreads) {
    int4 id[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t u = u0 + k * kGatherThreads;
      if (u < pieces) id[k] = *reinterpret_cast<const int4*>(idx_g + (u / P) * 128);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t u = u0 + k * kGatherThreads;
      if (u < pieces) {
        const int ids[4] = {id[k].x, id[k].y, id[k].z, id[k].w};
        Word v[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          int r;
          v[m] = !take_index(ids[m], T, &r) ? nan_bits
                 : r < Ts                   ? cols[m * Ts + r]
                                            : __ldg(src_g + (int64_t)r * 128 + m);
        }
        store_words(out_g + (u / P) * 128, v);
      }
    }
  }
}

// table_bytes: the shared memory a block gives the table's rows.
template <typename Word, int G>
cudaError_t launch_shared(const Word* src, const int* idx, Word* out, int64_t n_rows, int T,
                          int table_bytes, Word nan_bits, cudaStream_t s) {
  // co-resident blocks, cached per device and shared-memory size
  static int active_of[kMaxDevices];
  static size_t smem_of[kMaxDevices];
  const int Ts = (int)imin(T, table_bytes / (G * (int)sizeof(Word)));
  if (Ts <= 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)Ts * G * sizeof(Word);
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  auto kernel = lane_gather_shared_kernel<Word, G>;
  if (smem_of[dev] != smem || active_of[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGatherThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    active_of[dev] = per_sm * sms;
    smem_of[dev] = smem;
  }
  // as many chunks of rows a group as the card holds blocks at once, each of
  // at least Ts * sizeof(Word) / 2 rows: staging costs at most half the
  // chunk's idx bytes
  const int groups = 128 / G;
  const int64_t min_rows = imax(1, (int64_t)Ts * (int64_t)sizeof(Word) / 2);
  const int64_t chunks = imax(1, imin(active_of[dev] / groups, n_rows / min_rows));
  kernel<<<dim3((unsigned)chunks, groups), kGatherThreads, smem, s>>>(
      src, idx, out, n_rows, T, Ts, (n_rows + chunks - 1) / chunks, nan_bits);
  return cudaGetLastError();
}

// route: 0, or the bytes of each table row a block keeps (32 or 16).
template <typename Word>
cudaError_t launch_lane_gather(const Word* src, const int* idx, Word* out, int64_t n_rows,
                               int T, int route, int table_bytes, Word nan_bits,
                               cudaStream_t s) {
  if (route == 0) {
    const int64_t n = n_rows * 128;
    lane_gather_kernel<Word><<<blocks_for(n), kThreads, 0, s>>>(src, idx, out, n, T, nan_bits);
    return cudaGetLastError();
  }
  if (route == 32)
    return launch_shared<Word, 32 / sizeof(Word)>(src, idx, out, n_rows, T, table_bytes,
                                                  nan_bits, s);
  if (route == 16)
    return launch_shared<Word, 16 / sizeof(Word)>(src, idx, out, n_rows, T, table_bytes,
                                                  nan_bits, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- G13

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

// route: 0 (one thread an element), or the bytes of each table row a block
// keeps in shared memory (32, or 16 for bf16), of at most table_bytes a
// block; idx 16-byte aligned for those.  elem_bytes: 4 (f32) or 2 (bf16).
extern "C" int lane_gather(const void* src, const void* idx, void* out,
                           int64_t n_rows, int T, int elem_bytes, int route,
                           int table_bytes, void* stream) {
  if (n_rows == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (elem_bytes == 4 && route != 16) {
    err = launch_lane_gather<uint32_t>((const uint32_t*)src, (const int*)idx,
                                       (uint32_t*)out, n_rows, T, route, table_bytes,
                                       0x7fc00000u, s);
  } else if (elem_bytes == 2) {
    err = launch_lane_gather<uint16_t>((const uint16_t*)src, (const int*)idx,
                                       (uint16_t*)out, n_rows, T, route, table_bytes,
                                       (uint16_t)0x7fc0u, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
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
