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
// rounded to bf16, each product w g is exact in f32.  A block adds its
// products in fixed point: each is scaled by a power of two chosen from the
// largest |bf16(g)| the block has staged so far and rounded to an int64, the
// unit about 2^-49 of that value at 2^18 samples (a bit coarser for each
// doubling of a block's samples), so that the block's sums stay below 2^62.
// Integer sums do not depend on their order.
// The block's sums are rounded to f32 once, the blocks' partial sums are
// added in f64 in block order and the total rounded to f32 once: within a
// few f32 roundings of the block partials from the exact sum, which the
// PyTorch version rounds once, and two calls give the same bits.  A product
// that is +-inf or NaN is kept apart, as flags per entry, and the entry
// comes out NaN, +inf or -inf as an f64 sum would.  G10: g
// and the table are rounded to bf16, S at each tap is an f32 sum over the
// rank (serial within each lane's columns, then a butterfly over the
// lanes), then dx = (dW0 S0 + dW1 S1) (R - 1).  dW is
// exactly 0 at a grid point (pos - i = 0, and the neighbours at distance
// exactly 1 are excluded), so dx is 0 there, x = 0 and x = 1 included: the
// TPU kernel's rule, not the one-sided slope that autograd of the hat would
// give.
//
// Bounds on this card: device-memory traffic.  G8 writes 4 rank bytes per
// sample and axis (and a level's product), G9 and G10 read as many; the
// (R, rank) table (64 KiB at R = 512, rank 32) stays in L2 and L1.
//
// Designs.  G8: one kernel, instantiated for one table (kAxes = 1, the
// counterpart of the TPU kernel) and for one CP level (kAxes = 3: x (N, 3)
// read in place, the three axes' interpolants and their product
// (a_0 a_1) a_2 in one launch, the axes written only where a backward needs
// them).  Each sample takes a group of lanes, ceil(rank / 4) rounded up to a
// power of two (4 at rank 16, 8 at rank 32); lane c reads columns 4 c ..
// 4 c + 3 of the two tap rows by one 16-byte load each and writes one
// 16-byte store (masked 4-byte paths at other ranks or alignments); the taps
// are computed once per sample and the sample index is a block and lane
// split, with no division.  The tables stay in L1 and L2: staging them in
// shared memory as bf16 by a persistent grid made the level launch slower
// on an H100 at every TiNeuVox shape timed but one tie (PERF.md, the
// findings on G8).  Its parent design, one thread per output element, paid
// a 64-bit division, the taps again for each rank column and 4-byte loads
// and stores, and the encoder around it a column copy and a launch per axis
// and two product launches per level.
// G9: a scatter of 2 N taps into R rows, which on the TPU is a
// dense (R, BLK) x (BLK, rank) product per block of samples.  Here a
// persistent grid of 1024-thread blocks (as many as the SMs hold with the
// block's shared memory, at most one per tile) walks tiles of samples.  A
// tile's cotangent rows are staged in shared memory, rounded to bf16, by
// coalesced loads (lanes on consecutive rank columns, 8 floats per thread)
// that are issued for the next tile before the current one is added, so the
// loads overlap the adds; its taps are computed once per sample.  Each block
// holds one (R, rank) int64 table in shared memory (128 KiB at R = 512, rank
// 32).  A warp takes one sample at a time, two at rank 16: lanes are the
// rank columns, so the staged row is read without bank conflicts, and each
// lane adds its two products to its column with 64-bit shared-memory
// atomics.  The fixed point (Numerics) is what makes these atomics
// deterministic: with f32 atomics each block's sum would depend on the order
// of its warps.  The block converts its table to f32 and writes it to a
// scratch slab (no zeroing needed: each block writes all of it), and a
// second launch adds the slabs per entry in f64, in block order (32 slices
// per entry, then the slices in order), and rounds once.  No global atomics,
// no zeroing launch.  The table takes 9 bytes an entry: up to about 21,000
// entries (R * rank) fit the card's 227 KB beside a tile; a larger table is
// refused.
// G10: each sample takes a group of lanes, ceil(rank / 4) rounded up to a
// power of two and at most 32 (8 at rank 32, so 4 samples a warp; 4 at rank
// 16); lane c reads columns 4 c .. 4 c + 3 of the sample's g row and of its
// two table rows, one 16-byte load each where the rank is a multiple of 4
// and the rows are aligned (a warp's g loads are one contiguous 512 bytes),
// and adds its four products to each tap's sum in order; a __shfl_xor_sync
// butterfly within the group (3 steps at rank 32) adds the lanes' sums.  The
// table stays in L1 and L2.  One column a lane (5 butterfly steps, a 4-byte
// load per lane and row) was 2.4-3.4x slower alone on an H100 at every
// TiNeuVox shape (PERF.md, the kernel table and the findings on G10).
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

// G9's block: 32 warps; each thread stages kStage cotangent floats of a tile.
constexpr int kLineThreads = 1024;
constexpr int kStage = 8;
constexpr int kMaxTile = kLineThreads;  // one coordinate per thread
constexpr int kMaxLineRank = kStage * kLineThreads / 32;  // a tile holds 32 samples
constexpr unsigned kFull = 0xffffffffu;

// Loads tile t's cotangent floats and coordinates into registers.
__device__ __forceinline__ void fetch_tile(const float* __restrict__ x,
                                           const float* __restrict__ g,
                                           int64_t n, int rank, int tile,
                                           int64_t t, float (&staged)[kStage],
                                           float& xs) {
  const int64_t s0 = t * tile;
  const int cnt = (int)min((int64_t)tile, n - s0);
  const float* src = g + s0 * rank;
  const int elems = cnt * rank;
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int e = threadIdx.x + k * kLineThreads;
    staged[k] = e < elems ? src[e] : 0.0f;
  }
  xs = (int)threadIdx.x < cnt ? x[s0 + threadIdx.x] : 0.0f;
}

// Adds the exact product p to table entry e: in fixed point (p * scale,
// rounded to an int64), or, for +-inf and NaN, as a flag (1: +inf, 2: -inf,
// 4: NaN; one byte per entry).
__device__ __forceinline__ void add_product(long long* acc, unsigned* flags,
                                            int e, float p, double scale) {
  if (isfinite(p)) {
    atomicAdd(reinterpret_cast<unsigned long long*>(acc + e),
              (unsigned long long)__double2ll_rn((double)p * scale));
  } else {
    const unsigned bit = p != p ? 4u : (p > 0.0f ? 1u : 2u);
    atomicOr(flags + e / 4, bit << (8 * (e % 4)));
  }
}

__global__ void __launch_bounds__(kLineThreads, 1)
    hat_bwd_line_kernel(const float* __restrict__ x,
                        const float* __restrict__ g,
                        float* __restrict__ partials, int64_t n, int R,
                        int rank, int tile, int cw) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int table = R * rank;
  long long* acc = reinterpret_cast<long long*>(smem);  // (R, rank) fixed point
  unsigned* flags = reinterpret_cast<unsigned*>(acc + table);  // a byte each
  float* gt = reinterpret_cast<float*>(flags + (table + 3) / 4);  // (tile, rank)
  float* w0s = gt + tile * rank;  // (tile,) tap weights
  float* w1s = w0s + tile;
  int* i0s = reinterpret_cast<int*>(w1s + tile);  // (tile,) first tap rows
  __shared__ int warp_exp[kLineThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < table; i += kLineThreads) acc[i] = 0;
  for (int i = tid; i < (table + 3) / 4; i += kLineThreads) flags[i] = 0u;

  // a warp takes 32 / cw samples at a time, lane c of each the columns c,
  // c + cw, ...
  const int per_warp = 32 / cw, sub = lane / cw, c0 = lane % cw;
  const int64_t n_tiles = (n + tile - 1) / tile;
  // each entry takes at most one product per sample; 2^bits is at least
  // twice this block's samples, so its sums stay below 2^(62 - 1)
  const int64_t mine = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int bits = 65 - __clzll((unsigned long long)(mine * tile));
  int exp_cur = -1;  // the scale's biased bf16 exponent; -1: none yet

  float staged[kStage];
  float xs;
  int64_t t = blockIdx.x;
  fetch_tile(x, g, n, rank, tile, t, staged, xs);
  for (; t < n_tiles; t += gridDim.x) {
    const int cnt = (int)min((int64_t)tile, n - t * tile);
    __syncthreads();  // the previous tile's adds are done (and acc is zeroed)
    int ex = 0;  // the largest finite biased exponent this thread stages
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int e = tid + k * kLineThreads;
      if (e < cnt * rank) {
        const float v = round_bf16(staged[k]);
        gt[e] = v;
        const int be = (__float_as_int(v) >> 23) & 0xff;
        if (be != 0xff) ex = max(ex, be);
      }
    }
    ex = (int)__reduce_max_sync(kFull, (unsigned)ex);
    if (lane == 0) warp_exp[warp] = ex;
    if (tid < cnt) {
      const Taps tp = taps(xs, R);
      i0s[tid] = tp.i0;
      w0s[tid] = tp.w0;
      w1s[tid] = tp.w1;  // 0 where i0 + 1 is row R
    }
    __syncthreads();
    int ex_tile = 0;
    for (int w = 0; w < kLineThreads / 32; ++w) ex_tile = max(ex_tile, warp_exp[w]);
    if (ex_tile > exp_cur) {  // the same in every thread
      if (exp_cur >= 0) {  // a larger scale: shift the sums so far
        const int sh = ex_tile - exp_cur;
        for (int i = tid; i < table; i += kLineThreads)
          acc[i] = sh < 63 ? acc[i] >> sh : (acc[i] < 0 ? -1 : 0);
        __syncthreads();
      }
      exp_cur = ex_tile;
    }
    if (t + gridDim.x < n_tiles)
      fetch_tile(x, g, n, rank, tile, t + gridDim.x, staged, xs);
    // |bf16(g)| < 2^(exp_cur - 126), so each scaled product is below
    // 2^(62 - bits)
    const double scale = ldexp(1.0, 62 - bits - (exp_cur - 126));
    for (int s = warp * per_warp + sub; s < cnt; s += 32 * per_warp) {
      const int row = i0s[s];
      const float w0 = w0s[s], w1 = w1s[s];
      const float* gs = gt + s * rank;
      for (int c = c0; c < rank; c += cw) {
        const float gv = gs[c];
        if (w0 != 0.0f) add_product(acc, flags, row * rank + c, __fmul_rn(w0, gv), scale);
        if (w1 != 0.0f)
          add_product(acc, flags, (row + 1) * rank + c, __fmul_rn(w1, gv), scale);
      }
    }
  }
  __syncthreads();
  const double unit = ldexp(1.0, bits + (exp_cur - 126) - 62);
  float* slab = partials + (int64_t)blockIdx.x * table;
  for (int i = tid; i < table; i += kLineThreads) {
    const unsigned f = (flags[i / 4] >> (8 * (i % 4))) & 0xffu;
    float v = (float)((double)acc[i] * unit);
    if (f != 0u)
      v = (f & 4u) || (f & 3u) == 3u ? __int_as_float(0x7fc00000)
                                     : ((f & 1u) ? INFINITY : -INFINITY);
    slab[i] = v;
  }
}

// dline[e] = f32(sum over blocks b, in order, of f64(partials[b, e])): each
// block takes 32 entries; thread (e, y) sums the blocks y, y + 32, ..., then
// thread (e, 0) sums the 32 slices in order.
__global__ void hat_bwd_line_reduce_kernel(const float* __restrict__ partials,
                                           float* __restrict__ dline,
                                           int table, int blocks) {
  __shared__ double slices[32][33];
  const int e = blockIdx.x * 32 + threadIdx.x;
  double sum = 0.0;
  if (e < table)
    for (int b = threadIdx.y; b < blocks; b += 32)
      sum += (double)partials[(int64_t)b * table + e];
  slices[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && e < table) {
    double total = 0.0;
    for (int y = 0; y < 32; ++y) total += slices[y][threadIdx.x];
    dline[e] = (float)total;
  }
}

// G10's block: 8 warps; each lane takes four rank columns of a row.
constexpr int kXThreads = 256;
constexpr int kXCols = 4;

// Columns col .. col + 3 of one row, bf16-rounded: one 16-byte load where
// the rows are 16-byte aligned (kVec), else one load per column inside the
// rank and 0 past it.
template <bool kVec>
__device__ __forceinline__ void load_cols(const float* __restrict__ row,
                                          int col, int rank,
                                          float (&out)[kXCols]) {
  if constexpr (kVec) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + col));
    out[0] = round_bf16(v.x);
    out[1] = round_bf16(v.y);
    out[2] = round_bf16(v.z);
    out[3] = round_bf16(v.w);
  } else {
#pragma unroll
    for (int k = 0; k < kXCols; ++k)
      out[k] = col + k < rank ? round_bf16(__ldg(row + col + k)) : 0.0f;
  }
}

// Columns col .. col + 3 of one output row: one 16-byte store (kVec), else
// one store per column inside the rank.
template <bool kVec>
__device__ __forceinline__ void store_cols(float* __restrict__ row, int col,
                                           int rank, const float (&v)[kXCols]) {
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(row + col) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kXCols; ++k)
      if (col + k < rank) row[col + k] = v[k];
  }
}

// G8.  kAxes = 1: one table, x (n,), out = a_0.  kAxes = 3: one CP level,
// x (n, 3), lines (3, R, rank), out = (a_0 a_1) a_2, and with kKeep also
// a_0, a_1, a_2 into axes (3, n, rank).  A warp takes 32 / kCw samples,
// one to each group of kCw lanes; lane c of a group takes columns 4 c ..
// 4 c + 3, then every 4 kCw further.  Each lane computes its sample's taps
// once.
template <int kAxes, int kCw, bool kVec, bool kKeep>
__global__ void __launch_bounds__(kXThreads) hat_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ lines,
    float* __restrict__ out, float* __restrict__ axes, int64_t n, int R,
    int rank) {
  const int lane = threadIdx.x & 31;
  const int c = lane & (kCw - 1);
  const int64_t s =
      ((int64_t)blockIdx.x * (kXThreads / 32) + threadIdx.x / 32) * (32 / kCw) +
      lane / kCw;
  if (s >= n) return;
  const int64_t table = (int64_t)R * rank;
  Taps t[kAxes];
#pragma unroll
  for (int a = 0; a < kAxes; ++a) t[a] = taps(x[s * kAxes + a], R);
  for (int col = kXCols * c; col < rank; col += kXCols * kCw) {
    float f[kAxes][kXCols];
#pragma unroll
    for (int a = 0; a < kAxes; ++a) {
      const float* line = lines + a * table;
      float l0[kXCols], l1[kXCols];
      load_cols<kVec>(line + (int64_t)t[a].i0 * rank, col, rank, l0);
      load_cols<kVec>(line + (int64_t)t[a].i1 * rank, col, rank, l1);
#pragma unroll
      for (int k = 0; k < kXCols; ++k)
        f[a][k] = __fadd_rn(__fmul_rn(t[a].w0, l0[k]), __fmul_rn(t[a].w1, l1[k]));
    }
    if constexpr (kAxes == 1) {
      store_cols<kVec>(out + s * rank, col, rank, f[0]);
    } else {
      float prod[kXCols];
#pragma unroll
      for (int k = 0; k < kXCols; ++k)
        prod[k] = __fmul_rn(__fmul_rn(f[0][k], f[1][k]), f[2][k]);
      store_cols<kVec>(out + s * rank, col, rank, prod);
      if constexpr (kKeep) {
#pragma unroll
        for (int a = 0; a < kAxes; ++a)
          store_cols<kVec>(axes + (a * n + s) * rank, col, rank, f[a]);
      }
    }
  }
}

template <int kAxes, int kCw>
cudaError_t launch_fwd(const float* x, const float* lines, float* out,
                       float* axes, int64_t n, int R, int rank, bool vec,
                       cudaStream_t st) {
  constexpr int64_t per_block = (int64_t)(kXThreads / 32) * (32 / kCw);
  const int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)blocks;
  const bool keep = kAxes == 3 && axes != nullptr;
  if (keep && vec)
    hat_fwd_kernel<kAxes, kCw, true, kAxes == 3><<<grid, kXThreads, 0, st>>>(
        x, lines, out, axes, n, R, rank);
  else if (keep)
    hat_fwd_kernel<kAxes, kCw, false, kAxes == 3><<<grid, kXThreads, 0, st>>>(
        x, lines, out, axes, n, R, rank);
  else if (vec)
    hat_fwd_kernel<kAxes, kCw, true, false><<<grid, kXThreads, 0, st>>>(
        x, lines, out, axes, n, R, rank);
  else
    hat_fwd_kernel<kAxes, kCw, false, false><<<grid, kXThreads, 0, st>>>(
        x, lines, out, axes, n, R, rank);
  return cudaGetLastError();
}

template <int kAxes>
cudaError_t hat_fwd_axes(const void* x, const void* lines, void* out,
                         void* axes, int64_t n, int R, int rank, void* stream) {
  if (n == 0) return cudaSuccess;
  // row offsets are 32-bit within a table
  if (R < 1 || rank < 1 || (int64_t)R * rank > 0x7fffffff) return cudaErrorInvalidValue;
  // lanes a sample: ceil(rank / 4) rounded up to a power of two, at most 32
  int cw = 1;
  while (kXCols * cw < rank && cw < 32) cw *= 2;
  const bool vec = rank % kXCols == 0 &&
                   ((uintptr_t)lines | (uintptr_t)out | (uintptr_t)axes) % 16 == 0;
  const float* px = (const float*)x;
  const float* pl = (const float*)lines;
  float* po = (float*)out;
  float* pa = (float*)axes;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cw) {
    case 1: return launch_fwd<kAxes, 1>(px, pl, po, pa, n, R, rank, vec, st);
    case 2: return launch_fwd<kAxes, 2>(px, pl, po, pa, n, R, rank, vec, st);
    case 4: return launch_fwd<kAxes, 4>(px, pl, po, pa, n, R, rank, vec, st);
    case 8: return launch_fwd<kAxes, 8>(px, pl, po, pa, n, R, rank, vec, st);
    case 16: return launch_fwd<kAxes, 16>(px, pl, po, pa, n, R, rank, vec, st);
    default: return launch_fwd<kAxes, 32>(px, pl, po, pa, n, R, rank, vec, st);
  }
}

// Each sample takes a group of cw lanes (a power of two, at most 32); lane c
// of the group takes columns 4 c .. 4 c + 3, then every 4 cw further.
template <bool kVec>
__global__ void __launch_bounds__(kXThreads) hat_bwd_x_kernel(
    const float* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ line, float* __restrict__ dx, int64_t n, int R,
    int rank, int cw) {
  const int lane = threadIdx.x & 31;
  const int64_t first =
      ((int64_t)blockIdx.x * (kXThreads / 32) + threadIdx.x / 32) * (32 / cw);
  if (first >= n) return;  // warp-uniform
  const int64_t s = first + lane / cw;
  const int c = lane & (cw - 1);
  // a group past n runs on zero slopes: every lane reaches the shuffles
  Taps t = {0, 0, 0.0f, 0.0f, 0.0f, 0.0f};
  if (s < n) t = taps(x[s], R);
  float s0 = 0.0f, s1 = 0.0f;
  if (t.dw0 != 0.0f || t.dw1 != 0.0f) {  // the same in every lane of a group
    const float* gs = g + s * rank;
    const float* l0 = line + (int64_t)t.i0 * rank;
    const float* l1 = line + (int64_t)t.i1 * rank;
    for (int col = kXCols * c; col < rank; col += kXCols * cw) {
      float gv[kXCols], a[kXCols], b[kXCols];
      load_cols<kVec>(gs, col, rank, gv);
      load_cols<kVec>(l0, col, rank, a);
      load_cols<kVec>(l1, col, rank, b);
#pragma unroll
      for (int k = 0; k < kXCols; ++k) {
        s0 = __fmaf_rn(gv[k], a[k], s0);
        s1 = __fmaf_rn(gv[k], b[k], s1);
      }
    }
  }
  for (int o = cw / 2; o > 0; o >>= 1) {
    s0 = __fadd_rn(s0, __shfl_xor_sync(kFull, s0, o));
    s1 = __fadd_rn(s1, __shfl_xor_sync(kFull, s1, o));
  }
  if (s < n && c == 0) {
    const float sum = __fadd_rn(__fmul_rn(t.dw0, s0), __fmul_rn(t.dw1, s1));
    dx[s] = __fmul_rn(sum, (float)(R - 1));
  }
}

}  // namespace

// x (n,), line (R, rank) f32; out (n, rank) f32.
extern "C" int hat_fwd(const void* x, const void* line, void* out, int64_t n,
                       int R, int rank, void* stream) {
  return (int)hat_fwd_axes<1>(x, line, out, nullptr, n, R, rank, stream);
}

// One CP level: x (n, 3), lines (3, R, rank) f32; prod (n, rank) f32, the
// product (a_0 a_1) a_2 of the three axes' interpolants; axes (3, n, rank)
// f32 receives a_0, a_1 and a_2, or is null.
extern "C" int hat_level_fwd(const void* x, const void* lines, void* prod,
                             void* axes, int64_t n, int R, int rank,
                             void* stream) {
  return (int)hat_fwd_axes<3>(x, lines, prod, axes, n, R, rank, stream);
}

// x (n,), g (n, rank) f32; partials: scratch of max_blocks (R, rank) f32
// slabs, written before it is read; dline (R, rank) f32.  Two launches.  A
// table that does not fit the card's opt-in shared memory beside a tile, or
// a rank past kMaxLineRank, is refused with cudaErrorInvalidValue.
extern "C" int hat_bwd_line(const void* x, const void* g, void* partials,
                            void* dline, int64_t n, int R, int rank,
                            int max_blocks, void* stream) {
  if (R < 1 || rank < 1 || rank > kMaxLineRank)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, smem_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // a tile: kStage floats of g per thread, a multiple of 32 samples; lanes
  // per sample: rank rounded up to a power of two, at most 32
  const int fit = (kStage * kLineThreads / rank) / 32 * 32;
  const int tile = fit < kMaxTile ? fit : kMaxTile;
  int cw = 1;
  while (cw < rank && cw < 32) cw *= 2;
  const int table = R * rank;
  const size_t smem = (size_t)table * sizeof(long long) +
                      ((size_t)table + 3) / 4 * sizeof(unsigned) +
                      ((size_t)tile * rank + 3 * (size_t)tile) * sizeof(float);
  if (smem > (size_t)smem_optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(hat_bwd_line_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, hat_bwd_line_kernel, kLineThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t n_tiles = (n + tile - 1) / tile;
  const int64_t resident = (int64_t)per_sm * sms;
  const int blocks = (int)(n_tiles < resident ? n_tiles : resident);
  if (blocks > max_blocks) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (blocks > 0) {
    hat_bwd_line_kernel<<<blocks, kLineThreads, smem, st>>>(
        (const float*)x, (const float*)g, (float*)partials, n, R, rank, tile,
        cw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  hat_bwd_line_reduce_kernel<<<(table + 31) / 32, dim3(32, 32), 0, st>>>(
      (const float*)partials, (float*)dline, table, blocks);
  return (int)cudaGetLastError();
}

// x (n,), g (n, rank), line (R, rank) f32; dx (n,) f32.
extern "C" int hat_bwd_x(const void* x, const void* g, const void* line,
                         void* dx, int64_t n, int R, int rank, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  // lanes a sample: ceil(rank / 4) rounded up to a power of two, at most 32
  int cw = 1;
  while (kXCols * cw < rank && cw < 32) cw *= 2;
  const int64_t per_block = (int64_t)(kXThreads / 32) * (32 / cw);
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  const bool vec = rank % kXCols == 0 && ((uintptr_t)g | (uintptr_t)line) % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    hat_bwd_x_kernel<true><<<blocks, kXThreads, 0, st>>>(
        (const float*)x, (const float*)g, (const float*)line, (float*)dx, n, R,
        rank, cw);
  else
    hat_bwd_x_kernel<false><<<blocks, kXThreads, 0, st>>>(
        (const float*)x, (const float*)g, (const float*)line, (float*)dx, n, R,
        rank, cw);
  return (int)cudaGetLastError();
}
