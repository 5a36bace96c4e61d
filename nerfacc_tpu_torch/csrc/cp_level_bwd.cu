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
// TPU kernel's `da.astype(bf16)`), and the sums are fixed point (below).  In
// f32 mode nothing is rounded before the sums.  The products are evaluated
// in the TPU kernel's order ((g * f_first) * f_second, axes in increasing
// order).
//
// Bound on this card: not the bytes (0.011 ms at 2^18 samples, R = 512) but
// the per-sample work and the scatter.  2^18 samples x 2 taps land on as few
// as 16 rows per axis, so adding straight into device memory would
// serialise on a few addresses.
//
// Sums in fixed point, so that two calls give the same bits and the kernel
// equals its plain version (ops/cp_level.py::cp_level_backward_plain) bit
// for bit, whatever the order in which blocks and warps add.  Each term
// w * da becomes the int64 round(w * (da * 2^k)), with one scale 2^k an
// axis and launch (ops/ordered_sums.py): 2^k puts the bound
// 2^(e_g + e_b + e_c + 1) of an axis's terms, from the largest finite |g|
// and |L_b|, times twice the sample count, below 2^62.  Integer sums do not
// depend on their order.  The quantum is about 2^-(62 - log2(2N)) of the
// bound: ~2^-43 at N = 2^18.  A term that is +-inf or NaN is kept apart, as
// flags per entry (1: +inf, 2: -inf, 4: NaN), and the entry comes out NaN,
// +inf or -inf as an f64 sum would.
//
// Design: one cooperative launch in three phases, a grid barrier between
// them (every block resident, so the barrier is safe):
// 1. the largest finite |g| and |L_b| by atomicMax on their bits (an
//    order-free reduction), a flag if any input is not finite, and in bf16
//    mode the tables rounded once into the workspace;
// 2. the sums.  A block of 1024 threads holds a private int64 copy of a
//    part of the (R, rank) tables in dynamic shared memory, and a bitmask
//    of the rows it touched.  A part is the three axes' tables, each over a
//    slice of the features, as wide as fits (at (512, 32): two slices of 16
//    features, 192 KiB; at (1024, 32) four of 8); where three tables of one
//    feature do not fit, one axis's, the axes in turn.  blockIdx.y picks the
//    part; the taps and lerps of all three axes are computed per sample in
//    every part.  The block's samples are cut into one contiguous run per
//    warp (per slice / 32 warps past slices of 32), each thread on one
//    feature r; a warp takes 32 / lanes samples at a time, lanes being the
//    slice's next power of two up to 32, each group of lanes its own run of
//    consecutive samples of a tile.  A warp walks its run in tiles of
//    32 samples: lane j computes the taps and hat weights of the tile's
//    sample j once for the warp and hands them out by shuffles, packed (the
//    rows of two axes in one word, and in bf16 mode both weights of an axis
//    in one).  Per sample a thread computes the three axes' lerps once,
//    reads g and the six table rows once, and forms the product cotangents
//    of its part's axes (K2's single visit per sample).  It keeps, per axis,
//    an int64 register sum for each of the current pair of rows; when the
//    sample's first row changes, the row the two pairs share stays in
//    registers (ray samples cross one row at a time) and the other goes to
//    shared memory, as two 32-bit atomics (a 64-bit one is a
//    compare-and-swap loop on this card).  The checks for non-finite terms
//    run only where phase 1 saw a non-finite input or a bound past f32's
//    range.  At the end the block adds the nonzero entries of the rows it
//    touched into a zeroed int64 table in device memory with 64-bit atomics
//    (coalesced, one row of the slice at a time);
// 3. each entry written as f32(f64(sum) * 2^-k), or its flagged value.
// The grid is as many blocks as the card holds at once, shared among the
// parts, capped so that each run gets at least one tile.  A table whose f32
// size is past the shared-memory opt-in limit is refused with
// cudaErrorInvalidValue.
//
// Against the f32-atomic design before it (PERF.md, the findings on G4): a
// separate first pass and last pass, 64-bit shared atomics and register
// spills made the first version of this one 1.31-1.77x slower; one launch,
// the split atomics, the carried row, tables rounded once, packed
// shuffles, consecutive samples for each group of lanes (so that the
// carried row applies at R = 512) and the unchecked loop won most of it
// back.
// Variants timed while the f32 design was chosen, each slower or no
// faster: four features a thread (16-byte loads, 512 threads), batches of
// 16 cotangent loads in flight, a cotangent load one sample ahead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// round_bf16 on the integer pipe (round to nearest even on the bits), bit
// for bit the same for every x but NaN, which it leaves as it is.
__device__ __forceinline__ float round_bf16_bits(float x) {
  const unsigned b = __float_as_uint(x);
  const unsigned r = (b + 0x7fffu + ((b >> 16) & 1u)) & 0xffff0000u;
  return x != x ? x : __uint_as_float(r);
}

// Taps of one axis, exactly as G1 computes them: rows i0 and i0 + 1, or
// i0 again (with w1 = 0) where i0 is the last row.
struct Taps {
  int i0;
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
  if (i1 >= R) w1 = 0.0f;  // u = 1: the tap at row R is dropped
  t.w0 = kBf16 ? round_bf16(w0) : w0;
  t.w1 = kBf16 ? round_bf16(w1) : w1;
  return t;
}

__device__ __forceinline__ int second_row(int i0, int R) { return i0 + (i0 < R - 1); }

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSumBits = 62;  // every entry's |sum| stays below 2^62
constexpr int kMaxExp = 127;  // 2^k an f32 normal

// e with x < 2^e, for the bits of a finite x >= 0: E - 126 for the biased
// exponent E (ops/ordered_sums.py::exponent_bound)
__device__ __forceinline__ int exponent_bound(unsigned bits) {
  return (int)(bits >> 23) - 126;
}

// The scale exponent k of axis a (ops/cp_level.py::scale_exponents):
// maxima[0] holds the largest finite |g|, maxima[1 + b] that of |L_b|, as
// bits; `bits` is the bit length of 2 n, plus one.
__device__ __forceinline__ int scale_exp(const unsigned* maxima, int a, int bits) {
  const int b = a == 0 ? 1 : 0, c = a == 2 ? 1 : 2;
  const int e = min(exponent_bound(maxima[0]) + exponent_bound(maxima[1 + b]) +
                        exponent_bound(maxima[1 + c]) + 1,
                    128);
  return min(kSumBits - bits - e, kMaxExp);
}

// Whether a term may be non-finite: maxima[4] is set where an input was,
// and a bound at 2^128 or past it may overflow f32 (below it the terms and
// their bf16 roundings are finite).
__device__ __forceinline__ bool needs_check(const unsigned* maxima) {
  const int e = exponent_bound(maxima[0]) + 1;
  const int e1 = exponent_bound(maxima[1]), e2 = exponent_bound(maxima[2]),
            e3 = exponent_bound(maxima[3]);
  return maxima[4] != 0u || e + max(e1 + e2, max(e1 + e3, e2 + e3)) >= 128;
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// 2^k as an f32 (-126 <= k <= 127 here)
__device__ __forceinline__ float pow2f(int k) { return __int_as_float((127 + k) << 23); }

// A non-finite term: its flag in entry e's byte.
__device__ __forceinline__ void flag_term(unsigned* flags, int e, float t) {
  const unsigned bit = t != t ? 4u : (t > 0.0f ? 1u : 2u);
  atomicOr(flags + e / 4, bit << (8 * (e % 4)));
}

// The flags of a sample's two terms on an axis, entries e0 and e0 + step:
// out of line, so that the rare non-finite case holds no registers in the
// sample loop.
__device__ __noinline__ void flag_terms(unsigned* flags, int e0, int step,
                                        float t0, float t1) {
  flag_term(flags, e0, t0);
  flag_term(flags, e0 + step, t1);
}

// One axis's pending register sums: rows i0 and second_row(i0) of the
// current run.
struct RowRun {
  int i0;
  long long s0, s1;
};

__device__ __forceinline__ void mark_row(unsigned* touched, int row) {
  const unsigned bit = 1u << (row & 31);
  if (!(touched[row >> 5] & bit)) atomicOr(&touched[row >> 5], bit);
}

// Adds v into the block's int64 entry at p and, on the thread of the
// slice's first feature, marks the entry's row.  A 64-bit add in shared
// memory is a compare-and-swap loop on this card; two 32-bit adds, the carry
// of the low word into the high one, are not, and their sum is the same.
__device__ __forceinline__ void shared_add(long long* p, long long v, unsigned* touched,
                                           int row, int lr) {
  if (lr == 0) mark_row(touched, row);
  if (v == 0) return;
  unsigned* w = reinterpret_cast<unsigned*>(p);
  const unsigned lo = (unsigned)v, hi = (unsigned)((unsigned long long)v >> 32);
  const unsigned old = atomicAdd(w, lo);
  atomicAdd(w + 1, hi + (old + lo < old ? 1u : 0u));
}

// Moves an axis's register sums to the run starting at row i0: a row the
// two runs share keeps its sum in registers (consecutive ray samples cross
// one row at a time), the others go to the block's table (rows of rs
// features).  i0 < 0 flushes both.
__device__ __forceinline__ void next_run(RowRun& run, int i0, long long* acc,
                                         unsigned* touched, int R, int rs, int lr) {
  if (run.i0 >= 0) {
    const int i1 = second_row(run.i0, R);
    if (i0 >= 0 && i0 == i1 && i1 != run.i0) {  // one row up: i1 stays
      shared_add(&acc[run.i0 * rs + lr], run.s0, touched, run.i0, lr);
      run = {i0, run.s1, 0};
      return;
    }
    if (i0 >= 0 && second_row(i0, R) == run.i0 && i0 != run.i0) {  // one row down
      shared_add(&acc[i1 * rs + lr], run.s1, touched, i1, lr);
      run = {i0, 0, run.s0};
      return;
    }
    shared_add(&acc[run.i0 * rs + lr], run.s0, touched, run.i0, lr);
    shared_add(&acc[i1 * rs + lr], run.s1, touched, i1, lr);
  }
  run = {i0, 0, 0};
}

// This thread's place in the grid, and the grid's threads: the first and
// last phases' loops over the whole grid.
__device__ __forceinline__ int64_t grid_thread() {
  return ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t grid_threads() {
  return (int64_t)gridDim.x * gridDim.y * blockDim.x;
}

// The bits of the largest finite |v[i]| this warp's lanes read (a loop
// over the whole grid, thread `first` of `stride`, 16-byte loads where v is
// aligned), reduced over the warp; `nonfinite` is set where a lane read a
// non-finite value.
__device__ __forceinline__ unsigned finite_abs_max_bits(const float* __restrict__ v,
                                                        int64_t count, int64_t first,
                                                        int64_t stride, bool& nonfinite) {
  auto take = [&nonfinite](unsigned m, float x) {
    const unsigned b = __float_as_uint(x) & 0x7fffffffu;
    nonfinite |= b >= 0x7f800000u;
    return b < 0x7f800000u ? max(m, b) : m;
  };
  unsigned m = 0u;
  int64_t head = 0;  // elements read as float4
  if ((reinterpret_cast<uintptr_t>(v) & 15) == 0) {
    head = count & ~int64_t(3);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    for (int64_t i = first; i < head / 4; i += stride) {
      const float4 q = v4[i];
      m = take(take(take(take(m, q.x), q.y), q.z), q.w);
    }
  }
  for (int64_t i = head + first; i < count; i += stride) m = take(m, v[i]);
  return __reduce_max_sync(kFull, m);
}

// The first phase: the largest finite |x| of g and of each axis's table, as
// bits, by atomicMax (maxima[0] and maxima[1 + a]): the order of a maximum
// does not change it; maxima[4] set if any is not finite.  In bf16 mode the
// tables are also written to `rounded`, rounded to bf16, for the second.
template <bool kBf16>
__device__ __forceinline__ void first_phase(const float* __restrict__ g, int64_t count,
                                            const float* __restrict__ lines, int64_t table,
                                            float* rounded, unsigned* maxima) {
  const int64_t first = grid_thread(), stride = grid_threads();
  bool nonfinite = false;
  const unsigned mg = finite_abs_max_bits(g, count, first, stride, nonfinite);
  if (threadIdx.x % 32 == 0 && mg != 0u) atomicMax(maxima, mg);
  unsigned m[3] = {0u, 0u, 0u};
  for (int64_t i = first; i < 3 * table; i += stride) {
    const float x = lines[i];
    const unsigned b = __float_as_uint(x) & 0x7fffffffu;
    const int a = (int)(i / table);
    if (b < 0x7f800000u) m[a] = max(m[a], b);
    nonfinite |= b >= 0x7f800000u;
    if (kBf16) rounded[i] = round_bf16(x);
  }
  if (nonfinite) atomicOr(maxima + 4, 1u);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const unsigned ma = __reduce_max_sync(kFull, m[a]);
    if (threadIdx.x % 32 == 0 && ma != 0u) atomicMax(maxima + 1 + a, ma);
  }
}

// The last phase: dlines[e] = f32(f64(sums[e]) * 2^-k[axis]), or the value
// its flags give.  The sums and flags were written by atomics, at L2: read
// them there.
__device__ __forceinline__ void last_phase(const long long* sums, const unsigned* flags,
                                           const unsigned* maxima, float* __restrict__ dlines,
                                           int64_t table, int bits) {
  const int64_t first = grid_thread(), stride = grid_threads();
  double unit[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    unit[a] = __longlong_as_double((long long)(1023 - scale_exp(maxima, a, bits)) << 52);
  for (int64_t i = first; i < 3 * table; i += stride) {
    const unsigned f = (__ldcg(flags + i / 4) >> (8 * (i % 4))) & 0xffu;
    const int a = (int)(i / table);
    float v = __double2float_rn(
        __dmul_rn(__ll2double_rn(__ldcg(sums + i)), a == 0 ? unit[0] : (a == 1 ? unit[1] : unit[2])));
    if (f != 0u)
      v = (f & 4u) || (f & 3u) == 3u ? __int_as_float(0x7fc00000)
                                     : ((f & 1u) ? INFINITY : -INFINITY);
    dlines[i] = v;
  }
}

// Waits until `target` blocks have arrived at `count`: a grid-wide barrier,
// which the cooperative launch makes safe (every block is resident).  The
// fences make each block's writes before it visible to every block after.
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    while (atomicAdd(count, 0u) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// One cooperative launch in three phases, with a grid barrier between
// them: the first pass (first_phase), the sums (below), and the writing of
// dlines (last_phase).  axes = 3: the block keeps all three tables; axes =
// 1: one, the axes in turn.  blockIdx.y = part: axis (axes = 1) part /
// slices, features rs (part % slices) onwards.  A run of samples belongs to warps_per_run
// warps, warp k of them on the slice's features 32 k + (lane % lanes),
// where lanes (a power of two, at most 32) covers the slice; a warp takes
// 32 / lanes samples at a time.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1) cp_level_bwd_kernel(
    const float* __restrict__ u, const float* __restrict__ g,
    const float* __restrict__ lines_in, float* rounded, float* __restrict__ dlines,
    unsigned long long* sums, unsigned* flags, unsigned* maxima, int n, int R,
    int rank, int axes, int slices, int rs, int lanes, int warps_per_run, int per_block,
    int per_run, int bits) {
  first_phase<kBf16>(g, (int64_t)n * rank, lines_in, (int64_t)R * rank, rounded, maxima);
  // in bf16 mode the second phase reads the rounded tables: written in this
  // launch, so by plain loads (no read-only cache), and never read before
  // by this block
  const float* lines = kBf16 ? rounded : lines_in;
  // [axes][R][rs] sums, then the row bitmasks, then 2^k of each axis
  extern __shared__ __align__(8) unsigned char smem[];
  long long* acc = reinterpret_cast<long long*>(smem);
  const int table = R * rs;
  const int words = (R + 31) / 32;
  unsigned* touched = reinterpret_cast<unsigned*>(acc + axes * table);
  float* scale = reinterpret_cast<float*>(touched + axes * words);
  const int a_lo = axes == 3 ? 0 : (int)blockIdx.y / slices;
  const int r_lo = ((int)blockIdx.y % slices) * rs;
  for (int i = threadIdx.x; i < axes * table; i += blockDim.x) acc[i] = 0;
  for (int i = threadIdx.x; i < axes * words; i += blockDim.x) touched[i] = 0u;
  grid_barrier(maxima + 5, gridDim.x * gridDim.y);
  if (threadIdx.x < 3) scale[threadIdx.x] = pow2f(scale_exp(maxima, threadIdx.x, bits));
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int run_id = warp / warps_per_run;
  // a warp takes 32 / lanes samples at a time, one to each group of lanes;
  // group `sub` takes the samples span sub .. span (sub + 1) - 1 of a tile
  // in order, so that its runs see consecutive samples
  const int span = lanes;
  const int sub = lane / lanes;
  const int lr = (warp % warps_per_run) * 32 + lane % lanes;  // feature in the slice
  const int r = r_lo + lr;
  const bool active = lr < rs && r < rank;
  // sample indices, and n * rank, fit an int (the host checks)
  const int block_end = min(n, ((int)blockIdx.x + 1) * per_block);
  int s_begin = (int)blockIdx.x * per_block + run_id * per_run;
  if (run_id >= kWarps / warps_per_run) s_begin = block_end;  // spare warps
  const int s_end = min(block_end, s_begin + per_run);
  const int full = R * rank;  // one axis's table in device memory
  RowRun run[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) run[a] = {-1, 0, 0};
  // the sample loop, with the checks for non-finite terms only where the
  // first pass saw a non-finite input or a bound past f32's range
  auto walk = [&](auto check) {
  constexpr bool kCheck = decltype(check)::value;
  for (int base = s_begin; base < s_end; base += 32) {
    // lane j computes the taps of sample base + j once for the whole warp,
    // packed for the shuffles: the rows of axes 0 and 1 in one word (R <
    // 2^16), and in bf16 mode both weights of an axis in one word
    const int tile = min(32, s_end - base);
    unsigned rows01 = 0u, rows2 = 0u, wa[3] = {}, wb[3] = {};
    if (lane < tile) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const Taps tb = taps<kBf16>(u[(base + lane) * 3 + b], R);
        if (b == 0) rows01 = (unsigned)tb.i0;
        if (b == 1) rows01 |= (unsigned)tb.i0 << 16;
        if (b == 2) rows2 = (unsigned)tb.i0;
        wa[b] = kBf16 ? (__float_as_uint(tb.w0) & 0xffff0000u) | (__float_as_uint(tb.w1) >> 16)
                      : __float_as_uint(tb.w0);
        wb[b] = __float_as_uint(tb.w1);
      }
    }
    for (int p = 0; p < span; ++p) {
      const int t = sub * span + p;
      Taps tp[3];
      const unsigned r01 = __shfl_sync(kFull, rows01, t);
      tp[0].i0 = (int)(r01 & 0xffffu);
      tp[1].i0 = (int)(r01 >> 16);
      tp[2].i0 = (int)__shfl_sync(kFull, rows2, t);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const unsigned w = __shfl_sync(kFull, wa[b], t);
        tp[b].w0 = __uint_as_float(kBf16 ? w & 0xffff0000u : w);
        tp[b].w1 = __uint_as_float(kBf16 ? w << 16 : __shfl_sync(kFull, wb[b], t));
      }
      if (t >= tile || !active) continue;
      const int s = base + t;
      float f[3];
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        // in bf16 mode the tables were rounded by the first pass
        const float* line = lines + b * full + r;
        const float l0 = line[tp[b].i0 * rank];
        const float l1 = line[second_row(tp[b].i0, R) * rank];
        f[b] = __fadd_rn(__fmul_rn(tp[b].w0, l0), __fmul_rn(tp[b].w1, l1));
      }
      const float gs = g[s * rank + r];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        if (axes == 1 && a != a_lo) continue;
        // the other two axes in increasing order: (g * f_first) * f_second
        float da = __fmul_rn(__fmul_rn(gs, f[a == 0 ? 1 : 0]), f[a == 2 ? 1 : 2]);
        if (kBf16) da = round_bf16_bits(da);
        if (tp[a].i0 != run[a].i0)
          next_run(run[a], tp[a].i0, acc + (a - a_lo) * table, touched + (a - a_lo) * words,
                   R, rs, lr);
        // the terms w * (da * 2^k); w <= 1, so they are finite where da is
        const float ds = __fmul_rn(da, scale[a]);
        const float t0 = __fmul_rn(tp[a].w0, ds), t1 = __fmul_rn(tp[a].w1, ds);
        if (!kCheck || isfinite(ds)) {
          run[a].s0 += __float2ll_rn(t0);
          run[a].s1 += __float2ll_rn(t1);
        } else {
          flag_terms(flags, a * full + tp[a].i0 * rank + r,
                     (second_row(tp[a].i0, R) - tp[a].i0) * rank, t0, t1);
        }
      }
    }
  }
  };
  if (needs_check(maxima))
    walk(Flag<true>());
  else
    walk(Flag<false>());
  if (active) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (axes == 1 && a != a_lo) continue;
      next_run(run[a], -1, acc + (a - a_lo) * table, touched + (a - a_lo) * words, R, rs, lr);
    }
  }
  __syncthreads();

  // the nonzero entries of the touched rows into the device table, one row
  // of the slice at a time
  for (int i = threadIdx.x; i < axes * table; i += blockDim.x) {
    const int row = i / rs, c = i - row * rs;
    const int ax = row / R, rr = row - ax * R;
    const long long v = acc[i];
    if (v == 0 || r_lo + c >= rank || !((touched[ax * words + rr / 32] >> (rr & 31)) & 1u))
      continue;
    atomicAdd(sums + (a_lo + ax) * full + rr * rank + r_lo + c,
              (unsigned long long)v);
  }
  grid_barrier(maxima + 5, 2 * gridDim.x * gridDim.y);
  last_phase((const long long*)sums, flags, maxima, dlines, full, bits);
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

// u (n, 3), g (n, rank), lines (3, R, rank) f32; dlines (3, R, rank) f32
// receives the gradient.  work: int64 words, zeroed: (3 R rank + 1) / 2 for
// the bf16-rounded tables (first, where the allocation's alignment keeps
// their rows on 128-byte lines), 3 R rank for the sums, (3 R rank + 7) / 8
// for the flags (a byte an entry) and 3 for the maxima, the non-finite
// flag and the grid barrier's count.
extern "C" int cp_level_bwd(const void* u, const void* g, const void* lines,
                            void* dlines, void* work, int64_t n, int R, int rank,
                            int bf16, void* stream) {
  DeviceLimits lim;
  cudaError_t err = device_limits(&lim);
  if (err != cudaSuccess) return (int)err;
  // rows are packed into 16 bits for the shuffles, and the sample and
  // cotangent indices are ints
  if (rank < 1 || rank > kThreads || R < 1 || R > 0xffff || n < 0 ||
      n * (rank > 3 ? rank : 3) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  // the contract: an f32 table that fits the opt-in limit
  if ((size_t)R * rank * sizeof(float) > (size_t)lim.smem_optin)
    return (int)cudaErrorInvalidValue;
  const int64_t table = (int64_t)R * rank;
  float* rounded = (float*)work;
  unsigned long long* sums = (unsigned long long*)work + (3 * table + 1) / 2;
  unsigned* flags = (unsigned*)(sums + 3 * table);
  unsigned* maxima = (unsigned*)(sums + 3 * table + (3 * table + 7) / 8);
  int bits = 1;  // the bit length of 2 n, plus one
  for (int64_t c = 2 * n; c != 0; c >>= 1) ++bits;

  const size_t words = (size_t)(R + 31) / 32;
  auto smem_for = [&](int axes, int rs) {
    return (size_t)axes * ((size_t)R * rs * sizeof(long long) + words * sizeof(unsigned)) +
           3 * sizeof(float);
  };
  // the three axes over the widest slice of features that fits, else one
  // axis at a time
  int axes = 3, rs = rank;
  while (smem_for(axes, rs) > (size_t)lim.smem_optin && rs > 1) rs = (rs + 1) / 2;
  if (smem_for(axes, rs) > (size_t)lim.smem_optin) {
    axes = 1;
    rs = rank;
    while (smem_for(axes, rs) > (size_t)lim.smem_optin && rs > 1) rs = (rs + 1) / 2;
  }
  size_t smem = smem_for(axes, rs);
  if (smem > (size_t)lim.smem_optin) return (int)cudaErrorInvalidValue;
  int slices = (rank + rs - 1) / rs;
  // lanes per sample: the slice's next power of two up to 32; past 32 a
  // sample's features span warps_per_run warps
  int lanes = 1;
  while (lanes < rs && lanes < 32) lanes *= 2;
  int warps_per_run = (rs + 31) / 32;
  const int runs = kWarps / warps_per_run;
  const void* kernel = bf16 ? (const void*)cp_level_bwd_kernel<true>
                            : (const void*)cp_level_bwd_kernel<false>;
  int per_sm = 0;  // blocks resident at once on one SM
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  per_sm = per_sm < 1 ? 1 : per_sm;
  int grid_y = (3 / axes) * slices;
  // every block resident at once (the grid barriers need it)
  if (grid_y > lim.sms * per_sm) return (int)cudaErrorInvalidValue;
  int64_t blocks_x = (int64_t)lim.sms * per_sm / grid_y;
  // at least one tile of 32 samples per run
  const int64_t most = (n + (int64_t)runs * 32 - 1) / ((int64_t)runs * 32);
  blocks_x = blocks_x < most ? blocks_x : most;
  blocks_x = blocks_x < 1 ? 1 : blocks_x;
  int per_block = (int)((n + blocks_x - 1) / blocks_x);
  int per_run = (per_block + runs - 1) / runs;
  int n32 = (int)n;
  const dim3 grid((unsigned)blocks_x, grid_y);
  void* args[] = {(void*)&u, (void*)&g, (void*)&lines, (void*)&rounded, (void*)&dlines,
                  (void*)&sums, (void*)&flags, (void*)&maxima, (void*)&n32, (void*)&R,
                  (void*)&rank, (void*)&axes, (void*)&slices, (void*)&rs, (void*)&lanes,
                  (void*)&warps_per_run, (void*)&per_block, (void*)&per_run, (void*)&bits};
  return (int)cudaLaunchCooperativeKernel(kernel, grid, dim3(kThreads), args, smem,
                                          (cudaStream_t)stream);
}
