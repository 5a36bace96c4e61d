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
// rows it touches) are ~100 MiB, ~30 us at 3.35 TB/s.
//
// G6: level groups.  Its parent design (one thread per (sample, level), the
// level fastest, a warp on two samples x 16 levels) kept all sixteen 4 MiB
// level slices live at once, more than L2 holds, so most corner loads were
// 32-byte sector misses for 8 useful bytes.  Here:
// - a block takes kPass = 64 consecutive samples at a group of kGroup = 4
//   consecutive levels, kGroup lanes a sample (the level fastest), and the
//   blocks are numbered group-major, so the blocks resident at once read one
//   or two groups' slices (16-32 MiB), which stay in L2; a sample's four
//   float2 outputs are bytes 32 g .. 32 g + 31 of its output row, one whole
//   sector, written by one warp;
// - the x prime is 1, so a cell with even x index has its dx = 0 and dx = 1
//   corners on one row pair (2 m, 2 m + 1): one 16-byte load for both.
// The eight hashes and weights stay in registers (56 a thread, no spills).
// It sums the corners in the order c = 0..7 with explicitly rounded
// intrinsics, so it is bitwise equal to the PyTorch twin
// (nerfacc_tpu_torch/ops/hash_encode.py), which rounds each fused
// multiply-add once.  Measured on an H100 (PERF.md, the findings on G6):
// groups of two and of one levels were slower (more passes over x, sectors
// written in pieces), as were one thread a sample looping over its group's
// levels, level 0 gathered into shared memory, and loads that skip L1.
// G7: level-major, with merged updates.  Its parent design (one thread per
// (sample, level), the level fastest, eight float2 atomics each) kept all
// sixteen 4 MiB level slices of the gradient live at once, more than L2
// holds, and no two lanes of a warp on one row were neighbours.  Here:
// - a block takes kBwdSamples consecutive samples at one level, and the
//   blocks are numbered level-major, so the blocks resident at once share one
//   or a few levels' slices, which stay in L2;
// - a warp holds 32 consecutive samples at one level.  In the ray order of a
//   train step neighbouring samples share corner rows at the coarse and
//   middle levels: per corner, each run of equal rows on neighbouring lanes
//   is summed by a segmented shuffle scan (as many steps as the longest run
//   needs, none where no two neighbours agree) and issues one atomic;
// - a level whose cube of corner cells, (res + 1)^3 float2, fits kStageBytes
//   (res 16: 4,913 cells, 39 KB) is summed in shared memory, indexed by the
//   unhashed cell; at the end each nonzero cell goes to its hashed row with
//   one atomic (cells that hash to one row still add there).  A corner
//   outside the cube (x is not clamped) goes straight to a global atomic;
// - on the other levels the atomics are float4 adds on pairs of rows (2 m,
//   2 m + 1): the x prime is 1, so a cell with even x index has its dx = 0
//   and dx = 1 corners on one pair, and those two corners take one atomic.
//   A sample takes 6 atomics in place of 8 on average.
// What bounds it then is the count of atomics the L2 retires (60-65 G a
// second on an H100 at the field's shape, PERF.md), not bytes.  Its sums run
// in atomic order, which varies from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// tcnn's spatial hash of a corner cell, in uint32 (a corner below 0 wraps).
__device__ __forceinline__ uint32_t spatial_hash(int cx, int cy, int cz) {
  return ((uint32_t)cx * 1u) ^ ((uint32_t)cy * 2654435761u) ^
         ((uint32_t)cz * 805459861u);
}

struct Corners {
  uint32_t row[8];  // row of the (L*T, 2) flat table
  float w[8];
  int i0[3];        // the cell of corner 0
};

__device__ __forceinline__ Corners corners(const float* __restrict__ x,
                                           const float* __restrict__ res,
                                           int64_t s, int l, int log2T) {
  const float r = res[l];
  Corners c;
  float f[3];
  for (int a = 0; a < 3; ++a) {
    const float pos = __fmul_rn(x[s * 3 + a], r);
    const float fl = floorf(pos);
    c.i0[a] = (int)fl;
    f[a] = __fsub_rn(pos, fl);
  }
  const uint32_t mask = (1u << log2T) - 1u;
  const uint32_t base = (uint32_t)l << log2T;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = (k >> 2) & 1, dy = (k >> 1) & 1, dz = k & 1;
    const uint32_t h = spatial_hash(c.i0[0] + dx, c.i0[1] + dy, c.i0[2] + dz);
    c.row[k] = base + (h & mask);
    const float wx = dx ? f[0] : __fsub_rn(1.0f, f[0]);
    const float wy = dy ? f[1] : __fsub_rn(1.0f, f[1]);
    const float wz = dz ? f[2] : __fsub_rn(1.0f, f[2]);
    c.w[k] = __fmul_rn(__fmul_rn(wx, wy), wz);
  }
  return c;
}

constexpr int kThreads = 256;  // G6
constexpr int kGroup = 4;      // G6: levels a block takes
constexpr int kPass = kThreads / kGroup;  // G6: samples a block takes

// The eight corner rows of one (sample, level), corners dx-major.  With
// `pairs`, corners k and k + 4 of a cell with even x index lie on one row
// pair (2 m, 2 m + 1) (the x prime is 1), so the pair of corner k is one
// 16-byte load that holds corner k + 4 too; a cell with odd x index loads
// corner k + 4 on its own.  Every load is issued before any result is used
// (the odd cells' loads are predicated, not behind a branch).
__device__ __forceinline__ void corner_rows(const float2* __restrict__ table,
                                            const Corners& c, bool pairs,
                                            float2 (&v)[8]) {
  if (!pairs) {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __ldg(table + c.row[k]);
    return;
  }
  const float4* t4 = reinterpret_cast<const float4*>(table);
  const bool odd = c.i0[0] & 1;
  float4 p[4];
  float2 o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) p[k] = __ldg(t4 + (c.row[k] >> 1));
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = odd ? __ldg(table + c.row[k + 4]) : make_float2(0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool hi = c.row[k] & 1u;
    v[k] = hi ? make_float2(p[k].z, p[k].w) : make_float2(p[k].x, p[k].y);
    v[k + 4] = odd ? o[k] : (hi ? make_float2(p[k].x, p[k].y) : make_float2(p[k].z, p[k].w));
  }
}

// Block b takes levels kGroup g .. kGroup g + kGroup - 1, g = b / per_group,
// of kPass consecutive samples, kGroup lanes a sample (the level fastest):
// the blocks are numbered group-major, so the blocks resident at once read
// one or two groups' table slices, and a sample's kGroup float2 outputs are
// one 32-byte sector written by one warp.
__global__ void __launch_bounds__(kThreads) hash_fwd_kernel(
    const float* __restrict__ x, const float2* __restrict__ table,
    const float* __restrict__ res, float2* __restrict__ out, int64_t n, int L,
    int log2T, int per_group, bool pairs) {
  const int grp = blockIdx.x / per_group;
  const int64_t s = (int64_t)(blockIdx.x - grp * per_group) * kPass + threadIdx.x / kGroup;
  const int l = grp * kGroup + (int)(threadIdx.x % kGroup);
  if (s >= n || l >= L) return;
  const Corners c = corners(x, res, s, l, log2T);
  float2 v[8];
  corner_rows(table, c, pairs, v);
  // one chain of fused multiply-adds per feature, corners in order
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a0 = __fmaf_rn(c.w[k], v[k].x, a0);
    a1 = __fmaf_rn(c.w[k], v[k].y, a1);
  }
  out[s * L + l] = make_float2(a0, a1);
}

// Adds lane + d's v into this lane's where `take`.
__device__ __forceinline__ void add_from(float2& v, int d, bool take) {
  const float px = __shfl_down_sync(kFull, v.x, d);
  const float py = __shfl_down_sync(kFull, v.y, d);
  if (take) {
    v.x = __fadd_rn(v.x, px);
    v.y = __fadd_rn(v.y, py);
  }
}

__device__ __forceinline__ void add_from(float4& v, int d, bool take) {
  const float px = __shfl_down_sync(kFull, v.x, d);
  const float py = __shfl_down_sync(kFull, v.y, d);
  const float pz = __shfl_down_sync(kFull, v.z, d);
  const float pw = __shfl_down_sync(kFull, v.w, d);
  if (take) {
    v.x = __fadd_rn(v.x, px);
    v.y = __fadd_rn(v.y, py);
    v.z = __fadd_rn(v.z, pz);
    v.w = __fadd_rn(v.w, pw);
  }
}

// Sums v over each run of equal `key` on neighbouring lanes of the warp
// (`valid` lanes only; every lane must call it).  Returns true on the lane
// that starts a run, which then holds the run's sum in v: a segmented
// suffix scan, step d adding lane + d's partial where lanes lane + 1 ..
// lane + d continue the run, for as many steps as the longest run needs.
template <class V>
__device__ __forceinline__ bool merge_run(uint32_t key, V& v, unsigned valid,
                                          int lane) {
  const uint32_t prev = __shfl_up_sync(kFull, key, 1);
  // a lane that is not valid, or follows one, starts a run
  const unsigned heads =
      __ballot_sync(kFull, lane == 0 || key != prev) | ~valid | (~valid << 1);
  // bit i of m: lanes i + 1 .. i + d all continue lane i's run
  unsigned m = ~heads >> 1;
  for (int d = 1; m != 0; d <<= 1) {
    add_from(v, d, (m >> lane) & 1u);
    m &= m >> d;
  }
  return ((heads & valid) >> lane) & 1u;
}

// v into the half (row & 1) of a float4 over the row pair (row & ~1, row | 1).
__device__ __forceinline__ void add_half(float4& a, uint32_t row, float2 v) {
  if (row & 1u) {
    a.z = __fadd_rn(a.z, v.x);
    a.w = __fadd_rn(a.w, v.y);
  } else {
    a.x = __fadd_rn(a.x, v.x);
    a.y = __fadd_rn(a.y, v.y);
  }
}

constexpr int kBwdThreads = 512;    // G7
constexpr int kBwdSamples = 4096;   // consecutive samples a G7 block takes
// Shared memory a G7 block may stage a level's cube of corner cells in: res
// 16 (4,913 cells, 39,304 bytes) fits.  Staging res 23 too (112 KB, two
// blocks an SM) was no faster on an H100 (PERF.md, the findings on G7).
constexpr int kStageBytes = 48 * 1024;

// Block b takes samples kBwdSamples * (b % blocks_per_level) onwards at level
// b / blocks_per_level; kStageBytes of dynamic shared memory hold the cube
// where the level's fits.  On a level not staged, the corners dx = 0 and
// dx = 1 of a cell with even x index hash to the rows 2 m and 2 m + 1 (the x
// prime is 1), so with `pairs` each update is a float4 atomic on a row pair:
// one for both corners there, one with a zero half for each elsewhere.
__global__ void __launch_bounds__(kBwdThreads) hash_bwd_kernel(
    const float* __restrict__ x, const float2* __restrict__ cot,
    const float* __restrict__ res, float2* __restrict__ g_table, int64_t n,
    int L, int log2T, int blocks_per_level, bool pairs) {
  extern __shared__ float2 cube[];
  const int l = blockIdx.x / blocks_per_level;
  const int64_t first = (int64_t)(blockIdx.x - l * blocks_per_level) * kBwdSamples;
  const int lane = threadIdx.x & 31;
  // corner cells 0 .. res of the points in [0, 1)^3, per axis
  const int dim = (int)res[l] + 1;
  const bool staged =
      dim >= 1 && (int64_t)dim * dim * dim * (int64_t)sizeof(float2) <= kStageBytes;
  const int cells = staged ? dim * dim * dim : 0;
  for (int i = threadIdx.x; i < cells; i += kBwdThreads) cube[i] = make_float2(0.0f, 0.0f);
  if (staged) __syncthreads();
  float4* g_pairs = reinterpret_cast<float4*>(g_table);

  for (int it = 0; it < kBwdSamples / kBwdThreads; ++it) {
    const int64_t s = first + it * kBwdThreads + threadIdx.x;
    const unsigned valid = __ballot_sync(kFull, s < n);
    if (valid == 0) break;  // warp-uniform: later samples lie past n too
    Corners c = {};
    float2 g = make_float2(0.0f, 0.0f);
    if (s < n) {
      c = corners(x, res, s, l, log2T);
      g = cot[s * L + l];
    }
    float2 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = make_float2(__fmul_rn(c.w[k], g.x), __fmul_rn(c.w[k], g.y));
    if (pairs && !staged) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // corners k (dx = 0) and k + 4 (dx = 1)
        const uint32_t p0 = c.row[k] >> 1, p1 = c.row[k + 4] >> 1;
        float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
        add_half(a, c.row[k], v[k]);
        add_half(p1 == p0 ? a : b, c.row[k + 4], v[k + 4]);
        if (merge_run(p0, a, valid, lane)) atomicAdd(g_pairs + p0, a);
        const unsigned apart = __ballot_sync(kFull, p1 != p0) & valid;
        if (apart && merge_run(p1, b, apart, lane)) atomicAdd(g_pairs + p1, b);
      }
      continue;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (!merge_run(c.row[k], v[k], valid, lane)) continue;
      const int cx = c.i0[0] + ((k >> 2) & 1), cy = c.i0[1] + ((k >> 1) & 1),
                cz = c.i0[2] + (k & 1);
      if (staged && (unsigned)cx < (unsigned)dim && (unsigned)cy < (unsigned)dim &&
          (unsigned)cz < (unsigned)dim) {
        float* cell = reinterpret_cast<float*>(cube + ((cx * dim) + cy) * dim + cz);
        atomicAdd(cell, v[k].x);
        atomicAdd(cell + 1, v[k].y);
      } else {
        atomicAdd(g_table + c.row[k], v[k]);
      }
    }
  }
  if (!staged) return;
  __syncthreads();
  const uint32_t mask = (1u << log2T) - 1u;
  const uint32_t base = (uint32_t)l << log2T;
  for (int i = threadIdx.x; i < cells; i += kBwdThreads) {
    const float2 v = cube[i];
    if (v.x != 0.0f || v.y != 0.0f) {  // NaN too; a zero adds nothing
      const int cz = i % dim, cy = (i / dim) % dim, cx = i / (dim * dim);
      atomicAdd(g_table + base + (spatial_hash(cx, cy, cz) & mask), v);
    }
  }
}

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
  const int64_t per_group = (n + kPass - 1) / kPass;
  const int64_t blocks = per_group * ((L + kGroup - 1) / kGroup);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // 16-byte row pairs need an even row count (T > 1) and an aligned table
  const bool pairs = log2T > 0 && (uintptr_t)table % 16 == 0;
  hash_fwd_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float2*)table, (const float*)res, (float2*)out, n,
      L, log2T, (int)per_group, pairs);
  return (int)cudaGetLastError();
}

// x (n, 3) f32, cot (n, 2L) f32, res (L,) f32; g_table (L, 2^log2T, 2) f32,
// zeroed by the caller, receives the sums.
extern "C" int hash_bwd(const void* x, const void* cot, const void* res,
                        void* g_table, int64_t n, int L, int log2T,
                        void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (!shape_ok(L, log2T)) return (int)cudaErrorInvalidValue;
  const int64_t per_level = (n + kBwdSamples - 1) / kBwdSamples;
  if (per_level * L > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // float4 atomics on row pairs need an even row count (T > 1) and 16-byte pairs
  const bool pairs = log2T > 0 && (uintptr_t)g_table % 16 == 0;
  hash_bwd_kernel<<<(unsigned)(per_level * L), kBwdThreads, kStageBytes,
                    (cudaStream_t)stream>>>(
      (const float*)x, (const float2*)cot, (const float*)res,
      (float2*)g_table, n, L, log2T, (int)per_level, pairs);
  return (int)cudaGetLastError();
}
