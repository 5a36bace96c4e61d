// G14: inverse-transform importance sampling, batched layout, int count.
//
// Replaces: the XLA path nerfacc_tpu/pdf.py::importance_sampling (batched
// rows, an int sample count), which the proposal estimator runs once per
// proposal level and once for the final samples.  There it is a broadcast
// compare of every sample's CDF position against every edge of its row and
// masked max/min reductions, an (n_rays, n, E-1) pass chosen because row
// gathers are slow on the TPU.  Per ray r with edges vals[r, :E] and CDF
// values cdfs[r, :E], and bias b[r] (0.5, or one uniform draw when
// stratified):
//
//   u_step  = (cdfs[E-1] - cdfs[0]) * (1 / n)
//   u_s     = fma(s + b, u_step, cdfs[0])                 s = 0..n-1
//   over the row's first E-1 edges j:  le_j = cdfs[j] <= u_s
//   u_lo, t_lo = max of cdfs[j], vals[j] over le_j   (cdfs[0], vals[0] if none)
//   u_hi, t_hi = min of cdfs[j], vals[j] over !le_j  (cdfs[E-1], vals[E-1] if
//                                                     all E-1 are le)
//   sample_s = (u_hi - u_lo < 1e-10) ? 0.5 (t_lo + t_hi)
//                                   : (u_s - u_lo) (t_hi - t_lo) / (u_hi - u_lo) + t_lo
//   edges: the midpoints of consecutive samples, the first and last pushed
//          half a spacing outwards and clamped to [vals[0], vals[E-1]];
//          [vals[0], vals[E-1]] when n = 1.
//
// The step is a product with the f32 reciprocal of n and the position u a
// fused multiply-add, because XLA's CPU backend rewrites the division by a
// constant and contracts u so inside the JAX proposal trainer's jitted step
// (the JAX source writes (cdfs[E-1] - cdfs[0]) / n); every other operation
// is one explicitly rounded f32 operation, and max/min are exact, so the
// kernel is bitwise equal to its PyTorch version (nerfacc_tpu_torch/pdf.py),
// which reproduces the jitted JAX function bit for bit on the CPU.  It needs
// no monotone CDF, and NaN propagates through it as through XLA's max and
// min.
//
// Bound on this card: device-memory traffic.  A ray reads 8 B per edge and
// writes 8 B per sample (sample and edge); at 4096 rays, E = 129 and n = 64
// that is ~6.3 MB, ~1.9 us at 3.35 TB/s.  The first design (one block of 64
// or 128 threads a ray, every thread walking all E-1 edges for its sample
// with two NaN-aware max/min a step, two block barriers) issued ~3-4e8 lane
// instructions at that shape in dependent chains: 0.031 ms on an H100 80GB
// HBM3 at 700 W, 6% of the bound.
//
// Design: a warp per ray, several rays per block.  The warp stages its
// row's cdfs and vals in shared memory (coalesced)
// behind __syncwarp, with no block barrier, and votes (__all_sync) on
// whether the row is monotone: cdfs[j] <= cdfs[j+1] and vals[j] <= vals[j+1]
// for every j (so no NaN anywhere) and no -0.0 bit pattern anywhere.  On
// such a row the set {j < E-1 : cdfs[j] <= u} is a prefix {0 .. cnt-1}, and
// as max/min are exact and a tie of equal bits keeps equal bits, the masked
// reductions are the entries at its ends:
//   u_lo, t_lo = cdfs[max(cnt-1, 0)], vals[max(cnt-1, 0)]
//   u_hi, t_hi = cdfs[cnt], vals[cnt]            (cnt = E-1 included)
// bitwise, except where +0 and -0 tie (the reduction keeps the first seen),
// which the vote excludes.  cnt comes from a binary search over the staged
// row, ceil(log2(E)) shared loads.  A row that fails the vote takes the
// linear walk of the masked reductions.  A lane holds up to kPerLane samples
// of a chunk, lane-strided so that the stores coalesce, their searches
// independent; the edges between samples come from neighbouring lanes
// (__shfl_up_sync), at lane 0 from the last lane's sample of the round
// before, with no shared-memory round trip.  The outer edges' clamps are
// torch.maximum / torch.minimum's on the card, which the plain version runs
// (they differ from the reductions' max/min only where +0 and -0 tie).
// Half a warp a ray, a merge along a lane's consecutive samples in place
// of the search, and consecutive samples a lane were slower (PERF.md §6).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;    // warps (rays) a block when the rows fit
constexpr int kPerLane = 4;  // samples a lane per chunk, at most
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNegZero = 0x80000000u;

// XLA's max and min: a NaN operand wins.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

// The masked reductions over the row's first E-1 edges: any row.
__device__ __forceinline__ void walk(const float* sc, const float* sv, int E, float u,
                                     float& u_lo, float& t_lo, float& u_hi, float& t_hi) {
  int cnt = 0;
  u_lo = -INFINITY, t_lo = -INFINITY, u_hi = INFINITY, t_hi = INFINITY;
  for (int j = 0; j < E - 1; ++j) {
    const float c = sc[j], v = sv[j];
    if (c <= u) {
      ++cnt;
      u_lo = max_nan(c, u_lo);
      t_lo = max_nan(v, t_lo);
    } else {
      u_hi = min_nan(c, u_hi);
      t_hi = min_nan(v, t_hi);
    }
  }
  if (cnt == 0) {
    u_lo = sc[0];
    t_lo = sv[0];
  }
  if (cnt >= E - 1) {
    u_hi = sc[E - 1];
    t_hi = sv[E - 1];
  }
}

// cnt = #{j < E-1 : cdfs[j] <= u} on a monotone row: the first j < E-1
// whose cdfs[j] <= u fails, or E-1.
__device__ __forceinline__ int search(const float* sc, int E, float u) {
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sc[mid] <= u) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ float lerp_sample(float u, float u_lo, float t_lo, float u_hi,
                                             float t_hi) {
  const float denom = __fsub_rn(u_hi, u_lo);
  if (denom < 1e-10f) return __fmul_rn(0.5f, __fadd_rn(t_lo, t_hi));
  return __fadd_rn(
      __fdiv_rn(__fmul_rn(__fsub_rn(u, u_lo), __fsub_rn(t_hi, t_lo)), denom), t_lo);
}

// torch.maximum and torch.minimum on the card, for the outer edges' clamps:
// a NaN operand wins, else fmaxf / fminf, as those do (they differ from the
// XLA forms above only where +0 and -0 tie).
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__global__ void __launch_bounds__(kWarps * 32) importance_sampling_kernel(
    const float* __restrict__ vals, const float* __restrict__ cdfs,
    const float* __restrict__ bias, int64_t n_rays, int E, int n,
    float* __restrict__ samples, float* __restrict__ edges) {
  extern __shared__ float sh[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x / 32) + warp;
  if (r >= n_rays) return;  // the whole warp
  float* sc = sh + (size_t)warp * 2 * E;  // the row's CDF values, E
  float* sv = sc + E;                     // the row's edges, E
  const float* rc = cdfs + r * E;
  const float* rv = vals + r * E;
  for (int j = lane; j < E; j += 32) {
    sc[j] = rc[j];
    sv[j] = rv[j];
  }
  __syncwarp();
  bool ok = true;
  for (int j = lane; j < E; j += 32) {
    const float c = sc[j], v = sv[j];
    ok = ok && __float_as_uint(c) != kNegZero && __float_as_uint(v) != kNegZero;
    if (j + 1 < E) ok = ok && c <= sc[j + 1] && v <= sv[j + 1];
  }
  const bool monotone = __all_sync(kFull, ok);

  const float u_floor = sc[0];
  const float u_step =
      __fmul_rn(__fsub_rn(sc[E - 1], u_floor), __fdiv_rn(1.0f, (float)n));
  const float b = bias[r];
  const float t_min = sv[0], t_max = sv[E - 1];
  float* rs = samples + r * n;
  float* re = edges + r * (int64_t)(n + 1);
  // a chunk: m samples a lane, sample base + i * 32 + lane in s[i]
  const int m = min(kPerLane, (n + 31) / 32);
  float carry = 0.0f;  // the previous chunk's last sample
  for (int base = 0; base < n; base += 32 * m) {
    float s[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      s[i] = 0.0f;
      const int k = base + i * 32 + lane;
      if (i < m && k < n) {
        const float u = __fmaf_rn(__fadd_rn((float)k, b), u_step, u_floor);
        float u_lo, t_lo, u_hi, t_hi;
        if (monotone) {
          const int cnt = search(sc, E, u);
          const int l = cnt > 0 ? cnt - 1 : 0;
          u_lo = sc[l], t_lo = sv[l], u_hi = sc[cnt], t_hi = sv[cnt];
        } else {
          walk(sc, sv, E, u, u_lo, t_lo, u_hi, t_hi);
        }
        s[i] = lerp_sample(u, u_lo, t_lo, u_hi, t_hi);
        rs[k] = s[i];
      }
    }
    // sample 1, for the first edge where it lies in lane 1
    const float second = __shfl_down_sync(kFull, s[0], 1);
    float last = s[0];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      if (i >= m) break;
      // the sample before: the previous lane's, or at lane 0 the last lane's
      // of the round before (the previous chunk's last at the first round)
      const float up = __shfl_up_sync(kFull, s[i], 1);
      const float wrap = __shfl_sync(kFull, s[i > 0 ? i - 1 : 0], 31);
      const float prev = lane > 0 ? up : (i > 0 ? wrap : carry);
      const int k = base + i * 32 + lane;
      if (k < n) {
        if (k == 0) {
          re[0] = n == 1 ? t_min
                         : maximum(__fsub_rn(s[0], __fmul_rn(0.5f, __fsub_rn(second, s[0]))),
                                   t_min);
        } else {
          re[k] = __fmul_rn(0.5f, __fadd_rn(s[i], prev));
        }
        if (k == n - 1) {
          re[n] = n == 1 ? t_max
                         : minimum(__fadd_rn(s[i], __fmul_rn(0.5f, __fsub_rn(s[i], prev))),
                                   t_max);
        }
      }
      last = s[i];
    }
    carry = __shfl_sync(kFull, last, 31);
  }
}

// The largest row: (2 E) floats a ray within the 48 KB of static-sized
// dynamic shared memory, one ray a block at the limit.
constexpr int kMaxEdges = 48 * 1024 / (2 * 4);

}  // namespace

// vals, cdfs (n_rays, E) f32; bias (n_rays,) f32; samples (n_rays, n);
// edges (n_rays, n + 1).  2 <= E <= kMaxEdges (6144), n >= 1.
extern "C" int importance_sampling(const void* vals, const void* cdfs,
                                   const void* bias, void* samples, void* edges,
                                   int n_rays, int E, int n, void* stream) {
  if (n_rays == 0) return (int)cudaSuccess;
  if (E < 2 || n < 1 || E > kMaxEdges) return (int)cudaErrorInvalidValue;
  const int warps = min(kWarps, kMaxEdges / E);  // rays a block
  const size_t shared = sizeof(float) * 2 * (size_t)E * warps;
  const int blocks = (int)(((int64_t)n_rays + warps - 1) / warps);
  importance_sampling_kernel<<<blocks, warps * 32, shared, (cudaStream_t)stream>>>(
      (const float*)vals, (const float*)cdfs, (const float*)bias, n_rays, E, n,
      (float*)samples, (float*)edges);
  return (int)cudaGetLastError();
}
