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
// which reproduces the jitted JAX function bit for bit on the CPU.  The
// reductions are JAX's, not a search: they need no monotone CDF, and NaN
// propagates through them as through XLA's max and min.
//
// Bound on this card: device-memory traffic.  A ray reads 8 B per edge and
// writes 8 B per sample (sample and edge); at 4096 rays, E = 129 and n = 64
// that is ~6.3 MB, ~1.9 us at 3.35 TB/s.  The compares are E-1 per sample,
// ~33M at that shape, a few microseconds of the SMs' instruction rate.  In
// practice each thread's walk is a chain of dependent max/min, and its
// latency sets the time: ~0.03 ms at that shape on an H100 80GB HBM3 at
// 700 W (chip_smoke.py phase 1f, device time alone).
//
// Design (simple and right first): one block per ray.  The block stages the
// row's cdfs and vals in shared memory (coalesced), each thread walks its
// samples' E-1 compares over them (a broadcast read: all threads of a warp
// read the same word), writes its sample to shared memory and to the output,
// and after a barrier the block writes the n + 1 edges.  Left for later: a
// merge of the sorted sample positions against the edges in place of the
// linear walk, which a monotone CDF would allow.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// XLA's max and min: a NaN operand wins.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__global__ void importance_sampling_kernel(
    const float* __restrict__ vals, const float* __restrict__ cdfs,
    const float* __restrict__ bias, int E, int n, float* __restrict__ samples,
    float* __restrict__ edges) {
  extern __shared__ float sh[];
  float* sc = sh;          // the row's CDF values, E
  float* sv = sh + E;      // the row's edges, E
  float* ss = sh + 2 * E;  // the row's samples, n
  const int64_t r = blockIdx.x;
  const float* rc = cdfs + r * E;
  const float* rv = vals + r * E;
  for (int j = threadIdx.x; j < E; j += blockDim.x) {
    sc[j] = rc[j];
    sv[j] = rv[j];
  }
  __syncthreads();
  const float u_floor = sc[0];
  const float u_step =
      __fmul_rn(__fsub_rn(sc[E - 1], u_floor), __fdiv_rn(1.0f, (float)n));
  const float b = bias[r];
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const float u = __fmaf_rn(__fadd_rn((float)s, b), u_step, u_floor);
    int cnt = 0;
    float u_lo = -INFINITY, t_lo = -INFINITY, u_hi = INFINITY, t_hi = INFINITY;
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
    const float denom = __fsub_rn(u_hi, u_lo);
    float t;
    if (denom < 1e-10f) {
      t = __fmul_rn(0.5f, __fadd_rn(t_lo, t_hi));
    } else {
      t = __fadd_rn(
          __fdiv_rn(__fmul_rn(__fsub_rn(u, u_lo), __fsub_rn(t_hi, t_lo)), denom),
          t_lo);
    }
    ss[s] = t;
    samples[r * n + s] = t;
  }
  __syncthreads();
  const float t_min = sv[0], t_max = sv[E - 1];
  float* re = edges + r * (n + 1);
  for (int k = threadIdx.x; k <= n; k += blockDim.x) {
    float e;
    if (n == 1) {
      e = k == 0 ? t_min : t_max;
    } else if (k == 0) {
      e = max_nan(__fsub_rn(ss[0], __fmul_rn(0.5f, __fsub_rn(ss[1], ss[0]))), t_min);
    } else if (k == n) {
      e = min_nan(
          __fadd_rn(ss[n - 1], __fmul_rn(0.5f, __fsub_rn(ss[n - 1], ss[n - 2]))),
          t_max);
    } else {
      e = __fmul_rn(0.5f, __fadd_rn(ss[k], ss[k - 1]));
    }
    re[k] = e;
  }
}

}  // namespace

// vals, cdfs (n_rays, E) f32; bias (n_rays,) f32; samples (n_rays, n);
// edges (n_rays, n + 1).  E >= 2, n >= 1; (2E + n) floats of shared memory
// per block, which the wrapper keeps within the 48 KB static limit.
extern "C" int importance_sampling(const void* vals, const void* cdfs,
                                   const void* bias, void* samples, void* edges,
                                   int n_rays, int E, int n, void* stream) {
  if (n_rays == 0) return (int)cudaSuccess;
  if (E < 2 || n < 1) return (int)cudaErrorInvalidValue;
  const int threads = n >= 128 ? 128 : ((n + 31) / 32) * 32;
  const size_t shared = sizeof(float) * (2 * (size_t)E + n);
  importance_sampling_kernel<<<n_rays, threads, shared, (cudaStream_t)stream>>>(
      (const float*)vals, (const float*)cdfs, (const float*)bias, E, n,
      (float*)samples, (float*)edges);
  return (int)cudaGetLastError();
}
