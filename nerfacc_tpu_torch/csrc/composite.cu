// G3: sorted-segment volume compositing, forward; G5: its backward.
//
// Replaces: the JAX XLA path that the occupancy-grid renderer runs per ray
// chunk (nerfacc_tpu/utils/rendering.py::render_rays_with_occgrid):
// volrend.render_weight_from_density(indices_sorted=True), whose exclusive
// sum is ops/sorted_segments.py::exclusive_sum_sorted, followed by
// ops/sorted_segments.py::segment_sum_sorted of [rgb, 1, t_mid] * w.  On the
// TPU those are global prefix sums differenced at segment boundaries.
//
// Here each ray walks its own samples [seg_start, seg_end] of the sorted
// flat buffer once, in order:
//
//   sd    = min(sigma * (t_end - t_start), 40)     (the optical-depth cap)
//   alpha = 1 - exp(-sd)
//   T     = prefix_trans * exp(-sum of earlier sd of this ray)
//   w     = T * alpha
//
// and accumulates w * rgb, w and w * t_mid.  The running sum is local to the
// ray, so its rounding error is relative to the ray's own optical depth; the
// global-cumsum failure (transmittance above 1 on hard surfaces) cannot
// occur.  Slots past the last segment (fill id n_rays) are never touched.
//
// Bound on this card: device-memory reads, 24 B per sample (sigma, rgb,
// t_start, t_end), plus 4 B per sample when the weights are written.
//
// Design: one thread per ray, no shared memory.  Neighbouring threads walk
// neighbouring segments, so the reads of a warp are nearly contiguous when
// rays hold similar sample counts.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// min(sd, 40) as XLA's and PyTorch's minimum take it: a NaN stays NaN (an
// infinite density on a zero-length sample), where fminf would return 40.
__device__ __forceinline__ float cap_optical_depth(float sd) {
  return sd > 40.0f ? 40.0f : sd;
}

__global__ void composite_fwd_kernel(
    const float* __restrict__ t_starts, const float* __restrict__ t_ends,
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const int* __restrict__ seg_starts, const int* __restrict__ seg_ends,
    const float* __restrict__ prefix_trans, int n_rays,
    float* __restrict__ colors, float* __restrict__ opacities,
    float* __restrict__ depths, float* __restrict__ weights) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float prefix = prefix_trans != nullptr ? prefix_trans[r] : 1.0f;
  float optical_depth = 0.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, acc = 0.0f, dep = 0.0f;
  const int64_t end = seg_ends[r];
  for (int64_t i = seg_starts[r]; i <= end; ++i) {
    const float t0 = t_starts[i], t1 = t_ends[i];
    const float sd = cap_optical_depth(sigmas[i] * (t1 - t0));
    const float alpha = 1.0f - expf(-sd);
    const float w = expf(-optical_depth) * prefix * alpha;
    optical_depth += sd;
    c0 += w * rgbs[3 * i];
    c1 += w * rgbs[3 * i + 1];
    c2 += w * rgbs[3 * i + 2];
    acc += w;
    dep += w * (0.5f * (t0 + t1));
    if (weights != nullptr) weights[i] = w;
  }
  colors[3 * r] = c0;
  colors[3 * r + 1] = c1;
  colors[3 * r + 2] = c2;
  opacities[r] = acc;
  depths[r] = dep;
}

// G5: the backward of G3 for the sample densities and colours.
//
// Replaces: the VJPs that JAX's autodiff takes through
// nerfacc_tpu/volrend.py::render_transmittance_from_density (the sigma*dt
// cap at 40, exclusive_sum_sorted's custom VJP in
// nerfacc_tpu/ops/sorted_segments.py::_excl_bwd) and segment_sum_sorted's
// VJP (_seg_bwd).  With cotangents gc, go, gd of a ray's unnormalised colour,
// opacity and depth sums, and v_i = gc . rgb_i + go + gd * t_mid_i:
//
//   dL/drgb_i   = w_i * gc
//   dL/dsigma_i = delta_i * [sigma_i delta_i < 40]
//                 * (T_i exp(-sd_i) v_i - sum_{j > i, same ray} w_j v_j)
//
// The suffix sum is accumulated along the ray, walking its segment from the
// end: no difference of running totals is ever formed (the TPU path's
// _excl_bwd differences a global cumsum and needs an exact spread to survive
// the cancellation).  One thread per ray, two passes over its segment: the
// first recomputes T and w exactly as G3 does, writes dL/drgb, the
// first term T exp(-sd) v (into dsigmas) and w v (into scratch); the second
// walks back, adding the suffix.  Slots outside every segment (fill, or past
// a budget cut) are never touched: the caller zeroes the outputs.
//
// Bound on this card: device memory, as G3: 24 B read per sample in the
// first pass, 16 B in the second, 24 B written.
__global__ void composite_bwd_kernel(
    const float* __restrict__ t_starts, const float* __restrict__ t_ends,
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const int* __restrict__ seg_starts, const int* __restrict__ seg_ends,
    const float* __restrict__ prefix_trans, int n_rays,
    const float* __restrict__ g_colors, const float* __restrict__ g_opacities,
    const float* __restrict__ g_depths, float* __restrict__ d_sigmas,
    float* __restrict__ d_rgbs, float* __restrict__ scratch) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float prefix = prefix_trans != nullptr ? prefix_trans[r] : 1.0f;
  const float gc0 = g_colors[3 * r], gc1 = g_colors[3 * r + 1],
              gc2 = g_colors[3 * r + 2];
  const float go = g_opacities[r], gd = g_depths[r];
  const int64_t start = seg_starts[r], end = seg_ends[r];
  float optical_depth = 0.0f;
  for (int64_t i = start; i <= end; ++i) {
    const float t0 = t_starts[i], t1 = t_ends[i];
    const float sd = cap_optical_depth(sigmas[i] * (t1 - t0));
    const float alpha = 1.0f - expf(-sd);
    const float trans = expf(-optical_depth) * prefix;
    const float w = trans * alpha;
    optical_depth += sd;
    const float r0 = rgbs[3 * i], r1 = rgbs[3 * i + 1], r2 = rgbs[3 * i + 2];
    const float v = gc0 * r0 + gc1 * r1 + gc2 * r2 + go + gd * (0.5f * (t0 + t1));
    d_rgbs[3 * i] = w * gc0;
    d_rgbs[3 * i + 1] = w * gc1;
    d_rgbs[3 * i + 2] = w * gc2;
    d_sigmas[i] = trans * expf(-sd) * v;
    scratch[i] = w * v;
  }
  float suffix = 0.0f;
  for (int64_t i = end; i >= start; --i) {
    const float delta = t_ends[i] - t_starts[i];
    const bool capped = !(sigmas[i] * delta < 40.0f);
    d_sigmas[i] = capped ? 0.0f : delta * (d_sigmas[i] - suffix);
    suffix += scratch[i];
  }
}

}  // namespace

// colors (n_rays, 3), opacities (n_rays,), depths (n_rays,): unnormalised
// sums.  prefix_trans (n_rays,) and weights (n_samples,) may be null.
extern "C" int composite_fwd(const void* t_starts, const void* t_ends,
                             const void* sigmas, const void* rgbs,
                             const void* seg_starts, const void* seg_ends,
                             const void* prefix_trans, int n_rays,
                             void* colors, void* opacities, void* depths,
                             void* weights, void* stream) {
  if (n_rays == 0) return (int)cudaSuccess;
  const int threads = 128;
  const int blocks = (n_rays + threads - 1) / threads;
  composite_fwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)t_starts, (const float*)t_ends, (const float*)sigmas,
      (const float*)rgbs, (const int*)seg_starts, (const int*)seg_ends,
      (const float*)prefix_trans, n_rays, (float*)colors, (float*)opacities,
      (float*)depths, (float*)weights);
  return (int)cudaGetLastError();
}

// Cotangents g_colors (n_rays, 3), g_opacities (n_rays,), g_depths
// (n_rays,); d_sigmas (n,) and d_rgbs (n, 3) zeroed by the caller; scratch
// (n,) uninitialised; prefix_trans may be null.
extern "C" int composite_bwd(const void* t_starts, const void* t_ends,
                             const void* sigmas, const void* rgbs,
                             const void* seg_starts, const void* seg_ends,
                             const void* prefix_trans, int n_rays,
                             const void* g_colors, const void* g_opacities,
                             const void* g_depths, void* d_sigmas,
                             void* d_rgbs, void* scratch, void* stream) {
  if (n_rays == 0) return (int)cudaSuccess;
  const int threads = 128;
  const int blocks = (n_rays + threads - 1) / threads;
  composite_bwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)t_starts, (const float*)t_ends, (const float*)sigmas,
      (const float*)rgbs, (const int*)seg_starts, (const int*)seg_ends,
      (const float*)prefix_trans, n_rays, (const float*)g_colors,
      (const float*)g_opacities, (const float*)g_depths, (float*)d_sigmas,
      (float*)d_rgbs, (float*)scratch);
  return (int)cudaGetLastError();
}
