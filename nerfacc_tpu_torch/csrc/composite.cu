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
// Bound on this card: device memory, 24 B read and 16 B written per sample
// (64 B with the first pass's reads counted once more for long rays).
//
// Design: one warp per ray.  The warp walks its segment in chunks of 32
// consecutive samples, lane l on sample 32 c + l, so each load of t_starts,
// t_ends and sigmas is one 128-byte line and a chunk's colours 384
// contiguous bytes.  Forward, chunk by chunk: each lane caps its optical
// depth (cap_optical_depth: a NaN stays NaN), an inclusive warp scan
// (__shfl_up_sync) shifted by one lane plus the carried total of the earlier
// chunks gives its exclusive optical depth, hence T, w, v and dL/drgb
// (stored coalesced through three shuffles).  Backward, last chunk first: a
// reverse warp scan of w v (__shfl_down_sync) shifted by one lane plus the
// carried sum of the later chunks gives sum_{j > i} w_j v_j.  Every sum runs
// within one ray: no difference of running totals is formed (the TPU path's
// _excl_bwd differences a global cumsum).  The optical depth is summed as a
// tree within each chunk, so it rounds differently from G3's serial walk.
// The first kBwdRegChunks chunks (256 samples) keep the first term
// T exp(-sd) v, w v and delta in registers; later chunks of a longer ray
// park the first two in d_sigmas and scratch (coalesced) and reread their
// interval and density on the way back.  Slots outside every segment (fill,
// or past a budget cut) are never touched: the caller zeroes the outputs.
constexpr int kBwdWarps = 8;       // rays per block
constexpr int kBwdRegChunks = 8;   // chunks of 32 samples kept in registers
constexpr unsigned kFull = 0xffffffffu;

// One lane's sample of a chunk in the forward recompute.
struct BwdSample {
  float first;  // T exp(-sd) v
  float wv;     // w v
  float delta;  // t_end - t_start
  bool capped;  // !(sigma delta < 40): no density gradient
};

__device__ __forceinline__ BwdSample composite_bwd_forward_chunk(
    const float* __restrict__ t_starts, const float* __restrict__ t_ends,
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    int64_t base, int64_t end, int lane, float prefix, float gc0, float gc1,
    float gc2, float go, float gd, float& carry, float* __restrict__ d_rgbs) {
  const int64_t i = base + lane;
  const bool valid = i <= end;
  float t0 = 0.0f, t1 = 0.0f, sigma = 0.0f, r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
  if (valid) {
    t0 = t_starts[i];
    t1 = t_ends[i];
    sigma = sigmas[i];
    r0 = rgbs[3 * i];
    r1 = rgbs[3 * i + 1];
    r2 = rgbs[3 * i + 2];
  }
  const float delta = t1 - t0;
  const float sd = valid ? cap_optical_depth(sigma * delta) : 0.0f;
  float incl = sd;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  const float before = __shfl_up_sync(kFull, incl, 1);
  const float excl = lane == 0 ? carry : carry + before;
  carry += __shfl_sync(kFull, incl, 31);
  const float e = expf(-sd);
  const float trans = expf(-excl) * prefix;
  const float w = trans * (1.0f - e);
  const float v = gc0 * r0 + gc1 * r1 + gc2 * r2 + go + gd * (0.5f * (t0 + t1));
  // dL/drgb for the chunk's 96 contiguous words: word f of the chunk is
  // component f % 3 of sample f / 3
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int f = lane + 32 * j;
    const int s = f / 3, k = f - 3 * s;
    const float ws = __shfl_sync(kFull, w, s);
    if (base + s <= end) d_rgbs[3 * base + f] = ws * (k == 0 ? gc0 : k == 1 ? gc1 : gc2);
  }
  BwdSample out;
  out.first = trans * e * v;
  out.wv = valid ? w * v : 0.0f;
  out.delta = delta;
  out.capped = !(sigma * delta < 40.0f);
  return out;
}

// The suffix sums of one chunk, last lane first; writes dL/dsigma.
__device__ __forceinline__ void composite_bwd_reverse_chunk(
    const BwdSample& smp, int64_t i, int64_t end, int lane, float& later,
    float* __restrict__ d_sigmas) {
  float incl = smp.wv;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_down_sync(kFull, incl, o);
    if (lane + o < 32) incl += y;
  }
  const float after = __shfl_down_sync(kFull, incl, 1);
  const float suffix = lane == 31 ? later : later + after;
  later += __shfl_sync(kFull, incl, 0);
  if (i <= end) d_sigmas[i] = smp.capped ? 0.0f : smp.delta * (smp.first - suffix);
}

__global__ void __launch_bounds__(kBwdWarps * 32) composite_bwd_kernel(
    const float* __restrict__ t_starts, const float* __restrict__ t_ends,
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const int* __restrict__ seg_starts, const int* __restrict__ seg_ends,
    const float* __restrict__ prefix_trans, int n_rays,
    const float* __restrict__ g_colors, const float* __restrict__ g_opacities,
    const float* __restrict__ g_depths, float* __restrict__ d_sigmas,
    float* __restrict__ d_rgbs, float* __restrict__ scratch) {
  const int r = blockIdx.x * kBwdWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= n_rays) return;  // warp-uniform
  const float prefix = prefix_trans != nullptr ? prefix_trans[r] : 1.0f;
  const float gc0 = g_colors[3 * r], gc1 = g_colors[3 * r + 1],
              gc2 = g_colors[3 * r + 2];
  const float go = g_opacities[r], gd = g_depths[r];
  const int64_t start = seg_starts[r], end = seg_ends[r];
  const int64_t chunks = end >= start ? (end - start) / 32 + 1 : 0;

  BwdSample kept[kBwdRegChunks];
  float carry = 0.0f;
#pragma unroll
  for (int c = 0; c < kBwdRegChunks; ++c) {
    if (c < chunks)
      kept[c] = composite_bwd_forward_chunk(
          t_starts, t_ends, sigmas, rgbs, start + 32 * c, end, lane, prefix,
          gc0, gc1, gc2, go, gd, carry, d_rgbs);
  }
  for (int64_t c = kBwdRegChunks; c < chunks; ++c) {
    const int64_t i = start + 32 * c + lane;
    const BwdSample smp = composite_bwd_forward_chunk(
        t_starts, t_ends, sigmas, rgbs, start + 32 * c, end, lane, prefix, gc0,
        gc1, gc2, go, gd, carry, d_rgbs);
    if (i <= end) {
      d_sigmas[i] = smp.first;
      scratch[i] = smp.wv;
    }
  }

  float later = 0.0f;
  for (int64_t c = chunks - 1; c >= kBwdRegChunks; --c) {
    const int64_t i = start + 32 * c + lane;
    BwdSample smp = {0.0f, 0.0f, 0.0f, true};
    if (i <= end) {
      smp.first = d_sigmas[i];
      smp.wv = scratch[i];
      smp.delta = t_ends[i] - t_starts[i];
      smp.capped = !(sigmas[i] * smp.delta < 40.0f);
    }
    composite_bwd_reverse_chunk(smp, i, end, lane, later, d_sigmas);
  }
#pragma unroll
  for (int c = kBwdRegChunks - 1; c >= 0; --c) {
    if (c < chunks)
      composite_bwd_reverse_chunk(kept[c], start + 32 * c + lane, end, lane,
                                  later, d_sigmas);
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
  const int blocks = (n_rays + kBwdWarps - 1) / kBwdWarps;
  composite_bwd_kernel<<<blocks, kBwdWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)t_starts, (const float*)t_ends, (const float*)sigmas,
      (const float*)rgbs, (const int*)seg_starts, (const int*)seg_ends,
      (const float*)prefix_trans, n_rays, (const float*)g_colors,
      (const float*)g_opacities, (const float*)g_depths, (float*)d_sigmas,
      (float*)d_rgbs, (float*)scratch);
  return (int)cudaGetLastError();
}
