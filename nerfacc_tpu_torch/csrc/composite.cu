// G3: sorted-segment volume compositing, forward; G5: its backward.
//
// Replaces: the JAX XLA path that the occupancy-grid renderer runs per ray
// chunk (nerfacc_tpu/utils/rendering.py::render_rays_with_occgrid):
// volrend.render_weight_from_density(indices_sorted=True), whose exclusive
// sum is ops/sorted_segments.py::exclusive_sum_sorted, followed by
// ops/sorted_segments.py::segment_sum_sorted of [rgb, 1, t_mid] * w.  On the
// TPU those are global prefix sums differenced at segment boundaries.
//
// Here each ray's samples [seg_start, seg_end] of the sorted flat buffer are
// composited in order:
//
//   sd    = min(sigma * (t_end - t_start), 40)     (the optical-depth cap)
//   alpha = 1 - exp(-sd)
//   T     = prefix_trans * exp(-sum of earlier sd of this ray)
//   w     = T * alpha
//
// and w * rgb, w and w * t_mid are summed.  The running sum is local to the
// ray, so its rounding error is relative to the ray's own optical depth; the
// global-cumsum failure (transmittance above 1 on hard surfaces) cannot
// occur.  Slots outside every segment (fill id n_rays, or past a budget cut)
// are never touched.
//
// Bound on this card: device-memory reads, 24 B per sample (sigma, rgb,
// t_start, t_end), plus 4 B per sample when the weights are written.
//
// Design: one warp per ray, 8 rays per 256-thread block.  The warp walks its
// segment in chunks of 32 consecutive samples, lane l on sample 32 c + l, so
// each load of t_starts, t_ends and sigmas is one 128-byte line and a
// chunk's colours are 384 contiguous bytes, loaded as three coalesced words
// per lane.  Each chunk's loads are issued before the previous chunk's scan,
// so they overlap it.  The chunk scan (chunk_weights, shared with G5) caps
// each lane's optical depth, takes an inclusive warp scan shifted by one
// lane plus the carried total of the earlier chunks, and gives T and w: the
// optical depth is a tree sum within each chunk, and G3's weights are bit
// for bit the ones G5 recomputes.  Word f of a chunk's colours is component
// f % 3 of sample f / 3; since 32 = 2 (mod 3), the three words of lane l
// hold one word of each component, so the lane fetches the weight of each
// word's sample with one __shfl_sync and keeps fixed per-lane partials of
// w r, w g, w b, w and w t_mid over the chunks; one butterfly
// (__shfl_xor_sync) adds them at the end.  Nothing is kept per chunk, so any
// ray length runs in registers.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rays per block, G3 and G5
constexpr unsigned kFull = 0xffffffffu;

// min(sd, 40) as XLA's and PyTorch's minimum take it: a NaN stays NaN (an
// infinite density on a zero-length sample), where fminf would return 40.
__device__ __forceinline__ float cap_optical_depth(float sd) {
  return sd > 40.0f ? 40.0f : sd;
}

// One lane's sample of a chunk: exp(-sd), its transmittance and weight.
struct ChunkWeights {
  float e, trans, w;
};

// The chunk scan of G3 and G5: the capped optical depth sd of the lane's
// sample (0 where it is past the segment), an inclusive warp scan
// (__shfl_up_sync) shifted by one lane plus the carry of the earlier chunks
// as the exclusive optical depth, and the carry moved past this chunk.  A
// NaN depth reaches only the lanes above it and the later chunks.
__device__ __forceinline__ ChunkWeights chunk_weights(float sigma, float delta,
                                                      bool valid, int lane,
                                                      float prefix,
                                                      float& carry) {
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
  ChunkWeights out;
  out.e = expf(-sd);
  out.trans = expf(-excl) * prefix;
  out.w = out.trans * (1.0f - out.e);
  return out;
}

// One lane's loads of a chunk: its sample's interval and density (0 past
// the segment) and its three colour words (word f = lane + 32 j of the
// chunk's 96; 0 where f / 3 is past the segment).
struct ChunkLoad {
  float t0, t1, sigma, word[3];
};

__device__ __forceinline__ ChunkLoad load_chunk(
    const float* __restrict__ t_starts, const float* __restrict__ t_ends,
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    int64_t base, int64_t end, int lane) {
  ChunkLoad ld = {0.0f, 0.0f, 0.0f, {0.0f, 0.0f, 0.0f}};
  const int64_t i = base + lane;
  if (i <= end) {
    ld.t0 = t_starts[i];
    ld.t1 = t_ends[i];
    ld.sigma = sigmas[i];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int f = lane + 32 * j;
    if (base + f / 3 <= end) ld.word[j] = rgbs[3 * base + f];
  }
  return ld;
}

__global__ void __launch_bounds__(kWarps * 32) composite_fwd_kernel(
    const float* __restrict__ t_starts, const float* __restrict__ t_ends,
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const int* __restrict__ seg_starts, const int* __restrict__ seg_ends,
    const float* __restrict__ prefix_trans, int n_rays,
    float* __restrict__ colors, float* __restrict__ opacities,
    float* __restrict__ depths, float* __restrict__ weights) {
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= n_rays) return;  // warp-uniform
  const float prefix = prefix_trans != nullptr ? prefix_trans[r] : 1.0f;
  const int64_t start = seg_starts[r], end = seg_ends[r];
  const int64_t chunks = end >= start ? (end - start) / 32 + 1 : 0;
  // the components of the lane's first two colour words, l and l + 2 (mod 3);
  // the third's is the one left
  const int k0 = lane % 3, k1 = (lane + 2) % 3;
  float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, acc = 0.0f, dep = 0.0f;
  float carry = 0.0f;
  // each chunk's loads are issued before the previous chunk's scan
  ChunkLoad next = load_chunk(t_starts, t_ends, sigmas, rgbs, start, end, lane);
  for (int64_t c = 0; c < chunks; ++c) {
    const int64_t base = start + 32 * c;
    const ChunkLoad ld = next;
    if (c + 1 < chunks)
      next = load_chunk(t_starts, t_ends, sigmas, rgbs, base + 32, end, lane);
    const bool valid = base + lane <= end;
    const float w =
        chunk_weights(ld.sigma, ld.t1 - ld.t0, valid, lane, prefix, carry).w;
    if (valid) {
      acc += w;
      dep += w * (0.5f * (ld.t0 + ld.t1));
      if (weights != nullptr) weights[base + lane] = w;
    }
    // each colour word times the weight of its sample, lane f / 3
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int s = (lane + 32 * j) / 3;
      const float ws = __shfl_sync(kFull, w, s);
      if (base + s <= end) {
        const float p = ws * ld.word[j];
        if (j == 0) p0 += p;
        else if (j == 1) p1 += p;
        else p2 += p;
      }
    }
  }
  // the lane's partials by component, then one butterfly over the warp
  float c0 = k0 == 0 ? p0 : (k1 == 0 ? p1 : p2);
  float c1 = k0 == 1 ? p0 : (k1 == 1 ? p1 : p2);
  float c2 = k0 == 2 ? p0 : (k1 == 2 ? p1 : p2);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    c0 += __shfl_xor_sync(kFull, c0, o);
    c1 += __shfl_xor_sync(kFull, c1, o);
    c2 += __shfl_xor_sync(kFull, c2, o);
    acc += __shfl_xor_sync(kFull, acc, o);
    dep += __shfl_xor_sync(kFull, dep, o);
  }
  if (lane == 0) {
    colors[3 * r] = c0;
    colors[3 * r + 1] = c1;
    colors[3 * r + 2] = c2;
    opacities[r] = acc;
    depths[r] = dep;
  }
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
// chunks gives its exclusive optical depth (chunk_weights, shared with G3,
// so the two passes see the same T and w), hence v and dL/drgb (stored
// coalesced through three shuffles).  Backward, last chunk first: a
// reverse warp scan of w v (__shfl_down_sync) shifted by one lane plus the
// carried sum of the later chunks gives sum_{j > i} w_j v_j.  Every sum runs
// within one ray: no difference of running totals is formed (the TPU path's
// _excl_bwd differences a global cumsum).
// The first kBwdRegChunks chunks (256 samples) keep the first term
// T exp(-sd) v, w v and delta in registers; later chunks of a longer ray
// park the first two in d_sigmas and scratch (coalesced) and reread their
// interval and density on the way back.  Slots outside every segment (fill,
// or past a budget cut) are never touched: the caller zeroes the outputs.
constexpr int kBwdRegChunks = 8;   // chunks of 32 samples kept in registers

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
  const ChunkWeights cw = chunk_weights(sigma, delta, valid, lane, prefix, carry);
  const float e = cw.e, trans = cw.trans, w = cw.w;
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

__global__ void __launch_bounds__(kWarps * 32) composite_bwd_kernel(
    const float* __restrict__ t_starts, const float* __restrict__ t_ends,
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const int* __restrict__ seg_starts, const int* __restrict__ seg_ends,
    const float* __restrict__ prefix_trans, int n_rays,
    const float* __restrict__ g_colors, const float* __restrict__ g_opacities,
    const float* __restrict__ g_depths, float* __restrict__ d_sigmas,
    float* __restrict__ d_rgbs, float* __restrict__ scratch) {
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;
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
  const int blocks = (n_rays + kWarps - 1) / kWarps;
  composite_fwd_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
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
  const int blocks = (n_rays + kWarps - 1) / kWarps;
  composite_bwd_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)t_starts, (const float*)t_ends, (const float*)sigmas,
      (const float*)rgbs, (const int*)seg_starts, (const int*)seg_ends,
      (const float*)prefix_trans, n_rays, (const float*)g_colors,
      (const float*)g_opacities, (const float*)g_depths, (float*)d_sigmas,
      (float*)d_rgbs, (float*)scratch);
  return (int)cudaGetLastError();
}
