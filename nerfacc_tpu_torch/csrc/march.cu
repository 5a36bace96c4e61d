// G2: occupancy-grid march with exact packing, in two passes.
//
// Replaces: the JAX XLA path nerfacc_tpu/grid.py::traverse_grids_padded
// followed by nerfacc_tpu/utils/rendering.py::compact_samples.  On the TPU
// that path evaluates a static (n_rays, max_samples) lattice of candidates
// and compacts the valid ones into a fixed budget with a key sort.  Here each
// ray walks its own marching orbit:
//
//   1. slab test of the ray against every grid level's AABB;
//   2. a stable sort of the 2m entry/exit distances, resolved into disjoint
//      grid segments (grid.py::_grid_segments);
//   3. the orbit t_{k+1} = t_k + clamp(t_k * cone, step, 1e10), from the near
//      plane, in its closed form (grid.py::_orbit_t); candidate k is emitted
//      iff its midpoint lies in a valid segment and in an occupied voxel of
//      that segment's level.
//
// march_count runs the walk and writes each ray's sample count, its
// termination plane and whether it terminated; the caller takes an
// exclusive scan of the counts; march_fill runs the identical walk again and
// writes ray id, t_start and t_end into the exact-size buffer at the ray's
// offset.  Both passes call the same __device__ routine, so they cannot
// disagree on a sample.
//
// The candidate window (max_samples >= 0, the eval renderer's rounds): only
// candidates k < max_samples, counted from the near plane, may emit; the
// walk halts at the first candidate that is past the farthest segment or at
// k = max_samples, whichever comes first, and the ray has terminated iff it
// halted before the window's end (nerfacc_tpu/grid.py:1415-1445).  The
// termination plane is the orbit value of the halting candidate (plane_t
// below), so a ray cut by the window resumes from t_{max_samples}.  A masked ray emits
// nothing and keeps its near plane, but its flag is still the geometric
// one, as in the JAX padded traversal.  max_samples < 0 walks the whole
// orbit, and every ray terminates.
//
// Bound on this card: one random byte read of the binary grid per candidate
// inside a segment (a 128^3 level is 2 MiB and stays in L2), plus the
// sample writes (12 B each) of the fill pass.  What limits a walk is its
// latency: each candidate costs a chain of rounded operations (three IEEE
// divisions) and a dependent L2 read, and a train batch has few rays (2048,
// or 1024 for TiNeuVox) against the card's 132 SMs.
//
// Design: one warp per ray.  A candidate's arithmetic is a pure function of
// its orbit index k (the closed form, the midpoint, o + mid * d, the voxel),
// so the lanes evaluate candidates independently: lane j takes k0 + j,
// k0 + j + 32, ..., four 32-candidate chunks per step of the walk, whose
// voxel reads are all in flight together.  A ballot of "midpoint past the
// farthest segment" gives the first stopping candidate (the termination
// plane is its t, and the walk ends there); a ballot of the emitted
// candidates gives the count (__popc) and, in the fill pass, each sample's
// slot: the ray's offset + the samples before this chunk + the emitting
// lanes below this one, so the samples stay in (ray, orbit) order.
//
// The walk starts at k_start, not at 0 (first_candidate below): the
// candidates between the near plane and the first valid segment can emit
// nothing, and at the trainer's near plane 0 they are about half of the
// walk.  k_start comes from the closed form in the orbit's linear part only,
// where the orbit is monotone, and is checked by evaluating candidate
// k_start - 1, so the skip is exact.
//
// Float operations use the explicitly rounded intrinsics, so the compiler
// contracts nothing on its own: every candidate is the same sequence of
// rounded operations as the PyTorch twin in nerfacc_tpu_torch/grid.py, and
// the sample sets agree exactly.  The one fused multiply-add is the
// midpoint's position o + t * d, which XLA's CPU backend also fuses in the
// JAX package (the twin evaluates it with an exact f64 product).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxSegments = 2 * kMaxLevels - 1;
// Guard against a runaway walk (a ray whose last segment ends absurdly far
// out): no ray of a bounded scene comes near this many orbit steps.
constexpr int kMaxSteps = 1 << 24;
constexpr int kRaysPerBlock = 4;  // one warp each
constexpr int kChunks = 4;        // 32-candidate chunks per step of a walk
constexpr unsigned kFull = 0xffffffffu;

struct Grid {
  const uint8_t* binaries;  // (m, rx, ry, rz)
  const float* aabbs;       // (m, 6)
  int m, rx, ry, rz;
};

struct Orbit {
  float step, cone, tau, base;  // tau = step / cone, base = 1 + cone
};

// One ray's setup, the same in every lane of its warp.
struct Ray {
  float o[3], d[3];
  float near;
  float n_lin, t_lin_end;  // the orbit is linear for k <= n_lin
  int n_seg;
  float seg_lo[kMaxSegments], seg_hi[kMaxSegments];
  int seg_level[kMaxSegments];
  bool seg_valid[kMaxSegments];
  float lo_first, t_hi_last;  // over the valid segments
};

// NaN-propagating min / max, as jnp.minimum / jnp.maximum and the twin's
// torch.minimum / torch.maximum (fminf / fmaxf would drop the NaN).
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// grid.py::_orbit_t for one orbit index, with the ray's n_lin and
// t_lin_end computed once (by the same rounded operations).
__device__ __forceinline__ float orbit_t(const Ray& r, float k,
                                         const Orbit& o) {
  const float linear = __fadd_rn(r.near, __fmul_rn(k, o.step));
  if (k <= r.n_lin) return linear;
  return __fmul_rn(r.t_lin_end,
                   powf(o.base, fmaxf(__fsub_rn(k, r.n_lin), 0.0f)));
}

// A windowed walk's termination plane: the orbit value of candidate k with
// the linear part's near + k * step as one fused multiply-add, the form in
// which XLA computes the plane in the JAX package's windowed traversal.
__device__ __forceinline__ float plane_t(const Ray& r, float k,
                                        const Orbit& o) {
  if (k <= r.n_lin) return __fmaf_rn(k, o.step, r.near);
  return orbit_t(r, k, o);
}

__device__ __forceinline__ float midpoint(float t0, float t1) {
  return __fmul_rn(0.5f, __fadd_rn(t0, t1));
}

// Slab test, event sort and segments of ray r (grid.py::ray_aabb_intersect
// and _grid_segments).  Returns false if the ray has no valid segment.
__device__ bool setup_ray(int r, const float* __restrict__ rays_o,
                          const float* __restrict__ rays_d, float near,
                          float far, const Grid& g, const Orbit& orb,
                          Ray& ray) {
  float inv[3];
  for (int a = 0; a < 3; ++a) {
    ray.o[a] = rays_o[3 * r + a];
    ray.d[a] = rays_d[3 * r + a];
    inv[a] = __fdiv_rn(1.0f, ray.d[a]);
  }
  ray.near = near;

  // 1. slab test per level
  const int m = g.m;
  float ev_t[2 * kMaxLevels];
  int ev_i[2 * kMaxLevels];
  bool hit[kMaxLevels];
  for (int l = 0; l < m; ++l) {
    float tmin = -INFINITY, tmax = INFINITY;
    for (int a = 0; a < 3; ++a) {
      const float t1 =
          __fmul_rn(__fsub_rn(g.aabbs[6 * l + a], ray.o[a]), inv[a]);
      const float t2 =
          __fmul_rn(__fsub_rn(g.aabbs[6 * l + 3 + a], ray.o[a]), inv[a]);
      tmin = a == 0 ? nmin(t1, t2) : nmax(tmin, nmin(t1, t2));
      tmax = a == 0 ? nmax(t1, t2) : nmin(tmax, nmax(t1, t2));
    }
    hit[l] = (tmax > tmin) && (tmax > 0.0f);
    ev_t[l] = hit[l] ? tmin : INFINITY;
    ev_t[m + l] = hit[l] ? tmax : INFINITY;
  }
  // 2. stable insertion sort of the 2m events (argsort(stable=True))
  for (int i = 0; i < 2 * m; ++i) ev_i[i] = i;
  for (int i = 1; i < 2 * m; ++i) {
    const float t = ev_t[i];
    const int id = ev_i[i];
    int j = i;
    while (j > 0 && ev_t[j - 1] > t) {
      ev_t[j] = ev_t[j - 1];
      ev_i[j] = ev_i[j - 1];
      --j;
    }
    ev_t[j] = t;
    ev_i[j] = id;
  }
  // grid segments
  ray.n_seg = 2 * m - 1;
  ray.lo_first = INFINITY;
  ray.t_hi_last = -INFINITY;
  bool any_seg = false;
  for (int j = 0; j < ray.n_seg; ++j) {
    const int lev_this = ev_i[j] % m, lev_next = ev_i[j + 1] % m;
    const bool ent_this = ev_i[j] < m, ent_next = ev_i[j + 1] < m;
    const bool hit_this = hit[lev_this], hit_next = hit[lev_next];
    bool valid = ent_this ? hit_this : (hit_this && !ent_next && hit_next);
    ray.seg_level[j] = ent_this ? lev_this : lev_next;
    ray.seg_lo[j] = fmaxf(ev_t[j], near);
    ray.seg_hi[j] = fminf(ev_t[j + 1], far);
    valid = valid && (ray.seg_lo[j] < ray.seg_hi[j]);
    ray.seg_valid[j] = valid;
    if (valid) {
      any_seg = true;
      ray.lo_first = fminf(ray.lo_first, ray.seg_lo[j]);
      ray.t_hi_last = fmaxf(ray.t_hi_last, ray.seg_hi[j]);
    }
  }
  if (orb.cone > 0.0f) {
    ray.n_lin = fmaxf(
        ceilf(__fdiv_rn(__fsub_rn(orb.tau, near), orb.step)), 0.0f);
    ray.t_lin_end = __fadd_rn(near, __fmul_rn(ray.n_lin, orb.step));
  } else {
    ray.n_lin = INFINITY;
    ray.t_lin_end = 0.0f;
  }
  return any_seg;
}

// k_start: the walk's first candidate.  Where k + 1 <= n_lin (every k
// without a cone), t_k = near + fl(k step) is nondecreasing in k, since
// each rounded operation is monotone, and so is the midpoint of (t_k,
// t_{k+1}).  So if candidate k_start - 1 has its midpoint below lo_first,
// so has every earlier candidate: none lies in a valid segment (each starts
// at lo_first or later) and none stops the walk (t_hi_last > lo_first).
// The estimate from the closed form is capped at n_lin, checked by
// evaluating candidate k_start - 1, and stepped back where the check fails,
// so the skip is exact.  Where lo_first is within two steps of the near
// plane, or NaN, the walk starts at 0.
__device__ int first_candidate(const Ray& r, const Orbit& o) {
  const float e = __fdiv_rn(__fsub_rn(r.lo_first, r.near), o.step);
  if (!(e >= 2.0f)) return 0;
  const float cap = fminf(r.n_lin, (float)kMaxSteps);
  int k = (int)fminf(__fsub_rn(floorf(e), 1.0f), cap);
  while (k > 0 &&
         midpoint(orbit_t(r, (float)(k - 1), o), orbit_t(r, (float)k, o)) >=
             r.lo_first)
    --k;
  return k;
}

// Flat voxel index of a midpoint inside a valid segment (its level's
// occupancy cell, grid.py::_occupancy_lookup), or -1 outside every one.
__device__ __forceinline__ int64_t voxel(const Ray& r, float mid,
                                         const Grid& g) {
  int level = -1;
  for (int j = 0; j < r.n_seg; ++j) {
    if (r.seg_valid[j] && mid >= r.seg_lo[j] && mid < r.seg_hi[j])
      level = r.seg_level[j];
  }
  if (level < 0) return -1;
  const int res[3] = {g.rx, g.ry, g.rz};
  int idx[3];
  for (int a = 0; a < 3; ++a) {
    const float lo = g.aabbs[6 * level + a];
    const float hi = g.aabbs[6 * level + 3 + a];
    const float pos = __fmaf_rn(mid, r.d[a], r.o[a]);
    const float u = __fdiv_rn(__fsub_rn(pos, lo), __fsub_rn(hi, lo));
    const float f = floorf(__fmul_rn(u, (float)res[a]));
    idx[a] = (int)fminf(fmaxf(f, 0.0f), (float)(res[a] - 1));
  }
  return (((int64_t)level * g.rx + idx[0]) * g.ry + idx[1]) * g.rz + idx[2];
}

// Marches ray r with the 32 lanes of a warp, over candidates k < k_end
// (max_samples, or no end when it is negative).  With FILL, writes the
// samples from out_base on.  Returns the ray's sample count and stores its
// termination plane in *term and its flag in *stopped (the same in every
// lane).
template <bool FILL>
__device__ int march_ray(int r, int lane, const float* __restrict__ rays_o,
                         const float* __restrict__ rays_d,
                         const float* __restrict__ near_planes,
                         const float* __restrict__ far_planes,
                         const uint8_t* __restrict__ rays_mask,
                         const Grid& g, const Orbit& orb, int max_samples,
                         float* term, bool* stopped, int64_t out_base,
                         int* __restrict__ ray_ids,
                         float* __restrict__ t_starts,
                         float* __restrict__ t_ends) {
  const float near = near_planes[r];
  *term = near;
  *stopped = true;
  const bool masked = rays_mask != nullptr && !rays_mask[r];
  // a masked ray's flag matters only in a window, and the fill pass writes
  // no flag
  if (masked && (FILL || max_samples < 0)) return 0;
  Ray ray;
  if (!setup_ray(r, rays_o, rays_d, near, far_planes[r], g, orb, ray))
    return 0;

  const int k_end = max_samples < 0 ? kMaxSteps : max_samples;
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
  const int k_start = first_candidate(ray, orb);
  if (k_start >= k_end) {  // the window ends before the first segment
    if (!masked) *term = plane_t(ray, (float)k_end, orb);
    *stopped = max_samples < 0;
    return 0;
  }
  for (int k = k_start;; k += 32 * kChunks) {
    float t0[kChunks], t1[kChunks], mid[kChunks];
    unsigned halts[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int kk = k + 32 * u + lane;
      t0[u] = orbit_t(ray, (float)kk, orb);
      t1[u] = __shfl_down_sync(kFull, t0[u], 1);
      if (lane == 31) t1[u] = orbit_t(ray, (float)(kk + 1), orb);
      mid[u] = midpoint(t0[u], t1[u]);
      // the first candidate whose midpoint clears the farthest segment
      // ends the walk, as the window's end (or the kMaxSteps-th) does
      halts[u] = __ballot_sync(kFull, kk >= k_end || mid[u] >= ray.t_hi_last);
    }
    int stop_chunk = kChunks, stop_lane = 32;
#pragma unroll
    for (int u = kChunks - 1; u >= 0; --u) {
      if (halts[u] != 0u) {
        stop_chunk = u;
        stop_lane = __ffs(halts[u]) - 1;
      }
    }
    uint8_t occupied[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const bool before = u < stop_chunk || (u == stop_chunk && lane < stop_lane);
      const int64_t cell = before && !masked ? voxel(ray, mid[u], g) : -1;
      occupied[u] = cell >= 0 ? __ldg(g.binaries + cell) : 0;
    }
    float t_stop = t0[0];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const unsigned emits = __ballot_sync(kFull, occupied[u] != 0);
      if (FILL && occupied[u]) {
        const int64_t at = out_base + count + __popc(emits & below);
        ray_ids[at] = r;
        t_starts[at] = t0[u];
        t_ends[at] = t1[u];
      }
      count += __popc(emits);
      if (u == stop_chunk) t_stop = t0[u];
    }
    if (stop_chunk < kChunks) {
      // orbit value of the halting candidate: the first one past every
      // segment, or the window's end
      const int k_halt = k + 32 * stop_chunk + stop_lane;
      t_stop = __shfl_sync(kFull, t_stop, stop_lane);
      if (!masked)
        *term = max_samples < 0 ? t_stop : plane_t(ray, (float)k_halt, orb);
      *stopped = max_samples < 0 || k_halt < k_end;
      return count;
    }
  }
}

__global__ void march_count_kernel(const float* rays_o, const float* rays_d,
                                   const float* near_planes,
                                   const float* far_planes,
                                   const uint8_t* rays_mask, Grid g, Orbit orb,
                                   int n_rays, int max_samples, int* counts,
                                   float* term, uint8_t* terminated) {
  const int r = blockIdx.x * kRaysPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= n_rays) return;  // the whole warp
  float t;
  bool stopped;
  const int c = march_ray<false>(r, lane, rays_o, rays_d, near_planes,
                                 far_planes, rays_mask, g, orb, max_samples,
                                 &t, &stopped, 0, nullptr, nullptr, nullptr);
  if (lane == 0) {
    counts[r] = c;
    term[r] = t;
    terminated[r] = stopped;
  }
}

__global__ void march_fill_kernel(const float* rays_o, const float* rays_d,
                                  const float* near_planes,
                                  const float* far_planes,
                                  const uint8_t* rays_mask, Grid g, Orbit orb,
                                  int n_rays, int max_samples,
                                  const int64_t* offsets, int* ray_ids,
                                  float* t_starts, float* t_ends) {
  const int r = blockIdx.x * kRaysPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= n_rays) return;  // the whole warp
  float t;
  bool stopped;
  march_ray<true>(r, lane, rays_o, rays_d, near_planes, far_planes, rays_mask,
                  g, orb, max_samples, &t, &stopped, offsets[r], ray_ids,
                  t_starts, t_ends);
}

}  // namespace

// Pass 1: per-ray sample counts (int32), termination planes (f32) and
// terminated flags (bool bytes); max_samples < 0 walks the whole orbit.
extern "C" int march_count(const void* rays_o, const void* rays_d,
                           const void* near_planes, const void* far_planes,
                           const void* rays_mask, const void* binaries,
                           const void* aabbs, int n_rays, int m, int rx,
                           int ry, int rz, float step, float cone, float tau,
                           float base, int max_samples, void* counts,
                           void* term, void* terminated, void* stream) {
  if (m < 1 || m > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (max_samples > kMaxSteps) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return (int)cudaSuccess;
  const Grid g{(const uint8_t*)binaries, (const float*)aabbs, m, rx, ry, rz};
  const Orbit orb{step, cone, tau, base};
  const int blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  march_count_kernel<<<blocks, 32 * kRaysPerBlock, 0, (cudaStream_t)stream>>>(
      (const float*)rays_o, (const float*)rays_d, (const float*)near_planes,
      (const float*)far_planes, (const uint8_t*)rays_mask, g, orb, n_rays,
      max_samples, (int*)counts, (float*)term, (uint8_t*)terminated);
  return (int)cudaGetLastError();
}

// Pass 2: samples written at the exclusive-scan offsets (int64) of pass 1,
// with pass 1's max_samples.
extern "C" int march_fill(const void* rays_o, const void* rays_d,
                          const void* near_planes, const void* far_planes,
                          const void* rays_mask, const void* binaries,
                          const void* aabbs, int n_rays, int m, int rx, int ry,
                          int rz, float step, float cone, float tau,
                          float base, int max_samples, const void* offsets,
                          void* ray_ids, void* t_starts, void* t_ends,
                          void* stream) {
  if (m < 1 || m > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (max_samples > kMaxSteps) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return (int)cudaSuccess;
  const Grid g{(const uint8_t*)binaries, (const float*)aabbs, m, rx, ry, rz};
  const Orbit orb{step, cone, tau, base};
  const int blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  march_fill_kernel<<<blocks, 32 * kRaysPerBlock, 0, (cudaStream_t)stream>>>(
      (const float*)rays_o, (const float*)rays_d, (const float*)near_planes,
      (const float*)far_planes, (const uint8_t*)rays_mask, g, orb, n_rays,
      max_samples, (const int64_t*)offsets, (int*)ray_ids, (float*)t_starts,
      (float*)t_ends);
  return (int)cudaGetLastError();
}
