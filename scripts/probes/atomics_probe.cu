// Rates of the reductions G7 can build on, on one GPU: int64 adds into a
// block's shared memory and into another block's across a cluster,
// reductions into global memory (L2-resident or not) by atomics and by the
// tensor memory accelerator's bulk reductions.  Built and run by
// scripts/atomics_probe.py; one line a probe, G operations a second (the
// best of three timed launches after one warm-up).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <cstdio>
namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 8192;  // int64 pairs a block holds in shared memory (128 KB)

__device__ __forceinline__ uint32_t mix(uint32_t a) {
  a ^= a >> 16; a *= 0x7feb352du; a ^= a >> 15; a *= 0x846ca68bu; a ^= a >> 16;
  return a;
}

__device__ __forceinline__ void split_add(unsigned long long* p, long long v) {
  unsigned* w = (unsigned*)p;
  const unsigned lo = (unsigned)v, hi = (unsigned)((unsigned long long)v >> 32);
  const unsigned old = atomicAdd(w, lo);
  atomicAdd(w + 1, hi + (old + lo < old ? 1u : 0u));
}

__device__ __forceinline__ void bulk(unsigned long long* dst, const void* src, unsigned bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(src);
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.u64 [%0], [%1], %2;"
               ::"l"(dst), "r"(s), "r"(bytes) : "memory");
}

// Shared memory: MODE 0 a 64-bit atomicAdd (a compare-and-swap loop), 1 two
// 32-bit adds with the carry, 2 a 64-bit atomicAdd into a random block of
// the cluster (distributed shared memory).
template <int MODE>
__global__ void shared_probe(int iters, unsigned long long* out, int C) {
  extern __shared__ unsigned long long tab[];
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = threadIdx.x; i < 2 * kRows; i += blockDim.x) tab[i] = 0;
  cluster.sync();
  const uint32_t seed = (blockIdx.x * blockDim.x + threadIdx.x) * 0x9e3779b9u;
  for (int it = 0; it < iters; ++it) {
    const uint32_t h = mix(seed + it * 0x85ebca6bu);
    const int idx = h & (2 * kRows - 1);
    const long long v = (long long)(h >> 16) - 30000;
    if (MODE == 0) atomicAdd(tab + idx, (unsigned long long)v);
    if (MODE == 1) split_add(tab + idx, v);
    if (MODE == 2)
      atomicAdd(cluster.map_shared_rank(tab, (h >> 20) % C) + idx, (unsigned long long)v);
  }
  cluster.sync();
  unsigned long long s = 0;
  for (int i = threadIdx.x; i < 2 * kRows; i += blockDim.x) s += tab[i];
  atomicAdd(out, s);
}

// Global memory, random 32-byte sectors of a table of mask + 1 sectors:
// MODE 0 a 64-bit red, 1 a float4 atomicAdd, 2 one bulk reduction of BYTES,
// 3 one bulk reduction of 32 bytes and four 64-bit reds.
template <int MODE, int BYTES>
__global__ void global_probe(int iters, unsigned long long* g, uint32_t mask) {
  extern __shared__ __align__(128) unsigned long long slot[];
  unsigned long long* my = slot + threadIdx.x * (BYTES / 8);
  const uint32_t seed = (blockIdx.x * blockDim.x + threadIdx.x) * 0x9e3779b9u;
  for (int it = 0; it < iters; ++it) {
    const uint32_t h = mix(seed + it * 0x85ebca6bu);
    const long long v = (long long)(h >> 16) - 30000;
    const uint32_t s = h & mask & ~(uint32_t)(BYTES > 32 ? BYTES / 32 - 1 : 0);
    if (MODE == 0) atomicAdd(g + 4 * s + (h >> 30), (unsigned long long)v);
    if (MODE == 1) atomicAdd((float4*)g + 2 * s + (h >> 31), make_float4(1.f, 2.f, 3.f, 4.f));
    if (MODE == 3)
      for (int j = 0; j < 4; ++j) atomicAdd(g + 4 * (mix(h + j) & mask), (unsigned long long)v);
    if (MODE >= 2) {
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      for (int w = 0; w < BYTES / 8; ++w) my[w] = v + w;
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bulk(g + 4 * s, my, BYTES);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <class F>
float best_ms(F launch) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  float best = 1e30f;
  for (int rep = 0; rep < 4; ++rep) {
    cudaEventRecord(a);
    launch();
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    if (rep > 0 && ms < best) best = ms;
  }
  return best;
}

template <int MODE>
void shared_line(const char* name, int C, unsigned long long* out) {
  const int threads = 1024, blocks = C * (128 / C), iters = 256, smem = 2 * kRows * 8;
  cudaFuncSetAttribute(shared_probe<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(shared_probe<MODE>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float ms = best_ms([&] { cudaLaunchKernelEx(&cfg, shared_probe<MODE>, iters, out, C); });
  printf("probe %s, cluster of %d: %s, %.1f G int64 adds/s\n", name, C,
         cudaGetErrorString(cudaGetLastError()),
         (double)blocks * threads * iters / ms / 1e6);
}

template <int MODE, int BYTES>
void global_line(const char* name, size_t mib, int threads, int blocks, int iters,
                 unsigned long long* g) {
  const uint32_t mask = (uint32_t)((mib << 20) / 32 - 1);
  const int smem = threads * (BYTES > 8 ? BYTES : 8);
  cudaFuncSetAttribute(global_probe<MODE, BYTES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const float ms = best_ms([&] { global_probe<MODE, BYTES><<<blocks, threads, smem>>>(iters, g, mask); });
  const double its = (double)blocks * threads * iters;
  const double ops = MODE == 3 ? 5 * its : its;
  printf("probe %s, %d-byte records, %zu MiB table, %d warps a block: %s, %.1f G operations/s\n",
         name, BYTES, mib, threads / 32, cudaGetErrorString(cudaGetLastError()),
         ops / ms / 1e6);
}

}  // namespace

int main() {
  unsigned long long *out, *g;
  cudaMalloc(&out, 16);
  cudaMalloc(&g, size_t(128) << 20);
  cudaMemset(g, 0, size_t(128) << 20);
  shared_line<0>("shared memory, 64-bit atomicAdd", 1, out);
  shared_line<1>("shared memory, two 32-bit adds", 1, out);
  for (int C : {2, 4, 8, 16}) shared_line<2>("another block's shared memory, 64-bit atomicAdd", C, out);
  for (size_t mib : {8, 32, 128}) {
    global_line<0, 8>("global 64-bit red", mib, 512, 264, 256, g);
    global_line<1, 16>("global float4 atomicAdd", mib, 512, 264, 256, g);
    global_line<2, 32>("global bulk reduction", mib, 256, 528, 64, g);
  }
  for (int bytes_case = 0; bytes_case < 4; ++bytes_case) {
    // one block of 8 warps an SM: the latency of a record's read shows
    if (bytes_case == 0) global_line<2, 16>("global bulk reduction, 8 warps an SM", 8, 256, 132, 64, g);
    if (bytes_case == 1) global_line<2, 32>("global bulk reduction, 8 warps an SM", 8, 256, 132, 64, g);
    if (bytes_case == 2) global_line<2, 64>("global bulk reduction, 8 warps an SM", 8, 256, 132, 64, g);
    if (bytes_case == 3) global_line<2, 128>("global bulk reduction, 8 warps an SM", 8, 256, 132, 64, g);
  }
  global_line<3, 32>("global bulk reduction and four 64-bit reds", 8, 256, 528, 64, g);
  return 0;
}
