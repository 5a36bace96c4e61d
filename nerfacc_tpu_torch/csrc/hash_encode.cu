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
// Bound on this card: random 8-byte row gathers (G6) and random atomic adds
// (G7).  At the field's shape (2^18 samples, 16 levels, T = 2^19) a call
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
// G7: summed in fixed point by bulk reductions, one persistent launch.  The
// contract: each term w_c * cot becomes the int64 round(w_c * (cot * 2^k)),
// with one scale 2^k a call (ops/ordered_sums.py): a first pass takes the
// largest finite |cot| (atomicMax on its bits), w_c <= 1 bounds every term
// by it, and 2^k puts that bound times eight times the sample count below
// 2^62.  Integer sums do not depend on their order, so two calls give the
// same bits and the kernel equals its plain version
// (ops/hash_encode.py::hash_encode_backward_plain) bit for bit.  A +-inf or
// NaN term is kept apart, as flags per entry, and the entry comes out as an
// f64 sum of its terms would; each entry is written as f32(f64(sum) *
// 2^-k), or its flagged value.
//
// What bounds it on this card: operations, not bytes.  At the field's
// shape a call adds 2^18 x 16 x 8 x 2 = 67M int64 terms at random
// rows.  There is no 64-bit vector atomic; 64-bit reductions into an
// L2-resident table retire ~88 G a second, whatever their width, and
// 17 G a second once the table spills to DRAM (scripts/atomics_probe.py on
// an H100, 700 W).  The tensor memory accelerator's bulk
// reduction (cp.reduce.async.bulk .add.u64) adds a whole 16- or 32-byte
// record as one operation, 56-57 G a second into an L2-resident table; but
// its operands go through uniform registers, one lane at a time (~9
// instructions of the warp a record), and each block waits for its records
// to be read before it reuses their shared memory: at ~36 G records a
// second this design is bound by their issue.  Adds into another
// block's shared memory across a cluster (distributed shared memory)
// retire 37-47 G a second at 8-16 blocks: no better than the L2's, so the
// design keeps the rows in the L2, not on the chip.  Here:
// - the x prime is 1, so a cell with even x index has its corners dx = 0, 1
//   on one row pair (2 m, 2 m + 1): their four sums are one 32-byte record;
//   an odd cell's two rows are two 16-byte records (add_records).  Runs of
//   equal records on neighbouring lanes (ray order) are merged by a
//   segmented shuffle scan first.  ~6 reductions a sample and level, where
//   the parent design took 16 64-bit atomics;
// - a level whose cube of corner cells, (res + 1)^3 int64 pairs, fits
//   kStageBytes (res 16: 4,913 cells, 78,608 bytes) is summed in shared
//   memory, indexed by the unhashed cell, with split 32-bit adds; each item
//   (kStagedItems times the samples of another level's) writes its nonzero
//   cells to their hashed rows by 64-bit atomics (a corner outside the cube
//   goes straight to them);
// - the sums live in min(L, kMaxSlots) level slots, not in an int64 twin of
//   the whole table: persistent blocks take items in order (zero a level's
//   slot, add its samples, write its f32 gradient), so a slot is zeroed
//   just before its level's reductions and read soon after, mostly in L2,
//   and the parent's 128 MiB memset and separate conversion pass go.
// Timed on an H100, 700 W (device ms at N = 2^18 uniform, the NGP train
// step's ray order, and L = 5, T = 2^17 at N = 2^19 and 2^20 in ray order;
// scripts/time_kernels.py G7; PERF.md): the parent (64-bit atomics
// into an int64 twin) 1.26 / 0.82 / 0.34 / 0.45; this design 0.70 / 0.60 /
// 0.27 / 0.41.  Variants timed on the way: these records into the twin
// with a separate conversion 0.82 / 0.61 / 0.25 / 0.38; an odd cell's rows
// as 64-bit atomics 0.93 / 0.67 / 0.24 / 0.41 (more L2 operations); the
// res-16 level not staged, three blocks an SM 0.93 / 0.67 / 0.25 / 0.34;
// three slots reused in turn 0.78 / 0.65 / 0.28 / 0.43 (levels wait on
// each other); sum items of 1024, 2048, 4096, 8192 samples 0.83-0.85,
// 0.70, 0.80, 1.01 uniform and 0.44, 0.42, 0.41, 0.42 at N = 2^20; each
// lane waiting for its records to be read only at its first store 0.72 /
// 0.62 / 0.29 / 0.44; a 32-byte record for any two neighbouring rows (a
// third of the odd cells too: 11% fewer reductions) 0.70 / 0.60 / 0.29 /
// 0.42; a staged item writing out only the cells it touched 0.71 / 0.60 /
// 0.28 / 0.41.  None of these was kept.
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
__device__ __forceinline__ void add_from(longlong2& v, int d, bool take) {
  const long long px = __shfl_down_sync(kFull, v.x, d);
  const long long py = __shfl_down_sync(kFull, v.y, d);
  if (take) {
    v.x += px;
    v.y += py;
  }
}

// G7's record for one bulk reduction: the int64 sums of a row pair (2m,
// 2m + 1), both features of row 2m then of row 2m + 1 (32 bytes), or of
// one row in v[0..1] (16 bytes).
struct Rec {
  long long v[4];
};

__device__ __forceinline__ void add_from(Rec& r, int d, bool take) {
  long long p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __shfl_down_sync(kFull, r.v[i], d);
  if (take) {
#pragma unroll
    for (int i = 0; i < 4; ++i) r.v[i] += p[i];
  }
}

// Sums v over each run of equal `key` on neighbouring lanes of the warp
// (`valid` lanes only; every lane must call it).  Returns true on the lane
// that starts a run, which then holds the run's sum in v: a segmented
// suffix scan, step d adding lane + d's partial where lanes lane + 1 ..
// lane + d continue the run, for as many steps as the longest run needs.
template <class V>
__device__ __forceinline__ bool merge_run(uint32_t key, V& v, unsigned valid, int lane) {
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

constexpr int kSumBits = 62;  // every entry's |sum| stays below 2^62
constexpr int kMaxExp = 127;  // 2^k an f32 normal

// G7's scale exponent k (ops/hash_encode.py::scale_exponent): maxima[0]
// holds the bits of the largest finite |cot|, below 2^(E - 126) for its
// biased exponent E; `bits` is the bit length of 8 n, plus one.
__device__ __forceinline__ int scale_exp(const unsigned* maxima, int bits) {
  const int e = min((int)(maxima[0] >> 23) - 126, 128);
  return min(kSumBits - bits - e, kMaxExp);
}

// A scaled term in fixed point (rounded to nearest even), or 0 and its flag
// in entry e's byte (1: +inf, 2: -inf, 4: NaN) if it is not finite.
__device__ __forceinline__ long long fixed_term(float t, unsigned* flags, int64_t e) {
  if (isfinite(t)) return __float2ll_rn(t);
  const unsigned bit = t != t ? 4u : (t > 0.0f ? 1u : 2u);
  atomicOr(flags + e / 4, bit << (8 * (e % 4)));
  return 0;
}

__device__ __forceinline__ void add_pair(unsigned long long* p, longlong2 v) {
  if (v.x != 0) atomicAdd(p, (unsigned long long)v.x);
  if (v.y != 0) atomicAdd(p + 1, (unsigned long long)v.y);
}

// v into an int64 in shared memory, where a 64-bit add is a compare-and-swap
// loop on this card: two 32-bit adds, the carry of the low word into the
// high one, give the same sum.
__device__ __forceinline__ void shared_add(long long* p, long long v) {
  if (v == 0) return;
  unsigned* w = reinterpret_cast<unsigned*>(p);
  const unsigned lo = (unsigned)v, hi = (unsigned)((unsigned long long)v >> 32);
  const unsigned old = atomicAdd(w, lo);
  atomicAdd(w + 1, hi + (old + lo < old ? 1u : 0u));
}

constexpr int kBwdThreads = 512;   // G7
constexpr int kMaxItemSamples = 16384;  // samples of one level a sum item may take
constexpr int kConvRows = 16384;   // table rows a zero or a write item takes
// Shared memory a G7 block may stage a level's cube of corner cells in, as
// int64 pairs: res 16 (4,913 cells, 78,608 bytes) fits.
constexpr int kStageBytes = 80 * 1024;
// G7's records in shared memory: four a thread, one a (dy, dz) corner pair
constexpr int kSlotBytes = kBwdThreads * 4 * (int)sizeof(Rec);
// An item either stages a cube or keeps records: they share the memory
constexpr int kBwdSmem = kSlotBytes > kStageBytes ? kSlotBytes : kStageBytes;

// One bulk reduction of `bytes` (16 or 32) from shared memory at src into
// the int64 words at dst, by the tensor memory accelerator.
__device__ __forceinline__ void bulk_add(unsigned long long* dst, const Rec* src,
                                         unsigned bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(src);
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.u64 [%0], [%1], %2;" ::"l"(dst),
      "r"(s), "r"(bytes)
      : "memory");
}

// One sample's terms at a level that is not staged, into the level's slot
// `sums` (rows local to the level; `base` the level's first flat row): for
// each pair of corners dx = 0, 1 (same dy, dz), a cell with even x index
// puts both on one row pair (the x prime is 1), one 32-byte record; an odd
// one puts them on two rows, two 16-byte records.  Runs of equal records
// on neighbouring lanes are merged, and each run's sum is one bulk
// reduction.
__device__ __forceinline__ void add_records(const Corners& c, float2 g, bool pairs,
                                            unsigned valid, int lane, uint32_t base,
                                            Rec* slot, unsigned long long* sums,
                                            unsigned* flags) {
  // the bulk reductions of the last sample have read this thread's records
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  const bool paired = pairs && !(c.i0[0] & 1);
  const unsigned odd = __ballot_sync(kFull, !paired) & valid;
  unsigned issue = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t r0 = c.row[k] - base, r1 = c.row[k + 4] - base;
    const int64_t e0 = 2 * (int64_t)r0, e1 = 2 * (int64_t)r1;
    const long long t0x = fixed_term(__fmul_rn(c.w[k], g.x), flags, e0);
    const long long t0y = fixed_term(__fmul_rn(c.w[k], g.y), flags, e0 + 1);
    const long long t1x = fixed_term(__fmul_rn(c.w[k + 4], g.x), flags, e1);
    const long long t1y = fixed_term(__fmul_rn(c.w[k + 4], g.y), flags, e1 + 1);
    Rec a;
    uint32_t key;  // a pair's with bit 31 set, a row's below 2^31
    if (paired) {
      const bool hi = r0 & 1u;
      a.v[0] = hi ? t1x : t0x;
      a.v[1] = hi ? t1y : t0y;
      a.v[2] = hi ? t0x : t1x;
      a.v[3] = hi ? t0y : t1y;
      key = 0x80000000u | (r0 >> 1);
    } else {
      a.v[0] = t0x;
      a.v[1] = t0y;
      a.v[2] = 0;
      a.v[3] = 0;
      key = r0;
    }
    if (merge_run(key, a, valid, lane) && (a.v[0] | a.v[1] | a.v[2] | a.v[3]) != 0) {
      slot[k] = a;
      issue |= 1u << (2 * k);
    }
    if (odd != 0) {  // warp-uniform
      longlong2 b = make_longlong2(t1x, t1y);
      if (merge_run(r1, b, odd, lane) && (b.x | b.y) != 0) {
        slot[k].v[2] = b.x;
        slot[k].v[3] = b.y;
        issue |= 2u << (2 * k);
      }
    }
  }
  if (issue == 0) return;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t r0 = c.row[k] - base, r1 = c.row[k + 4] - base;
    if ((issue >> (2 * k)) & 1u)
      bulk_add(sums + 2 * (int64_t)(paired ? r0 & ~1u : r0), slot + k, paired ? 32u : 16u);
    if ((issue >> (2 * k + 1)) & 1u)
      bulk_add(sums + 2 * (int64_t)r1, reinterpret_cast<const Rec*>(&slot[k].v[2]), 16u);
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The inputs of one launch.  Its items, taken in order by the persistent
// blocks: a zero item zeroes kConvRows rows of a level's slot of int64 sums
// and their flags; a sum item adds `item_samples` samples' terms at one level
// into the slot; a write item writes kConvRows rows of the level's gradient
// from the slot.  Level l takes slot l % slots, slots = min(L, kMaxSlots).
// The order is by stages s = 0 .. L + kLag - 1: the zero and the sum items
// of level s (s < L), then the write items of level s - kLag (s >= kLag).
// A zero item of level l waits for the write items of level l - slots
// (taken at stage l - slots + kLag < l: slots > kLag wherever a slot is
// reused), a sum item for the zero items of its level, a write item for
// its level's zero and sum items: every wait is on items taken before it,
// so the launch cannot deadlock.  A slot is zeroed just before its level's
// sums and read soon after them, mostly in L2.
constexpr int kMaxSlots = 8;
constexpr int kLag = 2;

struct BwdArgs {
  const float* x;
  const float2* cot;
  const float* res;
  float* g_table;
  unsigned long long* sums;  // `slots` slots of 2 Tp int64, Tp = max(T, 2)
  unsigned* flags;           // `slots` slots of 2 Tp flag bytes
  unsigned* head;            // [0] largest |cot| bits, [1] next item, then 3 L counts
  int64_t n;
  int L, log2T, bits, slots;
  int item_samples;  // samples a sum item takes, a multiple of kBwdThreads; 4x at a staged level
  int row_items;     // a level's zero items, and its write items
};

// Whether level l's cube of corner cells, (res + 1)^3 int64 pairs, fits
// kStageBytes: its sum items add into the cube in shared memory.
__device__ __forceinline__ bool staged_level(const float* res, int l) {
  const int dim = (int)res[l] + 1;
  return dim >= 1 && dim <= 64 && dim * dim * dim * (int)sizeof(longlong2) <= kStageBytes;
}

// The samples of one of level l's sum items: a staged level's items take
// kStagedItems times as many, as each zeroes and writes out its cube.
constexpr int kStagedItems = 4;
__device__ __forceinline__ int level_samples(const BwdArgs& p, int l) {
  return staged_level(p.res, l) ? min(kStagedItems * p.item_samples, kMaxItemSamples)
                                : p.item_samples;
}

__device__ __forceinline__ int sum_items(const BwdArgs& p, int l) {
  const int s = level_samples(p, l);
  return (int)((p.n + s - 1) / s);
}

enum Kind { kZero, kSum, kWrite };

__device__ __forceinline__ void decode(const BwdArgs& p, int i, Kind& kind, int& l,
                                       int& chunk) {
  const int z = p.row_items, c = p.row_items;
  kind = kWrite, l = 0, chunk = 0;
  for (int s = 0; s < p.L + kLag; ++s) {
    if (s < p.L) {
      const int a = sum_items(p, s);
      if (i < z) {
        kind = kZero, l = s, chunk = i;
        return;
      }
      i -= z;
      if (i < a) {
        kind = kSum, l = s, chunk = i;
        return;
      }
      i -= a;
    }
    if (s >= kLag) {
      if (i < c) {
        kind = kWrite, l = s - kLag, chunk = i;
        return;
      }
      i -= c;
    }
  }
}

// Thread 0 waits until *count reaches target, then the block goes on.
__device__ __forceinline__ void wait_count(const unsigned* count, unsigned target) {
  if (threadIdx.x == 0) {
    while (true) {
      unsigned v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(count) : "memory");
      if (v >= target) break;
      __nanosleep(64);
    }
  }
  __syncthreads();
}

// Every thread's writes made visible, then one more item counted done.
__device__ __forceinline__ void count_done(unsigned* count) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(count, 1u);
}

// A sum item: samples chunk * item_samples onwards at level l, into slot
// `sums` with its flags.  A staged level sums into the cube, which the item
// zeroes first (the records of other items share its memory) and writes
// out at its end.
__device__ void sum_item(const BwdArgs& p, int l, int chunk, unsigned char* smem,
                         unsigned long long* sums, unsigned* flags, float scale) {
  const int samples = level_samples(p, l);
  const int64_t first = (int64_t)chunk * samples;
  const int lane = threadIdx.x & 31;
  const uint32_t base = (uint32_t)l << p.log2T;
  // corner cells 0 .. res of the points in [0, 1)^3, per axis
  const int dim = (int)p.res[l] + 1;
  const bool staged = staged_level(p.res, l);
  longlong2* cube = reinterpret_cast<longlong2*>(smem);
  const int cells = staged ? dim * dim * dim : 0;
  for (int i = threadIdx.x; i < cells; i += kBwdThreads) cube[i] = make_longlong2(0, 0);
  if (staged) __syncthreads();
  Rec* slot = reinterpret_cast<Rec*>(smem) + 4 * threadIdx.x;
  for (int it = 0; it < samples / kBwdThreads; ++it) {
    const int64_t s = first + it * kBwdThreads + threadIdx.x;
    const unsigned valid = __ballot_sync(kFull, s < p.n);
    if (valid == 0) break;  // warp-uniform: later samples lie past n too
    Corners c;
    float2 g = make_float2(0.0f, 0.0f);
    if (s < p.n) {
      c = corners(p.x, p.res, s, l, p.log2T);
      g = p.cot[s * p.L + l];
      g = make_float2(__fmul_rn(g.x, scale), __fmul_rn(g.y, scale));
    } else {
      c = Corners{};
      for (int k = 0; k < 8; ++k) c.row[k] = base;
    }
    if (!staged) {
      add_records(c, g, p.log2T > 0, valid, lane, base, slot, sums, flags);
      continue;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int64_t e = 2 * (int64_t)(c.row[k] - base);
      longlong2 v;
      v.x = fixed_term(__fmul_rn(c.w[k], g.x), flags, e);
      v.y = fixed_term(__fmul_rn(c.w[k], g.y), flags, e + 1);
      if (!merge_run(c.row[k], v, valid, lane)) continue;
      const int cx = c.i0[0] + ((k >> 2) & 1), cy = c.i0[1] + ((k >> 1) & 1),
                cz = c.i0[2] + (k & 1);
      if ((unsigned)cx < (unsigned)dim && (unsigned)cy < (unsigned)dim &&
          (unsigned)cz < (unsigned)dim) {
        long long* cell = reinterpret_cast<long long*>(cube + ((cx * dim) + cy) * dim + cz);
        shared_add(cell, v.x);
        shared_add(cell + 1, v.y);
      } else {
        add_pair(sums + e, v);
      }
    }
  }
  if (staged) {
    // each nonzero cell to its hashed row (cells that hash to one row still add there)
    __syncthreads();
    const uint32_t mask = (1u << p.log2T) - 1u;
    for (int i = threadIdx.x; i < cells; i += kBwdThreads) {
      const int cz = i % dim, cy = (i / dim) % dim, cx = i / (dim * dim);
      add_pair(sums + 2 * (int64_t)(spatial_hash(cx, cy, cz) & mask), cube[i]);
    }
  }
  // every reduction done (and this block's records read) before the count
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

__device__ __forceinline__ float from_fixed(long long s, unsigned f, double unit) {
  if (f == 0u) return __double2float_rn(__dmul_rn(__ll2double_rn(s), unit));
  return (f & 4u) || (f & 3u) == 3u ? __int_as_float(0x7fc00000)
                                    : ((f & 1u) ? INFINITY : -INFINITY);
}

// A write item: rows chunk * kConvRows onwards of level l, g = f32(f64(sum) *
// 2^-k) or the value its flags give, two rows a thread.  The slot is read
// past L1, which may hold lines of its earlier levels.
__device__ void write_item(const BwdArgs& p, int l, int chunk, longlong2* sums,
                           unsigned* flags, double unit) {
  const int64_t T = int64_t(1) << p.log2T;
  const int64_t row0 = (int64_t)chunk * kConvRows;
  const int64_t rows = min((int64_t)kConvRows, T - row0);
  float* g = p.g_table + 2 * ((int64_t)l * T + row0);
  for (int64_t i = threadIdx.x; 2 * i < rows; i += kBwdThreads) {
    const int64_t r = row0 + 2 * i;
    const longlong2 s0 = __ldcg(sums + r), s1 = __ldcg(sums + r + 1);
    const unsigned f = __ldcg(flags + r / 2);  // the four entries' bytes
    const float a = from_fixed(s0.x, f & 0xffu, unit), b = from_fixed(s0.y, (f >> 8) & 0xffu, unit);
    if (2 * i + 1 < rows) {
      const float c = from_fixed(s1.x, (f >> 16) & 0xffu, unit);
      const float d = from_fixed(s1.y, f >> 24, unit);
      reinterpret_cast<float4*>(g)[i] = make_float4(a, b, c, d);
    } else {
      reinterpret_cast<float2*>(g)[2 * i] = make_float2(a, b);
    }
  }
}

// A zero item: rows chunk * kConvRows onwards of a slot, and their flags.
__device__ void zero_item(const BwdArgs& p, int chunk, longlong2* sums, unsigned* flags) {
  const int64_t Tp = int64_t(2) << max(p.log2T - 1, 0);
  const int64_t row0 = (int64_t)chunk * kConvRows;
  const int64_t rows = min((int64_t)kConvRows, Tp - row0);
  for (int64_t i = threadIdx.x; 2 * i < rows; i += kBwdThreads) {
    const int64_t r = row0 + 2 * i;
    __stcg(sums + r, make_longlong2(0, 0));
    __stcg(sums + r + 1, make_longlong2(0, 0));
    __stcg(flags + r / 2, 0u);
  }
}

// G7's persistent blocks: take items in order until none is left.
__global__ void __launch_bounds__(kBwdThreads, 2) hash_bwd_kernel(BwdArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int next;
  int items = 0;
  for (int l = 0; l < p.L; ++l) items += sum_items(p, l) + 2 * p.row_items;
  unsigned* done_zero = p.head + 2;
  unsigned* done_sum = done_zero + p.L;
  unsigned* done_write = done_sum + p.L;
  const int k = scale_exp(p.head, p.bits);
  const float scale = __int_as_float((127 + k) << 23);                   // 2^k
  const double unit = __longlong_as_double((long long)(1023 - k) << 52);  // 2^-k
  const int64_t Tp = int64_t(2) << max(p.log2T - 1, 0);
  while (true) {
    if (threadIdx.x == 0) next = atomicAdd(p.head + 1, 1);
    __syncthreads();
    const int i = next;
    __syncthreads();
    if (i >= items) break;
    Kind kind;
    int l, chunk;
    decode(p, i, kind, l, chunk);
    unsigned long long* sums = p.sums + (l % p.slots) * 2 * Tp;
    unsigned* flags = p.flags + (l % p.slots) * (Tp / 2);
    if (kind == kZero) {
      if (l >= p.slots) wait_count(done_write + l - p.slots, p.row_items);
      zero_item(p, chunk, reinterpret_cast<longlong2*>(sums), flags);
      count_done(done_zero + l);
    } else if (kind == kSum) {
      wait_count(done_zero + l, p.row_items);
      // the slot's zeroes, written by other blocks, before this block's reductions
      asm volatile("fence.proxy.async.global;" ::: "memory");
      sum_item(p, l, chunk, smem, sums, flags, scale);
      count_done(done_sum + l);
    } else {
      // with no sample, only the zero items come before
      wait_count(done_zero + l, p.row_items);
      wait_count(done_sum + l, sum_items(p, l));
      write_item(p, l, chunk, reinterpret_cast<longlong2*>(sums), flags, unit);
      count_done(done_write + l);
    }
  }
}

// The bits of the largest finite |v[i]| this warp's lanes read (a
// grid-stride loop, 16-byte loads where v is aligned), reduced over the
// warp.
__device__ __forceinline__ unsigned finite_abs_max_bits(const float* __restrict__ v,
                                                        int64_t count) {
  auto take = [](unsigned m, float x) {
    const unsigned b = __float_as_uint(x) & 0x7fffffffu;
    return b < 0x7f800000u ? max(m, b) : m;
  };
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
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

// The largest finite |cot| as bits, by one atomicMax a block (one a warp,
// all on one address, took 20.8-21.3 us at the field's shape against
// 16.8): the order of a maximum does not change it.
__global__ void abs_max_kernel(const float* __restrict__ v, int64_t count,
                               unsigned* __restrict__ maxima) {
  __shared__ unsigned warp_max[32];
  const unsigned m = finite_abs_max_bits(v, count);
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    const unsigned b = __reduce_max_sync(
        kFull, threadIdx.x < blockDim.x / 32 ? warp_max[threadIdx.x] : 0u);
    if (threadIdx.x == 0 && b != 0u) atomicMax(maxima, b);
  }
}

// The SM count and G7's resident blocks an SM, once per device (with the
// opt-in for its shared memory).
cudaError_t bwd_limits(int* blocks) {
  constexpr int kMaxDevices = 64;
  static int cache[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute((const void*)hash_bwd_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hash_bwd_kernel,
                                                          kBwdThreads, kBwdSmem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[dev] = sms * per_sm;
  }
  *blocks = cache[dev];
  return cudaSuccess;
}

// Row ids of the (L * 2^log2T)-row flat table must fit in 32 bits.
bool shape_ok(int L, int log2T) {
  return L > 0 && log2T >= 0 && log2T <= 31 &&
         ((int64_t)L << log2T) <= (int64_t(1) << 32);
}

// G7's workspace in int64 words (ops/hash_encode.py::hash_bwd_workspace_words):
// the head (2 + 3 L u32, in 32-byte units), then min(L, kMaxSlots) slots of
// sums (2 Tp int64 each) and of flags (2 Tp bytes each), Tp = max(T, 2).
int64_t bwd_head_words(int L) { return ((2 + 3 * (int64_t)L + 7) / 8) * 4; }

int64_t bwd_workspace_words(int L, int log2T) {
  const int64_t Tp = int64_t(2) << (log2T > 0 ? log2T - 1 : 0);
  const int64_t slots = L < kMaxSlots ? L : kMaxSlots;
  return bwd_head_words(L) + slots * 2 * Tp + (slots * 2 * Tp + 7) / 8;
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
// 16-byte aligned, receives the gradient.  work: work_words int64 words, at
// least bwd_workspace_words(L, log2T), 32-byte aligned; its head is zeroed
// here, its slots by the kernel.  item_samples: the samples of one level a
// sum item takes (ops/hash_encode.py::hash_bwd_item_samples), a multiple of
// kBwdThreads up to kMaxItemSamples.
extern "C" int hash_bwd(const void* x, const void* cot, const void* res,
                        void* g_table, void* work, int64_t work_words, int64_t n, int L,
                        int log2T, int item_samples, void* stream) {
  if (!shape_ok(L, log2T) || work_words < bwd_workspace_words(L, log2T) ||
      (uintptr_t)work % 32 != 0 || (uintptr_t)g_table % 16 != 0 || item_samples <= 0 ||
      item_samples % kBwdThreads != 0 || item_samples > kMaxItemSamples)
    return (int)cudaErrorInvalidValue;
  const int64_t Tp = int64_t(2) << (log2T > 0 ? log2T - 1 : 0);
  const int64_t most_sum_items = (n + item_samples - 1) / item_samples;  // a level's, at most
  const int64_t row_items = (Tp + kConvRows - 1) / kConvRows;
  const int64_t items = (most_sum_items + 2 * row_items) * L;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int resident = 0;
  cudaError_t err = bwd_limits(&resident);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  err = cudaMemsetAsync(work, 0, bwd_head_words(L) * 8, st);
  if (err != cudaSuccess) return (int)err;
  BwdArgs p;
  p.x = (const float*)x;
  p.cot = (const float2*)cot;
  p.res = (const float*)res;
  p.g_table = (float*)g_table;
  p.head = (unsigned*)work;
  p.slots = L < kMaxSlots ? L : kMaxSlots;
  p.sums = (unsigned long long*)work + bwd_head_words(L);
  p.flags = (unsigned*)(p.sums + p.slots * 2 * Tp);
  p.n = n;
  p.L = L;
  p.log2T = log2T;
  p.bits = 1;  // the bit length of 8 n, plus one
  for (int64_t c = 8 * n; c != 0; c >>= 1) ++p.bits;
  p.item_samples = item_samples;
  p.row_items = (int)row_items;
  if (n > 0) {
    const int64_t count = n * 2 * L;
    int64_t blocks = (count + 255) / 256;
    blocks = blocks < 4 * resident ? blocks : 4 * resident;
    abs_max_kernel<<<(unsigned)blocks, 256, 0, st>>>((const float*)cot, count, p.head);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (int)(items < resident ? items : resident);
  hash_bwd_kernel<<<grid, kBwdThreads, kBwdSmem, st>>>(p);
  return (int)cudaGetLastError();
}
