// Greedy non-maximum suppression in two launches: the suppression bits of
// the score-sorted boxes, computed across the card, then the greedy sweep
// over 64-bit words, one warp a row.
//
// Replaces no Pallas kernel. It is nms_mask of
// bigdl_tpu/nn/detection.py:56-79: pairwise_iou of the sorted boxes, then
// a lax.fori_loop of K steps inside one XLA program; in PyTorch the loop
// would be about 4 launches a step (K = 400 for SSD's nms_topk, 1,333 for
// a Mask R-CNN proposal level, 999 for its class rows).
//
// bigdl_nms_mask_words: boxes (rows, K, 4) fp32, score-sorted, their alive
// flags (rows, K) and the threshold -> words (rows, K, W) uint64,
// W = ceil(K / 64). Bit b of words[r][j][w] is set iff i = 64 w + b has
// j < i < K, j and i both alive and IoU(box j, box i) > thr. Grid: x walks
// the pairs (jb, ib), ib >= jb, of 64-candidate blocks, y the rows. A CTA
// of 64 threads stages its 64 i boxes and their areas in shared memory;
// thread t owns j = 64 jb + t and writes its one word of block ib (the
// diagonal CTA also zeroes the words w < jb, so every word is defined).
// A dead candidate's box is never read and its IoUs are never computed: a
// CTA whose i block holds no alive candidate, or a warp whose 32 j are all
// dead, only writes zero words. No (rows, K, K) IoU tensor is formed: the
// words are K / 8 bytes a candidate, against 4 K of fp32 IoUs.
//
// The IoU is pairwise_iou of kernels/nms.py operation by operation, each
// rounded on its own as torch's elementwise kernels round it: __fsub_rn,
// __fmul_rn, __fadd_rn and __fdiv_rn, which nvcc never contracts into an
// FMA; (area_a + area_b) - inter in that order; max, min and the clamps
// propagating NaN as torch.maximum, torch.minimum and clamp do (max.NaN,
// min.NaN; fmaxf would drop the NaN); 0 where the union is not > 0. The
// division is taken only where two exact-sign FMAs do not decide
// `inter / union > thr` (classify): within an ulp of thr, or a zero or NaN
// difference. So the words are bit for bit those of the plain version on
// the same card, and the comparison with thr is the fp32 one of
// `iou > thr`.
//
// bigdl_nms_sweep_words: words and the alive flags (rows, K) -> keep
// (rows, K). One warp a row, the row's "removed" bits W words in shared
// memory; lane l owns candidates 64 b + l and 64 b + 32 + l of block b.
// For each block the warp stages the diagonal words words[j][b] (their
// bits above j) and resolves the 64 candidates in order in registers: j
// is kept iff alive and not removed, and keeping it removes what its
// diagonal word marks (three dependent operations a candidate). Each lane
// then reads its kept candidates' later words words[j][w > b], and a warp
// reduction ORs them into "removed", the words independent of each other,
// while the next block's diagonal words and alive flags load. W serial
// block steps (21 at K = 1,333), no block barrier. The sweep reads only
// bits i > j of kept j, as JAX's loop reads only iou[j, i] with j < i of
// kept j: the keep bits are JAX's exactly, whatever the words hold for
// dead candidates. The other layout, lanes owning words (lane l ORing
// word b + 1 + l of the block's kept rows, coalesced, no reduction), was
// measured slower or equal at every path shape on the H100 (PERF.md).
//
// What bounds it: the suppression bits are one IoU of about 13 fp32
// operations for every pair of alive candidates, spread over every SM;
// the sweep is W dependent block steps a row (a shared-memory round and a
// global load each), hidden across rows only when there are many rows.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;        // candidates a word
constexpr int kSweepWarps = 4;    // rows a sweep CTA
constexpr int kMaxK = 32768;      // W <= 512: the sweep's shared memory

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(max_nan(__fsub_rn(b.z, b.x), 0.f),
                   max_nan(__fsub_rn(b.w, b.y), 0.f));
}

struct Overlap {
  float inter, uni;
};

// pairwise_iou's intersection and union of a (the earlier, row box) and b
__device__ __forceinline__ Overlap overlap(float4 a, float area_a, float4 b,
                                          float area_b) {
  const float ix1 = max_nan(a.x, b.x);
  const float iy1 = max_nan(a.y, b.y);
  const float ix2 = min_nan(a.z, b.z);
  const float iy2 = min_nan(a.w, b.w);
  const float inter = __fmul_rn(max_nan(__fsub_rn(ix2, ix1), 0.f),
                                max_nan(__fsub_rn(iy2, iy1), 0.f));
  return {inter, __fsub_rn(__fadd_rn(area_a, area_b), inter)};
}

// where(union > 0, inter / union, 0) > thr, the division rounded as torch's
__device__ __forceinline__ bool above_exact(Overlap o, float thr) {
  const float iou = o.uni > 0.f ? __fdiv_rn(o.inter, o.uni) : 0.f;
  return iou > thr;
}

// The same test without the division where its sign decides it. For
// union > 0, q = inter / union exactly and Q = q rounded: Q > thr iff
// q > thr and Q != thr. fma(-thr, union, inter) is inter - thr union
// rounded once, so its sign is the exact difference's wherever it is not
// 0: < 0 means q < thr (false); fma(-thr_up, union, inter) > 0, thr_up the
// float after thr, means q > thr_up (true). Anything else (q within one
// ulp above thr, a zero or NaN difference) is left to above_exact. An
// infinite inter never meets a positive union here: overlap's union is
// then (area_a + area_b) - inf, NaN or -inf.
struct Verdict {
  bool yes, undecided;
};

__device__ __forceinline__ Verdict classify(Overlap o, float neg_thr,
                                            float neg_thr_up,
                                            bool zero_above) {
  const float below = __fmaf_rn(neg_thr, o.uni, o.inter);
  const float over = __fmaf_rn(neg_thr_up, o.uni, o.inter);
  const bool pos = o.uni > 0.f;
  return {pos ? over > 0.f : zero_above,
          pos && !(below < 0.f) && !(over > 0.f)};
}

__global__ void __launch_bounds__(kBlock)
nms_mask_words_kernel(const float4* __restrict__ boxes,
                      const unsigned char* __restrict__ alive,
                      unsigned long long* __restrict__ words, long long rows,
                      int k, int w, float thr) {
  __shared__ float4 ibox[kBlock];
  __shared__ float iarea[kBlock];
  __shared__ unsigned ilive[kBlock / 32];
  int p = blockIdx.x, jb = 0;   // the pair (jb, ib) of this CTA, jb-major
  while (p >= w - jb) {
    p -= w - jb;
    ++jb;
  }
  const int ib = jb + p;
  const int t = threadIdx.x;
  const int j = jb * kBlock + t, i0 = ib * kBlock;
  const float neg_thr = -thr, neg_thr_up = -nextafterf(thr, INFINITY);
  const bool zero_above = 0.f > thr;
  // the bits this thread may set: i > j, i < k
  unsigned long long valid = k - i0 >= kBlock ? ~0ull : (1ull << (k - i0)) - 1;
  if (ib == jb) valid &= t >= kBlock - 1 ? 0ull : ~0ull << (t + 1);
  const float nan = __int_as_float(0x7fffffff);
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const float4* rb = boxes + row * k;
    const unsigned char* ra = alive + row * k;
    __syncthreads();   // the last row's reads of the stage are done
    // a dead or missing i: a NaN box (its bits are masked off anyway)
    const bool ai = i0 + t < k && ra[i0 + t] != 0;
    const float4 bi = ai ? rb[i0 + t] : make_float4(nan, nan, nan, nan);
    ibox[t] = bi;
    iarea[t] = area(bi);
    const unsigned ball = __ballot_sync(0xffffffffu, ai);
    if ((t & 31) == 0) ilive[t >> 5] = ball;
    __syncthreads();
    if (j >= k) continue;
    unsigned long long* out = words + (row * k + j) * w;
    if (ib == jb)
      for (int x = 0; x < jb; ++x) out[x] = 0;
    const unsigned long long live =
        ((unsigned long long)ilive[1] << 32 | ilive[0]) & valid;
    unsigned long long bits = 0;
    if (live && ra[j] != 0) {
      const float4 a = rb[j];
      const float area_a = area(a);
      unsigned lo = 0, hi = 0, slo = 0, shi = 0;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const Verdict v = classify(overlap(a, area_a, ibox[b], iarea[b]),
                                   neg_thr, neg_thr_up, zero_above);
        lo |= (unsigned)v.yes << b;
        slo |= (unsigned)v.undecided << b;
      }
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const Verdict v = classify(
            overlap(a, area_a, ibox[b + 32], iarea[b + 32]), neg_thr,
            neg_thr_up, zero_above);
        hi |= (unsigned)v.yes << b;
        shi |= (unsigned)v.undecided << b;
      }
      bits = ((unsigned long long)hi << 32 | lo) & live;
      unsigned long long slow =
          ((unsigned long long)shi << 32 | slo) & live;
      while (slow) {   // rare: within an ulp of thr, or a 0 or NaN difference
        const int b = __ffsll((long long)slow) - 1;
        slow &= slow - 1;
        if (above_exact(overlap(a, area_a, ibox[b], iarea[b]), thr))
          bits |= 1ull << b;
      }
    }
    out[ib] = bits;
  }
}

// bits strictly above bit t
__device__ __forceinline__ unsigned long long above(int t) {
  return t >= 63 ? 0ull : ~0ull << (t + 1);
}

__device__ __forceinline__ unsigned long long warp_or(unsigned long long v) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)v);
  const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(v >> 32));
  return (unsigned long long)hi << 32 | lo;
}

__global__ void __launch_bounds__(32 * kSweepWarps)
nms_sweep_words_kernel(const unsigned long long* __restrict__ words,
                       const unsigned char* __restrict__ alive,
                       unsigned char* __restrict__ keep, long long rows,
                       int k, int w) {
  extern __shared__ unsigned long long smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned long long* removed = smem + warp * (w + kBlock);
  unsigned long long* diag = removed + w;
  const long long row = (long long)blockIdx.x * kSweepWarps + warp;
  if (row >= rows) return;   // whole warps only: no CTA-wide barrier below
  const unsigned long long* m = words + row * k * w;
  const unsigned char* al = alive + row * k;
  unsigned char* kp = keep + row * k;
  for (int x = lane; x < w; x += 32) removed[x] = 0;
  // lane l owns candidates j0 + l and j0 + 32 + l of each block: their
  // diagonal words and alive flags load while the block before ORs
  int ja = lane, jz = lane + 32;
  unsigned long long da = ja < k ? m[(long long)ja * w] : 0ull;
  unsigned long long dz = jz < k ? m[(long long)jz * w] : 0ull;
  bool aa = ja < k && al[ja] != 0, az = jz < k && al[jz] != 0;
  for (int b = 0; b < w; ++b) {
    const unsigned long long live =
        ((unsigned long long)__ballot_sync(0xffffffffu, az) << 32)
        | __ballot_sync(0xffffffffu, aa);
    diag[lane] = da & above(lane);
    diag[lane + 32] = dz & above(lane + 32);
    __syncwarp();
    // removed[b] holds every bit set by kept candidates of earlier blocks;
    // in-block bits only come from earlier candidates of the block (the
    // diagonal words hold bits above their own), so live & ~rem at the end
    // is the block's keep bits. The loads do not depend on rem: they issue
    // ahead of the chain, which is three operations a candidate.
    unsigned long long rem = removed[b];
    if (live & ~rem) {
#pragma unroll
      for (int t = 0; t < kBlock; ++t) {
        const unsigned long long d = diag[t];
        rem |= ((live & ~rem) >> t & 1ull) ? d : 0ull;
      }
    }
    const unsigned long long kept = live & ~rem;
    const bool ka = kept >> lane & 1ull, kz = kept >> (lane + 32) & 1ull;
    if (ja < k) kp[ja] = (unsigned char)ka;
    if (jz < k) kp[jz] = (unsigned char)kz;
    const unsigned long long* ra = m + (long long)ja * w;
    const unsigned long long* rz = m + (long long)jz * w;
    if (b + 1 < w) {
      ja += kBlock;
      jz += kBlock;
      da = ja < k ? m[(long long)ja * w + b + 1] : 0ull;
      dz = jz < k ? m[(long long)jz * w + b + 1] : 0ull;
      aa = ja < k && al[ja] != 0;
      az = jz < k && al[jz] != 0;
    }
    if (kept) {
      // the kept candidates' later words, ORed across the warp: each lane
      // reads its own two candidates' rows, the words independent
#pragma unroll 4
      for (int x = b + 1; x < w; ++x) {
        const unsigned long long v =
            warp_or((ka ? ra[x] : 0ull) | (kz ? rz[x] : 0ull));
        if (lane == 0) removed[x] |= v;
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int bigdl_nms_mask_words(const void* boxes, const void* alive,
                                    void* words, long long rows, int k,
                                    float thr, void* stream) {
  if (rows == 0 || k == 0) return 0;
  if (rows < 0 || k < 0 || k > kMaxK) return (int)cudaErrorInvalidValue;
  const int w = (k + kBlock - 1) / kBlock;
  const dim3 grid((unsigned)(w * (w + 1) / 2),
                  (unsigned)(rows < 65535 ? rows : 65535));
  nms_mask_words_kernel<<<grid, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes),
      static_cast<const unsigned char*>(alive),
      static_cast<unsigned long long*>(words), rows, k, w, thr);
  return (int)cudaGetLastError();
}

extern "C" int bigdl_nms_sweep_words(const void* words, const void* alive,
                                     void* keep, long long rows, int k,
                                     void* stream) {
  if (rows == 0 || k == 0) return 0;
  const long long ctas = (rows + kSweepWarps - 1) / kSweepWarps;
  if (rows < 0 || k < 0 || k > kMaxK || ctas > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int w = (k + kBlock - 1) / kBlock;
  const int smem = kSweepWarps * (w + kBlock) * (int)sizeof(unsigned long long);
  nms_sweep_words_kernel<<<(unsigned)ctas, 32 * kSweepWarps, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(words),
      static_cast<const unsigned char*>(alive),
      static_cast<unsigned char*>(keep), rows, k, w);
  return (int)cudaGetLastError();
}
