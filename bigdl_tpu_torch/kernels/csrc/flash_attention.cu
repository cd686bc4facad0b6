// Flash-attention forward for sm_90a: wgmma on the tensor cores, fed by a
// TMA ring of K/V tiles.
//
// Replaces the Pallas kernel bigdl_tpu/kernels/flash_attention.py:54
// (_pallas_flash_call): streaming-softmax attention over (B*H, T, d) with
// the running max m, sum l and accumulator O in fp32, scale 1/sqrt(d),
// causal tiles above the diagonal skipped, denom = max(l, 1e-37), and the
// per-row logsumexp lse = m + log(denom) (natural log, fp32) written beside
// O for the backward kernels.
//
// Bound. bf16 at the main path's shapes is bound by bytes (q, k, v, o, lse
// once each; 4·d flops per live (query, key) pair at 989 TFLOP/s are
// less). fp32 runs three TF32 products for each product (below), so its
// bound is operations: 3 · 4·d flops per pair at 495 TFLOP/s.
//
// Design:
//  - One CTA per (b·h, query tile); tiles are issued last first so causal
//    tails (the most key tiles) start early. A CTA is NWG consumer
//    warpgroups (64 query rows each) plus one producer warp.
//  - The producer warp's lane 0 loads Q once, then streams K/V tiles with
//    TMA (cp.async.bulk.tensor, 3-D maps over (d, T, b·h)) into a ring of
//    kStages stages. Each stage has a full mbarrier (TMA transaction bytes)
//    and an empty one (one arrival per consumer thread).
//  - S = Q·Kᵀ and O += P·V are wgmma with fp32 accumulators in registers;
//    the online softmax runs on the S fragment in registers, in log2 units
//    (scores pre-scaled by log2(e)/sqrt(d), one exp2f per score).
//  - bf16: Q, K from shared memory K-major (128- or 64-byte swizzle, as TMA
//    wrote them); V is the B operand MN-major (transpose bit), no copy. P
//    is rounded to bf16 and fed from registers: the S accumulator fragment
//    is already the A fragment of the second product. JAX multiplies p·v
//    in fp32; rounding P to bf16 is this port's choice (held to the bf16
//    tolerance, 2e-2, by tests/test_torch_flash_numerics.py).
//  - fp32: 3xTF32. Every operand x is split into big = x with its low 13
//    mantissa bits cleared and small = tf32(x - big); each product is
//    a_big·b_big + a_big·b_small + a_small·b_big (~2^-21 relative).
//    One-pass TF32 misses the fp32 tolerance when scores reach ~1e3.
//    tf32 wgmma takes only K-major shared-memory operands, so the
//    consumers convert each raw K/V stage into a working set: K big and
//    small (K-major, 128-byte swizzle) and Vᵀ big and small (keys
//    contiguous). The tf32 A-register fragment holds columns (t, t+4) of
//    each 8-wide k-step where the accumulator holds (2t, 2t+1), so Vᵀ's
//    keys are stored permuted inside each group of 8 (logical p holds key
//    2p, or 2(p-4)+1 for p >= 4): P·V is a sum over keys, and the same
//    permutation on both sides leaves it unchanged (hopper.cuh
//    split_kmajor, split_transposed). Q is split in place once. P is split
//    in registers.
//  - Causal: key tiles wholly above the CTA's last row are never loaded; a
//    warpgroup skips tiles above its own rows. Only the diagonal tile and
//    the ragged last tile run the masked softmax (keys >= T and keys above
//    the diagonal to -inf by index: TMA zero-fills keys past T, and a zero
//    key scores 0, not -inf). Rows >= T are computed but not stored.
//  - Tile sizes: bf16 64 keys a tile, fp32 32. NWG is 2 when two-warpgroup
//    CTAs still give at least one CTA per SM (b·h · ceil(T / 128) >= SMs)
//    and T > 64, else 1: so the serving shape (16, 512, 64) runs 128
//    one-warpgroup CTAs and the training shape (128, 512, 64) 512
//    two-warpgroup CTAs. fp32 at d = 128 always takes NWG = 1 (two would
//    need more than 227 KB of shared memory).
//  - Tensor maps are encoded on the host for every call (the pointers
//    change) through cudaGetDriverEntryPoint, so no -lcuda (tma.cuh), and
//    passed as __grid_constant__ parameters. The kernel allocates nothing.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"
#include "tma.cuh"

namespace {

using namespace bigdl::sm90;

constexpr float kLn2 = 0.6931471805599453f;

template <typename T, int D, int NWG>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kBN = kF32 ? 32 : 64;        // keys per tile
  static constexpr int kBM = 64 * NWG;              // query rows per CTA
  static constexpr int kConsumers = 128 * NWG;
  static constexpr int kThreads = kConsumers + 32;  // + the producer warp
  static constexpr int kStages = 2;
  // K-major shared tiles are D / kCB column blocks of rows of kRB bytes
  static constexpr int kCB = kF32 ? 32 : (D < 64 ? D : 64);
  static constexpr int kRB = kCB * (int)sizeof(T);  // 128, or 64 (bf16 d 32)
  static constexpr int kKSteps = kRB / 32;          // wgmma k-steps a row
  static constexpr int kQBytes = kBM * D * (int)sizeof(T);
  static constexpr int kTile = kBN * D * (int)sizeof(T);  // one K or V tile
  // shared memory, from a 1024-byte aligned base; every region is a
  // multiple of 1024 bytes
  static constexpr int kQ = 0;                    // Q (fp32: its big part)
  static constexpr int kQs = kQ + kQBytes;        // fp32: Q's small part
  static constexpr int kRing = kQs + (kF32 ? kQBytes : 0);
  static constexpr int kWork = kRing + kStages * 2 * kTile;  // fp32 only
  static constexpr int kBars = kWork + (kF32 ? 4 * kTile : 0);
  static constexpr int kAlloc = kBars + (2 * kStages + 1) * 8 + 1024;
  static_assert(kAlloc <= 232448, "over the 227 KB a block may use");
};

// Row max and sum over the four lanes that share a row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Online softmax of one S tile in place (S becomes P), rescaling the
// running state and O. `row` is this thread's first row (the second is
// row + 8), `key` the first key of its first column pair.
template <bool MASK, int NS, int NO>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&o)[NO],
                                             float (&m)[2], float (&l)[2],
                                             float scale_log2, int row,
                                             int key, int t, int causal) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float x = s[i] * scale_log2;
    if constexpr (MASK) {
      const int kj = key + 8 * (i / 4) + (i & 1);
      const int qi = row + 8 * ((i >> 1) & 1);
      if (kj >= t || (causal && kj > qi)) x = -INFINITY;
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = quad_max(mx[h]);  // finite: key 0 is live in the first tile
    alpha[h] = exp2f(m[h] - mx[h]);  // 0 while m is still -inf
    m[h] = mx[h];
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    s[i] = exp2f(s[i] - mx[(i >> 1) & 1]);  // masked keys give exactly 0
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// bf16: S = Q·Kᵀ, softmax, O += bf16(P)·V for one key tile.
template <typename C, bool MASK, int D>
__device__ __forceinline__ void tile_bf16(float (&o)[D / 2], float (&m)[2],
                                          float (&l)[2], uint32_t q_addr,
                                          uint32_t k_addr, uint32_t v_addr,
                                          float scale_log2, int row, int key,
                                          int t, int causal) {
  float s[C::kBN / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t blk = kk / C::kKSteps, step = (kk % C::kKSteps) * 32;
    const uint64_t da = smem_desc(q_addr + blk * C::kBM * C::kRB + step, 16,
                                  8 * C::kRB, C::kRB);
    const uint64_t db = smem_desc(k_addr + blk * C::kBN * C::kRB + step, 16,
                                  8 * C::kRB, C::kRB);
    wgmma_ss_bf16(s, da, db, kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);

  softmax_tile<MASK>(s, o, m, l, scale_log2, row, key, t, causal);

  uint32_t p[C::kBN / 4];
#pragma unroll
  for (int i = 0; i < C::kBN / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::kBN / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    const uint64_t db = smem_desc(v_addr + kk * 16 * C::kRB,
                                  C::kBN * C::kRB, 8 * C::kRB, C::kRB);
    wgmma_rs_bf16(o, a, db, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
}

// fp32 (3xTF32): the same on the split operands of the working set.
template <typename C, bool MASK, int D>
__device__ __forceinline__ void tile_f32(float (&o)[D / 2], float (&m)[2],
                                         float (&l)[2], uint32_t qb_addr,
                                         uint32_t qs_addr, uint32_t work,
                                         float scale_log2, int row, int key,
                                         int t, int causal) {
  const uint32_t kb = work, ks = work + C::kTile;
  const uint32_t vtb = work + 2 * C::kTile, vts = work + 3 * C::kTile;
  float s[C::kBN / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t blk = kk / C::kKSteps, step = (kk % C::kKSteps) * 32;
    const uint32_t oa = blk * C::kBM * C::kRB + step;
    const uint32_t ob = blk * C::kBN * C::kRB + step;
    wgmma_ss_tf32(s, smem_desc(qs_addr + oa, 16, 8 * C::kRB, C::kRB),
                  smem_desc(kb + ob, 16, 8 * C::kRB, C::kRB), kk > 0);
    wgmma_ss_tf32(s, smem_desc(qb_addr + oa, 16, 8 * C::kRB, C::kRB),
                  smem_desc(ks + ob, 16, 8 * C::kRB, C::kRB), 1);
    wgmma_ss_tf32(s, smem_desc(qb_addr + oa, 16, 8 * C::kRB, C::kRB),
                  smem_desc(kb + ob, 16, 8 * C::kRB, C::kRB), 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);

  softmax_tile<MASK>(s, o, m, l, scale_log2, row, key, t, causal);

  uint32_t pb[C::kBN / 2], ps[C::kBN / 2];
#pragma unroll
  for (int i = 0; i < C::kBN / 2; ++i) split_tf32(s[i], pb[i], ps[i]);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < C::kBN / 8; ++j) {
    // A fragment (g, t), (g+8, t), (g, t+4), (g+8, t+4) of k-step j from
    // accumulator columns 2t, 2t+1: see the key permutation of Vᵀ
    const uint32_t ab[4] = {pb[4 * j], pb[4 * j + 2], pb[4 * j + 1],
                            pb[4 * j + 3]};
    const uint32_t as[4] = {ps[4 * j], ps[4 * j + 2], ps[4 * j + 1],
                            ps[4 * j + 3]};
    const uint64_t db = smem_desc(vtb + j * 32, 16, 8 * C::kRB, C::kRB);
    wgmma_rs_tf32(o, as, db, 1);
    wgmma_rs_tf32(o, ab, smem_desc(vts + j * 32, 16, 8 * C::kRB, C::kRB), 1);
    wgmma_rs_tf32(o, ab, db, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
}

template <typename T, int D, int NWG>
__global__ void __launch_bounds__(Cfg<T, D, NWG>::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 T* __restrict__ o, float* __restrict__ lse, int t,
                 int causal, float scale_log2) {
  using C = Cfg<T, D, NWG>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* empty = full + C::kStages;
  uint64_t* q_full = empty + C::kStages;

  const int bh = blockIdx.x;
  // last query tiles first: under causal masking they stream the most key
  // tiles, so starting them early shortens the tail of the grid
  const int m0 = (gridDim.y - 1 - blockIdx.y) * C::kBM;
  const int k_end = causal ? min(t, m0 + C::kBM) : t;
  const int n_tiles = (k_end + C::kBN - 1) / C::kBN;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::kConsumers);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // ---------------------------- producer warp
    if (threadIdx.x % 32 != 0) return;
    mbar_arrive_expect_tx(q_full, C::kQBytes);
    for (int cb = 0; cb < D / C::kCB; ++cb)
      tma_load_3d(smem + C::kQ + cb * C::kBM * C::kRB, &qmap, q_full,
                  cb * C::kCB, m0, bh);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % C::kStages;
      mbar_wait(&empty[s], ((i / C::kStages) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[s], 2 * C::kTile);
      unsigned char* kt = smem + C::kRing + s * 2 * C::kTile;
      if constexpr (C::kF32) {  // raw tiles, one box each
        tma_load_3d(kt, &kmap, &full[s], 0, i * C::kBN, bh);
        tma_load_3d(kt + C::kTile, &vmap, &full[s], 0, i * C::kBN, bh);
      } else {
        for (int cb = 0; cb < D / C::kCB; ++cb) {
          tma_load_3d(kt + cb * C::kBN * C::kRB, &kmap, &full[s],
                      cb * C::kCB, i * C::kBN, bh);
          tma_load_3d(kt + C::kTile + cb * C::kBN * C::kRB, &vmap, &full[s],
                      cb * C::kCB, i * C::kBN, bh);
        }
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  const int tid = threadIdx.x;
  const int wg = warp / 4, lane = tid % 32;
  const int r0 = m0 + 64 * wg;  // this warpgroup's first row
  const int row = r0 + 16 * (warp % 4) + lane / 4;  // and row + 8
  const int col = 2 * (lane % 4);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const uint32_t q_addr = smem_addr(smem + C::kQ) + 64 * wg * C::kRB;
  const uint32_t qs_addr = smem_addr(smem + C::kQs) + 64 * wg * C::kRB;
  mbar_wait(q_full, 0);
  if constexpr (C::kF32) {  // split Q: big in place, small beside it
    split_in_place(smem + C::kQ, C::kQBytes, tid, C::kConsumers);
    fence_proxy_async();
    named_barrier(1, C::kConsumers);
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % C::kStages;
    mbar_wait(&full[s], (i / C::kStages) & 1);
    unsigned char* kt = smem + C::kRing + s * 2 * C::kTile;
    if constexpr (C::kF32) {
      // the working set: K big and small (K-major), Vᵀ big and small
      unsigned char* work = smem + C::kWork;
      split_kmajor<C::kBN, D>(reinterpret_cast<const float*>(kt), work, tid,
                              C::kConsumers);
      split_transposed<C::kBN, D>(
          reinterpret_cast<const float*>(kt + C::kTile), work + 2 * C::kTile,
          tid, C::kConsumers);
      fence_proxy_async();
      mbar_arrive(&empty[s]);  // the raw stage may be refilled now
      named_barrier(1, C::kConsumers);
    }
    const int n0 = i * C::kBN;
    if (!causal || n0 <= r0 + 63) {  // else wholly above this warpgroup
      const bool masked =
          n0 + C::kBN > t || (causal && n0 + C::kBN - 1 > r0);
      const int key = n0 + col;
      if constexpr (C::kF32) {
        const uint32_t work = smem_addr(smem + C::kWork);
        if (masked)
          tile_f32<C, true, D>(acc, m, l, q_addr, qs_addr, work, scale_log2,
                               row, key, t, causal);
        else
          tile_f32<C, false, D>(acc, m, l, q_addr, qs_addr, work, scale_log2,
                                row, key, t, causal);
      } else {
        const uint32_t k_addr = smem_addr(kt);
        const uint32_t v_addr = k_addr + C::kTile;
        if (masked)
          tile_bf16<C, true, D>(acc, m, l, q_addr, k_addr, v_addr,
                                scale_log2, row, key, t, causal);
        else
          tile_bf16<C, false, D>(acc, m, l, q_addr, k_addr, v_addr,
                                 scale_log2, row, key, t, causal);
      }
    }
    if constexpr (C::kF32)
      named_barrier(1, C::kConsumers);  // the working set is free again
    else
      mbar_arrive(&empty[s]);
  }

  // -------------------------------------------------------- epilogue
  const size_t base = (size_t)bh * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = row + 8 * h;
    const float denom = fmaxf(quad_sum(l[h]), 1e-37f);
    if (qi >= t) continue;
    const float inv = 1.f / denom;
    T* out = o + (base + qi) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float a = acc[4 * j + 2 * h] * inv;
      const float b = acc[4 * j + 2 * h + 1] * inv;
      if constexpr (C::kF32)
        *reinterpret_cast<float2*>(out + 8 * j) = make_float2(a, b);
      else
        *reinterpret_cast<uint32_t*>(out + 8 * j) = pack_bf16(a, b);
    }
    if (lane % 4 == 0) lse[base + qi] = m[h] * kLn2 + logf(denom);
  }
}

// ------------------------------------------------------------------ host
template <typename T, int D, int NWG>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, long long bh, int t, int causal,
                   cudaStream_t stream) {
  using C = Cfg<T, D, NWG>;
  CUtensorMap qm, km, vm;
  // Q: K-major swizzled blocks (fp32: split in place by the consumers);
  // K/V: the same for bf16, raw rows for fp32 (the consumers convert)
  const int sw = C::kRB;
  bool ok = make_map(&qm, q, C::kF32, bh, t, D, C::kCB, C::kBM, sw);
  if constexpr (C::kF32)
    ok = ok && make_map(&km, k, true, bh, t, D, D, C::kBN, 0) &&
         make_map(&vm, v, true, bh, t, D, D, C::kBN, 0);
  else
    ok = ok && make_map(&km, k, false, bh, t, D, C::kCB, C::kBN, sw) &&
         make_map(&vm, v, false, bh, t, D, C::kCB, C::kBN, sw);
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_kernel<T, D, NWG>;
  cudaError_t err =
      bigdl::allow_dynamic_smem<flash_fwd_kernel<T, D, NWG>>(C::kAlloc);
  if (err != cudaSuccess) return err;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  const dim3 grid((unsigned)bh, (unsigned)((t + C::kBM - 1) / C::kBM));
  kernel<<<grid, C::kThreads, C::kAlloc, stream>>>(
      qm, km, vm, static_cast<T*>(o), static_cast<float*>(lse), t, causal,
      scale_log2);
  return cudaGetLastError();
}

// Two consumer warpgroups a CTA when that still gives every SM a CTA and
// their shared memory fits.
int consumer_warpgroups(bool f32, int d, long long bh, int t) {
  return f32 && d == 128 ? 1 : bigdl::sm90::consumer_warpgroups(bh, t);
}

template <typename T, int D>
cudaError_t launch_wg(const void* q, const void* k, const void* v, void* o,
                      void* lse, long long bh, int t, int causal,
                      cudaStream_t stream) {
  constexpr bool kF32 = sizeof(T) == 4;
  if (consumer_warpgroups(kF32, D, bh, t) == 2)
    return launch<T, D, kF32 && D == 128 ? 1 : 2>(q, k, v, o, lse, bh, t,
                                                  causal, stream);
  return launch<T, D, 1>(q, k, v, o, lse, bh, t, causal, stream);
}

template <typename T, int D>
void plan(int nwg, int* threads, int* smem) {
  constexpr int kTwo = sizeof(T) == 4 && D == 128 ? 1 : 2;
  *threads = nwg == 2 ? Cfg<T, D, kTwo>::kThreads : Cfg<T, D, 1>::kThreads;
  *smem = nwg == 2 ? Cfg<T, D, kTwo>::kAlloc : Cfg<T, D, 1>::kAlloc;
}

template <typename T>
cudaError_t plan_dim(int d, int nwg, int* threads, int* smem) {
  switch (d) {
    case 32: plan<T, 32>(nwg, threads, smem); return cudaSuccess;
    case 64: plan<T, 64>(nwg, threads, smem); return cudaSuccess;
    case 128: plan<T, 128>(nwg, threads, smem); return cudaSuccess;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v, void* o,
                       void* lse, long long bh, int t, int d, int causal,
                       cudaStream_t stream) {
  switch (d) {
    case 32: return launch_wg<T, 32>(q, k, v, o, lse, bh, t, causal, stream);
    case 64: return launch_wg<T, 64>(q, k, v, o, lse, bh, t, causal, stream);
    case 128: return launch_wg<T, 128>(q, k, v, o, lse, bh, t, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (bh, t, d) contiguous in `dtype`, 16-byte aligned; lse: (bh, t)
// float32. d is 32, 64 or 128. Returns the cudaError_t of the launch.
extern "C" int bigdl_flash_attn_fwd(const void* q, const void* k, const void* v,
                                    void* o, void* lse, long long bh, int t,
                                    int d, int causal, int dtype,
                                    void* stream) {
  if (bh <= 0 || t <= 0) return 0;
  if (bh > 0x7fffffffLL || (t + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kFloat32)
    return (int)launch_dim<float>(q, k, v, o, lse, bh, t, d, causal, s);
  if (dtype == bigdl::kBFloat16)
    return (int)launch_dim<__nv_bfloat16>(q, k, v, o, lse, bh, t, d, causal, s);
  return (int)cudaErrorInvalidValue;
}

// The launch bigdl_flash_attn_fwd makes for these operands: consumer
// warpgroups a CTA, threads a CTA and dynamic shared memory bytes a CTA.
extern "C" int bigdl_flash_attn_fwd_plan(long long bh, int t, int d,
                                         int dtype, int* nwg, int* threads,
                                         int* smem) {
  const bool f32 = dtype == bigdl::kFloat32;
  if ((!f32 && dtype != bigdl::kBFloat16) || bh <= 0 || t <= 0)
    return (int)cudaErrorInvalidValue;
  *nwg = consumer_warpgroups(f32, d, bh, t);
  return (int)(f32 ? plan_dim<float>(d, *nwg, threads, smem)
                   : plan_dim<__nv_bfloat16>(d, *nwg, threads, smem));
}
