// Flash-attention backward for sm_90a: two kernels, dq and dk/dv, with
// every product on the tensor cores (wgmma) and the streamed tiles fed by
// a TMA ring.
//
// Replace the Pallas kernels bigdl_tpu/kernels/flash_attention.py:132
// (_pallas_flash_bwd_dq) and :199 (_pallas_flash_bwd_dkv). Both recompute
// the probabilities p = exp(s - L) from (q, k) and the forward's per-row
// natural-log logsumexp L, with s = q·kᵀ/sqrt(d), and take
// D = rowsum(dO∘O) from the caller:
//   dq = Σ_j ds_ij · k_j · scale        (one CTA per query tile)
//   dv = Σ_i p_ij · dO_i,  dk = Σ_i ds_ij · q_i · scale   (one CTA per key tile)
// with ds_ij = p_ij · (dO_i·v_j − D_i). Keeping the two kernels apart, as
// JAX does, leaves every output owned by one CTA: no atomics, the sums run
// in a fixed order, and two calls on the same inputs agree bit for bit.
//
// Bound: operations (6·d flops per live (query, key) pair for dq, 8·d for
// dk/dv, against O(T·d) bytes). fp32 runs three TF32 products for each
// product, so its bound is 3 · (6·d or 8·d) flops per pair at 495 TFLOP/s.
//
// Design. One body serves both kernels. A CTA holds 64·NWG "resident" rows
// of two operands R0, R1 and streams tiles of kBN rows of two others X0, X1:
//            R0, R1   X0, X1   products per tile
//   dq       Q, dO    K, V     S = Q·Kᵀ, dP = dO·Vᵀ; dQ += dS·K
//   dk/dv    K, V     Q, dO    Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ; dV += Pᵀ·dO, dK += dSᵀ·Q
// so S = R0·X0ᵀ and dP = R1·X1ᵀ (all operands K-major, as TMA writes them),
// then acc0 += dS·X0 (dq or dk) and, for dk/dv, acc1 += P·X1 (dv), with
// dS = P∘(dP − D) and P = exp2(S·log2(e)/sqrt(d) − L·log2(e)).
//  - One producer warp: lane 0 loads R0 and R1 once and streams X0/X1 with
//    TMA (cp.async.bulk.tensor, 3-D maps over (d, T, b·h)) into a 2-stage
//    ring with full and empty mbarriers; a stuck wait traps (hopper.cuh).
//  - Consumer warpgroups own 64 resident rows each; all four products run
//    as wgmma with fp32 accumulators in registers: S and dP are 64 × kBN
//    fragments, dQ (or dK and dV) 64 × d fragments that live through the
//    whole stream. P and dS are formed on the S/dP fragments in registers
//    and fed as the A operand of the second products from registers, as
//    the forward feeds P.
//  - lse and D: a TMA map over (T, b·h) fp32 would need 4·T to be a
//    multiple of 16 bytes, so ragged T (63, 127, ...) could not use one.
//    The dq consumers read lse and D of their own two rows with plain loads
//    once; for dk/dv they index the accumulator's columns (queries), so
//    all 32 lanes of the producer warp stage lse·log2(e) and D of each
//    query tile into the ring stage and arrive on its full barrier (32
//    arrivals, lane 0's with the TMA bytes).
//  - bf16: the X tiles are read straight from the swizzled TMA tiles: K-
//    major as the B operand of S and dP, MN-major (transpose bit) as the B
//    operand of the second products (N = d), as the forward reads V. S and
//    dP accumulate in fp32; P and dS are rounded to bf16 for the second
//    products (JAX multiplies in fp32: the rounding is this port's choice,
//    held to the bf16 tolerance by tests/test_torch_flash_bwd_numerics.py).
//  - fp32: 3xTF32, x = big + small (hopper.cuh split_tf32), each product
//    a_big·b_big + a_big·b_small + a_small·b_big. tf32 wgmma takes only
//    K-major shared-memory operands, so the consumers turn each raw X
//    stage (row-major, unswizzled) into a working set (hopper.cuh
//    split_kmajor, split_transposed) and release the stage at once: X0 and X1 big and small K-major (128-byte swizzle) for
//    S and dP, and X0ᵀ (and for dk/dv X1ᵀ) big and small with the
//    contraction index (keys for dq, queries for dk/dv) contiguous. The
//    tf32 A-register fragment holds columns (t, t+4) of each 8-wide k-step
//    where the accumulator holds (2t, 2t+1), so that index is stored
//    permuted inside each group of 8 (logical p holds row 2p, or
//    2(p-4)+1 for p >= 4), as the forward stores Vᵀ; lse and D index the
//    accumulator's columns and are read unpermuted. R0 and R1 are split in
//    place once. P and dS are split in registers.
//  - Causal: dq's loop ends at its last row's diagonal tile and dk/dv's
//    starts at its first row's; a warpgroup skips tiles wholly on the far
//    side of its own diagonal. Only tiles that cross a diagonal or the
//    ragged end of T run the index mask (p = 0 for keys > queries and for
//    streamed rows >= T: TMA zero-fills them, and a zero row scores 0, not
//    -inf). Resident rows >= T are computed but not stored.
//  - Tile sizes (streamed rows kBN) keep registers and shared memory in
//    bounds: bf16 64 (d = 32, 64) or 32 (d = 128); fp32 32 or 16
//    (d = 128). NWG is 2 when two-warpgroup CTAs still give every SM a CTA
//    (b·h · ceil(T / 128) >= SMs) and T > 64, else 1: the training shape
//    (16·8, 512, 64) runs 512 two-warpgroup CTAs, (2·8, 1024, 64) 256
//    one-warpgroup CTAs. d = 128 always takes one warpgroup in fp32 (two
//    would need more than 227 KB) and in dk/dv: ptxas gives a 288-thread
//    CTA at most 168 registers a thread (warps are allocated in fours),
//    dK and dV take 128 of them, and the bf16 two-warpgroup instance
//    spilled. Shared memory per instance: BwdCfg::kAlloc, printed by
//    chip_smoke.py phase 2 (largest: fp32 d = 64 dk/dv with two
//    warpgroups, 231,208 B, and fp32 d = 128 dk/dv).
//  - Entry points, arguments and outputs are those of the FMA kernels these
//    replace; the kernels allocate nothing.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"
#include "tma.cuh"

namespace {

using namespace bigdl::sm90;

constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D, int NWG, bool DKV>
struct BwdCfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kBN =                      // streamed rows a tile
      kF32 ? (D == 128 ? 16 : 32) : (D == 128 ? 32 : 64);
  static constexpr int kBM = 64 * NWG;            // resident rows a CTA
  static constexpr int kConsumers = 128 * NWG;
  static constexpr int kThreads = kConsumers + 32;  // + the producer warp
  static constexpr int kStages = 2;
  // K-major shared tiles are D / kCB column blocks of rows of kRB bytes
  static constexpr int kCB = kF32 ? 32 : (D < 64 ? D : 64);
  static constexpr int kRB = kCB * (int)sizeof(T);  // 128, or 64 (bf16 d 32)
  static constexpr int kKSteps = kRB / 32;          // wgmma k-steps a row
  static constexpr int kRes = kBM * D * (int)sizeof(T);   // one resident
  static constexpr int kTile = kBN * D * (int)sizeof(T);  // one streamed
  static constexpr int kTRB = kBN * 4;   // fp32 transposed rows: 128 or 64 B
  static constexpr int kWorkTiles = DKV ? 8 : 6;
  static constexpr int kStatBytes = DKV ? 2 * kBN * 4 : 0;  // lse2, D
  // shared memory, from a 1024-byte aligned base; every tile region is a
  // multiple of 1024 bytes. fp32 keeps each resident's small part after
  // its big part.
  static constexpr int kR0 = 0;
  static constexpr int kR1 = kR0 + (kF32 ? 2 : 1) * kRes;
  static constexpr int kRing = kR1 + (kF32 ? 2 : 1) * kRes;
  static constexpr int kWork = kRing + kStages * 2 * kTile;  // fp32 only
  static constexpr int kStats =
      kWork + (kF32 ? kWorkTiles * kTile + kStatBytes : 0);
  static constexpr int kBars = kStats + kStages * kStatBytes;
  static constexpr int kAlloc = kBars + (2 * kStages + 1) * 8 + 1024;
  static_assert(kAlloc <= 232448, "over the 227 KB a block may use");
};

// acc = R·Xᵀ over d, issued and not waited for. bf16: R and X K-major
// straight from the TMA tiles.
template <typename C, int D>
__device__ __forceinline__ void issue_ss_bf16(float (&acc)[C::kBN / 2],
                                              uint32_t r, uint32_t x) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t blk = kk / C::kKSteps, step = (kk % C::kKSteps) * 32;
    wgmma_ss_bf16(acc, smem_desc(r + blk * C::kBM * C::kRB + step, 16,
                                 8 * C::kRB, C::kRB),
                  smem_desc(x + blk * C::kBN * C::kRB + step, 16, 8 * C::kRB,
                            C::kRB),
                  kk > 0);
  }
}

// fp32: 3xTF32 on R's big part at r (small kRes after it) and X's K-major
// big tile at x (small kTile after it).
template <typename C, int D>
__device__ __forceinline__ void issue_ss_f32(float (&acc)[C::kBN / 2],
                                             uint32_t r, uint32_t x) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t blk = kk / C::kKSteps, step = (kk % C::kKSteps) * 32;
    const uint32_t oa = r + blk * C::kBM * C::kRB + step;
    const uint32_t ob = x + blk * C::kBN * C::kRB + step;
    const uint64_t ab = smem_desc(oa, 16, 8 * C::kRB, C::kRB);
    const uint64_t bb = smem_desc(ob, 16, 8 * C::kRB, C::kRB);
    wgmma_ss_tf32(acc, smem_desc(oa + C::kRes, 16, 8 * C::kRB, C::kRB), bb,
                  kk > 0);
    wgmma_ss_tf32(acc, ab, smem_desc(ob + C::kTile, 16, 8 * C::kRB, C::kRB),
                  1);
    wgmma_ss_tf32(acc, ab, bb, 1);
  }
}

// S -> P and dP -> dS in place. dq: lse2 and D per row (rl, rd); dk/dv:
// per column, from `stats` ([lse2 | D] of the tile's kBN queries). `row`
// is this thread's first resident row (the second is row + 8), `n0` the
// tile's first streamed row, `col` 2·(lane % 4).
template <typename C, bool DKV, bool MASK>
__device__ __forceinline__ void probs(float (&s)[C::kBN / 2],
                                      float (&dp)[C::kBN / 2],
                                      const float (&rl)[2],
                                      const float (&rd)[2],
                                      const float* stats, float scale_log2,
                                      int row, int n0, int col, int t,
                                      int causal) {
#pragma unroll
  for (int i = 0; i < C::kBN / 2; ++i) {
    const int h = (i >> 1) & 1;
    const int c = 8 * (i / 4) + col + (i & 1);  // column in the tile
    const float l2 = DKV ? stats[c] : rl[h];
    const float dd = DKV ? stats[C::kBN + c] : rd[h];
    float p = exp2f(fmaf(s[i], scale_log2, -l2));
    if constexpr (MASK) {
      const int r = row + 8 * h, n = n0 + c;
      const int qi = DKV ? n : r, kj = DKV ? r : n;
      if (n >= t || (causal && kj > qi)) p = 0.f;
    }
    s[i] = p;
    dp[i] = p * (dp[i] - dd);
  }
}

// acc += x·X over the streamed index, x a 64 × kBN fragment from
// registers, issued and not waited for. bf16: x packed to bf16, X read
// MN-major (transpose bit) from its TMA tile.
template <typename C, int D>
__device__ __forceinline__ void issue_rs_bf16(float (&acc)[D / 2],
                                              const uint32_t (&x)[C::kBN / 4],
                                              uint32_t xt) {
#pragma unroll
  for (int kk = 0; kk < C::kBN / 16; ++kk) {
    const uint32_t a[4] = {x[4 * kk], x[4 * kk + 1], x[4 * kk + 2],
                           x[4 * kk + 3]};
    wgmma_rs_bf16(acc, a, smem_desc(xt + kk * 16 * C::kRB, C::kBN * C::kRB,
                                    8 * C::kRB, C::kRB), 1);
  }
}

// fp32: 3xTF32 with x split in registers (xb, xs) and Xᵀ's big tile at xt
// (small kTile after it), as split_transposed stores it.
template <typename C, int D>
__device__ __forceinline__ void issue_rs_f32(float (&acc)[D / 2],
                                             const uint32_t (&xb)[C::kBN / 2],
                                             const uint32_t (&xs)[C::kBN / 2],
                                             uint32_t xt) {
#pragma unroll
  for (int j = 0; j < C::kBN / 8; ++j) {
    // A fragment (g, t), (g+8, t), (g, t+4), (g+8, t+4) of k-step j from
    // accumulator columns 2t, 2t+1: see the permutation of split_transposed
    const uint32_t ab[4] = {xb[4 * j], xb[4 * j + 2], xb[4 * j + 1],
                            xb[4 * j + 3]};
    const uint32_t as[4] = {xs[4 * j], xs[4 * j + 2], xs[4 * j + 1],
                            xs[4 * j + 3]};
    const uint64_t db = smem_desc(xt + j * 32, 16, 8 * C::kTRB, C::kTRB);
    wgmma_rs_tf32(acc, as, db, 1);
    wgmma_rs_tf32(acc, ab,
                  smem_desc(xt + C::kTile + j * 32, 16, 8 * C::kTRB, C::kTRB),
                  1);
    wgmma_rs_tf32(acc, ab, db, 1);
  }
}

// One streamed tile: S = R0·X0ᵀ and dP = R1·X1ᵀ, P and dS in registers,
// then acc[0] += dS·X0 and, for dk/dv, acc[1] += P·X1. fp32 reads the
// working set at `work`, bf16 the TMA tiles at x0, x1.
template <typename C, int D, bool DKV, bool MASK>
__device__ __forceinline__ void tile(float (&acc)[DKV ? 2 : 1][D / 2],
                                     uint32_t r0, uint32_t r1, uint32_t x0,
                                     uint32_t x1, uint32_t work,
                                     const float* stats, const float (&rl)[2],
                                     const float (&rd)[2], float scale_log2,
                                     int row, int n0, int col, int t,
                                     int causal) {
  float s[C::kBN / 2], dp[C::kBN / 2];
  wgmma_fence();
  if constexpr (C::kF32) {
    issue_ss_f32<C, D>(s, r0, work);
    issue_ss_f32<C, D>(dp, r1, work + 2 * C::kTile);
  } else {
    issue_ss_bf16<C, D>(s, r0, x0);
    issue_ss_bf16<C, D>(dp, r1, x1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  fence_regs(dp);

  probs<C, DKV, MASK>(s, dp, rl, rd, stats, scale_log2, row, n0, col, t,
                      causal);

  constexpr int kAcc = DKV ? 2 : 1;
  if constexpr (C::kF32) {
    uint32_t db[C::kBN / 2], ds[C::kBN / 2];
    uint32_t pb[DKV ? C::kBN / 2 : 1], ps[DKV ? C::kBN / 2 : 1];
#pragma unroll
    for (int i = 0; i < C::kBN / 2; ++i) {
      split_tf32(dp[i], db[i], ds[i]);
      if constexpr (DKV) split_tf32(s[i], pb[i], ps[i]);
    }
#pragma unroll
    for (int a = 0; a < kAcc; ++a) fence_regs(acc[a]);
    wgmma_fence();
    issue_rs_f32<C, D>(acc[0], db, ds, work + 4 * C::kTile);
    if constexpr (DKV) issue_rs_f32<C, D>(acc[1], pb, ps, work + 6 * C::kTile);
  } else {  // P and dS rounded to bf16
    uint32_t ad[C::kBN / 4], ap[DKV ? C::kBN / 4 : 1];
#pragma unroll
    for (int i = 0; i < C::kBN / 4; ++i) {
      ad[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
      if constexpr (DKV) ap[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    }
#pragma unroll
    for (int a = 0; a < kAcc; ++a) fence_regs(acc[a]);
    wgmma_fence();
    issue_rs_bf16<C, D>(acc[0], ad, x0);
    if constexpr (DKV) issue_rs_bf16<C, D>(acc[1], ap, x1);
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int a = 0; a < kAcc; ++a) fence_regs(acc[a]);
}

template <typename T, int D, int NWG, bool DKV>
__device__ __forceinline__ void bwd_body(
    const CUtensorMap* rmap0, const CUtensorMap* rmap1,
    const CUtensorMap* xmap0, const CUtensorMap* xmap1,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ out0, T* __restrict__ out1, int t, int causal,
    float scale_log2, float scale) {
  using C = BwdCfg<T, D, NWG, DKV>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* empty = full + C::kStages;
  uint64_t* r_full = empty + C::kStages;
  float* ring_stats = reinterpret_cast<float*>(smem + C::kStats);

  const int bh = blockIdx.x;
  const size_t base = (size_t)bh * t;
  // dq: last query tiles first (under causal masking they stream the most
  // key tiles); dk/dv: first key tiles first (they stream the most query
  // tiles). Either way the long CTAs start early.
  const int m0 = (DKV ? blockIdx.y : gridDim.y - 1 - blockIdx.y) * C::kBM;
  const int s0 = DKV && causal ? m0 : 0;  // first streamed row
  const int s_end = !DKV && causal ? min(t, m0 + C::kBM) : t;
  const int n_tiles = (s_end - s0 + C::kBN - 1) / C::kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], DKV ? 32 : 1);
      mbar_init(&empty[s], C::kConsumers);
    }
    mbar_init(r_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // ---------------------------- producer warp
    if (!DKV && lane != 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(r_full, 2 * C::kRes);
      for (int cb = 0; cb < D / C::kCB; ++cb) {
        tma_load_3d(smem + C::kR0 + cb * C::kBM * C::kRB, rmap0, r_full,
                    cb * C::kCB, m0, bh);
        tma_load_3d(smem + C::kR1 + cb * C::kBM * C::kRB, rmap1, r_full,
                    cb * C::kCB, m0, bh);
      }
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % C::kStages, n0 = s0 + i * C::kBN;
      mbar_wait(&empty[s], ((i / C::kStages) & 1) ^ 1);
      if constexpr (DKV) {  // lse2 and D of the tile's queries, 0 past T
        float* st = ring_stats + s * 2 * C::kBN;
        for (int r = lane; r < C::kBN; r += 32) {
          const bool in = n0 + r < t;
          st[r] = in ? lse[base + n0 + r] * kLog2e : 0.f;
          st[C::kBN + r] = in ? delta[base + n0 + r] : 0.f;
        }
        if (lane != 0) {
          mbar_arrive(&full[s]);
          continue;
        }
      }
      mbar_arrive_expect_tx(&full[s], 2 * C::kTile);
      unsigned char* xt = smem + C::kRing + s * 2 * C::kTile;
      if constexpr (C::kF32) {  // raw tiles, one box each
        tma_load_3d(xt, xmap0, &full[s], 0, n0, bh);
        tma_load_3d(xt + C::kTile, xmap1, &full[s], 0, n0, bh);
      } else {
        for (int cb = 0; cb < D / C::kCB; ++cb) {
          tma_load_3d(xt + cb * C::kBN * C::kRB, xmap0, &full[s],
                      cb * C::kCB, n0, bh);
          tma_load_3d(xt + C::kTile + cb * C::kBN * C::kRB, xmap1, &full[s],
                      cb * C::kCB, n0, bh);
        }
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  const int tid = threadIdx.x;
  const int wg = warp / 4;
  const int r0 = m0 + 64 * wg;  // this warpgroup's first resident row
  const int row = r0 + 16 * (warp % 4) + lane / 4;  // and row + 8
  const int col = 2 * (lane % 4);
  float acc[DKV ? 2 : 1][D / 2];
#pragma unroll
  for (int a = 0; a < (DKV ? 2 : 1); ++a)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[a][i] = 0.f;
  float rl[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};  // dq: lse2 and D per row
  if constexpr (!DKV) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row + 8 * h < t) {
        rl[h] = lse[base + row + 8 * h] * kLog2e;
        rd[h] = delta[base + row + 8 * h];
      }
    }
  }

  const uint32_t ra0 = smem_addr(smem + C::kR0) + 64 * wg * C::kRB;
  const uint32_t ra1 = smem_addr(smem + C::kR1) + 64 * wg * C::kRB;
  const uint32_t work = smem_addr(smem + C::kWork);
  float* work_stats =
      reinterpret_cast<float*>(smem + C::kWork + C::kWorkTiles * C::kTile);
  mbar_wait(r_full, 0);
  if constexpr (C::kF32) {  // split R0 and R1: big in place, small after
    split_in_place(smem + C::kR0, C::kRes, tid, C::kConsumers);
    split_in_place(smem + C::kR1, C::kRes, tid, C::kConsumers);
    fence_proxy_async();
    named_barrier(1, C::kConsumers);
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % C::kStages, n0 = s0 + i * C::kBN;
    mbar_wait(&full[s], (i / C::kStages) & 1);
    unsigned char* xt = smem + C::kRing + s * 2 * C::kTile;
    const float* stats = ring_stats + s * 2 * C::kBN;
    if constexpr (C::kF32) {
      // the working set, kTile each: X0 and X1 big and small K-major, X0ᵀ
      // (dk/dv: and X1ᵀ) big and small; then the stage's lse2 and D
      const float* raw = reinterpret_cast<const float*>(xt);  // X0, X1
      unsigned char* w = smem + C::kWork;
      split_kmajor<C::kBN, D, 2>(raw, w, tid, C::kConsumers);
      split_transposed<C::kBN, D, DKV ? 2 : 1>(raw, w + 4 * C::kTile, tid,
                                               C::kConsumers);
      if constexpr (DKV)
        for (int j = tid; j < 2 * C::kBN; j += C::kConsumers)
          work_stats[j] = stats[j];
      fence_proxy_async();
      mbar_arrive(&empty[s]);  // the raw stage may be refilled now
      named_barrier(1, C::kConsumers);
      stats = work_stats;
    }
    // dq: keys n0.. against queries r0..r0+63; dk/dv: queries n0.. against
    // keys r0..r0+63
    const bool live =
        r0 < t && (!causal || (DKV ? n0 + C::kBN - 1 >= r0 : n0 <= r0 + 63));
    if (live) {
      const bool masked =
          n0 + C::kBN > t ||
          (causal && (DKV ? r0 + 63 > n0 : n0 + C::kBN - 1 > r0));
      const uint32_t x0 = smem_addr(xt), x1 = x0 + C::kTile;
      if (masked)
        tile<C, D, DKV, true>(acc, ra0, ra1, x0, x1, work, stats, rl, rd,
                              scale_log2, row, n0, col, t, causal);
      else
        tile<C, D, DKV, false>(acc, ra0, ra1, x0, x1, work, stats, rl, rd,
                               scale_log2, row, n0, col, t, causal);
    }
    if constexpr (C::kF32)
      named_barrier(1, C::kConsumers);  // the working set is free again
    else
      mbar_arrive(&empty[s]);
  }

  // -------------------------------------------------------- epilogue
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= t) continue;
#pragma unroll
    for (int a = 0; a < (DKV ? 2 : 1); ++a) {
      const float mul = a == 0 ? scale : 1.f;  // dq, dk scaled; dv not
      T* out = (a == 0 ? out0 : out1) + (base + r) * D + col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float x = acc[a][4 * j + 2 * h] * mul;
        const float y = acc[a][4 * j + 2 * h + 1] * mul;
        if constexpr (C::kF32)
          *reinterpret_cast<float2*>(out + 8 * j) = make_float2(x, y);
        else
          *reinterpret_cast<uint32_t*>(out + 8 * j) = pack_bf16(x, y);
      }
    }
  }
}

template <typename T, int D, int NWG>
__global__ void __launch_bounds__(BwdCfg<T, D, NWG, false>::kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap domap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int t,
                    int causal, float scale_log2, float scale) {
  bwd_body<T, D, NWG, false>(&qmap, &domap, &kmap, &vmap, lse, delta, dq,
                             nullptr, t, causal, scale_log2, scale);
}

template <typename T, int D, int NWG>
__global__ void __launch_bounds__(BwdCfg<T, D, NWG, true>::kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap domap,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int t, int causal, float scale_log2,
                     float scale) {
  bwd_body<T, D, NWG, true>(&kmap, &vmap, &qmap, &domap, lse, delta, dk, dv,
                            t, causal, scale_log2, scale);
}

// ------------------------------------------------------------------ host
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dq; or dk and dv
  long long bh;
  int t;
  cudaStream_t stream;
};

template <typename T, int D, int NWG, bool DKV>
cudaError_t launch(const Args& a, int causal) {
  using C = BwdCfg<T, D, NWG, DKV>;
  // resident R0, R1 and streamed X0, X1 (see the table at the top)
  const void* r0 = DKV ? a.k : a.q;
  const void* r1 = DKV ? a.v : a.dout;
  const void* x0 = DKV ? a.q : a.k;
  const void* x1 = DKV ? a.dout : a.v;
  CUtensorMap rm0, rm1, xm0, xm1;
  // R: K-major swizzled blocks (fp32: split in place by the consumers);
  // X: the same for bf16, raw rows for fp32 (the consumers convert)
  const int sw = C::kRB;
  bool ok = make_map(&rm0, r0, C::kF32, a.bh, a.t, D, C::kCB, C::kBM, sw) &&
            make_map(&rm1, r1, C::kF32, a.bh, a.t, D, C::kCB, C::kBM, sw);
  if constexpr (C::kF32)
    ok = ok && make_map(&xm0, x0, true, a.bh, a.t, D, D, C::kBN, 0) &&
         make_map(&xm1, x1, true, a.bh, a.t, D, D, C::kBN, 0);
  else
    ok = ok && make_map(&xm0, x0, false, a.bh, a.t, D, C::kCB, C::kBN, sw) &&
         make_map(&xm1, x1, false, a.bh, a.t, D, C::kCB, C::kBN, sw);
  if (!ok) return cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  const dim3 grid((unsigned)a.bh, (unsigned)((a.t + C::kBM - 1) / C::kBM));
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  cudaError_t err;
  if constexpr (DKV) {
    auto kernel = flash_bwd_dkv_kernel<T, D, NWG>;
    err = bigdl::allow_dynamic_smem<flash_bwd_dkv_kernel<T, D, NWG>>(
        C::kAlloc);
    if (err != cudaSuccess) return err;
    kernel<<<grid, C::kThreads, C::kAlloc, a.stream>>>(
        rm0, rm1, xm0, xm1, lse, delta, static_cast<T*>(a.out0),
        static_cast<T*>(a.out1), a.t, causal, scale_log2, scale);
  } else {
    auto kernel = flash_bwd_dq_kernel<T, D, NWG>;
    err = bigdl::allow_dynamic_smem<flash_bwd_dq_kernel<T, D, NWG>>(
        C::kAlloc);
    if (err != cudaSuccess) return err;
    kernel<<<grid, C::kThreads, C::kAlloc, a.stream>>>(
        rm0, rm1, xm0, xm1, lse, delta, static_cast<T*>(a.out0), a.t, causal,
        scale_log2, scale);
  }
  return cudaGetLastError();
}

// d = 128 takes one warpgroup in fp32 (two do not fit in shared memory)
// and in dk/dv (a 288-thread CTA gets at most 168 registers a thread, and
// dK and dV alone take 128).
bool one_warpgroup(bool f32, int d, bool dkv) {
  return d == 128 && (f32 || dkv);
}

int consumer_warpgroups(bool f32, int d, bool dkv, long long bh, int t) {
  return one_warpgroup(f32, d, dkv) ? 1
                                    : bigdl::sm90::consumer_warpgroups(bh, t);
}

template <typename T, int D, bool DKV>
constexpr int kMaxWG = D == 128 && (sizeof(T) == 4 || DKV) ? 1 : 2;

template <typename T, int D, bool DKV>
cudaError_t launch_wg(const Args& a, int causal) {
  if (consumer_warpgroups(sizeof(T) == 4, D, DKV, a.bh, a.t) == 2)
    return launch<T, D, kMaxWG<T, D, DKV>, DKV>(a, causal);
  return launch<T, D, 1, DKV>(a, causal);
}

template <typename T, int D, bool DKV>
void plan_cfg(int nwg, int* threads, int* smem) {
  using C2 = BwdCfg<T, D, kMaxWG<T, D, DKV>, DKV>;
  using C1 = BwdCfg<T, D, 1, DKV>;
  *threads = nwg == 2 ? C2::kThreads : C1::kThreads;
  *smem = nwg == 2 ? C2::kAlloc : C1::kAlloc;
}

template <typename T, int D>
void plan(int nwg, bool dkv, int* threads, int* smem) {
  if (dkv)
    plan_cfg<T, D, true>(nwg, threads, smem);
  else
    plan_cfg<T, D, false>(nwg, threads, smem);
}

template <typename T>
cudaError_t plan_dim(int d, int nwg, bool dkv, int* threads, int* smem) {
  switch (d) {
    case 32: plan<T, 32>(nwg, dkv, threads, smem); return cudaSuccess;
    case 64: plan<T, 64>(nwg, dkv, threads, smem); return cudaSuccess;
    case 128: plan<T, 128>(nwg, dkv, threads, smem); return cudaSuccess;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool DKV>
cudaError_t launch_dim(const Args& a, int d, int causal) {
  switch (d) {
    case 32: return launch_wg<T, 32, DKV>(a, causal);
    case 64: return launch_wg<T, 64, DKV>(a, causal);
    case 128: return launch_wg<T, 128, DKV>(a, causal);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DKV>
int dispatch(const Args& a, int d, int causal, int dtype) {
  if (a.bh <= 0 || a.t <= 0) return 0;
  if (a.bh > 0x7fffffffLL || (a.t + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == bigdl::kFloat32)
    return (int)launch_dim<float, DKV>(a, d, causal);
  if (dtype == bigdl::kBFloat16)
    return (int)launch_dim<__nv_bfloat16, DKV>(a, d, causal);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, dout, dq: (bh, t, d) contiguous in `dtype`, 16-byte aligned;
// lse (the forward's natural-log logsumexp) and delta = rowsum(dout∘O):
// (bh, t) float32. d is 32, 64 or 128. Returns the cudaError_t of the launch.
extern "C" int bigdl_flash_attn_bwd_dq(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, long long bh, int t, int d,
                                       int causal, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, bh, t,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, d, causal, dtype);
}

// As bigdl_flash_attn_bwd_dq, writing dk and dv: (bh, t, d) in `dtype`.
extern "C" int bigdl_flash_attn_bwd_dkv(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv, long long bh,
                                        int t, int d, int causal, int dtype,
                                        void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, bh, t,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, d, causal, dtype);
}

// The launch bigdl_flash_attn_bwd_dq (dkv = 0) or _dkv (dkv = 1) makes for
// these operands: consumer warpgroups a CTA, threads a CTA and dynamic
// shared memory bytes a CTA.
extern "C" int bigdl_flash_attn_bwd_plan(long long bh, int t, int d,
                                         int dtype, int dkv, int* nwg,
                                         int* threads, int* smem) {
  const bool f32 = dtype == bigdl::kFloat32;
  if ((!f32 && dtype != bigdl::kBFloat16) || bh <= 0 || t <= 0)
    return (int)cudaErrorInvalidValue;
  *nwg = consumer_warpgroups(f32, d, dkv != 0, bh, t);
  return (int)(f32 ? plan_dim<float>(d, *nwg, dkv != 0, threads, smem)
                   : plan_dim<__nv_bfloat16>(d, *nwg, dkv != 0, threads,
                                             smem));
}
