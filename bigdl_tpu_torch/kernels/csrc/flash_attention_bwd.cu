// Flash-attention backward for sm_90a: two kernels, dq and dk/dv.
//
// Replace the Pallas kernels bigdl_tpu/kernels/flash_attention.py:132
// (_pallas_flash_bwd_dq) and :199 (_pallas_flash_bwd_dkv). Both recompute
// the probabilities p = exp(s - L) from (q, k) and the forward's per-row
// logsumexp L, with s = q·kᵀ/sqrt(d), and take D = rowsum(dO∘O) from the
// caller:
//   dq = Σ_j ds_ij · k_j · scale        (one CTA per query tile)
//   dv = Σ_i p_ij · dO_i,  dk = Σ_i ds_ij · q_i · scale   (one CTA per key tile)
// with ds_ij = p_ij · (dO_i·v_j − D_i). Keeping the two kernels apart, as
// JAX does, leaves every output owned by one CTA: no atomics, and the sums
// run in a fixed order, so the result is deterministic.
//
// Bound: operations (6·d flops per live (query, key) pair for dq, 8·d for
// dk/dv, against O(T·d) bytes), so the tensor-core version is the later
// fast path. This one is the plain FMA form of the forward kernel. Design:
//  - the TPU's sequential inner grid axis becomes a loop inside the CTA, so
//    the accumulators live in registers for the whole stream;
//  - a CTA owns 64 rows; a row is split over 1, 2 or 4 threads (d = 32, 64,
//    128) that own 32 of its columns each and add their partial dot
//    products with shuffles. A dk/dv thread then holds k, v, dk and dv for
//    its 32 columns (128 floats), a dq thread q, dO and dq (96);
//  - a row's columns are dealt to its threads in interleaved float4 chunks,
//    so the threads of one row read distinct shared-memory banks;
//  - the streamed operand (K and V for dq; Q, dO, L and D for dk/dv) passes
//    through shared memory in tiles of 32 rows, as fp32 whatever the input
//    dtype;
//  - any T: rows and keys past T are zero-filled and masked to p = 0
//    exactly, keys above the diagonal too; the causal loops stop (dq) or
//    start (dk/dv) at the diagonal tile. There is no O(T^2) fallback;
//  - scores are kept in log2 units: the owned row (q for dq, k for dk/dv)
//    is pre-scaled by log2(e)/sqrt(d) and L is converted from the natural
//    log the forward stores, so each probability is one exp2f.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBlockRows = 64;    // rows a CTA owns (queries or keys)
constexpr int kBlockStream = 32;  // rows of a streamed shared-memory tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int kCols = D > 32 ? 32 : D;       // columns a thread owns
  static constexpr int kThreadsPerRow = D / kCols;    // 1, 2 or 4
  static constexpr int kChunks = kCols / 4;           // float4 chunks a thread owns
  static constexpr int kThreads = kBlockRows * kThreadsPerRow;
};

// Column of the c-th float4 chunk of thread `sub` of a row.
template <int D>
__device__ __forceinline__ int chunk_col(int c, int sub) {
  return (c * Layout<D>::kThreadsPerRow + sub) * 4;
}

// Sum over the threads of one row (adjacent lanes of one warp).
template <int TPR>
__device__ __forceinline__ float row_sum(float a) {
  if (TPR > 1) a += __shfl_xor_sync(0xffffffffu, a, 1);
  if (TPR > 2) a += __shfl_xor_sync(0xffffffffu, a, 2);
  return a;
}

// Stage rows [r0, r0 + kBlockStream) of two (t, D) matrices in shared
// memory as fp32, zero past row t.
template <typename T, int D, int THREADS>
__device__ __forceinline__ void stage_tile(const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           float (*as)[D], float (*bs)[D],
                                           int r0, int t) {
  for (int i = threadIdx.x; i < kBlockStream * (D / 4); i += THREADS) {
    const int r = i / (D / 4);
    const int c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 y = x;
    if (r0 + r < t) {
      x = bigdl::load4(a + (size_t)(r0 + r) * D + c);
      y = bigdl::load4(b + (size_t)(r0 + r) * D + c);
    }
    *reinterpret_cast<float4*>(&as[r][c]) = x;
    *reinterpret_cast<float4*>(&bs[r][c]) = y;
  }
}

// Load this thread's chunks of row `row` of a (t, D) matrix, times `mul`.
template <typename T, int D>
__device__ __forceinline__ void load_row(const T* __restrict__ m, int row,
                                         int sub, bool valid, float mul,
                                         float* out) {
#pragma unroll
  for (int c = 0; c < Layout<D>::kChunks; ++c) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) x = bigdl::load4(m + (size_t)row * D + chunk_col<D>(c, sub));
    out[4 * c] = x.x * mul;
    out[4 * c + 1] = x.y * mul;
    out[4 * c + 2] = x.z * mul;
    out[4 * c + 3] = x.w * mul;
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_row(T* __restrict__ m, int row, int sub,
                                          float mul, const float* in) {
#pragma unroll
  for (int c = 0; c < Layout<D>::kChunks; ++c) {
    bigdl::store4(m + (size_t)row * D + chunk_col<D>(c, sub),
                  make_float4(in[4 * c] * mul, in[4 * c + 1] * mul,
                              in[4 * c + 2] * mul, in[4 * c + 3] * mul));
  }
}

// Dot product of this thread's chunks of `r` with row `row` of a shared tile.
template <int D>
__device__ __forceinline__ float dot_chunks(const float* r,
                                            const float (*tile)[D], int row,
                                            int sub) {
  float a = 0.f;
#pragma unroll
  for (int c = 0; c < Layout<D>::kChunks; ++c) {
    const float4 x =
        *reinterpret_cast<const float4*>(&tile[row][chunk_col<D>(c, sub)]);
    a = fmaf(r[4 * c], x.x, a);
    a = fmaf(r[4 * c + 1], x.y, a);
    a = fmaf(r[4 * c + 2], x.z, a);
    a = fmaf(r[4 * c + 3], x.w, a);
  }
  return a;
}

// acc += w · (this thread's chunks of row `row` of a shared tile).
template <int D>
__device__ __forceinline__ void axpy_chunks(float* acc, float w,
                                            const float (*tile)[D], int row,
                                            int sub) {
#pragma unroll
  for (int c = 0; c < Layout<D>::kChunks; ++c) {
    const float4 x =
        *reinterpret_cast<const float4*>(&tile[row][chunk_col<D>(c, sub)]);
    acc[4 * c] = fmaf(w, x.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(w, x.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(w, x.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(w, x.w, acc[4 * c + 3]);
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(Layout<D>::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int t, float scale) {
  constexpr int TPR = Layout<D>::kThreadsPerRow;
  constexpr int NC = Layout<D>::kChunks;
  __shared__ __align__(16) float ks[kBlockStream][D];
  __shared__ __align__(16) float vs[kBlockStream][D];

  const size_t base = (size_t)blockIdx.x * t * D;
  // last query tiles first: under causal masking they stream the most key
  // tiles, so starting them early shortens the tail of the grid
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;
  const int qi = q0 + threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  const bool valid = qi < t;

  float qr[4 * NC], dor[4 * NC], acc[4 * NC];
  load_row<T, D>(q + base, qi, sub, valid, scale * kLog2e, qr);
  load_row<T, D>(dout + base, qi, sub, valid, 1.f, dor);
#pragma unroll
  for (int c = 0; c < 4 * NC; ++c) acc[c] = 0.f;
  const size_t row = (size_t)blockIdx.x * t + qi;
  const float lse2 = valid ? lse[row] * kLog2e : 0.f;
  const float di = valid ? delta[row] : 0.f;

  const int k_end = CAUSAL ? min(t, q0 + kBlockRows) : t;
  for (int k0 = 0; k0 < k_end; k0 += kBlockStream) {
    __syncthreads();  // every thread is done with the previous tile
    stage_tile<T, D, Layout<D>::kThreads>(k + base, v + base, ks, vs, k0, t);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBlockStream; ++j) {
      const float s = row_sum<TPR>(dot_chunks<D>(qr, ks, j, sub));
      const float dp = row_sum<TPR>(dot_chunks<D>(dor, vs, j, sub));
      const int kj = k0 + j;
      const bool live = valid && kj < t && (!CAUSAL || kj <= qi);
      const float p = live ? exp2f(s - lse2) : 0.f;
      axpy_chunks<D>(acc, p * (dp - di), ks, j, sub);
    }
  }
  if (valid) store_row<T, D>(dq + base, qi, sub, scale, acc);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(Layout<D>::kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int t, float scale) {
  constexpr int TPR = Layout<D>::kThreadsPerRow;
  constexpr int NC = Layout<D>::kChunks;
  constexpr int THREADS = Layout<D>::kThreads;
  __shared__ __align__(16) float qs[kBlockStream][D];
  __shared__ __align__(16) float dos[kBlockStream][D];
  __shared__ float lse2s[kBlockStream];  // log2 units
  __shared__ float ds_[kBlockStream];

  const size_t base = (size_t)blockIdx.x * t * D;
  const float* lse_bh = lse + (size_t)blockIdx.x * t;
  const float* delta_bh = delta + (size_t)blockIdx.x * t;
  // first key tiles first: under causal masking they stream the most
  // query tiles
  const int k0 = blockIdx.y * kBlockRows;
  const int kj = k0 + threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  const bool valid = kj < t;

  float kr[4 * NC], vr[4 * NC], dka[4 * NC], dva[4 * NC];
  load_row<T, D>(k + base, kj, sub, valid, scale * kLog2e, kr);
  load_row<T, D>(v + base, kj, sub, valid, 1.f, vr);
#pragma unroll
  for (int c = 0; c < 4 * NC; ++c) dka[c] = dva[c] = 0.f;

  // causal: query rows above this key tile see none of its keys; k0 is a
  // multiple of the stream tile, so the loop starts on a tile boundary
  const int q_begin = CAUSAL ? k0 : 0;
  for (int i0 = q_begin; i0 < t; i0 += kBlockStream) {
    __syncthreads();
    stage_tile<T, D, THREADS>(q + base, dout + base, qs, dos, i0, t);
    for (int r = threadIdx.x; r < kBlockStream; r += THREADS) {
      const bool in = i0 + r < t;
      lse2s[r] = in ? lse_bh[i0 + r] * kLog2e : 0.f;
      ds_[r] = in ? delta_bh[i0 + r] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kBlockStream; ++r) {
      const float s = row_sum<TPR>(dot_chunks<D>(kr, qs, r, sub));
      const float dp = row_sum<TPR>(dot_chunks<D>(vr, dos, r, sub));
      const int qi = i0 + r;
      const bool live = valid && qi < t && (!CAUSAL || kj <= qi);
      const float p = live ? exp2f(s - lse2s[r]) : 0.f;
      axpy_chunks<D>(dva, p, dos, r, sub);
      axpy_chunks<D>(dka, p * (dp - ds_[r]), qs, r, sub);
    }
  }
  if (valid) {
    store_row<T, D>(dk + base, kj, sub, scale, dka);
    store_row<T, D>(dv + base, kj, sub, 1.f, dva);
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dq; or dk and dv
  long long bh;
  int t;
  cudaStream_t stream;
};

template <typename T, int D, bool CAUSAL>
cudaError_t launch(const Args& a, bool dkv) {
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((unsigned)a.bh, (unsigned)((a.t + kBlockRows - 1) / kBlockRows));
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  if (dkv) {
    flash_bwd_dkv_kernel<T, D, CAUSAL>
        <<<grid, Layout<D>::kThreads, 0, a.stream>>>(
            q, k, v, dout, lse, delta, static_cast<T*>(a.out0),
            static_cast<T*>(a.out1), a.t, scale);
  } else {
    flash_bwd_dq_kernel<T, D, CAUSAL>
        <<<grid, Layout<D>::kThreads, 0, a.stream>>>(
            q, k, v, dout, lse, delta, static_cast<T*>(a.out0), a.t, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const Args& a, int d, int causal, bool dkv) {
  switch (d) {
    case 32: return causal ? launch<T, 32, true>(a, dkv) : launch<T, 32, false>(a, dkv);
    case 64: return causal ? launch<T, 64, true>(a, dkv) : launch<T, 64, false>(a, dkv);
    case 128: return causal ? launch<T, 128, true>(a, dkv) : launch<T, 128, false>(a, dkv);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(const Args& a, int d, int causal, int dtype, bool dkv) {
  if (a.bh <= 0 || a.t <= 0) return 0;
  if (a.bh > 0x7fffffffLL || (a.t + kBlockRows - 1) / kBlockRows > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == bigdl::kFloat32) return (int)launch_dim<float>(a, d, causal, dkv);
  if (dtype == bigdl::kBFloat16)
    return (int)launch_dim<__nv_bfloat16>(a, d, causal, dkv);
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
  return dispatch(a, d, causal, dtype, false);
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
  return dispatch(a, d, causal, dtype, true);
}
