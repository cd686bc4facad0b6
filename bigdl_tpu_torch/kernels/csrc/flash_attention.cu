// Flash-attention forward for sm_90a.
//
// Replaces the Pallas kernel bigdl_tpu/kernels/flash_attention.py:54
// (_pallas_flash_call): streaming-softmax attention over (B*H, T, d) with
// the running max m, sum l and accumulator acc in fp32, scale 1/sqrt(d),
// causal tiles above the diagonal skipped, and the per-row logsumexp
// L = m + log(l) written beside O for the backward pass.
//
// Bound: operations (4·d flops per live (query, key) pair against 3·d
// elements read per key), so a tensor-core version is the later fast path.
// This one is the plain FMA form. Design:
//  - one CTA per (b·h, 64-row query tile); the TPU's sequential k grid axis
//    becomes a loop inside the CTA, so m, l and acc live in registers;
//  - one thread owns one query row (two threads per row at d = 128, which
//    add their half dot products with one shuffle), keeps its scaled q row
//    and its accumulator in registers, and reads each key and value row of
//    the tile from shared memory as float4 broadcasts, one load per 4 FMAs;
//  - K/V tiles of 32 rows are staged in shared memory as fp32 whatever the
//    input dtype;
//  - any T: rows and keys past T are masked (keys to -inf, rows not
//    written) instead of requiring T to divide into tiles, so the port has
//    no O(T^2) fallback;
//  - scores are kept in log2 units (q is pre-scaled by log2(e)/sqrt(d)) so
//    each exponential is one exp2f.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;  // query rows per CTA
constexpr int kBlockK = 32;  // key rows per shared-memory tile
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Layout {
  static constexpr int kCols = D > 64 ? 64 : D;  // columns one thread owns
  static constexpr int kThreadsPerRow = D / kCols;
  static constexpr int kThreads = kBlockQ * kThreadsPerRow;
};

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(Layout<D>::kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int t, float scale_log2) {
  constexpr int DP = Layout<D>::kCols;
  constexpr int TPR = Layout<D>::kThreadsPerRow;
  constexpr int THREADS = Layout<D>::kThreads;
  __shared__ __align__(16) float ks[kBlockK][D];
  __shared__ __align__(16) float vs[kBlockK][D];

  const int bh = blockIdx.x;
  // last query tiles first: under causal masking they stream the most key
  // tiles, so starting them early shortens the tail of the grid
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int qi = q0 + threadIdx.x / TPR;
  const int col0 = (threadIdx.x % TPR) * DP;
  const bool valid = qi < t;
  const size_t base = (size_t)bh * t * D;

  float qr[DP];
  float acc[DP];
#pragma unroll
  for (int c = 0; c < DP; c += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) x = bigdl::load4(q + base + (size_t)qi * D + col0 + c);
    qr[c] = x.x * scale_log2;
    qr[c + 1] = x.y * scale_log2;
    qr[c + 2] = x.z * scale_log2;
    qr[c + 3] = x.w * scale_log2;
    acc[c] = acc[c + 1] = acc[c + 2] = acc[c + 3] = 0.f;
  }
  float m = -INFINITY;  // running max of the scores, log2 units
  float l = 0.f;        // running sum of exp2(score - m)

  const int k_end = CAUSAL ? min(t, q0 + kBlockQ) : t;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kBlockK * (D / 4); i += THREADS) {
      const int r = i / (D / 4);
      const int c = (i % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (k0 + r < t) {
        kv = bigdl::load4(k + base + (size_t)(k0 + r) * D + c);
        vv = bigdl::load4(v + base + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<float4*>(&ks[r][c]) = kv;
      *reinterpret_cast<float4*>(&vs[r][c]) = vv;
    }
    __syncthreads();

    float s[kBlockK];
    float mt = m;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float a = 0.f;
#pragma unroll
      for (int c = 0; c < DP; c += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][col0 + c]);
        a = fmaf(qr[c], kk.x, a);
        a = fmaf(qr[c + 1], kk.y, a);
        a = fmaf(qr[c + 2], kk.z, a);
        a = fmaf(qr[c + 3], kk.w, a);
      }
      if (TPR > 1) a += __shfl_xor_sync(0xffffffffu, a, 1);
      const int kj = k0 + j;
      const bool live = kj < t && (!CAUSAL || kj <= qi);
      s[j] = live ? a : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    if (mt == -INFINITY) continue;  // no live key for this row yet

    const float alpha = exp2f(m - mt);  // 0 while m is still -inf
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      s[j] = exp2f(s[j] - mt);  // masked keys give exactly 0
      ps += s[j];
    }
    l = l * alpha + ps;
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
#pragma unroll
      for (int c = 0; c < DP; c += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][col0 + c]);
        acc[c] = fmaf(s[j], vv.x, acc[c]);
        acc[c + 1] = fmaf(s[j], vv.y, acc[c + 1]);
        acc[c + 2] = fmaf(s[j], vv.z, acc[c + 2]);
        acc[c + 3] = fmaf(s[j], vv.w, acc[c + 3]);
      }
    }
    m = mt;
  }

  if (!valid) return;
  const float denom = fmaxf(l, 1e-37f);
  const float inv = 1.f / denom;
#pragma unroll
  for (int c = 0; c < DP; c += 4) {
    bigdl::store4(o + base + (size_t)qi * D + col0 + c,
                  make_float4(acc[c] * inv, acc[c + 1] * inv,
                              acc[c + 2] * inv, acc[c + 3] * inv));
  }
  if (col0 == 0) lse[(size_t)bh * t + qi] = m * kLn2 + logf(denom);
}

template <typename T, int D, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, long long bh, int t, cudaStream_t stream) {
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  const dim3 grid((unsigned)bh, (unsigned)((t + kBlockQ - 1) / kBlockQ));
  flash_fwd_kernel<T, D, CAUSAL><<<grid, Layout<D>::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      t, scale_log2);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mask(const void* q, const void* k, const void* v, void* o,
                        void* lse, long long bh, int t, int causal,
                        cudaStream_t stream) {
  return causal ? launch<T, D, true>(q, k, v, o, lse, bh, t, stream)
                : launch<T, D, false>(q, k, v, o, lse, bh, t, stream);
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v, void* o,
                       void* lse, long long bh, int t, int d, int causal,
                       cudaStream_t stream) {
  switch (d) {
    case 32: return launch_mask<T, 32>(q, k, v, o, lse, bh, t, causal, stream);
    case 64: return launch_mask<T, 64>(q, k, v, o, lse, bh, t, causal, stream);
    case 128: return launch_mask<T, 128>(q, k, v, o, lse, bh, t, causal, stream);
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
  if (bh > 0x7fffffffLL || (t + kBlockQ - 1) / kBlockQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kFloat32)
    return (int)launch_dim<float>(q, k, v, o, lse, bh, t, d, causal, s);
  if (dtype == bigdl::kBFloat16)
    return (int)launch_dim<__nv_bfloat16>(q, k, v, o, lse, bh, t, d, causal, s);
  return (int)cudaErrorInvalidValue;
}
