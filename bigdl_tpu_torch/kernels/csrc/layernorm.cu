// LayerNorm forward over the last axis, for sm_90a.
//
// Replaces the Pallas kernel bigdl_tpu/kernels/layernorm.py:31
// (_pallas_layer_norm): mean, variance of the deviations, rsqrt(var + eps)
// in fp32, then * gamma + beta, written in the input dtype.
//
// Bound: bytes. Each element is read from device memory once and written
// once and takes a handful of flops, far below the card's ~20 flops per byte
// fp32 ridge. Design: one CTA per row (the TPU kernel's row block becomes
// one row per CTA, since CTAs run in parallel and need no carried state),
// threads stride over the row so every warp access is coalesced. The two
// later passes re-read the row, which a CTA just touched, from L1/L2 rather
// than device memory, so the row costs one device read for any H. The
// variance is the mean of squared deviations (the two-pass formula of the
// TPU kernel), not E[x^2] - E[x]^2.
#include "common.cuh"

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the CTA; blockDim.x is a multiple of 32. `red` holds 33 floats.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? red[lane] : 0.f;
    w = warp_sum(w);
    if (lane == 0) red[32] = w;
  }
  __syncthreads();
  const float total = red[32];
  __syncthreads();  // red is reused by the next reduction
  return total;
}

template <typename T>
__global__ void __launch_bounds__(256)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ out,
                      int h, float eps) {
  __shared__ float red[33];
  const size_t row = blockIdx.x;
  const T* xr = x + row * h;
  T* yr = out + row * h;

  float s = 0.f;
  for (int c = threadIdx.x; c < h; c += blockDim.x) s += bigdl::to_f32(xr[c]);
  const float mean = block_sum(s, red) / h;

  float ss = 0.f;
  for (int c = threadIdx.x; c < h; c += blockDim.x) {
    const float d = bigdl::to_f32(xr[c]) - mean;
    ss += d * d;
  }
  const float inv = rsqrtf(block_sum(ss, red) / h + eps);

  for (int c = threadIdx.x; c < h; c += blockDim.x) {
    const float y = (bigdl::to_f32(xr[c]) - mean) * inv * gamma[c] + beta[c];
    yr[c] = bigdl::from_f32<T>(y);
  }
}

}  // namespace

// x, out: (n, h) contiguous in `dtype`; gamma, beta: (h,) float32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int bigdl_layer_norm_fwd(const void* x, const void* gamma,
                                    const void* beta, void* out, long long n,
                                    int h, float eps, int dtype, void* stream) {
  if (n <= 0) return 0;
  if (h <= 0 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int threads = h >= 1024 ? 256 : 128;
  const dim3 grid((unsigned)n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  if (dtype == bigdl::kFloat32) {
    layer_norm_fwd_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(x), g, b, static_cast<float*>(out), h, eps);
  } else if (dtype == bigdl::kBFloat16) {
    layer_norm_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), g, b,
        static_cast<__nv_bfloat16*>(out), h, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
