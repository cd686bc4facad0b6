// LayerNorm over the last axis, forward and backward, for sm_90a.
//
// Forward: replaces the Pallas kernel bigdl_tpu/kernels/layernorm.py:31
// (_pallas_layer_norm): mean, mean of squared deviations (the two-pass
// formula of the TPU kernel, not E[x^2] - E[x]^2), rsqrt(var + eps) in fp32,
// then * gamma + beta, written in the input dtype.
//
// Backward: the counterpart of bigdl_tpu/kernels/layernorm.py:99 (_fln_bwd,
// the VJP of the plain formula in jnp, which XLA fuses). From x, the output
// gradient g and gamma it recomputes mean and inv, and with
// xhat = (x - mean)·inv and gx = g·gamma writes
//   dx = inv·(gx - mean(gx) - xhat·mean(gx·xhat)),
//   dgamma = Σ_rows g·xhat, dbeta = Σ_rows g,
// summed in fp32 and rounded once, at the end, to gamma's dtype.
//
// gamma and beta are fp32 or in the dtype of x (bf16 under the mixed
// precision policy, which casts every floating parameter to the compute
// dtype, as JAX does). Each lane converts them to fp32 on load, as the
// Pallas kernel promotes its bf16 g_ref, so the arithmetic is fp32 either
// way; the kernels are templates on x's type T and the parameters' type P.
//
// Bound: bytes. Each element takes a handful of flops, far below the card's
// fp32 ridge, so the kernels read every input once and write every output
// once, and otherwise only keep latency off the critical path. Design:
// - Rows of H <= 1024: one warp per row, the row held in registers (H/32
//   values a lane), read with 128-bit loads (4 fp32 or 8 bf16) when H and
//   the pointers allow and with scalar loads otherwise. Statistics come from
//   registers with __shfl_xor_sync only: no shared memory, no __syncthreads.
//   The forward packs 4 rows into a CTA, so a decode tick of 8 rows is 2
//   CTAs and the training shape's 8192 rows are 2048.
// - Wider rows: one CTA of 1024 threads per row, looping over the row in
//   global memory, so any H is taken, as the TPU kernel takes it.
// - dgamma and dbeta without float atomics: the backward's grid is `ctas`
//   CTAs striding over rows. Each lane accumulates g·xhat and g for its
//   columns over its warp's rows, the CTA sums its warps' partials in warp
//   order through shared memory and writes one partial row of 2·H floats to
//   a workspace, and a second kernel sums the partial rows column by column
//   in a fixed order. Two calls with the same plan agree bit for bit.
// - The backward launches the plan its caller gives it (CTAs, rows a CTA,
//   threads a row, elements a chunk, chunks a thread, warps of the column
//   sum): the Python wrapper
//   chooses it (layer_norm_bwd_plan), and the CPU emulation of the order of
//   sums imports the same function. This file only checks that the plan is
//   one its kernels can run.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kFwdWarps = 4;       // rows (warps) per CTA, forward warp path
constexpr int kBwdWarps = 8;       // warps per CTA, backward warp path
constexpr int kWarpMaxH = 1024;    // widest row of the warp paths
constexpr int kLoopThreads = 1024; // threads a row on the loop paths
constexpr int kReduceWarps = 8;    // warps of the column-sum kernel

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// Sums over the CTA (blockDim.x a multiple of 32): the warps' sums added in
// warp order, the same value in every thread and `red` free again on return.
__device__ __forceinline__ float block_sum(float v, float (*red)[32]) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[0][threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0][0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v += red[0][w];
  __syncthreads();
  return v;
}

__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float (*red)[32]) {
  warp_sum2(a, b);
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = a;
    red[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  a = red[0][0];
  b = red[1][0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
    a += red[0][w];
    b += red[1][w];
  }
  __syncthreads();
}

// VEC consecutive elements from p as fp32: 128-bit loads for VEC > 1 (p
// 16-byte aligned), a scalar load for VEC == 1.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* v) {
  if constexpr (VEC == 1) {
    v[0] = bigdl::to_f32(*p);
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(VEC % 4 == 0, "fp32 vectors are float4s");
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else {
    static_assert(VEC % 8 == 0, "bf16 vectors are 8 elements");
#pragma unroll
    for (int i = 0; i < VEC / 8; ++i) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[i];
      const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[k]));
        v[8 * i + 2 * k] = f.x;
        v[8 * i + 2 * k + 1] = f.y;
      }
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* v) {
  if constexpr (VEC == 1) {
    *p = bigdl::from_f32<T>(v[0]);
  } else if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 8; ++i) {
      unsigned int w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 b =
            __floats2bfloat162_rn(v[8 * i + 2 * k], v[8 * i + 2 * k + 1]);
        w[k] = *reinterpret_cast<const unsigned int*>(&b);
      }
      reinterpret_cast<uint4*>(p)[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Chunk c (VEC elements) of a row, or zeros past the row's `chunks`.
template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(const T* __restrict__ row, int c,
                                           int chunks, float* v) {
  if (c < chunks) {
    load_vec<T, VEC>(row + (size_t)c * VEC, v);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = 0.f;
  }
}

// Mean and inv = rsqrt(var + eps) of the row whose NV chunks of VEC values
// the warp's lanes hold (lane l: chunks l + 32·j, zeros past the row).
template <int VEC, int NV>
__device__ __forceinline__ void warp_row_stats(const float (&v)[NV][VEC],
                                               int lane, int chunks, int h,
                                               float eps, float& mean,
                                               float& inv) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) s += v[j][e];
  mean = warp_sum(s) / h;
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (lane + 32 * j < chunks) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = v[j][e] - mean;
        ss += d * d;
      }
    }
  }
  inv = rsqrtf(warp_sum(ss) / h + eps);
}

// ------------------------------------------------------------- forward
// One warp per row, kFwdWarps rows a CTA; lane l holds chunks l + 32·j.
template <typename T, typename P, int VEC, int NV>
__global__ void __launch_bounds__(kFwdWarps * 32)
ln_fwd_warp(const T* __restrict__ x, const P* __restrict__ gamma,
            const P* __restrict__ beta, T* __restrict__ out, long long n,
            int h, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kFwdWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const int chunks = h / VEC;
  const T* xr = x + (size_t)row * h;
  T* yr = out + (size_t)row * h;
  float v[NV][VEC], gam[NV][VEC], bet[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j) load_chunk<T, VEC>(xr, lane + 32 * j, chunks, v[j]);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    load_chunk<P, VEC>(gamma, lane + 32 * j, chunks, gam[j]);
    load_chunk<P, VEC>(beta, lane + 32 * j, chunks, bet[j]);
  }
  float mean, inv;
  warp_row_stats<VEC, NV>(v, lane, chunks, h, eps, mean, inv);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = lane + 32 * j;
    if (c < chunks) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        v[j][e] = (v[j][e] - mean) * inv * gam[j][e] + bet[j][e];
      store_vec<T, VEC>(yr + (size_t)c * VEC, v[j]);
    }
  }
}

// Rows wider than the warp path: one CTA per row, three passes over the
// row in global memory (the later two hit L1/L2).
template <typename T, typename P>
__global__ void __launch_bounds__(kLoopThreads)
ln_fwd_loop(const T* __restrict__ x, const P* __restrict__ gamma,
            const P* __restrict__ beta, T* __restrict__ out, int h,
            float eps) {
  __shared__ float red[2][32];
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
  for (int c = threadIdx.x; c < h; c += blockDim.x)
    yr[c] = bigdl::from_f32<T>((bigdl::to_f32(xr[c]) - mean) * inv *
                                   bigdl::to_f32(gamma[c]) +
                               bigdl::to_f32(beta[c]));
}

// ------------------------------------------------------------ backward
// One warp per row, kBwdWarps warps a CTA, the CTA's warps striding over
// rows (warp w of CTA b takes rows b·kBwdWarps + w, then every
// gridDim.x·kBwdWarps). Partials: ws row b = [Σ g·xhat (h), Σ g (h)].
template <typename T, typename P, int VEC, int NV>
__global__ void __launch_bounds__(kBwdWarps * 32)
ln_bwd_warp(const T* __restrict__ x, const T* __restrict__ g,
            const P* __restrict__ gamma, T* __restrict__ dx,
            float* __restrict__ ws, long long n, int h, float eps) {
  __shared__ float red[kBwdWarps][kWarpMaxH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = h / VEC;
  float gam[NV][VEC], adg[NV][VEC], adb[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    load_chunk<P, VEC>(gamma, lane + 32 * j, chunks, gam[j]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) adg[j][e] = adb[j][e] = 0.f;
  }
  for (long long row = (long long)blockIdx.x * kBwdWarps + warp; row < n;
       row += (long long)gridDim.x * kBwdWarps) {
    const size_t off = (size_t)row * h;
    float xv[NV][VEC], gv[NV][VEC];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      load_chunk<T, VEC>(x + off, lane + 32 * j, chunks, xv[j]);
      load_chunk<T, VEC>(g + off, lane + 32 * j, chunks, gv[j]);
    }
    float mean, inv;
    warp_row_stats<VEC, NV>(xv, lane, chunks, h, eps, mean, inv);
    float a = 0.f, b = 0.f;   // Σ gx, Σ gx·xhat (zero past the row: g is 0)
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = (xv[j][e] - mean) * inv;
        const float gx = gv[j][e] * gam[j][e];
        a += gx;
        b += gx * xh;
        adg[j][e] += gv[j][e] * xh;
        adb[j][e] += gv[j][e];
        xv[j][e] = xh;
        gv[j][e] = gx;
      }
    }
    warp_sum2(a, b);
    const float ma = a / h, mb = b / h;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = lane + 32 * j;
      if (c < chunks) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          xv[j][e] = inv * (gv[j][e] - ma - xv[j][e] * mb);
        store_vec<T, VEC>(dx + off + (size_t)c * VEC, xv[j]);
      }
    }
  }
  // the CTA's partial row: the warps' partials summed in warp order
  float* w = ws + (size_t)blockIdx.x * 2 * h;
#pragma unroll
  for (int part = 0; part < 2; ++part) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = lane + 32 * j;
      if (c < chunks) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          red[warp][c * VEC + e] = part == 0 ? adg[j][e] : adb[j][e];
      }
    }
    __syncthreads();
    for (int col = threadIdx.x; col < h; col += blockDim.x) {
      float t = red[0][col];
#pragma unroll
      for (int k = 1; k < kBwdWarps; ++k) t += red[k][col];
      w[part * h + col] = t;
    }
    __syncthreads();
  }
}

// Rows wider than the warp path: one CTA per row, CTA b taking rows b,
// b + gridDim.x, ...; four passes over the row in global memory; the CTA's
// workspace row is its own accumulator.
template <typename T, typename P>
__global__ void __launch_bounds__(kLoopThreads)
ln_bwd_loop(const T* __restrict__ x, const T* __restrict__ g,
            const P* __restrict__ gamma, T* __restrict__ dx,
            float* __restrict__ ws, long long n, int h, float eps) {
  __shared__ float red[2][32];
  float* w = ws + (size_t)blockIdx.x * 2 * h;
  for (int c = threadIdx.x; c < h; c += blockDim.x) w[c] = w[h + c] = 0.f;
  for (long long row = blockIdx.x; row < n; row += gridDim.x) {
    const T* xr = x + (size_t)row * h;
    const T* gr = g + (size_t)row * h;
    float s = 0.f;
    for (int c = threadIdx.x; c < h; c += blockDim.x) s += bigdl::to_f32(xr[c]);
    const float mean = block_sum(s, red) / h;
    float ss = 0.f;
    for (int c = threadIdx.x; c < h; c += blockDim.x) {
      const float d = bigdl::to_f32(xr[c]) - mean;
      ss += d * d;
    }
    const float inv = rsqrtf(block_sum(ss, red) / h + eps);
    float a = 0.f, b = 0.f;
    for (int c = threadIdx.x; c < h; c += blockDim.x) {
      const float xh = (bigdl::to_f32(xr[c]) - mean) * inv;
      const float gx = bigdl::to_f32(gr[c]) * bigdl::to_f32(gamma[c]);
      a += gx;
      b += gx * xh;
    }
    block_sum2(a, b, red);
    const float ma = a / h, mb = b / h;
    T* dxr = dx + (size_t)row * h;
    for (int c = threadIdx.x; c < h; c += blockDim.x) {
      const float gv = bigdl::to_f32(gr[c]);
      const float xh = (bigdl::to_f32(xr[c]) - mean) * inv;
      dxr[c] = bigdl::from_f32<T>(
          inv * (gv * bigdl::to_f32(gamma[c]) - ma - xh * mb));
      w[c] += gv * xh;
      w[h + c] += gv;
    }
  }
}

// out[col] = Σ_b ws[b][col] over the `ctas` partial rows, in a fixed order:
// warp k sums rows k, k + kReduceWarps, ..., then warp 0 adds the warps'
// sums in warp order and rounds the fp32 total once to P. One CTA per 32
// columns.
template <typename P>
__global__ void __launch_bounds__(kReduceWarps * 32)
ln_bwd_reduce(const float* __restrict__ ws, P* __restrict__ out, int ctas,
              int cols) {
  __shared__ float part[kReduceWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < cols)
    for (int b = warp; b < ctas; b += kReduceWarps) s += ws[(size_t)b * cols + col];
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float t = part[0][lane];
#pragma unroll
    for (int k = 1; k < kReduceWarps; ++k) t += part[k][lane];
    out[col] = bigdl::from_f32<P>(t);
  }
}

// ---------------------------------------------------------------- host
// Calls f(std::integral_constant<int, N>) for the N of Ns equal to nv.
template <int... Ns, typename F>
bool with_nv(int nv, F f) {
  return ((nv == Ns ? (f(std::integral_constant<int, Ns>{}), true) : false) ||
          ...);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Launches kern<VEC, NV> for a warp path: `vec` is 1 (scalar chunks) or
// V = 16 / sizeof(T) (128-bit chunks), `nv` the chunks a lane holds, one
// of the counts instantiated here; false for any other pair.
template <typename T, typename Go>
bool dispatch_warp(int vec, int nv, Go go) {
  constexpr int V = 16 / sizeof(T);
  const auto v1 = std::integral_constant<int, 1>{};
  const auto vv = std::integral_constant<int, V>{};
  if (vec == 1) return with_nv<2, 8, 32>(nv, [&](auto c) { go(v1, c); });
  if (vec != V) return false;
  if constexpr (V == 4)
    return with_nv<1, 2, 4, 8>(nv, [&](auto c) { go(vv, c); });
  else
    return with_nv<1, 2, 4>(nv, [&](auto c) { go(vv, c); });
}

// The forward's row layout: 128-bit chunks when h is a multiple of the
// chunk and every pointer is 16-byte aligned, and the fewest instantiated
// chunks a lane that cover the row.
template <typename T, typename P>
bool launch_fwd(const T* x, const P* gamma, const P* beta, T* out,
                long long n, int h, float eps, cudaStream_t s) {
  if (h > kWarpMaxH) {
    ln_fwd_loop<T, P><<<(unsigned)n, kLoopThreads, 0, s>>>(x, gamma, beta,
                                                           out, h, eps);
    return true;
  }
  constexpr int V = 16 / sizeof(T);
  const bool vectors = h % V == 0 && aligned16(x) && aligned16(gamma) &&
                       aligned16(beta) && aligned16(out);
  const int vec = vectors ? V : 1;
  const int per_lane = (h / vec + 31) / 32;
  int nv = 1;
  if (vec == 1) {
    nv = per_lane <= 2 ? 2 : per_lane <= 8 ? 8 : 32;
  } else {
    while (nv < per_lane) nv *= 2;
  }
  const dim3 grid((unsigned)((n + kFwdWarps - 1) / kFwdWarps));
  return dispatch_warp<T>(vec, nv, [&](auto vc, auto c) {
    ln_fwd_warp<T, P, decltype(vc)::value, decltype(c)::value>
        <<<grid, kFwdWarps * 32, 0, s>>>(x, gamma, beta, out, n, h, eps);
  });
}

// The backward plan's fields, as the caller passes them.
enum { kPlanCtas, kPlanRowsPerCta, kPlanThreads, kPlanVec, kPlanChunks,
       kPlanReduceWarps };

template <typename T, typename P>
bool launch_bwd(const T* x, const T* g, const P* gamma, T* dx, P* dgb,
                float* ws, long long n, int h, float eps, const int* plan,
                cudaStream_t s) {
  const int ctas = plan[kPlanCtas], vec = plan[kPlanVec];
  const int nv = plan[kPlanChunks];
  if (ctas <= 0 || plan[kPlanReduceWarps] != kReduceWarps) return false;
  const dim3 grid((unsigned)ctas);
  if (nv == 0) {   // the loop path
    if (plan[kPlanRowsPerCta] != 1 || plan[kPlanThreads] != kLoopThreads ||
        vec != 1)
      return false;
    ln_bwd_loop<T, P><<<grid, kLoopThreads, 0, s>>>(x, g, gamma, dx, ws, n,
                                                    h, eps);
  } else {
    if (plan[kPlanRowsPerCta] != kBwdWarps || plan[kPlanThreads] != 32 ||
        h > kWarpMaxH || vec <= 0 || h > 32 * nv * vec)
      return false;
    if (vec > 1 && (h % vec != 0 || !aligned16(x) || !aligned16(g) ||
                    !aligned16(gamma) || !aligned16(dx)))
      return false;
    const bool ok = dispatch_warp<T>(vec, nv, [&](auto vc, auto c) {
      ln_bwd_warp<T, P, decltype(vc)::value, decltype(c)::value>
          <<<grid, kBwdWarps * 32, 0, s>>>(x, g, gamma, dx, ws, n, h, eps);
    });
    if (!ok) return false;
  }
  if (cudaPeekAtLastError() != cudaSuccess) return true;  // reported below
  const int cols = 2 * h;
  ln_bwd_reduce<P><<<(cols + 31) / 32, kReduceWarps * 32, 0, s>>>(
      ws, dgb, ctas, cols);
  return true;
}

// Calls go(T*, P*) with the element types of x (`dtype`) and of gamma and
// beta (`param_dtype`): fp32, or the dtype of x. False for any other pair.
template <typename Go>
bool with_types(int dtype, int param_dtype, Go go) {
  using bf = __nv_bfloat16;
  if (dtype == bigdl::kFloat32 && param_dtype == bigdl::kFloat32)
    return go((float*)nullptr, (float*)nullptr);
  if (dtype == bigdl::kBFloat16 && param_dtype == bigdl::kFloat32)
    return go((bf*)nullptr, (float*)nullptr);
  if (dtype == bigdl::kBFloat16 && param_dtype == bigdl::kBFloat16)
    return go((bf*)nullptr, (bf*)nullptr);
  return false;
}

}  // namespace

// x, out: (n, h) contiguous in `dtype`; gamma, beta: (h,) contiguous in
// `param_dtype`, which is float32 or `dtype`. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int bigdl_layer_norm_fwd(const void* x, const void* gamma,
                                    const void* beta, void* out, long long n,
                                    int h, float eps, int dtype,
                                    int param_dtype, void* stream) {
  if (n <= 0) return 0;
  if (h <= 0 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = with_types(dtype, param_dtype, [&](auto* t, auto* p) {
    using T = std::remove_pointer_t<decltype(t)>;
    using P = std::remove_pointer_t<decltype(p)>;
    return launch_fwd<T, P>(static_cast<const T*>(x),
                            static_cast<const P*>(gamma),
                            static_cast<const P*>(beta), static_cast<T*>(out),
                            n, h, eps, s);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x, g, dx: (n, h) contiguous in `dtype`; gamma: (h,) in `param_dtype`
// (float32 or `dtype`); dgamma_dbeta: (2, h) in `param_dtype`, written as
// [dgamma; dbeta], summed in fp32 and rounded once; workspace: (ctas, 2·h)
// float32 scratch. `plan` holds six ints: CTAs (striding over
// the rows, one partial row each), rows a CTA holds at once (8 warps on the
// warp path, 1 on the loop path), threads a row (32, or 1024 on the loop
// path), elements a chunk (1, or 16 bytes' worth when h and the pointers
// allow), chunks a lane holds (0 selects the loop path) and the warps of
// the column-sum kernel (8). The sums of
// dgamma and dbeta depend on the plan and on nothing else that varies.
// Returns the cudaError_t of the launches (0 on success), or
// cudaErrorInvalidValue for a plan these kernels cannot run.
extern "C" int bigdl_layer_norm_bwd(const void* x, const void* g,
                                    const void* gamma, void* dx,
                                    void* dgamma_dbeta, void* workspace,
                                    long long n, int h, float eps, int dtype,
                                    int param_dtype, const int* plan,
                                    void* stream) {
  if (h <= 0 || n < 0 || plan == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  const bool ok = with_types(dtype, param_dtype, [&](auto* t, auto* p) {
    using T = std::remove_pointer_t<decltype(t)>;
    using P = std::remove_pointer_t<decltype(p)>;
    return launch_bwd<T, P>(static_cast<const T*>(x), static_cast<const T*>(g),
                            static_cast<const P*>(gamma), static_cast<T*>(dx),
                            static_cast<P*>(dgamma_dbeta), ws, n, h, eps, plan,
                            s);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
