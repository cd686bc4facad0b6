// Host side of the port's TMA loads: the driver's tensor-map encoder and
// the 3-D maps over (d, T, b·h) that the flash kernels read through.
//
// The encoder is fetched through cudaGetDriverEntryPoint, so nothing links
// against libcuda; maps are encoded for every call (the pointers change)
// and passed to the kernels as __grid_constant__ parameters.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

namespace bigdl {
namespace sm90 {

inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A 3-D map over (d, T, b·h) with a (box0, box1, 1) box: TMA zero-fills
// past T inside each head, never reading the next head's rows. swizzle:
// 128, 64 (bytes) or 0 for none.
inline bool make_map(CUtensorMap* map, const void* ptr, bool f32, long long bh,
                     int t, int d, int box0, int box1, int swizzle) {
  const auto encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t es = f32 ? 4 : 2;
  cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  cuuint64_t strides[2] = {d * es, (cuuint64_t)t * d * es};
  cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_NONE;
  return encode(map,
                f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Consumer warpgroups (64 rows each) a CTA for (b·h, T) operands: two when
// that still gives every SM a CTA, else one. Callers cap it where two do
// not fit in shared memory.
inline int consumer_warpgroups(long long bh, int t) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return t > 64 && bh * ((t + 127) / 128) >= sms ? 2 : 1;
}

}  // namespace sm90
}  // namespace bigdl
