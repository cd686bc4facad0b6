// Greedy non-maximum suppression: the sequential sweep of nms_mask.
//
// Replaces no Pallas kernel. It is the greedy pass of
// bigdl_tpu/nn/detection.py:56-79 (nms_mask), which JAX runs as a
// lax.fori_loop of K steps inside one XLA program; in PyTorch the same loop
// is about 4 launches a step (K = 400 for SSD's nms_topk, 1,333 for a Mask
// R-CNN proposal level, 999 for its class rows), so it is one kernel here.
//
// Input: the (rows, K, K) fp32 IoU matrices of score-sorted candidates
// (computed by the shared torch pairwise_iou, so the kernel and its plain
// version start from identical floats), the (rows, K) alive flags and the
// threshold. Output: the (rows, K) keep flags.
//
// One CTA a row; the row's keep flags live in shared memory. The CTA walks
// j = 0..K-1; when it reaches j, keep[j] is final (every earlier candidate
// has been applied), and if it is kept its threads clear keep[i] for every
// i > j with iou[j, i] > thr, reading row j of the matrix coalesced. That
// reads exactly the entries JAX's loop reads (iou[j, i] with j < i and j
// kept), with the same comparison, so the keep bits equal the plain
// version's bit for bit.
//
// What bounds it: K sequential block-wide steps, each ended by a barrier
// when its candidate is kept, and reading up to K^2/2 floats a row. The
// bytes are far below the card's rate; the steps are latency. A faster
// later design is the bitmask one: every CTA computes 64-bit suppression
// masks of a tile of (j, i) pairs in parallel, and one warp a row then
// sweeps K words instead of K barriers.
#include <cuda_runtime.h>

namespace {

constexpr int kNmsThreads = 256;

__global__ void __launch_bounds__(kNmsThreads)
nms_sweep_kernel(const float* __restrict__ iou,
                 const unsigned char* __restrict__ alive,
                 unsigned char* __restrict__ keep_out, int k, float thr) {
  extern __shared__ unsigned char keep[];
  const long long row = blockIdx.x;
  const float* m = iou + row * (long long)k * k;
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    keep[i] = alive[row * k + i] ? 1 : 0;
  __syncthreads();
  for (int j = 0; j < k - 1; ++j) {
    // keep[j] was last written before the last barrier: every thread reads
    // the same value, so the branch (and its barrier) is uniform
    if (keep[j]) {
      const float* r = m + (long long)j * k;
      for (int i = j + 1 + threadIdx.x; i < k; i += blockDim.x)
        if (r[i] > thr) keep[i] = 0;
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    keep_out[row * k + i] = keep[i];
}

}  // namespace

extern "C" int bigdl_nms_sweep(const void* iou, const void* alive,
                               void* keep, long long rows, int k, float thr,
                               void* stream) {
  if (rows == 0 || k == 0) return 0;
  if (rows < 0 || k < 0 || rows > 0x7fffffffLL || k > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_sweep_kernel<<<(unsigned)rows, kNmsThreads, k, s>>>(
      static_cast<const float*>(iou),
      static_cast<const unsigned char*>(alive),
      static_cast<unsigned char*>(keep), k, thr);
  return (int)cudaGetLastError();
}
