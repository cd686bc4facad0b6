// Runtime helpers exported beside the kernels' C entry points.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Human-readable name of a cudaError_t returned by a launch function.
extern "C" const char* bigdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches a kernel that does nothing, one warp, on `stream`: the floor
// under any launch of the port's kernels through the C interface.
extern "C" int bigdl_empty_launch(void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  empty_kernel<<<1, 32, 0, s>>>();
  return (int)cudaGetLastError();
}
