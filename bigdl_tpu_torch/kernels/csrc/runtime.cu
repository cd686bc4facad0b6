// Runtime helpers exported beside the kernels' C entry points.
#include <cuda_runtime.h>

// Human-readable name of a cudaError_t returned by a launch function.
extern "C" const char* bigdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
