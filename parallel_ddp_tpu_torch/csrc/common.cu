// What every kernel source of this library shares at link time and no kernel
// owns: the message for a CUDA error code returned by a launch function.

#include <cuda_runtime.h>

extern "C" const char* pddp_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
