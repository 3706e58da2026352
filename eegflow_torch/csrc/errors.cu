// CUDA error text for the Python wrappers.
#include <cuda_runtime.h>

extern "C" const char* eegflow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
