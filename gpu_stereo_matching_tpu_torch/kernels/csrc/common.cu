// Helpers shared by the kernels' C entries.

#include <cuda_runtime.h>

// Message for a CUDA error code returned by an entry.
extern "C" const char* gsm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
