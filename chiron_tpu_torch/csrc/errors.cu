// Error text for the codes the kernel entry points return.
#include "common.cuh"

CHIRON_EXPORT const char* chiron_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
