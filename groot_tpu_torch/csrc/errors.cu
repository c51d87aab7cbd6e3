// Error text for the codes the kernel entry points return
// (cudaGetLastError() after each launch), read by _build.Kernel.launch.
#include <cuda_runtime.h>

extern "C" const char* groot_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
