// Error text for the codes the kernel entry points return
// (cudaGetLastError() after each launch), read by _build.Kernel.launch, and
// the card's opt-in shared memory a block, read by _build.smem_optin.
#include <cuda_runtime.h>

extern "C" const char* groot_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The shared memory a block may opt in to on the current device, in bytes
// (the EM wrapper sizes the CSR graphs it stages by it), -error on failure.
extern "C" long long groot_smem_optin() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? optin : -static_cast<long long>(err);
}
