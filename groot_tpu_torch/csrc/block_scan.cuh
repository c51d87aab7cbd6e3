// Block-wide inclusive prefix sum, shared by the kernels that compact
// flagged elements in order (window_sketch.cu, weight_scatter.cu).
#pragma once

#include <cuda_runtime.h>

// Inclusive prefix sum over the block (blockDim.x a multiple of 32);
// `warp_sums` is shared scratch of 32 entries. All threads must call it.
static __device__ long long block_inclusive_scan(long long v,
                                                 long long* warp_sums) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const long long n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_sums[wid] = v;
  __syncthreads();
  if (wid == 0) {
    long long ws = lane < n_warps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const long long n = __shfl_up_sync(0xffffffffu, ws, o);
      if (lane >= o) ws += n;
    }
    if (lane < n_warps) warp_sums[lane] = ws;
  }
  __syncthreads();
  if (wid > 0) v += warp_sums[wid - 1];
  __syncthreads();  // warp_sums may be reused by the caller
  return v;
}
