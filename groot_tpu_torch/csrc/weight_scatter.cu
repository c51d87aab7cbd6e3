// Window weighting of the fused align step: kept (read, window) pairs ->
// node weights f32 [num_nodes], per-graph k-mer totals f32 [num_graphs],
// mapped [B] and the count of kept pairs past the pair budget.
//
// Replaces the weighting half of groot_tpu/parallel/device_index.py::
// align_step (an XLA program): the reference compacts the kept slots of
// win_idx [B, C] (flat row-major) to the first P with a stable argsort,
// gathers win_nodes / win_coeff [P, Cn] and scatter-adds coeff * kc into the
// node weights, floor(kc) into graph_kmers[graph_ids[w]] for windows that
// span several nodes (win_multi), counts dropped = max(n_kept - P, 0) and
// sets mapped[b] = any kept slot in row b (over every kept slot, not only
// the first P).
//
// Design, three launches on one stream:
//   1. weight_count_kernel, one block per tile of 1,024 flat slots: zeroes
//      the outputs (grid-stride) and writes the tile's count of kept slots;
//   2. weight_scan_kernel, one block: exclusive prefix sum of the tile
//      counts in flat order, and dropped;
//   3. weight_scatter_kernel, one block per tile: a block prefix sum ranks
//      each kept slot in flat order, so the slots ranked below P are the
//      reference's selection; each adds coeff * kc to its window's nodes
//      with f32 atomics (skipping -1 nodes) and floor(kc) to its graph.
// The atomics sum in another order than XLA's scatter, so node weights
// move in their last bits (graph_kmers are integers below 2^24 and exact).
// What bounds it on the card: the atomics, about 3 kept pairs per read
// times Cn nodes, and launch latency; the flat slots are read twice.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;
constexpr int kTile = kThreads * kPer;

__global__ void weight_count_kernel(
    const int32_t* __restrict__ win, long long n, int B, int num_nodes,
    int num_graphs, int32_t* __restrict__ tile_cnt,
    float* __restrict__ node_w, float* __restrict__ graph_k,
    uint8_t* __restrict__ mapped) {
  __shared__ long long warp_sums[32];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < num_nodes; i += stride)
    node_w[i] = 0.0f;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < num_graphs; i += stride)
    graph_k[i] = 0.0f;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < B; i += stride)
    mapped[i] = 0;
  const long long i0 = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kPer;
  int cnt = 0;
  for (int p = 0; p < kPer; ++p)
    cnt += i0 + p < n && win[i0 + p] >= 0;
  const long long total = block_inclusive_scan(cnt, warp_sums);
  if (threadIdx.x == blockDim.x - 1) tile_cnt[blockIdx.x] = static_cast<int32_t>(total);
}

// off[i] = sum of cnt[0 .. i-1]; dropped = max(total - P, 0). One block.
__global__ void weight_scan_kernel(const int32_t* __restrict__ cnt, int n,
                                   long long P, int64_t* __restrict__ off,
                                   int32_t* __restrict__ dropped) {
  __shared__ long long warp_sums[32];
  __shared__ long long carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int b = 0; b < n; b += blockDim.x) {
    const int i = b + threadIdx.x;
    const long long v = i < n ? cnt[i] : 0;
    const long long incl = block_inclusive_scan(v, warp_sums);
    const long long c0 = carry;
    if (i < n) off[i] = c0 + incl - v;
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry = c0 + incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const long long d = carry - P;
    dropped[0] = static_cast<int32_t>(d > 0 ? d : 0);
  }
}

__global__ void weight_scatter_kernel(
    const int32_t* __restrict__ win, long long n, int C,
    const int32_t* __restrict__ kc, const int32_t* __restrict__ win_nodes,
    int Cn, const float* __restrict__ win_coeff,
    const uint8_t* __restrict__ win_multi, const int32_t* __restrict__ graph_ids,
    long long P, const int64_t* __restrict__ tile_off,
    float* __restrict__ node_w, float* __restrict__ graph_k,
    uint8_t* __restrict__ mapped) {
  __shared__ long long warp_sums[32];
  const long long i0 = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kPer;
  int32_t w[kPer];
  int cnt = 0;
  for (int p = 0; p < kPer; ++p) {
    w[p] = i0 + p < n ? win[i0 + p] : -1;
    cnt += w[p] >= 0;
  }
  long long rank = tile_off[blockIdx.x] + block_inclusive_scan(cnt, warp_sums) - cnt;
  for (int p = 0; p < kPer; ++p) {
    if (w[p] < 0) continue;
    const int b = static_cast<int>((i0 + p) / C);
    mapped[b] = 1;
    if (rank++ >= P) continue;
    const float kcf = __int2float_rn(kc[b]);
    const size_t row = static_cast<size_t>(w[p]) * Cn;
    for (int j = 0; j < Cn; ++j) {
      const int32_t node = win_nodes[row + j];
      if (node >= 0) atomicAdd(node_w + node, __fmul_rn(win_coeff[row + j], kcf));
    }
    if (win_multi[w[p]]) atomicAdd(graph_k + graph_ids[w[p]], floorf(kcf));
  }
}

}  // namespace

extern "C" int groot_weight_scatter(
    const void* win, int B, int C, const void* kc, const void* win_nodes,
    int Cn, const void* win_coeff, const void* win_multi,
    const void* graph_ids, int num_nodes, int num_graphs, long long P,
    void* tile_cnt, void* tile_off, void* node_w, void* graph_k, void* mapped,
    void* dropped, void* stream) {
  if (B < 0 || C < 0 || Cn < 1 || num_nodes < 0 || num_graphs < 0 || P < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * C;
  const long long tiles = (n + kTile - 1) / kTile;
  const int n_tiles = static_cast<int>(tiles > 0 ? tiles : 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  weight_count_kernel<<<n_tiles, kThreads, 0, st>>>(
      static_cast<const int32_t*>(win), n, B, num_nodes, num_graphs,
      static_cast<int32_t*>(tile_cnt), static_cast<float*>(node_w),
      static_cast<float*>(graph_k), static_cast<uint8_t*>(mapped));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  weight_scan_kernel<<<1, 1024, 0, st>>>(
      static_cast<const int32_t*>(tile_cnt), n_tiles, P,
      static_cast<int64_t*>(tile_off), static_cast<int32_t*>(dropped));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  weight_scatter_kernel<<<n_tiles, kThreads, 0, st>>>(
      static_cast<const int32_t*>(win), n, C > 0 ? C : 1,
      static_cast<const int32_t*>(kc), static_cast<const int32_t*>(win_nodes),
      Cn, static_cast<const float*>(win_coeff),
      static_cast<const uint8_t*>(win_multi),
      static_cast<const int32_t*>(graph_ids), P,
      static_cast<const int64_t*>(tile_off), static_cast<float*>(node_w),
      static_cast<float*>(graph_k), static_cast<uint8_t*>(mapped));
  return static_cast<int>(cudaGetLastError());
}
