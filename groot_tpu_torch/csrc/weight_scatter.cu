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
// What bounds it on the card: at the main path's shapes (B = 2,048, C = 3,
// ~1,800 kept pairs, ~32 live of Cn = 85 node slots each) the bytes are
// about 1 MB, a third of a microsecond at 3.35 TB/s; the time is latency,
// the launches and one dependent chain per pair (a node row load, then an
// atomic). So the grid follows the kept pairs, not flat tiles (a grid of
// 1,024-slot tiles is 6 blocks at the main path's 6,144 slots), a pair's
// node slots are spread over a warp's lanes, and no phase runs on one
// block.
//
// Design, two launches on one stream:
//   1. weight_count_kernel, a grid sized to the card: zeroes node_w,
//      graph_k and mapped (one contiguous region, 16-byte stores) and
//      writes the kept count of each 1,024-slot tile;
//   2. weight_pairs_kernel, one block per S flat slots, S a power of two in
//      [64, 1,024] chosen so that the grid holds up to ~8 blocks an SM
//      (S = 64 at the main path: 96 blocks). A block ranks its slots
//      itself: the tile counts before its tile plus the kept slots of its
//      tile before it, then a block prefix sum; the slots ranked below P
//      (the reference's selection) go to a list in shared memory, and each
//      warp takes one listed pair at a time, its lanes over the Cn node
//      slots (coalesced loads of the win_nodes / win_coeff row, at most 3
//      rounds at Cn = 85), adding coeff * kc with f32 atomics (skipping -1
//      nodes); lane 0 adds floor(kc) to the pair's graph for multi-node
//      windows. Block 0 also sums every tile count for dropped.
// The atomics sum in another order than XLA's scatter, so node weights
// move in their last bits (graph_kmers are integers below 2^24 and exact).
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;
constexpr int kTile = kThreads * kPer;  // slots a tile count covers
constexpr int kMaxSub = kTile;          // most slots of a launch-2 block

// Sum over the block, returned to every thread (all threads must call it).
__device__ long long block_sum(long long v, long long* warp_sums) {
  __shared__ long long total;
  v = block_inclusive_scan(v, warp_sums);
  if (threadIdx.x == blockDim.x - 1) total = v;
  __syncthreads();
  const long long t = total;
  __syncthreads();
  return t;
}

__global__ void weight_count_kernel(const int32_t* __restrict__ win,
                                    long long n, long long n_tiles,
                                    uint4* __restrict__ zero, long long n_zero,
                                    int32_t* __restrict__ tile_cnt) {
  __shared__ long long warp_sums[32];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n_zero; i += stride)
    zero[i] = make_uint4(0u, 0u, 0u, 0u);
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int c = 0;
    for (int p = 0; p < kPer; ++p) {
      const long long i = t * kTile + p * kThreads + threadIdx.x;
      c += i < n && win[i] >= 0;
    }
    const long long total = block_sum(c, warp_sums);
    if (threadIdx.x == 0) tile_cnt[t] = static_cast<int32_t>(total);
  }
}

__global__ void weight_pairs_kernel(
    const int32_t* __restrict__ win, long long n, int C, int S,
    const int32_t* __restrict__ kc, const int32_t* __restrict__ win_nodes,
    int Cn, const float* __restrict__ win_coeff,
    const uint8_t* __restrict__ win_multi, const int32_t* __restrict__ graph_ids,
    long long P, const int32_t* __restrict__ tile_cnt, long long n_tiles,
    float* __restrict__ node_w, float* __restrict__ graph_k,
    uint8_t* __restrict__ mapped, int32_t* __restrict__ dropped) {
  __shared__ long long warp_sums[32];
  __shared__ int32_t list_w[kMaxSub];
  __shared__ float list_kc[kMaxSub];
  __shared__ int list_n;
  const long long s0 = static_cast<long long>(blockIdx.x) * S;
  const long long t0 = s0 / kTile;

  // kept slots before this block: whole tiles, then this tile's head
  long long pre = 0;
  for (long long t = threadIdx.x; t < t0; t += blockDim.x) pre += tile_cnt[t];
  for (long long i = t0 * kTile + threadIdx.x; i < s0; i += blockDim.x)
    pre += win[i] >= 0;
  pre = block_sum(pre, warp_sums);
  if (blockIdx.x == 0) {  // uniform per block
    long long tot = 0;
    for (long long t = threadIdx.x; t < n_tiles; t += blockDim.x) tot += tile_cnt[t];
    tot = block_sum(tot, warp_sums);
    if (threadIdx.x == 0) dropped[0] = static_cast<int32_t>(tot > P ? tot - P : 0);
  }

  // rank this block's slots in flat order; list those below P
  const int per = S > kThreads ? S / kThreads : 1;
  const int local0 = threadIdx.x * per;
  int32_t w[kPer];
  int cnt = 0;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const long long i = s0 + local0 + p;
    w[p] = p < per && local0 + p < S && i < n ? win[i] : -1;
    cnt += w[p] >= 0;
  }
  const long long incl = block_inclusive_scan(cnt, warp_sums);
  long long rank = pre + incl - cnt;
  if (threadIdx.x == blockDim.x - 1) {
    const long long room = P - pre;
    list_n = static_cast<int>(room < 0 ? 0 : (room < incl ? room : incl));
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    if (w[p] < 0) continue;
    const int b = static_cast<int>((s0 + local0 + p) / C);
    mapped[b] = 1;
    if (rank < P) {
      const int e = static_cast<int>(rank - pre);
      list_w[e] = w[p];
      list_kc[e] = __int2float_rn(kc[b]);
    }
    ++rank;
  }
  __syncthreads();

  // one warp per listed pair, lanes over its node slots
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int e = warp; e < list_n; e += n_warps) {
    const int32_t wi = list_w[e];
    const float kcf = list_kc[e];
    const size_t row = static_cast<size_t>(wi) * Cn;
    for (int j = lane; j < Cn; j += 32) {
      const int32_t node = win_nodes[row + j];
      if (node >= 0) atomicAdd(node_w + node, __fmul_rn(win_coeff[row + j], kcf));
    }
    if (lane == 0 && win_multi[wi]) atomicAdd(graph_k + graph_ids[wi], floorf(kcf));
  }
}

}  // namespace

extern "C" int groot_weight_scatter(
    const void* win, int B, int C, const void* kc, const void* win_nodes,
    int Cn, const void* win_coeff, const void* win_multi,
    const void* graph_ids, long long P, void* node_w, long long zero_bytes,
    void* graph_k, void* mapped, void* tile_cnt, void* dropped, void* stream) {
  if (B < 0 || C < 0 || Cn < 1 || P < 0 || zero_bytes < 0 || zero_bytes % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(B) * C;
  const long long n_tiles = (n + kTile - 1) / kTile;
  // launch 2's slots a block: the least power of two in [64, 1,024] that
  // keeps the grid within ~8 blocks an SM
  int S = 64;
  while (S < kMaxSub && (n + S - 1) / S > 8LL * n_sm) S <<= 1;
  const long long blocks2 = (n + S - 1) / S;
  const long long n_zero = zero_bytes / 16;
  long long blocks1 = n_tiles < 16LL * n_sm ? n_tiles : 16LL * n_sm;
  if (blocks1 < 2LL * n_sm) blocks1 = 2LL * n_sm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  weight_count_kernel<<<static_cast<unsigned>(blocks1), kThreads, 0, st>>>(
      static_cast<const int32_t*>(win), n, n_tiles, static_cast<uint4*>(node_w),
      n_zero, static_cast<int32_t*>(tile_cnt));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  weight_pairs_kernel<<<static_cast<unsigned>(blocks2 > 0 ? blocks2 : 1), kThreads,
                        0, st>>>(
      static_cast<const int32_t*>(win), n, C > 0 ? C : 1, S,
      static_cast<const int32_t*>(kc),
      static_cast<const int32_t*>(win_nodes), Cn,
      static_cast<const float*>(win_coeff), static_cast<const uint8_t*>(win_multi),
      static_cast<const int32_t*>(graph_ids), P,
      static_cast<const int32_t*>(tile_cnt), n_tiles, static_cast<float*>(node_w),
      static_cast<float*>(graph_k), static_cast<uint8_t*>(mapped),
      static_cast<int32_t*>(dropped));
  return static_cast<int>(cudaGetLastError());
}
