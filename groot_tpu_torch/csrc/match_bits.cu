// Match volumes of the `host` engine, for every graph a read batch touches
// in one launch. A segment is one graph: path rows (u8 codes in a flat
// buffer, row r at byte row_off[r], row_len[r] bases; every position at or
// past a row's end is a wildcard) and a run of pairs in `pairs` (each the
// row of a read in `reads`, u8 [R, Lr], with read_len[R]). A pair has nvar
// variants: nvar == 1 takes the read row itself with var_len = read_len;
// nvar == 6 derives (fwd | rc) x (full | clip-start: read[1:], length
// Lr-1 | clip-end: length Lr-1), rc[j] = comp(read[len-1-j]), N staying N.
// For variant k, path row p and offset o < W (the segment's width), the
// output bit says whether the first var_len bases all match the row at o:
// a path N (code >= 4) matches any base, a read N only a path N. var_len 0
// matches everywhere, below 0 or above Lr nowhere. Segment s writes u32
// [R_s, nvar, P_s, ceil(W/32)] at word seg_out[s], bit b of word w the
// match at offset 32w + b, the bits at offsets >= W zero.
//
// Replaces groot_tpu/align/aligner.py::_match_bits (an XLA program: one
// bf16 convolution of [P, Lp, 5] path one-hots with [K, Lr, 5] variant
// one-hots a graph, a count compared with var_len, packed 32 offsets a
// word). That count is exact only while every partial sum is an integer
// the accumulator holds; this kernel never counts: it ANDs bits, exact by
// construction, with no float and no one-hot.
//
// Design: a block takes one work item, (segment, path row, group of pairs,
// chunk of output words), from a table the host builds, so one launch
// covers a whole batch of graphs and long rows split into chunks.
// - Bit planes: over the chunk's words and ceil(ls/32) more, five u32
//   planes in shared memory, built by ballots (a warp a word, a lane a
//   position, one coalesced byte load a lane, the loads of four words
//   issued before their ballots): plane c < 4 holds "the base is c or a
//   wildcard", plane 4 "the base is a wildcard". The funnel shift below
//   reads at most the chunk's last word + ceil(ls/32) (ls below).
// - The group's reads are staged in shared memory, and for nvar == 6 their
//   reverse complements beside them; a variant is then a pointer (+1 for
//   clip-start) and a length.
// - An item is a (variant, word w): acc starts all ones, and each base j
//   < var_len (cut to the staged bases) ANDs in the plane of that base shifted to offset 32w + j
//   (__funnelshift_r of two neighbouring words). The last word is masked
//   to W. In rounds of a thread an item, a thread first walks its word's
//   first kSerial bases alone, stopping once acc is 0, as most words are
//   by then; a word still live with bases left is queued, and a warp then
//   takes each queued word, a lane every 32nd remaining base, the lanes'
//   words ANDed by __reduce_and_sync. So a word that holds a true match
//   costs kSerial dependent steps and ceil((len - kSerial) / 32)
//   independent ones, where one thread walking it alone took len
//   dependent steps while its warp's other lanes idled.
//
// Any read length: a block stages, of each code row, only the segment's
// `ls` bases (the segment table's last column: the batch's width Lr, cut
// to the segment's longest read and its longest path row + 1). Past a
// row's end every position is a wildcard, so a variant longer than that
// can fail to match only at its first ls (clip-start: ls - 1) bases, and
// its walk stops there; the planes reach ceil(ls/32) words past the
// chunk. A segment whose block still does not fit the shared memory
// (long reads on long rows) takes the global route: the same block body
// with its planes and codes in a slice of a scratch the wrapper
// allocates, a fixed grid of blocks walking those work items in turn.
// What bounds it: the output words (4 bytes a (variant, row, word)), the
// rows' and reads' bases read once, and one AND a (variant, row, word,
// base) that the early exit leaves; at a read batch of the host engine
// (~500 graphs of a few rows of ~1.5 kb, ~4 reads each) all are small, so
// the launch is set by latency: the plane build, the barriers, and the
// longest walk of a block, over the waves of blocks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPlanes = 5;
constexpr int kUnroll = 4;
constexpr int kSerial = 8;  // bases a thread walks alone before its word queues
constexpr unsigned kFull = 0xffffffffu;

// columns of the segment table (int32 [S, kSegCols])
enum {
  kSegPairOff, kSegPairs, kSegRow0, kSegRows, kSegW, kSegW32, kSegPG, kSegWC,
  kSegLS, kSegCols
};

__device__ __forceinline__ int clamp_code(int c) { return c < 4 ? c : 4; }
__device__ __forceinline__ int comp_code(int c) { return c < 4 ? 3 - c : 4; }

// Item `it` of a block: its variant's staged codes (+1 for clip-start),
// its length, the bases its walk takes (the length, cut to the staged
// ones), and its pair, variant and word within the block.
struct Item {
  const uint8_t* codes;
  int len, lim, pl, v, wl;
};

__device__ __forceinline__ Item block_item(int it, const uint8_t* codes,
                                           const int32_t* pair_rd,
                                           const int32_t* read_len, int ls,
                                           int nvar, int nw) {
  Item r;
  const int per_pair = nvar * nw;
  r.pl = it / per_pair;
  const int rem = it - r.pl * per_pair;
  r.v = rem / nw;
  r.wl = rem - r.v * nw;
  r.codes = codes + static_cast<size_t>(r.pl) * (nvar == 6 ? 2 : 1) * ls;
  r.len = read_len[pair_rd[r.pl]];
  int staged = ls;
  if (nvar == 6) {
    const int strand = r.v >= 3;
    const int kind = r.v - 3 * strand;  // 0 full, 1 clip-start, 2 clip-end
    r.codes += strand * ls + (kind == 1);
    r.len -= kind > 0;
    staged -= kind == 1;
  }
  r.lim = min(r.len, staged);
  return r;
}

// One work item (segment, row, first pair, first word) of a block, its
// planes and codes at `base` (shared memory, or its scratch slice).
__device__ __forceinline__ void match_block(
    const int4 item, uint32_t* base, const uint8_t* __restrict__ rows,
    const int64_t* __restrict__ row_off, const int32_t* __restrict__ row_len,
    const uint8_t* __restrict__ reads, const int32_t* __restrict__ read_len,
    int Lr, const int32_t* __restrict__ pairs, const int32_t* __restrict__ segs,
    const int64_t* __restrict__ seg_out, int nvar, uint32_t* __restrict__ out) {
  const int32_t* seg = segs + item.x * kSegCols;
  const int n_pairs = min(seg[kSegPG], seg[kSegPairs] - item.z);
  const int nw = min(seg[kSegWC], seg[kSegW32] - item.w);
  const int P = seg[kSegRows], W = seg[kSegW], W32 = seg[kSegW32];
  const int ls = seg[kSegLS];
  const int word0 = item.w;
  const int nws = nw + (ls + 31) / 32;  // plane words this block reads
  const int ncodes = nvar == 6 ? 2 : 1;
  uint32_t* plane = base;  // [kPlanes][nws]
  uint8_t* codes = reinterpret_cast<uint8_t*>(base + kPlanes * nws);  // [pairs][ncodes][ls]
  const int32_t* pair_rd = pairs + seg[kSegPairOff] + item.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  const int row = seg[kSegRow0] + item.y;
  const uint8_t* rp = rows + row_off[row];
  const int rlen = row_len[row];
  for (int wb = warp; wb < nws; wb += kUnroll * n_warps) {  // warp-uniform
    int c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int wi = wb + u * n_warps;
      const int x = (word0 + wi) * 32 + lane;
      c[u] = (wi < nws && x < rlen) ? rp[x] : 4;  // past the row: wildcard
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int wi = wb + u * n_warps;
      if (wi >= nws) break;
      const uint32_t wild = __ballot_sync(kFull, c[u] >= 4);
      const uint32_t b0 = __ballot_sync(kFull, c[u] == 0) | wild;
      const uint32_t b1 = __ballot_sync(kFull, c[u] == 1) | wild;
      const uint32_t b2 = __ballot_sync(kFull, c[u] == 2) | wild;
      const uint32_t b3 = __ballot_sync(kFull, c[u] == 3) | wild;
      if (lane < kPlanes)
        plane[lane * nws + wi] =
            lane == 0 ? b0 : lane == 1 ? b1 : lane == 2 ? b2 : lane == 3 ? b3 : wild;
    }
  }
  for (int i = threadIdx.x; i < n_pairs * ls; i += blockDim.x) {
    const int pl = i / ls;
    const int j = i - pl * ls;
    const int r = pair_rd[pl];
    const uint8_t* rd = reads + static_cast<size_t>(r) * Lr;
    uint8_t* dst = codes + static_cast<size_t>(pl) * ncodes * ls;
    dst[j] = static_cast<uint8_t>(clamp_code(rd[j]));
    if (ncodes == 2) {
      const int src = read_len[r] - 1 - j;
      dst[ls + j] = static_cast<uint8_t>(
          src >= 0 && src < Lr ? comp_code(clamp_code(rd[src])) : 4);
    }
  }
  __syncthreads();

  __shared__ int queue_item[kThreads];
  __shared__ uint32_t queue_acc[kThreads];
  __shared__ int queue_n;
  const uint32_t last_mask = (W & 31) ? (1u << (W & 31)) - 1u : kFull;
  uint32_t* seg_words = out + seg_out[item.x];
  auto store = [&](const Item& r, uint32_t acc) {
    const int w = word0 + r.wl;
    if (w == W32 - 1) acc &= last_mask;
    const int64_t k = static_cast<int64_t>(item.z + r.pl) * nvar + r.v;
    seg_words[(k * P + item.y) * W32 + w] = acc;
  };
  const int n_items = n_pairs * nvar * nw;
  for (int round = 0; round < n_items; round += blockDim.x) {  // block-uniform
    if (threadIdx.x == 0) queue_n = 0;
    __syncthreads();
    const int it = round + threadIdx.x;
    if (it < n_items) {
      const Item r = block_item(it, codes, pair_rd, read_len, ls, nvar, nw);
      uint32_t acc = (r.len < 0 || r.len > Lr) ? 0u : kFull;
      const int j1 = min(r.lim, kSerial);
      for (int j = 0; j < j1 && acc; ++j) {
        const uint32_t* pw = plane + r.codes[j] * nws + r.wl + (j >> 5);
        acc &= __funnelshift_r(pw[0], pw[1], j & 31);
      }
      if (acc && r.lim > kSerial) {
        const int q = atomicAdd(&queue_n, 1);
        queue_item[q] = it;
        queue_acc[q] = acc;
      } else {
        store(r, acc);
      }
    }
    __syncthreads();
    for (int q = warp; q < queue_n; q += n_warps) {  // warp-uniform
      const Item r = block_item(queue_item[q], codes, pair_rd, read_len, ls, nvar, nw);
      uint32_t acc = kFull;
      for (int j = kSerial + lane; j < r.lim; j += 32) {
        const uint32_t* pw = plane + r.codes[j] * nws + r.wl + (j >> 5);
        acc &= __funnelshift_r(pw[0], pw[1], j & 31);
      }
      acc = __reduce_and_sync(kFull, acc) & queue_acc[q];
      if (lane == 0) store(r, acc);
    }
    __syncthreads();
  }
}

// The shared route: a block a work item, its planes and codes in shared
// memory.
__global__ void __launch_bounds__(kThreads) match_bits_kernel(
    const uint8_t* __restrict__ rows, const int64_t* __restrict__ row_off,
    const int32_t* __restrict__ row_len, const uint8_t* __restrict__ reads,
    const int32_t* __restrict__ read_len, int Lr,
    const int32_t* __restrict__ pairs, const int32_t* __restrict__ segs,
    const int64_t* __restrict__ seg_out, const int4* __restrict__ work,
    int nvar, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  match_block(work[blockIdx.x], smem, rows, row_off, row_len, reads, read_len,
              Lr, pairs, segs, seg_out, nvar, out);
}

// The global route: each block walks work items blockIdx.x, + gridDim.x,
// ... with its planes and codes in its slice of the scratch.
__global__ void __launch_bounds__(kThreads) match_bits_global_kernel(
    const uint8_t* __restrict__ rows, const int64_t* __restrict__ row_off,
    const int32_t* __restrict__ row_len, const uint8_t* __restrict__ reads,
    const int32_t* __restrict__ read_len, int Lr,
    const int32_t* __restrict__ pairs, const int32_t* __restrict__ segs,
    const int64_t* __restrict__ seg_out, const int4* __restrict__ work,
    int n_work, int nvar, uint8_t* __restrict__ scratch, long long slice_bytes,
    uint32_t* __restrict__ out) {
  uint32_t* base = reinterpret_cast<uint32_t*>(scratch + blockIdx.x * slice_bytes);
  for (int wi = blockIdx.x; wi < n_work; wi += gridDim.x) {
    match_block(work[wi], base, rows, row_off, row_len, reads, read_len, Lr,
                pairs, segs, seg_out, nvar, out);
    __syncthreads();  // the next item overwrites the slice
  }
}

constexpr int kGlobalBlocksPerSM = 2;  // the global route's blocks, each a slice

}  // namespace

// The dynamic shared memory a block of the shared route may take on the
// current device, in bytes: the opt-in limit less the kernel's static
// queue; -error on a CUDA error. The wrapper sends a segment whose blocks
// take more to the global route.
extern "C" long long groot_match_bits_smem_limit() {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa{};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, match_bits_kernel);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return static_cast<long long>(optin) - static_cast<long long>(fa.sharedSizeBytes);
}

// The global route's blocks (scratch slices) on the current device:
// kGlobalBlocksPerSM an SM; -error on a CUDA error.
extern "C" long long groot_match_bits_global_blocks() {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? static_cast<long long>(kGlobalBlocksPerSM) * sms
                            : -static_cast<long long>(err);
}

// rows u8 (flat), row_off i64 [NR], row_len i32 [NR], reads u8 [R, Lr],
// read_len i32 [R], pairs i32, segs i32 [S, 9] (pair offset, pairs, first
// row, rows, W, W32, pairs a block, words a block, staged bases a code
// row), seg_out i64 [S], work i32 [n_shared + n_global, 4] (16-byte
// aligned: segment, row within it, first pair, first word) -> out u32.
// The first n_shared items take the shared route with smem_bytes of
// dynamic shared memory a block (the most any of them needs); the
// n_global after them the global route: `slices` blocks, each with its
// slice_bytes (a multiple of 16) of `scratch`. Returns cudaGetLastError()
// after the launches, or the error of the shared-memory setup
// (cudaErrorInvalidValue when smem_bytes passes the card's opt-in limit).
extern "C" int groot_match_bits(const void* rows, const void* row_off,
                                const void* row_len, const void* reads,
                                const void* read_len, int Lr, const void* pairs,
                                const void* segs, const void* seg_out,
                                const void* work, int n_shared, int n_global,
                                int nvar, int smem_bytes, int slices,
                                long long slice_bytes, void* scratch, void* out,
                                void* stream) {
  if (n_shared < 0 || n_global < 0 || Lr < 1 || smem_bytes < 0 ||
      (nvar != 1 && nvar != 6) ||
      (n_global > 0 && (slices < 1 || slice_bytes < 16 || slice_bytes % 16 || !scratch)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* rw = static_cast<const uint8_t*>(rows);
  const int64_t* ro = static_cast<const int64_t*>(row_off);
  const int32_t* rl = static_cast<const int32_t*>(row_len);
  const uint8_t* rd = static_cast<const uint8_t*>(reads);
  const int32_t* dl = static_cast<const int32_t*>(read_len);
  const int32_t* pr = static_cast<const int32_t*>(pairs);
  const int32_t* sg = static_cast<const int32_t*>(segs);
  const int64_t* so = static_cast<const int64_t*>(seg_out);
  const int4* wk = static_cast<const int4*>(work);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (n_shared > 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa{};
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, match_bits_kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (static_cast<size_t>(smem_bytes) + fa.sharedSizeBytes > static_cast<size_t>(optin))
      return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(match_bits_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    match_bits_kernel<<<n_shared, kThreads, static_cast<size_t>(smem_bytes), st>>>(
        rw, ro, rl, rd, dl, Lr, pr, sg, so, wk, nvar, o);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_global > 0) {
    match_bits_global_kernel<<<slices < n_global ? slices : n_global, kThreads, 0, st>>>(
        rw, ro, rl, rd, dl, Lr, pr, sg, so, wk + n_shared, n_global, nvar,
        static_cast<uint8_t*>(scratch), slice_bytes, o);
  }
  return static_cast<int>(cudaGetLastError());
}
