// Run-start window sketches of the index build: u8 path rows [R, L] ->
// (rows, cols, sketches u64 [M, s]) of every window whose KHF sketch differs
// from its predecessor's (and every row's first window).
//
// Replaces groot_tpu/index/window.py::window_sketches with _change_mask and
// _gather_sketches (XLA programs): the reference computes every stride-1
// window sketch [P, nw, s] with a van Herk sliding minimum over (hi, lo)
// uint32 pairs, flags run starts on the device and gathers them in fixed
// ROW_CHUNK x BLOCK_NW shapes, stitching runs across column blocks on the
// host. It returns the contract of native.window_sketch
// (groot_tpu/io/native.py): run starts in row-major order, columns
// ascending within a row, so _merge_windows_soa runs unchanged.
//
// Design, three launches on one stream:
//   1. window_sketch_kernel, one block per (row, tile of kTileW windows).
//      The block stages the tile's bases (a halo of w-1 bases, plus one more
//      window in front: the previous tile's last window) in shared memory,
//      computes each k-mer's canonical hash once (nthash.cuh), and then per
//      slot: the slot's hashes, the minimum over every aligned run of p
//      k-mers (p the largest power of two <= m = w-k+1, by log2(p) doubling
//      passes between two shared buffers), and each window's minimum as
//      min(M_p[i], M_p[i+m-p]). A window differs from its predecessor when
//      any slot does; the halo window makes the test at the tile's first
//      window exact. Sketches go to a slot-major scratch [s, cap] of every
//      valid window (coalesced stores), flags to [cap], and the tile's count
//      of run starts to tile_cnt.
//   2. window_scan_kernel, one block: exclusive prefix sum of the tile
//      counts in row-major tile order -> each tile's first output slot, M.
//   3. window_compact_kernel, one block per tile: a block-wide prefix sum
//      over the tile's flags ranks its run starts; each goes to its slot.
// Windows past len-w are never computed, and every k-mer of a valid window
// is valid, so no masking is needed. Codes above 4 count as N (seed 0).
//
// What bounds it on the card: integer instructions in step 1 (per window
// and slot one multiply-xorshift, ~log2(m) + 2 u64 minima, all in shared
// memory), then the scratch: 8*s bytes per window written once and read
// back only for the run starts.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"
#include "nthash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 1024;  // windows per block
constexpr int kPer = kTileW / kThreads;

__global__ void window_sketch_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ lens,
    const int64_t* __restrict__ row_base, int L, int k, int s, int w,
    int n_tiles, long long cap, u64* __restrict__ sk_scratch,
    uint8_t* __restrict__ flags, int32_t* __restrict__ tile_cnt) {
  extern __shared__ u64 smem[];
  __shared__ long long warp_sums[32];
  const int m = w - k + 1;
  const int nk_cap = kTileW + m;
  u64* c = smem;
  u64* buf0 = c + nk_cap;
  u64* buf1 = buf0 + nk_cap;
  uint8_t* row = reinterpret_cast<uint8_t*>(buf1 + nk_cap);
  uint8_t* diff = row + kTileW + w;

  const int r = blockIdx.x, t = blockIdx.y;
  const int nw = lens[r] - w + 1;  // valid windows of the row
  const int t0 = t * kTileW;
  const int tile = r * n_tiles + t;
  if (t0 >= nw) {
    if (threadIdx.x == 0) tile_cnt[tile] = 0;
    return;
  }
  const int nt = nw - t0 < kTileW ? nw - t0 : kTileW;  // windows emitted
  const int halo = t0 > 0 ? 1 : 0;
  const int a0 = t0 - halo;     // first window computed
  const int nwc = nt + halo;    // windows computed
  const int nk = nwc + m - 1;   // their k-mers
  const int nb = nk + k - 1;    // their bases
  const uint8_t* src = codes + static_cast<size_t>(r) * L + a0;
  const size_t base = static_cast<size_t>(row_base[r]) + a0;
  const u64 kseed = static_cast<u64>(k) * kMultiSeed;

  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const uint8_t b = src[i];
    row[i] = b > 4 ? 4 : b;
  }
  for (int i = threadIdx.x; i < nwc; i += blockDim.x) diff[i] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < nk; j += blockDim.x)
    c[j] = canonical_kmer_hash(row + j, k);
  __syncthreads();

  int p = 1;
  while (2 * p <= m) p *= 2;
  for (int slot = 0; slot < s; ++slot) {
    for (int j = threadIdx.x; j < nk; j += blockDim.x)
      buf0[j] = slot_hash(c[j], slot, kseed);
    __syncthreads();
    u64* cur = buf0;  // cur[j] = min of the slot's hashes j .. j+d-1
    u64* nxt = buf1;
    for (int d = 1; d < p; d *= 2) {
      for (int j = threadIdx.x; j < nk - 2 * d + 1; j += blockDim.x) {
        const u64 a = cur[j], b = cur[j + d];
        nxt[j] = a < b ? a : b;
      }
      __syncthreads();
      u64* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    for (int i = threadIdx.x; i < nwc; i += blockDim.x) {
      u64 v = cur[i], v2 = cur[i + m - p];
      v = v2 < v ? v2 : v;
      if (i > 0) {
        u64 u = cur[i - 1], u2 = cur[i - 1 + m - p];
        u = u2 < u ? u2 : u;
        if (u != v) diff[i] = 1;
      }
      if (i >= halo)
        sk_scratch[static_cast<size_t>(slot) * cap + base + i] = v;
    }
    __syncthreads();  // the next slot rewrites buf0
  }

  int cnt = 0;
  for (int i = halo + threadIdx.x; i < nwc; i += blockDim.x) {
    const uint8_t f = (a0 + i == 0) || diff[i];
    flags[base + i] = f;
    cnt += f;
  }
  const long long total = block_inclusive_scan(cnt, warp_sums);
  if (threadIdx.x == blockDim.x - 1) tile_cnt[tile] = static_cast<int32_t>(total);
}

// off[i] = sum of cnt[0 .. i-1] for i <= n (off[n] = the total), one block.
__global__ void window_scan_kernel(const int32_t* __restrict__ cnt, int n,
                                   int64_t* __restrict__ off) {
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
  if (threadIdx.x == 0) off[n] = carry;
}

__global__ void window_compact_kernel(
    const int32_t* __restrict__ lens, const int64_t* __restrict__ row_base,
    int w, int s, int n_tiles, long long cap,
    const u64* __restrict__ sk_scratch, const uint8_t* __restrict__ flags,
    const int64_t* __restrict__ tile_off, int32_t* __restrict__ out_row,
    int32_t* __restrict__ out_col, u64* __restrict__ out_sk) {
  __shared__ long long warp_sums[32];
  const int r = blockIdx.x, t = blockIdx.y;
  const int nw = lens[r] - w + 1;
  const int t0 = t * kTileW;
  if (t0 >= nw) return;
  const int nt = nw - t0 < kTileW ? nw - t0 : kTileW;
  const size_t base = static_cast<size_t>(row_base[r]) + t0;
  const int i0 = threadIdx.x * kPer;  // this thread's kPer windows, in order
  uint8_t f[kPer];
  int cnt = 0;
  for (int q = 0; q < kPer; ++q) {
    const int i = i0 + q;
    f[q] = i < nt ? flags[base + i] : 0;
    cnt += f[q];
  }
  long long o = tile_off[r * n_tiles + t] +
                block_inclusive_scan(cnt, warp_sums) - cnt;
  for (int q = 0; q < kPer; ++q) {
    if (!f[q]) continue;
    const int i = i0 + q;
    out_row[o] = r;
    out_col[o] = t0 + i;
    for (int slot = 0; slot < s; ++slot)
      out_sk[o * s + slot] = sk_scratch[static_cast<size_t>(slot) * cap + base + i];
    ++o;
  }
}

}  // namespace

extern "C" int groot_window_sketch(
    const void* codes, const void* lens, const void* row_base, int R, int L,
    int k, int s, int w, int n_tiles, long long cap, void* sk_scratch,
    void* flags, void* tile_cnt, void* tile_off, void* out_row, void* out_col,
    void* out_sk, void* stream) {
  if (R < 1 || n_tiles < 1 || n_tiles > 65535 || cap < 1 || k < 1 ||
      w < k || L < w || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m = w - k + 1;
  const size_t smem = 3 * sizeof(u64) * (kTileW + m) + (kTileW + w) +
                      (kTileW + 1);
  cudaError_t err = cudaFuncSetAttribute(
      window_sketch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(R, n_tiles);
  window_sketch_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(lens),
      static_cast<const int64_t*>(row_base), L, k, s, w, n_tiles, cap,
      static_cast<u64*>(sk_scratch), static_cast<uint8_t*>(flags),
      static_cast<int32_t*>(tile_cnt));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  window_scan_kernel<<<1, 1024, 0, st>>>(
      static_cast<const int32_t*>(tile_cnt), R * n_tiles,
      static_cast<int64_t*>(tile_off));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  window_compact_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int32_t*>(lens), static_cast<const int64_t*>(row_base),
      w, s, n_tiles, cap, static_cast<const u64*>(sk_scratch),
      static_cast<const uint8_t*>(flags),
      static_cast<const int64_t*>(tile_off), static_cast<int32_t*>(out_row),
      static_cast<int32_t*>(out_col), static_cast<u64*>(out_sk));
  return static_cast<int>(cudaGetLastError());
}
