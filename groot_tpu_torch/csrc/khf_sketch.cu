// KHF MinHash sketch of a read batch: u8 codes [B, L] -> u64 [B, s].
//
// Replaces groot_tpu/ops/pallas_sketch.py::khf_sketch_pallas (the Pallas
// kernel; its body is _kernel). It computes what that kernel computes, not
// its TPU block structure: the TPU version works on (hi, lo) uint32 pairs,
// a Hillis-Steele prefix-XOR over lanes and staged rotates, because the TPU
// has no 64-bit integers. Here every value is a native u64.
//
// Design: one block per read, walking the read's k-mers in tiles of kTile.
// For each tile the block stages the tile's codes (kTile + k - 1 bytes) in
// shared memory; thread t computes the canonical ntHash of k-mers t, t+T, ...
// directly in O(k) (canonical_kmer_hash, nthash.cuh) and keeps it in shared
// memory. Then, per slot m, each thread takes
// the min of h_m = m == 0 ? c : xorshift27(c * (m ^ k*MULTISEED)) over its
// k-mers of the tile, a warp shuffle reduces it, and lane 0 of each warp
// atomicMin's into the block's running slot minimum in shared memory. The
// shared footprint is fixed (about 10 KiB), so any read length L launches;
// k is bounded by kMaxK. k-mers starting at or past valid_len-k+1 are left
// out, which equals masking them to all-ones; a read with no valid k-mer
// sketches to all-ones in every slot.
//
// What bounds it on the card: integer issue, not memory. A 150 bp read is
// 150 bytes in and s*8 bytes out, against ~k*(L-k+1) 64-bit rotate-XORs plus
// (L-k+1)*s multiply-xorshifts. The O(k) hash keeps the code simple and
// independent of the reference's scan; a rolling hash would cut the first
// term by k in a later PR.
#include <cuda_runtime.h>
#include <stdint.h>

#include "nthash.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSlots = 64;
constexpr int kTile = 1024;  // k-mers per shared-memory tile
constexpr int kMaxK = 1024;

__global__ void khf_sketch_kernel(const uint8_t* __restrict__ codes,
                                  const int32_t* __restrict__ valid_len,
                                  u64* __restrict__ out, int L, int k,
                                  int s) {
  __shared__ u64 hashes[kTile];
  __shared__ uint8_t row[kTile + kMaxK - 1];
  __shared__ u64 slot_min[kMaxSlots];
  const int b = blockIdx.x;
  const int nk_all = L - k + 1 > 0 ? L - k + 1 : 0;  // k-mers of the row
  int nk = valid_len[b] - k + 1;                      // ... that are valid
  if (nk > nk_all) nk = nk_all;
  if (nk < 0) nk = 0;
  const uint8_t* src = codes + static_cast<size_t>(b) * L;
  const u64 kseed = static_cast<u64>(k) * kMultiSeed;

  for (int m = threadIdx.x; m < s; m += blockDim.x) slot_min[m] = ~0ULL;
  for (int t0 = 0; t0 < nk; t0 += kTile) {
    const int n = nk - t0 < kTile ? nk - t0 : kTile;  // k-mers in this tile
    const int span = n + k - 1;                      // their bases
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
      const uint8_t c = src[t0 + i];
      row[i] = c > 4 ? 4 : c;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      hashes[i] = canonical_kmer_hash(row + i, k);
    __syncthreads();
    for (int m = 0; m < s; ++m) {
      const u64 mult = static_cast<u64>(m) ^ kseed;
      u64 v = ~0ULL;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        u64 h = hashes[i];
        if (m > 0) {
          h *= mult;
          h ^= h >> kMultiShift;
        }
        v = h < v ? h : v;
      }
      v = warp_min(v);
      if ((threadIdx.x & 31) == 0) atomicMin(&slot_min[m], v);
    }
    __syncthreads();  // the next tile overwrites row and hashes
  }
  __syncthreads();
  for (int m = threadIdx.x; m < s; m += blockDim.x)
    out[static_cast<size_t>(b) * s + m] = slot_min[m];
}

}  // namespace

extern "C" int groot_khf_sketch(const void* codes, const void* valid_len,
                                void* out, int B, int L, int k, int s,
                                void* stream) {
  if (B == 0) return 0;
  if (L < 1 || k < 1 || k > kMaxK || s < 1 || s > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  khf_sketch_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(valid_len), static_cast<u64*>(out), L, k,
      s);
  return static_cast<int>(cudaGetLastError());
}
