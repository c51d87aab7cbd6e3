// ntHash v1 device helpers shared by the sketch kernels (khf_sketch.cu,
// window_sketch.cu): the base seeds, the rotate, the multihash constants, a
// warp-wide u64 minimum and the canonical k-mer hash (the
// canonical_hashes_np formula of ops/nthash.py, computed directly in O(k)):
//   f(i) = XOR_j rol(seed[c[i+j]], k-1-j),  r(i) = XOR_j rol(seed_rc[c[i+j]], j)
//   canonical(i) = min(f(i), r(i))
//   slot m > 0:   h = c * (m ^ k*MULTISEED);  h ^= h >> MULTISHIFT
// Every definition has internal linkage, so each kernel file that includes
// this header gets its own copy of the constant tables.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr u64 kMultiSeed = 0x90B45D39FB6DA1FAULL;
constexpr int kMultiShift = 27;

// ntHash v1 seeds for A, C, G, T, N and for their complements
__constant__ u64 kSeed[5] = {
    0x3C8BFBB395C60474ULL, 0x3193C18562A02B4CULL, 0x20323ED082572324ULL,
    0x295549F54BE24456ULL, 0x0ULL};
__constant__ u64 kSeedRc[5] = {
    0x295549F54BE24456ULL, 0x20323ED082572324ULL, 0x3193C18562A02B4CULL,
    0x3C8BFBB395C60474ULL, 0x0ULL};

__device__ __forceinline__ u64 rol(u64 x, int r) {
  r &= 63;
  return r ? (x << r) | (x >> (64 - r)) : x;
}

__device__ __forceinline__ u64 warp_min(u64 v) {
  for (int o = 16; o > 0; o >>= 1) {
    u64 w = __shfl_down_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  return v;
}

// Canonical hash of the k-mer starting at row[0]; row holds codes in 0..4.
__device__ __forceinline__ u64 canonical_kmer_hash(const uint8_t* row, int k) {
  u64 f = 0, r = 0;
  for (int j = 0; j < k; ++j) {
    const uint8_t c = row[j];
    f ^= rol(kSeed[c], k - 1 - j);
    r ^= rol(kSeedRc[c], j);
  }
  return f < r ? f : r;
}

// Slot m of the multihash of a canonical hash c (slot 0 is c itself).
__device__ __forceinline__ u64 slot_hash(u64 c, int m, u64 kseed) {
  if (m == 0) return c;
  u64 h = c * (static_cast<u64>(m) ^ kseed);
  return h ^ (h >> kMultiShift);
}

}  // namespace
