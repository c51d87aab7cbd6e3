// ntHash v1 device helpers shared by the sketch kernels (khf_sketch.cu,
// window_sketch.cu): the base seeds, the rotate, the multihash constants,
// the canonical k-mer hash (the canonical_hashes_np formula of
// ops/nthash.py, computed directly in O(k); window_sketch.cu) and, at the
// end, the pieces of the prefix-XOR form (khf_sketch.cu):
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

// ntHash v1 seeds for A, C, G, T (N is 0) and for their complements
constexpr u64 kSeedA = 0x3C8BFBB395C60474ULL;
constexpr u64 kSeedC = 0x3193C18562A02B4CULL;
constexpr u64 kSeedG = 0x20323ED082572324ULL;
constexpr u64 kSeedT = 0x295549F54BE24456ULL;
__constant__ u64 kSeed[5] = {kSeedA, kSeedC, kSeedG, kSeedT, 0ULL};
__constant__ u64 kSeedRc[5] = {kSeedT, kSeedG, kSeedC, kSeedA, 0ULL};

__device__ __forceinline__ u64 rol(u64 x, int r) {
  r &= 63;
  return r ? (x << r) | (x >> (64 - r)) : x;
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

// ---- helpers of the prefix-XOR sketch (khf_sketch.cu) ----------------------
// With X the exclusive prefix-XOR of gf(m) = ror(seed[c_m], m mod 64) and Y
// that of gr(m) = rol(seed_rc[c_m], m mod 64), the k-mer at i has
//   f(i) = rol(X[i+k] ^ X[i], (i+k-1) mod 64),  r(i) = ror(Y[i+k] ^ Y[i], i mod 64)
// (canonical_hashes_prefix_np in ops/nthash.py walks the same identity).

// Branch-free 64-bit rotates by any amount (taken mod 64).
__device__ __forceinline__ u64 rotl64(u64 x, int r) {
  return (x << (r & 63)) | (x >> ((64 - r) & 63));
}
__device__ __forceinline__ u64 rotr64(u64 x, int r) {
  return (x >> (r & 63)) | (x << ((64 - r) & 63));
}

__device__ __forceinline__ u64 umin64(u64 a, u64 b) { return a < b ? a : b; }

// The seed of a code and of its complement, picked by selects so that lanes
// holding different codes never index constant memory apart (codes above 3
// are N, seed 0).
__device__ __forceinline__ u64 seed_of(unsigned c) {
  return c == 0 ? kSeedA : c == 1 ? kSeedC : c == 2 ? kSeedG : c == 3 ? kSeedT : 0;
}
__device__ __forceinline__ u64 seed_rc_of(unsigned c) {
  return seed_of(c < 4 ? 3 - c : c);
}

}  // namespace
