// Match volumes of the `host` engine: for every read variant k, path row p
// and offset o < W = Lp - Lr + 1, do the first var_len[k] bases of the
// variant all match the path at o? A path N or pad (code >= 4) matches any
// base; a read N (code 4) matches only a path N or pad. A var_len of 0
// matches at every offset; one below 0 or above Lr never matches. Output:
// u32 [K, P, ceil(W/32)], bit b of word w the match at offset 32w + b, the
// bits at offsets >= W zero.
//
// Replaces groot_tpu/align/aligner.py::_match_bits (an XLA program: one
// bf16 convolution of [P, Lp, 5] path one-hots with [K, Lr, 5] variant
// one-hots, a count compared with var_len, packed 32 offsets a word). That
// count is exact only while every partial sum is an integer that the
// accumulator holds; this kernel never counts: it ANDs bits, exact by
// construction, with no float and no one-hot.
//
// Design: a block takes one path row p and a group of KG variants.
// - Bit planes: over positions 0 .. NWp*32 - 1 of the row, five u32 planes
//   in shared memory, built by ballots (a warp a word, a lane a position,
//   one coalesced byte load a lane): plane c < 4 holds "the base is c or
//   a wildcard", plane 4 "the base is a wildcard". Positions past Lp are
//   0 in every plane. NWp = W32 + ceil(Lr / 32) words: one word wider than
//   the last offset word's reach, so the funnel shift below never reads
//   past the planes.
// - The group's variant codes are staged in shared memory.
// - A thread a (variant, word w): acc starts all ones, and for each base j
//   < var_len it ANDs the plane of that base shifted to offset 32w + j
//   (__funnelshift_r of two neighbouring words), stopping once acc is 0,
//   as most words are after a few bases. The last word is masked to W.
//
// What bounds it: the output words (4 bytes a (variant, row, word)) and
// one AND a (variant, row, word, base) that the early exit leaves; both
// are small, so at the host engine's per-graph calls (tens to thousands of
// variants, a few rows of ~1.5 kb) a launch is set by its latency: the
// plane build (one ballot round a word), one barrier, then the longest
// walk of a block, the word that holds a true match (var_len steps).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPlanes = 5;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads) match_bits_kernel(
    const uint8_t* __restrict__ path, const uint8_t* __restrict__ var,
    const int32_t* __restrict__ var_len, int P, int Lp, int K, int Lr, int W,
    int W32, int NWp, int KG, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  uint32_t* plane = smem;  // [kPlanes][NWp]
  uint8_t* codes = reinterpret_cast<uint8_t*>(smem + kPlanes * NWp);  // [KG][Lr]
  const int p = blockIdx.y;
  const int k0 = blockIdx.x * KG;
  const int nk = min(KG, K - k0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  const uint8_t* row = path + static_cast<size_t>(p) * Lp;
  for (int wi = warp; wi < NWp; wi += n_warps) {  // warp-uniform
    const int x = wi * 32 + lane;
    const bool in = x < Lp;
    const int c = in ? row[x] : 0;
    const uint32_t wild = __ballot_sync(kFull, in && c >= 4);
    const uint32_t b0 = __ballot_sync(kFull, in && c == 0) | wild;
    const uint32_t b1 = __ballot_sync(kFull, in && c == 1) | wild;
    const uint32_t b2 = __ballot_sync(kFull, in && c == 2) | wild;
    const uint32_t b3 = __ballot_sync(kFull, in && c == 3) | wild;
    if (lane < kPlanes)
      plane[lane * NWp + wi] =
          lane == 0 ? b0 : lane == 1 ? b1 : lane == 2 ? b2 : lane == 3 ? b3 : wild;
  }
  const uint8_t* vsrc = var + static_cast<size_t>(k0) * Lr;
  for (int i = threadIdx.x; i < nk * Lr; i += blockDim.x) {
    const int c = vsrc[i];
    codes[i] = static_cast<uint8_t>(c < 4 ? c : 4);
  }
  __syncthreads();

  const uint32_t last_mask = (W & 31) ? (1u << (W & 31)) - 1u : kFull;
  for (int it = threadIdx.x; it < nk * W32; it += blockDim.x) {
    const int kl = it / W32;
    const int w = it - kl * W32;
    const int k = k0 + kl;
    const int len = var_len[k];
    uint32_t acc = (len < 0 || len > Lr) ? 0u : kFull;
    const uint8_t* v = codes + kl * Lr;
    for (int j = 0; j < len && acc; ++j) {
      const uint32_t* pl = plane + v[j] * NWp + w + (j >> 5);
      acc &= __funnelshift_r(pl[0], pl[1], j & 31);
    }
    if (w == W32 - 1) acc &= last_mask;
    out[(static_cast<size_t>(k) * P + p) * W32 + w] = acc;
  }
}

}  // namespace

// path u8 [P, Lp] (>= 4: wildcard), var u8 [K, Lr] (>= 4: N), var_len i32
// [K] -> out u32 [K, P, W32], W = Lp - Lr + 1 >= 1. Returns
// cudaGetLastError() after the launch (or the error of the shared-memory
// setup).
extern "C" int groot_match_bits(const void* path, const void* var,
                                const void* var_len, int P, int Lp, int K,
                                int Lr, void* out, void* stream) {
  const int W = Lp - Lr + 1;
  if (P < 0 || K < 0 || Lr < 0 || W < 1 || P > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0 || K == 0) return 0;
  const int W32 = (W + 31) / 32;
  const int NWp = W32 + (Lr + 31) / 32;
  int KG = W32 >= kThreads ? 1 : kThreads / W32;
  if (KG > K) KG = K;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the planes and one variant's codes must fit; fewer variants a block
  // where KG of them do not
  const long long planes = 4LL * kPlanes * NWp;
  if (planes + Lr > optin) return static_cast<int>(cudaErrorInvalidValue);
  if (Lr > 0 && planes + 1LL * KG * Lr > optin)
    KG = static_cast<int>((optin - planes) / Lr);
  const size_t smem = static_cast<size_t>(planes + 1LL * KG * Lr);
  err = cudaFuncSetAttribute(match_bits_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((K + KG - 1) / KG, P);
  match_bits_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(path), static_cast<const uint8_t*>(var),
      static_cast<const int32_t*>(var_len), P, Lp, K, Lr, W, W32, NWp, KG,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
