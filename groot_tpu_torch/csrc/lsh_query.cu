// Device LSH containment query: read sketches u64 [B, s] -> the kept window
// ids int32 [B, C] (-1 elsewhere) and the f32 containment of every
// candidate slot [B, C].
//
// Replaces groot_tpu/index/lshe.py::_query_device with _mix_bands_jax (an
// XLA program) and the seed half of parallel/device_index.py::align_step
// (banded and full-equality modes). Per read:
//   1. band signatures: the 32-bit FNV mix of each band's K slots (low
//      word, then high word, per slot), as _mix_bands_np;
//   2. per band, lower/upper-bound binary searches of the signature in the
//      band's sorted row (u32 [L, N]) and at most M window ids gathered from
//      band_idx (-1 for an empty slot): C = L * M slots;
//   3. banded mode: the C ids sorted ascending and every id equal to its
//      left neighbour replaced by -1, in place (so the -1s of empty slots
//      come first and later duplicates stay where they sorted), exactly the
//      reference's jnp.sort + adjacent-duplicate mask;
//   4. per slot, eq = the number of sketch slots equal to the window's
//      (window 0 for an empty slot, as the reference's clipped gather) and
//      contain = j (qs + d) / ((1 + j) qs) with j = eq / s, rounded step by
//      step in the reference's order (no FMA contraction, which could flip
//      contain > t at the boundary against XLA's f32);
//   5. keep: banded, contain > t; full equality (one row of full-sketch
//      signatures, K = s, no dedup), eq == s and kc <= qmax; both only for
//      a non-empty slot of a read with kc > 0 (mesh padding keeps nothing).
//
// Design: one warp per read. The read's sketch sits in shared memory; the
// lanes take one band each for the mix and the two binary searches (about
// log2(N) = 19 dependent loads at 408,788 windows) and write the band's
// slots into the warp's shared buffer, padded to a power of two with
// INT_MAX. The warp bitonic-sorts the buffer (at most 4,096 entries), then
// each lane takes slots for the dedup, the s-slot compare against the
// window's sketch row and the containment. What bounds it on the card: the
// latency of the dependent search loads and of the candidate sketch rows
// (8 s bytes each, C per read); the kernel is small and the card mostly
// idle at the pipeline's batch of 2,048 reads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxS = 64;
constexpr int kMaxC = 4096;

__device__ __forceinline__ int lower_bound(const uint32_t* a, int n,
                                           uint32_t key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const uint32_t* a, int n,
                                           uint32_t key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void lsh_query_kernel(
    const u64* __restrict__ q, const int32_t* __restrict__ kc,
    const u64* __restrict__ sketches, const uint32_t* __restrict__ sigs,
    const int32_t* __restrict__ idx, int B, int s, int N, int L, int K, int M,
    int Cp, int qmax, float d, float t, int full,
    int32_t* __restrict__ win_out, float* __restrict__ contain_out) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  u64* qs_all = reinterpret_cast<u64*>(smem);
  int32_t* buf_all = reinterpret_cast<int32_t*>(qs_all + kWarpsPerBlock * kMaxS);
  u64* qv = qs_all + warp * kMaxS;
  int32_t* buf = buf_all + static_cast<size_t>(warp) * Cp;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const int C = L * M;

  for (int i = lane; i < s; i += 32) qv[i] = q[static_cast<size_t>(b) * s + i];
  for (int i = C + lane; i < Cp; i += 32) buf[i] = 0x7fffffff;
  __syncwarp();

  // 1-2: band signatures, searches, gathered ids
  for (int band = lane; band < L; band += 32) {
    uint32_t h = 2166136261u;
    for (int j = 0; j < K; ++j) {
      const u64 v = qv[band * K + j];
      h = (h ^ static_cast<uint32_t>(v)) * 16777619u;
      h = (h ^ static_cast<uint32_t>(v >> 32)) * 16777619u;
    }
    const uint32_t* row = sigs + static_cast<size_t>(band) * N;
    const int lo = lower_bound(row, N, h);
    const int hi = upper_bound(row, N, h);
    const int32_t* irow = idx + static_cast<size_t>(band) * N;
    for (int m = 0; m < M; ++m)
      buf[band * M + m] = lo + m < hi ? irow[lo + m] : -1;
  }
  __syncwarp();

  // 3: bitonic sort of the Cp entries, ascending (banded mode only)
  if (!full) {
    for (int size = 2; size <= Cp; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = lane; i < Cp / 2; i += 32) {
          const int a = ((i & ~(stride - 1)) << 1) | (i & (stride - 1));
          const int c = a + stride;
          const bool asc = (a & size) == 0;
          const int32_t x = buf[a], y = buf[c];
          if ((x > y) == asc) {
            buf[a] = y;
            buf[c] = x;
          }
        }
        __syncwarp();
      }
    }
  }

  // 4-5: dedup, containment, keep
  const int kcb = kc[b];
  const float qsf = __int2float_rn(kcb);
  const float sf = __int2float_rn(s);
  for (int i = lane; i < C; i += 32) {
    int32_t cand = buf[i];
    if (!full && i > 0 && buf[i - 1] == cand) cand = -1;
    const u64* wrow = sketches + static_cast<size_t>(cand < 0 ? 0 : cand) * s;
    int eq = 0;
    for (int j = 0; j < s; ++j) eq += wrow[j] == qv[j];
    const float jf = __fdiv_rn(__int2float_rn(eq), sf);
    const float num = __fmul_rn(jf, __fadd_rn(qsf, d));
    const float den = __fmul_rn(__fadd_rn(1.0f, jf), qsf);
    const float contain = __fdiv_rn(num, den);
    bool keep = full ? (eq == s && kcb <= qmax) : (contain > t);
    keep = keep && cand >= 0 && kcb > 0;
    const size_t o = static_cast<size_t>(b) * C + i;
    win_out[o] = keep ? cand : -1;
    contain_out[o] = contain;
  }
}

}  // namespace

extern "C" int groot_lsh_query(
    const void* q, const void* kc, const void* sketches, const void* sigs,
    const void* idx, int B, int s, int N, int L, int K, int M, int qmax,
    float d, float t, int full, void* win_out, void* contain_out,
    void* stream) {
  const int C = L * M;
  if (B < 1 || s < 1 || s > kMaxS || N < 1 || L < 1 || K < 1 || L * K > s ||
      M < 1 || C > kMaxC || (full && L != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int Cp = 1;
  while (Cp < C) Cp <<= 1;
  const size_t smem = kWarpsPerBlock * (kMaxS * sizeof(u64) +
                                        static_cast<size_t>(Cp) * sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(
      lsh_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lsh_query_kernel<<<blocks, kWarpsPerBlock * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(q), static_cast<const int32_t*>(kc),
      static_cast<const u64*>(sketches), static_cast<const uint32_t*>(sigs),
      static_cast<const int32_t*>(idx), B, s, N, L, K, M, Cp, qmax, d, t, full,
      static_cast<int32_t*>(win_out), static_cast<float*>(contain_out));
  return static_cast<int>(cudaGetLastError());
}
