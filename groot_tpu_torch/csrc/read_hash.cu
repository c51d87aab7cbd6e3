// Per-read prefix and anchor hashes for the device cascade's phase A.
//
// Replaces groot_tpu/align/device_join.py::DeviceJoinAligner._read_hash_fn
// (its jitted `build`, an XLA program). For each read b of a batch of u8
// codes [B, L] (N = 4) with length len[b], in wrapping uint32 arithmetic
// (the low 32 bits of the host engine's mod-2^64 polynomial hash):
//   PHf[b, i+1] = sum_{m<=i} (c[m] + 1) * rpow[m]            i < L
//   PHr[b, i+1] = sum_{m<=i} (rc(c[clip(len-1-m)]) + 1) * rpow[m]
//   PH[b, 0] = 0, PH[b, L+1 .. WPH-1] = 0
//   AH[b, i] = (PH[b, i+k] - PH[b, i]) * rinv[i]              i < L+1-k
// The reverse-complement index clips to [0, L-1] exactly as the reference's
// take_along_axis does, so positions past the read's length repeat its
// first base's complement (they are masked by every consumer). Codes above
// 4 count as N.
//
// What bounds it: bytes. A read is L bytes in and ~4 (L + 1) * 4 bytes of
// hashes out; the arithmetic is a multiply-add a base and strand. The
// first design ran one thread a read through a 160-step dependent loop and
// stored each row at a stride of WPH words, so it was latency-bound and its
// stores touched a cache line a lane.
//
// Design: one warp a read, kWarps reads a block, no block barrier. The warp
// stages its read's codes in shared memory with coalesced loads, then walks
// the row 32 positions at a time: each lane forms both strands' terms of
// one position, an inclusive warp scan (__shfl_up_sync) makes the prefix,
// and the chunk's total carries into the next. Wrapping u32 addition is
// associative, so the sums equal the sequential ones bit for bit. The PH
// rows are stored coalesced, the pad to WPH zeroed by the same warp, and
// the anchors read the rows back from shared memory. Past kStagedMaxL
// (long FASTA rows) the shared copies would not fit, so the warp reads
// codes and its own PH rows from device memory instead (a __syncwarp
// orders the warp's stores before its loads).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // reads a block
constexpr int kThreads = kWarps * 32;
constexpr int kStagedMaxL = 512;  // 8 staged reads fit in 48 KB of shared
constexpr unsigned kFull = 0xffffffffu;

// shared bytes one warp stages: both PH rows (L + 1 words each) and the codes
__host__ __device__ inline int staged_bytes(int L) {
  return (8 * (L + 1) + L + 15) / 16 * 16;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    read_hash_kernel(const uint8_t* __restrict__ codes,
                     const int32_t* __restrict__ lengths,
                     const uint32_t* __restrict__ rpow,
                     const uint32_t* __restrict__ rinv, uint32_t* PHf,
                     uint32_t* PHr, uint32_t* __restrict__ AHf,
                     uint32_t* __restrict__ AHr, int B, int L, int k, int WPH) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // the whole warp leaves together
  const uint8_t* row = codes + static_cast<size_t>(b) * L;
  uint32_t* pf = PHf + static_cast<size_t>(b) * WPH;
  uint32_t* pr = PHr + static_cast<size_t>(b) * WPH;
  const int len = lengths[b];

  // the row's codes and PH rows as the anchors read them: shared copies,
  // or the device-memory rows themselves
  const uint8_t* cr = row;
  uint32_t* sf = pf;
  uint32_t* sr = pr;
  if (kStaged) {
    unsigned char* base = smem + static_cast<size_t>(warp) * staged_bytes(L);
    sf = reinterpret_cast<uint32_t*>(base);
    sr = sf + (L + 1);
    uint8_t* sc = reinterpret_cast<uint8_t*>(sr + (L + 1));
    if ((L & 3) == 0 && (reinterpret_cast<uintptr_t>(row) & 3) == 0) {
      const uint32_t* row4 = reinterpret_cast<const uint32_t*>(row);
      uint32_t* sc4 = reinterpret_cast<uint32_t*>(sc);
      for (int m = lane; m < (L >> 2); m += 32) sc4[m] = row4[m];
    } else {
      for (int m = lane; m < L; m += 32) sc[m] = row[m];
    }
    __syncwarp();
    cr = sc;
  }

  uint32_t carry_f = 0, carry_r = 0;
  for (int c0 = 0; c0 < L; c0 += 32) {
    const int m = c0 + lane;
    uint32_t vf = 0, vr = 0;
    if (m < L) {
      const uint32_t p = __ldg(rpow + m);
      uint32_t c = cr[m];
      c = c > 4 ? 4u : c;
      int ri = len - 1 - m;
      ri = ri < 0 ? 0 : (ri > L - 1 ? L - 1 : ri);
      uint32_t rc = cr[ri];
      rc = rc >= 4 ? 4u : 3u - rc;
      vf = (c + 1u) * p;
      vr = (rc + 1u) * p;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t tf = __shfl_up_sync(kFull, vf, o);
      const uint32_t tr = __shfl_up_sync(kFull, vr, o);
      if (lane >= o) {
        vf += tf;
        vr += tr;
      }
    }
    vf += carry_f;
    vr += carry_r;
    if (m < L) {
      pf[m + 1] = vf;
      pr[m + 1] = vr;
      if (kStaged) {
        sf[m + 1] = vf;
        sr[m + 1] = vr;
      }
    }
    carry_f = __shfl_sync(kFull, vf, 31);
    carry_r = __shfl_sync(kFull, vr, 31);
  }
  if (lane == 0) {
    pf[0] = 0;
    pr[0] = 0;
    sf[0] = 0;
    sr[0] = 0;
  }
  for (int i = L + 1 + lane; i < WPH; i += 32) {
    pf[i] = 0;
    pr[i] = 0;
  }
  __syncwarp();  // the rows are complete before any lane reads them back

  const int na = L + 1 - k;
  uint32_t* hf = AHf + static_cast<size_t>(b) * na;
  uint32_t* hr = AHr + static_cast<size_t>(b) * na;
  for (int i = lane; i < na; i += 32) {
    const uint32_t inv = __ldg(rinv + i);
    hf[i] = (sf[i + k] - sf[i]) * inv;
    hr[i] = (sr[i + k] - sr[i]) * inv;
  }
}

}  // namespace

extern "C" int groot_read_hash(const void* codes, const void* lengths,
                               const void* rpow, const void* rinv, void* PHf,
                               void* PHr, void* AHf, void* AHr, int B, int L,
                               int k, int WPH, void* stream) {
  if (B == 0) return 0;
  if (L < k || k < 1 || WPH < L + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kWarps - 1) / kWarps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* n = static_cast<const int32_t*>(lengths);
  const auto* p = static_cast<const uint32_t*>(rpow);
  const auto* q = static_cast<const uint32_t*>(rinv);
  auto* pf = static_cast<uint32_t*>(PHf);
  auto* pr = static_cast<uint32_t*>(PHr);
  auto* af = static_cast<uint32_t*>(AHf);
  auto* ar = static_cast<uint32_t*>(AHr);
  if (L <= kStagedMaxL) {
    read_hash_kernel<true><<<blocks, kThreads, kWarps * staged_bytes(L), st>>>(
        c, n, p, q, pf, pr, af, ar, B, L, k, WPH);
  } else {
    read_hash_kernel<false><<<blocks, kThreads, 0, st>>>(
        c, n, p, q, pf, pr, af, ar, B, L, k, WPH);
  }
  return static_cast<int>(cudaGetLastError());
}
