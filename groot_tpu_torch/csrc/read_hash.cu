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
// first base's complement (they are masked by every consumer).
//
// Design: one thread per read running the sequential prefix loop; the
// anchors read back the prefix row the same thread just wrote. What bounds
// it: the per-thread loop is latency-bound and the row writes are strided
// (uncoalesced), but the whole batch is ~3*L*4 bytes per mapped read, tiny
// beside the seed scan that consumes it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void read_hash_kernel(const uint8_t* __restrict__ codes,
                                 const int32_t* __restrict__ lengths,
                                 const uint32_t* __restrict__ rpow,
                                 const uint32_t* __restrict__ rinv,
                                 uint32_t* __restrict__ PHf,
                                 uint32_t* __restrict__ PHr,
                                 uint32_t* __restrict__ AHf,
                                 uint32_t* __restrict__ AHr, int B, int L,
                                 int k, int WPH) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* row = codes + static_cast<size_t>(b) * L;
  uint32_t* pf = PHf + static_cast<size_t>(b) * WPH;
  uint32_t* pr = PHr + static_cast<size_t>(b) * WPH;
  const int len = lengths[b];
  uint32_t af = 0, ar = 0;
  pf[0] = 0;
  pr[0] = 0;
  for (int i = 0; i < L; ++i) {
    uint32_t c = row[i];
    c = c > 4 ? 4 : c;
    af += (c + 1u) * rpow[i];
    pf[i + 1] = af;
    int ri = len - 1 - i;
    ri = ri < 0 ? 0 : (ri > L - 1 ? L - 1 : ri);
    uint32_t rc = row[ri];
    rc = rc >= 4 ? 4u : 3u - rc;
    ar += (rc + 1u) * rpow[i];
    pr[i + 1] = ar;
  }
  for (int i = L + 1; i < WPH; ++i) {
    pf[i] = 0;
    pr[i] = 0;
  }
  const int na = L + 1 - k;
  uint32_t* hf = AHf + static_cast<size_t>(b) * na;
  uint32_t* hr = AHr + static_cast<size_t>(b) * na;
  for (int i = 0; i < na; ++i) {
    hf[i] = (pf[i + k] - pf[i]) * rinv[i];
    hr[i] = (pr[i + k] - pr[i]) * rinv[i];
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
  const int blocks = (B + kThreads - 1) / kThreads;
  read_hash_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(lengths),
      static_cast<const uint32_t*>(rpow), static_cast<const uint32_t*>(rinv),
      static_cast<uint32_t*>(PHf), static_cast<uint32_t*>(PHr),
      static_cast<uint32_t*>(AHf), static_cast<uint32_t*>(AHr), B, L, k, WPH);
  return static_cast<int>(cudaGetLastError());
}
