// Phase A of the device exact-alignment cascade: stages 1, 3 and 4 for
// every flat (mapping, path) row.
//
// Replaces groot_tpu/align/device_join.py::seed_scan (an XLA program) with
// its helpers _row_gather and _short_over. Per row and orientation
// (forward, reverse complement):
//   stage 1: the least offset j < D1 (j <= sb, the path has room for the
//     read) whose anchor chain matches: path window hashes at p+o+j equal
//     the read's anchors at o for the static ladder o = 0, k, 2k, ... below
//     lb-k, plus the tail anchor (read[lb-k:lb]) at p+lb-k+j; or, for a
//     terminal-free path, an overhang a < lb matched by one path-tail hash
//     (pe2) against the read's prefix hash. Capped at 255 (= none).
//   stages 3/4: the one-base clip variants (clip-start reads read[1:lb],
//     clip-end read[0:lb-1]) at offset 0 only.
// Output: packed int32 j1f | j1r << 8 | flags << 16 with flags bits
// (s3f, s4f, s3r, s4r).
//
// The TPU version gathers rows of an unfolded table T1[p, w] = ah[p + w]
// (row gathers are the TPU's only fast arbitrary load). Here the folded
// window-hash table ah32 is read directly: T1[p, w] == ah[p + w], with the
// row p clipped to [0, F-1] and reads past the end of ah giving 0, which is
// exactly what the reference's clipped gather over its zero-padded unfold
// returns for rows near the end of the last path.
//
// Design: one warp per row. Stage 1 spreads j over the lanes (each lane
// stops at its first hit, a warp min picks the least); the overhang spreads
// the tail length a < KA over the lanes; the clip chains are a few scalar
// compares every lane repeats. What bounds it: dependent 4-byte gathers
// from the path table (ah32, tens of MB at the database's scale, mostly in
// L2) — about D1 * (ladder + 1) loads per row and orientation in the worst
// case, far fewer when chains fail at the first anchor.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KA = 192;  // overhang tail lanes (device_join.KA = MAXL)
constexpr int INF = 1 << 30;
constexpr int NONE8 = 255;
constexpr int kWarpsPerBlock = 8;

struct Rows {
  const int32_t* read;
  const int32_t* prow;
  const int32_t* base;
  const int32_t* sb;
  const int32_t* lb;
};

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) {
    const int w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  return v;
}

__device__ __forceinline__ uint32_t ah_at(const uint32_t* ah, long long F,
                                          long long q) {
  return q < F ? ah[q] : 0u;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// _short_over: least j = plen - base - a over overhangs a in [1, lbv-1] with
// j in [0, bound] whose path-tail hash pe[a] equals the read's prefix hash
// (PH[cs+a] - PH[cs]) * (cs == 1 ? rinv1 : 1); INF if none or the path end
// is not terminal-free. Every lane of the warp must call it.
__device__ int short_over(const uint32_t* pe, const uint32_t* ph, int cs,
                          int lbv, int plen, int base, int bound, bool tf,
                          uint32_t rinv1, int lane) {
  int best = INF;
  if (tf) {
    const uint32_t p0 = ph[cs];
    const uint32_t scale = cs == 1 ? rinv1 : 1u;
    for (int a = lane; a < KA; a += 32) {
      if (a < 1 || a > lbv - 1) continue;
      const int j = plen - base - a;
      if (j < 0 || j > bound) continue;
      if (pe[a] == (ph[cs + a] - p0) * scale) best = j < best ? j : best;
    }
  }
  return warp_min(best);
}

__global__ void seed_scan_kernel(
    const uint32_t* __restrict__ ah, long long F,
    const uint32_t* __restrict__ pe2, const int32_t* __restrict__ path_len,
    const int32_t* __restrict__ ph_start, const uint8_t* __restrict__ tfree,
    uint32_t rinv1, const uint32_t* __restrict__ PHf,
    const uint32_t* __restrict__ PHr, int WPH,
    const uint32_t* __restrict__ AHf, const uint32_t* __restrict__ AHr,
    int Lh, Rows rows, int Nr, int D1, int k, int n_offs,
    int32_t* __restrict__ out) {
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= Nr) return;  // uniform per warp

  const int rd = rows.read[r];
  const int prow = rows.prow[r];
  const int rb = rows.base[r];
  const int sb = rows.sb[r];
  const int lb = rows.lb[r];
  const int plen = path_len[prow];
  const bool tf = tfree[prow] != 0;
  const long long s0 = ph_start[prow];
  const long long base = rb > 0 ? rb : 0;
  long long p1 = s0 + base;                   // T1 row of the seed position
  long long p2 = s0 + base + (lb - 1 - k);    // T1 row of the tail anchors
  p1 = p1 < 0 ? 0 : (p1 > F - 1 ? F - 1 : p1);
  p2 = p2 < 0 ? 0 : (p2 > F - 1 ? F - 1 : p2);
  const uint32_t* pe = pe2 + static_cast<size_t>(prow) * KA;

  int packed = 0;
  for (int ori = 0; ori < 2; ++ori) {
    const uint32_t* ph = (ori ? PHr : PHf) + static_cast<size_t>(rd) * WPH;
    const uint32_t* ahr = (ori ? AHr : AHf) + static_cast<size_t>(rd) * Lh;
    const uint32_t a_full = ahr[clampi(lb - k, 0, Lh - 1)];
    const uint32_t a_clip0 = ahr[clampi(lb - 1 - k, 0, Lh - 1)];

    // stage 1, full variant: least j over the lanes
    int j1 = INF;
    for (int j = lane; j < D1; j += 32) {
      if (plen - (rb + j) < lb || j > sb) continue;
      bool g = true;
      for (int i = 0; i < n_offs && g; ++i) {
        const int o = i * k;
        if (o < lb - k) g = ah_at(ah, F, p1 + o + j) == ahr[o];
      }
      if (g && ah_at(ah, F, p2 + 1 + j) == a_full) {
        j1 = j;
        break;
      }
    }
    j1 = warp_min(j1);
    const int js = short_over(pe, ph, 0, lb, plen, rb, sb, tf, rinv1, lane);
    j1 = js < j1 ? js : j1;

    // stages 3 (clip start, cs = 1) and 4 (clip end, cs = 0), offset 0
    int flags = 0;
    for (int v = 0; v < 2; ++v) {
      const int cs = v == 0 ? 1 : 0;
      const uint32_t a_tail = v == 0 ? a_full : a_clip0;
      const int lbv = lb - 1;
      bool g = plen - rb >= lbv;
      for (int i = 0; i < n_offs && g; ++i) {
        const int o = i * k;
        if (o < lbv - k) g = ah_at(ah, F, p1 + o) == ahr[cs + o];
      }
      g = g && ah_at(ah, F, p2) == a_tail;
      const int jc = short_over(pe, ph, cs, lbv, plen, rb, 0, tf, rinv1, lane);
      if (g || jc == 0) flags |= 1 << v;
    }
    const int j1c = j1 < NONE8 ? j1 : NONE8;
    packed |= (j1c << (8 * ori)) | (flags << (16 + 2 * ori));
  }
  if (lane == 0) out[r] = packed;
}

}  // namespace

extern "C" int groot_seed_scan(
    const void* ah32, long long F, const void* pe2, const void* path_len,
    const void* ph_start, const void* tfree, uint32_t rinv1, const void* PHf,
    const void* PHr, int WPH, const void* AHf, const void* AHr, int Lh,
    const void* row_read, const void* row_prow, const void* row_base,
    const void* row_sb, const void* row_lb, int Nr, int D1, int k, int n_offs,
    void* out, void* stream) {
  if (Nr == 0) return 0;
  if (F < 1 || D1 < 1 || D1 > NONE8 - 1 || WPH < KA + 2 || Lh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Rows rows{static_cast<const int32_t*>(row_read),
            static_cast<const int32_t*>(row_prow),
            static_cast<const int32_t*>(row_base),
            static_cast<const int32_t*>(row_sb),
            static_cast<const int32_t*>(row_lb)};
  const int blocks = (Nr + kWarpsPerBlock - 1) / kWarpsPerBlock;
  seed_scan_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ah32), F,
      static_cast<const uint32_t*>(pe2),
      static_cast<const int32_t*>(path_len),
      static_cast<const int32_t*>(ph_start),
      static_cast<const uint8_t*>(tfree), rinv1,
      static_cast<const uint32_t*>(PHf), static_cast<const uint32_t*>(PHr),
      WPH, static_cast<const uint32_t*>(AHf),
      static_cast<const uint32_t*>(AHr), Lh, rows, Nr, D1, k, n_offs,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
