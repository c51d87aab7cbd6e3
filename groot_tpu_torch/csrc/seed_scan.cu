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
// What bounds it: the chain of dependent 4-byte gathers from the path
// table (ah32, tens of MB at the database's scale, mostly in L2) and the
// read tables, not their bytes. A row needs three dependent load levels
// (the row, then its path row and read, then the path words), each a full
// round trip to memory with the whole batch in flight, and a lane walking
// its offsets adds a level per further pass of 32. Design: a warp a
// row, both orientations at once, and no load waits on a compare:
// - stage 1 spreads the offsets j the row admits (j <= sb, j < D1, the
//   path has room for the read: ~13 a row on the main path, so one pass)
//   over the lanes; a lane loads every ladder word of its j into registers
//   before any compare and tests both orientations' anchors (staged once a
//   row in shared memory) against the same words; no lane stops at its
//   first hit;
// - the overhangs of all three short_over uses and both orientations are
//   one pass over the only lengths that can hit (j = plen - base - a must
//   lie in [0, sb], so a near a path end only; none elsewhere), pe[a] and
//   each prefix hash loaded once a lane;
// - the stage 3 and 4 chains are split over the lanes, lane i testing
//   ladder anchor i of all four (orientation, clip) chains, combined by
//   votes; minima by __reduce_min_sync.
// The first pass of every phase is loaded before any compare.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KA = 192;  // overhang tail lanes (device_join.KA = MAXL)
constexpr int INF = 1 << 30;
constexpr int NONE8 = 255;
constexpr int kWarps = 4;     // rows a block
constexpr int kMaxOffs = 8;   // ladder words a lane holds; anchors staged
constexpr unsigned kFull = 0xffffffffu;

struct Rows {
  const int32_t* read;
  const int32_t* prow;
  const int32_t* base;
  const int32_t* sb;
  const int32_t* lb;
};

__device__ __forceinline__ uint32_t ah_at(const uint32_t* ah, long long F,
                                          long long q) {
  return q < F ? ah[q] : 0u;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Ladder anchors a chain of length `len` requires: i < n_offs with i * k <
// len - k.
__device__ __forceinline__ int ladder(int len, int k, int n_offs) {
  return len - k > 0 ? min(n_offs, (len - k - 1) / k + 1) : 0;
}

// Stage 1 at one offset j, read from device memory: the first kMaxOffs
// ladder words of the path and the tail word, loaded together; `eval`
// compares them with both orientations' anchors (the row's copy in shared
// memory, `anc`: forward then reverse) and loads any further ladder words.
struct Stage1 {
  uint32_t w[kMaxOffs], tail;

  __device__ __forceinline__ void eval(const uint32_t* ah, long long F,
                                       long long p1, const uint32_t* anc,
                                       const uint32_t* ahf,
                                       const uint32_t* ahr, int k, int n_req,
                                       int j, bool& gf, bool& gr) const {
    gf = gr = true;
#pragma unroll
    for (int u = 0; u < kMaxOffs; ++u) {
      gf &= w[u] == anc[u];
      gr &= w[u] == anc[kMaxOffs + u];
    }
    for (int i = kMaxOffs; i < n_req; ++i) {
      const uint32_t x = ah_at(ah, F, p1 + i * k + j);
      gf &= x == ahf[i * k];
      gr &= x == ahr[i * k];
    }
  }
};

__device__ __forceinline__ Stage1 stage1_load(const uint32_t* ah, long long F,
                                              long long p1, long long p2, int k,
                                              int n_req, int j, bool on) {
  Stage1 s;
#pragma unroll
  for (int u = 0; u < kMaxOffs; ++u)
    s.w[u] = on && u < n_req ? ah_at(ah, F, p1 + u * k + j) : 0u;
  s.tail = on ? ah_at(ah, F, p2 + 1 + j) : 0u;
  return s;
}

// One overhang length a: the path-tail hash and the prefix hashes of both
// orientations it is held to.
struct Overhang {
  uint32_t pe, fa, fa1, ra, ra1;
};

__device__ __forceinline__ Overhang overhang_load(const uint32_t* pe,
                                                  const uint32_t* phf,
                                                  const uint32_t* phr, int a,
                                                  bool on) {
  Overhang o{0u, 0u, 0u, 0u, 0u};
  if (on) o = {pe[a], phf[a], phf[a + 1], phr[a], phr[a + 1]};
  return o;
}

// Ladder anchor i of the clip chains: the path word at offset i * k and
// the four anchors (orientation x clip start / end) it must equal.
struct ClipAnchor {
  uint32_t w, f0, f1, r0, r1;
};

__device__ __forceinline__ ClipAnchor clip_load(const uint32_t* ah, long long F,
                                                long long p1,
                                                const uint32_t* ahf,
                                                const uint32_t* ahr, int k,
                                                int i, bool on) {
  ClipAnchor c{0u, 0u, 0u, 0u, 0u};
  if (on) {
    const int o = i * k;
    c = {ah_at(ah, F, p1 + o), ahf[o], ahf[1 + o], ahr[o], ahr[1 + o]};
  }
  return c;
}

__global__ void __launch_bounds__(32 * kWarps, 8) seed_scan_kernel(
    const uint32_t* __restrict__ ah, long long F,
    const uint32_t* __restrict__ pe2, const int32_t* __restrict__ path_len,
    const int32_t* __restrict__ ph_start, const uint8_t* __restrict__ tfree,
    uint32_t rinv1, const uint32_t* __restrict__ PHf,
    const uint32_t* __restrict__ PHr, int WPH,
    const uint32_t* __restrict__ AHf, const uint32_t* __restrict__ AHr,
    int Lh, Rows rows, int Nr, int D1, int k, int n_offs,
    int32_t* __restrict__ out) {
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
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
  const uint32_t* ahf = AHf + static_cast<size_t>(rd) * Lh;
  const uint32_t* ahr = AHr + static_cast<size_t>(rd) * Lh;
  const uint32_t full_f = ahf[clampi(lb - k, 0, Lh - 1)];
  const uint32_t full_r = ahr[clampi(lb - k, 0, Lh - 1)];
  const uint32_t clip0_f = ahf[clampi(lb - 1 - k, 0, Lh - 1)];
  const uint32_t clip0_r = ahr[clampi(lb - 1 - k, 0, Lh - 1)];

  // The three phases, each a loop over the lanes' candidates: stage 1 over
  // the admitted offsets j = 0..jmax; the overhangs a in [1, lbv - 1]
  // (a < KA) at j = plen - rb - a, j <= sb for the full variant and j = 0
  // for the clips (lbv = lb - 1); the clip chains' ladder anchors.
  const int n_req = ladder(lb, k, n_offs);
  const int n_clip = ladder(lb - 1, k, n_offs);
  const int jmax = min(min(sb, D1 - 1), plen - rb - lb);
  const int a_hi = tf ? min(min(lb - 1, KA - 1), plen - rb) : 0;
  const int a_lo = max(1, plen - rb - max(sb, 0));
  const uint32_t* pe = pe2 + static_cast<size_t>(prow) * KA;
  const uint32_t* phf = PHf + static_cast<size_t>(rd) * WPH;
  const uint32_t* phr = PHr + static_cast<size_t>(rd) * WPH;

  // The row's ladder anchors, both orientations (0 past the ladder, as
  // the path words of Stage1).
  __shared__ uint32_t anchors[kWarps][2 * kMaxOffs];
  uint32_t* anc = anchors[threadIdx.x >> 5];
  if (lane < 2 * kMaxOffs) {
    const int u = lane % kMaxOffs;
    anc[lane] = u < n_req ? (lane < kMaxOffs ? ahf : ahr)[u * k] : 0u;
  }
  // the first pass of every phase, loaded before any compare
  Stage1 s1 = stage1_load(ah, F, p1, p2, k, n_req, lane, lane <= jmax);
  Overhang ov = overhang_load(pe, phf, phr, a_lo + lane, a_lo + lane <= a_hi);
  ClipAnchor ca = clip_load(ah, F, p1, ahf, ahr, k, lane, lane < n_clip);
  const uint32_t t0 = ah_at(ah, F, p2);
  const uint32_t f0 = phf[0], f1 = phf[1], r0 = phr[0], r1 = phr[1];
  __syncwarp();

  int j1f = INF, j1r = INF;
  bool o3f = false, o4f = false, o3r = false, o4r = false;
  bool b3f = false, b4f = false, b3r = false, b4r = false;
  for (int j = lane;;) {
    if (j <= jmax) {
      bool gf, gr;
      s1.eval(ah, F, p1, anc, ahf, ahr, k, n_req, j, gf, gr);
      if (gf && s1.tail == full_f && j < j1f) j1f = j;
      if (gr && s1.tail == full_r && j < j1r) j1r = j;
    }
    j += 32;
    if (j > jmax) break;
    s1 = stage1_load(ah, F, p1, p2, k, n_req, j, true);
  }
  for (int a = a_lo + lane;;) {
    if (a <= a_hi) {
      const int j = plen - rb - a;
      if (j <= sb) {
        if (ov.pe == ov.fa - f0 && j < j1f) j1f = j;
        if (ov.pe == ov.ra - r0 && j < j1r) j1r = j;
      }
      if (j == 0 && a <= lb - 2) {
        o3f = ov.pe == (ov.fa1 - f1) * rinv1;  // clip start: read[1:lb]
        o4f = ov.pe == ov.fa - f0;             // clip end: read[0:lb-1]
        o3r = ov.pe == (ov.ra1 - r1) * rinv1;
        o4r = ov.pe == ov.ra - r0;
      }
    }
    a += 32;
    if (a > a_hi) break;
    ov = overhang_load(pe, phf, phr, a, true);
  }
  for (int i = lane;;) {
    if (i < n_clip) {
      b3f |= ca.w != ca.f1;
      b4f |= ca.w != ca.f0;
      b3r |= ca.w != ca.r1;
      b4r |= ca.w != ca.r0;
    }
    i += 32;
    if (i >= n_clip) break;
    ca = clip_load(ah, F, p1, ahf, ahr, k, i, true);
  }
  j1f = __reduce_min_sync(kFull, j1f);
  j1r = __reduce_min_sync(kFull, j1r);

  // stages 3 (clip start) and 4 (clip end) at offset 0
  const bool room = plen - rb >= lb - 1;
  const bool s3f = (room && !__any_sync(kFull, b3f) && t0 == full_f) ||
                   __any_sync(kFull, o3f);
  const bool s4f = (room && !__any_sync(kFull, b4f) && t0 == clip0_f) ||
                   __any_sync(kFull, o4f);
  const bool s3r = (room && !__any_sync(kFull, b3r) && t0 == full_r) ||
                   __any_sync(kFull, o3r);
  const bool s4r = (room && !__any_sync(kFull, b4r) && t0 == clip0_r) ||
                   __any_sync(kFull, o4r);
  if (lane == 0) {
    const int flags = s3f | s4f << 1 | s3r << 2 | s4r << 3;
    out[r] = min(j1f, NONE8) | min(j1r, NONE8) << 8 | flags << 16;
  }
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
  const int blocks = (Nr + kWarps - 1) / kWarps;
  seed_scan_kernel<<<blocks, 32 * kWarps, 0,
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
