// The match-volume cascade of the `cascade` engine: stages 1-4 of every
// (read, mapping) pair, one packed int32 row per pair:
//   [found, 0, ori, stage, node, off, clip_s, clip_e, ids[Pb]].
//
// Replaces groot_tpu/align/device_cascade.py::_pair_cascade (an XLA
// program). The reference builds, per combo (graph, read), the match counts
// of six read variants at every window position (a banded matmul), the
// gated full-match positions and their reverse suffix minimum (the NXT
// volumes), and then reads those volumes at each pair's probe positions.
// Every lookup into NXT asks one question: is there a gated full match at a
// position in [x, x + bound]? At stage 1 bound <= min(span_lim, seed_len -
// 1 - seed_off), at stage 2 bound <= min(S, c_len - 1); stages 3 and 4 read
// one position of the ungated clip-match bits. So this kernel builds no
// volume (some 125 MB of int32 NXT per call at the database's shapes): it
// answers each question by comparing the read variant with the path row,
// base by base, stopping at the first mismatch.
//
// What bounds it on the card: not bytes (a chunk of ~500 pairs needs well
// under a megabyte) but each pair's longest dependent chain: the positions
// a row may match at, the ~28 stage-2 probes of a pair, and the reverse
// strand, which the reference reports only when the forward one fails, are
// each a chain if walked in turn; and a warp a pair with lanes over path
// rows leaves 16 of 32 lanes idle at Pb = 16 and half the SMs empty.
//
// Design: one block of 256 threads a pair (a chunk of 517 pairs fills the
// card about four blocks an SM); both strands run at once, the read staged
// once in shared memory in both orientations (no reverse-complement
// arithmetic per base) and compared four bases an instruction (__vcmpeq4
// on path words funnel-shifted to the position; Lb and Lr are multiples of
// 4). Every hit also lowers its row's own least
// offset (stage 1) or key (stage 2) in shared memory, so the id bits need
// no second compare (but for a stage-2 winner whose offset lies outside [0,
// S], where the reference's floor mod decides). The answer is the forward
// strand's if it found anything at any stage, else the reverse strand's
// (also when neither found anything): the reference's "forward first",
// kept by selection.
//   stage 1: threads over (strand, live path row, offset) in rounds of
//     offsets from the least one up to bound1; an atomic min gives each
//     strand's least gated full match offset j1 over its rows, and a strand
//     stops at the first round with a hit (the ids are the rows whose least
//     offset is j1). A forward hit ends the pair.
//   stage 2 (forward, and reverse if its stage 1 failed): threads over
//     (strand, probe x live row, shift); one atomic min over the 64-bit key
//     (rank * (S + 1) + offset, probe row) picks the winner, the lowest
//     probe row among equal values (the ids are the rows whose least key is
//     the winner's). A forward hit ends the pair.
//   stages 3/4: the clip-start and clip-end variants at clip(base), threads
//     over (strand, clip, row).
// Edge semantics kept from the reference: clip() clamps a lookup to [0, W -
// 1] while offsets are taken from the unclamped position; positions run up
// to Wp = ceil(W / 128) * 128; a full match is gated (x < plen and x + len
// <= plen unless the row is terminal-free); a path 4 (N or pad) matches read
// codes 0-4, a read base 0-3 only its own path base, a read N only a path
// 4, columns past Lb nothing; clipped variants of read_len - 1 <= 0 bases.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 512;  // (probe, row) cells compacted per stage-2 pass
constexpr int INF = 1 << 30;
constexpr long long BIG = 0x7fffffffffffffffLL;
constexpr int MAX_CLIP = 1;  // alignment.go:16

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Do the n bases rd[0:n] match the path row at x?
__device__ bool matches(const uint8_t* path, int Lb, const uint8_t* rd, int n,
                        int x) {
  if (n < 0) return false;
  if (n > 0 && x + n > Lb) return false;
  for (int j = 0; j < n; ++j) {
    const int pb = path[x + j];
    const int rb = rd[j];
    if (rb > 4 || (pb != 4 && pb != rb)) return false;
  }
  return true;
}

// matches() four bases a step: rd 4-byte aligned, the path row's bytes
// funnel-shifted from its aligned words (the row 4-byte aligned); per byte a
// path 4 or an equal code is a match, a read code past 4 never is.
__device__ bool matches4(const uint8_t* path, int Lb, const uint8_t* rd, int n,
                         int x) {
  if (n < 0) return false;
  if (n > 0 && x + n > Lb) return false;
  const uint32_t* pw = reinterpret_cast<const uint32_t*>(path) + (x >> 2);
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(rd);
  const int shift = (x & 3) * 8;
  const int last = (Lb >> 2) - 1 - (x >> 2);  // the row's last word, from pw
  uint32_t lo = n > 0 ? pw[0] : 0u;
  for (int k = 0; 4 * k < n; ++k) {
    const uint32_t hi = k < last ? pw[k + 1] : 0u;
    const uint32_t pb = __funnelshift_r(lo, hi, shift);
    lo = hi;
    const uint32_t rb = rw[k];
    uint32_t ok = (__vcmpeq4(pb, rb) | __vcmpeq4(pb, 0x04040404u)) &
                  ~__vcmpgtu4(rb, 0x04040404u);
    if (n - 4 * k < 4) ok |= 0xffffffffu << (8 * (n - 4 * k));
    if (ok != 0xffffffffu) return false;
  }
  return true;
}

// The last position a lookup from `start` with `bound` may try: x <= start
// + bound, x < Wp, x < plen and, unless the row is terminal-free, x + len
// <= plen.
__device__ __forceinline__ int last_pos(int start, int bound, int plen,
                                        bool term, int len, int Wp) {
  int hi = min(start + bound, min(Wp - 1, plen - 1));
  if (!term) hi = min(hi, plen - len);
  return hi;
}

__global__ void __launch_bounds__(kThreads) pair_cascade_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ npos,
    const int32_t* __restrict__ nlen, const int32_t* __restrict__ plen_all,
    const uint8_t* __restrict__ term_all, int Pb, int Lb, int Nb, int W,
    int Wp, int S, const int32_t* __restrict__ g_idx,
    const uint8_t* __restrict__ read_codes,
    const int32_t* __restrict__ read_len, int Lr,
    const int32_t* __restrict__ pair_combo,
    const uint8_t* __restrict__ pair_valid,
    const int32_t* __restrict__ seed_idx, const int32_t* __restrict__ seed_off_,
    const int32_t* __restrict__ span_lim,
    const int32_t* __restrict__ probe_ptr,
    const int32_t* __restrict__ probe_node,
    const int32_t* __restrict__ probe_rank, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* rd_s = smem;                  // [2][Lr]: forward, reverse complement
  uint8_t* ok34 = smem + 2 * Lr;         // [strand][clip][Pb]
  // [strand][Pb]: each row's least stage-1 offset, or least stage-2 key
  long long* row_key = reinterpret_cast<long long*>(
      smem + ((2 * Lr + 4 * Pb + 15) & ~15));
  // stage 1: the live rows [Pb]; stage 2: a pass's live (probe, row)
  // cells, {q, row, first x, last x} [kSeg] and rank * (S + 1) - cs [kSeg]
  int32_t* list = reinterpret_cast<int32_t*>(row_key + 2 * Pb);
  int4* cell = reinterpret_cast<int4*>(row_key + 2 * Pb);
  int32_t* cell_v = reinterpret_cast<int32_t*>(cell + kSeg);
  __shared__ int s_j1[2], s_any[4], s_n, s_fmin;
  __shared__ long long s_best[2];

  const int p = blockIdx.x, tid = threadIdx.x;
  const int c = pair_combo[p];
  const size_t gs = static_cast<size_t>(g_idx[c]);
  const uint8_t* paths = codes + gs * Pb * Lb;
  const int32_t* g_npos = npos + gs * Nb * Pb;
  const int32_t* g_nlen = nlen + gs * Nb;
  const int32_t* plen = plen_all + gs * Pb;
  const uint8_t* term = term_all + gs * Pb;
  const int len = read_len[c];
  const int seed = seed_idx[p], seed_off = seed_off_[p];
  const int32_t* seed_pos = g_npos + static_cast<size_t>(seed) * Pb;
  const int seed_len = g_nlen[seed];
  const int bound1 = min(span_lim[p], seed_len - 1 - seed_off);
  const int q0 = probe_ptr[p], q1 = probe_ptr[p + 1];
  const int S1 = S + 1;

  const uint8_t* rc = read_codes + static_cast<size_t>(c) * Lr;
  for (int j = tid; j < len; j += kThreads) {
    const int b = rc[j];
    rd_s[j] = b;
    rd_s[Lr + len - 1 - j] = b < 4 ? 3 - b : b;
  }
  if (tid == 0) {
    s_j1[0] = s_j1[1] = INF;
    s_best[0] = s_best[1] = BIG;
    s_any[0] = s_any[1] = s_any[2] = s_any[3] = 0;
    s_n = 0;
    s_fmin = INF;
  }
  for (int i = tid; i < 2 * Pb; i += kThreads) row_key[i] = BIG;
  __syncthreads();
  // the seed's live path rows and the least offset a lookup can reach
  for (int r = tid; r < Pb; r += kThreads) {
    const int ss = seed_pos[r];
    if (ss >= 0) {
      list[atomicAdd(&s_n, 1)] = r;
      const int base = ss + seed_off;
      atomicMin(&s_fmin, clampi(base, 0, W - 1) - base);
    }
  }
  __syncthreads();

  // ---- stage 1: both strands, rounds of CH offsets over the live rows
  // (2 * CH for the forward strand alone once the reverse one has hit)
  const int nlive = s_n, fmin = s_fmin;
  if (nlive > 0 && fmin <= bound1) {
    const int CH = max(1, kThreads / (2 * nlive));
    const int per = nlive * CH;
    bool rev_done = false;
    for (int f0 = fmin, ch = CH; f0 <= bound1;
         f0 += ch, ch = rev_done ? 2 * CH : CH) {
      int hit0 = 0, hit1 = 0;
      for (int i = tid; i < 2 * per; i += kThreads) {
        const int s = !rev_done && i >= per;
        const int rem = i - s * per, k = rem / ch;
        const int f = f0 + rem - k * ch;
        if (f > bound1) continue;
        const int r = list[k];
        const int base = seed_pos[r] + seed_off;
        const int x = base + f;
        if (x < clampi(base, 0, W - 1) ||
            x > last_pos(base, bound1, plen[r], term[r] != 0, len, Wp))
          continue;
        if (matches4(paths + static_cast<size_t>(r) * Lb, Lb, rd_s + s * Lr,
                     len, x)) {
          atomicMin(&s_j1[s], f);
          atomicMin(&row_key[s * Pb + r], static_cast<long long>(f));
          (s ? hit1 : hit0) = 1;
        }
      }
      if (__syncthreads_or(hit0)) break;
      const int h1 = __syncthreads_or(hit1);
      rev_done = rev_done || h1;
    }
  }
  __syncthreads();
  const int j1f = s_j1[0], j1r = s_j1[1];

  // ---- stage 2: forward, and reverse where its stage 1 failed
  const int nq = q1 - q0;
  if (j1f == INF && nq > 0) {
    const int nstr = j1r == INF ? 2 : 1;
    const long long cells = static_cast<long long>(nq) * Pb;
    for (long long seg = 0; seg < cells; seg += kSeg) {
      if (tid == 0) s_n = 0;
      __syncthreads();
      for (int i = tid; i < kSeg && seg + i < cells; i += kThreads) {
        const long long qr = seg + i;
        const int q = q0 + static_cast<int>(qr / Pb);
        const int r = static_cast<int>(qr % Pb);
        const int node = probe_node[q];
        const int cs = g_npos[static_cast<size_t>(node) * Pb + r];
        if (cs >= 0) {
          const int e = atomicAdd(&s_n, 1);
          cell[e] = make_int4(q, r, clampi(cs, 0, W - 1),
                              last_pos(cs, min(S, g_nlen[node] - 1), plen[r],
                                       term[r] != 0, len, Wp));
          cell_v[e] = probe_rank[q] * S1 - cs;
        }
      }
      __syncthreads();
      const int per = s_n * S1;
      for (int i = tid; i < nstr * per; i += kThreads) {
        const int s = i >= per;
        const int rem = i - s * per, e = rem / S1, sh = rem - e * S1;
        const int4 cl = cell[e];  // q, row, first x, last x
        const uint8_t* path = paths + static_cast<size_t>(cl.y) * Lb;
        for (int x = cl.z + sh; x <= cl.w; x += S1) {
          if (matches4(path, Lb, rd_s + s * Lr, len, x)) {
            const long long k =
                static_cast<long long>(cell_v[e] + x) * 4294967296LL + cl.x;
            atomicMin(&s_best[s], k);
            atomicMin(&row_key[s * Pb + cl.y], k);
            break;
          }
        }
      }
      __syncthreads();
    }
  }
  const long long best0 = s_best[0], best1 = s_best[1];

  // ---- stages 3/4: forward, and reverse where its stages 1-2 failed
  if (j1f == INF && best0 == BIG) {
    const int nstr = j1r == INF && best1 == BIG ? 2 : 1;
    const bool live_seed = seed_off < seed_len;
    for (int i = tid; i < nstr * 2 * Pb; i += kThreads) {
      const int s = i / (2 * Pb), rem = i - s * 2 * Pb;
      const int clip = rem / Pb, r = rem - clip * Pb;  // clip 0: start, 1: end
      const int ss = seed_pos[r];
      bool ok = false;
      if (ss >= 0 && live_seed) {
        const int base = ss + seed_off;
        const int pl = plen[r];
        if (base < pl && (base + len - 1 <= pl || term[r]))
          ok = matches(paths + static_cast<size_t>(r) * Lb, Lb,
                       rd_s + s * Lr + (clip == 0), len - 1, clampi(base, 0, W - 1));
      }
      ok34[i] = ok;
      if (ok) s_any[s * 2 + clip] = 1;
    }
    __syncthreads();
  }

  // ---- the answer: forward if it found anything, else reverse
  int ori = 0, stage = 4, j1 = INF;
  long long key = BIG;
  bool found = true;
  if (j1f < INF) {
    stage = 1, j1 = j1f;
  } else if (best0 < BIG) {
    stage = 2, key = best0;
  } else if (s_any[0] || s_any[1]) {
    stage = s_any[0] ? 3 : 4;
  } else {
    ori = 1;
    if (j1r < INF) stage = 1, j1 = j1r;
    else if (best1 < BIG) stage = 2, key = best1;
    else if (s_any[2]) stage = 3;
    else found = s_any[3] != 0;
  }
  int node = seed, off = seed_off;
  const uint8_t* rd = rd_s + ori * Lr;
  bool exact2 = false;  // the winner's offset is its own least match's
  if (stage == 1) off = seed_off + j1;
  if (stage == 2) {
    const int q = static_cast<int>(key & 0xffffffffLL);
    const long long v = key >> 32;  // floor: the low word is the probe row
    off = static_cast<int>(((v % S1) + S1) % S1);  // floor mod, as the reference's
    node = probe_node[q];
    exact2 = v - static_cast<long long>(probe_rank[q]) * S1 == off;
  }
  int32_t* row = out + static_cast<size_t>(p) * (8 + Pb);
  for (int r = tid; r < Pb; r += kThreads) {
    const uint8_t* path = paths + static_cast<size_t>(r) * Lb;
    bool ok = false;
    if (stage == 1) {  // rows whose least gated match sits at j1
      ok = row_key[ori * Pb + r] == j1;
    } else if (stage == 2 && exact2) {  // rows whose least key is the winner's
      ok = row_key[ori * Pb + r] == key;
    } else if (stage == 2) {  // rows of the winner whose least match is at off
      const int cs = g_npos[static_cast<size_t>(node) * Pb + r];
      if (cs >= 0) {
        const int hi = last_pos(cs, min(S, g_nlen[node] - 1), plen[r],
                                term[r] != 0, len, Wp);
        int x = clampi(cs, 0, W - 1);
        while (x <= hi && !matches4(path, Lb, rd, len, x)) ++x;
        ok = x <= hi && x - cs == off;
      }
    } else {
      ok = ok34[(ori * 2 + stage - 3) * Pb + r] != 0;
    }
    row[8 + r] = ok;
  }
  if (tid == 0) {
    row[0] = found && pair_valid[p] != 0;
    row[1] = 0;
    row[2] = ori;
    row[3] = stage;
    row[4] = node;
    row[5] = off;
    row[6] = stage == 3 ? MAX_CLIP : 0;
    row[7] = stage == 4 ? MAX_CLIP : 0;
  }
}

}  // namespace

extern "C" int groot_pair_cascade(
    const void* codes, const void* npos, const void* nlen, const void* plen,
    const void* term, int Gs, int Pb, int Lb, int Nb, const void* g_idx,
    const void* read_codes, const void* read_len, int C, int Lr,
    const void* pair_combo, const void* pair_valid, const void* seed_idx,
    const void* seed_off, const void* span_lim, int Np, const void* probe_ptr,
    const void* probe_node, const void* probe_rank, int Nq, int W, int Wp,
    int n_shuffles, void* out, void* stream) {
  if (Np == 0) return 0;
  if (Gs < 1 || Pb < 1 || Lb < 1 || Nb < 1 || C < 1 || Lr < 1 || Nq < 0 ||
      W < 1 || W > Lb || Wp < W || n_shuffles < 0 || Lb % 4 || Lr % 4 ||
      reinterpret_cast<uintptr_t>(codes) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ((2 * static_cast<size_t>(Lr) + 4 * Pb + 15) & ~size_t(15)) +
                      16 * static_cast<size_t>(Pb) +
                      (Pb > 5 * kSeg ? 4 * static_cast<size_t>(Pb) : 20 * kSeg);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pair_cascade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pair_cascade_kernel<<<Np, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(npos),
      static_cast<const int32_t*>(nlen), static_cast<const int32_t*>(plen),
      static_cast<const uint8_t*>(term), Pb, Lb, Nb, W, Wp, n_shuffles,
      static_cast<const int32_t*>(g_idx),
      static_cast<const uint8_t*>(read_codes),
      static_cast<const int32_t*>(read_len), Lr,
      static_cast<const int32_t*>(pair_combo),
      static_cast<const uint8_t*>(pair_valid),
      static_cast<const int32_t*>(seed_idx),
      static_cast<const int32_t*>(seed_off),
      static_cast<const int32_t*>(span_lim),
      static_cast<const int32_t*>(probe_ptr),
      static_cast<const int32_t*>(probe_node),
      static_cast<const int32_t*>(probe_rank), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
