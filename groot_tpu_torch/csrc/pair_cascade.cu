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
// Design: one warp per pair, lanes over path rows (a loop when Pb > 32).
// The forward orientation runs first; the reverse runs only when the
// forward finds nothing (the reference then reports the reverse columns,
// found or not). Per orientation:
//   stage 1: each row's least gated full match in [clip(base),
//     base + bound1]; a warp min gives j1, the id bits are the rows at j1;
//   stage 2 (no stage-1 hit): the pair's probes in order; each row's least
//     gated full match in [clip(c_start), c_start + bound2]; the lowest
//     (rank * (S + 1) + first2, probe row) wins and its rows are tested once
//     more for the id bits;
//   stages 3/4: the clip-start, then the clip-end variant at clip(base).
// clip() is the reference's clamp to [0, W - 1] for the lookup; offsets are
// taken from the unclamped position. The id slots of the output row are
// each lane's scratch for its own rows. What bounds it: the compares, on
// path rows and reads that stay in L1/L2; on random sequence a mismatch
// ends a compare after ~1.3 bases, so the work is about the positions tried
// times a few bases.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int INF = 1 << 30;
constexpr int MAX_CLIP = 1;  // alignment.go:16

struct Graph {              // one graph slot of the signature stack
  const uint8_t* codes;     // [Pb, Lb]
  const int32_t* npos;      // [Nb, Pb]
  const int32_t* nlen;      // [Nb]
  const int32_t* plen;      // [Pb]
  const uint8_t* term;      // [Pb]
};

struct Dims {
  int Pb, Lb, W, Wp, S;
};

struct Read {
  const uint8_t* codes;     // [Lr], 0-4
  int len;
};

struct Pick {
  bool found;
  int stage, node, off;
};

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) {
    const int w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  return v;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// base j (0 <= j < len) of the read in orientation ori (1: reverse
// complement, RC_CODE = 3, 2, 1, 0, 4)
__device__ __forceinline__ int read_base(const Read& rd, int ori, int j) {
  if (ori == 0) return rd.codes[j];
  const int c = rd.codes[rd.len - 1 - j];
  return c < 4 ? 3 - c : c;
}

// Does variant `clip` (0 full, 1 clip start = read[1:], 2 clip end =
// read[:-1]) of the read in orientation `ori` match the path row at x? A
// path 4 (N or pad) matches read codes 0-4, a read base 0-3 its own path
// base, a read N only a path 4 (the one-hot channels); columns past Lb are
// the reference's zero padding and match nothing.
__device__ bool matches(const uint8_t* path, int Lb, const Read& rd, int ori,
                        int clip, int x) {
  const int n = clip ? rd.len - 1 : rd.len;
  if (n < 0) return false;
  if (n > 0 && x + n > Lb) return false;
  const int s = clip == 1 ? 1 : 0;
  for (int j = 0; j < n; ++j) {
    const int pb = path[x + j];
    const int rb = read_base(rd, ori, j + s);
    if (rb > 4 || (pb != 4 && pb != rb)) return false;
  }
  return true;
}

// The least x in [lo, hi] that is a gated full match (x < Wp, x < plen and,
// unless the row is terminal-free, x + len <= plen), or -1.
__device__ int first_full(const uint8_t* path, const Dims& d, const Read& rd,
                          int ori, int lo, int hi, int plen, bool term) {
  hi = min(hi, min(d.Wp - 1, plen - 1));
  if (!term) hi = min(hi, plen - rd.len);
  for (int x = lo; x <= hi; ++x)
    if (matches(path, d.Lb, rd, ori, 0, x)) return x;
  return -1;
}

// One orientation of the cascade for the pair; every lane of the warp calls
// it and gets the same Pick. Writes the pair's id bits to ids[0:Pb].
__device__ Pick cascade_ori(int ori, const Graph& g, const Dims& d,
                            const Read& rd, int seed, int seed_off, int span,
                            int q0, int q1, const int32_t* probe_node,
                            const int32_t* probe_rank, int32_t* ids,
                            int lane) {
  const int Pb = d.Pb;
  const int32_t* seed_pos = g.npos + static_cast<size_t>(seed) * Pb;
  const int seed_len = g.nlen[seed];
  const int bound1 = min(span, seed_len - 1 - seed_off);

  // stage 1: offsets from the seed, up to the shuffle limit
  int j1 = INF;
  for (int r = lane; r < Pb; r += 32) {
    int f = INF;
    const int ss = seed_pos[r];
    if (ss >= 0) {
      const int base = ss + seed_off;
      const int x = first_full(g.codes + static_cast<size_t>(r) * d.Lb, d, rd,
                               ori, clampi(base, 0, d.W - 1), base + bound1,
                               g.plen[r], g.term[r] != 0);
      if (x >= 0) f = x - base;
    }
    ids[r] = f;
    j1 = min(j1, f);
  }
  j1 = warp_min(j1);
  if (j1 < INF) {
    for (int r = lane; r < Pb; r += 32) ids[r] = ids[r] == j1;
    return {true, 1, seed, seed_off + j1};
  }

  // stage 2: contained nodes in order, shuffles 0..S
  const int S1 = d.S + 1;
  int best = INF, best_q = -1;
  for (int q = q0; q < q1; ++q) {
    const int node = probe_node[q];
    const int32_t* cpos = g.npos + static_cast<size_t>(node) * Pb;
    const int bound2 = min(d.S, g.nlen[node] - 1);
    const int rank = probe_rank[q];
    int pr = INF;
    for (int r = lane; r < Pb; r += 32) {
      const int cs = cpos[r];
      if (cs < 0) continue;
      const int x = first_full(g.codes + static_cast<size_t>(r) * d.Lb, d, rd,
                               ori, clampi(cs, 0, d.W - 1), cs + bound2,
                               g.plen[r], g.term[r] != 0);
      if (x >= 0) pr = min(pr, rank * S1 + (x - cs));
    }
    pr = warp_min(pr);
    if (pr < best) {  // strict: the lowest probe row among equal values
      best = pr;
      best_q = q;
    }
  }
  if (best_q >= 0) {
    const int jj2 = ((best % S1) + S1) % S1;  // floor mod, as the reference's
    const int node = probe_node[best_q];
    const int32_t* cpos = g.npos + static_cast<size_t>(node) * Pb;
    const int bound2 = min(d.S, g.nlen[node] - 1);
    for (int r = lane; r < Pb; r += 32) {
      const int cs = cpos[r];
      bool ok = false;
      if (cs >= 0) {
        const int x = first_full(g.codes + static_cast<size_t>(r) * d.Lb, d,
                                 rd, ori, clampi(cs, 0, d.W - 1), cs + bound2,
                                 g.plen[r], g.term[r] != 0);
        ok = x >= 0 && x - cs == jj2;
      }
      ids[r] = ok;
    }
    return {true, 2, node, jj2};
  }

  // stages 3/4: one clipped probe at the seed offset
  for (int clip = 1; clip <= 2; ++clip) {
    bool any = false;
    for (int r = lane; r < Pb; r += 32) {
      bool ok = false;
      const int ss = seed_pos[r];
      if (ss >= 0 && seed_off < seed_len) {
        const int base = ss + seed_off;
        const int plen = g.plen[r];
        if (base < plen && (base + rd.len - 1 <= plen || g.term[r]))
          ok = matches(g.codes + static_cast<size_t>(r) * d.Lb, d.Lb, rd, ori,
                       clip, clampi(base, 0, d.W - 1));
      }
      ids[r] = ok;
      any = any || ok;
    }
    if (__any_sync(0xffffffffu, any))
      return {true, clip == 1 ? 3 : 4, seed, seed_off};
  }
  return {false, 4, seed, seed_off};
}

__global__ void pair_cascade_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ npos,
    const int32_t* __restrict__ nlen, const int32_t* __restrict__ plen,
    const uint8_t* __restrict__ term, int Nb, Dims d,
    const int32_t* __restrict__ g_idx, const uint8_t* __restrict__ read_codes,
    const int32_t* __restrict__ read_len, int Lr,
    const int32_t* __restrict__ pair_combo,
    const uint8_t* __restrict__ pair_valid,
    const int32_t* __restrict__ seed_idx, const int32_t* __restrict__ seed_off,
    const int32_t* __restrict__ span_lim, int Np,
    const int32_t* __restrict__ probe_ptr,
    const int32_t* __restrict__ probe_node,
    const int32_t* __restrict__ probe_rank, int32_t* __restrict__ out) {
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= Np) return;  // uniform per warp

  const int c = pair_combo[p];
  const size_t gs = static_cast<size_t>(g_idx[c]);
  const Graph g{codes + gs * d.Pb * d.Lb, npos + gs * Nb * d.Pb,
                nlen + gs * Nb, plen + gs * d.Pb, term + gs * d.Pb};
  const Read rd{read_codes + static_cast<size_t>(c) * Lr, read_len[c]};
  int32_t* row = out + static_cast<size_t>(p) * (8 + d.Pb);
  const int seed = seed_idx[p], off = seed_off[p], span = span_lim[p];
  const int q0 = probe_ptr[p], q1 = probe_ptr[p + 1];

  int ori = 0;
  Pick pk = cascade_ori(0, g, d, rd, seed, off, span, q0, q1, probe_node,
                        probe_rank, row + 8, lane);
  if (!pk.found) {
    ori = 1;
    pk = cascade_ori(1, g, d, rd, seed, off, span, q0, q1, probe_node,
                     probe_rank, row + 8, lane);
  }
  if (lane == 0) {
    row[0] = pk.found && pair_valid[p] != 0;
    row[1] = 0;
    row[2] = ori;
    row[3] = pk.stage;
    row[4] = pk.node;
    row[5] = pk.off;
    row[6] = pk.stage == 3 ? MAX_CLIP : 0;
    row[7] = pk.stage == 4 ? MAX_CLIP : 0;
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
      W < 1 || W > Lb || Wp < W || n_shuffles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{Pb, Lb, W, Wp, n_shuffles};
  const int blocks = (Np + kWarps - 1) / kWarps;
  pair_cascade_kernel<<<blocks, 32 * kWarps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(npos),
      static_cast<const int32_t*>(nlen), static_cast<const int32_t*>(plen),
      static_cast<const uint8_t*>(term), Nb, d,
      static_cast<const int32_t*>(g_idx),
      static_cast<const uint8_t*>(read_codes),
      static_cast<const int32_t*>(read_len), Lr,
      static_cast<const int32_t*>(pair_combo),
      static_cast<const uint8_t*>(pair_valid),
      static_cast<const int32_t*>(seed_idx),
      static_cast<const int32_t*>(seed_off),
      static_cast<const int32_t*>(span_lim), Np,
      static_cast<const int32_t*>(probe_ptr),
      static_cast<const int32_t*>(probe_node),
      static_cast<const int32_t*>(probe_rank), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
