// Device LSH containment query: read sketches u64 [B, s] -> the kept window
// ids int32 [B, C] (-1 elsewhere) and the f32 containment of every
// candidate slot [B, C].
//
// Replaces groot_tpu/index/lshe.py::_query_device with _mix_bands_jax (an
// XLA program) and the seed half of parallel/device_index.py::align_step
// (banded and full-equality modes). Per read:
//   1. band signatures: the 32-bit FNV mix of each band's K slots (low
//      word, then high word, per slot), as _mix_bands_np;
//   2. per band, the lower bound lo of the signature in the band's sorted
//      row (u32 [L, N]) and at most M window ids gathered from band_idx (-1
//      for an empty slot): C = L * M slots. Slot m holds an id when
//      lo + m < N and sigs[lo + m] equals the signature, which in a sorted
//      row is the reference's lo + m < upper bound;
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
// Design: one warp per read, the read's sketch and its C ids in shared
// memory. The lanes split into groups of g = 2^d - 1 <= 32 / L lanes (g >=
// 1), a group a band: the lower bound is a 2^d-ary search in which the g
// lanes load g splitters at once and a ballot picks the sub-range, so the
// full mode (L = 1, g = 31) takes ceil(log32 N) = 4 levels at 408,788
// windows, the banded mode at L = 10 (g = 3) 10 levels, against 2 log2 N
// dependent loads of two binary searches. The M ids of a band are gathered
// by its group's lanes at once. The banded mode compacts the ids found (by
// ballots) and sorts only those, padded to a power of two >= 32, by a
// bitonic network: strides below 32 by shuffles in registers (entry r * 32
// + lane in lane `lane`, four rows at once), wider ones in shared memory;
// the -1s of the empty slots go in front. The candidates' sketch rows are read by groups of
// lanes sized to C (8 lanes a candidate at C = 3), their slot matches summed
// by shuffles; window 0's matches, which every empty or duplicate slot
// scores, are counted once a read.
// Where a block's four reads' sketches (8 s bytes each) and sort buffers
// (8 Cp bytes each) do not fit the card's shared memory (C past about
// 6,000, or a very large s), the global route takes the same steps with
// each read's ids and sort buffer in its own slice of a scratch the
// wrapper allocates (int32 [B, 2 Cp], groot_lsh_query_scratch_bytes) and
// its sketch read from q; the
// sort's strides below 32 stay in registers, the wider ones go through L1.
// What bounds it on the card: the latency of the dependent loads (the
// search levels, then the ids, then the sketch rows); the signature row
// (1.6 MB) stays in L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kWarpsPerBlock = 4;
constexpr int kNarrowS = 64;  // slots a warp's staged sketch takes when s <= 64
constexpr unsigned kFull = 0xffffffffu;

constexpr int kIlp = 4;  // entries a lane carries through a sort stage at once

// Sort the warp's Cp entries (a power of two >= 32) ascending. Entry
// r * 32 + lane lives in lane `lane`: strides below 32 exchange by shuffles,
// kIlp rows of a lane at once in registers; wider strides compare in shared
// memory, each lane loading its kIlp pairs before it stores.
__device__ void warp_bitonic_sort(int32_t* buf, int Cp, int lane) {
  const int E = Cp >> 5;  // rows of 32 entries
  for (int size = 2; size <= Cp; size <<= 1) {
    int stride = size >> 1;
    for (; stride >= 32; stride >>= 1) {
      for (int i0 = lane; i0 < Cp / 2; i0 += 32 * kIlp) {
        int32_t x[kIlp], y[kIlp];
        int a[kIlp];
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
          const int i = i0 + 32 * u;
          a[u] = ((i & ~(stride - 1)) << 1) | (i & (stride - 1));
          if (i < Cp / 2) {
            x[u] = buf[a[u]];
            y[u] = buf[a[u] + stride];
          }
        }
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
          if (i0 + 32 * u < Cp / 2 && (x[u] > y[u]) == ((a[u] & size) == 0)) {
            buf[a[u]] = y[u];
            buf[a[u] + stride] = x[u];
          }
        }
      }
      __syncwarp();
    }
    for (int r0 = 0; r0 < E; r0 += kIlp) {  // r0 and E are the warp's own
      int32_t v[kIlp];
#pragma unroll
      for (int u = 0; u < kIlp; ++u)
        if (r0 + u < E) v[u] = buf[(r0 + u) * 32 + lane];
      for (int st = stride; st > 0; st >>= 1) {
        const bool lower = (lane & st) == 0;
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
          if (r0 + u < E) {
            const int32_t o = __shfl_xor_sync(kFull, v[u], st);
            const bool asc = ((((r0 + u) << 5) | lane) & size) == 0;
            v[u] = (lower == asc) ? (o < v[u] ? o : v[u]) : (o > v[u] ? o : v[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kIlp; ++u)
        if (r0 + u < E) buf[(r0 + u) * 32 + lane] = v[u];
    }
    __syncwarp();
  }
}

// kGlobal: the read's sort buffer in scratch (int32 [B][2 Cp]) and its
// sketch read from q; else both in shared memory ([warps][qst] u64, then
// [warps][2 Cp] int32). kWide: s > 64, the staged sketch takes qst = s
// slots (else kNarrowS) and window 0's slots past 64 are compared too.
template <bool kGlobal, bool kWide>
__global__ void lsh_query_kernel(
    const u64* __restrict__ q, const int32_t* __restrict__ kc,
    const u64* __restrict__ sketches, const uint32_t* __restrict__ sigs,
    const int32_t* __restrict__ idx, int B, int s, int N, int L, int K, int M,
    int Cp, int qmax, float d, float t, int full,
    int32_t* __restrict__ win_out, float* __restrict__ contain_out,
    int32_t* __restrict__ scratch) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qst = kWide ? s : kNarrowS;
  u64* qs = reinterpret_cast<u64*>(smem) + static_cast<size_t>(warp) * qst;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  int32_t* buf = kGlobal ? scratch + static_cast<size_t>(b) * 2 * Cp
                         : reinterpret_cast<int32_t*>(reinterpret_cast<u64*>(smem) +
                                                      kWarpsPerBlock * qst) +
                               static_cast<size_t>(warp) * 2 * Cp;
  int32_t* real_ids = buf + Cp;
  if (b >= B) return;  // the whole warp: every shuffle below has 32 lanes
  const int C = L * M;

  const int kcb = kc[b];  // loaded beside the sketch, used at the end
  // window 0's first 64 slots, which every empty or duplicate slot scores:
  // loaded now, compared at the end (with any slots past them)
  const u64 w0a = lane < s ? sketches[lane] : 0;
  const u64 w0b = lane + 32 < s ? sketches[lane + 32] : 0;
  const u64* qv = kGlobal ? q + static_cast<size_t>(b) * s : qs;
  if (!kGlobal)
    for (int i = lane; i < s; i += 32) qs[i] = q[static_cast<size_t>(b) * s + i];
  __syncwarp();

  // 1-2: band signatures, (g+1)-ary lower bounds, gathered ids; g = 2^lg
  // - 1 lanes a band, the most that give every band a group, so the g + 1
  // sub-range edges are shifts
  int lg = 1;  // log2(g + 1)
  while ((2 << lg) - 1 <= (L >= 32 ? 1 : 32 / L)) ++lg;
  const int g = (1 << lg) - 1;
  const int n_grp = 32 / g;
  const int grp = lane / g, j = lane - grp * g;
  const unsigned gmask = ((1u << g) - 1) << (grp * g);
  for (int band0 = 0; band0 < L; band0 += n_grp) {
    const int band = band0 + grp;
    const bool active = grp < n_grp && band < L;
    uint32_t h = 2166136261u;
    if (active) {
      for (int x = 0; x < K; ++x) {
        const u64 v = qv[band * K + x];
        h = (h ^ static_cast<uint32_t>(v)) * 16777619u;
        h = (h ^ static_cast<uint32_t>(v >> 32)) * 16777619u;
      }
    }
    const uint32_t* row = sigs + static_cast<size_t>(band < L ? band : 0) * N;
    // the lower bound lies in [lo, hi]; the entries in [lo, hi) are unknown
    int lo = 0, hi = active ? N : 0;
    while (__any_sync(kFull, lo < hi)) {
      const long long len = hi - lo;
      bool below = false;  // the last entry of sub-range j is below h
      if (lo < hi) {
        const int end = lo + static_cast<int>(((j + 1) * len + g) >> lg);
        below = row[end - 1] < h;
      }
      const int c = __popc(__ballot_sync(kFull, below) & gmask);
      if (lo < hi) {
        const int nlo = lo + static_cast<int>((c * len + g) >> lg);
        if (c < g) hi = lo + static_cast<int>(((c + 1) * len + g) >> lg) - 1;
        lo = nlo;
      }
    }
    if (active) {
      const int32_t* irow = idx + static_cast<size_t>(band) * N;
      for (int mm = j; mm < M; mm += g) {
        const int pos = lo + mm;
        int32_t id = -1;
        if (pos < N) {
          const int32_t cand = irow[pos];
          if (row[pos] == h) id = cand;
        }
        buf[band * M + mm] = id;
      }
    }
  }
  __syncwarp();

  // 3: sort (banded mode only): the ids found are compacted and sorted
  //    alone, and the -1s of the empty slots, which sort first, put before
  //    them
  if (!full) {
    int n_real = 0;
    for (int e0 = 0; e0 < C; e0 += 32) {
      const int e = e0 + lane;
      const int32_t v = e < C ? buf[e] : -1;
      const unsigned found = __ballot_sync(kFull, v >= 0);
      if (v >= 0) real_ids[n_real + __popc(found & ((1u << lane) - 1))] = v;
      n_real += __popc(found);
    }
    int P2 = 32;
    while (P2 < n_real) P2 <<= 1;
    for (int e = n_real + lane; e < P2; e += 32) real_ids[e] = 0x7fffffff;
    __syncwarp();
    warp_bitonic_sort(real_ids, P2, lane);
    const int n_empty = C - n_real;
    for (int e = lane; e < C; e += 32) buf[e] = e < n_empty ? -1 : real_ids[e - n_empty];
    __syncwarp();
  }

  // 4-5: dedup, containment, keep; gc lanes a candidate. An empty or
  // duplicate slot scores window 0 (the reference's clipped gather), the
  // same for every such slot of the read: its matches are counted once
  int eq0 = __popc(__ballot_sync(kFull, lane < s && w0a == qv[lane])) +
            __popc(__ballot_sync(kFull, lane + 32 < s && w0b == qv[lane + 32]));
  if constexpr (kWide) {
    for (int x0 = 64; x0 < s; x0 += 32) {
      const int x = x0 + lane;
      eq0 += __popc(__ballot_sync(kFull, x < s && sketches[x] == qv[x]));
    }
  }
  int gc = 1;
  while (gc < 32 && 2 * gc * C <= 32) gc <<= 1;
  const float qsf = __int2float_rn(kcb);
  const float sf = __int2float_rn(s);
  for (int i0 = 0; i0 < C; i0 += 32 / gc) {
    const int i = i0 + lane / gc, jj = lane & (gc - 1);
    int32_t cand = -1;
    int eq = 0;
    if (i < C) {
      cand = buf[i];
      if (!full && i > 0 && buf[i - 1] == cand) cand = -1;
      if (cand < 0) {
        eq = jj == 0 ? eq0 : 0;
      } else {
        const u64* wrow = sketches + static_cast<size_t>(cand) * s;
        for (int x = jj; x < s; x += gc) eq += wrow[x] == qv[x];
      }
    }
    for (int o = gc >> 1; o > 0; o >>= 1) eq += __shfl_xor_sync(kFull, eq, o);
    if (i < C && jj == 0) {
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
}

// The candidate slots of a read's sort buffer: C rounded up to a power of
// two, at least 32.
int padded_candidates(long long C) {
  int Cp = 32;
  while (Cp < C) Cp <<= 1;
  return Cp;
}

// The shared route's dynamic shared memory a block: four reads' staged
// sketches (8 max(s, 64) bytes each) and sort buffers (8 Cp bytes each).
size_t shared_bytes(int s, int Cp) {
  const size_t qst = s > kNarrowS ? s : kNarrowS;
  return kWarpsPerBlock * (qst * sizeof(u64) + 2 * static_cast<size_t>(Cp) * sizeof(int32_t));
}

}  // namespace

// The bytes of scratch groot_lsh_query needs for B reads of s slots and
// C = L M candidate slots on the current device: 0 where the shared
// route's bytes fit a block's opt-in shared memory, else those of the
// global route's int32 [B, 2 Cp]; -error on a CUDA error.
extern "C" long long groot_lsh_query_scratch_bytes(long long B, long long s,
                                                    long long L, long long M) {
  const long long C = L * M;
  if (B < 1 || s < 1 || s > INT32_MAX || L < 1 || M < 1 || C > (1 << 29)) return 0;
  const int Cp = padded_candidates(C);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  if (shared_bytes(static_cast<int>(s), Cp) <= static_cast<size_t>(optin)) return 0;
  return B * 2 * Cp * static_cast<long long>(sizeof(int32_t));
}

// scratch: null for the shared route, or int32 [B, 2 Cp] for the global
// route, sized by groot_lsh_query_scratch_bytes.
extern "C" int groot_lsh_query(
    const void* q, const void* kc, const void* sketches, const void* sigs,
    const void* idx, int B, int s, int N, int L, int K, int M, int qmax,
    float d, float t, int full, void* win_out, void* contain_out,
    void* scratch, void* stream) {
  const long long C = static_cast<long long>(L) * M;
  if (B < 1 || s < 1 || N < 1 || L < 1 || K < 1 || static_cast<long long>(L) * K > s ||
      M < 1 || C > (1 << 29) || (full && L != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Cp = padded_candidates(C);
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const u64* qp = static_cast<const u64*>(q);
  const int32_t* kp = static_cast<const int32_t*>(kc);
  const u64* skp = static_cast<const u64*>(sketches);
  const uint32_t* sgp = static_cast<const uint32_t*>(sigs);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  int32_t* wo = static_cast<int32_t*>(win_out);
  float* co = static_cast<float*>(contain_out);
  int32_t* sc = static_cast<int32_t*>(scratch);
  const bool wide = s > kNarrowS;
  const size_t smem = scratch ? 0 : shared_bytes(s, Cp);
  if (smem > static_cast<size_t>(INT32_MAX)) return static_cast<int>(cudaErrorInvalidValue);
#define GROOT_LSH_LAUNCH(GLOBAL, WIDE)                                               \
  do {                                                                               \
    if (!GLOBAL) {                                                                   \
      const cudaError_t err = cudaFuncSetAttribute(                                  \
          lsh_query_kernel<GLOBAL, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
          static_cast<int>(smem));                                                   \
      if (err != cudaSuccess) return static_cast<int>(err);                          \
    }                                                                                \
    lsh_query_kernel<GLOBAL, WIDE><<<blocks, kWarpsPerBlock * 32, smem, st>>>(        \
        qp, kp, skp, sgp, ip, B, s, N, L, K, M, Cp, qmax, d, t, full, wo, co, sc);   \
  } while (0)
  switch (2 * (scratch != nullptr) + wide) {
    case 0: GROOT_LSH_LAUNCH(false, false); break;
    case 1: GROOT_LSH_LAUNCH(false, true); break;
    case 2: GROOT_LSH_LAUNCH(true, false); break;
    default: GROOT_LSH_LAUNCH(true, true); break;
  }
#undef GROOT_LSH_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
