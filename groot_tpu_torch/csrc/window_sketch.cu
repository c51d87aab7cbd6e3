// Run-start window sketches of the index build: u8 path rows [R, L] ->
// (rows, cols, sketches u64 [M, s]) of every window whose KHF sketch differs
// from its predecessor's (and every row's first window).
//
// Replaces groot_tpu/index/window.py::window_sketches with _change_mask and
// _gather_sketches (XLA programs): the reference computes every stride-1
// window sketch [P, nw, s] with a van Herk sliding minimum over (hi, lo)
// uint32 pairs, flags run starts on the device and gathers them in fixed
// ROW_CHUNK x BLOCK_NW shapes, stitching runs across column blocks on the
// host. It returns the contract of native.window_sketch
// (groot_tpu/io/native.py): run starts in row-major order, columns
// ascending within a row, so _merge_windows_soa runs unchanged.
//
// Design: one launch, one block per tile of tw windows of a row (tw from
// groot_window_tile_width, the widest tile that lets two blocks share an
// SM); a row has ceil(windows / tw) tiles, and one without a window none.
// A block takes its tile in row-major order from an atomic counter, so
// every tile before it has started, and its row and the row's first tile
// from the wrapper's tile table; then:
//   1. it computes the canonical ntHash of each k-mer of the tile (a halo
//      of w-1 bases, plus one window in front: the previous tile's last
//      window) once, in O(1) from block-wide prefix-XORs of the bases;
//   2. van Herk / Gil-Werman sliding minimum: the tile's k-mers fall into
//      blocks of m = w-k+1; a thread takes one (slot, block) and walks the
//      block backward (suffix minima S, written to the window minima of the
//      block in shared memory) and the next block forward (prefix minima P):
//      window i = min(S[i], P[i+m-1]). Per k-mer and slot two slot hashes
//      and two u64 minima, in registers, with no barrier between slots. A
//      thread compares each window it finishes with the one before it and
//      marks a change; windows at the start of an m-block are compared over
//      every slot after the barrier;
//   3. a block scan ranks the tile's run starts; the tile's first output
//      slot comes from a single-pass decoupled look-back over the tiles
//      before it (status and value in one 64-bit word: aggregate, or
//      inclusive prefix); row, column and the s minima of each run start
//      are written from shared memory, coalesced. Nothing is written for a
//      window that is not a run start; each tile adds its count to its
//      row's, and the last tile writes M.
// Windows past len-w are never computed, and every k-mer of a valid window
// is valid, so no masking is needed. Codes above 4 count as N (seed 0).
// Slot groups: where no tile holds the minima of all s slots (s (tw + 1)
// u64; about s > 870 at w150 even at tw = 32), the tile runs step 2 on
// groups of sg slots, one after another in the same shared memory: each
// group ORs its change marks (and its m-block start compares) into the
// tile's, so a run start is a window where any slot changed; after step 3
// each group's minima are computed once more and its slots of the run
// starts written.
//
// What bounds it on the card: integer instructions (per k-mer and slot two
// multiply-xorshift slot hashes and two u64 minima), then the output, 8 + 8s
// bytes a run start.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"
#include "nthash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kU = 8;       // hashes a sliding-minimum walk loads at once
constexpr int kTileWidths[] = {512, 256, 128, 64, 32};  // widest first

// slot_hash (nthash.cuh) of a canonical hash, for a slot's multiplier
// (1 for slot 0) and shift mask (0 for slot 0)
__device__ __forceinline__ u64 mix_slot(u64 c, u64 mult, u64 keep) {
  const u64 h = c * mult;
  return h ^ ((h >> kMultiShift) & keep);
}
constexpr u64 kAggregate = 1ULL << 62;  // tile status: its own count known
constexpr u64 kInclusive = 2ULL << 62;  // tile status: its inclusive prefix
constexpr u64 kValueMask = (1ULL << 62) - 1;

// Dynamic shared memory of a tile of tw windows: minima [s][tw+1] (the odd row stride keeps the slots' u64 in distinct
// banks; the prefix-XORs [2][tw+w+1] use the same space before them),
// hashes [tw+m], run-start list [tw], change marks [tw+1].
inline size_t tile_smem(int tw, int s, int k, int w) {
  const int m = w - k + 1;
  const size_t mins = static_cast<size_t>(s) * (tw + 1), xy = 2 * static_cast<size_t>(tw + w + 1);
  return sizeof(u64) * ((mins > xy ? mins : xy) + tw + m) + sizeof(int32_t) * tw +
         (tw + 1);
}

// Block-wide exclusive XOR-scan of a pair (all threads call it; wx, wy are
// shared scratch of 32 entries each).
__device__ __forceinline__ void block_xor_scan2(u64& a, u64& b, u64* wx, u64* wy) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  u64 ia = a, ib = b;
  for (int o = 1; o < 32; o <<= 1) {
    const u64 na = __shfl_up_sync(0xffffffffu, ia, o);
    const u64 nb = __shfl_up_sync(0xffffffffu, ib, o);
    if (lane >= o) {
      ia ^= na;
      ib ^= nb;
    }
  }
  if (lane == 31) {
    wx[wid] = ia;
    wy[wid] = ib;
  }
  __syncthreads();
  if (wid == 0) {
    const int n_warps = blockDim.x >> 5;
    u64 xa = lane < n_warps ? wx[lane] : 0, xb = lane < n_warps ? wy[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const u64 na = __shfl_up_sync(0xffffffffu, xa, o);
      const u64 nb = __shfl_up_sync(0xffffffffu, xb, o);
      if (lane >= o) {
        xa ^= na;
        xb ^= nb;
      }
    }
    if (lane < n_warps) {
      wx[lane] = xa;
      wy[lane] = xb;
    }
  }
  __syncthreads();
  const u64 ea = ia ^ a, eb = ib ^ b;  // exclusive within the warp
  a = wid > 0 ? ea ^ wx[wid - 1] : ea;
  b = wid > 0 ? eb ^ wy[wid - 1] : eb;
  __syncthreads();  // wx, wy may be reused
}

// Step 2 for the slots [g0, g0 + gs), their minima in the rows 0..gs-1 of
// `mins` (row stride os): a thread a (slot, block of m windows); each walk
// loads kU hashes before it stores, so the loads overlap. kMark: mark in
// `diff` each window that differs from the one before it in some slot of
// the group (windows at an m-block start are compared by the caller).
template <bool kMark>
__device__ __forceinline__ void slide_slots(const u64* c, u64* mins, uint8_t* diff,
                                            int os, int nwc, int nk, int m, int k,
                                            int g0, int gs) {
  const u64 kseed = static_cast<u64>(k) * kMultiSeed;
  const int nblk = (nwc + m - 1) / m;
  for (int task = threadIdx.x; task < gs * nblk; task += blockDim.x) {
    const int slot = g0 + task % gs, b0 = (task / gs) * m;
    // slot_hash without a branch: slot 0 multiplies by 1, shifts nothing
    const u64 mult = slot ? (static_cast<u64>(slot) ^ kseed) : 1ULL;
    const u64 keep = slot ? ~0ULL : 0ULL;
    u64* mrow = mins + static_cast<size_t>(slot - g0) * os;
    const int jend = b0 + m - 1 < nk - 1 ? b0 + m - 1 : nk - 1;
    u64 sv = ~0ULL;
    int j = jend;
    for (; j >= nwc; --j) sv = umin64(sv, mix_slot(c[j], mult, keep));
    for (; j - (kU - 1) >= b0; j -= kU) {  // suffix minima of the block
      u64 h[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) h[u] = c[j - u];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        sv = umin64(sv, mix_slot(h[u], mult, keep));
        mrow[j - u] = sv;
      }
    }
    for (; j >= b0; --j) {
      sv = umin64(sv, mix_slot(c[j], mult, keep));
      mrow[j] = sv;
    }
    u64 pv = ~0ULL, prev = sv;  // prefix minima of the next block
    const int iend = b0 + m < nwc ? b0 + m : nwc;
    int i = b0 + 1;
    for (; i + kU <= iend; i += kU) {
      u64 h[kU], v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        h[u] = c[i + u + m - 1];
        v[u] = mrow[i + u];
      }
      bool changed[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        pv = umin64(pv, mix_slot(h[u], mult, keep));
        v[u] = umin64(v[u], pv);
        changed[u] = v[u] != prev;
        prev = v[u];
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        mrow[i + u] = v[u];
        if (kMark && changed[u]) diff[i + u] = 1;
      }
    }
    for (; i < iend; ++i) {
      pv = umin64(pv, mix_slot(c[i + m - 1], mult, keep));
      const u64 v = umin64(mrow[i], pv);
      mrow[i] = v;
      if (kMark && v != prev) diff[i] = 1;
      prev = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads) window_sketch_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ lens,
    const int32_t* __restrict__ tile_row, const int32_t* __restrict__ row_tile0,
    int L, int k, int s, int sg, int w, int tw,
    unsigned long long* __restrict__ tile_state,
    unsigned long long* __restrict__ tile_counter,
    int64_t* __restrict__ total, int64_t* __restrict__ row_counts,
    int32_t* __restrict__ out_row, int32_t* __restrict__ out_col,
    u64* __restrict__ out_sk) {
  extern __shared__ u64 smem[];
  __shared__ long long warp_sums[32];
  __shared__ u64 wx[32], wy[32];
  __shared__ int tile_sh;
  __shared__ long long agg_sh, base_sh;
  const int m = w - k + 1;
  const int os = tw + 1;  // row stride of the minima
  u64* mins = smem;
  const size_t n_mins = static_cast<size_t>(sg) * os, n_xy = 2 * static_cast<size_t>(tw + w + 1);
  u64* c = mins + (n_mins > n_xy ? n_mins : n_xy);
  int32_t* rs_list = reinterpret_cast<int32_t*>(c + tw + m);
  uint8_t* diff = reinterpret_cast<uint8_t*>(rs_list + tw);

  if (threadIdx.x == 0) tile_sh = static_cast<int>(atomicAdd(tile_counter, 1ULL));
  __syncthreads();
  const int tile = tile_sh;
  const int r = tile_row[tile];
  const int t0 = (tile - row_tile0[r]) * tw;
  const int nw = lens[r] - w + 1;  // valid windows of the row
  const int nt = nw - t0 < tw ? nw - t0 : tw;  // emitted, at least 1
  const int halo = t0 > 0 ? 1 : 0;
  const int a0 = t0 - halo;     // first window computed
  const int nwc = nt + halo;    // windows computed
  const int nk = nwc + m - 1;   // their k-mers
  const int nb = nk + k - 1;    // their bases

  // 1. canonical hashes in O(1) a k-mer from the exclusive prefix-XORs
  //    X of gf(p) = ror(seed[b_p], p) and Y of gr(p) = rol(seed_rc[b_p], p)
  //    over the tile's bases (nthash.cuh): each thread XORs a run of
  //    consecutive bases, one block scan, then each k-mer at once
  const uint8_t* src = codes + static_cast<size_t>(r) * L + a0;
  u64* X = mins;
  u64* Y = mins + nb + 1;
  const int per_b = (nb + blockDim.x - 1) / blockDim.x;
  const int p0 = threadIdx.x * per_b;
  const int p1 = p0 + per_b < nb ? p0 + per_b : nb;
  u64 fx = 0, fy = 0;
  for (int p = p0; p < p1; ++p) {
    const unsigned b = src[p];
    fx ^= rotr64(seed_of(b), p);
    fy ^= rotl64(seed_rc_of(b), p);
  }
  block_xor_scan2(fx, fy, wx, wy);
  for (int p = p0; p < p1; ++p) {
    X[p] = fx;
    Y[p] = fy;
    const unsigned b = src[p];
    fx ^= rotr64(seed_of(b), p);
    fy ^= rotl64(seed_rc_of(b), p);
  }
  if (p0 < nb && p1 == nb) {
    X[nb] = fx;
    Y[nb] = fy;
  }
  for (int i = threadIdx.x; i < nwc; i += blockDim.x) diff[i] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < nk; j += blockDim.x)
    c[j] = umin64(rotl64(X[j + k] ^ X[j], j + k - 1), rotr64(Y[j + k] ^ Y[j], j));
  __syncthreads();  // the minima overwrite X and Y

  // 2. sliding minima, all s slots at once (sg == s), or in groups of sg
  //    slots whose change marks are ORed, windows at an m-block start
  //    compared group by group (their minima are overwritten by the next)
  const bool grouped = sg < s;
  for (int g0 = 0; g0 < s; g0 += sg) {
    const int gs = s - g0 < sg ? s - g0 : sg;
    slide_slots<true>(c, mins, diff, os, nwc, nk, m, k, g0, gs);
    __syncthreads();
    if (grouped) {
      for (int i = m + threadIdx.x * m; i < nwc; i += blockDim.x * m) {
        bool f = false;
        for (int slot = 0; slot < gs && !f; ++slot)
          f = mins[static_cast<size_t>(slot) * os + i] !=
              mins[static_cast<size_t>(slot) * os + i - 1];
        if (f) diff[i] = 1;
      }
      __syncthreads();
    }
  }

  // 3. flags (a thread a run of consecutive windows), ranks, look-back
  const int per = (tw + blockDim.x - 1) / blockDim.x;
  const int e0 = threadIdx.x * per;
  int cnt = 0;
  unsigned fbits = 0;
  for (int q = 0; q < per; ++q) {
    const int e = e0 + q;
    if (e >= nt) break;
    const int i = e + halo;
    bool f = (a0 + i == 0) || diff[i];
    if (!grouped && !f && i > 0 && i % m == 0)
      for (int slot = 0; slot < s && !f; ++slot)
        f = mins[static_cast<size_t>(slot) * os + i] !=
            mins[static_cast<size_t>(slot) * os + i - 1];
    fbits |= static_cast<unsigned>(f) << q;
    cnt += f;
  }
  const long long incl = block_inclusive_scan(cnt, warp_sums);
  if (threadIdx.x == blockDim.x - 1) agg_sh = incl;  // the tile's count
  __syncthreads();
  const long long agg = agg_sh;

  if (threadIdx.x < 32) {  // decoupled look-back, warp 0
    const int lane = threadIdx.x;
    volatile unsigned long long* st = tile_state;
    if (lane == 0)
      st[tile] = (tile == 0 ? kInclusive : kAggregate) | static_cast<u64>(agg);
    long long excl = 0;
    int look = tile - 1;  // the newest tile not yet summed
    while (look >= 0) {
      const int pred = look - lane;
      u64 v = kInclusive;  // past tile 0: an inclusive prefix of 0
      if (pred >= 0) {
        do { v = st[pred]; } while ((v >> 62) == 0);
      }
      const unsigned incl_mask = __ballot_sync(0xffffffffu, (v >> 62) == 2);
      const int stop = __ffs(incl_mask) - 1;  // nearest inclusive prefix
      const bool take = stop < 0 || lane <= stop;
      long long add = take ? static_cast<long long>(v & kValueMask) : 0;
      for (int o = 16; o > 0; o >>= 1) add += __shfl_xor_sync(0xffffffffu, add, o);
      excl += add;
      look = stop >= 0 ? -1 : look - 32;
    }
    if (lane == 0) {
      if (tile > 0) st[tile] = kInclusive | static_cast<u64>(excl + agg);
      base_sh = excl;
      if (agg > 0)
        atomicAdd(reinterpret_cast<unsigned long long*>(row_counts) + r,
                  static_cast<unsigned long long>(agg));
      if (tile == static_cast<int>(gridDim.x) - 1) total[0] = excl + agg;
    }
  }
  __syncthreads();
  const long long base = base_sh;

  long long o = incl - cnt;  // this thread's first rank in the tile
  for (int q = 0; q < per; ++q) {
    if (!((fbits >> q) & 1)) continue;
    const int e = e0 + q;
    rs_list[o] = e + halo;
    out_row[base + o] = r;
    out_col[base + o] = t0 + e;
    ++o;
  }
  __syncthreads();
  u64* dst = out_sk + static_cast<size_t>(base) * s;
  if (!grouped) {
    const int n_out = static_cast<int>(agg) * s;  // at most tw * s
    for (int x = threadIdx.x; x < n_out; x += blockDim.x) {
      const int q = x / s, slot = x - q * s;
      dst[x] = mins[static_cast<size_t>(slot) * os + rs_list[q]];
    }
    return;
  }
  // groups: each group's minima once more, its slots of the run starts
  for (int g0 = 0; g0 < s; g0 += sg) {
    const int gs = s - g0 < sg ? s - g0 : sg;
    slide_slots<false>(c, mins, diff, os, nwc, nk, m, k, g0, gs);
    __syncthreads();
    const int n_out = static_cast<int>(agg) * gs;
    for (int x = threadIdx.x; x < n_out; x += blockDim.x) {
      const int q = x / gs, slot = x - q * gs;
      dst[static_cast<size_t>(q) * s + g0 + slot] =
          mins[static_cast<size_t>(slot) * os + rs_list[q]];
    }
    __syncthreads();  // the next group overwrites the minima
  }
}

// The dynamic shared memory a block may take on the current device (the
// opt-in limit less the kernel's static shared memory), with the kernel's
// attribute raised to it.
cudaError_t dynamic_limit(size_t* limit) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa{};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, window_sketch_kernel);
  if (err != cudaSuccess) return err;
  *limit = optin - fa.sharedSizeBytes;
  return cudaFuncSetAttribute(window_sketch_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*limit));
}

// Whether a tile of tw windows and sg slots at once fits `limit` with at
// least `want` blocks an SM (the occupancy query counts the static and the
// per-block reserved shared memory).
cudaError_t tile_fits(int tw, int sg, int k, int w, int want, size_t limit,
                      bool* fits) {
  const size_t smem = tile_smem(tw, sg, k, w);
  int blocks = 0;
  *fits = false;
  if (smem > limit) return cudaSuccess;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, window_sketch_kernel, kThreads, smem);
  *fits = err == cudaSuccess && blocks >= want;
  return err;
}

// The slots a tile of tw windows takes at once: all s when they fit,
// else the most that let two blocks share an SM, else the most that fit
// one block (a binary search; fewer slots never take more memory); 0
// when not one slot fits.
cudaError_t slot_group(int tw, int k, int s, int w, size_t limit, int* sg) {
  *sg = tile_smem(tw, s, k, w) <= limit ? s : 0;
  cudaError_t err = cudaSuccess;
  for (int want = 2; want >= 1 && *sg == 0 && err == cudaSuccess; --want) {
    int lo = 0, hi = s - 1;  // the most that fit lies in [lo, hi]
    while (lo < hi && err == cudaSuccess) {
      const int mid = (lo + hi + 1) / 2;
      bool fits = false;
      err = tile_fits(tw, mid, k, w, want, limit, &fits);
      if (fits) lo = mid; else hi = mid - 1;
    }
    *sg = lo;
  }
  return err;
}

// The windows a tile for (k, s, w) on the current device: the widest of
// kTileWidths whose s slots at once let two blocks share an SM, else the
// widest whose s slots fit one block; where no tile holds every slot, the
// widest that holds a slot group of two blocks an SM, else of one (the
// kernel then runs the slots in groups: slot_group).
cudaError_t pick_tile(int k, int s, int w, size_t limit, int* tw_out) {
  cudaError_t err = cudaSuccess;
  *tw_out = 0;
  for (int groups = 0; groups <= 1; ++groups) {
    for (int want = 2; want >= 1 && err == cudaSuccess; --want) {
      for (const int tw : kTileWidths) {
        bool fits = false;
        err = tile_fits(tw, groups ? 1 : s, k, w, want, limit, &fits);
        if (err != cudaSuccess) break;
        if (fits) {
          *tw_out = tw;
          return cudaSuccess;
        }
      }
    }
  }
  return err;
}

}  // namespace

// The windows a tile for (k, s, w) on the current device (pick_tile); 0
// when no tile fits (a window too wide), -error on a CUDA error.
extern "C" long long groot_window_tile_width(long long k, long long s, long long w) {
  if (k < 1 || w < k || s < 1 || w > INT32_MAX || s > INT32_MAX) return 0;
  size_t limit = 0;
  int tw = 0;
  cudaError_t err = dynamic_limit(&limit);
  if (err == cudaSuccess)
    err = pick_tile(static_cast<int>(k), static_cast<int>(s), static_cast<int>(w), limit, &tw);
  return err == cudaSuccess ? tw : -static_cast<long long>(err);
}

// The slots a tile of tw windows takes at once for (k, s, w) on the
// current device (slot_group; s when they all fit), -error on a CUDA error.
extern "C" long long groot_window_slot_group(long long k, long long s, long long w,
                                             long long tw) {
  if (k < 1 || w < k || s < 1 || tw < 1 || w > INT32_MAX || s > INT32_MAX ||
      tw > 32 * kThreads)
    return 0;
  size_t limit = 0;
  int sg = 0;
  cudaError_t err = dynamic_limit(&limit);
  if (err == cudaSuccess)
    err = slot_group(static_cast<int>(tw), static_cast<int>(k), static_cast<int>(s),
                     static_cast<int>(w), limit, &sg);
  return err == cudaSuccess ? sg : -static_cast<long long>(err);
}

// tile_row: int32 [n], the row of each tile; row_tile0: int32 [R], the
// first tile of each row; tile_state: n + 1 zeroed words (the tiles'
// states, then the tile counter); total: int64 [1] (M); row_counts: zeroed
// int64 [R]. A tile of tw windows takes sg of the s slots at once
// (groot_window_tile_width, groot_window_slot_group), in groups when
// sg < s; cudaErrorInvalidValue when that passes the shared memory.
extern "C" int groot_window_sketch(
    const void* codes, const void* lens, const void* tile_row,
    const void* row_tile0, int R, int L, int k, int s, int w, int tw, int sg,
    int n, void* tile_state, void* total, void* row_counts, void* out_row,
    void* out_col, void* out_sk, void* stream) {
  if (R < 1 || n < 1 || tw < 1 || tw > 32 * kThreads || k < 1 || w < k ||
      L < w || s < 1 || sg < 1 || sg > s)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tile_smem(tw, sg, k, w);
  if (smem > 48 * 1024) {  // past the default: ask the card
    size_t limit = 0;
    const cudaError_t err = dynamic_limit(&limit);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      window_sketch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned long long* state = static_cast<unsigned long long*>(tile_state);
  window_sketch_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(tile_row), static_cast<const int32_t*>(row_tile0),
      L, k, s, sg, w, tw, state, state + n, static_cast<int64_t*>(total),
      static_cast<int64_t*>(row_counts), static_cast<int32_t*>(out_row),
      static_cast<int32_t*>(out_col), static_cast<u64*>(out_sk));
  return static_cast<int>(cudaGetLastError());
}
