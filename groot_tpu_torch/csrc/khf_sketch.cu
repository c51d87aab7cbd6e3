// KHF MinHash sketch of a read batch: u8 codes [B, L] -> u64 [B, s].
//
// Replaces groot_tpu/ops/pallas_sketch.py::khf_sketch_pallas (the Pallas
// kernel; its body is _kernel). It computes what that kernel computes, not
// its TPU block structure: the TPU version works on (hi, lo) uint32 pairs,
// a Hillis-Steele prefix-XOR over lanes and staged rotates, because the TPU
// has no 64-bit integers. Here every value is a native u64.
//
// What bounds it on the card: integer issue, not memory. A 150 bp read is
// 150 bytes in and s*8 bytes out, against (L-k+1)*s multiply-xorshifts. The
// first design hashed every k-mer from scratch in O(k) with divergent
// __constant__ seed loads, ran a 128-thread block a read (8 threads idle at
// k31 L150) and reduced each slot with a shuffle tree and a shared atomic.
//
// Design: a warp walks its bases 32 at a time. Each lane picks its base's
// seeds by selects, rotates them by the position (nthash.cuh: X, Y), an
// inclusive warp XOR-scan with the carry of the chunk before gives the
// prefixes X[j+1], Y[j+1] at once, and the lane whose base ends a k-mer
// reads X[i], Y[i] back from the warp's ring in shared memory (next_pow2(k
// + 32) entries, so any k up to kMaxK fits): O(1) a k-mer after the O(L)
// scan. The chunks are placed so that one starts at the warp's first k-mer
// end, and every lane of a later chunk ends a k-mer; each chunk's codes
// are loaded one chunk ahead. Each lane keeps the minimum of each slot over
// its own k-mers in registers (s rounded up to a multiple of 4, a template,
// so that the slot loop tests nothing at run time), and one butterfly
// reduce-scatter across the warp at the end leaves every slot's minimum in
// one lane. Short reads (the main path's 150 bp) take a warp a
// read, up to kReadsPerBlock reads a block, with no block barrier. A read
// of kSplitL bases or more would leave one warp a chain of thousands of
// chunks, so a block of up to kSplitWarps warps splits its k-mers into
// chunk-aligned segments: each warp first XORs the terms of its share of
// the bases, the block exchanges those sums for each warp's starting X and
// Y, each warp scans from k-1 bases before its segment, and the warps'
// slot minima meet in shared memory. k-mers starting at or past
// valid_len-k+1 are left out, which equals masking them to all-ones; a
// read with no valid k-mer sketches to all-ones in every slot.
// Sketches of more than kMaxSlots slots split the slots into G =
// ceil(s / 64) groups of at most 64 (gridDim.y = G, the group's slots
// rounded up to a multiple of 4, at least 36, a template of its own): each
// group's blocks rescan their reads, an O(L) scan against the (L-k+1)*64
// multiply-xorshifts of the group, and keep that group's minima in
// registers as above; the groups write disjoint slots of the same rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "nthash.cuh"

namespace {

constexpr int kMaxSlots = 64;
constexpr int kMaxK = 1024;
constexpr int kReadsPerBlock = 4;  // warps a block on short reads
constexpr int kSplitWarps = 8;     // warps that share a long read
constexpr int kSplitL = 1024;      // reads this long are split
constexpr int kSmemBudget = 48 * 1024;  // static launch limit of shared memory
constexpr int kSpread = 132;            // blocks to aim for (the H100's SMs)
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

// Reduce-scatter of the per-lane slot minima v[0..N) over the warp, then the
// store of slots < s: halving step t trades half of the values with lane ^
// 2^t and keeps the half that lane bit t selects, so after H steps lane l
// holds the slots whose index starts with the bits of l reversed; lanes that
// hold the same slots then take the minimum of one another's.
template <int N>
__device__ __forceinline__ void store_slot_minima(u64 (&v)[N], int lane,
                                                  int s, u64* dst) {
  constexpr int H = ilog2(N) < 5 ? ilog2(N) : 5;
  constexpr int kLeft = N >> H;  // values a lane keeps (2 when N = 64)
  int slot = 0;
#pragma unroll
  for (int t = 0; t < H; ++t) {
    const int half = N >> (t + 1);
    const bool upper = (lane >> t) & 1;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      if (i < half) {
        const u64 send = upper ? v[i] : v[i + half];
        const u64 keep = upper ? v[i + half] : v[i];
        v[i] = umin64(keep, __shfl_xor_sync(kFull, send, 1 << t));
      }
    }
    slot = 2 * slot + upper;
  }
#pragma unroll
  for (int o = 1 << H; o < 32; o <<= 1)
    v[0] = umin64(v[0], __shfl_xor_sync(kFull, v[0], o));
  if ((lane >> H) != 0) return;  // a copy of lane & (2^H - 1)'s slots
#pragma unroll
  for (int i = 0; i < kLeft; ++i) {
    const int m = slot * kLeft + i;
    if (m < s) dst[m] = v[i];
  }
}

// Slot minima a lane keeps: S4 = s rounded up to a multiple of 4 (a
// template, so the slot loop has no per-slot test), in an array of the next
// power of two for the reduce-scatter.
template <int S4>
constexpr int kSlotRegs = S4 <= 8 ? 8 : S4 <= 16 ? 16 : S4 <= 32 ? 32 : 64;

// s: the slots a block computes (its group's); s_row: the slots of an
// output row; kGrouped: slot group blockIdx.y starts at slot blockIdx.y * s
template <int S4, bool kSplit, bool kGrouped>
__global__ void __launch_bounds__(kSplitWarps * 32)
    khf_sketch_kernel(const uint8_t* __restrict__ codes,
                      const int32_t* __restrict__ valid_len,
                      u64* __restrict__ out, int B, int L, int k, int s,
                      int s_row, int ring) {
  // per warp an X ring and a Y ring; split: then the warps' slot minima
  // [warps][s] and their segment sums of X and Y [warps] each
  extern __shared__ u64 smem[];
  const int m0 = kGrouped ? static_cast<int>(blockIdx.y) * s : 0;  // first slot
  const int s_out = kGrouped ? imin(s, s_row - m0) : s;  // slots stored
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int b = kSplit ? blockIdx.x : blockIdx.x * warps + warp;
  if (b >= B) return;  // (not split) the whole warp leaves together
  const int mask = ring - 1;
  u64* rx = smem + static_cast<size_t>(warp) * 2 * ring;
  u64* ry = rx + ring;
  u64* part = smem + static_cast<size_t>(warps) * 2 * ring;
  u64* seg_x = part + warps * s;
  u64* seg_y = seg_x + warps;
  const uint8_t* row = codes + static_cast<size_t>(b) * L;
  int vl = valid_len[b];
  vl = vl < L ? vl : L;
  const int nk = vl - k + 1 > 0 ? vl - k + 1 : 0;  // valid k-mers
  const int span = nk + k - 1;                      // the bases they cover
  const int lead = 32 * ((k + 30) / 32);            // >= k - 1, whole chunks

  // this warp's k-mers end at bases [s0, s1); it scans from p0 = s0 - lead
  int s0 = k - 1, s1 = nk > 0 ? span : k - 1;
  u64 cx = 0, cy = 0;  // X, Y at base imax(p0, 0)
  if (kSplit) {
    const int seg = ((nk + warps - 1) / warps + 31) / 32 * 32;
    s0 = imin(k - 1 + warp * seg, s1);
    s1 = imin(s0 + seg, s1);
    // the bases [q(w), q(w+1)) of each warp w partition those before every
    // warp's scan start q(w) = clamp(p0(w), 0, span)
    const int q0 = imax(0, imin(s0 - lead, span));
    const int q1 = imax(0, imin(k - 1 + (warp + 1) * seg - lead, span));
    u64 tx = 0, ty = 0;
    for (int j = q0 + lane; j < q1; j += 32) {
      const unsigned c = row[j];
      tx ^= rotr64(seed_of(c), j);
      ty ^= rotl64(seed_rc_of(c), j);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      tx ^= __shfl_xor_sync(kFull, tx, o);
      ty ^= __shfl_xor_sync(kFull, ty, o);
    }
    if (lane == 0) {
      seg_x[warp] = tx;
      seg_y[warp] = ty;
    }
    __syncthreads();
    for (int w = 0; w < warp; ++w) {
      cx ^= seg_x[w];
      cy ^= seg_y[w];
    }
  }
  const u64 kseed = static_cast<u64>(k) * kMultiSeed;
  constexpr int N = kSlotRegs<S4>;
  u64 mins[N];
#pragma unroll
  for (int m = 0; m < N; ++m) mins[m] = ~0ULL;
  if (s1 > s0) {
    const int p0 = s0 - lead;
    if (lane == 0) {
      rx[imax(p0, 0) & mask] = cx;
      ry[imax(p0, 0) & mask] = cy;
    }
    int jn = p0 + lane;
    unsigned next = jn >= 0 && jn < s1 ? row[jn] : 4u;  // N: seed 0
    for (int c0 = p0; c0 < s1; c0 += 32) {
      const int j = c0 + lane;
      const unsigned c = next;
      jn = j + 32;
      next = jn >= 0 && jn < s1 ? row[jn] : 4u;
      u64 x = rotr64(seed_of(c), j);
      u64 y = rotl64(seed_rc_of(c), j);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const u64 tx = __shfl_up_sync(kFull, x, o);
        const u64 ty = __shfl_up_sync(kFull, y, o);
        if (lane >= o) {
          x ^= tx;
          y ^= ty;
        }
      }
      x ^= cx;  // X[j + 1]
      y ^= cy;
      if (j >= 0 && j < s1) {
        rx[(j + 1) & mask] = x;
        ry[(j + 1) & mask] = y;
      }
      cx = __shfl_sync(kFull, x, 31);
      cy = __shfl_sync(kFull, y, 31);
      __syncwarp();  // X[i] of a k-mer may come from this chunk
      if (j >= s0 && j < s1) {
        const int i = j + 1 - k;  // the k-mer that ends at base j
        const u64 f = rotl64(x ^ rx[i & mask], j);
        const u64 r = rotr64(y ^ ry[i & mask], i);
        const u64 h = umin64(f, r);
        if (kGrouped && m0 > 0) {  // slot m0 is a multihash slot too
          u64 g = h * (static_cast<u64>(m0) ^ kseed);
          g ^= g >> kMultiShift;
          mins[0] = umin64(mins[0], g);
        } else {
          mins[0] = umin64(mins[0], h);
        }
#pragma unroll
        for (int m = 1; m < S4; ++m) {  // slot_hash; slots >= s never stored
          u64 g = h * (static_cast<u64>(m0 + m) ^ kseed);
          g ^= g >> kMultiShift;
          mins[m] = umin64(mins[m], g);
        }
      }
      __syncwarp();  // the next chunk overwrites ring entries read here
    }
  }
  u64* dst = out + static_cast<size_t>(b) * s_row + m0;
  if (!kSplit) {
    store_slot_minima<N>(mins, lane, s_out, dst);
    return;
  }
  store_slot_minima<N>(mins, lane, s, part + warp * s);
  __syncthreads();
  for (int m = threadIdx.x; m < s_out; m += blockDim.x) {
    u64 v = part[m];
    for (int w = 1; w < warps; ++w) v = umin64(v, part[w * s + m]);
    dst[m] = v;
  }
}

// s: the slots a block computes (a group's when kGrouped, G groups);
// s_row: the slots of an output row
template <int S4, bool kGrouped>
cudaError_t launch(const uint8_t* codes, const int32_t* valid_len, u64* out,
                   int B, int L, int k, int s, int s_row, int G, cudaStream_t st) {
  if constexpr (S4 < kMaxSlots) {
    if (s > S4)
      return launch<S4 + 4, kGrouped>(codes, valid_len, out, B, L, k, s, s_row, G, st);
  }
  int ring = 64;
  while (ring < k + 32) ring <<= 1;
  const int ring_bytes = 2 * ring * static_cast<int>(sizeof(u64));
  const int split_bytes = ring_bytes + (s + 2) * static_cast<int>(sizeof(u64));
  const int split = imin(kSplitWarps, kSmemBudget / split_bytes);
  if (L >= kSplitL && split >= 2) {
    khf_sketch_kernel<S4, true, kGrouped>
        <<<dim3(B, G), split * 32, split * split_bytes, st>>>(
            codes, valid_len, out, B, L, k, s, s_row, ring);
  } else {
    // reads a block: fewer when the batch is too small to give every SM a
    // block, and no more rings than fit the shared budget
    int warps = imin(kReadsPerBlock, (B + kSpread - 1) / kSpread);
    warps = imin(warps, kSmemBudget / ring_bytes);
    const int blocks = (B + warps - 1) / warps;
    khf_sketch_kernel<S4, false, kGrouped>
        <<<dim3(blocks, G), warps * 32, warps * ring_bytes, st>>>(
            codes, valid_len, out, B, L, k, s, s_row, ring);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int groot_khf_sketch(const void* codes, const void* valid_len,
                                void* out, int B, int L, int k, int s,
                                void* stream) {
  if (B == 0) return 0;
  if (L < 1 || k < 1 || k > kMaxK || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const int32_t* v = static_cast<const int32_t*>(valid_len);
  u64* o = static_cast<u64*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s <= kMaxSlots)
    return static_cast<int>(launch<4, false>(c, v, o, B, L, k, s, s, 1, st));
  // groups of gs = ceil(s / G) slots, 32 < gs <= 64, so the first
  // template is 36
  const int G = (s + kMaxSlots - 1) / kMaxSlots;
  if (G > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int gs = (s + G - 1) / G;
  return static_cast<int>(launch<36, true>(c, v, o, B, L, k, gs, s, G, st));
}
