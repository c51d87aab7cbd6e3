// Batched EM over graph equivalence classes: one graph per block, each
// block running its graph's whole EM loop with no host round trip.
//
// Replaces groot_tpu/em/em.py::_run_em_batched (and _run_em, its one-graph
// form), an XLA while_loop over a dense padded [G, E, P] membership whose
// every round is two batched matmuls and whose loop runs until the slowest
// graph is done, the others frozen. Here each block stops at its own
// graph's last round, which gives the frozen lanes' result. Per round, in
// float32 as the reference computes:
//   denom[e] = sum of alpha over the ec's paths; cn[e] = count[e] / max(denom,
//              TOLERANCE) if count[e] != 0 and denom >= TOLERANCE, else 0
//   next[p]  = alpha[p] * sum of cn over the path's ecs
//   changed  = some path has next > 1e-2 and |next - alpha| / max(next,
//              1e-30) > 1e-2
//   stop     = !changed && it > min_it; entering the final round zeroes the
//              alphas under 1e-8; the round after the final one is the last.
// TOLERANCE is float64 epsilon, 2^-52, exact in float32.
//
// What bounds it on the card: the chain of dependent rounds. A graph needs
// up to ~1,200 rounds and graphs are independent blocks, so the batch costs
// its slowest graph's rounds times the latency of one round; the arithmetic
// is far below the card's rate. The design cuts the latency of a round:
// - The wrapper (em/em.py::em_layout) puts each graph's live ecs (count != 0,
//   some path) first. An ec with count 0 adds 0.0f to every path sum, so
//   leaving it out changes no bit. Everything a round reads is staged in
//   shared memory once, before the loop.
// - Mask route, a graph of at most 32 path lanes (its `width`: its path
//   count, or its highest member lane + 1 if larger): each ec is a 32-bit
//   path mask and every thread holds all alphas in registers. denom[e] adds
//   the mask's alphas in ascending path order (a clear bit adds nothing), the
//   same float sequence as a sum over the ec's path list. Each thread adds
//   its ecs' cn into per-path float64 partials in registers; a butterfly
//   reduce-scatter leaves one path's warp sum in each lane; per-warp sums go
//   to a double-buffered shared array behind ONE barrier a round, and every
//   warp sums them in the same order, so every lane computes the same next
//   alphas and the same `changed` (a warp vote) with no second barrier. The
//   graph uses a thread a live ec, up to the block's warps; the others leave
//   after staging, and the round's barrier counts only the working threads.
//   The block has as many threads as keep all the batch's blocks resident
//   at once (cudaOccupancy*), so no graph waits for another's rounds.
// - CSR route, a wider graph: ec -> paths and path -> ecs CSR in shared
//   memory when they fit (else read from device memory), alpha and next
//   double-buffered so that there is no copy pass: the ecs' quotients over
//   all threads, a barrier, then groups of lanes of a width that spreads the
//   paths over all threads sum each path's quotients, and __syncthreads_or
//   both gives `changed` and ends the round: two barriers a round. The final
//   round's zeroing is applied where the next round reads the alphas.
// - Large graphs: a mask-route graph whose live ecs' masks and counts do
//   not fit the block's shared memory beside the warp sums reads them from
//   the layout in device memory (they are read-only); a CSR-route graph
//   whose counts, quotients and alphas do not fit reads its counts from
//   the layout and keeps its quotients and alphas in its own slice of a
//   scratch the wrapper allocates (float32 [G][E + 2 P]). The rounds are
//   the same; their loads go through L1 and L2.
// The path sums add float32 quotients in float64 and round once: a float32
// sum over hundreds of ecs in another order than the reference's drifts
// past 1e-5 over hundreds of rounds (seen in a CPU emulation of this
// kernel), a float64 one stays within the reference's own rounding. Alphas
// may differ in their last bits (the tests hold them to 1e-5 of max(1,
// |alpha|)); iteration counts are equal. Denominators are float32 sums.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTolerance = 2.220446049250313e-16f;  // TOLERANCE, em.go:11
constexpr float kAlphaZero = 1e-8f;                     // ALPHA_LIMIT / 10
constexpr float kChangeLimit = 1e-2f;                   // ALPHA_CHANGE_LIMIT
constexpr float kChange = 1e-2f;                        // ALPHA_CHANGE
constexpr float kTiny = 1e-30f;
constexpr int kEcsPerThread = 1;  // live ecs a mask-route thread aims at
constexpr int kWpartWords = 4 * 32 * 32;  // the mask route's warp sums
constexpr unsigned kFull = 0xffffffffu;

struct Layout {
  const int32_t* mask;      // [G, E] path mask of each ec, live ecs first
  const float* cnt;         // [G, E] counts in the same order
  const int32_t* n_live;    // [G]
  const int32_t* width;     // [G] path lanes the graph uses
  const int32_t* n_paths;   // [G]
  // CSR of the graphs of more than 32 lanes (else unused): per graph local
  // offsets [G, E + 1] / [G, P + 1] into its segment of the flat lists
  const int32_t* ec_ptr;     // live ec -> path lanes, ascending
  const int64_t* ec_base;    // [G] start of the graph's segment
  const int32_t* ec_paths;
  const int32_t* path_ptr;   // path lane -> live ec index, ascending
  const int64_t* path_base;  // [G]
  const int32_t* path_ecs;
};

__device__ __forceinline__ void named_barrier(int n_threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(n_threads) : "memory");
}

__device__ __forceinline__ bool alpha_changed(float na, float a) {
  return na > kChangeLimit && fabsf(na - a) / fmaxf(na, kTiny) > kChange;
}

__device__ __forceinline__ float quotient(float c, float d) {
  return c != 0.0f && d >= kTolerance ? c / fmaxf(d, kTolerance) : 0.0f;
}

// One butterfly step of width O and the steps below it, all indices known
// at compile time (the values stay in registers): lanes with bit O set keep
// the upper half of v[0, 2 O), the others the lower half.
template <int O, int NP>
__device__ __forceinline__ void reduce_scatter_step(double (&v)[NP], int lane) {
  if constexpr (O >= 1) {
    const bool upper = lane & O;
#pragma unroll
    for (int i = 0; i < O; ++i) {
      const double send = upper ? v[i] : v[i + O];
      const double keep = upper ? v[i + O] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, O);
    }
    reduce_scatter_step<O / 2, NP>(v, lane);
  }
}

// Butterfly reduce-scatter of NP per-lane values: lane l returns the warp's
// sum of v[l & (NP - 1)].
template <int NP>
__device__ __forceinline__ double reduce_scatter(double (&v)[NP], int lane) {
  reduce_scatter_step<NP / 2, NP>(v, lane);
  double s = v[0];
#pragma unroll
  for (int o = NP; o < 32; o <<= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// The mask route; threads >= 32 * n_warps have already left.
template <int NP>
__device__ void em_masks(const uint32_t* smask, const float* scnt, int n_live,
                         int n, int n_warps, double* wpart, int min_it,
                         int max_it, int P, int* it_out, float* a_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_thr = 32 * n_warps;
  const float nf = fmaxf(static_cast<float>(n), 1.0f);
  const int my_p = lane & (NP - 1);
  float alpha[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) alpha[p] = p < n ? 1.0f / nf : 0.0f;
  float a_lane = my_p < n ? 1.0f / nf : 0.0f;

  int it = 0, buf = 0;
  bool final_round = false, done = false;
  while (!done && it < max_it) {
    double part[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) part[p] = 0.0;
    for (int e = threadIdx.x; e < n_live; e += n_thr) {
      const uint32_t m = smask[e];
      float d = 0.0f;
#pragma unroll
      for (int p = 0; p < NP; ++p)
        if (m >> p & 1u) d += alpha[p];
      const float cn = quotient(scnt[e], d);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        if (m >> p & 1u) part[p] += cn;
    }
    const double ws = reduce_scatter<NP>(part, lane);
    double* wp = wpart + buf * (32 * 32);
    if (lane < NP) wp[warp * 32 + lane] = ws;
    named_barrier(n_thr);
    double sum = 0.0;
    for (int w = 0; w < n_warps; ++w) sum += wp[w * 32 + my_p];
    float na = __fmul_rn(a_lane, __double2float_rn(sum));
    const bool changed = __any_sync(kFull, alpha_changed(na, a_lane));
    const bool stop = !changed && it > min_it;
    const bool enter_final = stop && !final_round;
    done = final_round;  // the round just run was the final one
    if (enter_final && na < kAlphaZero) na = 0.0f;
    a_lane = na;
#pragma unroll
    for (int p = 0; p < NP; ++p) alpha[p] = __shfl_sync(kFull, na, p);
    ++it;
    final_round = final_round || enter_final;
    buf ^= 1;
  }
  if (threadIdx.x == 0) *it_out = it;
  if (warp == 0 && lane < P) a_out[lane] = lane < NP ? a_lane : 0.0f;
}

// The CSR route: every thread of the block takes part.
__device__ void em_csr(const int32_t* ep, const int32_t* eps,
                       const int32_t* pp, const int32_t* pes,
                       const float* scnt, int n_live, int n, int width,
                       float* abuf, float* cn, int min_it, int max_it,
                       int* it_out, float* a_out) {
  const int T = blockDim.x;
  int gs = 32;  // lanes a path: the widest power of two that covers the paths
  while (gs > 1 && (T / gs) < width) gs >>= 1;
  const int n_groups = T / gs;
  const int gid = threadIdx.x / gs, gl = threadIdx.x % gs;
  const float nf = fmaxf(static_cast<float>(n), 1.0f);
  for (int p = threadIdx.x; p < width; p += T) abuf[p] = p < n ? 1.0f / nf : 0.0f;
  __syncthreads();

  int it = 0, cur = 0;
  bool final_round = false, done = false, zero = false;
  while (!done && it < max_it) {
    const float* a = abuf + cur * width;
    float* nx = abuf + (cur ^ 1) * width;
    for (int e = threadIdx.x; e < n_live; e += T) {
      float d = 0.0f;
      for (int q = ep[e]; q < ep[e + 1]; ++q) {
        const float v = a[eps[q]];
        d += zero && v < kAlphaZero ? 0.0f : v;
      }
      cn[e] = quotient(scnt[e], d);
    }
    __syncthreads();
    int changed = 0;
    for (int base = 0; base < width; base += n_groups) {
      const int p = base + gid;
      double sum = 0.0;
      if (p < width)
        for (int q = pp[p] + gl; q < pp[p + 1]; q += gs) sum += cn[pes[q]];
      for (int o = gs / 2; o >= 1; o >>= 1)
        sum += __shfl_xor_sync(kFull, sum, o);
      if (p < width && gl == 0) {
        float av = a[p];
        if (zero && av < kAlphaZero) av = 0.0f;
        const float na = __fmul_rn(av, __double2float_rn(sum));
        nx[p] = na;
        changed |= alpha_changed(na, av);
      }
    }
    changed = __syncthreads_or(changed);
    const bool stop = !changed && it > min_it;
    const bool enter_final = stop && !final_round;
    done = final_round;
    zero = enter_final;  // read the next alphas with the final round's zeroing
    ++it;
    final_round = final_round || enter_final;
    cur ^= 1;
  }
  if (threadIdx.x == 0) *it_out = it;
  const float* a = abuf + cur * width;
  for (int p = threadIdx.x; p < width; p += T) {
    const float v = a[p];
    a_out[p] = zero && v < kAlphaZero ? 0.0f : v;
  }
}

// Shared memory of a CSR-route graph, in 4-byte words: cnt, cn and two
// alpha buffers always; the local CSR when `with_csr`.
__device__ __forceinline__ long long csr_words(long long n_live, long long width,
                                              long long nnz, bool with_csr) {
  long long w = 2 * n_live + 2 * width;
  if (with_csr) w += (n_live + 1) + nnz + (width + 1) + nnz;
  return w;
}

// kLarge: a batch whose graphs may not fit smem_words (E ecs' masks and
// counts, 2 E words, and the warp sums do not; or a CSR graph needs the
// scratch): each block then stages its graph only when it fits, and reads
// the layout in device memory, or keeps its CSR quotients and alphas in
// the scratch, when it does not (a template, so that batches that fit
// keep the code, and the registers, of a kernel that always stages).
template <int NP, bool kLarge>
__global__ void em_batched_kernel(Layout L, int E, int P, int min_it,
                                  int max_it, long long smem_words,
                                  int32_t* __restrict__ it_out,
                                  float* __restrict__ alpha_out,
                                  float* __restrict__ scratch) {
  extern __shared__ float sm[];
  const int g = blockIdx.x;
  const size_t row = static_cast<size_t>(g) * E;
  const int n_live = L.n_live[g];
  const int width = L.width[g];
  const int n = L.n_paths[g];
  float* a_out = alpha_out + static_cast<size_t>(g) * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) a_out[p] = 0.0f;

  if (width <= 32) {
    const bool staged = !kLarge || 2LL * n_live + kWpartWords <= smem_words;
    const int span = kLarge ? n_live : E;  // the staged arrays' length
    uint32_t* smask = reinterpret_cast<uint32_t*>(sm);
    float* scnt = sm + span;
    // [2][32][32] warp sums, after the staged masks and counts
    double* wpart = reinterpret_cast<double*>(sm + (staged ? 2 * span : 0));
    if (staged) {
      for (int e = threadIdx.x; e < n_live; e += blockDim.x) {
        smask[e] = static_cast<uint32_t>(L.mask[row + e]);
        scnt[e] = L.cnt[row + e];
      }
    }
    __syncthreads();
    int n_warps = (n_live + 32 * kEcsPerThread - 1) / (32 * kEcsPerThread);
    n_warps = n_warps < 1 ? 1 : n_warps;
    n_warps = n_warps > static_cast<int>(blockDim.x >> 5)
                  ? static_cast<int>(blockDim.x >> 5) : n_warps;
    if (static_cast<int>(threadIdx.x >> 5) >= n_warps) return;
    __syncwarp();
    if (staged)
      em_masks<NP>(smask, scnt, n_live, n, n_warps, wpart, min_it, max_it, P,
                   it_out + g, a_out);
    else  // the layout's masks and counts, read from device memory
      em_masks<NP>(reinterpret_cast<const uint32_t*>(L.mask + row), L.cnt + row,
                   n_live, n, n_warps, wpart, min_it, max_it, P, it_out + g, a_out);
    return;
  }

  // CSR route: the graph's local CSR, staged when it fits
  const int32_t* ep = L.ec_ptr + static_cast<size_t>(g) * (E + 1);
  const int32_t* eps = L.ec_paths + L.ec_base[g];
  const int32_t* pp = L.path_ptr + static_cast<size_t>(g) * (P + 1);
  const int32_t* pes = L.path_ecs + L.path_base[g];
  const int nnz = ep[n_live];
  if constexpr (kLarge) {
    if (csr_words(n_live, width, nnz, false) > smem_words) {
      // counts from the layout, quotients and alphas in the graph's scratch
      float* cn = scratch + static_cast<size_t>(g) * (E + 2 * P);
      em_csr(ep, eps, pp, pes, L.cnt + row, n_live, n, width, cn + E, cn, min_it,
             max_it, it_out + g, a_out);
      return;
    }
  }
  float* scnt = sm;
  float* cn = scnt + n_live;
  float* abuf = cn + n_live;
  for (int e = threadIdx.x; e < n_live; e += blockDim.x) scnt[e] = L.cnt[row + e];
  if (csr_words(n_live, width, nnz, true) <= smem_words) {
    int32_t* s_ep = reinterpret_cast<int32_t*>(abuf + 2 * width);
    int32_t* s_eps = s_ep + n_live + 1;
    int32_t* s_pp = s_eps + nnz;
    int32_t* s_pes = s_pp + width + 1;
    for (int e = threadIdx.x; e <= n_live; e += blockDim.x) s_ep[e] = ep[e];
    for (int p = threadIdx.x; p <= width; p += blockDim.x) s_pp[p] = pp[p];
    for (int q = threadIdx.x; q < nnz; q += blockDim.x) {
      s_eps[q] = eps[q];
      s_pes[q] = pes[q];
    }
    ep = s_ep, eps = s_eps, pp = s_pp, pes = s_pes;
  }
  __syncthreads();
  em_csr(ep, eps, pp, pes, scnt, n_live, n, width, abuf, cn, min_it, max_it,
         it_out + g, a_out);
}

// The block's thread count: at most `want`, and as many as let all G
// blocks be resident at once (a graph's rounds then start at launch, not
// behind another graph's), never fewer than 32; a CUDA error as -code.
template <typename Kern>
int block_threads(Kern kern, int want, size_t smem, int G) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaFuncAttributes attr;
  int dev = 0, sms = 0;
  if ((err = cudaFuncGetAttributes(&attr, kern)) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return -static_cast<int>(err);
  int t = want < attr.maxThreadsPerBlock ? want : attr.maxThreadsPerBlock & ~31;
  for (; t > 32; t -= 32) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, t, smem);
    if (err != cudaSuccess) return -static_cast<int>(err);
    if (static_cast<long long>(per_sm) * sms >= G) break;
  }
  return t;
}

// The shared memory a block, in 4-byte words, for a batch of E ecs whose
// widest CSR-route graph's counts, quotients and alphas take `least` words
// (2 n_live + 2 width) and whose largest CSR graph that fits staged whole
// takes `fits`: the most of those and the mask route's masks, counts and
// warp sums (2 E + kWpartWords), at most the card's opt-in limit.
cudaError_t plan_words(long long E, long long least, long long fits, long long* words) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  long long w = 2 * E + kWpartWords;
  w = w < least ? least : w;
  w = w < fits ? fits : w;
  *words = w < optin / 4 ? w : optin / 4;
  return err;
}

}  // namespace

// groot_em_batched's smem_words for a batch (plan_words), -error on a CUDA
// error.
extern "C" long long groot_em_smem_words(long long E, long long least, long long fits) {
  long long w = 0;
  const cudaError_t err = plan_words(E, least, fits, &w);
  return err == cudaSuccess ? w : -static_cast<long long>(err);
}

// The bytes of groot_em_batched's scratch for a batch of G graphs of E ecs
// and P path lanes: float32 [G, E + 2 P] when the widest CSR-route graph's
// `least` words pass smem_words (its graphs that do not fit keep their
// quotients and alphas there), else 0; -error on a CUDA error.
extern "C" long long groot_em_scratch_bytes(long long G, long long E, long long P,
                                            long long least, long long fits) {
  long long w = 0;
  const cudaError_t err = plan_words(E, least, fits, &w);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return least > w ? 4 * G * (E + 2 * P) : 0;
}

// smem_words and scratch from groot_em_smem_words and
// groot_em_scratch_bytes (null when that is 0).
extern "C" int groot_em_batched(
    const void* mask, const void* cnt, const void* n_live, const void* width,
    const void* n_paths, const void* ec_ptr, const void* ec_base,
    const void* ec_paths, const void* path_ptr, const void* path_base,
    const void* path_ecs, int G, int E, int P, int NP, int threads,
    long long smem_words, int min_it, int max_it, void* it_out,
    void* alpha_out, void* scratch, void* stream) {
  if (G == 0) return 0;
  if (G < 0 || E < 0 || P < 1 || threads < 32 || threads > 1024 ||
      threads % 32 || smem_words < kWpartWords)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L{static_cast<const int32_t*>(mask),
                 static_cast<const float*>(cnt),
                 static_cast<const int32_t*>(n_live),
                 static_cast<const int32_t*>(width),
                 static_cast<const int32_t*>(n_paths),
                 static_cast<const int32_t*>(ec_ptr),
                 static_cast<const int64_t*>(ec_base),
                 static_cast<const int32_t*>(ec_paths),
                 static_cast<const int32_t*>(path_ptr),
                 static_cast<const int64_t*>(path_base),
                 static_cast<const int32_t*>(path_ecs)};
  const size_t smem = 4 * static_cast<size_t>(smem_words);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* it = static_cast<int32_t*>(it_out);
  float* al = static_cast<float*>(alpha_out);
  float* sc = static_cast<float*>(scratch);
  const bool large = 2LL * E + kWpartWords > smem_words || scratch != nullptr;
#define GROOT_EM_LAUNCH(NPV, LARGE)                                             \
  do {                                                                          \
    const int t = block_threads(em_batched_kernel<NPV, LARGE>, threads, smem, G); \
    if (t < 0) return -t;                                                       \
    em_batched_kernel<NPV, LARGE><<<G, t, smem, st>>>(L, E, P, min_it, max_it,  \
                                                      smem_words, it, al, sc);  \
  } while (0)
  switch (NP * 2 + large) {
    case 16: GROOT_EM_LAUNCH(8, false); break;
    case 17: GROOT_EM_LAUNCH(8, true); break;
    case 32: GROOT_EM_LAUNCH(16, false); break;
    case 33: GROOT_EM_LAUNCH(16, true); break;
    case 64: GROOT_EM_LAUNCH(32, false); break;
    case 65: GROOT_EM_LAUNCH(32, true); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GROOT_EM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
