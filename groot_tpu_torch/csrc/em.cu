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
// Design: alpha[P], next[P], count[E] and cn[E] live in shared memory. The
// membership comes in CSR form both ways (ec -> paths, path -> ecs). Threads
// stride over the ecs for the denominators (a graph's ec has a few paths);
// a warp per path sums the quotients over the path's ecs with a shuffle
// reduction; __syncthreads_or gives the block's `changed`. The summation
// order differs from the reference's matmuls, so alphas may differ in their
// last bits (the tests hold them to 1e-5 relative).
//
// What bounds it on the card: latency. A round is a few hundred shared-
// memory loads per thread and three barriers; graphs are independent
// blocks, so the batch costs about its slowest graph's rounds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTolerance = 2.220446049250313e-16f;  // TOLERANCE, em.go:11
constexpr float kAlphaZero = 1e-8f;                     // ALPHA_LIMIT / 10
constexpr float kChangeLimit = 1e-2f;                   // ALPHA_CHANGE_LIMIT
constexpr float kChange = 1e-2f;                        // ALPHA_CHANGE
constexpr float kTiny = 1e-30f;

__global__ void em_batched_kernel(
    const int64_t* __restrict__ ec_ptr, const int32_t* __restrict__ ec_paths,
    const int64_t* __restrict__ path_ptr, const int32_t* __restrict__ path_ecs,
    const float* __restrict__ counts, const int32_t* __restrict__ n_paths,
    int E, int P, int min_it, int max_it, int32_t* __restrict__ it_out,
    float* __restrict__ alpha_out) {
  extern __shared__ float sm[];
  float* alpha = sm;
  float* nxt = alpha + P;
  float* cnt = nxt + P;
  float* cn = cnt + E;
  const int g = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int64_t* ep = ec_ptr + static_cast<size_t>(g) * E;
  const int64_t* pp = path_ptr + static_cast<size_t>(g) * P;

  const int n = n_paths[g];
  const float nf = fmaxf(static_cast<float>(n), 1.0f);
  for (int p = threadIdx.x; p < P; p += blockDim.x)
    alpha[p] = p < n ? 1.0f / nf : 0.0f;
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    cnt[e] = counts[static_cast<size_t>(g) * E + e];
  __syncthreads();

  int it = 0;
  bool final_round = false, done = false;
  while (!done && it < max_it) {
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      float d = 0.0f;
      for (int64_t q = ep[e]; q < ep[e + 1]; ++q) d += alpha[ec_paths[q]];
      const bool valid = cnt[e] != 0.0f && d >= kTolerance;
      cn[e] = valid ? cnt[e] / fmaxf(d, kTolerance) : 0.0f;
    }
    __syncthreads();
    int changed = 0;
    for (int p = warp; p < P; p += n_warps) {
      float sum = 0.0f;
      for (int64_t q = pp[p] + lane; q < pp[p + 1]; q += 32)
        sum += cn[path_ecs[q]];
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_down_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float a = alpha[p];
        const float na = __fmul_rn(a, sum);
        nxt[p] = na;
        changed |= na > kChangeLimit &&
                   fabsf(na - a) / fmaxf(na, kTiny) > kChange;
      }
    }
    changed = __syncthreads_or(changed);
    const bool stop = !changed && it > min_it;
    const bool enter_final = stop && !final_round;
    done = final_round;  // the round just run was the final one
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const float a = nxt[p];
      alpha[p] = enter_final && a < kAlphaZero ? 0.0f : a;
    }
    ++it;
    final_round = final_round || enter_final;
    __syncthreads();
  }
  if (threadIdx.x == 0) it_out[g] = it;
  for (int p = threadIdx.x; p < P; p += blockDim.x)
    alpha_out[static_cast<size_t>(g) * P + p] = alpha[p];
}

}  // namespace

extern "C" int groot_em_batched(const void* ec_ptr, const void* ec_paths,
                                const void* path_ptr, const void* path_ecs,
                                const void* counts, const void* n_paths, int G,
                                int E, int P, int min_it, int max_it,
                                void* it_out, void* alpha_out, void* stream) {
  if (G == 0) return 0;
  if (G < 0 || E < 0 || P < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(P) + 2 * E);
  cudaError_t err = cudaFuncSetAttribute(
      em_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  em_batched_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ec_ptr), static_cast<const int32_t*>(ec_paths),
      static_cast<const int64_t*>(path_ptr),
      static_cast<const int32_t*>(path_ecs), static_cast<const float*>(counts),
      static_cast<const int32_t*>(n_paths), E, P, min_it, max_it,
      static_cast<int32_t*>(it_out), static_cast<float*>(alpha_out));
  return static_cast<int>(cudaGetLastError());
}
