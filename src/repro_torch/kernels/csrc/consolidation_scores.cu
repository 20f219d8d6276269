// Q x m candidate scorer of the paper's Fig-8 greedy (Eqns 2-5), for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/consolidation.py
// (consolidation_scores -> _score_kernel). Same contract: for each candidate
// q with grid type t_q and each server s, with c = counts[s] + e_{t_q},
//
//   cache[q, s] = (c . rs + c . fs_resident[s]) / llc_budget[s]
//   maxd[q, s]  = max over {u : c[u] > 0} of clip((c @ D[s])[u] - D[s,u,u], 0, 1)
//
// Design. The Pallas kernel recomputes c @ D[s] for every (s, q), which is
// O(Q m T^2). Here c @ D[s] = counts[s] @ D[s] + D[s, t_q, :], so one CTA per
// (server, chunk of candidates) forms col0 = counts[s] @ D[s] once (step 1)
// and then each candidate costs one gathered [T] row of D[s] plus a masked
// max (step 2): O(nnz(counts[s]) T + Q T) per server.
//
// Bound. Memory: the function must read the D rows of the types present on
// each server, one gathered D row per (q, s), and write 2 Q m floats. There
// are ~2 flops per byte read, far below the card's fp32 ridge, so the kernel
// is bandwidth- (and at small Q launch-) bound. No tensor cores: the
// contraction is a GEMV per server, and fp32 FMA keeps it at full precision.
//
// Step 1 (threads = columns): thread u < T owns column u. Rows t with
// counts[s, t] == 0 are skipped; the test is on a shared-memory value, so the
// branch is uniform across the block, and most of the 230 types are absent.
// Step 2 (warps = candidates): each warp takes its own candidates, reads the
// row D[s, t_q, :] coalesced (lane v covers columns v, v+32, ...), and
// reduces the masked max with shuffles, so step 2 needs no block barrier.
//
// cache sums byte counts: for grid-typed workloads every term is a multiple
// of 1 KiB far below 2^24 KiB, so the f32 sums are exact in any order.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // step 1 needs one thread per type: T <= 256
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
score_kernel(const float* __restrict__ counts,   // [m, T]
             const float* __restrict__ D,        // [m, T, T]
             const float* __restrict__ rs,       // [T]
             const float* __restrict__ fs_res,   // [m, T]
             const float* __restrict__ budget,   // [m]
             const int* __restrict__ wtypes,     // [Q]
             float* __restrict__ cache,          // [Q, m]
             float* __restrict__ maxd,           // [Q, m]
             int m, int T, int Q, int q_chunk) {
  __shared__ float s_counts[kThreads];
  __shared__ float s_col0[kThreads];
  __shared__ float s_diag[kThreads];
  __shared__ unsigned char s_present[kThreads];
  __shared__ float s_red[kWarps];
  __shared__ float s_comp0;

  const int s = blockIdx.x;
  const int u = threadIdx.x;
  const int lane = u & 31;
  const int warp = u >> 5;
  const float* Ds = D + (size_t)s * T * T;
  const float* fs_s = fs_res + (size_t)s * T;

  // ---- step 1: counts row, comp0 = sum_u counts (rs + fs_res), col0 -----
  float c_u = 0.f, bytes_u = 0.f;
  if (u < T) {
    c_u = counts[(size_t)s * T + u];
    bytes_u = c_u * rs[u] + c_u * fs_s[u];
  }
  s_counts[u] = c_u;
  for (int off = 16; off > 0; off >>= 1)
    bytes_u += __shfl_xor_sync(0xffffffffu, bytes_u, off);
  if (lane == 0) s_red[warp] = bytes_u;
  __syncthreads();
  if (u == 0) {
    float comp0 = 0.f;
    for (int w = 0; w < kWarps; ++w) comp0 += s_red[w];
    s_comp0 = comp0;
  }

  if (u < T) {
    float acc = 0.f;
    for (int t = 0; t < T; ++t) {
      const float c = s_counts[t];
      if (c != 0.f) acc = fmaf(c, Ds[(size_t)t * T + u], acc);
    }
    s_col0[u] = acc;
    s_diag[u] = Ds[(size_t)u * T + u];
    s_present[u] = c_u > 0.f;
  }
  __syncthreads();

  // ---- step 2: one warp per candidate ------------------------------------
  const float comp0 = s_comp0;
  const float bud = budget[s];
  const int q0 = blockIdx.y * q_chunk;
  const int q1 = min(Q, q0 + q_chunk);
  for (int q = q0 + warp; q < q1; q += kWarps) {
    const int tq = wtypes[q];
    const bool valid = tq >= 0 && tq < T;  // uniform across the warp
    float best = -INFINITY;
    if (valid) {
      const float* row = Ds + (size_t)tq * T;
      for (int v = lane; v < T; v += 32) {
        float d = (s_col0[v] + row[v]) - s_diag[v];
        d = fminf(fmaxf(d, 0.f), 1.f);
        if (s_present[v] || v == tq) best = fmaxf(best, d);
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
    if (lane == 0) {
      const size_t o = (size_t)q * m + s;
      if (valid) {
        cache[o] = (comp0 + rs[tq] + fs_s[tq]) / bud;
        maxd[o] = best;
      } else {
        cache[o] = NAN;
        maxd[o] = NAN;
      }
    }
  }
}

}  // namespace

extern "C" int consolidation_scores_launch(
    const void* counts, const void* D, const void* rs, const void* fs_res,
    const void* budget, const void* wtypes, void* cache, void* maxd,
    int m, int T, int Q, int q_chunk, void* stream) {
  if (m <= 0 || T <= 0 || T > kThreads || Q <= 0 || q_chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const int chunks = (Q + q_chunk - 1) / q_chunk;
  if (chunks > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)m, (unsigned)chunks);
  score_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)counts, (const float*)D, (const float*)rs,
      (const float*)fs_res, (const float*)budget, (const int*)wtypes,
      (float*)cache, (float*)maxd, m, T, Q, q_chunk);
  return (int)cudaGetLastError();
}

extern "C" const char* consolidation_scores_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
