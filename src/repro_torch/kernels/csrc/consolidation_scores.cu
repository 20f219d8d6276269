// Q x m candidate scorer of the paper's Fig-8 greedy (Eqns 2-5), for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/consolidation.py
// (consolidation_scores -> _score_kernel). Same contract: for each candidate
// q with grid type t_q and each server s, with c = counts[s] + e_{t_q},
//
//   cache[q, s] = (c . rs + c . fs_resident[s]) / llc_budget[s]
//   maxd[q, s]  = max over {u : c[u] > 0} of clip((c @ D[s])[u] - D[s,u,u], 0, 1)
//
// and NaN in both for a type outside [0, T). Since c @ D[s] = counts[s] @ D[s]
// + D[s, t_q, :], both outputs depend on a candidate only through its type:
//
//   cache[q, s] = (comp0[s] + rs[t] + fs_resident[s, t]) / llc_budget[s]
//   maxd[q, s]  = max over {u : counts[s, u] > 0 or u = t} of
//                 clip(col0[s, u] + D[s, t, u] - D[s, u, u], 0, 1),   t = t_q,
//
// with col0 = counts[s] @ D[s] and comp0 = counts[s] . (rs + fs_resident[s]).
//
// Two paths, picked by the wrapper from Q:
//
// Table path (large Q). Pass A: a CTA per (server, share of the types) forms
// col0 and comp0, marks the types that some candidate has (one scan of the Q
// ints into a shared-memory mask), and forms the [T, m] table entries of its
// share of the marked types: each needed row of D[s] is read once, coalesced.
// Pass B writes out[q, s] = table[t_q, s], coalesced along s; the table
// (<= T x m floats, 0.9 MB at m = 1024) stays in L2. So D costs one read of
// the needed rows per call, where the single pass read one row per (q, s):
// at m = 1024, Q = 4096 that is 217 MB of D instead of 3.9 GB of row reads.
//
// Single pass (small Q: 1 and 8 are most launches, and launch-bound). A CTA
// per (server, chunk of 64 candidates) forms col0 once and a warp per
// candidate reads its D row and takes the masked max; one launch.
//
// Both paths form each entry with the same arithmetic in the same thread
// layout (step 1: thread u < T owns column u of col0, rows t with
// counts[s, t] == 0 skipped; step 2: lane v covers columns v, v + 32, ...
// of the type's row, a shuffle tree takes the max), so their outputs are
// bitwise equal.
//
// Bound. Memory: the function must read the D rows of the types present on
// each server or scored there, and write 2 Q m floats. Its least work is 5 T
// operations per distinct candidate type and server (add, subtract, clip,
// mask, max) plus the gather, ~2 flops per byte read: far below the card's
// fp32 ridge, so the table path is bandwidth-bound and the single pass at
// small Q launch-bound. No tensor cores: the contraction is a GEMV per
// server, and fp32 FMA keeps it at full precision.
//
// cache sums byte counts: for grid-typed workloads every term is a multiple
// of 1 KiB far below 2^24 KiB, so the f32 sums are exact in any order.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // step 1 needs one thread per type: T <= 256
constexpr int kWarps = kThreads / 32;
constexpr int kGatherThreads = 256;

struct ServerState {
  float col0[kThreads];
  float diag[kThreads];
  unsigned char present[kThreads];
  int list[kThreads];
  int warp_n[kWarps];
  float red[kWarps];
  float comp0;
};

// the threads u whose flag is set, in order, into list; returns their count
// (by the whole block)
__device__ __forceinline__ int compact(bool flag, int* list, int* warp_n) {
  const int u = threadIdx.x, lane = u & 31, warp = u >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_n[warp] = __popc(ballot);
  __syncthreads();
  int base = 0, n = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) base += warp_n[w];
    n += warp_n[w];
  }
  if (flag) list[base + __popc(ballot & ((1u << lane) - 1u))] = u;
  __syncthreads();
  return n;
}

// step 1, by the whole block: counts row, comp0 = sum_u counts (rs + fs_res),
// col0 = counts[s] @ D[s], the diagonal and the present mask of server s.
// col0 sums the rows t with counts[s, t] != 0 in type order, their loads
// issued eight at a time (the sum's order is that of a plain loop over t).
__device__ __forceinline__ void server_state(ServerState& st, const float* __restrict__ counts,
                                             const float* __restrict__ Ds,
                                             const float* __restrict__ rs,
                                             const float* __restrict__ fs_s, int s, int T,
                                             float* s_counts) {
  const int u = threadIdx.x, lane = u & 31, warp = u >> 5;
  float c_u = 0.f, bytes_u = 0.f;
  if (u < T) {
    c_u = counts[(size_t)s * T + u];
    bytes_u = c_u * rs[u] + c_u * fs_s[u];
  }
  s_counts[u] = c_u;
  for (int off = 16; off > 0; off >>= 1)
    bytes_u += __shfl_xor_sync(0xffffffffu, bytes_u, off);
  if (lane == 0) st.red[warp] = bytes_u;
  const int n_nz = compact(c_u != 0.f, st.list, st.warp_n);  // its barriers publish red
  if (u == 0) {
    float comp0 = 0.f;
    for (int w = 0; w < kWarps; ++w) comp0 += st.red[w];
    st.comp0 = comp0;
  }
  if (u < T) {
    float acc = 0.f;
    int k = 0;
    for (; k + 8 <= n_nz; k += 8) {
      float d[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = Ds[(size_t)st.list[k + i] * T + u];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(s_counts[st.list[k + i]], d[i], acc);
    }
    for (; k < n_nz; ++k) acc = fmaf(s_counts[st.list[k]], Ds[(size_t)st.list[k] * T + u], acc);
    st.col0[u] = acc;
    st.diag[u] = Ds[(size_t)u * T + u];
    st.present[u] = c_u > 0.f;
  }
  __syncthreads();
}

// step 2, by one warp: the masked max of type tq (0 <= tq < T) on server s
__device__ __forceinline__ float type_maxd(const ServerState& st, const float* __restrict__ Ds,
                                           int tq, int T) {
  const int lane = threadIdx.x & 31;
  float best = -INFINITY;
  const float* row = Ds + (size_t)tq * T;
  for (int v = lane; v < T; v += 32) {
    float d = (st.col0[v] + row[v]) - st.diag[v];
    d = fminf(fmaxf(d, 0.f), 1.f);
    if (st.present[v] || v == tq) best = fmaxf(best, d);
  }
  for (int off = 16; off > 0; off >>= 1)
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
  return best;
}

// single pass: grid (m, ceil(Q / q_chunk)), one warp per candidate
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
  __shared__ ServerState st;
  __shared__ float s_counts[kThreads];
  const int s = blockIdx.x;
  const float* Ds = D + (size_t)s * T * T;
  const float* fs_s = fs_res + (size_t)s * T;
  server_state(st, counts, Ds, rs, fs_s, s, T, s_counts);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float comp0 = st.comp0;
  const float bud = budget[s];
  const int q0 = blockIdx.y * q_chunk;
  const int q1 = min(Q, q0 + q_chunk);
  for (int q = q0 + warp; q < q1; q += kWarps) {
    const int tq = wtypes[q];
    const bool valid = tq >= 0 && tq < T;  // uniform across the warp
    const float best = valid ? type_maxd(st, Ds, tq, T) : -INFINITY;
    if (lane == 0) {
      const size_t o = (size_t)q * m + s;
      cache[o] = valid ? (comp0 + rs[tq] + fs_s[tq]) / bud : NAN;
      maxd[o] = valid ? best : NAN;
    }
  }
}

// table path, pass A: grid (m, shares); share c of server s forms the
// entries of the c-th share of the marked types, in type order
__global__ void __launch_bounds__(kThreads)
score_table_kernel(const float* __restrict__ counts, const float* __restrict__ D,
                   const float* __restrict__ rs, const float* __restrict__ fs_res,
                   const float* __restrict__ budget, const int* __restrict__ wtypes,
                   float* __restrict__ t_cache,  // [T, m]
                   float* __restrict__ t_maxd,   // [T, m]
                   int m, int T, int Q) {
  __shared__ ServerState st;
  __shared__ float s_counts[kThreads];
  __shared__ int s_mark[kThreads];
  const int u = threadIdx.x, lane = u & 31, warp = u >> 5;
  const int s = blockIdx.x;

  s_mark[u] = 0;
  __syncthreads();
  for (int q = u; q < Q; q += kThreads) {
    const int t = wtypes[q];
    if (t >= 0 && t < T) s_mark[t] = 1;  // benign race: every writer stores 1
  }
  const float* Ds = D + (size_t)s * T * T;
  const float* fs_s = fs_res + (size_t)s * T;
  server_state(st, counts, Ds, rs, fs_s, s, T, s_counts);  // its barriers publish s_mark

  // the marked types, in type order, into st.list (col0 is done with it)
  const int n_marked = compact(u < T && s_mark[u], st.list, st.warp_n);

  const int per = (n_marked + gridDim.y - 1) / gridDim.y;
  const int i0 = blockIdx.y * per;
  const int i1 = min(n_marked, i0 + per);
  const float comp0 = st.comp0;
  const float bud = budget[s];
  for (int i = i0 + warp; i < i1; i += kWarps) {
    const int tq = st.list[i];
    const float best = type_maxd(st, Ds, tq, T);
    if (lane == 0) {
      t_cache[(size_t)tq * m + s] = (comp0 + rs[tq] + fs_s[tq]) / bud;
      t_maxd[(size_t)tq * m + s] = best;
    }
  }
}

// table path, pass B: out[q, s] = table[t_q, s], NaN for a type outside [0, T)
__global__ void __launch_bounds__(kGatherThreads)
score_gather_kernel(const float* __restrict__ t_cache, const float* __restrict__ t_maxd,
                    const int* __restrict__ wtypes, float* __restrict__ cache,
                    float* __restrict__ maxd, int m, int T, long long n) {
  for (long long e = blockIdx.x * (long long)kGatherThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kGatherThreads) {
    const int q = (int)(e / m), s = (int)(e % m);
    const int tq = wtypes[q];
    const bool valid = tq >= 0 && tq < T;
    cache[e] = valid ? t_cache[(size_t)tq * m + s] : NAN;
    maxd[e] = valid ? t_maxd[(size_t)tq * m + s] : NAN;
  }
}

}  // namespace

// Single pass: q_chunk candidates per CTA.
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

// Table path: pass A over (m, shares) CTAs into the [T, m] scratch tables
// t_cache and t_maxd (entries of unmarked types are left unwritten and never
// read), then pass B over gather_blocks CTAs.
extern "C" int consolidation_scores_table_launch(
    const void* counts, const void* D, const void* rs, const void* fs_res,
    const void* budget, const void* wtypes, void* cache, void* maxd,
    void* t_cache, void* t_maxd, int m, int T, int Q, int shares, int gather_blocks,
    void* stream) {
  if (m <= 0 || T <= 0 || T > kThreads || Q <= 0 || shares <= 0 || shares > 65535 ||
      gather_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  score_table_kernel<<<dim3((unsigned)m, (unsigned)shares), kThreads, 0, st>>>(
      (const float*)counts, (const float*)D, (const float*)rs, (const float*)fs_res,
      (const float*)budget, (const int*)wtypes, (float*)t_cache, (float*)t_maxd, m, T, Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  score_gather_kernel<<<(unsigned)gather_blocks, kGatherThreads, 0, st>>>(
      (const float*)t_cache, (const float*)t_maxd, (const int*)wtypes, (float*)cache,
      (float*)maxd, m, T, (long long)Q * m);
  return (int)cudaGetLastError();
}

extern "C" const char* consolidation_scores_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
