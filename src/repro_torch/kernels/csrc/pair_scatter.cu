// K-stacked pair-statistic scatter of the telemetry estimator, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/telemetry.py (pair_scatter ->
// _pair_scatter_impl -> _pair_scatter_kernel). Same contract: for a batch of
// B observations with target type t_b, exposure row cbar[b, :] (T floats)
// and K statistics vals[k, b],
//
//   pair[k, u, t] = sum_b cbar[b, u] * vals[k, b] * 1{t_b == t}    [K, T, T]
//   base[k, t]    = sum_b             vals[k, b] * 1{t_b == t}    [K, T]
//
// and a row whose type lies outside [0, T) contributes nothing.
//
// Design. The Pallas kernel turns the scatter into a one-hot [T, B] x [B, T]
// MXU contraction per statistic: O(K B T^2) flops, which the TPU's matrix
// unit absorbs. Here the kernel does only the O(K B T) work the scatter
// needs. One CTA owns one target type t and walks the batch in order, in
// chunks of kThreads rows: each thread tests one row's type, the block
// compacts the matching row indices into shared memory in ascending order
// (warp ballots plus a prefix over the warps' counts), and then thread u
// adds cbar[b, u] * vals[k, b] into K register accumulators for every
// matching row b. No atomics: each output element is summed in ascending b
// by one thread, so the result does not change from run to run.
//
// Bound. A cbar row is read only by the CTA of its type, so cbar is read
// once in total; types (4 B bytes) is read by all T CTAs, from L2 after the
// first. The function moves 4 (B T + B + K B + K T^2 + K T) bytes for
// 2 K B T fp32 operations, well under one operation per byte, so it is bound
// by bytes; at the estimator's small per-server batches, by launch latency.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // one thread per exposure column u: T <= 256
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 4;  // statistics per pass

__global__ void __launch_bounds__(kThreads)
pair_scatter_kernel(const int* __restrict__ types,   // [B]
                    const float* __restrict__ cbar,  // [B, T]
                    const float* __restrict__ vals,  // [K, B]
                    float* __restrict__ pair,        // [K, T, T]
                    float* __restrict__ base,        // [K, T]
                    int B, int T, int K) {
  __shared__ int s_rows[kThreads];
  __shared__ int s_warp_count[kWarps];

  const int t = blockIdx.x;
  const int u = threadIdx.x;
  const int lane = u & 31;
  const int warp = u >> 5;

  float acc[kMaxK];
  float bacc[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    acc[k] = 0.f;
    bacc[k] = 0.f;
  }

  for (int b0 = 0; b0 < B; b0 += kThreads) {
    // compact the chunk's rows of type t, keeping ascending order
    const int b = b0 + u;
    const bool hit = b < B && types[b] == t;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_warp_count[w];
      offset += (w < warp) ? c : 0;
      total += c;
    }
    if (hit) s_rows[offset + __popc(ballot & ((1u << lane) - 1u))] = b;
    __syncthreads();

    // accumulate the matching rows: coalesced cbar row, broadcast vals
    for (int j = 0; j < total; ++j) {
      const int r = s_rows[j];
      const float c = (u < T) ? cbar[(size_t)r * T + u] : 0.f;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) {
          const float v = vals[(size_t)k * B + r];
          acc[k] = fmaf(c, v, acc[k]);
          bacc[k] += v;
        }
      }
    }
    __syncthreads();  // the next chunk rewrites s_rows and s_warp_count
  }

  if (u < T) {
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) pair[((size_t)k * T + u) * T + t] = acc[k];
  }
  if (u == 0) {
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) base[(size_t)k * T + t] = bacc[k];
  }
}

}  // namespace

extern "C" int pair_scatter_launch(const void* types, const void* cbar,
                                   const void* vals, void* pair, void* base,
                                   int B, int T, int K, void* stream) {
  if (B <= 0 || T <= 0 || T > kThreads || K <= 0 || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  pair_scatter_kernel<<<T, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)types, (const float*)cbar, (const float*)vals,
      (float*)pair, (float*)base, B, T, K);
  return (int)cudaGetLastError();
}

extern "C" const char* pair_scatter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
