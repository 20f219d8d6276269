// Dependent-issue latencies, in SM clocks, of the operations the fleet
// kernels (src/repro_torch/kernels/csrc/cusum_scan.cu, fleet_actions.cu)
// chain: one warp runs each operation 1000 times, every result feeding the
// next, and divides the clock64() span by the count. Needs one CUDA card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o sm_latency tools/sm_latency.cu
//   ./sm_latency
//
// Prints one line of "name cycles" pairs. __match_any_sync is timed on
// 4, 8 and 32 distinct keys in the warp: its time grows with them.
#include <cuda_runtime.h>

#include <cstdio>

namespace {

constexpr int kReps = 1000;
constexpr unsigned kFull = 0xffffffffu;

__global__ void latencies(long long* out, long long* sink) {
  __shared__ int ring[1024];
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) ring[i] = (i + 1) & 1023;
  __syncthreads();
  if (threadIdx.x >= 32) return;
  int p = 0;
  unsigned u = lane;
  float f = 1.0f + lane;
  long long t0;
#define TIME(slot, body)                                    \
  t0 = clock64();                                           \
  for (int k = 0; k < kReps; ++k) { body; }                 \
  out[slot] = (clock64() - t0) / kReps;
  TIME(0, p = ring[p]);
  TIME(1, u = __shfl_sync(kFull, u, (u + 1) & 31));
  TIME(2, u = __ballot_sync(kFull, (u >> lane) & 1) ^ lane);
  TIME(3, u = __match_any_sync(kFull, static_cast<int>(u & 3)) + lane);
  TIME(4, u = __match_any_sync(kFull, static_cast<int>((u & 1) * 64 + (lane & 7))) + lane);
  TIME(5, u = __match_any_sync(kFull, static_cast<int>((u & 1) * 64 + lane)) + lane);
  TIME(6, f = __fadd_rn(__fmul_rn(0.9f, f), 0.1f));
  TIME(7, f = __fdiv_rn(f, 1.0001f) + 1.0f);
  TIME(8, u = __ffs(u | 0x80000000u) + u);
  TIME(9, u = __popc(u) + u);
  TIME(10, u = __reduce_min_sync(kFull, static_cast<int>(u + lane)));
#undef TIME
  sink[lane] = p + u + static_cast<long long>(f);
}

}  // namespace

int main() {
  long long *out, *sink;
  cudaMalloc(&out, 16 * sizeof(long long));
  cudaMalloc(&sink, 32 * sizeof(long long));
  for (int warm = 0; warm < 2; ++warm) latencies<<<1, 64>>>(out, sink);
  long long o[16];
  cudaMemcpy(o, out, sizeof(o), cudaMemcpyDeviceToHost);
  const char* names[] = {"lds", "shfl", "ballot", "match_any(4 keys)", "match_any(8 keys)",
                         "match_any(32 keys)", "fmul+fadd", "fdiv_rn+fadd", "ffs+add",
                         "popc+add", "reduce_min"};
  for (int i = 0; i < 11; ++i) printf("%s %lld%s", names[i], o[i], i < 10 ? "; " : "\n");
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    fprintf(stderr, "sm_latency: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
