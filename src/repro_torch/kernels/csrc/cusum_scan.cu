// The drift detector's CUSUM scan, for sm_90a.
//
// Port of the sequential fold in repro/fleet/detect.py::_cusum_update, a
// lax.scan over a block of B observation rows in stream order (no Pallas
// twin: XLA compiles the scan into one program). Per valid row b, with
// server s = server[b], pool row w = row[b] and residual r = resid[b]
// (computed before the launch: rows are independent there), from the
// state as it stands after rows 0..b-1:
//
//   hat  = pool_n[w] > 0 ? pool_level[w] / max((1 - d) pool_n[w], 1e-12) : 0
//   x    = r - hat                                 (pool-centered residual)
//   stat[s, 0]    = max(0, stat[s, 0] + (x - k))   (S+)
//   stat[s, 1]    = max(0, stat[s, 1] - (x + k))   (S-)
//   level[s]      = d level[s] + (1 - d) r
//   n[s]          = d n[s] + 1
//   pool_level[w] = d pool_level[w] + (1 - d) r
//   pool_n[w]     = d pool_n[w] + 1
//
// Invalid rows change nothing (JAX scatters them to index m, which drops).
//
// Design. The fold is sequential by contract: a row's update reads the
// state that every earlier row of its server and of its pool row left, and
// the contract is that one block gives the same bits as the same rows split
// over several calls (tests/test_fleet.py:115-121). So one CTA does it:
// its threads stage the state into shared memory (6 m floats; m <= 9216 at
// the default 227 KB) and the rows 1024 at a time (coalesced), and thread 0
// walks the staged rows in order. Above the shared-memory limit the state
// stays in global memory, where thread 0 updates it in place.
//
// Every operation is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn): nvcc would contract d * level + (1 - d) * r into an FMA, the
// plain PyTorch version rounds the product first, and the chunk contract
// needs the two to agree bit for bit.
//
// Bound. Each row's four inputs are read once (13 B) and the state is read
// and written once (2 x 4 (4 m + 2 rows) B): bytes bound it, and at the
// fused loop's blocks (B = 2 x 4096, m = 1024) that is well under a
// microsecond at HBM rate; the walk's dependent shared-memory updates (a
// few tens of cycles a row) set the time.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // rows staged per pass
constexpr int kMaxSmemBytes = 227 * 1024;
constexpr int kStagedBytes = kChunk * (2 * 4 + 4 + 1);

__global__ void __launch_bounds__(kThreads) cusum_scan_kernel(
    const int* __restrict__ server, const int* __restrict__ row,
    const float* __restrict__ resid, const unsigned char* __restrict__ valid,
    float* stat_g, float* level_g, float* n_g, float* pool_level_g, float* pool_n_g,
    int B, int m, int rows, float k, float d, float omd, int state_in_smem) {
  __shared__ int s_srv[kChunk];
  __shared__ int s_row[kChunk];
  __shared__ float s_res[kChunk];
  __shared__ unsigned char s_ok[kChunk];
  extern __shared__ float smem[];
  const int tid = threadIdx.x;

  float* stat = stat_g;
  float* level = level_g;
  float* n = n_g;
  float* pool_level = pool_level_g;
  float* pool_n = pool_n_g;
  if (state_in_smem) {
    stat = smem;
    level = stat + 2 * m;
    n = level + m;
    pool_level = n + m;
    pool_n = pool_level + rows;
    for (int i = tid; i < 2 * m; i += kThreads) stat[i] = stat_g[i];
    for (int i = tid; i < m; i += kThreads) {
      level[i] = level_g[i];
      n[i] = n_g[i];
    }
    for (int i = tid; i < rows; i += kThreads) {
      pool_level[i] = pool_level_g[i];
      pool_n[i] = pool_n_g[i];
    }
  }

  for (int base = 0; base < B; base += kChunk) {
    const int cnt = min(kChunk, B - base);
    __syncthreads();  // the previous pass's walk is done with the staging
    for (int i = tid; i < cnt; i += kThreads) {
      s_srv[i] = server[base + i];
      s_row[i] = row[base + i];
      s_res[i] = resid[base + i];
      s_ok[i] = valid[base + i];
    }
    __syncthreads();
    if (tid == 0) {
      for (int i = 0; i < cnt; ++i) {
        const int s = s_srv[i];
        const int w = s_row[i];
        if (!s_ok[i] || s < 0 || s >= m || w < 0 || w >= rows) continue;
        const float r = s_res[i];
        const float pl = pool_level[w];
        const float pn = pool_n[w];
        const float hat = pn > 0.0f ? __fdiv_rn(pl, fmaxf(__fmul_rn(omd, pn), 1e-12f)) : 0.0f;
        const float x = __fsub_rn(r, hat);
        const float pos = fmaxf(0.0f, __fadd_rn(stat[2 * s], __fsub_rn(x, k)));
        const float neg = fmaxf(0.0f, __fsub_rn(stat[2 * s + 1], __fadd_rn(x, k)));
        const float lvl = __fadd_rn(__fmul_rn(d, level[s]), __fmul_rn(omd, r));
        const float cnt_s = __fadd_rn(__fmul_rn(d, n[s]), 1.0f);
        const float plv = __fadd_rn(__fmul_rn(d, pl), __fmul_rn(omd, r));
        const float pcn = __fadd_rn(__fmul_rn(d, pn), 1.0f);
        stat[2 * s] = pos;
        stat[2 * s + 1] = neg;
        level[s] = lvl;
        n[s] = cnt_s;
        pool_level[w] = plv;
        pool_n[w] = pcn;
      }
    }
  }

  if (state_in_smem) {
    __syncthreads();
    for (int i = tid; i < 2 * m; i += kThreads) stat_g[i] = stat[i];
    for (int i = tid; i < m; i += kThreads) {
      level_g[i] = level[i];
      n_g[i] = n[i];
    }
    for (int i = tid; i < rows; i += kThreads) {
      pool_level_g[i] = pool_level[i];
      pool_n_g[i] = pool_n[i];
    }
  }
}

}  // namespace

extern "C" {

// Folds B rows into the state, which the caller passes as writable copies
// (stat [m, 2], level [m], n [m], pool_level [rows], pool_n [rows], all
// float32) and which the kernel updates in place. Returns 0 or a CUDA error
// code.
int cusum_scan_launch(const int* server, const int* row, const float* resid,
                      const unsigned char* valid, float* stat, float* level, float* n,
                      float* pool_level, float* pool_n, int B, int m, int rows, float k,
                      float level_decay, float one_minus_decay, cudaStream_t stream) {
  if (B < 0 || m <= 0 || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const long long state_bytes = 4LL * (4LL * m + 2LL * rows);
  const int in_smem = state_bytes + kStagedBytes <= kMaxSmemBytes;
  const int dyn = in_smem ? static_cast<int>(state_bytes) : 0;
  cudaError_t err = cudaFuncSetAttribute(cusum_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  cusum_scan_kernel<<<1, kThreads, dyn, stream>>>(server, row, resid, valid, stat, level, n,
                                                  pool_level, pool_n, B, m, rows, k,
                                                  level_decay, one_minus_decay, in_smem);
  return static_cast<int>(cudaGetLastError());
}

const char* cusum_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
