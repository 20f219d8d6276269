// The fleet controller's action loops, for sm_90a.
//
// Port of the two lax.fori_loops of repro/fleet/controller.py::fleet_step
// (split_body and evict_body, controller.py:223-297; no Pallas twin: XLA
// compiles each loop into one program). Both walk the servers s = 0..m-1 in
// index order against live pool membership: an earlier action changes the
// routing a later step sees.
//
//   split  for a flagged server in a pool of two or more: a member leaves
//          with the pool's posterior (src_of[s] = src_of[row]; row_map and
//          read_row of s become s), a leader leaves the pool to its smallest
//          other member (src_of[new] = src_of[row]; the others move to new,
//          and the pool-centering rows pool_level/pool_n move from row to
//          new); a flagged server's CUSUM pair is zeroed whether or not it
//          split.
//   evict  for an active server (while more than one is active, and
//          act_ok) with a level hit, or a base hit in a pool of one: a
//          leader first hands its pool to the smallest other member (as a
//          split does), then the server's routing becomes -1, its active
//          flag 0 and its detector rows (stat, level, n) 0, and its statistic
//          is recorded.
//
// Everything a step decides on is an integer or boolean: the float
// quantities (level hits, the base ratio's test, the recorded statistic)
// are computed before the launch in PyTorch, so the kernel and its plain
// version agree exactly. src_of is the row-provenance map (final content
// of bank row r = input row src_of[r]); the bank gather through it happens
// after the launches.
//
// Design. One CTA, threads striding the m servers; row_map, read_row,
// src_of (and the active mask) in shared memory. A step that cannot act
// (not flagged; not active or no hit) is skipped by every thread alike. An
// acting step takes two block reductions (the size of the server's pool
// and the smallest other member; for evict also the active count), one
// thread then writes the scalar updates and every thread moves its own
// servers, and a barrier closes the step. ctl[0] = 0 (the pre-action
// screen found nothing that can fire, take_slow = false in JAX) ends the
// kernel at its first instruction, and the caller's copies of the inputs
// stand as the outputs.
//
// Bound. The loops read and write O(m) ints and a few floats per acting
// step: bytes bound them (under a microsecond at m = 1024 at HBM rate);
// the chain of dependent steps, each a few barriers, sets the time when
// something acts, the early exit when nothing does.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

struct Reduced {
  int count;   // members of the row (and, for evict, active servers)
  int active;
  int min_other;
};

// Block-wide (sum, sum, min) over per-thread partials; every thread gets
// the result. ``scratch`` holds 3 x 32 ints.
__device__ Reduced block_reduce(int count, int active, int min_other, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, off);
    active += __shfl_down_sync(0xffffffffu, active, off);
    min_other = min(min_other, __shfl_down_sync(0xffffffffu, min_other, off));
  }
  if (lane == 0) {
    scratch[warp] = count;
    scratch[32 + warp] = active;
    scratch[64 + warp] = min_other;
  }
  __syncthreads();
  Reduced r{0, 0, 0x7fffffff};
  for (int w = 0; w < nwarps; ++w) {
    r.count += scratch[w];
    r.active += scratch[32 + w];
    r.min_other = min(r.min_other, scratch[64 + w]);
  }
  return r;
}

__global__ void __launch_bounds__(kMaxThreads) fleet_split_kernel(
    const unsigned char* __restrict__ flags, int* row_map_g, int* read_row_g, int* src_of_g,
    float* stat, float* pool_level, float* pool_n, unsigned char* fired,
    const int* __restrict__ ctl, int m) {
  if (ctl[0] == 0) return;
  extern __shared__ int smem[];
  __shared__ int scratch[96];
  int* row_map = smem;
  int* read_row = row_map + m;
  int* src_of = read_row + m;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < m; i += nt) {
    row_map[i] = row_map_g[i];
    read_row[i] = read_row_g[i];
    src_of[i] = src_of_g[i];
  }
  __syncthreads();
  for (int s = 0; s < m; ++s) {
    if (!flags[s]) continue;
    const int row = row_map[s];
    int count = 0, min_other = m;
    for (int i = tid; i < m; i += nt) {
      if (row >= 0 && row_map[i] == row) {
        ++count;
        if (i != s) min_other = min(min_other, i);
      }
    }
    const Reduced r = block_reduce(count, 0, min_other, scratch);
    const bool can = row >= 0 && r.count > 1;
    const bool leader = can && row == s;
    const int next = r.min_other;
    const int src = min(max(row, 0), m - 1);
    if (leader) {  // the pool moves to its smallest other member
      for (int i = tid; i < m; i += nt) {
        if (i != s && row_map[i] == row) {
          row_map[i] = next;
          read_row[i] = next;
        }
      }
    }
    if (tid == 0) {
      if (can) src_of[leader ? next : s] = src_of[src];
      if (can && !leader) {
        row_map[s] = s;
        read_row[s] = s;
      }
      if (leader) {
        pool_level[next] = pool_level[src];
        pool_level[src] = 0.0f;
        pool_n[next] = pool_n[src];
        pool_n[src] = 0.0f;
      }
      stat[2 * s] = 0.0f;
      stat[2 * s + 1] = 0.0f;
      if (can) fired[s] = 1;
    }
    __syncthreads();
  }
  for (int i = tid; i < m; i += nt) {
    row_map_g[i] = row_map[i];
    read_row_g[i] = read_row[i];
    src_of_g[i] = src_of[i];
  }
}

__global__ void __launch_bounds__(kMaxThreads) fleet_evict_kernel(
    const unsigned char* __restrict__ level_hits, const unsigned char* __restrict__ base_ok,
    const float* __restrict__ stat_val, int* row_map_g, int* read_row_g, int* src_of_g,
    unsigned char* active_g, float* stat, float* level, float* n, float* pool_level,
    float* pool_n, unsigned char* fired, float* stats, const int* __restrict__ ctl, int m) {
  if (ctl[0] == 0) return;
  const bool act_ok = ctl[1] != 0;
  extern __shared__ int smem[];
  __shared__ int scratch[96];
  int* row_map = smem;
  int* read_row = row_map + m;
  int* src_of = read_row + m;
  int* active = src_of + m;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < m; i += nt) {
    row_map[i] = row_map_g[i];
    read_row[i] = read_row_g[i];
    src_of[i] = src_of_g[i];
    active[i] = active_g[i];
  }
  __syncthreads();
  for (int s = 0; s < m; ++s) {
    if (!(act_ok && active[s] && (level_hits[s] || base_ok[s]))) continue;
    const int row = row_map[s];
    int count = 0, n_active = 0, min_other = m;
    for (int i = tid; i < m; i += nt) {
      n_active += active[i];
      if (row >= 0 && row_map[i] == row) {
        ++count;
        if (i != s) min_other = min(min_other, i);
      }
    }
    const Reduced r = block_reduce(count, n_active, min_other, scratch);
    const bool base_hit = r.count == 1 && base_ok[s];
    const bool fire = r.active > 1 && (level_hits[s] || base_hit);
    if (fire) {
      const bool leader = row == s && r.count > 1;
      const int next = r.min_other;
      const int src = min(max(row, 0), m - 1);
      if (leader) {  // detach the survivors first: the pool moves to next
        for (int i = tid; i < m; i += nt) {
          if (i != s && row_map[i] == row) {
            row_map[i] = next;
            read_row[i] = next;
          }
        }
      }
      if (tid == 0) {
        if (leader) {
          src_of[next] = src_of[src];
          pool_level[next] = pool_level[src];
          pool_level[src] = 0.0f;
          pool_n[next] = pool_n[src];
          pool_n[src] = 0.0f;
        }
        row_map[s] = -1;
        active[s] = 0;
        stat[2 * s] = 0.0f;
        stat[2 * s + 1] = 0.0f;
        level[s] = 0.0f;
        n[s] = 0.0f;
        fired[s] = 1;
        stats[s] = stat_val[s];
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < m; i += nt) {
    row_map_g[i] = row_map[i];
    read_row_g[i] = read_row[i];
    src_of_g[i] = src_of[i];
    active_g[i] = static_cast<unsigned char>(active[i]);
  }
}

int threads_for(int m) {
  const int t = ((m + 31) / 32) * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

}  // namespace

extern "C" {

// Shared memory of the evict entry (the larger): 4 m ints.
int fleet_actions_max_servers() { return (227 * 1024 - 96 * 4) / 16; }

// The split loop over m servers. The caller passes writable copies of
// row_map, read_row, src_of (int32 [m]), stat ([m, 2]), pool_level and
// pool_n ([m]), and a zeroed fired (uint8 [m]); ctl (int32 [2]) is
// (take_slow, act_ok) on the device. Returns 0 or a CUDA error code.
int fleet_split_launch(const unsigned char* flags, int* row_map, int* read_row, int* src_of,
                       float* stat, float* pool_level, float* pool_n, unsigned char* fired,
                       const int* ctl, int m, cudaStream_t stream) {
  if (m <= 0 || m > fleet_actions_max_servers()) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 3 * m * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(fleet_split_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fleet_split_kernel<<<1, threads_for(m), smem, stream>>>(flags, row_map, read_row, src_of, stat,
                                                          pool_level, pool_n, fired, ctl, m);
  return static_cast<int>(cudaGetLastError());
}

// The evict loop over m servers: writable copies of row_map, read_row,
// src_of, active (uint8 [m]), stat, level, n, pool_level, pool_n, a zeroed
// fired (uint8 [m]) and stats (float32 [m]); level_hits, base_ok (uint8 [m])
// and stat_val (float32 [m]) are read only. Returns 0 or a CUDA error code.
int fleet_evict_launch(const unsigned char* level_hits, const unsigned char* base_ok,
                       const float* stat_val, int* row_map, int* read_row, int* src_of,
                       unsigned char* active, float* stat, float* level, float* n,
                       float* pool_level, float* pool_n, unsigned char* fired, float* stats,
                       const int* ctl, int m, cudaStream_t stream) {
  if (m <= 0 || m > fleet_actions_max_servers()) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * m * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(fleet_evict_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fleet_evict_kernel<<<1, threads_for(m), smem, stream>>>(
      level_hits, base_ok, stat_val, row_map, read_row, src_of, active, stat, level, n,
      pool_level, pool_n, fired, stats, ctl, m);
  return static_cast<int>(cudaGetLastError());
}

const char* fleet_actions_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
