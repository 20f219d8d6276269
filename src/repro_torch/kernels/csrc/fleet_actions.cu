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
// after the launches. row_map holds -1 (or any negative: no pool) or a pool
// row in [0, m).
//
// Design: one warp walks the acting servers with incremental bookkeeping.
//   1. Which servers can act is fixed before the walk (split: flags[s];
//      evict: act_ok && active[s] && (level_hits[s] || base_ok[s]), since
//      only step s itself clears active[s]). The CTA stages it as one bit
//      per server (a ballot per 32), with row_map, src_of and each pool
//      row's member count in shared memory (3 m ints and a few bits per
//      server).
//   2. Warp 0 walks the set bits in index order (__ffs over each word), so
//      a server that cannot act costs nothing. At an acting step the pool's
//      size is its count and the active count a register, so a member
//      leaving (a split, an eviction) is a few scalar updates.
//   3. A leader's hand-over is the one step that needs the membership: the
//      warp scans row_map once for the smallest other member (a warp min)
//      and once to relabel the others, 32 servers a pass; the counts, src_of
//      and the pool-centering rows move with them.
//   4. Every lane of warp 0 runs each step alike (the step's scalars are
//      warp-uniform; each lane loads what it stores, and __syncwarp closes
//      the step), so no lane waits on another's update, and the fired bits
//      of a word stay in a register; the other warps only stage and write
//      back. Outputs are written out of place from the inputs: the
//      walk touches only its shared copies, read_row and the pool rows, and
//      a last pass writes every output once (a fired server's detector rows
//      zeroed, its statistic recorded). With ctl[0] == 0 (the pre-action
//      screen found nothing that can fire, take_slow = false in JAX) the
//      kernel copies its inputs to its outputs in one coalesced pass.
//
// Bound. The loops read and write O(m) ints and floats once: bytes bound
// them (under a microsecond at m = 1024 at HBM rate). The walk sets the
// time when something acts: a dependent shared-memory round trip or two per
// acting step, two passes over row_map per hand-over.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmemBytes = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool bit(const unsigned* words, int i) {
  return (words[i >> 5] >> (i & 31)) & 1u;
}

// Shared copies of the routing and the member count of each pool row.
struct Book {
  int* row;  // row_map
  int* src;  // src_of
  int* cnt;  // members per pool row
};

// Stages row_map and src_of, zeroes the counts (all threads), then counts
// every pool row's members (a barrier between and after).
__device__ __forceinline__ void stage_book(Book bk, const int* row_map, const int* src_of, int m) {
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    bk.row[i] = row_map[i];
    bk.src[i] = src_of[i];
    bk.cnt[i] = 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int r = bk.row[i];
    if (r >= 0 && r < m) atomicAdd(&bk.cnt[r], 1);
  }
}

// Warp 0 at a leader s of pool row `row` with `size` > 1 members: the
// others move to the smallest of them, with their routing, their count, the
// bank row's provenance and the pool-centering rows. Every lane runs it
// alike (each lane loads what it stores, a __syncwarp between), so that no
// lane waits on another's scalar update.
__device__ __forceinline__ void hand_over(Book bk, int s, int row, int size, int m,
                                          int* read_row, float* pool_level, float* pool_n) {
  const int lane = threadIdx.x & 31;
  const float lv = pool_level[row], nv = pool_n[row];  // in flight behind the scans
  const int src = bk.src[row];
  int first = m;
#pragma unroll 8
  for (int i = lane; i < m; i += 32) {
    first = min(first, i != s && bk.row[i] == row ? i : m);
  }
  const int next = __reduce_min_sync(kFull, first);
  const int c_next = bk.cnt[next];
#pragma unroll 8
  for (int i = lane; i < m; i += 32) {  // predicated stores, no branch per server
    const int r = bk.row[i];
    const bool move = i != s && r == row;
    bk.row[i] = move ? next : r;
    if (move) read_row[i] = next;
  }
  __syncwarp();
  bk.src[next] = src;
  bk.cnt[next] = c_next + size - 1;
  bk.cnt[row] = 1;
  pool_level[next] = lv;
  pool_level[row] = 0.0f;
  pool_n[next] = nv;
  pool_n[row] = 0.0f;
  __syncwarp();
}

__global__ void __launch_bounds__(kMaxThreads) fleet_split_kernel(
    const unsigned char* __restrict__ flags, const int* __restrict__ row_map,
    const int* __restrict__ read_row, const int* __restrict__ src_of,
    const float* __restrict__ stat, const float* __restrict__ pool_level,
    const float* __restrict__ pool_n, int* row_map_out, int* read_row_out, int* src_of_out,
    float* stat_out, float* pool_level_out, float* pool_n_out, unsigned char* fired_out,
    const int* __restrict__ ctl, int m) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  if (ctl[0] == 0) {  // nothing can split: the outputs are the inputs
    for (int i = tid; i < m; i += nt) {
      row_map_out[i] = row_map[i];
      read_row_out[i] = read_row[i];
      src_of_out[i] = src_of[i];
      const bool f = flags[i];
      stat_out[2 * i] = f ? 0.0f : stat[2 * i];
      stat_out[2 * i + 1] = f ? 0.0f : stat[2 * i + 1];
      pool_level_out[i] = pool_level[i];
      pool_n_out[i] = pool_n[i];
      fired_out[i] = 0;
    }
    return;
  }
  const int words = (m + 31) >> 5;
  extern __shared__ int smem[];
  const Book bk{smem, smem + m, smem + 2 * m};
  unsigned* cand = reinterpret_cast<unsigned*>(smem + 3 * m);
  unsigned* fired = cand + words;
  for (int i = tid; i < m; i += nt) {  // what the walk may overwrite, first
    read_row_out[i] = read_row[i];
    pool_level_out[i] = pool_level[i];
    pool_n_out[i] = pool_n[i];
  }
  for (int w = warp; w < words; w += nt >> 5) {
    const int i = 32 * w + lane;
    const unsigned c = __ballot_sync(kFull, i < m && flags[i]);
    if (lane == 0) {
      cand[w] = c;
      fired[w] = 0;
    }
  }
  stage_book(bk, row_map, src_of, m);
  __syncthreads();

  if (warp == 0) {  // every lane alike: the steps' scalars are warp-uniform
    for (int w = 0; w < words; ++w) {
      unsigned fw = 0, left = cand[w];
      for (int b = __ffs(left) - 1; left;) {
        const int s = 32 * w + b;
        left &= left - 1;
        b = __ffs(left) - 1;  // the next candidate, off this step's chain
        const int row = bk.row[s];
        const int size = row >= 0 && row < m ? bk.cnt[row] : 0;
        if (size < 2) continue;  // flagged but alone: only its CUSUM pair resets
        if (row == s) {
          hand_over(bk, s, row, size, m, read_row_out, pool_level_out, pool_n_out);
        } else {  // a member leaves with the pool's posterior
          const int src = bk.src[row], c_s = bk.cnt[s];
          __syncwarp();
          bk.src[s] = src;
          bk.cnt[row] = size - 1;
          bk.cnt[s] = c_s + 1;
          bk.row[s] = s;
          read_row_out[s] = s;
          __syncwarp();
        }
        fw |= 1u << (s & 31);
      }
      if (lane == 0) fired[w] = fw;
    }
  }
  __syncthreads();
  for (int i = tid; i < m; i += nt) {
    row_map_out[i] = bk.row[i];
    src_of_out[i] = bk.src[i];
    const bool f = flags[i];
    stat_out[2 * i] = f ? 0.0f : stat[2 * i];
    stat_out[2 * i + 1] = f ? 0.0f : stat[2 * i + 1];
    fired_out[i] = bit(fired, i);
  }
}

__global__ void __launch_bounds__(kMaxThreads) fleet_evict_kernel(
    const unsigned char* __restrict__ level_hits, const unsigned char* __restrict__ base_ok,
    const float* __restrict__ stat_val, const int* __restrict__ row_map,
    const int* __restrict__ read_row, const int* __restrict__ src_of,
    const unsigned char* __restrict__ active, const float* __restrict__ stat,
    const float* __restrict__ level, const float* __restrict__ n,
    const float* __restrict__ pool_level, const float* __restrict__ pool_n, int* row_map_out,
    int* read_row_out, int* src_of_out, unsigned char* active_out, float* stat_out,
    float* level_out, float* n_out, float* pool_level_out, float* pool_n_out,
    unsigned char* fired_out, float* stats_out, const int* __restrict__ ctl, int m) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  if (ctl[0] == 0) {  // nothing can fire: the outputs are the inputs
    for (int i = tid; i < m; i += nt) {
      row_map_out[i] = row_map[i];
      read_row_out[i] = read_row[i];
      src_of_out[i] = src_of[i];
      active_out[i] = active[i];
      stat_out[2 * i] = stat[2 * i];
      stat_out[2 * i + 1] = stat[2 * i + 1];
      level_out[i] = level[i];
      n_out[i] = n[i];
      pool_level_out[i] = pool_level[i];
      pool_n_out[i] = pool_n[i];
      fired_out[i] = 0;
      stats_out[i] = 0.0f;
    }
    return;
  }
  const bool act_ok = ctl[1] != 0;
  const int words = (m + 31) >> 5;
  extern __shared__ int smem[];
  __shared__ int s_active;
  const Book bk{smem, smem + m, smem + 2 * m};
  unsigned* cand = reinterpret_cast<unsigned*>(smem + 3 * m);
  unsigned* fired = cand + words;
  unsigned* hits = fired + words;
  unsigned* base = hits + words;
  if (tid == 0) s_active = 0;
  for (int i = tid; i < m; i += nt) {  // what the walk may overwrite, first
    read_row_out[i] = read_row[i];
    pool_level_out[i] = pool_level[i];
    pool_n_out[i] = pool_n[i];
  }
  __syncthreads();
  for (int w = warp; w < words; w += nt >> 5) {
    const int i = 32 * w + lane;
    const bool a = i < m && active[i];
    const bool h = i < m && level_hits[i];
    const bool b = i < m && base_ok[i];
    const unsigned va = __ballot_sync(kFull, a);
    const unsigned vh = __ballot_sync(kFull, h);
    const unsigned vb = __ballot_sync(kFull, b);
    if (lane == 0) {
      cand[w] = act_ok ? va & (vh | vb) : 0u;
      fired[w] = 0;
      hits[w] = vh;
      base[w] = vb;
      atomicAdd(&s_active, __popc(va));
    }
  }
  stage_book(bk, row_map, src_of, m);
  __syncthreads();

  if (warp == 0) {  // every lane alike: the steps' scalars are warp-uniform
    int n_active = s_active;
    for (int w = 0; w < words; ++w) {
      const unsigned hw = hits[w], bw = base[w];
      unsigned fw = 0, left = cand[w];
      for (int nb = __ffs(left) - 1; left && n_active > 1;) {
        const int b = nb;
        const int s = 32 * w + b;
        left &= left - 1;
        nb = __ffs(left) - 1;  // the next candidate, off this step's chain
        const int row = bk.row[s];
        const bool live = row >= 0 && row < m;
        const int size = live ? bk.cnt[row] : 0;
        if (!((hw >> b) & 1u) && !(size == 1 && ((bw >> b) & 1u))) continue;
        const bool leader = row == s && size > 1;
        if (leader) {  // detach the survivors first: the pool moves on
          hand_over(bk, s, row, size, m, read_row_out, pool_level_out, pool_n_out);
        }
        __syncwarp();  // every lane has read the step's state before any writes
        if (live) bk.cnt[row] = (leader ? 1 : size) - 1;
        bk.row[s] = -1;
        __syncwarp();
        fw |= 1u << b;
        --n_active;
      }
      if (lane == 0) fired[w] = fw;
    }
  }
  __syncthreads();
  for (int i = tid; i < m; i += nt) {
    const bool f = bit(fired, i);
    row_map_out[i] = bk.row[i];
    src_of_out[i] = bk.src[i];
    active_out[i] = active[i] && !f;
    stat_out[2 * i] = f ? 0.0f : stat[2 * i];
    stat_out[2 * i + 1] = f ? 0.0f : stat[2 * i + 1];
    level_out[i] = f ? 0.0f : level[i];
    n_out[i] = f ? 0.0f : n[i];
    fired_out[i] = f;
    stats_out[i] = f ? stat_val[i] : 0.0f;
  }
}

int threads_for(int m) {
  const int t = ((m + 31) / 32) * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// Dynamic shared memory of an entry: row_map, src_of and the counts (3 m
// ints) and `bitsets` words of one bit per server.
int smem_bytes(int m, int bitsets) {
  return 4 * (3 * m + bitsets * ((m + 31) / 32));
}

}  // namespace

extern "C" {

// The largest m whose evict entry (the larger) fits in shared memory.
int fleet_actions_max_servers() { return (kMaxSmemBytes - 64) / 25 * 2; }

// The split loop over m servers: reads flags (uint8 [m]), row_map, read_row,
// src_of (int32 [m]), stat ([m, 2]), pool_level and pool_n ([m]) and ctl
// (int32 [2], (take_slow, act_ok) on the device); writes the outputs of the
// same shapes and fired (uint8 [m]), none aliasing an input. Returns 0 or a
// CUDA error code.
int fleet_split_launch(const unsigned char* flags, const int* row_map, const int* read_row,
                       const int* src_of, const float* stat, const float* pool_level,
                       const float* pool_n, int* row_map_out, int* read_row_out,
                       int* src_of_out, float* stat_out, float* pool_level_out,
                       float* pool_n_out, unsigned char* fired, const int* ctl, int m,
                       cudaStream_t stream) {
  if (m <= 0 || m > fleet_actions_max_servers()) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(m, 2);
  cudaError_t err = cudaFuncSetAttribute(fleet_split_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fleet_split_kernel<<<1, threads_for(m), smem, stream>>>(
      flags, row_map, read_row, src_of, stat, pool_level, pool_n, row_map_out, read_row_out,
      src_of_out, stat_out, pool_level_out, pool_n_out, fired, ctl, m);
  return static_cast<int>(cudaGetLastError());
}

// The evict loop over m servers: reads level_hits, base_ok (uint8 [m]),
// stat_val (float32 [m]), row_map, read_row, src_of, active (uint8 [m]),
// stat, level, n, pool_level, pool_n and ctl; writes the outputs of the
// same shapes, fired (uint8 [m]) and stats (float32 [m]), none aliasing an
// input. Returns 0 or a CUDA error code.
int fleet_evict_launch(const unsigned char* level_hits, const unsigned char* base_ok,
                       const float* stat_val, const int* row_map, const int* read_row,
                       const int* src_of, const unsigned char* active, const float* stat,
                       const float* level, const float* n, const float* pool_level,
                       const float* pool_n, int* row_map_out, int* read_row_out,
                       int* src_of_out, unsigned char* active_out, float* stat_out,
                       float* level_out, float* n_out, float* pool_level_out,
                       float* pool_n_out, unsigned char* fired, float* stats, const int* ctl,
                       int m, cudaStream_t stream) {
  if (m <= 0 || m > fleet_actions_max_servers()) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(m, 4);
  cudaError_t err = cudaFuncSetAttribute(fleet_evict_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fleet_evict_kernel<<<1, threads_for(m), smem, stream>>>(
      level_hits, base_ok, stat_val, row_map, read_row, src_of, active, stat, level, n,
      pool_level, pool_n, row_map_out, read_row_out, src_of_out, active_out, stat_out, level_out,
      n_out, pool_level_out, pool_n_out, fired, stats, ctl, m);
  return static_cast<int>(cudaGetLastError());
}

const char* fleet_actions_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
