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
// Invalid rows change nothing (JAX scatters them to index m, which drops),
// and neither do rows whose server or pool row is out of range.
//
// Design: independent chains. The fold has two kinds of state, and each
// depends only on its own rows: pool row w's (pool_level, pool_n) on the
// earlier rows of w, server s's (stat, level, n) on the earlier rows of s
// and on each row's x, which the pool state before the row fixes. So the
// pool chains run first and leave every row its x; the server chains then
// need nothing of the pools, whatever pool rows a server's rows name. Each
// state variable sees the same operations on the same operands in the same
// order as in the sequential fold, so the result is bit for bit the plain
// version's and a block split over several calls gives the same state.
// One CTA of 512 threads, per chunk of up to 4096 rows:
//   1. every warp loads its contiguous share of the chunk into registers
//      (all loads in flight at once) and compacts its valid rows into
//      shared memory in stream order (a ballot per 32 rows, a scan over the
//      warps);
//   2. the rows are stably partitioned by pool row and by server: each warp
//      owns a residue class of one partition's keys and ranks each of their
//      rows among the earlier rows of its key, 32 rows at a time in stream
//      order (__match_any_sync groups a tile's rows by key, a group's first
//      lane moves the key's count), one exclusive scan over both
//      partitions' keys gives each key its first slot, and every thread
//      sends its rows to their slots;
//   3. each live pool row's two chains, now contiguous, are walked by two
//      threads of different warps with their state in registers: pool_level
//      (residuals loaded eight at a time one step ahead, a dependent FMUL
//      and FADD a row) and pool_n (the same, on nothing but the row count),
//      each leaving the state before every row in its slot;
//   4. every thread divides for the hat and x of its rows, off the chains;
//   5. one thread per server walks its rows with (S+, S-, level, n) in
//      registers.
// The state and the keys' counts live in shared memory (above its limit,
// in the output arrays and a global scratch), and the state is written out
// of place: the kernel reads the input state and writes the output arrays,
// so the caller copies nothing.
//
// Every operation is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn): nvcc would contract d * level + (1 - d) * r into an FMA, the
// plain PyTorch version rounds the product first, and the chunk contract
// needs the two to agree bit for bit.
//
// Bound. Each row's four inputs are read once (13 B) and the state is read
// and written once (2 x 4 (4 m + 2 rows) B): bytes bound it, and at the
// fused loop's blocks (B = 2 x 4096, m = 1024) that is well under a
// microsecond at HBM rate. The chains set the time: the longest pool chain
// (about half the valid rows with the spec pools) at one dependent FMUL and
// FADD a row, after the partition's warp has ranked each 32 rows.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 4096;  // compacted rows per pass
constexpr int kPerLane = kMaxChunk / kThreads;  // rows a lane loads per pass
constexpr int kPoolWarps = 2;    // warps that rank the pool partition
constexpr int kServerWarps = 6;  // and the server partition
constexpr int kRowBytes = 32;    // shared memory per staged row: 8 arrays of 4 B
constexpr int kMaxSmemBytes = 227 * 1024 - 1024;  // dynamic, beside the static arrays
constexpr unsigned kFull = 0xffffffffu;

struct State {
  float* stat;  // [m, 2]
  float* level;
  float* n;
  float* pool_level;  // [rows]
  float* pool_n;
};

// Per key of both partitions (the pool rows, then the servers): its rows in
// this chunk, then the first of its slots.
struct Keys {
  int* cnt;
  int* start;
};

// One warp of `parts`: for the keys k of this partition with k % parts ==
// part, each row's rank among the earlier rows of its key (rank[i]) and
// each key's rows (cnt[k + offset], zeroed before), 32 rows at a time in
// stream order. The warps split the keys so that __match_any_sync, whose
// time grows with the distinct keys in a tile, groups few; the next tile is
// loaded and grouped while this tile's counts move.
template <int kParts>
__device__ __forceinline__ void rank_keys(const int* keys, int n, int offset, int part, int* cnt,
                                          int* rank) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  auto mine = [&](int i) {  // this warp's key of row i, else -1 (one group)
    const int k = i < n ? keys[i] : -1;
    return k >= 0 && k % kParts == part ? k : -1;
  };
  int key = mine(lane);
  unsigned peers = __match_any_sync(kFull, key);
  for (int t0 = 0; t0 < n; t0 += 32) {
    const int key_next = mine(t0 + 32 + lane);
    const unsigned peers_next = __match_any_sync(kFull, key_next);
    const int at = key >= 0 ? cnt[key + offset] : 0;
    __syncwarp();  // the group has read its count before its first lane moves it
    if (key >= 0) {
      const unsigned before = peers & lt;
      if (before == 0) cnt[key + offset] = at + __popc(peers);
      rank[t0 + lane] = at + __popc(before);
    }
    __syncwarp();
    key = key_next;
    peers = peers_next;
  }
}

// start[j] = cnt[0] + ... + cnt[j - 1] for j < K (all threads; barriers).
__device__ void scan_keys(Keys keys, int K, int* s_wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (K + kThreads - 1) / kThreads;
  const int lo = min(K, tid * per), hi = min(K, lo + per);
  int sum = 0;
  for (int j = lo; j < hi; ++j) sum += keys.cnt[j];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? s_wsum[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < kWarps) s_wsum[lane] = wi - w;
  }
  __syncthreads();
  int run = s_wsum[warp] + incl - sum;
  for (int j = lo; j < hi; ++j) {
    keys.start[j] = run;
    run += keys.cnt[j];
  }
  __syncthreads();
}

// One chain of a pool row over its slots [q, end): pool_level (kLevel, on
// the residuals r) or pool_n, leaving the value before each row in pre.
// Eight rows a step: their residuals loaded a step ahead, their values
// stored after the step, so that no store holds up the chain.
template <bool kLevel>
__device__ __forceinline__ float pool_chain(float v, int q, int end, const float* r, float* pre,
                                            float d, float omd) {
  constexpr int kStep = 8;
  float rv[kStep], nx[kStep], a[kStep];
#pragma unroll
  for (int j = 0; j < kStep; ++j) rv[j] = kLevel && q + kStep <= end ? r[q + j] : 0.0f;
  for (; q + kStep <= end; q += kStep) {
    const bool more = kLevel && q + 2 * kStep <= end;
#pragma unroll
    for (int j = 0; j < kStep; ++j) nx[j] = more ? r[q + kStep + j] : 0.0f;
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      a[j] = v;
      v = __fadd_rn(__fmul_rn(d, v), kLevel ? __fmul_rn(omd, rv[j]) : 1.0f);
    }
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      pre[q + j] = a[j];
      rv[j] = nx[j];
    }
  }
  for (; q < end; ++q) {
    pre[q] = v;
    v = __fadd_rn(__fmul_rn(d, v), kLevel ? __fmul_rn(omd, r[q]) : 1.0f);
  }
  return v;
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads) cusum_scan_kernel(
    const int* __restrict__ server, const int* __restrict__ row, const float* __restrict__ resid,
    const unsigned char* __restrict__ valid, const float* __restrict__ stat_in,
    const float* __restrict__ level_in, const float* __restrict__ n_in,
    const float* __restrict__ pool_level_in, const float* __restrict__ pool_n_in,
    float* stat_out, float* level_out, float* n_out, float* pool_level_out, float* pool_n_out,
    int* scratch, int B, int m, int rows, int chunk, float k, float d, float omd) {
  extern __shared__ float smem[];
  __shared__ int s_wsum[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* c_srv = reinterpret_cast<int*>(smem);  // the compacted rows, by row
  int* c_row = c_srv + chunk;
  float* c_x = reinterpret_cast<float*>(c_row);  // x replaces the pool row once placed
  float* c_res = reinterpret_cast<float*>(c_row + chunk);
  int* ord = reinterpret_cast<int*>(c_res + chunk);  // [2 chunk]: pool slots, then server
  float* p_r = reinterpret_cast<float*>(ord + 2 * chunk);  // by pool slot
  float* p_pl = p_r + chunk;
  float* p_pn = p_pl + chunk;
  int* pool_rank = reinterpret_cast<int*>(p_pl);  // until the chains run
  int* srv_rank = reinterpret_cast<int*>(p_pn);
  State st{stat_out, level_out, n_out, pool_level_out, pool_n_out};
  int* tables = scratch;
  if (kSmem) {
    st.stat = p_pn + chunk;
    st.level = st.stat + 2 * m;
    st.n = st.level + m;
    st.pool_level = st.n + m;
    st.pool_n = st.pool_level + rows;
    tables = reinterpret_cast<int*>(st.pool_n + rows);
  }
  const int K = rows + m;  // the pool rows' keys, then the servers'
  const Keys keys{tables, tables + K};
  for (int i = tid; i < 2 * m; i += kThreads) st.stat[i] = stat_in[i];
  for (int i = tid; i < m; i += kThreads) {
    st.level[i] = level_in[i];
    st.n[i] = n_in[i];
  }
  for (int i = tid; i < rows; i += kThreads) {
    st.pool_level[i] = pool_level_in[i];
    st.pool_n[i] = pool_n_in[i];
  }

  for (int base = 0; base < B; base += chunk) {
    const int cnt = min(chunk, B - base);
    // 1. each warp loads a contiguous share of the chunk, at most kPerLane
    // rows a lane, then compacts its valid rows in stream order
    const int per = ((cnt + kThreads - 1) / kThreads) * 32;
    const int lo = min(cnt, warp * per), hi = min(cnt, lo + per);
    int rs[kPerLane], rw[kPerLane];
    float rr[kPerLane];
    unsigned votes[kPerLane];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int i = lo + 32 * j + lane;
      const bool in = i < hi;
      rs[j] = in ? server[base + i] : -1;
      rw[j] = in ? row[base + i] : -1;
      rr[j] = in ? resid[base + i] : 0.0f;
      const bool ok = in && valid[base + i] && rs[j] >= 0 && rs[j] < m && rw[j] >= 0 &&
                      rw[j] < rows;
      votes[j] = __ballot_sync(kFull, ok);
      mine += __popc(votes[j]);
    }
    __syncthreads();  // the previous chunk's walks are done with the staging
    if (lane == 0) s_wsum[warp] = mine;
    for (int i = tid; i < K; i += kThreads) keys.cnt[i] = 0;
    __syncthreads();
    int at = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? s_wsum[w] : 0;
      n += s_wsum[w];
    }
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if ((votes[j] >> lane) & 1u) {
        const int q = at + __popc(votes[j] & ((1u << lane) - 1u));
        c_srv[q] = rs[j];
        c_row[q] = rw[j];
        c_res[q] = rr[j];
      }
      at += __popc(votes[j]);
    }
    __syncthreads();

    // 2. the stable partitions by pool row and by server: ranks, counts,
    // slots
    if (warp < kPoolWarps) {
      rank_keys<kPoolWarps>(c_row, n, 0, warp, keys.cnt, pool_rank);
    } else if (warp < kPoolWarps + kServerWarps) {
      rank_keys<kServerWarps>(c_srv, n, rows, warp - kPoolWarps, keys.cnt, srv_rank);
    }
    __syncthreads();
    scan_keys(keys, K, s_wsum);  // the server slots follow the n pool slots
    for (int i = tid; i < n; i += kThreads) {
      const int q = keys.start[c_row[i]] + pool_rank[i];
      ord[q] = i;
      p_r[q] = c_res[i];
      ord[keys.start[rows + c_srv[i]] + srv_rank[i]] = i;
    }
    __syncthreads();

    // 3. the pool chains: pool_level by the first half of the threads,
    // pool_n by the second, a warp further on so that a pool's two chains
    // issue from different schedulers (warp w runs on scheduler w % 4)
    constexpr int kHalf = kThreads / 2;
    const bool level = tid < kHalf;
    for (int w = level ? tid : (tid - 32) % kHalf; w < rows; w += kHalf) {
      const int c = keys.cnt[w];
      if (c == 0) continue;
      const int q = keys.start[w];
      if (level) {
        st.pool_level[w] = pool_chain<true>(st.pool_level[w], q, q + c, p_r, p_pl, d, omd);
      } else {
        st.pool_n[w] = pool_chain<false>(st.pool_n[w], q, q + c, p_r, p_pn, d, omd);
      }
    }
    __syncthreads();

    // 4. each row's hat and x, off the chains
    for (int q = tid; q < n; q += kThreads) {
      const float pl = p_pl[q], pn = p_pn[q];
      const float hat = pn > 0.0f ? __fdiv_rn(pl, fmaxf(__fmul_rn(omd, pn), 1e-12f)) : 0.0f;
      c_x[ord[q]] = __fsub_rn(p_r[q], hat);
    }
    __syncthreads();

    // 5. the server chains
    for (int s = tid; s < m; s += kThreads) {
      const int c = keys.cnt[rows + s];
      if (c == 0) continue;
      const int q0 = keys.start[rows + s];
      float pos = st.stat[2 * s], neg = st.stat[2 * s + 1];
      float lvl = st.level[s], cn = st.n[s];
      for (int q = q0; q < q0 + c; ++q) {
        const int i = ord[q];
        const float x = c_x[i], r = c_res[i];
        pos = fmaxf(0.0f, __fadd_rn(pos, __fsub_rn(x, k)));
        neg = fmaxf(0.0f, __fsub_rn(neg, __fadd_rn(x, k)));
        lvl = __fadd_rn(__fmul_rn(d, lvl), __fmul_rn(omd, r));
        cn = __fadd_rn(__fmul_rn(d, cn), 1.0f);
      }
      st.stat[2 * s] = pos;
      st.stat[2 * s + 1] = neg;
      st.level[s] = lvl;
      st.n[s] = cn;
    }
  }

  if (kSmem) {
    __syncthreads();
    for (int i = tid; i < 2 * m; i += kThreads) stat_out[i] = st.stat[i];
    for (int i = tid; i < m; i += kThreads) {
      level_out[i] = st.level[i];
      n_out[i] = st.n[i];
    }
    for (int i = tid; i < rows; i += kThreads) {
      pool_level_out[i] = st.pool_level[i];
      pool_n_out[i] = st.pool_n[i];
    }
  }
}

template <bool kSmem>
int launch(const int* server, const int* row, const float* resid, const unsigned char* valid,
           const float* stat, const float* level, const float* n, const float* pool_level,
           const float* pool_n, float* stat_out, float* level_out, float* n_out,
           float* pool_level_out, float* pool_n_out, int* scratch, int B, int m, int rows,
           int chunk, float k, float d, float omd, int dyn, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(cusum_scan_kernel<kSmem>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  cusum_scan_kernel<kSmem><<<1, kThreads, dyn, stream>>>(
      server, row, resid, valid, stat, level, n, pool_level, pool_n, stat_out, level_out, n_out,
      pool_level_out, pool_n_out, scratch, B, m, rows, chunk, k, d, omd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Folds B rows into the state: reads the input state (stat [m, 2], level
// [m], n [m], pool_level [rows], pool_n [rows], all float32) and writes the
// new state to the output arrays, of the same shapes and not aliasing the
// inputs; scratch (int32 [2 (m + rows)]) holds the keys' counts where they
// do not fit in shared memory. Shared memory and the chunk are sized from
// B, m and rows only. Returns 0 or a CUDA error code.
int cusum_scan_launch(const int* server, const int* row, const float* resid,
                      const unsigned char* valid, const float* stat, const float* level,
                      const float* n, const float* pool_level, const float* pool_n,
                      float* stat_out, float* level_out, float* n_out, float* pool_level_out,
                      float* pool_n_out, int* scratch, int B, int m, int rows, float k,
                      float level_decay, float one_minus_decay, cudaStream_t stream) {
  if (B < 0 || m <= 0 || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int want = ((min(max(B, 1), kMaxChunk) + 31) / 32) * 32;
  // the state and the keys' tables: 4 (4 m + 2 rows) + 4 (2 m + 2 rows) bytes
  const long long fixed = 24LL * m + 16LL * rows;
  const long long room = (kMaxSmemBytes - fixed) / kRowBytes / 32 * 32;
  const bool in_smem = room >= min(want, 1024);  // a shorter chunk, before global state
  const int chunk = in_smem ? static_cast<int>(room < want ? room : want) : want;
  const int dyn = static_cast<int>(kRowBytes * chunk + (in_smem ? fixed : 0));
  const auto run = in_smem ? launch<true> : launch<false>;
  return run(server, row, resid, valid, stat, level, n, pool_level, pool_n, stat_out, level_out,
             n_out, pool_level_out, pool_n_out, scratch, B, m, rows, chunk, k, level_decay,
             one_minus_decay, dyn, stream);
}

const char* cusum_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
