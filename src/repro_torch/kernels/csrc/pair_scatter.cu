// K-stacked pair-statistic scatter of the telemetry estimator, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/telemetry.py (pair_scatter ->
// _pair_scatter_impl -> _pair_scatter_kernel). Two entries share one body.
// For a batch of B observations with key key_b, exposure row co[b, :]
// (T floats) and K statistics vals[k, b], both compute
//
//   acc[k, r, u] = sum_b co[b, u] * vals[k, b] * 1{key_b == r}
//
// and a row whose key lies outside [0, n_rows) contributes nothing (-1
// padding, evicted rows, dump slots).
//
//   contract entry  key = target type, n_rows = T: the Pallas contract.
//                   acc is written whole, [K, T(t), T(u)] with untouched rows
//                   zero, which the wrapper returns as the [K, T(u), T(t)]
//                   view, beside base[k, t] = sum_b vals[k, b] 1{key_b == t}.
//   banked entry    key = bank row * T + type, n_rows = m T: the estimator
//                   bank's scatter over the combined (server, type) space.
//                   Only touched rows are written, as a compact block
//                   rows[k, j, :] for the j-th distinct key in ascending
//                   order, with the key list slot_keys[j]; slots past the
//                   last key hold zeros and the key n_rows. The dense
//                   [K, m, T, T] table is never formed (27 MB at m = 64).
//
// Design.
//  1. Bucket once, stably: every slot's rows listed in ascending b.
//     a. The contract (chunk_sort_kernel, one CTA of 256 threads per 256
//        rows): each CTA sorts its chunk by type (the lanes of a warp that
//        share a type from eight ballots, one per type bit; an exclusive
//        scan over (type, warp); the placement) and writes the chunk's
//        count and first position of each type. A type's rows are its
//        runs in chunk 0, 1, ..., which the accumulate walks in order: no
//        merge across chunks, and every SM that holds a chunk sorts it.
//     b. The bank (bucket_kernel, one CTA of 256 threads): a counting sort
//        of the keys, 8 bits a pass, ceil(log2(n_rows) / 8) passes, in
//        shared memory up to 8192 keys. Warp w owns a contiguous range of
//        rows; a pass takes each warp's histogram (shared-memory integer
//        atomics: counts do not depend on order), an exclusive scan over
//        (digit, warp), and a placement in the warp's row order (ballots
//        for eight rows of 32 at once). Out-of-range keys drop in the first
//        pass; the last ends with the distinct keys and their segment
//        starts. This sort, not the bytes, sets the entry's time: one SM
//        ranks every key (about 9,000 cycles a pass for 4096 keys).
//  2. Accumulate (accumulate_kernel): one warp per slot (a type of the
//     contract, a distinct key of the bank), two slots per CTA, launched
//     while the sort runs (programmatic dependent launch) and waiting on
//     it at its first instruction. The warp
//     takes its rows 32 at a time: each lane loads one row index and its K
//     values, and the warp stages the rows into its 32 KB of shared memory
//     by cp.async, all in flight at once, each lane copying the T / 32
//     columns it sums (float2 where T is even: a row of 230 floats is 920
//     bytes, 8-byte aligned; float4 is not). The old design held one
//     dependent row load in flight per CTA, and that latency, not bytes,
//     set its time. Each element is summed in ascending b by one lane, with
//     no float atomics, so a rerun is bitwise equal.
//  3. Target-major stores: row r of acc is written contiguously over u
//     (float2 per lane), where the old design stored 4-byte values at a
//     stride of T floats.
//
// No tensor cores: the scatter needs O(K B T) multiply-adds. The TPU's one-
// hot MXU form is O(K B T^2) work that the matrix unit absorbs there and
// that Hopper has no reason to do.
//
// Bound. Every input byte is read once (the co rows of in-range keys, the
// keys, the values) and every output byte written once: 4 (n_in T + B +
// K n_in) in and 4 K n_rows_out T (+ base or key list) out, for 2 K n_in T
// fp32 operations, well under one operation per byte, so bytes bound it;
// at the estimator's per-segment batches (well under 1 MB), launch latency.
#include <cuda_runtime.h>

namespace {

constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr int kChunk = 8;  // rows of 32 whose digits a warp ranks at once
constexpr int kChunkRows = kSortThreads;  // rows per CTA of the contract's sort
static_assert(kSortThreads == kBins, "the sorts' offsets take one thread per digit");
constexpr int kMaxK = 4;      // statistics per pass
constexpr int kMaxT = 256;    // exposure columns per row
constexpr int kAccWarps = 2;  // slots per CTA of the accumulate kernel (64 KB staged)
constexpr int kSmemRows = 8192;  // keys the sort keeps in shared memory (128 KB)

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive scan of one value per thread over the whole CTA (all threads
// call it). Returns the exclusive prefix; *total gets the sum.
__device__ __forceinline__ int block_exclusive_scan(int x, int* s_wsum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(x, lane);
  if (lane == 31) s_wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kSortWarps ? s_wsum[lane] : 0;
    s_wsum[lane] = warp_inclusive_scan(w, lane);  // inclusive over warps
  }
  __syncthreads();
  const int before = warp ? s_wsum[warp - 1] : 0;
  *total = s_wsum[kSortWarps - 1];
  __syncthreads();  // s_wsum is reused by the caller's next scan
  return before + incl - x;
}

// The lanes of this warp whose digit equals this lane's (d = -1: not
// placed), from one ballot per digit bit: __match_any_sync's work, at the
// rate of ballots.
__device__ __forceinline__ unsigned peers_of(int d) {
  unsigned peers = __ballot_sync(0xffffffffu, d >= 0);
  if (d < 0) peers = ~peers;
#pragma unroll
  for (int bit = 0; bit < kDigitBits; ++bit) {
    const bool set = (d >> bit) & 1;
    const unsigned m = __ballot_sync(0xffffffffu, set);
    peers &= set ? m : ~m;
  }
  return peers;
}

// The digit a pass sorts key k by; -1 where the row is not placed (the
// first pass drops keys outside [0, n_rows)).
__device__ __forceinline__ int digit_of(int k, bool first, int n_rows, int shift) {
  return (!first || (k >= 0 && k < n_rows)) ? (k >> shift) & (kBins - 1) : -1;
}

// The bank's stable counting sort of the in-range keys (see the header,
// step 1b). Up to kSmemRows keys, the passes run in dynamic shared memory
// (16 B bytes) and the sorted rows leave in one coalesced copy; above, in
// the global halves gk / gr ([2 B] each). order gets the rows, seg the
// segment starts and ukey the slots' keys.
__global__ void __launch_bounds__(kSortThreads)
bucket_kernel(const int* __restrict__ keys, int B, int n_rows, int passes,
              int* __restrict__ gk, int* __restrict__ gr,
              int* __restrict__ order,  // [B] rows by slot, ascending b
              int* __restrict__ seg,    // [B + 1] segment starts
              int* __restrict__ ukey) { // [B] key of each slot
  extern __shared__ int s_dyn[];
  __shared__ int s_cnt[kSortWarps * kBins];  // per (warp, digit): count, then offset
  __shared__ int s_start[kBins + 1];
  __shared__ int s_wsum[32];

  // let the accumulate grid launch now: it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const bool in_smem = B <= kSmemRows;
  int* kbuf = in_smem ? s_dyn : gk;
  int* rbuf = in_smem ? s_dyn + 2 * B : gr;
  const int* kin = keys;
  if (in_smem) {  // one coalesced read of the keys, into the half pass 0 does not write
#pragma unroll 4
    for (int i = tid; i < B; i += kSortThreads) kbuf[B + i] = keys[i];
    kin = kbuf + B;
    __syncthreads();
  }
  const int* rin = nullptr;  // the first pass's row is its index
  int n = B;
  for (int p = 0; p < passes; ++p) {
    int* kout = kbuf + (p & 1) * B;
    int* rout = (p == passes - 1 && !in_smem) ? order : rbuf + (p & 1) * B;
    const int shift = p * kDigitBits;
    const bool first = p == 0;
    const int per = (n + kSortWarps - 1) / kSortWarps;
    const int lo = min(n, warp * per), hi = min(n, lo + per);

    // histogram per warp: counts do not depend on order, so shared atomics
    for (int i = tid; i < kSortWarps * kBins; i += kSortThreads) s_cnt[i] = 0;
    __syncthreads();
#pragma unroll 4
    for (int i = lo + lane; i < hi; i += 32) {
      const int d = digit_of(kin[i], first, n_rows, shift);
      if (d >= 0) atomicAdd(&s_cnt[warp * kBins + d], 1);
    }
    __syncthreads();

    // offsets, digit-major then warp within the digit: one thread per digit
    int run = 0;
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = s_cnt[w * kBins + tid];
      s_cnt[w * kBins + tid] = run;
      run += c;
    }
    int n_valid;
    s_start[tid] = block_exclusive_scan(run, s_wsum, &n_valid);
    if (tid == 0) s_start[kBins] = n_valid;
    __syncthreads();

    // placement in the warp's order: the lanes sharing a digit (ballots)
    // for kChunk rows of 32 at once, then the ranks one row of 32 after the
    // other
    for (int b0 = lo; b0 < hi; b0 += 32 * kChunk) {  // warp-uniform trip count
      int kk[kChunk], rr[kChunk], dd[kChunk];
      unsigned pp[kChunk];
      const int live = min(kChunk, (hi - b0 + 31) / 32);  // rows of 32 in range
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (c >= live) break;  // warp-uniform
        const int i = b0 + 32 * c + lane;
        kk[c] = i < hi ? kin[i] : -1;
        rr[c] = i < hi ? (first ? i : rin[i]) : 0;
        dd[c] = i < hi ? digit_of(kk[c], first, n_rows, shift) : -1;
        pp[c] = peers_of(dd[c]);
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (c >= live) break;
        const int d = dd[c];
        int pos = 0;
        if (d >= 0) pos = s_start[d] + s_cnt[warp * kBins + d] + __popc(pp[c] & lt_mask);
        __syncwarp();
        if (d >= 0 && lane == __ffs(pp[c]) - 1) s_cnt[warp * kBins + d] += __popc(pp[c]);
        __syncwarp();
        if (d >= 0) {
          kout[pos] = kk[c];
          rout[pos] = rr[c];
        }
      }
    }
    __syncthreads();  // this pass's output is visible to the whole CTA
    if (p == passes - 1 && in_smem)
      for (int i = tid; i < n_valid; i += kSortThreads) order[i] = rout[i];
    n = n_valid;
    kin = kout;
    rin = rout;
  }

  // the bank: one slot per distinct key, in ascending key order, taken
  // kSortThreads sorted rows at a time
  int n_keys = 0;
  for (int i0 = 0; i0 < n; i0 += kSortThreads) {
    const int i = i0 + tid;
    const bool head = i < n && (i == 0 || kin[i] != kin[i - 1]);
    int round;
    const int u = n_keys + block_exclusive_scan(head, s_wsum, &round);
    if (head) {
      ukey[u] = kin[i];
      seg[u] = i;
    }
    n_keys += round;
  }
  for (int j = n_keys + tid; j <= B; j += kSortThreads) {
    seg[j] = n;
    if (j < B) ukey[j] = n_rows;
  }
}

// The contract's bucketing (see the header, step 1a): CTA c sorts the
// kChunkRows rows [c kChunkRows, (c + 1) kChunkRows) by type, stably, into
// chunk_order[c], and writes each type's count (cnt[c][t]) and first
// position in the chunk (loff[c][t]). One row of 32 per warp: the lanes
// sharing a type (ballots), an exclusive scan over (type, warp), the
// placement.
__global__ void __launch_bounds__(kSortThreads)
chunk_sort_kernel(const int* __restrict__ types, int B, int T,
                  int* __restrict__ chunk_order,  // [C][kChunkRows]
                  int* __restrict__ cnt,          // [C][kBins]
                  int* __restrict__ loff) {       // [C][kBins]
  __shared__ int s_cnt[kSortWarps * kBins];  // per (warp, type): count, then offset
  __shared__ int s_start[kBins];
  __shared__ int s_wsum[32];

  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x;
  const int i = c * kChunkRows + tid;
  const int k = i < B ? types[i] : -1;
  const int d = (k >= 0 && k < T) ? k : -1;
  for (int j = tid; j < kSortWarps * kBins; j += kSortThreads) s_cnt[j] = 0;
  __syncthreads();
  const unsigned peers = peers_of(d);
  if (d >= 0 && lane == __ffs(peers) - 1) s_cnt[warp * kBins + d] = __popc(peers);
  __syncthreads();
  // one thread per type: offsets over the warps, then over the types
  int run = 0;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    const int x = s_cnt[w * kBins + tid];
    s_cnt[w * kBins + tid] = run;
    run += x;
  }
  int total;
  const int start = block_exclusive_scan(run, s_wsum, &total);
  s_start[tid] = start;
  cnt[c * kBins + tid] = run;
  loff[c * kBins + tid] = start;
  __syncthreads();
  if (d >= 0) {
    const unsigned lt_mask = (1u << lane) - 1u;
    const int pos = s_start[d] + s_cnt[warp * kBins + d] + __popc(peers & lt_mask);
    chunk_order[c * kChunkRows + pos] = i;
  }
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool pred) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(pred ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(pred ? 4 : 0));
}

template <int VEC> struct Vec;
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ void copy(T* s, const T* g, bool p) { cp_async4(s, g, p); }
};
template <> struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ void copy(T* s, const T* g, bool p) { cp_async8(s, g, p); }
};

// Sums each slot's rows (see the header, steps 2 and 3). A warp takes its
// slot's rows 32 at a time, in ascending b: each lane holds one row index
// and loads its K values, the warp stages the (up to) 32 rows into its
// shared-memory area by cp.async -- every load in flight at once, each lane
// copying the columns it will sum -- and then sums them in order. The rows
// come from the bank's sort (CHUNKED false: order[seg[j] .. seg[j + 1]))
// or from the contract's chunks (CHUNKED true: type j's rows in chunk 0,
// then chunk 1, ..., each chunk's run found by a search over the lanes).
// VEC = 2 moves float2 (T even, co 8-byte aligned), VEC = 1 single floats.
template <int VEC, int K, bool CHUNKED>
__global__ void __launch_bounds__(kAccWarps * 32)
accumulate_kernel(const float* __restrict__ co,     // [B, T]
                  const float* __restrict__ vals,   // [K, B]
                  const int* __restrict__ order,    // bank: rows by slot; contract: chunk_order
                  const int* __restrict__ seg,      // bank: [n_slots + 1]; contract: cnt
                  const int* __restrict__ loff,     // contract only
                  int n_chunks, int n_slots, int B, int T,
                  float* __restrict__ out,          // [K, n_slots, T]
                  float* __restrict__ base) {       // [K, n_slots] or null
  using V = Vec<VEC>;
  using VT = typename V::T;
  constexpr int kPer = kMaxT / (32 * VEC);  // vectors per lane
  extern __shared__ float s_stage[];          // [kAccWarps][32 rows][kPer][32 lanes]
  // launched early (programmatic dependent launch): wait until the sort
  // grid has finished and its writes are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = blockIdx.x * kAccWarps + warp;
  if (slot >= n_slots) return;
  VT* stage = reinterpret_cast<VT*>(s_stage) + warp * 32 * kPer * 32;
  const int nvec = T / VEC;

  float acc[K][kPer * VEC];
  float bacc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bacc[k] = 0.f;
#pragma unroll
    for (int c = 0; c < kPer * VEC; ++c) acc[k][c] = 0.f;
  }

  // stage and sum the next cnt rows, lane l holding the l-th one's index
  auto consume = [&](int my_row, int cnt) {
    float my_v[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      my_v[k] = lane < cnt ? __ldg(vals + (size_t)k * B + my_row) : 0.f;
    for (int r = 0; r < cnt; ++r) {
      const int row = __shfl_sync(0xffffffffu, my_row, r);
      const VT* src = reinterpret_cast<const VT*>(co + (size_t)row * T);
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int j = lane + 32 * q;
        V::copy(&stage[(r * kPer + q) * 32 + lane], src + (j < nvec ? j : 0), j < nvec);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);  // a lane reads back only its own copies
    for (int r = 0; r < cnt; ++r) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float v = __shfl_sync(0xffffffffu, my_v[k], r);
        bacc[k] += v;
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const VT x = stage[(r * kPer + q) * 32 + lane];
          if constexpr (VEC == 2) {
            acc[k][2 * q] = fmaf(x.x, v, acc[k][2 * q]);
            acc[k][2 * q + 1] = fmaf(x.y, v, acc[k][2 * q + 1]);
          } else {
            acc[k][q] = fmaf(x, v, acc[k][q]);
          }
        }
      }
    }
  };

  if constexpr (!CHUNKED) {
    const int s0 = seg[slot], s1 = seg[slot + 1];
    for (int j0 = s0; j0 < s1; j0 += 32) {
      const int cnt = min(32, s1 - j0);
      consume(lane < cnt ? order[j0 + lane] : 0, cnt);
    }
  } else {
    for (int c0 = 0; c0 < n_chunks; c0 += 32) {  // 32 chunks at a time, one per lane
      const int c = c0 + lane;
      const int my_cnt = c < n_chunks ? seg[c * kBins + slot] : 0;
      const int my_off = c < n_chunks ? loff[c * kBins + slot] : 0;
      const int incl = warp_inclusive_scan(my_cnt, lane);
      const int pre = incl - my_cnt;  // the type's rows in the chunks before lane's
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      for (int j0 = 0; j0 < total; j0 += 32) {
        const int j = j0 + lane;
        int cc = 0;  // the last lane whose chunk starts at or before row j
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
          const int probe = __shfl_sync(0xffffffffu, pre, cc + step);
          if (probe <= j) cc += step;
        }
        const int off = __shfl_sync(0xffffffffu, my_off, cc);
        const int first = __shfl_sync(0xffffffffu, pre, cc);
        const int cnt = min(32, total - j0);
        consume(lane < cnt ? order[(c0 + cc) * kChunkRows + off + (j - first)] : 0, cnt);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    VT* dst = reinterpret_cast<VT*>(out + ((size_t)k * n_slots + slot) * T);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int j = lane + 32 * q;
      if (j < nvec) {
        if constexpr (VEC == 2) dst[j] = make_float2(acc[k][2 * q], acc[k][2 * q + 1]);
        else dst[j] = acc[k][q];
      }
    }
    if (base != nullptr && lane == 0) base[(size_t)k * n_slots + slot] = bacc[k];
  }
}

// Opts a kernel into more than 48 KB of dynamic shared memory, once.
template <typename Kernel>
cudaError_t opt_in(Kernel kern, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  *done = err == cudaSuccess;
  return err;
}

struct AccArgs {
  const float* co;
  const float* vals;
  const int* order;
  const int* seg;
  const int* loff;
  int n_chunks, n_slots, B, T;
  float* out;
  float* base;
};

template <int VEC, int K, bool CHUNKED>
cudaError_t launch_accumulate(const AccArgs& a, cudaStream_t stream) {
  constexpr int kBytes = kAccWarps * 32 * (kMaxT / 32) * 32 * 4;  // 32 rows per warp
  auto kern = accumulate_kernel<VEC, K, CHUNKED>;
  static bool opted = false;
  cudaError_t err = opt_in(kern, kBytes, &opted);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.n_slots + kAccWarps - 1) / kAccWarps);
  cfg.blockDim = dim3(kAccWarps * 32);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;  // overlap the sort grid
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a.co, a.vals, a.order, a.seg, a.loff, a.n_chunks,
                           a.n_slots, a.B, a.T, a.out, a.base);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool CHUNKED>
cudaError_t launch_accumulate_vk(int K, bool vec2, const AccArgs& a, cudaStream_t stream) {
  if (vec2) {
    switch (K) {
      case 1: return launch_accumulate<2, 1, CHUNKED>(a, stream);
      case 2: return launch_accumulate<2, 2, CHUNKED>(a, stream);
      case 3: return launch_accumulate<2, 3, CHUNKED>(a, stream);
      default: return launch_accumulate<2, 4, CHUNKED>(a, stream);
    }
  }
  switch (K) {
    case 1: return launch_accumulate<1, 1, CHUNKED>(a, stream);
    case 2: return launch_accumulate<1, 2, CHUNKED>(a, stream);
    case 3: return launch_accumulate<1, 3, CHUNKED>(a, stream);
    default: return launch_accumulate<1, 4, CHUNKED>(a, stream);
  }
}

int digit_passes(int n_rows) {
  int bits = 1;
  while (bits < 31 && (1 << bits) < n_rows) ++bits;
  return (bits + kDigitBits - 1) / kDigitBits;
}

bool vec2_ok(const float* co, int T) {
  return (T % 2 == 0) && ((reinterpret_cast<size_t>(co) & 7) == 0);
}

// The contract: chunk sort, then the accumulate over T slots (one per type).
int launch_contract(const int* types, const float* cbar, const float* vals, float* acc,
                    float* base, int* scratch, int B, int T, int K, cudaStream_t stream) {
  const int n_chunks = (B + kChunkRows - 1) / kChunkRows;
  int* chunk_order = scratch;                        // [C][kChunkRows]
  int* cnt = chunk_order + n_chunks * kChunkRows;    // [C][kBins]
  int* loff = cnt + n_chunks * kBins;                // [C][kBins]
  chunk_sort_kernel<<<n_chunks, kSortThreads, 0, stream>>>(types, B, T, chunk_order, cnt, loff);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const AccArgs a{cbar, vals, chunk_order, cnt, loff, n_chunks, T, B, T, acc, base};
  return (int)launch_accumulate_vk<true>(K, vec2_ok(cbar, T), a, stream);
}

// The bank: the sort over the combined key space, then the accumulate over
// B slots (one per distinct key, the rest zero).
int launch_banked(const int* keys, const float* co, const float* vals, float* rows,
                  int* slot_keys, int* scratch, int B, int T, int K, int n_rows,
                  cudaStream_t stream) {
  int* order = scratch;        // [B]
  int* seg = scratch + B;      // [B + 1]
  int* gk = seg + B + 1;       // [2B] and [2B], above kSmemRows keys only
  int* gr = gk + 2 * B;
  static bool opted = false;
  cudaError_t err = opt_in(bucket_kernel, 16 * kSmemRows, &opted);
  if (err != cudaSuccess) return (int)err;
  const int smem = B <= kSmemRows ? 16 * B : 0;
  bucket_kernel<<<1, kSortThreads, smem, stream>>>(keys, B, n_rows, digit_passes(n_rows), gk, gr,
                                                   order, seg, slot_keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const AccArgs a{co, vals, order, seg, nullptr, 0, B, B, T, rows, nullptr};
  return (int)launch_accumulate_vk<false>(K, vec2_ok(co, T), a, stream);
}

bool bad_shape(int B, int T, int K) {
  return B <= 0 || T <= 0 || T > kMaxT || K <= 0 || K > kMaxK;
}

}  // namespace

// Contract entry. types i32[B], cbar f32[B, T], vals f32[K, B] -> acc
// f32[K, T(t), T(u)] (every row written), base f32[K, T]. scratch: i32
// [3 * 256 * ceil(B / 256)].
extern "C" int pair_scatter_launch(const void* types, const void* cbar, const void* vals,
                                   void* acc, void* base, void* scratch, int B, int T, int K,
                                   void* stream) {
  if (bad_shape(B, T, K)) return (int)cudaErrorInvalidValue;
  return launch_contract((const int*)types, (const float*)cbar, (const float*)vals, (float*)acc,
                         (float*)base, (int*)scratch, B, T, K, (cudaStream_t)stream);
}

// Banked entry. keys i32[B] (bank row * T + type), co f32[B, T], vals
// f32[K, B] -> rows f32[K, B, T] (slot j: the j-th distinct in-range key;
// zeros past the last), slot_keys i32[B] (n_rows past the last key).
// scratch: i32 [2 B + 1], plus [4 B] above kSmemRows rows.
extern "C" int pair_scatter_banked_launch(const void* keys, const void* co, const void* vals,
                                          void* rows, void* slot_keys, void* scratch, int B,
                                          int T, int K, int n_rows, void* stream) {
  if (bad_shape(B, T, K) || n_rows <= 0) return (int)cudaErrorInvalidValue;
  return launch_banked((const int*)keys, (const float*)co, (const float*)vals, (float*)rows,
                       (int*)slot_keys, (int*)scratch, B, T, K, n_rows, (cudaStream_t)stream);
}

extern "C" const char* pair_scatter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
