// The WKV6 recurrence of RWKV6 ("Finch"), for sm_90a: a sequential entry on
// the CUDA cores and a chunked entry on the tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_scan.py (rwkv6_scan ->
// pallas_call at :90, body _wkv_kernel). Same function: for every batch row
// b and head h, with the state S [dh_k, dh_v] starting at s0[b, h], token by
// token
//
//   y_t[j] = sum_i r_t[i] * (S[i, j] + u[h, i] * k_t[i] * v_t[j])
//   S[i,j] <- exp(wlog_t[i]) * S[i, j] + k_t[i] * v_t[j]
//
// then sT[b, h] = S. y and the states are fp32; r, k, v are read in their
// own dtype (bf16 or fp32), wlog, u and s0 are fp32.
//
// Differences from the TPU kernel: the model layout r, k, v, wlog [B, S, H,
// dh], each with its own batch/sequence/head strides (dim stride 1), read
// in place (the TPU wrapper folds and transposes them to [B * H, S, dh]);
// u [H, dh] indexed by h; any S >= 1 (the TPU kernel asserts S % chunk ==
// 0), so decode's S = 1 is one step.
//
// Bound. At the serving prefill (B 8, S 512, H 64, dh 64, bf16 r/k/v) a
// call must move r, k, v (3 x 33.5 MB), wlog (67.1 MB), y (67.1 MB) and
// s0, sT (2 x 8.4 MB), ~252 MB: 0.075 ms at 3.35 TB/s. In decode (S 1) the
// bytes are the states, read and written once (16.8 MB, 0.005 ms).
//
// Entries, picked by the Python wrapper (`entry`) from the dtype and S:
//
// 1. Sequential, CUDA cores: fp32 r/k/v (held to float32 sums), and every
//    decode step. One CTA of dh threads owns one (b, h); thread j holds
//    S[:, j] in registers. The CTA stages kTok tokens at a time through
//    shared memory (r_t, k_t, u * k_t, exp(wlog_t), v_t); per token each
//    thread walks i over the staged rows with two FMAs for y and two ops for
//    S. ~4 dh instructions per token and warp with ~8 warps per SM: at the
//    serving prefill 0.397 ms, 5.3x the bytes bound (H100 80GB HBM3, 700
//    W); at decode 0.0058 ms, near its 0.0052 ms bound.
//
// 2. Chunked, tensor cores: bf16 r/k/v with S > 1 (the prefill). One CTA
//    of 2 dh threads (dh / 16 warps) owns one (b, h) and walks S in chunks
//    of kChunk = 16 tokens. r, k, v and wlog of the next chunk come in
//    through a cp.async double buffer (a ragged last chunk is zero-filled:
//    r = k = v = 0 and wlog = 0 add nothing and keep the state). Per chunk,
//    with cl the inclusive cumulative log2 decay per channel (cle the
//    exclusive one, cl_last = cl[15]):
//      y  = (r * 2^cle) . S  +  A . v,   A[t, s] = sum_i r[t,i] k[s,i] 2^(cle[t,i] - cl[s,i])
//           for s < t, A[t, t] = sum_i r[t,i] u[i] k[t,i] (the bonus)
//      S <- 2^cl_last * S + (k * 2^(cl_last - cl))^T . v
//    Every exponent is <= 0: each is a sum of wlog over tokens in order. A
//    factorisation relative to the chunk's first token, which would overflow
//    fp32 under the served model's decays (-2.7 per token, past -88 within a
//    64-token chunk), is never formed. The matrix A is built on the CUDA
//    cores from two sub-chunks of 8 tokens: the off-diagonal block (queries
//    8..15, keys 0..7) as a product of factors that take their reference at
//    the key sub-chunk's last token, r * 2^(cle - cl[7]) and k * 2^(cl[7] -
//    cl), both <= 1 (64 fp32 multiply-adds per entry, no exponentials); the
//    two diagonal blocks in the direct per-channel form, masked in the log
//    domain, as the Pallas kernel computes its whole chunk. There each
//    thread takes a pair of queries (t, 7 - t) of one block over 4 channels,
//    so the entries spread evenly as independent chains, and a
//    reduce-scatter by shuffles over the 16 (4 at dh 16) lanes of a pair
//    sums them.
//    The state S [dh, dh] stays in registers for the whole sequence as
//    mma.sync.m16n8k16 accumulator fragments of S^T (rows j, columns i):
//    warp w owns value columns j in [16 w, 16 w + 16), so a fragment of
//    S^T is, as it stands, the B fragment of (r * 2^cle) . S, and each
//    warp computes y for its own columns with no exchange between warps.
//    The three products run on mma.sync with ldmatrix (bf16 in, fp32
//    accumulate). r, k, v enter exactly; each fp32 operand -- the decayed r
//    and k, S, and A -- enters as three bf16 parts (hi, mid, lo: 24 bits,
//    all of an fp32 significand). A design study of this arithmetic (bf16
//    parts rounded as here, products exact, fp32 sums) put two parts at 3-5x
//    the plain fp32 version's error from float64 at the serving prefill and
//    under strong decays (wlog = -exp(U[-6, 2])), where the card's witness
//    allows 2x; three parts (six products for (r * 2^cle) . S, three for
//    A . v and for the update) at 0.1-0.4x. On the card (H100 80GB HBM3, 700
//    W) the kernel lies 2.75e-05 from float64 at the serving prefill and
//    8.07e-05 under strong decays, the plain version 1.04e-04 and 1.65e-04.
//    All exponentials are ex2.approx of log2-domain sums.
//    Measured at the serving prefill on that card: 0.215 ms, 1.85x faster
//    than entry 1 (0.397) and 2.9x its bytes bound. Taking parts out one at
//    a time: the loads, barriers and stores alone run 0.088 ms (2.7 TB/s),
//    the matrix A adds 0.075, step 1's decays and parts ~0.045, (r *
//    2^cle) . S ~0.04 and the update ~0.02; the phases overlap only across
//    CTAs (four per SM at 128 registers) and are separated by three
//    barriers per chunk. Keeping the tensor cores busy while the CUDA cores
//    form the next chunk's operands (warp specialisation) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kTok = 32;      // sequential entry: tokens staged per pass
constexpr int kChunk = 16;    // chunked entry: tokens per chunk
constexpr int kHalf = kChunk / 2;  // chunked entry: tokens per sub-chunk of the matrix A
constexpr int kParts = 3;     // chunked entry: bf16 parts of an fp32 operand
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;
  float* y;
  float* sT;
  long long r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh;  // elements
  int S, H;
};

// ---------------------------------------------------------------------------
// Entry 1: sequential, CUDA cores.

template <typename T, int DH>
__global__ void __launch_bounds__(DH)
rwkv6_scan_kernel(const Args a) {
  __shared__ __align__(16) float Rs[kTok][DH];
  __shared__ __align__(16) float Ks[kTok][DH];
  __shared__ __align__(16) float KUs[kTok][DH];
  __shared__ __align__(16) float Es[kTok][DH];
  __shared__ __align__(16) float Vs[kTok][DH];

  const int j = threadIdx.x;
  const int b = (int)blockIdx.x / a.H, h = (int)blockIdx.x % a.H;
  const long long bh = (long long)blockIdx.x;
  const T* r = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh + j;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh + j;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + j;
  const float* w = a.w + b * a.w_sb + h * a.w_sh + j;
  float* y = a.y + ((long long)b * a.S * a.H + h) * DH + j;  // y is [B, S, H, DH] contiguous
  const long long y_ss = (long long)a.H * DH;
  const float uj = a.u[h * DH + j];

  float s[DH];  // S[:, j]
  const float* s0 = a.s0 + bh * DH * DH + j;
#pragma unroll
  for (int i = 0; i < DH; ++i) s[i] = s0[i * DH];

  for (int t0 = 0; t0 < a.S; t0 += kTok) {
    const int n = a.S - t0 < kTok ? a.S - t0 : kTok;
    __syncthreads();  // the previous pass has read the staged rows
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const long long tt = t0 + t;
      const float kv = to_float(k[tt * a.k_ss]);
      Rs[t][j] = to_float(r[tt * a.r_ss]);
      Ks[t][j] = kv;
      KUs[t][j] = uj * kv;
      Es[t][j] = expf(w[tt * a.w_ss]);  // wlog <= 0: a decay in (0, 1]
      Vs[t][j] = to_float(v[tt * a.v_ss]);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = Vs[t][j];
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;  // four chains, not one
#pragma unroll
      for (int i = 0; i < DH; i += 4) {
        const float4 rr = *reinterpret_cast<const float4*>(&Rs[t][i]);
        const float4 kk = *reinterpret_cast<const float4*>(&Ks[t][i]);
        const float4 ku = *reinterpret_cast<const float4*>(&KUs[t][i]);
        const float4 ee = *reinterpret_cast<const float4*>(&Es[t][i]);
        acc0 = fmaf(rr.x, fmaf(ku.x, vj, s[i + 0]), acc0);
        acc1 = fmaf(rr.y, fmaf(ku.y, vj, s[i + 1]), acc1);
        acc2 = fmaf(rr.z, fmaf(ku.z, vj, s[i + 2]), acc2);
        acc3 = fmaf(rr.w, fmaf(ku.w, vj, s[i + 3]), acc3);
        s[i + 0] = fmaf(ee.x, s[i + 0], kk.x * vj);
        s[i + 1] = fmaf(ee.y, s[i + 1], kk.y * vj);
        s[i + 2] = fmaf(ee.z, s[i + 2], kk.z * vj);
        s[i + 3] = fmaf(ee.w, s[i + 3], kk.w * vj);
      }
      y[(t0 + t) * y_ss] = (acc0 + acc1) + (acc2 + acc3);
    }
  }

  float* sT = a.sT + bh * DH * DH + j;
#pragma unroll
  for (int i = 0; i < DH; ++i) sT[i * DH] = s[i];
}

// ---------------------------------------------------------------------------
// Entry 2: chunked, tensor cores (bf16 r/k/v). Fragment layouts of
// mma.sync.m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"), g =
// lane / 4, c = lane % 4:
//   A (16 x 16, row): reg0 (row g, k 2c..2c+1), reg1 (row g+8, k 2c..),
//                     reg2 (row g, k 2c+8..), reg3 (row g+8, k 2c+8..)
//   B (16 x 8, col):  reg0 (k 2c..2c+1, n g), reg1 (k 2c+8.., n g)
//   C (16 x 8):       c0, c1 (row g, n 2c, 2c+1), c2, c3 (row g+8, n 2c, 2c+1)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared, or 16 zero bytes when bytes == 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(const void* p, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(const void* p, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d += a . b on one m16n8k16 tile
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float ex2(float x) {  // 2^x, approximate (2 ulp); ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// four bf16 (8-byte aligned) as floats
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
// x as kParts bf16 parts, each rounded to nearest from what the earlier ones
// left (the remainders are exact in fp32), into p[0] (the largest) ..
__device__ __forceinline__ void split_parts(float x, __nv_bfloat16* p, int stride) {
#pragma unroll
  for (int t = 0; t < kParts; ++t) {
    const __nv_bfloat16 q = __float2bfloat16_rn(x);
    p[t * stride] = q;
    x -= __bfloat162float(q);
  }
}
// two floats as kParts bf16x2 words (x in the low half)
__device__ __forceinline__ void split_pair(float x, float y, unsigned (&p)[kParts]) {
#pragma unroll
  for (int t = 0; t < kParts; ++t) {
    const __nv_bfloat162 q = __floats2bfloat162_rn(x, y);
    p[t] = *reinterpret_cast<const unsigned*>(&q);
    x -= __low2float(q);
    y -= __high2float(q);
  }
}

// A reduce-scatter over lanes xor O, O / 2, .., 1: a lane with bit O of
// grp set keeps the upper M of its 2M values and sends the lower, its
// partner the reverse, and each adds what it receives; once one value is
// left (M = 0) the remaining steps sum it over the lanes.
template <int O, int M, int NV>
__device__ __forceinline__ void reduce_scatter(float (&p)[NV], int grp) {
  if constexpr (O > 0) {
    if constexpr (M > 0) {
      const bool up = grp & O;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const float send = up ? p[j] : p[j + M], keep = up ? p[j + M] : p[j];
        p[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
    } else {
      p[0] += __shfl_xor_sync(0xffffffffu, p[0], O);
    }
    reduce_scatter<O / 2, M / 2>(p, grp);
  }
}

template <int DH>
struct ChunkSmem {
  static constexpr int LDS = DH + 8;  // bf16 row stride: 16 bytes of padding keep ldmatrix conflict-free
  __nv_bfloat16 rkv[2][3][kChunk][LDS];   // r, k, v of a chunk, double-buffered
  float w[2][kChunk][DH];                 // wlog, double-buffered
  __nv_bfloat16 rd[kParts][kChunk][LDS];  // r * 2^cle, in parts
  __nv_bfloat16 kd[kParts][kChunk][LDS];  // k * 2^(cl_last - cl), in parts
  __nv_bfloat16 att[kParts][kChunk][kChunk + 8];  // the chunk's matrix A, in parts
  float cl[kChunk][DH];                   // inclusive cumulative log2 decay
  float qa[kHalf][DH + 8];                // r * 2^(cle - cl[7]), queries 8..15
  float kb[kHalf][DH + 8];                // k * 2^(cl[7] - cl), keys 0..7
  float dl[DH];                           // 2^cl_last
  float u[DH];
};

template <int DH>
__global__ void __launch_bounds__(2 * DH, DH == 64 ? 4 : 8)
rwkv6_scan_chunked_kernel(const Args a) {
  constexpr int NT = 2 * DH;     // threads
  constexpr int LDS = ChunkSmem<DH>::LDS;
  constexpr int NI = DH / 8;     // n8 tiles of S^T over i
  constexpr int G = DH / 4;      // channel groups of 4 for the matrix A
  __shared__ __align__(16) ChunkSmem<DH> sm;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int b = (int)blockIdx.x / a.H, h = (int)blockIdx.x % a.H;
  const long long bh = (long long)blockIdx.x;
  const __nv_bfloat16* rsrc = static_cast<const __nv_bfloat16*>(a.r) + b * a.r_sb + h * a.r_sh;
  const __nv_bfloat16* ksrc = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* vsrc = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* wsrc = a.w + b * a.w_sb + h * a.w_sh;
  const int n_chunks = (a.S + kChunk - 1) / kChunk;

  // one chunk's r, k, v and wlog into stage ch & 1 as one cp.async group
  // (an empty group past the last chunk keeps the wait counts uniform)
  auto issue = [&](int ch) {
    if (ch < n_chunks) {
      const int st = ch & 1, t0 = ch * kChunk;
      for (int e = tid; e < 3 * kChunk * (DH / 8); e += NT) {
        const int arr = e / (kChunk * (DH / 8)), rem = e % (kChunk * (DH / 8));
        const int row = rem / (DH / 8), col = rem % (DH / 8) * 8;
        const bool ok = t0 + row < a.S;
        const __nv_bfloat16* src = arr == 0 ? rsrc : arr == 1 ? ksrc : vsrc;
        const long long ss = arr == 0 ? a.r_ss : arr == 1 ? a.k_ss : a.v_ss;
        cp_async16(&sm.rkv[st][arr][row][col], ok ? src + (long long)(t0 + row) * ss + col : src,
                   ok ? 16 : 0);
      }
      for (int e = tid; e < kChunk * (DH / 4); e += NT) {
        const int row = e / (DH / 4), col = e % (DH / 4) * 4;
        const bool ok = t0 + row < a.S;
        cp_async16(&sm.w[st][row][col], ok ? wsrc + (long long)(t0 + row) * a.w_ss + col : wsrc,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  issue(0);

  if (tid < DH) sm.u[tid] = a.u[h * DH + tid];
  {  // A's entries above the diagonal are never written: zero once
    __nv_bfloat16* att = &sm.att[0][0][0];
    for (int e = tid; e < kParts * kChunk * (kChunk + 8); e += NT) att[e] = __float2bfloat16(0.f);
  }
  // S^T fragments: st[ni][e] = S^T[j][i] = S[i][j], j = 16 warp + g + 8 (e >> 1),
  // i = 8 ni + 2c + (e & 1)
  float st[NI][4];
  {
    const float* s0 = a.s0 + bh * DH * DH;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[ni][e] = s0[(8 * ni + 2 * c + (e & 1)) * DH + 16 * warp + g + 8 * (e >> 1)];
  }

  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<0>();
    // chunk ch has landed for every thread, and every thread is done with
    // chunk ch - 1: its stage and the tables may be overwritten
    __syncthreads();
    issue(ch + 1);  // overlaps this chunk's work
    const int stg = ch & 1, t0 = ch * kChunk;
    const int n = a.S - t0 < kChunk ? a.S - t0 : kChunk;
    const __nv_bfloat16(*R)[LDS] = sm.rkv[stg][0];
    const __nv_bfloat16(*K)[LDS] = sm.rkv[stg][1];
    const __nv_bfloat16(*V)[LDS] = sm.rkv[stg][2];

    // 1. cumulative log2 decays of channel i (both halves of the CTA form
    //    the same sums), then in the first half r * 2^cle in parts and the
    //    off-diagonal block's query factors r * 2^(cle - cl[7]) (tokens
    //    8..15), in the second k * 2^(cl_last - cl) in parts, 2^cl_last and
    //    the block's key factors k * 2^(cl[7] - cl) (tokens 0..7). cl never
    //    rises, so every exponent is <= 0
    {
      const int i = tid % DH;
      float cl[kChunk];
      float run = 0.f;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        run = fmaf(sm.w[stg][t][i], kLog2e, run);
        cl[t] = run;
      }
      const float mid = cl[kHalf - 1];
      if (tid < DH) {
#pragma unroll
        for (int t = 0; t < kChunk; ++t) {
          const float cle = t ? cl[t - 1] : 0.f, rt = __bfloat162float(R[t][i]);
          sm.cl[t][i] = cl[t];
          split_parts(rt * ex2(cle), &sm.rd[0][t][i], kChunk * LDS);
          if (t >= kHalf) sm.qa[t - kHalf][i] = rt * ex2(cle - mid);
        }
      } else {
        const float last = cl[kChunk - 1];
#pragma unroll
        for (int t = 0; t < kChunk; ++t) {
          const float kt = __bfloat162float(K[t][i]);
          split_parts(kt * ex2(last - cl[t]), &sm.kd[0][t][i], kChunk * LDS);
          if (t < kHalf) sm.kb[t][i] = kt * ex2(mid - cl[t]);
        }
        sm.dl[i] = ex2(last);
      }
    }
    __syncthreads();

    // 2. the chunk's matrix A on the CUDA cores, as two sub-chunks of 8
    //    tokens. The off-diagonal block (queries 8..15, keys 0..7) is a
    //    product of step 1's factors, both <= 1 with their reference at the
    //    key sub-chunk's last token: A[t, s] = sum_i qa[t, i] kb[s, i], two
    //    threads per entry, each on half of the channels
    {
      const int c0 = 4 * (tid & 1);  // channels c0 + 8 m .. + 3: no bank conflicts
#pragma unroll
      for (int e = tid / 2; e < kHalf * kHalf; e += NT / 2) {
        const int t = e / kHalf, s = e % kHalf;
        float acc[4] = {};
#pragma unroll
        for (int x = c0; x < DH; x += 8) {
          const float4 q4 = *reinterpret_cast<const float4*>(&sm.qa[t][x]);
          const float4 k4 = *reinterpret_cast<const float4*>(&sm.kb[s][x]);
          acc[0] = fmaf(q4.x, k4.x, acc[0]);
          acc[1] = fmaf(q4.y, k4.y, acc[1]);
          acc[2] = fmaf(q4.z, k4.z, acc[2]);
          acc[3] = fmaf(q4.w, k4.w, acc[3]);
        }
        float p = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        if (!(tid & 1)) split_parts(p, &sm.att[0][kHalf + t][s], kChunk * (kChunk + 8));
      }
    }
    //    The two diagonal blocks in the direct form, masked in the log
    //    domain: thread (hb, tp, grp) takes queries tp and 7 - tp of block
    //    hb over channels 4 grp .. 4 grp + 3 and every key of the block, as
    //    independent chains; the G lanes of one (hb, tp) are neighbours,
    //    and a reduce-scatter over them leaves each lane the whole sums of
    //    kHalf / min(G, kHalf) keys
    {
      constexpr int kHeld = G < kHalf ? kHalf / G : 1;  // sums a lane ends with
      constexpr int kSpan = G < kHalf ? 1 : G / kHalf;  // lanes that hold the same sums
      const int grp = tid % G, combo = tid / G, hb = combo / 4, tp = combo % 4, i0 = 4 * grp;
      const float4 u4 = *reinterpret_cast<const float4*>(&sm.u[i0]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ql = half ? kHalf - 1 - tp : tp, tq = kHalf * hb + ql;
        const int qmax = __reduce_max_sync(0xffffffffu, ql);  // warp-uniform
        const float4 r4 = load4(&R[tq][i0]), kq = load4(&K[tq][i0]);
        const float4 e4 = tq ? *reinterpret_cast<const float4*>(&sm.cl[tq - 1][i0])
                             : make_float4(0.f, 0.f, 0.f, 0.f);  // cle of tq
        const float rq[4] = {r4.x, r4.y, r4.z, r4.w}, eq[4] = {e4.x, e4.y, e4.z, e4.w};
        // the bonus on the diagonal: sum over the 4 channels of r u k
        const float bonus = fmaf(r4.w * u4.w, kq.w, fmaf(r4.z * u4.z, kq.z,
                                 fmaf(r4.y * u4.y, kq.y, r4.x * u4.x * kq.x)));
        float p[kHalf];
#pragma unroll
        for (int sl = 0; sl < kHalf; ++sl) {
          p[sl] = 0.f;
          if (sl <= qmax) {  // warp-uniform
            const int s = kHalf * hb + sl;
            const float4 ks = load4(&K[s][i0]), cs = *reinterpret_cast<const float4*>(&sm.cl[s][i0]);
            const float kx[4] = {ks.x, ks.y, ks.z, ks.w}, cx[4] = {cs.x, cs.y, cs.z, cs.w};
            float off = 0.f;
#pragma unroll
            for (int x = 0; x < 4; ++x)
              off = fmaf(rq[x] * kx[x], ex2(sl < ql ? eq[x] - cx[x] : -INFINITY), off);
            p[sl] = sl == ql ? bonus : off;
          }
        }
        reduce_scatter<G / 2, kHalf / 2>(p, grp);
        if (grp % kSpan == 0) {
#pragma unroll
          for (int j = 0; j < kHeld; ++j) {
            const int sl = kHeld * (grp / kSpan) + j;
            if (sl <= ql) split_parts(p[j], &sm.att[0][tq][kHalf * hb + sl], kChunk * (kChunk + 8));
          }
        }
      }
    }
    __syncthreads();

    // 3. tensor cores, warp w on value columns [16 w, 16 w + 16):
    //    y = (r * 2^cle) . S + A . v; then S^T <- S^T * 2^cl_last + v^T . kd
    {
      const int arow = (lane & 7) + 8 * ((lane >> 3) & 1), acol = 8 * (lane >> 4);
      // two sets of accumulators (even and odd k blocks) halve the MMAs' chains
      float yacc[2][4] = {}, yodd[2][4] = {};
#pragma unroll
      for (int kb = 0; kb < DH / 16; ++kb) {
        unsigned ra[kParts][4];
#pragma unroll
        for (int p = 0; p < kParts; ++p) ldsm_x4(&sm.rd[p][arow][16 * kb + acol], ra[p]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          unsigned b0[kParts], b1[kParts];  // S over i in [16 kb, 16 kb + 16), j in tile nt
          split_pair(st[2 * kb][2 * nt], st[2 * kb][2 * nt + 1], b0);
          split_pair(st[2 * kb + 1][2 * nt], st[2 * kb + 1][2 * nt + 1], b1);
          // the six products of parts up to second order, the smallest first
          float(&d)[4] = kb & 1 ? yodd[nt] : yacc[nt];
          mma_bf16(d, ra[2], b0[0], b1[0]);
          mma_bf16(d, ra[0], b0[2], b1[2]);
          mma_bf16(d, ra[1], b0[1], b1[1]);
          mma_bf16(d, ra[1], b0[0], b1[0]);
          mma_bf16(d, ra[0], b0[1], b1[1]);
          mma_bf16(d, ra[0], b0[0], b1[0]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[nt][e] += yodd[nt][e];
      {
        unsigned bv[4];
        ldsm_x4_trans(&V[arow][16 * warp + acol], bv);
#pragma unroll
        for (int p = kParts - 1; p >= 0; --p) {
          unsigned aa[4];
          ldsm_x4(&sm.att[p][arow][acol], aa);
          mma_bf16(yacc[0], aa, bv[0], bv[1]);
          mma_bf16(yacc[1], aa, bv[2], bv[3]);
        }
      }
      float* yb = a.y + (((long long)b * a.S + t0) * a.H + h) * DH + 16 * warp + 2 * c;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = g + 8 * hf;
          if (t < n)
            *reinterpret_cast<float2*>(yb + (long long)t * a.H * DH + 8 * nt) =
                make_float2(yacc[nt][2 * hf], yacc[nt][2 * hf + 1]);
        }

#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[ni][e] *= sm.dl[8 * ni + 2 * c + (e & 1)];
      unsigned va[4];  // v^T over the warp's 16 columns and the 16 tokens
      ldsm_x4_trans(&V[(lane & 7) + 8 * (lane >> 4)][16 * warp + 8 * ((lane >> 3) & 1)], va);
#pragma unroll
      for (int ni = 0; ni < NI; ni += 2)
#pragma unroll
        for (int p = kParts - 1; p >= 0; --p) {
          unsigned bk[4];
          ldsm_x4_trans(&sm.kd[p][arow][8 * ni + acol], bk);
          mma_bf16(st[ni], va, bk[0], bk[1]);
          mma_bf16(st[ni + 1], va, bk[2], bk[3]);
        }
    }
  }

  float* sT = a.sT + bh * DH * DH;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sT[(8 * ni + 2 * c + (e & 1)) * DH + 16 * warp + g + 8 * (e >> 1)] = st[ni][e];
}

bool bad_grid(int B, int S, int H) {
  return B <= 0 || S <= 0 || H <= 0 || (long long)B * H > 0x7fffffffLL;
}

template <typename T, int DH>
int launch(const Args& a, int B, cudaStream_t stream) {
  rwkv6_scan_kernel<T, DH><<<(unsigned)((long long)B * a.H), DH, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const Args& a, int B, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int DH>
int launch_chunked(const Args& a, int B, cudaStream_t stream) {
  rwkv6_scan_chunked_kernel<DH><<<(unsigned)((long long)B * a.H), 2 * DH, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

Args make_args(const void* r, const void* k, const void* v, const void* wlog, const void* u,
               const void* s0, void* y, void* sT, int S, int H, long long r_sb, long long r_ss,
               long long r_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
               long long v_ss, long long v_sh, long long w_sb, long long w_ss, long long w_sh) {
  return Args{r, k, v, static_cast<const float*>(wlog), static_cast<const float*>(u),
              static_cast<const float*>(s0), static_cast<float*>(y), static_cast<float*>(sT),
              r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh, S, H};
}

}  // namespace

// The sequential entry. rkv_bf16: 1 for bf16 r/k/v, 0 for fp32. Strides are
// in elements (the dim stride is 1); u [H, dh], s0 and sT [B, H, dh, dh] and
// y [B, S, H, dh] are contiguous (checked by the Python wrapper). sT may not
// alias s0.
extern "C" int rwkv6_scan_launch(
    const void* r, const void* k, const void* v, const void* wlog, const void* u,
    const void* s0, void* y, void* sT, int rkv_bf16, int dh, int B, int S, int H,
    long long r_sb, long long r_ss, long long r_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long w_sb, long long w_ss, long long w_sh, void* stream) {
  if (bad_grid(B, S, H)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(r, k, v, wlog, u, s0, y, sT, S, H, r_sb, r_ss, r_sh, k_sb, k_ss,
                           k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh);
  cudaStream_t s = (cudaStream_t)stream;
  if (rkv_bf16) return launch_dh<__nv_bfloat16>(a, B, dh, s);
  return launch_dh<float>(a, B, dh, s);
}

// The chunked entry: bf16 r, k, v and fp32 wlog, each with 16-byte aligned
// pointers and strides (checked by the Python wrapper); the rest as above.
extern "C" int rwkv6_scan_chunked_launch(
    const void* r, const void* k, const void* v, const void* wlog, const void* u,
    const void* s0, void* y, void* sT, int dh, int B, int S, int H,
    long long r_sb, long long r_ss, long long r_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long w_sb, long long w_ss, long long w_sh, void* stream) {
  if (bad_grid(B, S, H)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(r, k, v, wlog, u, s0, y, sT, S, H, r_sb, r_ss, r_sh, k_sb, k_ss,
                           k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh);
  cudaStream_t s = (cudaStream_t)stream;
  switch (dh) {
    case 16: return launch_chunked<16>(a, B, s);
    case 64: return launch_chunked<64>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rwkv6_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
