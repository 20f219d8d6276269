// Flash attention with the GQA head map in the kernel, for sm_90a: a CUDA-core
// entry for fp32 q and two tensor-core entries for bf16 q.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention -> _flash_kernel). Same function: for every batch row b,
// query head h (kv head h / G, G = H / Hkv) and query i,
//
//   s_j   = (q[b, i, h] . k[b, j, h / G]) / sqrt(dh)
//   out   = sum_j softmax_j(s) v[b, j, h / G]       over visible j,
//
// visible meaning j < Skv, when causal q_offset + i >= j, and with a sliding
// window (window > 0) j > q_offset + i - window. Scores, softmax and the
// P.V sums are fp32 (online softmax: running max m and denominator l per
// row, acc rescaled by exp(m_old - m_new)); the output is divided by
// max(l, 1e-30) and written in q's dtype.
//
// Differences from the TPU layout:
//   * model layout: q [B, Sq, H, dh], k/v [B, Skv, Hkv, dh], each with its
//     own batch/sequence/head strides (dim stride 1), so k and v are read
//     in place as slices of the [L, B, T, Hkv, dh] cache; the TPU wrapper
//     repeats k/v G times and transposes them first;
//   * q_offset and the sliding window are runtime arguments: each row has a
//     lower limit beside its upper one, and a CTA reads only the kv rows
//     some query of it sees (the TPU wrapper's model slices the cache to
//     the last window + S rows instead);
//   * ragged Sq and Skv: tails are masked, no block divisibility;
//   * dh in {16, 32, 64, 128}. Every CTA packs BQ consecutive queries x Gc
//     heads of one GQA group into its rows, so each k/v row it loads serves
//     all of them.
//
// Entries, picked by the Python wrapper from the dtypes and Sq:
//
// 1. CUDA cores, fp32 q (k/v fp32, or bf16: the float32-compute model
//    reading its bf16 cache). Held to 2e-5, which bf16 products cannot
//    meet (and TF32 is ruled out). A CTA of 4 warps owns 16 rows and walks
//    the kv rows in tiles of 128, one row per lane: scores by fp32 FMA with
//    q broadcast from shared memory, P.V with dh/32 output columns per
//    lane; the warps' (m, l, acc) merge in warp order. Bound by the FMA
//    issue rate, ~60x the bytes bound at the serving prefill.
//
// 2. Tensor cores, bf16 q and k/v, Sq > 1 (prefill). The FA2 schedule on
//    mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with ldmatrix, not wgmma:
//    wgmma's shared-memory descriptors and warpgroup layouts could not be
//    brought up without a compiler beside the source, and mma.sync met the
//    accuracy gates first. A CTA of 4 warps owns 64 rows (tinyllama: 8
//    queries x 8 heads; jamba: 16 x 4), 16 per warp. K and V tiles of 64
//    rows stream through a cp.async ring in shared memory (3 stages up to
//    dh 64, 2 at dh 128; rows padded by 16 bytes, so ldmatrix is
//    conflict-free); the next tiles' copies overlap this tile's products.
//    S = Q.K^T runs on the tensor cores (bf16 x bf16 products are exact in
//    fp32); masks (only on tiles that cut some row's range) and the online
//    softmax stay in fp32 registers, in base 2; tiles wholly above the
//    diagonal or below the window are never loaded, and a warp skips tiles
//    its own rows do not see. The score fragments are the A fragments of
//    P.V as they stand. A CTA's and a warp's kv ranges come from their first
//    and last queries, not row by row: per-row integer work in the prologue
//    once cost more than the products. At the serving prefill (B 8, Sq 512,
//    Skv 672, H 32, Hkv 4, dh 64) the call must move q and out (33.6 MB)
//    and the 512 visible k/v rows (4.2 MB): 0.011 ms at 3.35 TB/s, a little
//    above its 8.6 GFLOP at the bf16 tensor-core peak; this entry is held
//    back by latency (2-3 CTAs of 4 warps per SM at 168-255 registers) and
//    by the P split's MMAs and conversions between the products.
//
//    P.V at fp32 accuracy. p is fp32 (as in the TPU kernel, whose
//    jax.lax.dot(p, v) is float32); rounding P to bf16 before P.V (as FA2,
//    FA3 and SDPA do) moves a near-zero output by up to 2^-9 of the terms
//    that cancel in it, many bf16 ulps of the output. So P is split into
//    three bf16 parts, P_hi = bf16(p), P_lo = bf16(p - P_hi), and a third
//    from the rest, each an MMA against the same V fragments: two parts
//    carry ~16 bits of p, three all 24 (exact). With two parts, ~20x more
//    outputs of the served hybrid's attention landed more than one bf16 ulp
//    from float64 than the plain version's (~10x when P_hi rounds; its gate
//    allows 2x + 64); with three, fewer than the plain version's. Each
//    tile's P.V starts from zero on the tensor cores and
//    joins acc by one fp32 FMA (acc * alpha + PV), so the tensor cores' own
//    accumulation spans 64 kv rows at a time. l is summed from the fp32 p.
//
// 3. Tensor cores, bf16, Sq = 1 (decode; flash-decoding). A CTA owns 16
//    rows (tinyllama: 1 query x 8 heads) and one split of the visible kv
//    rows (grid B x Hkv x splits; the split count, from the visible rows
//    and the CTA count, is the wrapper's split_plan: 256 CTAs at B 8,
//    Hkv 4, 512 rows); its 4 warps take 16 kv columns of each 64-row tile,
//    and merge in warp order into one partial (m, l, acc). A second kernel
//    combines each row's partials in split order, one thread per output:
//    no float atomics, so outputs are bitwise equal from run to run. Decode
//    is bound by the cache bytes (4.2 MB at decode@511, each row read once
//    per kv head); its gain is parallelism: 32 CTAs walked the cache in
//    entry 1's design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kWarps * 32;  // kv rows per iteration: one per lane
constexpr int kRows = 16;           // query rows (query x head) per CTA
constexpr int kPad = 4;             // shared-memory row padding, in elements
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;  // element strides
  int Sq, Skv, H, Hkv, q_offset, causal, window;
  float scale;       // 1 / sqrt(dh)
  float scale_log2;  // scale * log2(e): the tensor-core entries' softmax runs in base 2
  // tensor-core entries: split partials [grid x, y, n_split][16][dh + 2] (decode),
  // kv rows per split (a multiple of the kv tile)
  void* part;
  int n_split, split_rows;
};

template <typename TKV, int DH>
constexpr int tile_bytes() {
  return 2 * kTile * (DH + kPad) * (int)sizeof(TKV);
}
template <int DH>
constexpr int merge_bytes() {
  return kWarps * kRows * (DH + 2) * (int)sizeof(float);
}
template <typename TKV, int DH>
constexpr int smem_bytes() {
  return kRows * DH * (int)sizeof(float) +
         (tile_bytes<TKV, DH>() > merge_bytes<DH>() ? tile_bytes<TKV, DH>() : merge_bytes<DH>());
}

// rows [0, kTile) of one k or v tile, starting at kv row t0, zeros past kv_end
template <typename TKV, int DH>
__device__ __forceinline__ void load_tile(TKV* dst, const TKV* src, long long s_seq, int t0,
                                          int kv_end) {
  constexpr int kPerChunk = 16 / (int)sizeof(TKV);  // elements per 16-byte chunk
  constexpr int kChunks = DH / kPerChunk;            // chunks per row
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int row = c / kChunks;
    const int col = (c % kChunks) * kPerChunk;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + row < kv_end)
      val = *reinterpret_cast<const uint4*>(src + (long long)(t0 + row) * s_seq + col);
    uint2* d = reinterpret_cast<uint2*>(dst + row * (DH + kPad) + col);  // 8-byte aligned rows
    d[0] = make_uint2(val.x, val.y);
    d[1] = make_uint2(val.z, val.w);
  }
}

template <typename TKV, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Args a) {
  constexpr int DPL = DH >= 32 ? DH / 32 : 1;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);                         // [kRows][DH]
  TKV* Ks = reinterpret_cast<TKV*>(smem + kRows * DH * sizeof(float));  // [kTile][DH+kPad]
  TKV* Vs = Ks + kTile * (DH + kPad);
  float* Ps = reinterpret_cast<float*>(Vs + kTile * (DH + kPad));      // [kWarps][kRows][32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.H / a.Hkv;
  const int Gc = G < kRows ? G : kRows;
  const int n_gsplit = (G + Gc - 1) / Gc;
  const int BQ = kRows / Gc;
  const int n_qblk = (a.Sq + BQ - 1) / BQ;
  const int qb = n_qblk - 1 - (int)(blockIdx.x / n_gsplit);  // longest causal rows first
  const int g0 = (int)(blockIdx.x % n_gsplit) * Gc;
  const int b = (int)blockIdx.y / a.Hkv, hk = (int)blockIdx.y % a.Hkv;
  const int i0 = qb * BQ;

  // per row r: query i = i0 + r / Gc, head hk * G + g0 + r % Gc; lo and lim
  // = first and last visible kv row
  int lo[kRows], lim[kRows];
  int kv_end = 0, kv_start = a.Skv;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r / Gc, g = g0 + r % Gc;
    const bool valid = r < BQ * Gc && i < a.Sq && g < G;
    int l = a.Skv - 1;
    if (a.causal && a.q_offset + i < l) l = a.q_offset + i;
    int f = a.window ? a.q_offset + i - a.window + 1 : 0;
    if (f < 0) f = 0;
    lim[r] = valid ? l : -1;
    lo[r] = f;
    kv_end = lim[r] + 1 > kv_end ? lim[r] + 1 : kv_end;
    if (valid && f < kv_start) kv_start = f;
  }

  const float* q = static_cast<const float*>(a.q);
  for (int e = tid; e < kRows * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    const int i = i0 + r / Gc, g = g0 + r % Gc;
    float x = 0.f;
    if (r < BQ * Gc && i < a.Sq && g < G)
      x = to_float(q[b * a.q_sb + (long long)i * a.q_ss + (long long)(hk * G + g) * a.q_sh + d]);
    Qs[e] = x;
  }

  const TKV* kb = static_cast<const TKV*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const TKV* vb = static_cast<const TKV*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  const bool owns = lane * DPL < DH;
  const int col = owns ? lane * DPL : 0;
  float* P = Ps + warp * kRows * 32;

  for (int t0 = kv_start / kTile * kTile; t0 < kv_end; t0 += kTile) {
    load_tile<TKV, DH>(Ks, kb, a.k_ss, t0, kv_end);
    load_tile<TKV, DH>(Vs, vb, a.v_ss, t0, kv_end);
    __syncthreads();

    const int jj = warp * 32 + lane;  // this lane's row of the tile
    const int j = t0 + jj;
    // warp-uniform: the warp's 32 rows hold something visible
    if (t0 + warp * 32 < kv_end && t0 + warp * 32 + 31 >= kv_start) {
      float s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = 0.f;
      const TKV* krow = Ks + jj * (DH + kPad);
#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        const float4 kk = load4(krow + d);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 qq = *reinterpret_cast<const float4*>(Qs + r * DH + d);
          s[r] = fmaf(qq.x, kk.x, s[r]);
          s[r] = fmaf(qq.y, kk.y, s[r]);
          s[r] = fmaf(qq.z, kk.z, s[r]);
          s[r] = fmaf(qq.w, kk.w, s[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool vis = j <= lim[r] && j >= lo[r];
        const float sc = vis ? s[r] * a.scale : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(sc));
        const float p = vis ? expf(sc - m_new) : 0.f;
        const float alpha = expf(m[r] - m_new);
        l[r] = l[r] * alpha + warp_sum(p);
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
        P[r * 32 + lane] = p;
      }
      __syncwarp();
#pragma unroll 2
      for (int u0 = 0; u0 < 32; u0 += 4) {
        float vv[4][DPL];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const TKV* vrow = Vs + (warp * 32 + u0 + u) * (DH + kPad) + col;
          if constexpr (DPL == 4) {
            const float4 t = load4(vrow);
            vv[u][0] = t.x; vv[u][1] = t.y; vv[u][2] = t.z; vv[u][3] = t.w;
          } else {
#pragma unroll
            for (int c = 0; c < DPL; ++c) vv[u][c] = to_float(vrow[c]);
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 p = *reinterpret_cast<const float4*>(P + r * 32 + u0);
#pragma unroll
          for (int c = 0; c < DPL; ++c) {
            float x = acc[r][c];
            x = fmaf(p.x, vv[0][c], x);
            x = fmaf(p.y, vv[1][c], x);
            x = fmaf(p.z, vv[2][c], x);
            acc[r][c] = fmaf(p.w, vv[3][c], x);
          }
        }
      }
      __syncwarp();
    }
    __syncthreads();  // the next tile overwrites Ks and Vs
  }

  // merge the four warps' (m, l, acc) in warp order, through the tile space
  float* Mw = reinterpret_cast<float*>(Ks);
  float* Lw = Mw + kWarps * kRows;
  float* Aw = Lw + kWarps * kRows;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (lane == 0) {
      Mw[warp * kRows + r] = m[r];
      Lw[warp * kRows + r] = l[r];
    }
    if (owns) {
#pragma unroll
      for (int c = 0; c < DPL; ++c) Aw[(warp * kRows + r) * DH + col + c] = acc[r][c];
    }
  }
  __syncthreads();
  float* o = static_cast<float*>(a.o);
  for (int e = tid; e < kRows * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    const int i = i0 + r / Gc, g = g0 + r % Gc;
    if (!(r < BQ * Gc && i < a.Sq && g < G)) continue;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, Mw[w * kRows + r]);
    float Lsum = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(Mw[w * kRows + r] - M);
      Lsum += Lw[w * kRows + r] * f;
      A += Aw[(w * kRows + r) * DH + d] * f;
    }
    const long long row = ((long long)b * a.Sq + i) * a.H + hk * G + g;
    o[row * DH + d] = A / fmaxf(Lsum, 1e-30f);
  }
}

template <typename TKV, int DH>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = smem_bytes<TKV, DH>() + kWarps * kRows * 32 * (int)sizeof(float);
  auto kernel = flash_attention_kernel<TKV, DH>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int G = a.H / a.Hkv;
  const int Gc = G < kRows ? G : kRows;
  const int n_gsplit = (G + Gc - 1) / Gc;
  const int BQ = kRows / Gc;
  const long long nx = (long long)((a.Sq + BQ - 1) / BQ) * n_gsplit;
  const long long ny = (long long)B * a.Hkv;
  if (nx > 0x7fffffffLL || ny > 65535) return (int)cudaErrorInvalidConfiguration;
  kernel<<<dim3((unsigned)nx, (unsigned)ny), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TKV>
int launch_dh(const Args& a, int B, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<TKV, 16>(a, B, stream);
    case 32: return launch<TKV, 32>(a, B, stream);
    case 64: return launch<TKV, 64>(a, B, stream);
    case 128: return launch<TKV, 128>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// Tensor-core entries: bf16 q with bf16 k/v, on mma.sync.m16n8k16 (bf16 in,
// fp32 accumulate). Fragment layouts (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), g = lane / 4, c = lane % 4:
//   A (16 x 16, row): reg0 (row g, k 2c..2c+1), reg1 (row g+8, k 2c..),
//                     reg2 (row g, k 2c+8..), reg3 (row g+8, k 2c+8..)
//   B (16 x 8, col):  reg0 (k 2c..2c+1, n g), reg1 (k 2c+8.., n g)
//   C (16 x 8):       c0, c1 (row g, n 2c, 2c+1), c2, c3 (row g+8, n 2c, 2c+1)
// so the score tile's C fragments of two neighbouring n8 tiles are the A
// fragment of the P.V product over those 16 kv rows, with no data movement.

constexpr int kMmaThreads = 128;   // 4 warps
constexpr int kKvTile = 64;        // kv rows per pipeline stage
// stages of the cp.async ring: 3 up to dh 64 (64.5 KB with the q tile, so
// three CTAs share an SM), 2 at dh 128 (87 KB, two CTAs)
template <int DH>
__host__ __device__ constexpr int stages() {
  return DH <= 64 ? 3 : 2;
}
// CTAs per SM the register budget aims at
template <int DH>
__host__ __device__ constexpr int min_ctas() {
  return DH <= 64 ? 3 : 2;
}
constexpr int kPrefillRows = 64;   // query rows of a prefill CTA: 16 per warp
constexpr int kSplitRows = 16;     // query rows of a split CTA, shared by its warps
constexpr int kPTerms = 3;  // bf16 parts of P in P.V: 3 x 8 bits hold an fp32 p

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared, or 16 zero bytes when bytes == 0
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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
// two floats as bf16, x in the low half. A leading part is cut by
// truncation (one byte permute) and x and y become the remainders x -
// bf16(x), y - bf16(y), exact in fp32 with at most 16 significant bits; the
// last part rounds to nearest. So three parts hold a normal fp32 exactly,
// and one part is the rounding FA2 and SDPA use.
template <bool last>
__device__ __forceinline__ unsigned split_bf16x2(float& x, float& y) {
  if (last) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const unsigned*>(&h);
  }
  const unsigned ux = __float_as_uint(x), uy = __float_as_uint(y);
  x -= __uint_as_float(ux & 0xffff0000u);
  y -= __uint_as_float(uy & 0xffff0000u);
  return __byte_perm(ux, uy, 0x7632);
}

// Which (query, head) a CTA row is, and its visible kv rows [lo, lim].
struct RowMap {
  int G, Gc, BQ, i0, g0, b, hk;
  template <int ROWS>
  __device__ __forceinline__ void init(const Args& a) {
    G = a.H / a.Hkv;
    Gc = G < ROWS ? G : ROWS;
    const int n_gsplit = (G + Gc - 1) / Gc;
    BQ = ROWS / Gc;
    const int n_qblk = (a.Sq + BQ - 1) / BQ;
    i0 = (n_qblk - 1 - (int)(blockIdx.x / n_gsplit)) * BQ;  // longest causal rows first
    g0 = (int)(blockIdx.x % n_gsplit) * Gc;
    b = (int)blockIdx.y / a.Hkv;
    hk = (int)blockIdx.y % a.Hkv;
  }
  __device__ __forceinline__ bool valid(const Args& a, int r) const {
    return r < BQ * Gc && i0 + r / Gc < a.Sq && g0 + r % Gc < G;
  }
  // the visible kv rows [lo, lim] of query i; both grow with i
  __device__ __forceinline__ static void query_limits(const Args& a, int i, int& lo, int& lim) {
    lim = a.Skv - 1;
    if (a.causal && a.q_offset + i < lim) lim = a.q_offset + i;
    lo = a.window ? a.q_offset + i - a.window + 1 : 0;
    if (lo < 0) lo = 0;
  }
  // of row r; an invalid row sees nothing: lo > lim
  __device__ __forceinline__ void limits(const Args& a, int r, int& lo, int& lim) const {
    query_limits(a, i0 + r / Gc, lo, lim);
    if (!valid(a, r)) lo = a.Skv, lim = -1;
  }
  // the queries [first, last] of rows [r0, r1) (last < first: none valid);
  // each has a valid row there (its first head, g0, is one)
  __device__ __forceinline__ void queries(const Args& a, int r0, int r1, int& first,
                                          int& last) const {
    first = i0 + r0 / Gc;
    last = min(i0 + (min(r1, BQ * Gc) - 1) / Gc, a.Sq - 1);
    if (r0 >= BQ * Gc) last = first - 1;
  }
  __device__ __forceinline__ long long q_index(const Args& a, int r) const {
    return b * a.q_sb + (long long)(i0 + r / Gc) * a.q_ss + (long long)(hk * G + g0 + r % Gc) * a.q_sh;
  }
  __device__ __forceinline__ long long out_row(const Args& a, int r) const {
    return ((long long)b * a.Sq + i0 + r / Gc) * a.H + hk * G + g0 + r % Gc;
  }
};

// kv rows [t0, t0 + kKvTile) of k or v into a [kKvTile][DH + 8] tile; rows
// outside [lo, hi) are zero-filled, so they add exact zeros
template <int DH>
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                             long long s_seq, int t0, int lo, int hi) {
  constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kKvTile * kChunks; c += kMmaThreads) {
    const int row = c / kChunks, col = (c % kChunks) * 8;
    const int j = t0 + row;
    const bool in = j >= lo && j < hi;
    cp_async16(smem_u32(dst + row * (DH + 8) + col), in ? src + (long long)j * s_seq + col : src,
               in ? 16 : 0);
  }
}

template <int DH>
constexpr int mma_smem_bytes(int rows) {
  return (rows + stages<DH>() * 2 * kKvTile) * (DH + 8) * 2;
}

// The shared body of both tensor-core kernels.
// PREFILL (SPLIT false): a CTA owns 64 query rows, warp w rows 16w..16w+15,
// and every warp walks the whole of each kv tile. SPLIT: a CTA owns 16 query
// rows and one range of kv rows (split blockIdx.z); warp w takes kv columns
// 16w..16w+15 of each tile, and the four warps' states are merged in warp
// order into one partial (m, l, acc) per CTA.
template <int DH, bool SPLIT>
__device__ __forceinline__ void mma_body(const Args& a) {
  constexpr int LDS = DH + 8;  // smem row stride: 16 bytes of padding keep ldmatrix conflict-free
  constexpr int ROWS = SPLIT ? kSplitRows : kPrefillRows;
  constexpr int NC = SPLIT ? 16 : kKvTile;  // kv columns per warp per tile
  constexpr int KD = DH / 16;               // k steps of Q.K^T
  constexpr int ND = DH / 8;                // n8 tiles of the output
  constexpr int NH = ND < 8 ? ND : 8;       // output n8 tiles per P.V pass
  constexpr int NS = NC / 8;                // n8 tiles of the scores
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [ROWS][LDS]
  constexpr int ST = stages<DH>();
  __nv_bfloat16* KV = Qs + ROWS * LDS;                         // [ST][k, v][kKvTile][LDS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  RowMap rm;
  rm.init<ROWS>(a);

  // the CTA's kv rows [kv_lo, kv_hi) (a split's share of them): from its
  // first query's first row to its last query's last
  int q_first, q_last, kv_lo, kv_hi, l0, l1;
  rm.queries(a, 0, ROWS, q_first, q_last);
  RowMap::query_limits(a, q_first, kv_lo, l1);
  RowMap::query_limits(a, q_last, l0, kv_hi);
  ++kv_hi;
  if (SPLIT) {
    const int base = kv_lo / kKvTile * kKvTile;
    kv_lo = max(kv_lo, base + (int)blockIdx.z * a.split_rows);
    kv_hi = min(kv_hi, base + ((int)blockIdx.z + 1) * a.split_rows);
  }
  // the warp's rows: the union [w_lo, w_hi] and the intersection [f_lo, f_hi]
  // of their visible kv rows, within the CTA's; this thread's rows g, g + 8
  const int wr = SPLIT ? 0 : 16 * warp;
  int w_lo = kv_hi, w_hi = kv_lo - 1, f_lo = kv_lo, f_hi = kv_hi - 1, lo[2], lim[2];
  rm.queries(a, wr, wr + 16, q_first, q_last);
  if (q_first <= q_last) {
    RowMap::query_limits(a, q_first, w_lo, f_hi);
    RowMap::query_limits(a, q_last, f_lo, w_hi);
    w_lo = max(w_lo, kv_lo);
    w_hi = min(w_hi, kv_hi - 1);
    f_lo = max(f_lo, kv_lo);
    f_hi = min(f_hi, kv_hi - 1);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rm.limits(a, wr + g + 8 * h, lo[h], lim[h]);
    lo[h] = max(lo[h], kv_lo);
    lim[h] = min(lim[h], kv_hi - 1);
  }
  const int t_base = kv_lo / kKvTile * kKvTile;
  const int n_tiles = kv_lo < kv_hi ? (kv_hi - 1 - t_base) / kKvTile + 1 : 0;

  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(a.k) + rm.b * a.k_sb + rm.hk * a.k_sh;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(a.v) + rm.b * a.v_sb + rm.hk * a.v_sh;
  // tile it's copies as one cp.async group (an empty group past the last
  // tile, so that waiting for all but the ST - 1 newest groups always means
  // tile it has landed)
  auto issue = [&](int it) {
    if (it < n_tiles) {
      __nv_bfloat16* st = KV + (it % ST) * 2 * kKvTile * LDS;
      load_kv_tile<DH>(st, kb, a.k_ss, t_base + it * kKvTile, kv_lo, kv_hi);
      load_kv_tile<DH>(st + kKvTile * LDS, vb, a.v_ss, t_base + it * kKvTile, kv_lo, kv_hi);
    }
    cp_async_commit();
  };
  for (int it = 0; it < ST - 1; ++it) issue(it);

  // q rows into shared memory, 8 elements per step (element loads: q needs
  // no alignment), then into A fragments
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  for (int e = tid; e < ROWS * DH / 8; e += kMmaThreads) {
    const int r = e / (DH / 8), d = e % (DH / 8) * 8;
    const bool ok = rm.valid(a, r);
    const __nv_bfloat16* src = q + (ok ? rm.q_index(a, r) + d : 0);
#pragma unroll
    for (int i = 0; i < 8; ++i) Qs[r * LDS + d + i] = ok ? src[i] : __float2bfloat16(0.f);
  }
  __syncthreads();
  // A fragments of q are read from shared memory at each k step: held in
  // registers they would cost 2 dh of them
  const unsigned q_addr =
      smem_u32(Qs + (wr + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDS + 8 * (lane >> 4));

  // m: running max of the scores in the log2 domain (scale_log2 applied)
  float o[ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const int c0 = SPLIT ? 16 * warp : 0;  // the warp's first column of a tile
  const float sl2 = a.scale_log2;

  for (int it = 0; it < n_tiles; ++it) {
    issue(it + ST - 1);  // overlaps this tile's products
    cp_async_wait<ST - 1>();
    __syncthreads();
    const int j0 = t_base + it * kKvTile + c0;  // the warp's first kv row of the tile
    const __nv_bfloat16* Ks = KV + (it % ST) * 2 * kKvTile * LDS;
    const __nv_bfloat16* Vs = Ks + kKvTile * LDS;
    if (j0 <= w_hi && j0 + NC - 1 >= w_lo) {  // warp-uniform: some row sees some column
      // S = Q . K^T over the warp's NC columns
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned qk[4];
        ldsm_x4(q_addr + 32 * kk, qk);
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          unsigned bk[4];
          ldsm_x4(smem_u32(Ks + (c0 + 8 * n + (lane & 7) + 8 * (lane >> 4)) * LDS + 16 * kk +
                           8 * ((lane >> 3) & 1)),
                  bk);
          mma_bf16(s[n], qk, bk[0], bk[1]);
          mma_bf16(s[n + 1], qk, bk[2], bk[3]);
        }
      }
      // masks only where the tile cuts some row's range (warp-uniform)
      if (j0 < f_lo || j0 + NC - 1 > f_hi) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + 8 * n + 2 * c + (e & 1), h = e >> 1;
            if (j < lo[h] || j > lim[h]) s[n][e] = -INFINITY;
          }
      }
      // online softmax in fp32 registers, base 2
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      float alpha[2], m_use[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h] * sl2);
        m_use[h] = m_new == -INFINITY ? 0.f : m_new;  // a row that has seen nothing yet
        alpha[h] = ex2(m[h] - m_use[h]);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = ex2(fmaf(s[n][e], sl2, -m_use[e >> 1]));  // 0 where masked
          l[e >> 1] += s[n][e];                               // l from the fp32 p
        }
      // acc = acc * alpha + P.V, NH output tiles at a time: this tile's
      // products sum from zero on the tensor cores (NH independent chains),
      // then one fp32 FMA per element joins them to acc
#pragma unroll
      for (int n0 = 0; n0 < ND; n0 += NH) {
        float pv[NH][4];
#pragma unroll
        for (int n = 0; n < NH; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
        for (int j = 0; j < NS / 2; ++j) {
          // P over these 16 kv rows as kPTerms bf16 parts (P_hi = bf16(p), P_lo =
          // bf16(p - P_hi), ...), each an A fragment
          unsigned pf[kPTerms][4];
          float x[8] = {s[2 * j][0], s[2 * j][1], s[2 * j][2], s[2 * j][3],
                        s[2 * j + 1][0], s[2 * j + 1][1], s[2 * j + 1][2], s[2 * j + 1][3]};
#pragma unroll
          for (int t = 0; t < kPTerms; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              pf[t][i] = t + 1 < kPTerms ? split_bf16x2<false>(x[2 * i], x[2 * i + 1])
                                         : split_bf16x2<true>(x[2 * i], x[2 * i + 1]);
#pragma unroll
          for (int n = 0; n < NH; n += 2) {
            unsigned bv[4];
            ldsm_x4_trans(smem_u32(Vs + (c0 + 16 * j + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                            LDS +
                                   8 * (n0 + n) + 8 * (lane >> 4)),
                          bv);
#pragma unroll
            for (int t = kPTerms - 1; t >= 0; --t) {  // the smallest part first
              mma_bf16(pv[n], pf[t], bv[0], bv[1]);
              mma_bf16(pv[n + 1], pf[t], bv[2], bv[3]);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < NH; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n0 + n][e] = fmaf(o[n0 + n][e], alpha[e >> 1], pv[n][e]);
      }
    }
    __syncthreads();  // the next issue overwrites this stage
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  if (!SPLIT) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr + g + 8 * h;
      if (!rm.valid(a, r)) continue;
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      __nv_bfloat16* orow = out + rm.out_row(a, r) * DH;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * c) =
            __floats2bfloat162_rn(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
    }
    return;
  }

  // SPLIT: merge the four warps' states in warp order through the tile
  // space, into this CTA's partial [m[16], l[16], acc[16][DH]]
  float* Mw = reinterpret_cast<float*>(KV);  // [4][16]
  float* Lw = Mw + 4 * kSplitRows;           // [4][16]
  float* Aw = Lw + 4 * kSplitRows;           // [4][16][DH]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    if (c == 0) {
      Mw[warp * kSplitRows + r] = m[h];
      Lw[warp * kSplitRows + r] = l[h];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      Aw[(warp * kSplitRows + r) * DH + 8 * n + 2 * c] = o[n][2 * h];
      Aw[(warp * kSplitRows + r) * DH + 8 * n + 2 * c + 1] = o[n][2 * h + 1];
    }
  }
  __syncthreads();
  const long long cta = ((long long)blockIdx.y * gridDim.x + blockIdx.x) * gridDim.z + blockIdx.z;
  float* part = static_cast<float*>(a.part) + cta * kSplitRows * (DH + 2);
  for (int e = tid; e < kSplitRows * DH; e += kMmaThreads) {
    const int r = e / DH, d = e % DH;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, Mw[w * kSplitRows + r]);
    const float M_use = M == -INFINITY ? 0.f : M;
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float f = ex2(Mw[w * kSplitRows + r] - M_use);
      L += Lw[w * kSplitRows + r] * f;
      A += Aw[(w * kSplitRows + r) * DH + d] * f;
    }
    part[2 * kSplitRows + r * DH + d] = A;
    if (d == 0) {
      part[r] = M;
      part[kSplitRows + r] = L;
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads, min_ctas<DH>())
flash_attention_mma_kernel(const Args a) {
  mma_body<DH, false>(a);
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads, min_ctas<DH>())
flash_attention_split_kernel(const Args a) {
  mma_body<DH, true>(a);
}

constexpr int kCombineThreads = 256;

// The split CTAs' partials of one (query block, head group, batch, kv head)
// merged in split order, normalised, written in bf16: the grid (x, y) of the
// split kernel, and z over the 16 x DH outputs, one per thread.
template <int DH>
__global__ void __launch_bounds__(kCombineThreads) flash_attention_combine_kernel(const Args a) {
  RowMap rm;
  rm.init<kSplitRows>(a);
  const int n_split = a.n_split;
  const float* part = static_cast<const float*>(a.part) +
                      ((long long)blockIdx.y * gridDim.x + blockIdx.x) * n_split *
                          kSplitRows * (DH + 2);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
  const int e = blockIdx.z * kCombineThreads + threadIdx.x;
  if (e < kSplitRows * DH) {
    const int r = e / DH, d = e % DH;
    if (!rm.valid(a, r)) return;
    float M = -INFINITY;
    for (int sp = 0; sp < n_split; ++sp) M = fmaxf(M, part[sp * kSplitRows * (DH + 2) + r]);
    const float M_use = M == -INFINITY ? 0.f : M;
    float L = 0.f, A = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const float* p = part + sp * kSplitRows * (DH + 2);
      const float f = ex2(p[r] - M_use);
      L += p[kSplitRows + r] * f;
      A += p[2 * kSplitRows + r * DH + d] * f;
    }
    out[rm.out_row(a, r) * DH + d] = __float2bfloat16(A / fmaxf(L, 1e-30f));
  }
}

template <int DH>
int launch_mma(const Args& a, int B, cudaStream_t stream) {
  const int rows = a.n_split ? kSplitRows : kPrefillRows;
  const int smem = mma_smem_bytes<DH>(rows);
  static bool configured[2] = {false, false};
  if (!configured[a.n_split ? 1 : 0]) {
    const cudaError_t err = a.n_split
        ? cudaFuncSetAttribute(flash_attention_split_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
        : cudaFuncSetAttribute(flash_attention_mma_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured[a.n_split ? 1 : 0] = true;
  }
  const int G = a.H / a.Hkv;
  const int Gc = G < rows ? G : rows;
  const int n_gsplit = (G + Gc - 1) / Gc;
  const int BQ = rows / Gc;
  const long long nx = (long long)((a.Sq + BQ - 1) / BQ) * n_gsplit;
  const long long ny = (long long)B * a.Hkv;
  if (nx > 0x7fffffffLL || ny > 65535 || a.n_split > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (!a.n_split) {
    flash_attention_mma_kernel<DH><<<dim3((unsigned)nx, (unsigned)ny), kMmaThreads, smem,
                                     stream>>>(a);
    return (int)cudaGetLastError();
  }
  flash_attention_split_kernel<DH><<<dim3((unsigned)nx, (unsigned)ny, (unsigned)a.n_split),
                                     kMmaThreads, smem, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_attention_combine_kernel<DH>
      <<<dim3((unsigned)nx, (unsigned)ny, (kSplitRows * DH + kCombineThreads - 1) / kCombineThreads),
         kCombineThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// CUDA-core entry: fp32 q and o; kv_bf16: 1 for bf16 k/v, 0 for fp32 (a bf16
// q goes to the tensor-core entries). Strides are in elements; every pointer
// and stride must allow 16-byte loads of k and v rows (checked by the Python
// wrapper). window 0: no window.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int kv_bf16, int dh,
    int B, int Sq, int Skv, int H, int Hkv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, int q_offset, int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0 || q_offset < 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
         Sq, Skv, H, Hkv, q_offset, causal ? 1 : 0, window,
         (float)(1.0 / std::sqrt((double)dh)), 0.f, nullptr, 0, 0};
  cudaStream_t s = (cudaStream_t)stream;
  return kv_bf16 ? launch_dh<__nv_bfloat16>(a, B, dh, s) : launch_dh<float>(a, B, dh, s);
}

// Tensor-core entries, bf16 q, k, v, o. n_split 0: the prefill entry; n_split
// >= 1: the split entry, kv rows [base + i split_rows, base + (i + 1)
// split_rows) for split i (base: the first visible row rounded down to the
// 64-row tile; split_rows a multiple of 64), partials in part (n_split x
// 16 (dh + 2) floats per CTA of the grid), then the combine pass.
extern "C" int flash_attention_mma_launch(
    const void* q, const void* k, const void* v, void* o, void* part, int dh,
    int B, int Sq, int Skv, int H, int Hkv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, int q_offset, int window, int n_split, int split_rows, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0 || q_offset < 0 || window < 0 ||
      n_split < 0 || (n_split && (!part || split_rows <= 0 || split_rows % kKvTile)))
    return (int)cudaErrorInvalidValue;
  const double scale = 1.0 / std::sqrt((double)dh);
  Args a{q, k, v, o, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
         Sq, Skv, H, Hkv, q_offset, causal ? 1 : 0, window,
         (float)scale, (float)(scale * 1.4426950408889634), part, n_split, split_rows};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dh) {
    case 16: return launch_mma<16>(a, B, s);
    case 32: return launch_mma<32>(a, B, s);
    case 64: return launch_mma<64>(a, B, s);
    case 128: return launch_mma<128>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
