// Flash attention with the GQA head map in the kernel, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention -> _flash_kernel). Same function: for every batch row b,
// query head h (kv head h / G, G = H / Hkv) and query i,
//
//   s_j   = (q[b, i, h] . k[b, j, h / G]) / sqrt(dh)
//   out   = sum_j softmax_j(s) v[b, j, h / G]       over visible j,
//
// visible meaning j < Skv, when causal q_offset + i >= j, and with a sliding
// window (window > 0) j > q_offset + i - window. Scores,
// softmax and the P.V sums are fp32 (online softmax: running max m and
// denominator l per row, acc rescaled by exp(m_old - m_new)); the output
// is divided by max(l, 1e-30) and written in q's dtype.
//
// Differences from the TPU layout:
//   * model layout: q [B, Sq, H, dh], k/v [B, Skv, Hkv, dh], each with its
//     own batch/sequence/head strides (dim stride 1), so k and v are read
//     in place as slices of the [L, B, T, Hkv, dh] cache; the TPU wrapper
//     repeats k/v G times and transposes them first;
//   * q_offset is a runtime argument (it is the cache length in decode);
//   * the sliding window is a runtime argument too: each row has a lower
//     limit beside its upper one, and a CTA starts at the tile holding the
//     lowest row any of its queries sees, so rows below every window are
//     never read (the TPU wrapper's model slices the cache to the last
//     window + S rows instead);
//   * ragged Sq and Skv: tails are masked, no block divisibility;
//   * q in fp32 or bf16, k/v in fp32 or bf16 (bf16 k/v with fp32 q is the
//     float32-compute model reading its bf16 cache); dh in {16, 32, 64, 128}.
//
// Design. One CTA of 4 warps owns one (batch, kv head) and R = 16 query
// rows: BQ consecutive queries x Gc heads of the group (Gc = min(G, 16); a
// group wider than 16 heads is split over CTAs), so every k/v row it loads
// serves all of them. It walks the kv rows in tiles of 128, loaded once
// into shared memory in their own dtype; a causal CTA stops at the last row
// its last query sees, so blocks above the diagonal (and, in decode, the
// cache's unwritten rows) are never read. Inside a tile each warp owns 32
// rows, one per lane: the lane forms its row's 16 scores (q rows broadcast
// from shared memory), the warp reduces max and sum with shuffles, and for
// P.V each lane owns dh/32 output columns. Each warp keeps its own (m, l,
// acc) over the tiles; the four are merged through shared memory in a fixed
// order at the end, so the result does not change from run to run. CTAs are
// issued last query block first, so the longest causal rows start first.
//
// Bound. At the serving prefill (B 8, Sq 512, Skv 672, H 32, Hkv 4, dh 64,
// bf16) the call must move q and out (33.6 MB) and the 512 visible k/v rows
// (4.2 MB): 0.011 ms at 3.35 TB/s, a little above the 8.6 GFLOP of
// 4 B H dh sum_i(visible_i) at the bf16 tensor-core peak (0.009 ms). This
// kernel does those flops on the fp32 CUDA cores, one shared-memory
// broadcast of q per four FMAs, and takes ~60x its bound there; tensor
// cores (wgmma) are later work. In decode (Sq 1) the cache rows are the
// bytes, each read once per kv head, and the 32 CTAs that walk the cache
// are latency-bound.
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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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
  float scale;
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

template <typename TQ, typename TKV, int DH>
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

  const TQ* q = static_cast<const TQ*>(a.q);
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
  TQ* o = static_cast<TQ*>(a.o);
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
    store(o + row * DH + d, A / fmaxf(Lsum, 1e-30f));
  }
}

template <typename TQ, typename TKV, int DH>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = smem_bytes<TKV, DH>() + kWarps * kRows * 32 * (int)sizeof(float);
  auto kernel = flash_attention_kernel<TQ, TKV, DH>;
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

template <typename TQ, typename TKV>
int launch_dh(const Args& a, int B, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<TQ, TKV, 16>(a, B, stream);
    case 32: return launch<TQ, TKV, 32>(a, B, stream);
    case 64: return launch<TQ, TKV, 64>(a, B, stream);
    case 128: return launch<TQ, TKV, 128>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q_bf16 / kv_bf16: 1 for bf16, 0 for fp32 (bf16 q with fp32 k/v is refused).
// Strides are in elements; every pointer and stride must allow 16-byte loads
// of k and v rows (checked by the Python wrapper). window 0: no window.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int q_bf16, int kv_bf16, int dh,
    int B, int Sq, int Skv, int H, int Hkv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, int q_offset, int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0 || q_offset < 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
         Sq, Skv, H, Hkv, q_offset, causal ? 1 : 0, window,
         (float)(1.0 / std::sqrt((double)dh))};
  cudaStream_t s = (cudaStream_t)stream;
  if (!q_bf16 && !kv_bf16) return launch_dh<float, float>(a, B, dh, s);
  if (q_bf16 && kv_bf16) return launch_dh<__nv_bfloat16, __nv_bfloat16>(a, B, dh, s);
  if (!q_bf16 && kv_bf16) return launch_dh<float, __nv_bfloat16>(a, B, dh, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
