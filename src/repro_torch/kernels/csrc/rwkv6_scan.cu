// The WKV6 recurrence of RWKV6 ("Finch"), for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_scan.py (rwkv6_scan ->
// _wkv_kernel). Same function: for every batch row b and head h, with the
// state S [dh_k, dh_v] starting at s0[b, h], token by token
//
//   y_t[j] = sum_i r_t[i] * (S[i, j] + u[h, i] * k_t[i] * v_t[j])
//   S[i,j] <- exp(wlog_t[i]) * S[i, j] + k_t[i] * v_t[j]
//
// then sT[b, h] = S. y and the states are fp32; r, k, v are read in their
// own dtype (bf16 or fp32) and widened in registers, wlog, u and s0 are fp32.
//
// Differences from the TPU kernel:
//   * model layout: r, k, v, wlog [B, S, H, dh], each with its own
//     batch/sequence/head strides (dim stride 1), u [H, dh] indexed by h;
//     the TPU wrapper folds and transposes them to [B * H, S, dh] first;
//   * any S >= 1: the TPU kernel asserts S % chunk == 0, the model pads its
//     tail; here the token loop simply ends, so decode's S = 1 is one step;
//   * the sequential form, not the chunked one: the TPU kernel turns a chunk
//     of 32 tokens into [C, C] products for its matrix unit, with the decays
//     between tokens as exp of differences of cumulative log decays masked
//     above the diagonal. Here every exp takes one wlog <= 0, so no exponent
//     is ever positive and nothing needs masking.
//
// Design. One CTA of dh threads owns one (b, h); thread j owns value column
// j and holds S[:, j] in registers (dh floats) for the whole sequence. The
// CTA stages kTok tokens at a time through shared memory: r_t, k_t,
// u * k_t, exp(wlog_t) and v_t, one coalesced row of dh per token and
// array. Then, per token, each thread walks i over the staged rows (float4
// broadcasts from shared memory) with two FMAs for y and two ops for S, and
// writes y_t[j]; after the last token it writes its column of sT.
//
// Bound. At the serving prefill (B 8, S 512, H 64, dh 64, bf16 r/k/v) the
// call must move r, k, v (3 x 33.5 MB), wlog (67.1 MB), y (67.1 MB) and
// s0, sT (2 x 8.4 MB), ~252 MB: 0.075 ms at 3.35 TB/s, above the 4 dh^2
// fp32 flops per (b, h, token) (4.3 GFLOP, 0.064 ms at 67 TFLOP/s). The
// 512 CTAs of 64 threads are all resident at once (40 KB of shared memory
// each), but each SM then holds only ~8 warps, and every token costs a warp
// ~4 dh instructions (the output's sum split over four chains so that the
// dependent adds do not serialise it): the kernel is bound by issue and
// latency on the CUDA cores, several times above its bound. The chunked
// form on tensor cores (bf16 MMA, fp32 accumulation) is later work. In
// decode (S 1) the bytes are the states, read and written once (16.8 MB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTok = 32;  // tokens staged per pass

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

template <typename T, int DH>
int launch(const Args& a, int B, cudaStream_t stream) {
  const long long n = (long long)B * a.H;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rwkv6_scan_kernel<T, DH><<<(unsigned)n, DH, 0, stream>>>(a);
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

}  // namespace

// rkv_bf16: 1 for bf16 r/k/v, 0 for fp32. Strides are in elements (the dim
// stride is 1); u [H, dh], s0 and sT [B, H, dh, dh] and y [B, S, H, dh] are
// contiguous (checked by the Python wrapper). sT may not alias s0.
extern "C" int rwkv6_scan_launch(
    const void* r, const void* k, const void* v, const void* wlog, const void* u,
    const void* s0, void* y, void* sT, int rkv_bf16, int dh, int B, int S, int H,
    long long r_sb, long long r_ss, long long r_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long w_sb, long long w_ss, long long w_sh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  Args a{r, k, v, static_cast<const float*>(wlog), static_cast<const float*>(u),
         static_cast<const float*>(s0), static_cast<float*>(y), static_cast<float*>(sT),
         r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh, S, H};
  cudaStream_t s = (cudaStream_t)stream;
  if (rkv_bf16) return launch_dh<__nv_bfloat16>(a, B, dh, s);
  return launch_dh<float>(a, B, dh, s);
}

extern "C" const char* rwkv6_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
