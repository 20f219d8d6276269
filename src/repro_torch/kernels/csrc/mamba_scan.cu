// Mamba's selective scan (S6), for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py (mamba_scan ->
// pallas_call at :66, body _mamba_kernel). Same function: for every batch
// row b and channel e, with the state h[e, :] of N entries starting at
// h0[b, e], token by token
//
//   h[n] <- da_t[e, n] * h[n] + dbu_t[e, n]
//   y_t[e] = sum_n h[n] * c_t[n]
//
// then hT[b, e] = h. y, the states and every product are fp32.
//
// Two entry points share the recurrence and differ only in how da and dbu
// arrive (template parameter kModel):
//   * the contract entry (kModel = false) reads da, dbu [B, S, E, N] fp32
//     and c [B, S, N] fp32, as the Pallas kernel does;
//   * the model entry (kModel = true) reads what the Mamba block has before
//     the scan -- delta [B, S, E] fp32, u [B, S, E], B and C [B, S, N] (u, B
//     and C in the compute dtype, B and C strided views of one projection)
//     and A [E, N] fp32 -- and forms da = exp(delta * A[e, n]) and
//     dbu = (delta * u) * B[n] in registers, in the JAX model's order of
//     products (repro/models/mamba.py:111-112). It never materialises the
//     [B, S, E, N] tensors, which at the served prefill would be 2.15 GB
//     each per layer.
//
// Differences from the TPU kernel: any S >= 1 and any E (the TPU kernel
// asserts S % chunk == 0 and E % eblock == 0), so decode's S = 1 is one
// step; h0 is an input of both entries; nothing is blocked over E for
// VMEM -- the state lives in registers.
//
// Design. One thread per (b, e) holds the N states (N in {4, 8, 16}) and,
// in the model entry, A's row in registers; a CTA of 128 threads covers 128
// consecutive channels of one batch row, so its loads of delta, u, da, dbu
// and its stores of y are coalesced across the warp. The CTA stages kTok
// tokens of C (and of B in the model entry) in shared memory, where every
// thread reads them as broadcasts; y_t is summed over n inside the thread.
//
// Bound. The scan is elementwise in (b, e, n) and sequential in S, so it is
// bound by bytes. At the served prefill (B 8, S 512, E 8192, N 16) the
// model entry must move delta (134 MB), u (67 MB in bf16), y (134 MB), h0
// and hT (4.2 MB each) and B, C (0.26 MB): 0.344 GB, 0.103 ms at 3.35
// TB/s. It also takes 537 M expf, ~10 instructions each on the CUDA cores
// (~0.2 ms at the card's issue rate), so the exponentials may set its pace;
// the contract entry moves da and dbu (2.15 GB each), 1.33 ms. With one
// thread per (b, e) the served prefill is 512 CTAs, ~15 warps per SM: thin
// occupancy, which a later kernel could raise by splitting N over a few
// lanes. In decode (S 1) the bytes are the states, read and written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels per CTA, one per thread
constexpr int kTok = 32;       // tokens of B and C staged per pass

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Args {
  const float* da;     // contract: [B, S, E, N]
  const float* dbu;    // contract: [B, S, E, N]
  const float* delta;  // model: [B, S, E]
  const void* u;       // model: [B, S, E]
  const void* bm;      // model: [B, S, N], strides bm_sb, bm_ss
  const float* A;      // model: [E, N]
  const void* c;       // [B, S, N], strides c_sb, c_ss
  const float* h0;     // [B, E, N]
  float* y;            // [B, S, E]
  float* hT;           // [B, E, N]
  long long bm_sb, bm_ss, c_sb, c_ss;  // element strides
  int S, E;
};

template <bool kModel, typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const Args a) {
  __shared__ __align__(16) float Bs[kModel ? kTok : 1][N];
  __shared__ __align__(16) float Cs[kTok][N];

  const int b = (int)blockIdx.y;
  const int e = (int)blockIdx.x * kThreads + (int)threadIdx.x;
  const bool active = e < a.E;  // the ragged last CTA still stages and syncs
  const long long be = ((long long)b * a.E + (active ? e : 0)) * N;

  float h[N];
  float Ar[kModel ? N : 1];
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = active ? a.h0[be + n] : 0.f;
  if constexpr (kModel) {
#pragma unroll
    for (int n = 0; n < N; ++n) Ar[n] = active ? a.A[(long long)e * N + n] : 0.f;
  }

  const T* cb = static_cast<const T*>(a.c) + b * a.c_sb;
  const T* bb = static_cast<const T*>(a.bm) + b * a.bm_sb;
  for (int t0 = 0; t0 < a.S; t0 += kTok) {
    const int nt = a.S - t0 < kTok ? a.S - t0 : kTok;
    __syncthreads();  // the previous pass has read the staged rows
    for (int i = threadIdx.x; i < nt * N; i += kThreads) {
      const int t = i / N, k = i % N;
      Cs[t][k] = to_float(cb[(long long)(t0 + t) * a.c_ss + k]);
      if constexpr (kModel) Bs[t][k] = to_float(bb[(long long)(t0 + t) * a.bm_ss + k]);
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int t = 0; t < nt; ++t) {
        const long long row = ((long long)b * a.S + t0 + t) * a.E + e;  // [B, S, E] index
        float y = 0.f;
        if constexpr (kModel) {
          const float d = a.delta[row];
          const float du = d * to_float(static_cast<const T*>(a.u)[row]);
#pragma unroll
          for (int n = 0; n < N; ++n) {
            h[n] = expf(d * Ar[n]) * h[n] + du * Bs[t][n];
            y = fmaf(h[n], Cs[t][n], y);
          }
        } else {
          const float4* pa = reinterpret_cast<const float4*>(a.da + row * N);
          const float4* pb = reinterpret_cast<const float4*>(a.dbu + row * N);
#pragma unroll
          for (int q = 0; q < N / 4; ++q) {
            const float4 x = pa[q], z = pb[q];
            h[4 * q + 0] = x.x * h[4 * q + 0] + z.x;
            h[4 * q + 1] = x.y * h[4 * q + 1] + z.y;
            h[4 * q + 2] = x.z * h[4 * q + 2] + z.z;
            h[4 * q + 3] = x.w * h[4 * q + 3] + z.w;
          }
#pragma unroll
          for (int n = 0; n < N; ++n) y = fmaf(h[n], Cs[t][n], y);
        }
        a.y[row] = y;
      }
    }
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n) a.hT[be + n] = h[n];
  }
}

template <bool kModel, typename T, int N>
int launch(const Args& a, int B, cudaStream_t stream) {
  const dim3 grid((unsigned)((a.E + kThreads - 1) / kThreads), (unsigned)B);
  mamba_scan_kernel<kModel, T, N><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kModel, typename T>
int launch_n(const Args& a, int B, int N, cudaStream_t stream) {
  switch (N) {
    case 4: return launch<kModel, T, 4>(a, B, stream);
    case 8: return launch<kModel, T, 8>(a, B, stream);
    case 16: return launch<kModel, T, 16>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int S, int E) {
  return B <= 0 || S <= 0 || E <= 0 || B > 65535;
}

}  // namespace

// The contract entry: da, dbu [B, S, E, N], c [B, S, N] (strides c_sb, c_ss,
// last dim contiguous), h0 [B, E, N], all fp32; y [B, S, E] and hT [B, E, N]
// fp32 out. da and dbu are contiguous and 16-byte aligned; h0, y and hT
// contiguous (checked by the Python wrapper). hT may not alias h0.
extern "C" int mamba_scan_launch(
    const void* da, const void* dbu, const void* c, const void* h0, void* y, void* hT,
    int B, int S, int E, int N, long long c_sb, long long c_ss, void* stream) {
  if (bad_shape(B, S, E)) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(da), static_cast<const float*>(dbu), nullptr, nullptr,
         nullptr, nullptr, c, static_cast<const float*>(h0), static_cast<float*>(y),
         static_cast<float*>(hT), 0, 0, c_sb, c_ss, S, E};
  return launch_n<false, float>(a, B, N, (cudaStream_t)stream);
}

// The model entry: delta [B, S, E] fp32 and u [B, S, E] contiguous; B and C
// [B, S, N] with element strides (last dim contiguous); u, B and C bf16 when
// ubc_bf16, else fp32; A [E, N] and h0 [B, E, N] fp32 contiguous; y and hT
// as above.
extern "C" int mamba_selective_scan_launch(
    const void* delta, const void* u, const void* bm, const void* cm, const void* A,
    const void* h0, void* y, void* hT, int ubc_bf16, int B, int S, int E, int N,
    long long bm_sb, long long bm_ss, long long c_sb, long long c_ss, void* stream) {
  if (bad_shape(B, S, E)) return (int)cudaErrorInvalidValue;
  Args a{nullptr, nullptr, static_cast<const float*>(delta), u, bm,
         static_cast<const float*>(A), cm, static_cast<const float*>(h0),
         static_cast<float*>(y), static_cast<float*>(hT), bm_sb, bm_ss, c_sb, c_ss, S, E};
  cudaStream_t s = (cudaStream_t)stream;
  if (ubc_bf16) return launch_n<true, __nv_bfloat16>(a, B, N, s);
  return launch_n<true, float>(a, B, N, s);
}

extern "C" const char* mamba_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
