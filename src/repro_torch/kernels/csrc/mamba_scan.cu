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
// Bound. The scan is elementwise in (b, e, n) and sequential in S, so it is
// bound by bytes. At the served prefill (B 8, S 512, E 8192, N 16) the
// model entry must move delta (134 MB), u (67 MB in bf16), y (134 MB), h0
// and hT (4.2 MB each) and B, C (0.26 MB): 0.344 GB, 0.103 ms at 3.35
// TB/s. It also takes 537 M exponentials: at 16 per SM per clock on the
// SFU (132 SMs, 1.98 GHz) that alone is 0.13 ms, so the SFU, not the
// bytes, is the floor this design can reach. In decode (S 1) the bytes are
// the states, 8.4 MB read and written once: 0.0029 ms.
//
// Design: lanes over the state. The first design gave one thread
// all N states of a channel: 512 CTAs of 128 threads at the served prefill
// (~15 warps per SM), h0, A and hT as 16 scalar accesses 64 bytes apart
// between lanes, and 16 accurate expf per token. It took 0.437 ms at the
// prefill (4.2x its bound) and 0.0191 ms at decode (6.7x), on an H100 80GB
// HBM3 at 700 W. Here
//   * each thread holds 4 consecutive states of one (b, e): N / 4 lanes per
//     channel (4 at N 16, 2 at N 8, 1 at N 4), so a CTA of 128 threads
//     covers 128 / (N / 4) channels and the served prefill runs 8 x 8192 x
//     4 threads, four times the warps. h0, A, hT (and the contract entry's
//     da, dbu) move as one float4 per thread, coalesced across the warp;
//   * y_t is each lane's partial sum over its 4 states; over a block of L
//     tokens a reduce-scatter by __shfl_xor_sync (L - 1 shuffles) leaves
//     lane q the whole y of the block's token q, so a warp's store writes L
//     tokens' rows at once;
//   * the decay is exp2 of delta times A * log2(e), formed once per thread:
//     one ex2.approx on the SFU per state and token, where expf adds a
//     range reduction on the CUDA cores;
//   * delta and u of the next kPre tokens are loaded into registers while
//     the current ones compute, lane q of a channel loading tokens q, q + L,
//     .. and handing them to the channel's other lanes by shuffles: each
//     load instruction of a warp then reads L tokens' rows (128 bytes at N
//     16), not 32 bytes of one, which sets how many bytes are in flight;
//     B and C are staged in shared memory kTok tokens at a time, as
//     broadcasts for the CTA's channels;
//   * a launch of one token (decode) reads its row of B and C straight from
//     global memory: no staging pass, no barrier.
// Measured on that card: 0.294 ms at the served prefill (1.49x faster, 2.9x
// the bytes bound, 2.3x the SFU floor) and 0.0040 ms at decode (4.7x
// faster); the contract entry 1.475 ms (its bound 1.325) and 0.0035. Taking
// parts out one at a time at the prefill: without the exponentials 0.297
// ms, without the loads of delta and u 0.256, without the stores of y
// 0.284 -- the SFU does not set the pace; issue and latency on the CUDA
// cores do (~32 instructions per token and thread). Loading delta and u
// one token per lane was worth most: 0.500 ms with each lane loading every
// token (32 bytes per warp and load), 0.373 with the loads shared, 0.303
// with 16 tokens in flight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per CTA: kThreads / (N / 4) channels
constexpr int kTok = 32;       // tokens of B and C staged per pass
constexpr int kPre = 16;       // tokens of delta and u loaded ahead
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float ex2(float x) {  // 2^x, approximate (2 ulp); ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

template <int L>
__device__ __forceinline__ float lane_sum(float x) {  // over the channel's L lanes
#pragma unroll
  for (int o = 1; o < L; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A reduce-scatter of 2M values per lane over lanes xor O, O / 2, ..: a lane
// with bit O of q set keeps the upper M values and sends the lower, its
// partner the reverse, and each adds what it receives. Over the channel's L
// lanes (O = M = L / 2) lane q ends with the whole sum of value q in p[0].
template <int O, int M, int NV>
__device__ __forceinline__ void reduce_scatter(float (&p)[NV], int q) {
  if constexpr (O > 0) {
    const bool up = q & O;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float send = up ? p[j] : p[j + M], keep = up ? p[j + M] : p[j];
      p[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    reduce_scatter<O / 2, M / 2>(p, q);
  }
}

template <bool kModel, typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const Args a) {
  constexpr int L = N / 4;              // lanes per channel
  constexpr int kChannels = kThreads / L;
  __shared__ __align__(16) float Bs[kModel ? kTok : 1][N];
  __shared__ __align__(16) float Cs[kTok][N];

  const int b = (int)blockIdx.y;
  const int q = (int)threadIdx.x % L;  // this lane's states: 4q .. 4q + 3
  const int e = (int)blockIdx.x * kChannels + (int)threadIdx.x / L;
  const bool active = e < a.E;  // the ragged last CTA still stages, syncs and shuffles
  const int ec = active ? e : 0;
  const long long be = ((long long)b * a.E + ec) * N + 4 * q;

  float4 h = active ? *reinterpret_cast<const float4*>(a.h0 + be) : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 A2 = make_float4(0.f, 0.f, 0.f, 0.f);  // A * log2(e)
  if constexpr (kModel) {
    const float4 Ar = *reinterpret_cast<const float4*>(a.A + (long long)ec * N + 4 * q);
    A2 = make_float4(Ar.x * kLog2e, Ar.y * kLog2e, Ar.z * kLog2e, Ar.w * kLog2e);
  }

  const T* cb = static_cast<const T*>(a.c) + b * a.c_sb;
  const T* bb = static_cast<const T*>(a.bm) + b * a.bm_sb;
  const T* ub = static_cast<const T*>(a.u);
  const long long row0 = (long long)b * a.S * a.E + ec;  // [B, S, E] index of token 0

  // one token: h <- da h + dbu over this lane's 4 states; its share of y_t
  auto advance = [&](long long row, float d, float uu, float4 bv, float4 cv) -> float {
    float4 da, dbu;
    if constexpr (kModel) {
      const float du = d * uu;
      da = make_float4(ex2(d * A2.x), ex2(d * A2.y), ex2(d * A2.z), ex2(d * A2.w));
      dbu = make_float4(du * bv.x, du * bv.y, du * bv.z, du * bv.w);
    } else {
      da = *reinterpret_cast<const float4*>(a.da + row * N + 4 * q);
      dbu = *reinterpret_cast<const float4*>(a.dbu + row * N + 4 * q);
    }
    h.x = fmaf(da.x, h.x, dbu.x);
    h.y = fmaf(da.y, h.y, dbu.y);
    h.z = fmaf(da.z, h.z, dbu.z);
    h.w = fmaf(da.w, h.w, dbu.w);
    return (h.x * cv.x + h.y * cv.y) + (h.z * cv.z + h.w * cv.w);
  };

  if (a.S == 1) {  // decode: B and C read in place, no staging barrier
    float4 bv = make_float4(0.f, 0.f, 0.f, 0.f), cv;
    cv = make_float4(to_float(cb[4 * q]), to_float(cb[4 * q + 1]), to_float(cb[4 * q + 2]),
                     to_float(cb[4 * q + 3]));
    float d = 0.f, uu = 0.f;
    if constexpr (kModel) {
      bv = make_float4(to_float(bb[4 * q]), to_float(bb[4 * q + 1]), to_float(bb[4 * q + 2]),
                       to_float(bb[4 * q + 3]));
      d = a.delta[row0];
      uu = to_float(ub[row0]);
    }
    const float y = lane_sum<L>(advance(row0, d, uu, bv, cv));
    if (active && q == 0) a.y[row0] = y;
  } else {
    constexpr int kLoads = kPre / L;  // tokens of delta and u a lane loads per group
    const int lane0 = ((int)threadIdx.x & 31) & ~(L - 1);  // the channel's first lane
    for (int t0 = 0; t0 < a.S; t0 += kTok) {
      const int nt = a.S - t0 < kTok ? a.S - t0 : kTok;
      // lane q loads delta and u of tokens q, q + L, .. of a group of kPre:
      // the channel's L lanes together hold the group, and each load
      // instruction of a warp reads L tokens' rows, not one
      float dn[kLoads] = {}, un[kLoads] = {};
      auto load_group = [&](int g) {
#pragma unroll
        for (int m = 0; m < kLoads; ++m) {
          const int t = g + q + L * m < nt ? g + q + L * m : nt - 1;
          const long long row = row0 + (long long)(t0 + t) * a.E;
          dn[m] = a.delta[row];
          un[m] = to_float(ub[row]);
        }
      };
      if constexpr (kModel) load_group(0);  // in flight across the staging
      __syncthreads();  // the previous pass has read the staged rows
      for (int i = threadIdx.x; i < nt * N; i += kThreads) {
        const int t = i / N, k = i % N;
        Cs[t][k] = to_float(cb[(long long)(t0 + t) * a.c_ss + k]);
        if constexpr (kModel) Bs[t][k] = to_float(bb[(long long)(t0 + t) * a.bm_ss + k]);
      }
      __syncthreads();
      for (int g = 0; g < nt; g += kPre) {
        float dc[kLoads], uc[kLoads];
#pragma unroll
        for (int m = 0; m < kLoads; ++m) {
          dc[m] = dn[m];
          uc[m] = un[m];
        }
        if constexpr (kModel) {  // the next group's, while this one computes
          if (g + kPre < nt) load_group(g + kPre);
        }
        float yv[kPre];
#pragma unroll
        for (int i = 0; i < kPre; ++i) {
          const int t = g + i;
          yv[i] = 0.f;
          if (t < nt) {  // CTA-uniform
            float d = 0.f, uu = 0.f;
            float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
            if constexpr (kModel) {
              d = L == 1 ? dc[i] : __shfl_sync(0xffffffffu, dc[i / L], lane0 + i % L);
              uu = L == 1 ? uc[i] : __shfl_sync(0xffffffffu, uc[i / L], lane0 + i % L);
              bv = *reinterpret_cast<const float4*>(&Bs[t][4 * q]);
            }
            const float4 cv = *reinterpret_cast<const float4*>(&Cs[t][4 * q]);
            yv[i] = advance(row0 + (long long)(t0 + t) * a.E, d, uu, bv, cv);
          }
        }
        // per block of L tokens, lane q ends with the whole y of token q
#pragma unroll
        for (int k0 = 0; k0 < kPre; k0 += L) {
          float blk[L];
#pragma unroll
          for (int j = 0; j < L; ++j) blk[j] = yv[k0 + j];
          reduce_scatter<L / 2, L / 2>(blk, q);
          const int t = g + k0 + q;
          if (active && t < nt) a.y[row0 + (long long)(t0 + t) * a.E] = blk[0];
        }
      }
    }
  }
  if (active) *reinterpret_cast<float4*>(a.hT + be) = h;
}

template <bool kModel, typename T, int N>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int kChannels = kThreads / (N / 4);
  const dim3 grid((unsigned)((a.E + kChannels - 1) / kChannels), (unsigned)B);
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
// fp32 out. da, dbu, h0, y and hT are contiguous and 16-byte aligned
// (checked by the Python wrapper). hT may not alias h0.
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
// ubc_bf16, else fp32; A [E, N] and h0 [B, E, N] fp32 contiguous and 16-byte
// aligned; y and hT as above.
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
