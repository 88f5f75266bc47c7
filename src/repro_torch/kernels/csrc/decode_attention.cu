// One-token GQA decode attention against a KV cache for Hopper (sm_90a):
//
//     o[b, h, g] = sum_{j < length} softmax_j(q[b, h, g] . k[b, h, j] / sqrt(D)) v[b, h, j]
//
// with the scores, the online softmax and the sums in fp32, for fp32 or
// bf16 q and caches; the output in q's type. ``length`` (the cache fill)
// is a host int or an int32 on the device, read by the kernel itself, so a
// decode loop that keeps its position on the card needs no host sync.
//
// Replaces repro/kernels/decode_attention.py:_decode_kernel (the Pallas
// TPU kernel), which walks a (B, KV, kv block) grid with the kv axis
// sequential, the state in VMEM scratch, the length prefetched into SMEM
// so that blocks past it skip their products.
//
// Bound: memory. Every cache row below ``length`` is read once (K and V,
// 2*D elements per kv head) for 4*G*D flops, far below the card's
// flop-per-byte balance point; at the serving shape (llama3.2-1b, B=4,
// length ~528, bf16) one layer's call must move 4.3 MB, 1.3 us at
// 3.35 TB/s. What the design does:
//   * one block per (b, kv head, chunk of up to 8 query heads): the G
//     query heads of a kv head share every K/V row the block reads (GQA);
//     only a kv head with more than 8 query heads (MQA at G = 48) reads
//     its rows once per chunk; the chunk width (1, 2, 4 or 8) is a
//     template argument, so the per-head state is unrolled in registers;
//   * 8 warps stride over the positions below ``length``, 4 consecutive
//     positions per warp at a time, whose K and V rows are all loaded
//     before any is used, so 8 rows per warp are in flight; a warp reads a
//     row coalesced (lane l holds elements l, l+32, ...) and combines its
//     G dot products with shuffles;
//   * each warp keeps its own online softmax (m, l, acc) in registers;
//     the 8 warps' states are merged once at the end through shared
//     memory;
//   * positions at or past ``length`` are never read (the TPU kernel's
//     `k_off < length` saving), and the caches are addressed through their
//     strides, so the model passes views of its (B, S, KV, hd) cache.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;                // positions per warp per step
constexpr int kMaxHeads = 8;              // query heads per block, at most
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Strides {      // element strides; the last axis of every tensor is 1
  long long qb, qh, qg;
  long long kb, kh, ks;
  long long vb, vh, vs;
};

template <typename T, int DP, int kHeads>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, T* __restrict__ o, Strides st, int KV,
              int G, int S, const int32_t* __restrict__ length_ptr,
              int length_val, float scale) {
  constexpr int D = DP * 32;
  __shared__ float sm_m[kWarps][kHeads];
  __shared__ float sm_l[kWarps][kHeads];
  __shared__ float sm_acc[kWarps][kHeads][D];

  const int g0 = blockIdx.x * kHeads, h = blockIdx.y, b = blockIdx.z;
  const int gc = min(kHeads, G - g0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int len = length_ptr != nullptr ? *length_ptr : length_val;
  len = max(0, min(len, S));

  float qr[kHeads][DP], acc[kHeads][DP], m[kHeads], l[kHeads];
  const T* qp = q + b * st.qb + h * st.qh;
#pragma unroll
  for (int gi = 0; gi < kHeads; ++gi) {
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      qr[gi][i] = gi < gc ? to_f32(qp[(g0 + gi) * st.qg + lane + 32 * i]) : 0.f;
      acc[gi][i] = 0.f;
    }
    m[gi] = kNegInf;
    l[gi] = 0.f;
  }

  const T* kp = kc + b * st.kb + h * st.kh;
  const T* vp = vc + b * st.vb + h * st.vh;
  for (int p0 = warp * kUnroll; p0 < len; p0 += kWarps * kUnroll) {
    float kf[kUnroll][DP], vf[kUnroll][DP];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        kf[u][i] = p < len ? to_f32(kp[p * st.ks + lane + 32 * i]) : 0.f;
        vf[u][i] = p < len ? to_f32(vp[p * st.vs + lane + 32 * i]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p0 + u >= len) break;           // uniform across the warp
      float s[kHeads];
#pragma unroll
      for (int gi = 0; gi < kHeads; ++gi) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DP; ++i) dot += qr[gi][i] * kf[u][i];
        s[gi] = dot;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int gi = 0; gi < kHeads; ++gi)
          s[gi] += __shfl_xor_sync(0xffffffffu, s[gi], off);
      }
#pragma unroll
      for (int gi = 0; gi < kHeads; ++gi) {
        const float sc = s[gi] * scale;
        const float m_new = fmaxf(m[gi], sc);
        const float alpha = expf(m[gi] - m_new);
        const float p = expf(sc - m_new);
        l[gi] = l[gi] * alpha + p;
#pragma unroll
        for (int i = 0; i < DP; ++i)
          acc[gi][i] = acc[gi][i] * alpha + p * vf[u][i];
        m[gi] = m_new;
      }
    }
  }

#pragma unroll
  for (int gi = 0; gi < kHeads; ++gi) {
    if (lane == 0) {
      sm_m[warp][gi] = m[gi];
      sm_l[warp][gi] = l[gi];
    }
#pragma unroll
    for (int i = 0; i < DP; ++i) sm_acc[warp][gi][lane + 32 * i] = acc[gi][i];
  }
  __syncthreads();

  T* op = o + (((long long)b * KV + h) * G + g0) * D;
  for (int e = threadIdx.x; e < gc * D; e += kThreads) {
    const int gi = e / D, d = e % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][gi]);
    float tot_l = 0.f, tot_a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (sm_l[w][gi] == 0.f) continue;   // a warp that saw no position
      const float f = expf(sm_m[w][gi] - mx);
      tot_l += sm_l[w][gi] * f;
      tot_a += sm_acc[w][gi][d] * f;
    }
    op[gi * D + d] = from_f32<T>(tot_a / fmaxf(tot_l, 1e-20f));
  }
}

template <typename T, int DP, int kHeads>
int launch_g(const void* q, const void* kc, const void* vc, void* o,
             const Strides& st, int B, int KV, int G, int S,
             const int32_t* length_ptr, int length_val, float scale,
             cudaStream_t stream) {
  const dim3 grid((G + kHeads - 1) / kHeads, KV, B);
  decode_kernel<T, DP, kHeads><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<T*>(o), st, KV, G, S, length_ptr,
      length_val, scale);
  return static_cast<int>(cudaGetLastError());
}

// the block's query-head chunk: G itself when it is 1, 2 or 4, else 8
template <typename T, int DP>
int launch_d(const void* q, const void* kc, const void* vc, void* o,
             const Strides& st, int B, int KV, int G, int S,
             const int32_t* length_ptr, int length_val, float scale,
             cudaStream_t stream) {
  if (G == 1)
    return launch_g<T, DP, 1>(q, kc, vc, o, st, B, KV, G, S, length_ptr,
                              length_val, scale, stream);
  if (G == 2)
    return launch_g<T, DP, 2>(q, kc, vc, o, st, B, KV, G, S, length_ptr,
                              length_val, scale, stream);
  if (G <= 4)
    return launch_g<T, DP, 4>(q, kc, vc, o, st, B, KV, G, S, length_ptr,
                              length_val, scale, stream);
  return launch_g<T, DP, kMaxHeads>(q, kc, vc, o, st, B, KV, G, S, length_ptr,
                                    length_val, scale, stream);
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, void* o,
           const Strides& st, int B, int KV, int G, int S, int D,
           const int32_t* length_ptr, int length_val, float scale,
           cudaStream_t stream) {
  if (B <= 0 || KV <= 0 || G <= 0) return 0;
  switch (D) {
    case 32:
      return launch_d<T, 1>(q, kc, vc, o, st, B, KV, G, S, length_ptr,
                            length_val, scale, stream);
    case 64:
      return launch_d<T, 2>(q, kc, vc, o, st, B, KV, G, S, length_ptr,
                            length_val, scale, stream);
    case 96:
      return launch_d<T, 3>(q, kc, vc, o, st, B, KV, G, S, length_ptr,
                            length_val, scale, stream);
    case 128:
      return launch_d<T, 4>(q, kc, vc, o, st, B, KV, G, S, length_ptr,
                            length_val, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches on ``stream`` and returns cudaGetLastError(). q is (B, KV, G, D)
// and the caches (B, KV, S, D), each given by its element strides (the last
// axis has stride 1); o is (B, KV, G, D) contiguous; D is 32, 64, 96 or 128.
// ``length_ptr`` (an int32 on the device) wins over ``length_val`` when it
// is not null. ``bf16`` selects bf16 (1) or fp32 (0) for all four tensors.
int decode_attention(const void* q, const void* kc, const void* vc, void* o,
                     long long qb, long long qh, long long qg, long long kb,
                     long long kh, long long ks, long long vb, long long vh,
                     long long vs, int B, int KV, int G, int S, int D,
                     const void* length_ptr, int length_val, float scale,
                     int bf16, void* stream) {
  const Strides st{qb, qh, qg, kb, kh, ks, vb, vh, vs};
  const int32_t* lp = static_cast<const int32_t*>(length_ptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, kc, vc, o, st, B, KV, G, S, D, lp,
                                      length_val, scale, s)
              : launch<float>(q, kc, vc, o, st, B, KV, G, S, D, lp,
                              length_val, scale, s);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
