// Causal (or full) GQA prefill attention for Hopper (sm_90a), flash style:
//
//     o[b, h, g, i] = sum_j softmax_j(q[b, h, g, i] . k[b, h, j] / sqrt(D)) v[b, h, j]
//
// over the keys j <= i when causal (all Skv keys otherwise), with the
// scores, the online softmax and the sums in fp32, for fp32 or bf16 q, k,
// v; the output in q's type. Masked scores are -1e30, as in the reference.
//
// Replaces repro/kernels/flash_attention.py:_flash_kernel (the Pallas TPU
// kernel). The TPU version walks a (B, KV, q block, kv block) grid whose
// last axis is sequential, carrying m, l and acc in VMEM scratch between
// grid steps, and feeds (G*bq, D) x (D, bkv) tiles to the matrix unit.
// Hopper blocks run in no order, so here a block owns a set of query rows
// and loops over the kv tiles itself, the state in registers.
//
// Bound: at the serving shape (llama3.2-1b, B=4, S=512, bf16) one layer's
// call must move 21 MB (q, k, v once, the output once) and do 4.3 GFLOP of
// causal products, so the bytes bound it (6.3 us at 3.35 TB/s vs 4.3 us at
// 989 TFLOP/s); this first design does the products on the CUDA cores in
// fp32, so operations bound it in practice. What it does:
//   * the rows of one (b, kv-head) are flattened query-major, r = i*G + g,
//     and a block takes 128/TPR consecutive rows: the G query heads of a
//     kv head share every K/V tile the block stages (GQA), and the block's
//     rows span few query positions, so its causal extent is tight;
//   * TPR threads share a row (TPR = 1, 2, 4 for D = 32, 64, 96/128), each
//     holding D/TPR of q and of the fp32 accumulator in registers, with
//     the q.k partial sums combined by TPR-lane shuffles;
//   * K/V tiles of BKV rows are staged in shared memory as fp32 (32 KB),
//     read as broadcasts (all rows of a warp read one key at a time, and
//     the TPR parts of a row are interleaved across banks);
//   * kv tiles wholly above the block's last query are never loaded (the
//     TPU kernel's `run` skip); keys are taken in chunks of 16, so the
//     running max and the rescale of acc happen once per chunk;
//   * q, k, v and o are addressed through their strides (unit stride on
//     the last axis only), so the model hands in views of its projections
//     and no layout copy is made; any Sq and Skv work.
// wgmma and TMA are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;                // keys per online-softmax update
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
  long long qb, qh, qg, qs;
  long long kb, kh, ks;
  long long vb, vh, vs;
  long long ob, oh, og, os;
};

template <typename T, int D, int TPR, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Strides st, int G,
             int Sq, int Skv, int causal, float scale) {
  constexpr int DP = D / TPR;             // elements of a row per thread
  constexpr int ROWS = kThreads / TPR;    // query rows per block
  __shared__ float ks[BKV][D];
  __shared__ float vs[BKV][D];

  const int h = blockIdx.y, b = blockIdx.z;
  const int R = Sq * G;
  const int row0 = blockIdx.x * ROWS;
  const int row = row0 + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const bool valid = row < R;
  const int qpos = valid ? row / G : 0;
  const int g = valid ? row % G : 0;

  float qr[DP], acc[DP];
  const T* qp = q + b * st.qb + h * st.qh + g * st.qg + qpos * st.qs;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = valid ? to_f32(qp[i * TPR + part]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const int q_hi = (min(row0 + ROWS, R) - 1) / G;   // block's last query
  const int kv_end = causal ? min(Skv, q_hi + 1) : Skv;
  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;

  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();                      // the previous tile is consumed
    for (int e = threadIdx.x; e < BKV * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const bool in = k0 + j < Skv;
      ks[j][d] = in ? to_f32(kp[(k0 + j) * st.ks + d]) : 0.f;
      vs[j][d] = in ? to_f32(vp[(k0 + j) * st.vs + d]) : 0.f;
    }
    __syncthreads();
    const int jmax = min(BKV, kv_end - k0);
    for (int j0 = 0; j0 < jmax; j0 += kChunk) {
      float s[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DP; ++i) dot += qr[i] * ks[j][i * TPR + part];
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const int kpos = k0 + j;
        const bool ok = j < jmax && (!causal || kpos <= qpos);
        s[c] = ok ? dot * scale : kNegInf;
        cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] *= alpha;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float p = s[c] > 0.5f * kNegInf ? expf(s[c] - m_new) : 0.f;
        l += p;
#pragma unroll
        for (int i = 0; i < DP; ++i) acc[i] += p * vs[j0 + c][i * TPR + part];
      }
      m = m_new;
    }
  }

  if (valid) {
    T* op = o + b * st.ob + h * st.oh + g * st.og + qpos * st.os;
    const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
    for (int i = 0; i < DP; ++i) op[i * TPR + part] = from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int D, int TPR, int BKV>
int launch_d(const void* q, const void* k, const void* v, void* o,
             const Strides& st, int B, int KV, int G, int Sq, int Skv,
             int causal, float scale, cudaStream_t stream) {
  constexpr int ROWS = kThreads / TPR;
  const dim3 grid((Sq * G + ROWS - 1) / ROWS, KV, B);
  flash_kernel<T, D, TPR, BKV><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st, G, Sq, Skv, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides& st, int B, int KV, int G, int Sq, int Skv, int D,
           int causal, float scale, cudaStream_t stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || Sq <= 0 || Skv <= 0) return 0;
  switch (D) {
    case 32:
      return launch_d<T, 32, 1, 64>(q, k, v, o, st, B, KV, G, Sq, Skv, causal,
                                    scale, stream);
    case 64:
      return launch_d<T, 64, 2, 64>(q, k, v, o, st, B, KV, G, Sq, Skv, causal,
                                    scale, stream);
    case 96:
      return launch_d<T, 96, 4, 32>(q, k, v, o, st, B, KV, G, Sq, Skv, causal,
                                    scale, stream);
    case 128:
      return launch_d<T, 128, 4, 32>(q, k, v, o, st, B, KV, G, Sq, Skv,
                                     causal, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches on ``stream`` and returns cudaGetLastError(). q/o are
// (B, KV, G, Sq, D) and k/v (B, KV, Skv, D), each given by its element
// strides (the last axis has stride 1); D is 32, 64, 96 or 128. ``bf16``
// selects bf16 (1) or fp32 (0) for all four tensors.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    long long qb, long long qh, long long qg, long long qs,
                    long long kb, long long kh, long long ks, long long vb,
                    long long vh, long long vs, long long ob, long long oh,
                    long long og, long long os, int B, int KV, int G, int Sq,
                    int Skv, int D, int causal, float scale, int bf16,
                    void* stream) {
  const Strides st{qb, qh, qg, qs, kb, kh, ks, vb, vh, vs, ob, oh, og, os};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, o, st, B, KV, G, Sq, Skv, D,
                                      causal, scale, s)
              : launch<float>(q, k, v, o, st, B, KV, G, Sq, Skv, D, causal,
                              scale, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
