// GQA attention backward for Hopper (sm_90a). For the forward
//
//     o[b, h, g, i] = sum_j P[i, j] v[b, h, j],
//     P[i, :] = softmax_j(q[b, h, g, i] . k[b, h, j] * scale)
//
// over the keys j <= i when causal (top-left aligned, as the forward's
// ``ki <= qi``) or all Skv of them, and the upstream gradient dO, it gives
//
//     Delta_i = sum_d dO[i, d] o[i, d]
//     dS[i, j] = P[i, j] (dO_i . v_j - Delta_i)
//     dq_i = scale sum_j dS[i, j] k_j
//     dk_j = scale sum_{g, i} dS[i, j] q_i,   dv_j = sum_{g, i} P[i, j] dO_i
//
// fp32 inside, for fp32 or bf16 q, k, v, o and dO (one type); dq, dk and
// dv come out in that type. Query head h*G + g reads kv head h.
//
// Replaces no TPU kernel: the JAX package trains through the plain
// ``_sdpa`` (repro/models/transformer.py) under jax.value_and_grad, with
// no custom_vjp, so there is no backward kernel to carry over. The port's
// forward runs the hand-written flash_attention kernel, whose output
// autograd cannot differentiate, so training needs this one.
//
// Three launches in stream order, each with the rows of one (b, kv head)
// flattened query-major, r = i*G + g (as the forward does), so the G query
// heads of a kv head share every K/V tile a block stages:
//   1. stats: per block of query rows, the row's log2-sum-exp over its
//      keys (recomputed, so the tuned forward kernel stays as it is) and
//      Delta; both into fp32 scratch;
//   2. dkdv: a block owns a tile of keys (each key's k, v, dk and dv in the
//      registers of a group of TPR lanes) and walks the query rows that
//      can see them in tiles staged in shared memory, recomputing P from
//      the stats: each key tile is written by one block, so no atomics;
//   3. dq: per block of query rows, the same walk over key tiles as 1.
// Every product runs in fp32 on the CUDA cores: a thread holds D/TPR of
// the head dims (dim d = sub + TPR*t, so the lanes of a group read
// neighbouring shared words), and the partial dot products are combined
// by TPR-lane shuffles. Kernels 2 and 3 skip what a causal mask removes
// (key tiles above a block's last query, query rows above a tile's first
// key). All operands are addressed through their strides (unit stride on
// the last axis), so the forward's permuted views need no copy.
//
// Bound: at llama3.2-1b's training shape (batch 4 x 512, D 64, causal,
// bf16) a layer's call must move ~25 MB and do five products of 2*D flops
// per scored (query, key) pair: operations bound it on the tensor cores
// (~10 us at 989 TFLOP/s) and far more so here on the CUDA cores, where
// it stays until a later PR moves the products onto wgmma: this kernel is
// written to be right and simple first.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;                 // keys (1, 3) or query rows (2)
                                          // staged per shared tile
constexpr float kLog2e = 1.4426950408889634f;

using bf16_bits = uint16_t;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16_bits v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16_bits from_f32<bf16_bits>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// element strides of the operands: a 5-d (B, KV, G, S, D) tensor uses
// [0..3], a 4-d (B, KV, S, D) one [0..2]
struct Strides {
  long long q[4], k[3], v[3], o[4], dO[4], dq[4], dk[3], dv[3];
};

template <int TPR>
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <int TPR>
__device__ __forceinline__ void group_sum2(float& a, float& b) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
}

// rows [j0, j0 + kTile) of a (S, D) slab with row stride ``rs`` into
// shared fp32, zeros past ``n``
template <typename T, int D>
__device__ __forceinline__ void stage(float (*dst)[D], const T* src,
                                      long long rs, int j0, int n) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int row = e / D, col = e % D;
    const int j = j0 + row;
    dst[row][col] = j < n ? to_f32(src[(long long)j * rs + col]) : 0.f;
  }
}

// 1. per query row: lse2 = log2 sum_j 2^(s_j log2e) and Delta
template <typename T, int D, int TPR>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ o, const T* __restrict__ dO, Strides st,
             float* __restrict__ lse, float* __restrict__ delta, int KV,
             int G, int Sq, int Skv, int causal, float scale) {
  constexpr int DPT = D / TPR, ROWS = kThreads / TPR;
  __shared__ float ks[kTile][D];
  const int b = blockIdx.y / KV, h = blockIdx.y % KV;
  const int R = Sq * G;
  const int sub = threadIdx.x % TPR;
  const int r = blockIdx.x * ROWS + threadIdx.x / TPR;
  const bool live = r < R;
  const int i = live ? r / G : 0, g = live ? r % G : 0;
  const float sl2 = scale * kLog2e;

  const T* qr = q + b * st.q[0] + h * st.q[1] + g * st.q[2] + i * st.q[3];
  float qv[DPT];
#pragma unroll
  for (int t = 0; t < DPT; ++t) qv[t] = live ? to_f32(qr[sub + TPR * t]) : 0.f;

  const int rlast = min(R, (blockIdx.x + 1) * ROWS) - 1;
  const int kend = causal ? min(Skv, rlast / G + 1) : Skv;
  const T* kb = k + b * st.k[0] + h * st.k[1];
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < kend; j0 += kTile) {
    __syncthreads();
    stage<T, D>(ks, kb, st.k[2], j0, Skv);
    __syncthreads();
    const int jn = min(kTile, kend - j0);
    for (int jj = 0; jj < jn; ++jj) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < DPT; ++t) s += qv[t] * ks[jj][sub + TPR * t];
      s = group_sum<TPR>(s) * sl2;
      if (live && (!causal || j0 + jj <= i)) {
        if (s > m) {
          l = l * exp2f(m - s) + 1.f;
          m = s;
        } else {
          l += exp2f(s - m);
        }
      }
    }
  }
  const T* orow = o + b * st.o[0] + h * st.o[1] + g * st.o[2] + i * st.o[3];
  const T* drow = dO + b * st.dO[0] + h * st.dO[1] + g * st.dO[2] +
                  i * st.dO[3];
  float dl = 0.f;
#pragma unroll
  for (int t = 0; t < DPT; ++t)
    if (live) dl += to_f32(orow[sub + TPR * t]) * to_f32(drow[sub + TPR * t]);
  dl = group_sum<TPR>(dl);
  if (live && sub == 0) {
    const long long idx = (long long)blockIdx.y * R + r;
    lse[idx] = m + log2f(l);
    delta[idx] = dl;
  }
}

// 2. per key tile: dk and dv over every query row that sees it
template <typename T, int D, int TPR>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dO, Strides st,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int KV, int G, int Sq,
            int Skv, int causal, float scale) {
  constexpr int DPT = D / TPR, KEYS = kThreads / TPR;
  __shared__ float qs[kTile][D];
  __shared__ float dos[kTile][D];          // dO rows
  __shared__ float ls[kTile], dl[kTile];
  const int b = blockIdx.y / KV, h = blockIdx.y % KV;
  const int R = Sq * G;
  const int sub = threadIdx.x % TPR;
  const int j0 = blockIdx.x * KEYS;
  const int j = j0 + threadIdx.x / TPR;
  const bool live = j < Skv;
  const float sl2 = scale * kLog2e;

  const T* kr = k + b * st.k[0] + h * st.k[1] + (live ? j : 0) * st.k[2];
  const T* vr = v + b * st.v[0] + h * st.v[1] + (live ? j : 0) * st.v[2];
  float kv_[DPT], vv[DPT], dka[DPT], dva[DPT];
#pragma unroll
  for (int t = 0; t < DPT; ++t) {
    kv_[t] = live ? to_f32(kr[sub + TPR * t]) : 0.f;
    vv[t] = live ? to_f32(vr[sub + TPR * t]) : 0.f;
    dka[t] = 0.f;
    dva[t] = 0.f;
  }

  // query rows r = i*G + g with i >= j0 can see this tile when causal
  const int rstart = causal ? min(R, j0 * G) / kTile * kTile : 0;
  const long long sidx = (long long)blockIdx.y * R;
  for (int r0 = rstart; r0 < R; r0 += kTile) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
      const int row = e / D, col = e % D;
      const int rr = r0 + row;
      float qe = 0.f, de = 0.f;
      if (rr < R) {
        const int ii = rr / G, gg = rr % G;
        qe = to_f32(q[b * st.q[0] + h * st.q[1] + gg * st.q[2] +
                      ii * st.q[3] + col]);
        de = to_f32(dO[b * st.dO[0] + h * st.dO[1] + gg * st.dO[2] +
                       ii * st.dO[3] + col]);
      }
      qs[row][col] = qe;
      dos[row][col] = de;
    }
    if (threadIdx.x < kTile) {
      const int rr = r0 + threadIdx.x;
      ls[threadIdx.x] = rr < R ? lse[sidx + rr] : 0.f;
      dl[threadIdx.x] = rr < R ? delta[sidx + rr] : 0.f;
    }
    __syncthreads();
    const int rn = min(kTile, R - r0);
    for (int rr = 0; rr < rn; ++rr) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int t = 0; t < DPT; ++t) {
        s += qs[rr][sub + TPR * t] * kv_[t];
        dp += dos[rr][sub + TPR * t] * vv[t];
      }
      group_sum2<TPR>(s, dp);
      const int i = (r0 + rr) / G;
      const bool ok = live && (!causal || j <= i);
      const float p = ok ? exp2f(s * sl2 - ls[rr]) : 0.f;
      const float dsv = p * (dp - dl[rr]);
#pragma unroll
      for (int t = 0; t < DPT; ++t) {
        dva[t] += p * dos[rr][sub + TPR * t];
        dka[t] += dsv * qs[rr][sub + TPR * t];
      }
    }
  }
  if (live) {
    T* dkr = dk + b * st.dk[0] + h * st.dk[1] + j * st.dk[2];
    T* dvr = dv + b * st.dv[0] + h * st.dv[1] + j * st.dv[2];
#pragma unroll
    for (int t = 0; t < DPT; ++t) {
      dkr[sub + TPR * t] = from_f32<T>(dka[t] * scale);
      dvr[sub + TPR * t] = from_f32<T>(dva[t]);
    }
  }
}

// 3. per query row: dq over the keys it sees
template <typename T, int D, int TPR>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dO, Strides st,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int KV, int G, int Sq, int Skv, int causal,
          float scale) {
  constexpr int DPT = D / TPR, ROWS = kThreads / TPR;
  __shared__ float ks[kTile][D];
  __shared__ float vs[kTile][D];
  const int b = blockIdx.y / KV, h = blockIdx.y % KV;
  const int R = Sq * G;
  const int sub = threadIdx.x % TPR;
  const int r = blockIdx.x * ROWS + threadIdx.x / TPR;
  const bool live = r < R;
  const int i = live ? r / G : 0, g = live ? r % G : 0;
  const float sl2 = scale * kLog2e;

  const T* qr = q + b * st.q[0] + h * st.q[1] + g * st.q[2] + i * st.q[3];
  const T* dr = dO + b * st.dO[0] + h * st.dO[1] + g * st.dO[2] +
                i * st.dO[3];
  float qv[DPT], dv_[DPT], acc[DPT];
#pragma unroll
  for (int t = 0; t < DPT; ++t) {
    qv[t] = live ? to_f32(qr[sub + TPR * t]) : 0.f;
    dv_[t] = live ? to_f32(dr[sub + TPR * t]) : 0.f;
    acc[t] = 0.f;
  }
  const long long idx = (long long)blockIdx.y * R + (live ? r : 0);
  const float lrow = live ? lse[idx] : 0.f;
  const float drow = live ? delta[idx] : 0.f;

  const int rlast = min(R, (blockIdx.x + 1) * ROWS) - 1;
  const int kend = causal ? min(Skv, rlast / G + 1) : Skv;
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  for (int j0 = 0; j0 < kend; j0 += kTile) {
    __syncthreads();
    stage<T, D>(ks, kb, st.k[2], j0, Skv);
    stage<T, D>(vs, vb, st.v[2], j0, Skv);
    __syncthreads();
    const int jn = min(kTile, kend - j0);
    for (int jj = 0; jj < jn; ++jj) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int t = 0; t < DPT; ++t) {
        s += qv[t] * ks[jj][sub + TPR * t];
        dp += dv_[t] * vs[jj][sub + TPR * t];
      }
      group_sum2<TPR>(s, dp);
      const bool ok = live && (!causal || j0 + jj <= i);
      const float p = ok ? exp2f(s * sl2 - lrow) : 0.f;
      const float dsv = p * (dp - drow);
#pragma unroll
      for (int t = 0; t < DPT; ++t) acc[t] += dsv * ks[jj][sub + TPR * t];
    }
  }
  if (live) {
    T* out = dq + b * st.dq[0] + h * st.dq[1] + g * st.dq[2] + i * st.dq[3];
#pragma unroll
    for (int t = 0; t < DPT; ++t) out[sub + TPR * t] = from_f32<T>(acc[t] * scale);
  }
}

template <typename T, int D, int TPR>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* dO, void* dq, void* dk, void* dv, float* lse,
             float* delta, const Strides& st, int B, int KV, int G, int Sq,
             int Skv, int causal, float scale, cudaStream_t stream) {
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v), *op = static_cast<const T*>(o),
          *dop = static_cast<const T*>(dO);
  const int R = Sq * G;
  constexpr int ROWS = kThreads / TPR;
  const dim3 rows_grid((R + ROWS - 1) / ROWS, B * KV);
  const dim3 keys_grid((Skv + ROWS - 1) / ROWS, B * KV);
  if (rows_grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  stats_kernel<T, D, TPR><<<rows_grid, kThreads, 0, stream>>>(
      qp, kp, op, dop, st, lse, delta, KV, G, Sq, Skv, causal, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T, D, TPR><<<keys_grid, kThreads, 0, stream>>>(
      qp, kp, vp, dop, st, lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), KV, G, Sq, Skv, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, D, TPR><<<rows_grid, kThreads, 0, stream>>>(
      qp, kp, vp, dop, st, lse, delta, static_cast<T*>(dq), KV, G, Sq, Skv,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, void* dq, void* dk, void* dv, float* lse,
           float* delta, const Strides& st, int B, int KV, int G, int Sq,
           int Skv, int D, int causal, float scale, cudaStream_t stream) {
#define FB_ARGS q, k, v, o, dO, dq, dk, dv, lse, delta, st, B, KV, G, Sq, Skv, \
                causal, scale, stream
  switch (D) {
    case 32: return launch_d<T, 32, 2>(FB_ARGS);
    case 64: return launch_d<T, 64, 4>(FB_ARGS);
    case 96: return launch_d<T, 96, 8>(FB_ARGS);
    case 128: return launch_d<T, 128, 8>(FB_ARGS);
  }
#undef FB_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches the three kernels on ``stream`` and returns cudaGetLastError().
// ``strides`` holds 28 element strides in the order of ``Strides``: q, o,
// dO and dq are (B, KV, G, Sq, D) (4 each), k, v, dk and dv (B, KV, Skv, D)
// (3 each), the last axis unit-stride. ``lse`` and ``delta`` are fp32
// scratch of B*KV*G*Sq each. ``bf16`` selects bf16 (1) or fp32 (0) for
// every operand; D is 32, 64, 96 or 128; Sq, Skv >= 1.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dO, void* dq, void* dk,
                        void* dv, void* lse, void* delta,
                        const long long* strides, int B, int KV, int G,
                        int Sq, int Skv, int D, int causal, float scale,
                        int bf16, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || Sq <= 0 || Skv <= 0) return 0;
  Strides st;
  const long long* s = strides;
  for (int a = 0; a < 4; ++a) st.q[a] = *s++;
  for (int a = 0; a < 3; ++a) st.k[a] = *s++;
  for (int a = 0; a < 3; ++a) st.v[a] = *s++;
  for (int a = 0; a < 4; ++a) st.o[a] = *s++;
  for (int a = 0; a < 4; ++a) st.dO[a] = *s++;
  for (int a = 0; a < 4; ++a) st.dq[a] = *s++;
  for (int a = 0; a < 3; ++a) st.dk[a] = *s++;
  for (int a = 0; a < 3; ++a) st.dv[a] = *s++;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(delta);
  if (bf16)
    return launch<bf16_bits>(q, k, v, o, dO, dq, dk, dv, l, d, st, B, KV, G,
                             Sq, Skv, D, causal, scale, cs);
  return launch<float>(q, k, v, o, dO, dq, dk, dv, l, d, st, B, KV, G, Sq,
                       Skv, D, causal, scale, cs);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
