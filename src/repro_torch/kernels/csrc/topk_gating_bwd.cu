// Backward of the MoE router gating (csrc/topk_gating.cu) for Hopper
// (sm_90a). Per token row, for the gradient dw of the k renormalised
// weights w routed to the experts idx:
//
//     p   = softmax(logits[r, :E])                 (recomputed, fp32)
//     t_j = p[idx_j],  s = sum_j t_j
//     dt_j = (dw_j - sum_i dw_i w_i) / s   where s > 1e-9, else dw_j / 1e-9
//     dlogits[r, e] = p_e * (sum_{j: idx_j = e} dt_j) - p_e * sum_j dt_j t_j
//
// Replaces no TPU kernel: the JAX package trains its router through jax's
// autodiff of softmax -> lax.top_k -> renormalise (repro/models/
// transformer.py:230-232); the Pallas forward (repro/kernels/topk_gating.py:
// _gating_kernel) has no backward. Indices carry no gradient.
//
// The forward's row layout: G lanes own a row (G a power of two, 2 to 32,
// from E), lane t holds elements 4t .. 4t + 3, 4(G + t) .. as 16-byte loads
// where E is a multiple of 4 and the bases are 16-byte aligned (else the
// scalar route, V = 1); the row's max and sum are shuffle butterflies over
// its G lanes, as in the forward, so p is the forward's p bit for bit.
// Every lane of the row reads the row's k indices, weights and gradients
// (a few cached loads, k is small on every model) and computes t_j from the
// logit at idx_j, s, sum dw w and sum dt t in the same order, then adds
// dt_j to the element it holds, if any; each lane writes its own elements
// of dlogits once, 16 bytes at a time. No atomics: a rerun is bit-equal.
// Rows past N route row N - 1 again and store nothing, so every lane of a
// warp takes part in every shuffle. Any N; E up to 256; the plan (V, loads
// per lane, G, rows per block, blocks) is ``topk_gating.bwd_plan``.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr float kNegInf = -1e30f;

template <int V>
struct alignas(V * sizeof(float)) Pack {
  float v[V];
};

template <int G, int V, int NV>
__global__ void __launch_bounds__(kMaxThreads)
topk_gating_bwd_kernel(const float* __restrict__ logits,
                       const int* __restrict__ idx,
                       const float* __restrict__ w,
                       const float* __restrict__ dw, float* __restrict__ dl,
                       int N, int E, int k) {
  constexpr int PER = V * NV;
  const int lane = threadIdx.x % 32;
  const int t = lane % G;
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const bool stores = r < N;
  const long long row_i = stores ? r : N - 1;
  const float* row = logits + row_i * E;

  auto index = [&](int i) { return ((i / V) * G + t) * V + i % V; };

  float v[PER];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e0 = (j * G + t) * V;
    if (e0 < E) {
      const Pack<V> pk = *reinterpret_cast<const Pack<V>*>(row + e0);
#pragma unroll
      for (int c = 0; c < V; ++c) v[j * V + c] = pk.v[c];
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) v[j * V + c] = kNegInf;
    }
  }
  float m = kNegInf;
#pragma unroll
  for (int i = 0; i < PER; ++i) m = fmaxf(m, v[i]);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v[i] = index(i) < E ? expf(v[i] - m) : 0.f;
    s += v[i];
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = v[i] / s;        // p, 0 past E

  const int* ir = idx + row_i * k;
  const float* wr = w + row_i * k;
  const float* dwr = dw + row_i * k;
  float tot = 0.f, sdw = 0.f;
  for (int j = 0; j < k; ++j) {
    tot += expf(row[ir[j]] - m) / s;
    sdw += dwr[j] * wr[j];
  }
  const bool big = tot > 1e-9f;
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  float c = 0.f;
  for (int j = 0; j < k; ++j) {
    const int e = ir[j];
    const float tj = expf(row[e] - m) / s;
    const float dtj = big ? (dwr[j] - sdw) / tot : dwr[j] / 1e-9f;
    c += dtj * tj;
#pragma unroll
    for (int i = 0; i < PER; ++i)          // the lane holding e, if any
      if (index(i) == e) acc[i] += dtj;
  }
  if (!stores) return;
  float* out = dl + r * E;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e0 = (j * G + t) * V;
    if (e0 < E) {
      Pack<V> pk;
#pragma unroll
      for (int cc = 0; cc < V; ++cc) {
        const float p = v[j * V + cc];
        pk.v[cc] = p * acc[j * V + cc] - p * c;
      }
      *reinterpret_cast<Pack<V>*>(out + e0) = pk;
    }
  }
}

template <int G, int V, int NV>
int launch_g(const float* logits, const int* idx, const float* w,
             const float* dw, float* dl, int N, int E, int k, int threads,
             int blocks, cudaStream_t stream) {
  topk_gating_bwd_kernel<G, V, NV><<<blocks, threads, 0, stream>>>(
      logits, idx, w, dw, dl, N, E, k);
  return static_cast<int>(cudaGetLastError());
}

template <int V, int NV>
int launch_nv(const float* logits, const int* idx, const float* w,
              const float* dw, float* dl, int N, int E, int k, int lanes,
              int threads, int blocks, cudaStream_t stream) {
#define TGB_ARGS logits, idx, w, dw, dl, N, E, k, threads, blocks, stream
  switch (lanes) {
    case 2: return launch_g<2, V, NV>(TGB_ARGS);
    case 4: return launch_g<4, V, NV>(TGB_ARGS);
    case 8: return launch_g<8, V, NV>(TGB_ARGS);
    case 16: return launch_g<16, V, NV>(TGB_ARGS);
    case 32: return launch_g<32, V, NV>(TGB_ARGS);
  }
#undef TGB_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches on ``stream`` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a plan the kernel does not take). logits (N, E)
// fp32, idx (N, k) int32, w and dw (N, k) fp32, all contiguous; dlogits (N,
// E) fp32 is written. ``vec`` (4 or 1), ``nv``, ``lanes``,
// ``rows_per_block`` and ``blocks`` are the Python plan's; the vector route
// needs logits and dlogits 16-byte aligned and E a multiple of 4.
int topk_gating_bwd(const void* logits, const void* idx, const void* w,
                    const void* dw, void* dlogits, int N, int E, int k,
                    int vec, int nv, int lanes, int rows_per_block,
                    int blocks, void* stream) {
  if (N <= 0) return 0;
  const int threads = rows_per_block * lanes;
  if (E <= 0 || k <= 0 || k > E || vec < 1 || E % vec != 0 ||
      E > lanes * vec * nv || threads % 32 != 0 || threads > kMaxThreads ||
      blocks < 1 || (long long)blocks * rows_per_block < N)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(logits);
  const int* ip = static_cast<const int*>(idx);
  const float* wp = static_cast<const float*>(w);
  const float* dwp = static_cast<const float*>(dw);
  float* dlp = static_cast<float*>(dlogits);
#define TGB_PLAN lg, ip, wp, dwp, dlp, N, E, k, lanes, threads, blocks, s
  if (vec == 4) {
    switch (nv) {
      case 1: return launch_nv<4, 1>(TGB_PLAN);
      case 2: return launch_nv<4, 2>(TGB_PLAN);
    }
  } else if (vec == 1) {
    switch (nv) {
      case 1: return launch_nv<1, 1>(TGB_PLAN);
      case 2: return launch_nv<1, 2>(TGB_PLAN);
      case 4: return launch_nv<1, 4>(TGB_PLAN);
      case 8: return launch_nv<1, 8>(TGB_PLAN);
    }
  }
#undef TGB_PLAN
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* topk_gating_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
