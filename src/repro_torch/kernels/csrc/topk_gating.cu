// MoE router gating for Hopper (sm_90a): per token row of fp32 logits,
//
//     p = softmax(logits[r, :E])                  (fp32)
//     k rounds: i_j = argmax(p), w_j = p[i_j], p[i_j] = -1e30
//     w[r, :] = w / max(sum_j w_j, 1e-9),  idx[r, :] = i
//
// Ties go to the lowest index, as jnp.argmax and lax.top_k break them.
//
// Replaces repro/kernels/topk_gating.py:_gating_kernel (the Pallas TPU
// kernel), which holds a (512, E) block of rows in VMEM and runs the k
// argmax-and-mask rounds unrolled.
//
// Bound: memory, and at the serving shapes launch latency and the length
// of each row's chain of dependent steps. Per row the kernel reads E fp32
// logits once and writes k weights and k indices; its arithmetic (E
// exponentials, k small reductions) is tiny. At a decode step (4 rows) the
// whole call is one row's chain: max, sum, then k rounds of argmax, each a
// butterfly of shuffles. What the design does about it:
//   * G lanes own a row (G a power of two, 2 to 32, from E: 16 at E 64, 4 at
//     E 16, 2 at E 8), so a warp holds 32 / G rows and each butterfly has
//     log2(G) levels instead of 5; lane t reads its elements as 16-byte
//     loads (elements 4t .. 4t + 3, then 4(G + t) .. where E > 4G), all
//     in flight before the first is used;
//   * the row stays in registers: max, sum and every round's argmax are
//     shuffle butterflies over the row's G lanes, with no shared memory and
//     no barrier;
//   * a lane scans its own elements in ascending index and the butterfly
//     keeps the lower index of two equal values, so ties go to the lowest
//     expert index; the pick runs on exp(v - m) / s, the divided values,
//     as the plain version's argmax does;
//   * results stay in registers: after each round every lane of the row
//     holds the winner and its running total; lane j mod G keeps round j's
//     weight and index, and when the rounds end each lane divides what it
//     keeps by the total and stores it, once, beside the others' (no global
//     location is read back).
// Ragged E (not a multiple of 4) or a base that is not 16-byte aligned
// takes the scalar route (V = 1: lane t holds elements t, t + G, ...): the
// same kernel body, chosen by the plan. The plan (V, loads per lane, G,
// rows per block, blocks) lives in Python (``topk_gating.plan``). Any N;
// E up to 256.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr float kNegInf = -1e30f;

// V elements moved as one access when aligned to it
template <int V>
struct alignas(V * sizeof(float)) Pack {
  float v[V];
};

// G lanes per row, V elements per access, NV accesses per lane
template <int G, int V, int NV>
__global__ void __launch_bounds__(kMaxThreads)
topk_gating_kernel(const float* __restrict__ logits, float* __restrict__ w,
                   int* __restrict__ idx, int N, int E, int k) {
  constexpr int PER = V * NV;              // elements a lane holds
  const int lane = threadIdx.x % 32;
  const int t = lane % G;                  // this lane's place in its row
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  // a row past N routes row N - 1 again and stores nothing, so every lane
  // of the warp takes part in every shuffle
  const bool stores = r < N;
  const float* row = logits + (stores ? r : N - 1) * (long long)E;

  // element i of this lane: access i / V, place i % V
  auto index = [&](int i) { return ((i / V) * G + t) * V + i % V; };

  float v[PER];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e0 = (j * G + t) * V;
    if (e0 < E) {                          // V divides E on the vector route
      const Pack<V> p = *reinterpret_cast<const Pack<V>*>(row + e0);
#pragma unroll
      for (int c = 0; c < V; ++c) v[j * V + c] = p.v[c];
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
  for (int i = 0; i < PER; ++i) v[i] = index(i) < E ? v[i] / s : kNegInf;

  // round j = jj * G + l is kept by lane l in slot jj: k <= E <= G * PER
  float kept_w[PER];
  int kept_i[PER];
  float total = 0.f;
#pragma unroll
  for (int jj = 0; jj < PER; ++jj) {
    if (jj * G >= k) break;                // uniform across the row
#pragma unroll 1
    for (int l = 0; l < G && jj * G + l < k; ++l) {
      float best = kNegInf;
      int best_i = 0x7fffffff;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        if (v[i] > best) {                 // strict: the first index wins
          best = v[i];
          best_i = index(i);
        }
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
        if (ob > best || (ob == best && oi < best_i)) {
          best = ob;
          best_i = oi;
        }
      }
#pragma unroll
      for (int i = 0; i < PER; ++i)
        if (index(i) == best_i) v[i] = kNegInf;
      total += best;
      if (t == l) {
        kept_w[jj] = best;
        kept_i[jj] = best_i;
      }
    }
  }
  if (!stores) return;
  const float norm = fmaxf(total, 1e-9f);
  float* wr = w + r * (long long)k;
  int* ir = idx + r * (long long)k;
#pragma unroll
  for (int jj = 0; jj < PER; ++jj) {
    const int j = jj * G + t;
    if (j < k) {
      wr[j] = kept_w[jj] / norm;
      ir[j] = kept_i[jj];
    }
  }
}

template <int G, int V, int NV>
int launch_g(const float* logits, float* w, int* idx, int N, int E, int k,
             int threads, int blocks, cudaStream_t stream) {
  topk_gating_kernel<G, V, NV><<<blocks, threads, 0, stream>>>(
      logits, w, idx, N, E, k);
  return static_cast<int>(cudaGetLastError());
}

template <int V, int NV>
int launch_nv(const float* logits, float* w, int* idx, int N, int E, int k,
              int lanes, int threads, int blocks, cudaStream_t stream) {
#define TG_ARGS logits, w, idx, N, E, k, threads, blocks, stream
  switch (lanes) {
    case 2: return launch_g<2, V, NV>(TG_ARGS);
    case 4: return launch_g<4, V, NV>(TG_ARGS);
    case 8: return launch_g<8, V, NV>(TG_ARGS);
    case 16: return launch_g<16, V, NV>(TG_ARGS);
    case 32: return launch_g<32, V, NV>(TG_ARGS);
  }
#undef TG_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches on ``stream`` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a plan the kernel does not take). logits is
// (N, E) fp32 contiguous; w (N, k) fp32 and idx (N, k) int32 are written.
// ``vec`` (4 or 1), ``nv`` (accesses per lane), ``lanes`` (per row),
// ``rows_per_block`` and ``blocks`` are the Python plan's; the vector route
// needs logits 16-byte aligned and E a multiple of 4.
int topk_gating(const void* logits, void* w, void* idx, int N, int E, int k,
                int vec, int nv, int lanes, int rows_per_block, int blocks,
                void* stream) {
  if (N <= 0) return 0;
  const int threads = rows_per_block * lanes;
  if (E <= 0 || k <= 0 || k > E || vec < 1 || E % vec != 0 ||
      E > lanes * vec * nv || threads % 32 != 0 || threads > kMaxThreads ||
      blocks < 1 || (long long)blocks * rows_per_block < N)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(logits);
  float* wp = static_cast<float*>(w);
  int* ip = static_cast<int*>(idx);
#define TG_PLAN lg, wp, ip, N, E, k, lanes, threads, blocks, s
  if (vec == 4) {
    switch (nv) {
      case 1: return launch_nv<4, 1>(TG_PLAN);
      case 2: return launch_nv<4, 2>(TG_PLAN);
    }
  } else if (vec == 1) {
    switch (nv) {
      case 1: return launch_nv<1, 1>(TG_PLAN);
      case 2: return launch_nv<1, 2>(TG_PLAN);
      case 4: return launch_nv<1, 4>(TG_PLAN);
      case 8: return launch_nv<1, 8>(TG_PLAN);
    }
  }
#undef TG_PLAN
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* topk_gating_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
