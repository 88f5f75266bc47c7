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
// Bound: memory, and at the serving shapes launch latency. Per row the
// kernel reads E fp32 logits once and writes k weights and k indices; its
// arithmetic (E exponentials, k warp reductions) is tiny. What the design
// does about it:
//   * one warp per row, eight rows per 256-thread block; lane l holds the
//     row's elements l, l + 32, ... in registers (kMaxPerLane of them), so
//     the row is read once, coalesced, and never leaves registers;
//   * max, sum and each round's argmax are warp-shuffle reductions: no
//     shared memory and no block-level barrier;
//   * a lane scans its own elements in increasing index order and the
//     shuffle keeps the lower index of two equal values, so ties resolve to
//     the lowest expert index;
//   * lane 0 writes the row's k results and divides them by their sum.
// Any N (ragged last block masked by row); E up to 32 * kMaxPerLane.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kMaxPerLane = 8;            // E <= 256
constexpr float kNegInf = -1e30f;

template <int PER_LANE>
__global__ void __launch_bounds__(kThreads)
topk_gating_kernel(const float* __restrict__ logits, float* __restrict__ w,
                   int* __restrict__ idx, int N, int E, int k) {
  const int lane = threadIdx.x % 32;
  const long long r =
      (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (r >= N) return;                      // whole warp leaves together
  const float* row = logits + r * (long long)E;

  float v[PER_LANE];
  float m = kNegInf;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int e = lane + 32 * j;
    v[j] = e < E ? row[e] : kNegInf;
    m = fmaxf(m, v[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int e = lane + 32 * j;
    v[j] = e < E ? expf(v[j] - m) : 0.f;
    s += v[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j)
    v[j] = (lane + 32 * j) < E ? v[j] / s : kNegInf;

  float total = 0.f;
  float* wr = w + r * (long long)k;
  int* ir = idx + r * (long long)k;
  for (int round = 0; round < k; ++round) {
    float best = kNegInf;
    int best_i = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int e = lane + 32 * j;
      if (e < E && v[j] > best) {           // strict: first index wins
        best = v[j];
        best_i = e;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
      if (ob > best || (ob == best && oi < best_i)) {
        best = ob;
        best_i = oi;
      }
    }
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      if (lane + 32 * j == best_i) v[j] = kNegInf;
    total += best;
    if (lane == 0) {
      wr[round] = best;
      ir[round] = best_i;
    }
  }
  if (lane == 0) {                          // reads back its own writes
    const float norm = fmaxf(total, 1e-9f);
    for (int j = 0; j < k; ++j) wr[j] /= norm;
  }
}

template <int PER_LANE>
int launch(const float* logits, float* w, int* idx, int N, int E, int k,
           cudaStream_t stream) {
  const int blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  topk_gating_kernel<PER_LANE><<<blocks, kThreads, 0, stream>>>(
      logits, w, idx, N, E, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on ``stream`` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for sizes the kernel does not take). logits is
// (N, E) fp32 contiguous; w (N, k) fp32 and idx (N, k) int32 are written.
int topk_gating(const void* logits, void* w, void* idx, int N, int E, int k,
                void* stream) {
  if (N <= 0) return 0;
  if (E <= 0 || E > 32 * kMaxPerLane || k <= 0 || k > E)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(logits);
  float* wp = static_cast<float*>(w);
  int* ip = static_cast<int*>(idx);
  if (E <= 32) return launch<1>(lg, wp, ip, N, E, k, s);
  if (E <= 64) return launch<2>(lg, wp, ip, N, E, k, s);
  if (E <= 128) return launch<4>(lg, wp, ip, N, E, k, s);
  return launch<8>(lg, wp, ip, N, E, k, s);
}

const char* topk_gating_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
