// Quorum aggregation for Hopper (sm_90a): masked per-slot FC merge.
//
//     out (B, C) = sum_k  mask_k * portion_k (B, Dk) @ (W_k (Dk, C) * s_k)  + bias
//
// Replaces repro/kernels/quorum_aggregate.py:_agg_kernel (the Pallas TPU
// kernel). The TPU version walks the slot axis k as a sequential grid axis
// and carries the (bb, C) sum in VMEM scratch between grid steps. Blocks on
// this card run in parallel and in no order, so here each block owns one
// (BM rows x BN classes) tile of the output and loops over k itself; the sum
// lives in a register of the thread that owns the output element.
//
// Bound: memory. The work is 2*K_alive*B*Dk*C flops against
// K_alive*B*Dk*4 + K_alive*Dk*C*w + B*C*4 bytes (w = 4 for fp32 weights, 1
// for int8), far below the card's flop-per-byte balance point. What the
// design does about it:
//   * a slot whose mask is 0 is skipped by a branch that is uniform across
//     the block, so its portion and its weights are never read (the TPU
//     kernel's HBM saving for failed slots);
//   * int8 weights are read as int8 and expanded to fp32 (q * s_k) on their
//     way into shared memory, so device memory carries a quarter of the
//     fp32 weight bytes; the fp32 path multiplies by s = 1 (bit-exact), so
//     both weight types share one body;
//   * portions and weights are staged through shared memory in TD-deep
//     slices of Dk, so any Dk and C fit (WRN-28-10's 640-wide final conv
//     with CIFAR-100's 100 classes does not fit one 48 KB slice).
// The per-slot dot is summed in its own fp32 register and then added to the
// accumulator (acc += dot_k, k ascending), the order of the JAX kernel.
// A block holds bm = block_batch rows of bn classes, one thread each
// (bm * bn <= 1024 threads; 16 rows of 16 classes for CIFAR-10's C = 10 is
// the launch this kernel made before it took a tile). bm changes which block
// owns an output, never the order of its sum, so every bm gives the same
// bits.
// No wgmma or TMA: at the serving shapes (K=8, Dk=32, C=10) one call moves a
// few hundred KB and launch latency dominates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;  // one output element per thread
constexpr int kTD = 32;            // depth of one staged Dk slice

template <typename W>
__global__ void __launch_bounds__(kMaxThreads)
quorum_aggregate_kernel(const float* __restrict__ portions,
                        const W* __restrict__ weights,
                        const float* __restrict__ scales,
                        const float* __restrict__ bias,
                        const int32_t* __restrict__ mask,
                        float* __restrict__ out, int K, int B, int Dk, int C,
                        int bm, int bn) {
  // bn (16 or 32) classes and bm rows per tile, bm * bn threads
  const int threads = bm * bn;
  const int tid = threadIdx.x;
  const int ty = tid / bn;  // row inside the tile
  const int tx = tid % bn;  // class inside the tile
  const int r0 = blockIdx.x * bm;
  const int c0 = blockIdx.y * bn;
  const int row = r0 + ty;
  const int col = c0 + tx;

  // +1 column keeps the row-broadcast reads of sp off one bank
  extern __shared__ float sp[];   // (bm, TD + 1) portion slice
  __shared__ float sw[kTD][32];   // (TD, bn) weight slice

  float acc = 0.f;
  for (int k = 0; k < K; ++k) {
    if (mask[k] == 0) continue;  // uniform: a failed slot reads nothing
    const float s = scales != nullptr ? scales[k] : 1.f;
    const float* pk = portions + (size_t)k * B * Dk;
    const W* wk = weights + (size_t)k * Dk * C;
    float dot = 0.f;
    for (int d0 = 0; d0 < Dk; d0 += kTD) {
      for (int i = tid; i < bm * kTD; i += threads) {
        const int r = i / kTD, d = i % kTD;
        const int gr = r0 + r, gd = d0 + d;
        sp[r * (kTD + 1) + d] =
            (gr < B && gd < Dk) ? pk[(size_t)gr * Dk + gd] : 0.f;
      }
      for (int i = tid; i < kTD * bn; i += threads) {
        const int d = i / bn, c = i % bn;
        const int gd = d0 + d, gc = c0 + c;
        sw[d][c] = (gd < Dk && gc < C)
                       ? static_cast<float>(wk[(size_t)gd * C + gc]) * s
                       : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int d = 0; d < kTD; ++d) dot += sp[ty * (kTD + 1) + d] * sw[d][tx];
      __syncthreads();
    }
    acc += dot;
  }
  if (row < B && col < C) out[(size_t)row * C + col] = acc + bias[col];
}

template <typename W>
int launch(const float* portions, const W* weights, const float* scales,
           const float* bias, const int32_t* mask, float* out, int K, int B,
           int Dk, int C, int bm, cudaStream_t stream) {
  if (B <= 0 || C <= 0) return 0;
  const int bn = C <= 16 ? 16 : 32;
  if (bm < 1 || bm * bn > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + bm - 1) / bm, (C + bn - 1) / bn);
  const size_t smem = (size_t)bm * (kTD + 1) * sizeof(float);
  quorum_aggregate_kernel<W><<<grid, bm * bn, smem, stream>>>(
      portions, weights, scales, bias, mask, out, K, B, Dk, C, bm, bn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on ``stream`` and returns cudaGetLastError().
// ``scales`` may be null on the fp32 path (scale 1); the int8 path needs it.
// ``bm`` rows per block, with bm * bn <= 1024 (bn = 16 for C <= 16, else
// 32); the Python wrapper clamps a table's entry there.
int quorum_aggregate_f32(const void* portions, const void* weights,
                         const void* scales, const void* bias,
                         const void* mask, void* out, int K, int B, int Dk,
                         int C, int bm, void* stream) {
  return launch<float>(static_cast<const float*>(portions),
                       static_cast<const float*>(weights),
                       static_cast<const float*>(scales),
                       static_cast<const float*>(bias),
                       static_cast<const int32_t*>(mask),
                       static_cast<float*>(out), K, B, Dk, C, bm,
                       static_cast<cudaStream_t>(stream));
}

int quorum_aggregate_i8(const void* portions, const void* weights,
                        const void* scales, const void* bias, const void* mask,
                        void* out, int K, int B, int Dk, int C, int bm,
                        void* stream) {
  return launch<int8_t>(static_cast<const float*>(portions),
                        static_cast<const int8_t*>(weights),
                        static_cast<const float*>(scales),
                        static_cast<const float*>(bias),
                        static_cast<const int32_t*>(mask),
                        static_cast<float*>(out), K, B, Dk, C, bm,
                        static_cast<cudaStream_t>(stream));
}

const char* quorum_aggregate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
