// Coded-share decode for Hopper (sm_90a): masked, decode-weighted gather
// over the share axis.
//
//     out (B, K, F)[b, k] = sum_r  mask[b, r] * dec[b, k, r] * share[b, r] * s_r
//
// Replaces repro/kernels/coded_decode.py:_decode_kernel (the Pallas TPU
// kernel). The TPU version runs a (batch tile, slot) grid and folds the
// (bb, R) weight row in VMEM. Here the work per row b is a tiny (K x R) by
// (R x F) product, so each block owns one row b and one tile of up to 128
// feature columns: it folds dec * mask * s into a (K, R) weight tile in
// shared memory, then each thread owns one column f and keeps the K sums in
// registers while it walks r ascending.
//
// Bound: memory. The work is 2*B*K*R_live*F flops against the arrived
// shares' payload (B*R_live*F*w bytes, w = 4 for fp32 shares, 1 for int8)
// plus dec, mask, scales and the (B, K, F) fp32 output, far below the card's
// flop-per-byte balance point. What the design does about it:
//   * a share whose mask is 0 is skipped by a branch that is uniform across
//     the block (one block serves one row), so its payload is never read -
//     the TPU kernel's saving for dead shares;
//   * each arrived share row is read once, coalesced along f, and feeds all
//     K outputs of that column from registers;
//   * int8 shares are read as int8 and scaled on the way in (s_r is folded
//     into the weight tile), so the fp32 path multiplies by s = 1 and both
//     share types run one body.
// No wgmma or TMA: at the serving shapes (R <= 8, K <= 5, F <= 64) one call
// moves well under a megabyte and launch latency dominates.
//
// A block serves ``rows`` = block_batch consecutive rows, ``lanes`` of them
// at a time (blockDim.y; each lane has its own weight tile); one row per
// block is the launch this kernel made before it took a tile. The rows a
// block owns never change the order of a row's sum, so every block_batch
// gives the same bits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 128;  // feature columns per block
constexpr int kKChunk = 16;       // sums held in registers per pass over r

// up to 512 threads (lanes x feature columns), at most 128 registers each
template <typename S>
__global__ void __launch_bounds__(512)
coded_decode_kernel(const S* __restrict__ shares,
                    const float* __restrict__ dec,
                    const int32_t* __restrict__ mask,
                    const float* __restrict__ scales, float* __restrict__ out,
                    int B, int R, int K, int F, int rows) {
  extern __shared__ float smem[];
  // this lane's (K, R) folded weights and (R,) mask row
  float* w = smem + (size_t)threadIdx.y * (K * R + R);
  int32_t* live = reinterpret_cast<int32_t*>(w + K * R);

  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  const int b_end = min(B, (blockIdx.x + 1) * rows);
  for (int b0 = blockIdx.x * rows; b0 < b_end; b0 += blockDim.y) {
    const int b = b0 + threadIdx.y;   // the pass count is uniform
    const bool row = b < b_end;       // across the block: sync is safe
    if (row) {
      const int32_t* mask_b = mask + (size_t)b * R;
      for (int r = threadIdx.x; r < R; r += blockDim.x) live[r] = mask_b[r];
    }
    __syncthreads();
    if (row) {
      const float* dec_b = dec + (size_t)b * K * R;
      for (int i = threadIdx.x; i < K * R; i += blockDim.x) {
        const int r = i % R;
        const float s = scales != nullptr ? scales[r] : 1.f;
        w[i] = dec_b[i] * static_cast<float>(live[r]) * s;
      }
    }
    __syncthreads();
    if (row) {
      const S* sh_b = shares + (size_t)b * R * F;
      float* out_b = out + (size_t)b * K * F;
      for (int k0 = 0; k0 < K; k0 += kKChunk) {
        float acc[kKChunk];
#pragma unroll
        for (int j = 0; j < kKChunk; ++j) acc[j] = 0.f;
        for (int r = 0; r < R; ++r) {
          if (live[r] == 0) continue;  // uniform: a dead share reads nothing
          const float x =
              f < F ? static_cast<float>(sh_b[(size_t)r * F + f]) : 0.f;
#pragma unroll
          for (int j = 0; j < kKChunk; ++j)
            if (k0 + j < K) acc[j] += w[(k0 + j) * R + r] * x;
        }
        if (f < F) {
#pragma unroll
          for (int j = 0; j < kKChunk; ++j)
            if (k0 + j < K) out_b[(size_t)(k0 + j) * F + f] = acc[j];
        }
      }
    }
    __syncthreads();                  // the next pass rewrites w and live
  }
}

template <typename S>
int launch(const S* shares, const float* dec, const int32_t* mask,
           const float* scales, float* out, int B, int R, int K, int F,
           int rows, int lanes, cudaStream_t stream) {
  if (B <= 0 || K <= 0 || F <= 0) return 0;
  const int threads = F >= kMaxThreads ? kMaxThreads : ((F + 31) / 32) * 32;
  if (rows < 1 || lanes < 1 || lanes > rows || threads * lanes > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + rows - 1) / rows, (F + threads - 1) / threads);
  const size_t smem = (size_t)lanes * ((size_t)K * R * sizeof(float) +
                                       (size_t)R * sizeof(int32_t));
  coded_decode_kernel<S><<<grid, dim3(threads, lanes), smem, stream>>>(
      shares, dec, mask, scales, out, B, R, K, F, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on ``stream`` and returns cudaGetLastError().
// ``scales`` may be null on the fp32 path (scale 1); the int8 path needs it.
// ``rows`` batch rows per block, ``lanes`` (<= rows) of them at a time.
// ``lanes`` (K, R) weight tiles and mask rows must fit 48 KB of shared
// memory; the Python wrapper checks that before it calls.
int coded_decode_f32(const void* shares, const void* dec, const void* mask,
                     const void* scales, void* out, int B, int R, int K,
                     int F, int rows, int lanes, void* stream) {
  return launch<float>(static_cast<const float*>(shares),
                       static_cast<const float*>(dec),
                       static_cast<const int32_t*>(mask),
                       static_cast<const float*>(scales),
                       static_cast<float*>(out), B, R, K, F, rows, lanes,
                       static_cast<cudaStream_t>(stream));
}

int coded_decode_i8(const void* shares, const void* dec, const void* mask,
                    const void* scales, void* out, int B, int R, int K, int F,
                    int rows, int lanes, void* stream) {
  return launch<int8_t>(static_cast<const int8_t*>(shares),
                        static_cast<const float*>(dec),
                        static_cast<const int32_t*>(mask),
                        static_cast<const float*>(scales),
                        static_cast<float*>(out), B, R, K, F, rows, lanes,
                        static_cast<cudaStream_t>(stream));
}

const char* coded_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
