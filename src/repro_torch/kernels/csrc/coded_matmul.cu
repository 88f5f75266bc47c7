// Coded shard matmul for Hopper (sm_90a): every compute shard's partial
// product in one launch.
//
//     out (n, B, w)[i] = x (B, D) @ shards (n, D, w)[i]
//
// Replaces repro/kernels/coded_matmul.py:_shard_kernel (the Pallas TPU
// kernel). The TPU version runs a (shard, batch tile) grid with the whole
// reduction dim D and the shard's (D, w) weight in VMEM, one MXU product per
// step. Here the grid is (row tile, column tile, shard): a block owns one
// (kBM x kBN) tile of one shard's output, stages x rows and shard columns
// through shared memory in kTD-deep slices of D, and each of its 256 threads
// keeps a kTM x kTN block of sums in registers. Every output's sum over D
// runs d = 0, 1, ..., D-1 in one thread (fmaf), in fp32, so a systematic
// shard's output is the same for any B tiling.
//
// Bound: bytes at the serving shapes (x and the n shards read once, n*B*w
// outputs written; 2*n*B*D*w flops, tens of flops per byte), operations at
// a wide layer over a large batch. What the design does: x is read once per
// (row tile, column tile, shard) from device memory and the slices are
// reused kTM / kTN times from shared memory. No wgmma: fp32 operands, and
// the first Hopper version of this kernel is the simple one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64, kBN = 64;  // output tile of one block
constexpr int kTM = 4, kTN = 4;    // outputs per thread
constexpr int kTD = 16;            // depth of one staged D slice
constexpr int kThreadsX = kBN / kTN, kThreadsY = kBM / kTM;  // 16 x 16

__global__ void coded_matmul_kernel(const float* __restrict__ x,
                                    const float* __restrict__ shards,
                                    float* __restrict__ out, int B, int D,
                                    int W) {
  __shared__ float xs[kBM][kTD + 1];
  __shared__ float ws[kTD][kBN];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int r0 = blockIdx.x * kBM, c0 = blockIdx.y * kBN;
  const float* sh = shards + (size_t)blockIdx.z * D * W;
  float* o = out + (size_t)blockIdx.z * B * W;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kTD) {
    for (int i = tid; i < kBM * kTD; i += kThreadsX * kThreadsY) {
      const int r = i / kTD, d = i % kTD;
      const int gr = r0 + r, gd = d0 + d;
      xs[r][d] = (gr < B && gd < D) ? x[(size_t)gr * D + gd] : 0.f;
    }
    for (int i = tid; i < kTD * kBN; i += kThreadsX * kThreadsY) {
      const int d = i / kBN, c = i % kBN;
      const int gd = d0 + d, gc = c0 + c;
      ws[d][c] = (gd < D && gc < W) ? sh[(size_t)gd * W + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < kTD; ++d) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[ty + i * kThreadsY][d];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[d][tx + j * kThreadsX];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gr = r0 + ty + i * kThreadsY;
    if (gr >= B) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gc = c0 + tx + j * kThreadsX;
      if (gc < W) o[(size_t)gr * W + gc] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Launches on ``stream`` and returns cudaGetLastError(). ``n`` shards of
// (D, W) fp32 weights; x (B, D) and out (n, B, W) fp32, all contiguous.
int coded_matmul_f32(const void* x, const void* shards, void* out, int n,
                     int B, int D, int W, void* stream) {
  if (n <= 0 || B <= 0 || W <= 0) return 0;
  const dim3 grid((B + kBM - 1) / kBM, (W + kBN - 1) / kBN, n);
  const dim3 threads(kThreadsX, kThreadsY);
  coded_matmul_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(shards),
      static_cast<float*>(out), B, D, W);
  return static_cast<int>(cudaGetLastError());
}

const char* coded_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
