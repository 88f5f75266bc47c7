// Fused RMSNorm for Hopper (sm_90a):
//
//     out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * scale
//
// with the sum of squares and the product in fp32, for fp32 or bf16 x and
// scale (each independently), the output in x's type.
//
// Replaces repro/kernels/rmsnorm.py:_rmsnorm_kernel (the Pallas TPU
// kernel), which normalises a (256, D) block of rows per grid step in VMEM.
//
// Bound: memory. Per element the kernel does three flops against 4 or 8
// bytes of traffic (one read of x, one write of out), far below the card's
// flop-per-byte balance point. What the design does about it:
//   * one block per row; the row is read from device memory once, as fp32
//     into shared memory (D * 4 bytes, 24 KB at the registry's largest
//     D = 6144), and the normalised row is written from there, so every
//     element is read once and written once (the unfused lowering reads x
//     three times);
//   * the sum of squares is reduced in fp32 by warp shuffles, then across
//     the block's warps through shared memory;
//   * consecutive threads touch consecutive elements, so reads and writes
//     are coalesced; any D works (no vector-width assumption).
// Rows are independent, so the grid is one block per row and fills the card
// at the serving shapes (2048 rows per prefill of 4 x 512 tokens).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int D, float eps) {
  extern __shared__ float row[];                 // (D,) fp32
  __shared__ float warp_sums[kThreads / 32];

  const size_t r = blockIdx.x;
  const T* xr = x + r * (size_t)D;
  T* outr = out + r * (size_t)D;

  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = to_f32(xr[i]);
    row[i] = v;
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  const float inv = rsqrtf(total / (float)D + eps);

  for (int i = threadIdx.x; i < D; i += kThreads)
    outr[i] = from_f32<T>(row[i] * inv * to_f32(scale[i]));
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, int rows, int D,
           float eps, cudaStream_t stream) {
  if (rows <= 0 || D <= 0) return 0;
  const size_t smem = (size_t)D * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rmsnorm_kernel<T, S><<<rows, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on ``stream`` and returns cudaGetLastError(). x and out are
// (rows, D) contiguous; scale is (D,). ``x_bf16`` / ``scale_bf16`` select
// bf16 (1) or fp32 (0) for each; out has x's type.
int rmsnorm(const void* x, const void* scale, void* out, int rows, int D,
            float eps, int x_bf16, int scale_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return scale_bf16
               ? launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, D,
                                                      eps, s)
               : launch<__nv_bfloat16, float>(x, scale, out, rows, D, eps, s);
  }
  return scale_bf16
             ? launch<float, __nv_bfloat16>(x, scale, out, rows, D, eps, s)
             : launch<float, float>(x, scale, out, rows, D, eps, s);
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
