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
// Bound: memory. Per element the kernel does four flops against 4 or 8
// bytes of traffic (one read of x, one write of out), far below the card's
// flop-per-byte balance point, so the design is about keeping enough bytes
// in flight and moving each byte once:
//   * 16-byte accesses: a thread reads and writes V = 16 / sizeof(x)
//     elements at a time (8 bf16 or 4 fp32), NV accesses per row, all
//     issued before the first is used;
//   * the row stays in registers between the sum of squares and the
//     product: no shared-memory staging and no second read of x;
//   * ``warps`` warps share a row, chosen by the Python plan from D so a
//     thread holds at most 8 accesses (one warp up to D 2048 in bf16), or
//     16 elements where there are no more rows than SMs (a decode step's
//     few rows: there a thread's elements are a serial chain of squares
//     and products that no other warp hides); the sum of squares is a
//     warp-shuffle reduction, with one small shared exchange (and one
//     barrier) only where a row spans warps;
//   * a block holds ``rows_per_block`` rows and walks the row groups with a
//     grid-wide stride; each thread loads its share of the scale into
//     registers once, for every row it normalises.
// A row whose D is not a multiple of V, or a base pointer (x or scale) that
// is not 16-byte aligned, takes the scalar route (V = 1, up to 32 elements
// a thread): the same kernel body, chosen by the plan; nothing falls back to
// another implementation. The plan (V, NV, warps, rows per block, blocks)
// lives in Python (``rmsnorm.plan``); this file launches what it is given.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;

// bf16 travels as its 16 raw bits
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
  return __bfloat16_as_ushort(__float2bfloat16(v));   // round to nearest even
}

// V elements moved as one access (two for 32 bytes) when aligned to it
template <typename E, int V>
struct alignas(sizeof(E) * V > 16 ? 16 : sizeof(E) * V) Pack {
  E v[V];
};

template <typename T, typename S, int V, int NV>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, long long rows, int D, int warps,
               int rows_per_block, float eps) {
  __shared__ float part[2][kMaxWarps];     // per-warp sums, by parity

  const int tpr = warps * 32;              // threads per row
  const int t = threadIdx.x % tpr;         // this thread's place in its row
  const int slot = threadIdx.x / tpr;      // this thread's row in the block
  const int warp = threadIdx.x / 32;
  const int nvec = D / V;                  // V divides D (the plan's rule)

  Pack<S, V> sc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = i * tpr + t;
    if (vi < nvec)
      sc[i] = *reinterpret_cast<const Pack<S, V>*>(scale + (size_t)vi * V);
  }

  int parity = 0;
  // the trip count depends on blockIdx alone, so the barrier is uniform
  for (long long r0 = (long long)blockIdx.x * rows_per_block; r0 < rows;
       r0 += (long long)gridDim.x * rows_per_block) {
    const long long r = r0 + slot;
    const bool row = r < rows;
    const T* xr = x + r * D;
    Pack<T, V> v[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = i * tpr + t;
      if (row && vi < nvec)
        v[i] = *reinterpret_cast<const Pack<T, V>*>(xr + (size_t)vi * V);
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (row && i * tpr + t < nvec) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float e = to_f32(v[i].v[j]);
          ss += e * e;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (warps > 1) {                        // uniform across the block
      if (threadIdx.x % 32 == 0) part[parity][warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int w = 0; w < warps; ++w) ss += part[parity][slot * warps + w];
      parity ^= 1;                          // the next row group's buffer
    }
    if (!row) continue;
    const float inv = rsqrtf(ss / (float)D + eps);
    T* outr = out + r * D;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = i * tpr + t;
      if (vi < nvec) {
        Pack<T, V> o;
#pragma unroll
        for (int j = 0; j < V; ++j)
          o.v[j] = from_f32<T>(to_f32(v[i].v[j]) * inv * to_f32(sc[i].v[j]));
        *reinterpret_cast<Pack<T, V>*>(outr + (size_t)vi * V) = o;
      }
    }
  }
}

template <typename T, typename S, int V, int NV>
int launch_nv(const void* x, const void* scale, void* out, long long rows,
              int D, float eps, int warps, int rows_per_block, int blocks,
              cudaStream_t stream) {
  rmsnorm_kernel<T, S, V, NV><<<blocks, warps * 32 * rows_per_block, 0,
                                stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), rows, D, warps, rows_per_block, eps);
  return static_cast<int>(cudaGetLastError());
}

// the vector route: V = 16 bytes of x, NV in {1, 2, 4, 8}; the scalar
// route: V = 1, NV in {1, 2, 4, 8, 16, 32}
template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, long long rows,
           int D, float eps, int vec, int nv, int warps, int rows_per_block,
           int blocks, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (rows <= 0 || D <= 0) return 0;
  if (warps < 1 || rows_per_block < 1 || blocks < 1 ||
      warps * 32 * rows_per_block > kMaxThreads || vec < 1 ||
      D % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define RMS_ARGS x, scale, out, rows, D, eps, warps, rows_per_block, blocks, \
                 stream
  if (vec == kVec) {
    switch (nv) {
      case 1: return launch_nv<T, S, kVec, 1>(RMS_ARGS);
      case 2: return launch_nv<T, S, kVec, 2>(RMS_ARGS);
      case 4: return launch_nv<T, S, kVec, 4>(RMS_ARGS);
      case 8: return launch_nv<T, S, kVec, 8>(RMS_ARGS);
    }
  } else if (vec == 1) {
    switch (nv) {
      case 1: return launch_nv<T, S, 1, 1>(RMS_ARGS);
      case 2: return launch_nv<T, S, 1, 2>(RMS_ARGS);
      case 4: return launch_nv<T, S, 1, 4>(RMS_ARGS);
      case 8: return launch_nv<T, S, 1, 8>(RMS_ARGS);
      case 16: return launch_nv<T, S, 1, 16>(RMS_ARGS);
      case 32: return launch_nv<T, S, 1, 32>(RMS_ARGS);
    }
  }
#undef RMS_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches on ``stream`` and returns cudaGetLastError(). x and out are
// (rows, D) with rows D elements apart; scale is (D,). ``x_bf16`` /
// ``scale_bf16`` select bf16 (1) or fp32 (0) for each; out has x's type.
// ``vec``, ``nv``, ``warps``, ``rows_per_block`` and ``blocks`` are the
// Python plan's; a vector route needs x and scale 16-byte aligned.
int rmsnorm(const void* x, const void* scale, void* out, long long rows,
            int D, float eps, int x_bf16, int scale_bf16, int vec, int nv,
            int warps, int rows_per_block, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RMS_PLAN x, scale, out, rows, D, eps, vec, nv, warps, \
                 rows_per_block, blocks, s
  if (x_bf16) {
    return scale_bf16 ? launch<bf16_bits, bf16_bits>(RMS_PLAN)
                      : launch<bf16_bits, float>(RMS_PLAN);
  }
  return scale_bf16 ? launch<float, bf16_bits>(RMS_PLAN)
                    : launch<float, float>(RMS_PLAN);
#undef RMS_PLAN
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
