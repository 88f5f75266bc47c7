// RMSNorm backward for Hopper (sm_90a). With r = rsqrt(mean(x^2) + eps),
// x^ = x * r and gs = g * scale, for each row of x and of the upstream
// gradient g:
//
//     dx[r, :]  = r * (gs - x^ * mean(gs * x^))
//     dscale[:] = sum over rows of g * x^
//
// fp32 inside, for fp32 or bf16 x and g (one type) and fp32 or bf16 scale;
// dx comes out in x's type and dscale in scale's.
//
// Replaces no TPU kernel: the JAX package trains through the plain
// rmsnorm_apply (repro/models/layers.py) under jax.value_and_grad and has
// no custom_vjp, so there is no backward kernel to carry over. The port's
// forward runs the hand-written rmsnorm kernel (csrc/rmsnorm.cu), whose
// output autograd cannot differentiate, so training needs this one.
//
// Bound: memory. Per element it reads x and g and writes dx (6 or 12
// bytes) for about ten flops. The design follows the forward's:
//   * a row is spread over ``warps`` warps of one block, each thread holding
//     NV accesses of V = 16 bytes (or V = 1 on the scalar route, for ragged
//     D or unaligned bases) of x and of g in registers, all loads issued
//     before the first is used; sum(x^2) and sum(gs * x) are reduced
//     together (warp shuffles, then one shared exchange where a row spans
//     warps), and dx = r * gs - x * r^3 * sum(gs * x) / D is written from
//     the same registers: x and g are read once;
//   * a block walks rows with a grid stride; every row it takes puts its
//     g * x^ into per-thread fp32 sums for the same columns, so dscale
//     needs no atomics: each block writes its column sums to a row of a
//     (blocks, D) fp32 scratch, and a second launch sums that scratch down
//     the blocks in a fixed order (eight fixed ranges, then the eight in
//     order). Two runs give the same bits. Every sum down the rows is
//     compensated (Kahan): dscale adds thousands of rows' terms that may
//     cancel, and a plain fp32 running sum would lose more than the
//     bound of 3e-5 there.
// The plan (V, NV, warps, blocks) lives in Python (``rmsnorm.bwd_plan``).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kReduceCols = 32;          // dscale columns a reduce block owns
constexpr int kReduceGroups = 8;         // block ranges it sums in parallel

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

// s += v with the lost low part carried in c (no fast-math: nvcc keeps
// the order)
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = v - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

template <typename E, int V>
struct alignas(sizeof(E) * V > 16 ? 16 : sizeof(E) * V) Pack {
  E v[V];
};

template <typename T, typename S, int V, int NV>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ partial, long long rows, int D,
                   float eps) {
  __shared__ float red[2][2][kMaxWarps];   // per-warp sums, by parity

  const int tpr = blockDim.x;
  const int t = threadIdx.x;
  const int warp = t / 32, warps = tpr / 32;
  const int nvec = D / V;

  float sc[NV][V];
  float ds[NV][V], dc[NV][V];              // Kahan sums and compensations
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = i * tpr + t;
    Pack<S, V> s{};
    if (vi < nvec)
      s = *reinterpret_cast<const Pack<S, V>*>(scale + (size_t)vi * V);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sc[i][j] = to_f32(s.v[j]);
      ds[i][j] = 0.f;
      dc[i][j] = 0.f;
    }
  }

  int parity = 0;
  // the trip count depends on blockIdx alone, so the barrier is uniform
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* xr = x + r * D;
    const T* gr = g + r * D;
    Pack<T, V> xv[NV], gv[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = i * tpr + t;
      if (vi < nvec) {
        xv[i] = *reinterpret_cast<const Pack<T, V>*>(xr + (size_t)vi * V);
        gv[i] = *reinterpret_cast<const Pack<T, V>*>(gr + (size_t)vi * V);
      }
    }
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * tpr + t < nvec) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xe = to_f32(xv[i].v[j]);
          ss += xe * xe;
          sg += to_f32(gv[i].v[j]) * sc[i][j] * xe;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sg += __shfl_xor_sync(0xffffffffu, sg, off);
    }
    if (warps > 1) {                        // uniform across the block
      if (t % 32 == 0) {
        red[parity][0][warp] = ss;
        red[parity][1][warp] = sg;
      }
      __syncthreads();
      ss = 0.f;
      sg = 0.f;
      for (int w = 0; w < warps; ++w) {
        ss += red[parity][0][w];
        sg += red[parity][1][w];
      }
      parity ^= 1;                          // the next row's buffer
    }
    const float inv = rsqrtf(ss / (float)D + eps);
    const float c = inv * inv * inv * sg / (float)D;
    T* dxr = dx + r * D;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = i * tpr + t;
      if (vi < nvec) {
        Pack<T, V> o;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xe = to_f32(xv[i].v[j]);
          const float ge = to_f32(gv[i].v[j]);
          o.v[j] = from_f32<T>(inv * ge * sc[i][j] - xe * c);
          kahan_add(ds[i][j], dc[i][j], ge * (xe * inv));
        }
        *reinterpret_cast<Pack<T, V>*>(dxr + (size_t)vi * V) = o;
      }
    }
  }
  float* pr = partial + (size_t)blockIdx.x * D;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = i * tpr + t;
    if (vi < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) pr[(size_t)vi * V + j] = ds[i][j];
    }
  }
}

// dscale[c] = sum over the ``parts`` rows of partial[:, c], in a fixed
// order: group k of a block sums its contiguous range of rows in order,
// then thread group 0 adds the groups' sums in order.
template <typename S>
__global__ void __launch_bounds__(kReduceCols * kReduceGroups)
rmsnorm_dscale_kernel(const float* __restrict__ partial, S* __restrict__ dscale,
                      int parts, int D) {
  __shared__ float sums[kReduceGroups][kReduceCols];
  const int lane = threadIdx.x % kReduceCols;
  const int grp = threadIdx.x / kReduceCols;
  const int c = blockIdx.x * kReduceCols + lane;
  const int per = (parts + kReduceGroups - 1) / kReduceGroups;
  const int b0 = grp * per;
  const int b1 = min(parts, b0 + per);
  float s = 0.f, comp = 0.f;
  if (c < D)
    for (int b = b0; b < b1; ++b)
      kahan_add(s, comp, partial[(size_t)b * D + c]);
  sums[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && c < D) {
    float total = 0.f;
    comp = 0.f;
#pragma unroll
    for (int k = 0; k < kReduceGroups; ++k)
      kahan_add(total, comp, sums[k][lane]);
    dscale[c] = from_f32<S>(total);
  }
}

template <typename T, typename S, int V, int NV>
int launch_nv(const void* x, const void* scale, const void* g, void* dx,
              void* dscale, float* partial, long long rows, int D, float eps,
              int warps, int blocks, cudaStream_t stream) {
  rmsnorm_bwd_kernel<T, S, V, NV><<<blocks, warps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<const T*>(g), static_cast<T*>(dx), partial, rows, D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (D + kReduceCols - 1) / kReduceCols;
  rmsnorm_dscale_kernel<S><<<grid, kReduceCols * kReduceGroups, 0, stream>>>(
      partial, static_cast<S*>(dscale), blocks, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int launch(const void* x, const void* scale, const void* g, void* dx,
           void* dscale, float* partial, long long rows, int D, float eps,
           int vec, int nv, int warps, int blocks, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (rows <= 0 || D <= 0) return 0;
  if (warps < 1 || warps > kMaxWarps || blocks < 1 || vec < 1 ||
      D % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define RMS_ARGS x, scale, g, dx, dscale, partial, rows, D, eps, warps, \
                 blocks, stream
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

// Launches both kernels on ``stream`` and returns cudaGetLastError(). x, g
// and dx are (rows, D), contiguous; scale and dscale are (D,); ``partial``
// is fp32 scratch of ``blocks`` x D. ``x_bf16`` / ``scale_bf16`` select
// bf16 (1) or fp32 (0); g and dx have x's type, dscale scale's. ``vec``,
// ``nv``, ``warps`` and ``blocks`` are the Python plan's; a vector route
// needs x, g, dx and scale 16-byte aligned.
int rmsnorm_bwd(const void* x, const void* scale, const void* g, void* dx,
                void* dscale, void* partial, long long rows, int D, float eps,
                int x_bf16, int scale_bf16, int vec, int nv, int warps,
                int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
#define RMS_PLAN x, scale, g, dx, dscale, p, rows, D, eps, vec, nv, warps, \
                 blocks, s
  if (x_bf16) {
    return scale_bf16 ? launch<bf16_bits, bf16_bits>(RMS_PLAN)
                      : launch<bf16_bits, float>(RMS_PLAN);
  }
  return scale_bf16 ? launch<float, bf16_bits>(RMS_PLAN)
                    : launch<float, float>(RMS_PLAN);
#undef RMS_PLAN
}

const char* rmsnorm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
