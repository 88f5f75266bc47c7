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
//   * a row is spread over ``warps`` warps, each thread holding NV
//     accesses of V = 16 bytes (or V = 1 on the scalar route, for ragged
//     D or unaligned bases) of x and of g in registers; sum(x^2) and
//     sum(gs * x) are reduced together (warp shuffles, then one shared
//     exchange behind a barrier of the row's own warps where a row spans
//     several), and dx = r * gs - x * r^3 * sum(gs * x) / D is written from
//     the same registers: x and g are read once. The plan keeps a thread
//     at two accesses, so a row spans as few warps as it can: that
//     exchange set the pace (on an H100 at 2048 x 2048 bf16 the row kernel
//     took 14.2 us over 8 warps a row, 10.4 with the exchange left out,
//     11.2 over 4 warps);
//   * a block of 512 threads is ``groups`` such row groups; the grid is
//     one wave (a block an SM), and each group walks its rows with a
//     grid-wide stride, a row loaded, reduced and written at a time (a
//     second row in flight, loaded through volatile asm, came within 0.5 us
//     of this loop's 11 on an H100 at 2048 x 2048 bf16: not worth a second
//     path);
//   * every row a thread takes puts its g * x^ into per-thread compensated
//     (Kahan) fp32 sums for the same columns, so dscale needs no atomics:
//     the groups of a block fold their sums into group 0's in order, the
//     block writes one row of a (blocks, D) fp32 scratch, and a second
//     launch, spread over the card (16 columns x 32 ranges of the scratch
//     rows a block), sums it down the blocks in a fixed order (each range
//     in order, then the ranges in order). Two runs give the same bits.
//     Every sum down the rows is compensated: dscale adds thousands of
//     rows' terms that may cancel, and a plain fp32 running sum would lose
//     more than the bound of 3e-5 there. The column sum is a programmatic
//     dependent launch: its blocks are scheduled as the row kernel's
//     finish and wait for its writes, so no launch gap separates the two
//     (about 1 us of the call's 15 on an H100).
//   The first design (a profile of its two launches apart on an H100,
//   2048 x 2048 bf16): 528 blocks of 4 rows, 8 warps a row (15.1 us
//   against 7.5), a 4.3 MB scratch, and a column sum of 64 blocks, each
//   thread a chain of 66 dependent adds (5.8 us).
// The plan (V, NV, warps, groups, blocks) lives in Python
// (``rmsnorm.bwd_plan``), which also passes the column sum's ranges
// (``rmsnorm.BWD_REDUCE_RANGES``, checked against the 32 built here).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;         // a block: groups x warps x 32
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kFold = 4096;              // columns a group folds
constexpr int kReduceCols = 16;          // dscale columns a reduce block owns
constexpr int kRanges = 32;              // scratch-row ranges it sums

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
// the order); s - c is the compensated sum
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
__global__ void __launch_bounds__(kMaxThreads, 1)
rmsnorm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ partial, long long rows, int D,
                   float eps, int warps) {
  __shared__ float red[2][2][kMaxWarps];   // per-warp sums, by parity
  __shared__ float fold[kFold];            // a group's column sums

  const int tpr = warps * 32;
  const int groups = blockDim.x / tpr;
  const int grp = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int warp = threadIdx.x / 32;       // within the block
  const int nvec = D / V;
  // the group's rows: r0, r0 + stride, ...
  const long long stride = (long long)gridDim.x * groups;
  const long long r0 = (long long)blockIdx.x * groups + grp;
  const long long mine = rows > r0 ? (rows - r0 + stride - 1) / stride : 0;

  using Row = Pack<T, V>[NV];
  auto load = [&](long long n, Row& xv, Row& gv) {
    const T* xr = x + (r0 + n * stride) * D;
    const T* gr = g + (r0 + n * stride) * D;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = i * tpr + t;
      if (vi < nvec) {
        xv[i] = *reinterpret_cast<const Pack<T, V>*>(xr + (size_t)vi * V);
        gv[i] = *reinterpret_cast<const Pack<T, V>*>(gr + (size_t)vi * V);
      }
    }
  };
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
  // the group's row n from its registers: dx written, g * x^ into the sums
  auto row = [&](long long n, const Row& xv, const Row& gv) {
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
    if (warps > 1) {                        // uniform across the group
      if (threadIdx.x % 32 == 0) {
        red[parity][0][warp] = ss;
        red[parity][1][warp] = sg;
      }
      // a barrier of the group's warps alone (id 1 + grp; 0 is the block's)
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(tpr) : "memory");
      ss = 0.f;
      sg = 0.f;
      for (int w = grp * warps; w < (grp + 1) * warps; ++w) {
        ss += red[parity][0][w];
        sg += red[parity][1][w];
      }
      parity ^= 1;                          // the next row's buffer
    }
    const float inv = rsqrtf(ss / (float)D + eps);
    const float c = inv * inv * inv * sg / (float)D;
    T* dxr = dx + (r0 + n * stride) * D;
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
  };

  // the trip count is the group's alone, so its barrier is uniform
  for (long long n = 0; n < mine; ++n) {
    Row xv, gv;
    load(n, xv, gv);
    row(n, xv, gv);
  }

  // groups 1, 2, ... fold their compensated sums into group 0's, in order
  // (the plan gives a block several groups only where a group's columns
  // fit ``fold``)
  for (int k = 1; k < groups; ++k) {
    __syncthreads();
    if (grp == k) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vi = i * tpr + t;
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (vi < nvec) fold[vi * V + j] = ds[i][j] - dc[i][j];
      }
    }
    __syncthreads();
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vi = i * tpr + t;
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (vi < nvec) kahan_add(ds[i][j], dc[i][j], fold[vi * V + j]);
      }
    }
  }
  // the column sum may be scheduled now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (grp != 0) return;
  float* pr = partial + (size_t)blockIdx.x * D;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = i * tpr + t;
    if (vi < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) pr[(size_t)vi * V + j] = ds[i][j] - dc[i][j];
    }
  }
}

// dscale[c] = sum over the ``parts`` rows of partial[:, c], in a fixed
// order: range k of a block (rows k * per .. (k + 1) * per, a few at one
// SM a block) summed in order, four rows' loads in flight at a time, then
// range 0's thread adds the ranges' sums in order.
template <typename S>
__global__ void __launch_bounds__(kReduceCols * kRanges)
rmsnorm_dscale_kernel(const float* __restrict__ partial, S* __restrict__ dscale,
                      int parts, int D) {
  __shared__ float sums[kRanges][kReduceCols];
  // launched early (programmatic dependent launch): every write of the row
  // kernel before it is visible past this wait
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lane = threadIdx.x % kReduceCols;
  const int grp = threadIdx.x / kReduceCols;
  const int c = blockIdx.x * kReduceCols + lane;
  const int per = (parts + kRanges - 1) / kRanges;
  const int b0 = min(parts, grp * per);
  const int b1 = min(parts, b0 + per);
  float s = 0.f, comp = 0.f;
  if (c < D) {
    int b = b0;
    for (; b + 4 <= b1; b += 4) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = partial[(size_t)(b + u) * D + c];
#pragma unroll
      for (int u = 0; u < 4; ++u) kahan_add(s, comp, v[u]);
    }
    for (; b < b1; ++b) kahan_add(s, comp, partial[(size_t)b * D + c]);
  }
  sums[grp][lane] = s - comp;
  __syncthreads();
  if (grp == 0 && c < D) {
    float total = 0.f;
    comp = 0.f;
#pragma unroll
    for (int k = 0; k < kRanges; ++k) kahan_add(total, comp, sums[k][lane]);
    dscale[c] = from_f32<S>(total - comp);
  }
}

template <typename T, typename S, int V, int NV>
int launch_nv(const void* x, const void* scale, const void* g, void* dx,
              void* dscale, float* partial, long long rows, int D, float eps,
              int warps, int groups, int blocks, cudaStream_t stream) {
  if (groups > 1 && warps * 32 * NV * V > kFold)
    return static_cast<int>(cudaErrorInvalidValue);
  rmsnorm_bwd_kernel<T, S, V, NV><<<blocks, groups * warps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<const T*>(g), static_cast<T*>(dx), partial, rows, D, eps,
      warps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the column sum as a programmatic dependent launch: its blocks take the
  // SMs the row kernel frees without a launch gap between the two
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D + kReduceCols - 1) / kReduceCols);
  cfg.blockDim = dim3(kReduceCols * kRanges);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, rmsnorm_dscale_kernel<S>, static_cast<const float*>(partial),
      static_cast<S*>(dscale), blocks, D));
}

template <typename T, typename S>
int launch(const void* x, const void* scale, const void* g, void* dx,
           void* dscale, float* partial, long long rows, int D, float eps,
           int vec, int nv, int warps, int groups, int blocks, int ranges,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (rows <= 0 || D <= 0) return 0;
  if (warps < 1 || groups < 1 || groups * warps > kMaxWarps || blocks < 1 ||
      ranges != kRanges || vec < 1 || D % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define RMS_ARGS x, scale, g, dx, dscale, partial, rows, D, eps, warps, \
                 groups, blocks, stream
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
// is fp32 scratch of ``blocks`` x D (a row a block: its groups' folded
// column sums). ``x_bf16`` / ``scale_bf16`` select
// bf16 (1) or fp32 (0); g and dx have x's type, dscale scale's. ``vec``,
// ``nv``, ``warps``, ``groups`` (row groups a block, groups * warps <= 16)
// and ``blocks`` are the Python plan's; ``ranges``, the column sum's ranges
// (``rmsnorm.BWD_REDUCE_RANGES``), must be the 32 this kernel is built for;
// a vector route needs x, g, dx and scale 16-byte aligned.
int rmsnorm_bwd(const void* x, const void* scale, const void* g, void* dx,
                void* dscale, void* partial, long long rows, int D, float eps,
                int x_bf16, int scale_bf16, int vec, int nv, int warps,
                int groups, int blocks, int ranges, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
#define RMS_PLAN x, scale, g, dx, dscale, p, rows, D, eps, vec, nv, warps, \
                 groups, blocks, ranges, s
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
