// Coded shard matmul for Hopper (sm_90a): every compute shard's partial
// product in one launch.
//
//     out (n, B, w)[i] = x (B, D) @ shards (n, D, w)[i]
//
// Replaces repro/kernels/coded_matmul.py:_shard_kernel (the Pallas TPU
// kernel). The TPU version runs a (shard, batch tile) grid with the whole
// reduction dim D and the shard's (D, w) weight in VMEM, one MXU product per
// step. Here the grid is (row tile, column tile, shard): a block of 64
// threads (8 x 8) owns one (8*TM x 32) tile of one shard's output and walks
// D in kTD-deep slices; each thread keeps TM x 4 sums in registers (rows
// ty, ty + 8, ...; four neighbouring columns). Every output's sum over D
// runs d = 0, 1, ..., D-1 in one thread (fmaf), in fp32, so a systematic
// shard's output is the same for any B tiling or plan.
//
// Bound: fp32 operations at a wide layer (2*n*B*D*w flops; 12.5 us at
// 67 TFLOP/s for (8, 5) over a (1024, 1000) layer and B 256, whose bytes
// take 2.8 us), launch latency and one memory round trip at the serving
// shape ((5, 3), D 64). The operands stay fp32 on the CUDA cores: keeping
// fp32 accuracy on the tensor cores would take about six bf16 cross
// products, and any truncation in their accumulation is multiplied by the
// decode gain (up to 330 for (8, 5)) in the compute-coding round trip.
// What the design does:
//   * the x and shard tiles of the next slice are in flight by cp.async
//     (16 bytes where the rows allow it, D % 4 == 0 for x and w % 4 == 0 for
//     the shards; 4 bytes otherwise) into the other of two shared buffers
//     while this slice's FMAs run; rows past B, D or w are zero-filled;
//   * shared memory is read as float4: per 4 d, TM loads of x (padded rows,
//     the four rows of a warp on distinct banks) and 4 of the shard (8
//     lanes cover one 128-byte row), 16 * TM FMAs;
//   * 64-deep slices: a barrier pair per 64 d (32-deep slices were
//     slower at both timed shapes, 128-deep ones too);
//   * the plan (coded_matmul.py:plan) takes 8 x 4 outputs a thread where
//     that still gives every SM two blocks (a warp for each of its four
//     schedulers), else 4 x 4 or 2 x 4: (8, 5) at B 256 runs 448 blocks
//     of 4 x 4, (5, 3) 160 of 2 x 4.
//   Tried and not faster on the card (PERF.md): 3 to 8 stages of 16- or
//   32-deep slices, 128- and 256-deep slices, a partly unrolled slice,
//   64 x 64 tiles of 128 threads (128 blocks, under a wave at (8, 5)), and
//   the n shards tiled as one (D, n*w) matrix (the shard and column of
//   every staged element cost an integer division).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;           // 8 x 8
constexpr int kStages = 2;             // slices in flight
constexpr int kTD = 64;                // depth of one D slice
constexpr int kTN = 4;                 // columns a thread
constexpr int kXStride = kTD + 4;      // fp32 row of a staged x slice
constexpr int kBN = 8 * kTN;           // columns of a block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 or 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
coded_matmul_kernel(const float* __restrict__ x,
                    const float* __restrict__ shards, float* __restrict__ out,
                    int B, int D, int W) {
  constexpr int BM = 8 * TM;
  extern __shared__ __align__(16) float smem[];
  auto xs = reinterpret_cast<float (*)[BM][kXStride]>(smem);
  auto ws = reinterpret_cast<float (*)[kTD][kBN + 4]>(
      smem + kStages * BM * kXStride);
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int r0 = blockIdx.x * BM, c0 = blockIdx.y * kBN;
  const float* sh = shards + (size_t)blockIdx.z * D * W;
  float* o = out + (size_t)blockIdx.z * B * W;
  const bool xvec = D % 4 == 0, wvec = W % 4 == 0;

  auto load = [&](int sl, int buf) {
    const int d0 = sl * kTD;
    if (xvec) {
      for (int c = tid; c < BM * (kTD / 4); c += kThreads) {
        const int r = c / (kTD / 4), d = 4 * (c % (kTD / 4));
        const int gr = r0 + r, gd = d0 + d;
        const bool ok = gr < B && gd < D;
        cp_async16(&xs[buf][r][d], ok ? x + (size_t)gr * D + gd : x, ok);
      }
    } else {
      for (int c = tid; c < BM * kTD; c += kThreads) {
        const int r = c / kTD, d = c % kTD;
        const int gr = r0 + r, gd = d0 + d;
        const bool ok = gr < B && gd < D;
        cp_async4(&xs[buf][r][d], ok ? x + (size_t)gr * D + gd : x, ok);
      }
    }
    if (wvec) {
      for (int c = tid; c < kTD * (kBN / 4); c += kThreads) {
        const int d = c / (kBN / 4), col = 4 * (c % (kBN / 4));
        const int gd = d0 + d, gc = c0 + col;
        const bool ok = gd < D && gc < W;
        cp_async16(&ws[buf][d][col], ok ? sh + (size_t)gd * W + gc : sh, ok);
      }
    } else {
      for (int c = tid; c < kTD * kBN; c += kThreads) {
        const int d = c / kBN, col = c % kBN;
        const int gd = d0 + d, gc = c0 + col;
        const bool ok = gd < D && gc < W;
        cp_async4(&ws[buf][d][col], ok ? sh + (size_t)gd * W + gc : sh, ok);
      }
    }
  };

  float acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int slices = (D + kTD - 1) / kTD;
#pragma unroll
  for (int sl = 0; sl < kStages - 1; ++sl) {
    if (sl < slices) load(sl, sl);
    cp_async_commit();
  }
  for (int sl = 0; sl < slices; ++sl) {
    const int buf = sl % kStages;
    if (sl + kStages - 1 < slices)
      load(sl + kStages - 1, (sl + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
#pragma unroll
    for (int d4 = 0; d4 < kTD; d4 += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(&xs[buf][ty + 8 * i][d4]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 b =
            *reinterpret_cast<const float4*>(&ws[buf][d4 + e][kTN * tx]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = e == 0 ? a[i].x : e == 1 ? a[i].y
                         : e == 2 ? a[i].z : a[i].w;
          acc[i][0] = fmaf(av, b.x, acc[i][0]);
          acc[i][1] = fmaf(av, b.y, acc[i][1]);
          acc[i][2] = fmaf(av, b.z, acc[i][2]);
          acc[i][3] = fmaf(av, b.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }

  const int gc = c0 + kTN * tx;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = r0 + ty + 8 * i;
    if (gr >= B) continue;
    float* row = o + (size_t)gr * W;
    if (wvec && gc + kTN <= W) {
      *reinterpret_cast<float4*>(row + gc) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (gc + j < W) row[gc + j] = acc[i][j];
    }
  }
}

template <int TM>
int launch(const float* x, const float* shards, float* out, int n, int B,
           int D, int W, cudaStream_t s) {
  constexpr int smem =
      kStages * (8 * TM * kXStride + kTD * (kBN + 4)) * sizeof(float);
  auto kernel = coded_matmul_kernel<TM>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((B + 8 * TM - 1) / (8 * TM), (W + kBN - 1) / kBN, n);
  kernel<<<grid, kThreads, smem, s>>>(x, shards, out, B, D, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on ``stream`` and returns cudaGetLastError(). ``n`` shards of
// (D, W) fp32 weights; x (B, D) and out (n, B, W) fp32, all contiguous on
// 16-byte bases; ``plan`` 0, 1 or 2 takes 8, 4 or 2 rows of 4 outputs a
// thread (coded_matmul.py:PLANS).
int coded_matmul_f32(const void* x, const void* shards, void* out, int n,
                     int B, int D, int W, int plan, void* stream) {
  if (n <= 0 || B <= 0 || W <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto sp = static_cast<const float*>(shards);
  auto op = static_cast<float*>(out);
  switch (plan) {
    case 0: return launch<8>(xp, sp, op, n, B, D, W, s);
    case 1: return launch<4>(xp, sp, op, n, B, D, W, s);
    case 2: return launch<2>(xp, sp, op, n, B, D, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* coded_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
