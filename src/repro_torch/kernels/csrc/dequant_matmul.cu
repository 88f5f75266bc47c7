// Weight-dequant matmul for Hopper (sm_90a): int8 weights, fp32 activations.
//
//     y (B, N) = x (B, D) @ (q (D, N) * scale),  scale () or (N,)
//
// Replaces repro/kernels/dequant_matmul.py:_dqmm_kernel (the Pallas TPU
// kernel). The TPU version gives a grid step a (bb rows x bn columns) output
// tile with the whole reduction dim D in VMEM and lets the MXU do the
// product. Here each block owns one (bb x bn) output tile too, but D is cut
// into kTD-deep slices staged through shared memory: the x rows as fp32,
// the q columns read from device memory as int8 and expanded to fp32
// (q * scale) on their way in, so only the int8 weight bytes cross device
// memory - the point of the TPU kernel. The weight is expanded BEFORE the
// product, as the TPU kernel and the plain version do; the finished dot is
// not scaled.
//
// Each thread owns up to kTM x kTN outputs of the tile (rows ty + i*rows_t,
// columns tx + j*cols_t) and keeps their sums in registers. Every output's
// sum over D runs d = 0, 1, ..., D-1 in one thread (fmaf, the zero padding
// of the last slice adds +0), so any (bb, bn) gives the same bits: a tile
// changes which block owns an output, never the order of its sum.
//
// Bound: operations at the shapes where the kernel sets the time (2*B*D*N
// fp32 flops against (4B*D + D*N + 4B*N) bytes: 1,000+ flops per byte at
// llama3.2-1b's gate projection over 2048 rows), bytes or launch latency at
// small B. What the design does: the x and w slices are read from shared
// memory once per kTM x kTN outer product (16 loads for 64 FMAs). No wgmma:
// x is fp32 and the first Hopper version of this kernel is the simple one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTM = 8;    // output rows per thread
constexpr int kTN = 8;    // output columns per thread
constexpr int kTD = 16;   // depth of one staged D slice
constexpr int kMaxTile = 128;  // largest bb and bn: 16 x 16 threads
constexpr int kMaxThreads = (kMaxTile / kTM) * (kMaxTile / kTN);

// at most 256 threads, so each may hold up to 255 registers: the 64 sums
// and 16 operands of a thread stay in registers without spilling (capping
// them at 128 for two blocks per SM spills them, and was slower)
template <bool kPerChannel>
__global__ void __launch_bounds__(kMaxThreads, 1)
dequant_matmul_kernel(const float* __restrict__ x,
                      const int8_t* __restrict__ q,
                      const float* __restrict__ scale, float* __restrict__ y,
                      int B, int D, int N, int bb, int bn, int col_tiles) {
  extern __shared__ float smem[];
  float* xs = smem;                   // (bb, kTD + 1) x slice
  float* ws = smem + bb * (kTD + 1);  // (kTD, bn) expanded weight slice

  const int cols_t = blockDim.x, rows_t = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * cols_t + tx, nthreads = cols_t * rows_t;
  const int r0 = (blockIdx.x / col_tiles) * bb;
  const int c0 = (blockIdx.x % col_tiles) * bn;
  const float s0 = kPerChannel ? 1.f : scale[0];

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kTD) {
    for (int i = tid; i < bb * kTD; i += nthreads) {
      const int r = i / kTD, d = i % kTD;
      const int gr = r0 + r, gd = d0 + d;
      xs[r * (kTD + 1) + d] = (gr < B && gd < D) ? x[(size_t)gr * D + gd] : 0.f;
    }
    for (int i = tid; i < kTD * bn; i += nthreads) {
      const int d = i / bn, c = i % bn;
      const int gd = d0 + d, gc = c0 + c;
      float w = 0.f;
      if (gd < D && gc < N)
        w = static_cast<float>(q[(size_t)gd * N + gc]) *
            (kPerChannel ? scale[gc] : s0);
      ws[d * bn + c] = w;
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < kTD; ++d) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int r = ty + i * rows_t;
        a[i] = r < bb ? xs[r * (kTD + 1) + d] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int c = tx + j * cols_t;
        b[j] = c < bn ? ws[d * bn + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty + i * rows_t, gr = r0 + r;
    if (r >= bb || gr >= B) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = tx + j * cols_t, gc = c0 + c;
      if (c < bn && gc < N) y[(size_t)gr * N + gc] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Launches on ``stream`` and returns cudaGetLastError(). ``bb`` and ``bn``
// must lie in [1, 128] (the Python wrapper clamps a table's entry there);
// ``per_channel`` selects a (N,) scale over a single () one.
int dequant_matmul_f32(const void* x, const void* q, const void* scale,
                       void* y, int B, int D, int N, int bb, int bn,
                       int per_channel, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (bb < 1 || bb > kMaxTile || bn < 1 || bn > kMaxTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_tiles = (B + bb - 1) / bb, col_tiles = (N + bn - 1) / bn;
  const dim3 threads((bn + kTN - 1) / kTN, (bb + kTM - 1) / kTM);
  const size_t smem = ((size_t)bb * (kTD + 1) + (size_t)kTD * bn) * sizeof(float);
  const dim3 grid((unsigned)row_tiles * (unsigned)col_tiles);
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto qp = static_cast<const int8_t*>(q);
  auto sp = static_cast<const float*>(scale);
  auto yp = static_cast<float*>(y);
  if (per_channel)
    dequant_matmul_kernel<true><<<grid, threads, smem, s>>>(
        xp, qp, sp, yp, B, D, N, bb, bn, col_tiles);
  else
    dequant_matmul_kernel<false><<<grid, threads, smem, s>>>(
        xp, qp, sp, yp, B, D, N, bb, bn, col_tiles);
  return static_cast<int>(cudaGetLastError());
}

const char* dequant_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
