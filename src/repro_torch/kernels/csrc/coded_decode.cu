// Coded-share decode for Hopper (sm_90a): masked, decode-weighted gather
// over the share axis.
//
//     out (B, K, F)[b, k] = sum_r  mask[b, r] * dec[b, k, r] * share[b, r] * s_r
//
// Replaces repro/kernels/coded_decode.py:_decode_kernel (the Pallas TPU
// kernel). The TPU version runs a (batch tile, slot) grid and folds the
// (bb, R) weight row in VMEM. Here the work per row b is a tiny (K x R) by
// (R x F) product.
//
// Bound: memory, and at the serving shapes (B <= 256, R <= 8, K <= 5,
// F <= 64: well under a megabyte a call) the latency of one launch and of
// the memory round trips it waits on. The work is 2*B*K*R_live*F flops
// against the shares' payload, dec, mask, scales and the (B, K, F) fp32
// output, far below the card's flop-per-byte balance point. So the design
// puts every load of a row in flight at once and moves each byte once:
//   * a thread owns one row b and V = 4 adjacent feature columns, and
//     reads each share's 4 values as one access (16 bytes of fp32, 4 of
//     int8); it issues all R share loads, the row's mask and its (K, R)
//     dec weights (small and broadcast: every thread of the row reads the
//     same words, served by L1) before it uses any of them, so a call waits
//     on one memory round trip, with no barrier and no shared memory. For
//     int8, 16 columns a thread (a 16-byte access) measured slower at the
//     serving shape: its 16 conversions and 16 * K sums a share are a
//     longer serial chain than the loads it saves;
//   * R is bounded at compile time (RMAX = 4, 8 or 16, the serving codes'
//     R <= 16), so the loads unroll into straight-line code the compiler
//     can keep in flight together; a larger R runs the same body over
//     passes of 16 shares (the generic loop);
//   * a dead share is selected out of the sum (its garbage, NaN included,
//     never reaches it) instead of weighted by zero;
//   * int8 shares are read as int8 and scaled through the weights (s_r is
//     folded into dec), so the fp32 path multiplies by s = 1 and both share
//     types run one body;
//   * a block serves ``rows`` rows, ``lanes`` at a time, each lane a row of
//     threads along F, and the grid spreads the rows over the SMs.
// For each (b, k, f) the sum runs over r in ascending order, one fused
// multiply-add per live share, whatever the block shape, the vector width
// or the number of passes: every plan gives the same bits. Shares may be a
// view: unit stride along F, element strides ``sb`` (rows) and ``sr``
// (shares) passed in. A view whose base or strides are not aligned to 4
// elements, or an F that 4 does not divide, takes the scalar route (V = 1):
// the same kernel body, chosen by the plan. The plan (V, RMAX, rows, lanes, columns
// per block, grid) lives in Python (``coded_decode.decode_plan``).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

// V elements moved as one access when aligned to it
template <typename E, int V>
struct alignas(sizeof(E) * V > 16 ? 16 : sizeof(E) * V) Pack {
  E v[V];
};

// outputs summed per pass over the shares: the weight tile (KC x RMAX) and
// the sums (KC x V) stay within about 96 registers
__host__ __device__ constexpr int k_chunk(int V, int RMAX) {
  return 96 / (V + RMAX) < 8 ? 96 / (V + RMAX) : 8;
}

template <typename S, int V, int RMAX>
__global__ void __launch_bounds__(kMaxThreads)
coded_decode_kernel(const S* __restrict__ shares, long long sb, long long sr,
                    const float* __restrict__ dec,
                    const int32_t* __restrict__ mask,
                    const float* __restrict__ scales, float* __restrict__ out,
                    int B, int R, int K, int F, int rows) {
  constexpr int KC = k_chunk(V, RMAX);
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * V;  // first column
  if (c >= F) return;                    // no barrier in this kernel
  const int b_end = min(B, (blockIdx.x + 1) * rows);
  for (int b = blockIdx.x * rows + threadIdx.y; b < b_end; b += blockDim.y) {
    const S* sh = shares + b * sb + c;
    const int32_t* m = mask + (size_t)b * R;
    const float* d = dec + (size_t)b * K * R;
    float* o = out + (size_t)b * K * F + c;
    for (int k0 = 0; k0 < K; k0 += KC) {
      float acc[KC][V] = {};
      for (int r0 = 0; r0 < R; r0 += RMAX) {
        // every load of the pass is issued before the first use
        Pack<S, V> x[RMAX];
        int32_t live[RMAX];
        float w[KC][RMAX];
#pragma unroll
        for (int i = 0; i < RMAX; ++i) {
          const int r = r0 + i;
          const bool in = r < R;
          if (in) x[i] = *reinterpret_cast<const Pack<S, V>*>(sh + r * sr);
          live[i] = in ? m[r] : 0;
          const float s = in && scales != nullptr ? scales[r] : 1.f;
#pragma unroll
          for (int j = 0; j < KC; ++j)
            w[j][i] = in && k0 + j < K ? d[(size_t)(k0 + j) * R + r] * s
                                       : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RMAX; ++i) {
          if (live[i] == 0) continue;    // selected out, never weighted by 0
#pragma unroll
          for (int j = 0; j < KC; ++j)
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc[j][e] = fmaf(w[j][i], static_cast<float>(x[i].v[e]),
                               acc[j][e]);
        }
      }
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        if (k0 + j < K) {
          Pack<float, V> p;
#pragma unroll
          for (int e = 0; e < V; ++e) p.v[e] = acc[j][e];
          *reinterpret_cast<Pack<float, V>*>(o + (size_t)(k0 + j) * F) = p;
        }
      }
    }
  }
}

template <typename S, int V>
int launch_v(const S* shares, long long sb, long long sr, const float* dec,
             const int32_t* mask, const float* scales, float* out, int B,
             int R, int K, int F, int r_max, int rows, int lanes, int cols,
             int grid_x, int grid_y, cudaStream_t stream) {
  const dim3 grid(grid_x, grid_y), block(cols, lanes);
#define CD_ARGS shares, sb, sr, dec, mask, scales, out, B, R, K, F, rows
  switch (r_max) {
    case 4: coded_decode_kernel<S, V, 4><<<grid, block, 0, stream>>>(CD_ARGS);
      break;
    case 8: coded_decode_kernel<S, V, 8><<<grid, block, 0, stream>>>(CD_ARGS);
      break;
    case 16: coded_decode_kernel<S, V, 16><<<grid, block, 0, stream>>>(
        CD_ARGS);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CD_ARGS
  return static_cast<int>(cudaGetLastError());
}

// the vector route: V = 4 columns; the scalar route: V = 1
template <typename S>
int launch(const void* shares, long long sb, long long sr, const void* dec,
           const void* mask, const void* scales, void* out, int B, int R,
           int K, int F, int vec, int r_max, int rows, int lanes, int cols,
           int grid_x, int grid_y, void* stream) {
  if (B <= 0 || K <= 0 || F <= 0) return 0;
  if (rows < 1 || lanes < 1 || cols < 1 || cols * lanes > kMaxThreads ||
      grid_x < 1 || grid_y < 1 || vec < 1 || F % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define CD_LAUNCH static_cast<const S*>(shares), sb, sr, \
    static_cast<const float*>(dec), static_cast<const int32_t*>(mask), \
    static_cast<const float*>(scales), static_cast<float*>(out), B, R, K, F, \
    r_max, rows, lanes, cols, grid_x, grid_y, \
    static_cast<cudaStream_t>(stream)
  if (vec == 4) return launch_v<S, 4>(CD_LAUNCH);
  if (vec == 1) return launch_v<S, 1>(CD_LAUNCH);
#undef CD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Each entry point launches on ``stream`` and returns cudaGetLastError().
// shares (B, R, F) with unit stride along F and element strides ``sb``,
// ``sr``; dec (B, K, R), mask (B, R) and out (B, K, F) contiguous.
// ``scales`` may be null on the fp32 path (scale 1); the int8 path needs it.
// ``vec``, ``r_max``, ``rows``, ``lanes``, ``cols`` and the grid are the
// Python plan's; the vector route needs the shares' base and strides
// aligned to 4 elements.
int coded_decode_f32(const void* shares, long long sb, long long sr,
                     const void* dec, const void* mask, const void* scales,
                     void* out, int B, int R, int K, int F, int vec,
                     int r_max, int rows, int lanes, int cols, int grid_x,
                     int grid_y, void* stream) {
  return launch<float>(shares, sb, sr, dec, mask, scales, out, B, R, K, F,
                       vec, r_max, rows, lanes, cols, grid_x, grid_y, stream);
}

int coded_decode_i8(const void* shares, long long sb, long long sr,
                    const void* dec, const void* mask, const void* scales,
                    void* out, int B, int R, int K, int F, int vec, int r_max,
                    int rows, int lanes, int cols, int grid_x, int grid_y,
                    void* stream) {
  return launch<int8_t>(shares, sb, sr, dec, mask, scales, out, B, R, K, F,
                        vec, r_max, rows, lanes, cols, grid_x, grid_y,
                        stream);
}

const char* coded_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
