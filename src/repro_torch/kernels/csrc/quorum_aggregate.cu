// Quorum aggregation for Hopper (sm_90a): masked per-slot FC merge.
//
//     out (B, C) = sum_k  mask_k * portion_k (B, Dk) @ (W_k (Dk, C) * s_k)  + bias
//
// Replaces repro/kernels/quorum_aggregate.py:_agg_kernel (the Pallas TPU
// kernel). The TPU version walks the slot axis k as a sequential grid axis
// and carries the (bb, C) sum in VMEM scratch between grid steps. Blocks on
// this card run in parallel and in no order, so here each block owns whole
// output rows and loops over k itself.
//
// Bound: memory, and at the serving shapes (K 8, B 256, Dk 32, C 10: a few
// hundred KB a call) the latency of one launch and of the memory round
// trips it waits on. The work is 2*K_alive*B*Dk*C flops against
// K_alive*B*Dk*4 + K_alive*Dk*C*w + B*C*4 bytes (w = 4 for fp32 weights, 1
// for int8), far below the card's flop-per-byte balance point.
//
// The rows route (the serving shapes: at most 32 slots and 32 classes, a
// row's portions in at most 8 chunks a lane, the weights within 48 KB):
//   * a warp owns an output row, and a block ``rows`` rows (``block_batch``,
//     1 by default: 256 blocks at B 256, more than the card's 132 SMs);
//   * the row's reduction axis is cut into chunks of 4 along Dk: G lanes
//     share a slot (G from Dk: 8 at Dk 32, 32 from Dk 128) and 32 / G slots
//     run side by side, so every lane works; each lane puts all its live
//     slots' chunks in flight as 16-byte loads (1 KB a row at the serving
//     shape) before it forms any dot, and the mask is read once;
//   * the arrived slots' weights are staged once per block by all 8 warps,
//     behind one barrier, as (K, CMAX, DP) rows of d (W_k[d, c] * s_k, int8
//     expanded on the way in, zero past Dk and past C), so a lane reads its
//     4 weights of a class as one 16-byte shared access without bank
//     conflicts, and every loop over classes runs to the compile-time
//     bound CMAX (4, 10, 16 or 32) with no branch; a slot whose mask is 0
//     reads no portion and no weight;
//   * each slot's dot is summed by every lane over its chunks (ascending
//     d), then by a shuffle butterfly over the slot's G lanes; the slots'
//     dots go through the warp's shared memory, and lane c sums class c's
//     in ascending k and adds the bias last. The order depends on (K, Dk)
//     alone.
// The tiles route (wider shapes: the sweep reaches Dk 640 and C 100) walks
// Dk in slices of 32 per slot: a block owns a tile of ``rows`` rows and 16
// or 32 classes, one thread an output, and stages each slot's portion and
// weight slices through shared memory; each dot runs over d in ascending
// order, then acc += dot_k in ascending k, the bias last.
// On both routes ``rows`` changes which block owns an output, never the
// order of its sum, so every block_batch gives the same bits. Portions may
// be a view: unit stride along Dk and element strides ``sk`` (slots) and
// ``sb`` (rows) passed in; a view whose base or strides are not aligned to
// 4 elements, or a Dk that 4 does not divide, reads its chunks one element
// at a time (V = 1) in the same order, so its bits equal the aligned
// call's. The plan (route, V, chunks, class bound, lanes, rows, threads,
// grid, shared memory) lives in Python (``quorum_aggregate.merge_plan``).
// No wgmma or TMA: a call moves a few hundred KB at the serving shapes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowThreads = 256;   // the rows route's launch bound
constexpr int kTileThreads = 1024;  // one output element per thread
constexpr int kTD = 32;             // depth of one staged Dk slice

// V elements moved as one access when aligned to it
template <int V>
struct alignas(V * sizeof(float)) Pack {
  float v[V];
};

template <typename W>
__device__ __forceinline__ float weight(const W* p) {
  return static_cast<float>(__ldg(p));
}

// -- the rows route -------------------------------------------------------

// Shared memory: the staged weights ws (K, CMAX, DP) then each warp's
// slot dots (K, CMAX); DP = 4 * G * J covers every lane's chunks, zero past
// Dk, and classes past C are zero rows, so the hot loops run to compile-
// time bounds with no per-class branch.
template <typename W, int V, int NCH, int CMAX>
__global__ void __launch_bounds__(kRowThreads)
quorum_aggregate_rows_kernel(const float* __restrict__ portions,
                             long long sk, long long sb,
                             const W* __restrict__ weights,
                             const float* __restrict__ scales,
                             const float* __restrict__ bias,
                             const int32_t* __restrict__ mask,
                             float* __restrict__ out, int K, int B, int Dk,
                             int C, int G, int rows) {
  extern __shared__ float4 smem[];
  const int Q = (Dk + 3) / 4;                  // chunks of 4 along Dk
  const int S = 32 / G;                        // slots side by side
  const int J = (Q + G - 1) / G;               // chunks a lane reads a slot
  const int P = (K + S - 1) / S;               // passes over the slots
  const int DP = 4 * G * J;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const int g = lane / G, t = lane % G;
  float* ws = reinterpret_cast<float*>(smem);  // weights * s_k
  float* dots = ws + (size_t)K * CMAX * DP + (size_t)warp * K * CMAX;

  // the mask, once: bit k is set for an arrived slot (K <= 32 here)
  const unsigned live =
      __ballot_sync(0xffffffffu, lane < K && mask[lane] != 0);
  const float bias_c = lane < C ? bias[lane] : 0.f;
  const int b_end = min(B, (blockIdx.x + 1) * rows);
  int b = blockIdx.x * rows + warp;

  // chunk i of this lane: pass i / J (slot pass * S + g), chunk t + G * j;
  // zero where the slot is out of range or dead, or the chunk past Dk
  Pack<4> x[NCH];
  auto load_row = [&](int row) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int pass = i / J, j = i - pass * J;
      const int k = pass * S + g, q = t + G * j;
#pragma unroll
      for (int e = 0; e < 4; ++e) x[i].v[e] = 0.f;
      if (pass < P && k < K && ((live >> k) & 1u) && q < Q) {
        const float* src = portions + k * sk + row * sb + 4 * q;
        if (V == 4) {
          x[i] = *reinterpret_cast<const Pack<4>*>(src);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * q + e < Dk) x[i].v[e] = src[e];
        }
      }
    }
  };
  if (b < b_end) load_row(b);       // in flight while the weights stage

  // the arrived slots' weights, once per block: a thread per (k, d) row
  for (int r = threadIdx.x; r < K * DP; r += blockDim.x) {
    const int k = r / DP, d = r - k * DP;
    if (!((live >> k) & 1u)) continue;
    float v[CMAX];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) v[c] = 0.f;
    if (d < Dk) {
      const float s = scales != nullptr ? scales[k] : 1.f;
      const W* src = weights + ((size_t)k * Dk + d) * C;
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C) v[c] = weight(src + c) * s;
    }
    float* dst = ws + (size_t)k * CMAX * DP + d;
#pragma unroll
    for (int c = 0; c < CMAX; ++c) dst[c * DP] = v[c];
  }
  __syncthreads();                  // the only barrier

  for (; b < b_end; b += warps) {   // uniform across the warp
    float part[CMAX];
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int pass = i / J, j = i - pass * J;
      if (pass >= P) break;
      if (j == 0) {
#pragma unroll
        for (int c = 0; c < CMAX; ++c) part[c] = 0.f;
      }
      // a slot past K reads slot K - 1's rows (its x is zero, its dot
      // unused); d past Dk reads the zero padding
      const int k = min(pass * S + g, K - 1);
      const float* wr = ws + (size_t)k * CMAX * DP + 4 * (t + G * j);
      float4 w4[CMAX];
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        w4[c] = *reinterpret_cast<const float4*>(wr + c * DP);
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        part[c] = fmaf(x[i].v[0], w4[c].x, part[c]);
        part[c] = fmaf(x[i].v[1], w4[c].y, part[c]);
        part[c] = fmaf(x[i].v[2], w4[c].z, part[c]);
        part[c] = fmaf(x[i].v[3], w4[c].w, part[c]);
      }
      if (j == J - 1) {
        // the slot's dot over its G lanes, the same bits in each
        for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
          for (int c = 0; c < CMAX; ++c)
            part[c] += __shfl_xor_sync(0xffffffffu, part[c], off);
        }
        const int kk = pass * S + g;
        if (t == 0 && kk < K && ((live >> kk) & 1u)) {
#pragma unroll
          for (int c = 0; c < CMAX; ++c) dots[kk * CMAX + c] = part[c];
        }
      }
    }
    __syncwarp();
    // acc += dot_k in ascending k over the arrived slots, the bias last
    if (lane < C) {
      float acc = 0.f;
      for (int k = 0; k < K; ++k)
        if ((live >> k) & 1u) acc += dots[k * CMAX + lane];
      out[(size_t)b * C + lane] = acc + bias_c;
    }
    __syncwarp();                   // the dots are read before the next row
    if (b + warps < b_end) load_row(b + warps);
  }
}

// -- the tiles route --------------------------------------------------------

template <typename W>
__global__ void __launch_bounds__(kTileThreads)
quorum_aggregate_tiles_kernel(const float* __restrict__ portions,
                              long long sk, long long sb,
                              const W* __restrict__ weights,
                              const float* __restrict__ scales,
                              const float* __restrict__ bias,
                              const int32_t* __restrict__ mask,
                              float* __restrict__ out, int K, int B, int Dk,
                              int C, int bm, int bn) {
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
    const float* pk = portions + k * sk;
    const W* wk = weights + (size_t)k * Dk * C;
    float dot = 0.f;
    for (int d0 = 0; d0 < Dk; d0 += kTD) {
      for (int i = tid; i < bm * kTD; i += threads) {
        const int r = i / kTD, d = i % kTD;
        const int gr = r0 + r, gd = d0 + d;
        sp[r * (kTD + 1) + d] =
            (gr < B && gd < Dk) ? pk[gr * sb + gd] : 0.f;
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

// -- launches -------------------------------------------------------------

struct Args {
  const float* portions;
  long long sk, sb;
  const void* weights;
  const float* scales;
  const float* bias;
  const int32_t* mask;
  float* out;
  int K, B, Dk, C;
};

template <typename W, int V, int NCH, int CMAX>
int launch_rows(const Args& a, int lanes, int rows, int threads, int blocks,
                int smem, cudaStream_t stream) {
  quorum_aggregate_rows_kernel<W, V, NCH, CMAX>
      <<<blocks, threads, smem, stream>>>(
          a.portions, a.sk, a.sb, static_cast<const W*>(a.weights),
          a.scales, a.bias, a.mask, a.out, a.K, a.B, a.Dk, a.C, lanes, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename W, int V, int NCH>
int launch_cmax(const Args& a, int cmax, int lanes, int rows, int threads,
                int blocks, int smem, cudaStream_t stream) {
#define QA_ROWS(CM) \
  launch_rows<W, V, NCH, CM>(a, lanes, rows, threads, blocks, smem, stream)
  switch (cmax) {
    case 4: return QA_ROWS(4);
    case 10: return QA_ROWS(10);
    case 16: return QA_ROWS(16);
    case 32: return QA_ROWS(32);
  }
#undef QA_ROWS
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename W, int V>
int launch_nch(const Args& a, int nch, int cmax, int lanes, int rows,
               int threads, int blocks, int smem, cudaStream_t stream) {
#define QA_ARGS a, cmax, lanes, rows, threads, blocks, smem, stream
  switch (nch) {
    case 1: return launch_cmax<W, V, 1>(QA_ARGS);
    case 2: return launch_cmax<W, V, 2>(QA_ARGS);
    case 4: return launch_cmax<W, V, 4>(QA_ARGS);
    case 8: return launch_cmax<W, V, 8>(QA_ARGS);
  }
#undef QA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename W>
int launch(const Args& a, int route, int vec, int nch, int cmax, int lanes,
           int rows, int threads, int grid_x, int grid_y, int smem,
           void* stream) {
  if (a.B <= 0 || a.C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || threads < 1 || grid_x < 1 || grid_y < 1 || smem < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 0) {               // rows
    if (a.K > 32 || a.C > cmax || threads > kRowThreads || threads < 32 ||
        threads % 32 != 0 || grid_y != 1 || lanes < 1 || lanes > 32 ||
        (lanes & (lanes - 1)) != 0 || (vec == 4 && a.Dk % 4 != 0) ||
        smem > 48 * 1024)
      return static_cast<int>(cudaErrorInvalidValue);
    if (vec == 4)
      return launch_nch<W, 4>(a, nch, cmax, lanes, rows, threads, grid_x,
                              smem, s);
    if (vec == 1)
      return launch_nch<W, 1>(a, nch, cmax, lanes, rows, threads, grid_x,
                              smem, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == 1) {               // tiles: lanes = bn classes a tile
    if ((lanes != 16 && lanes != 32) || rows * lanes != threads ||
        threads > kTileThreads)
      return static_cast<int>(cudaErrorInvalidValue);
    quorum_aggregate_tiles_kernel<W>
        <<<dim3(grid_x, grid_y), threads, smem, s>>>(
            a.portions, a.sk, a.sb, static_cast<const W*>(a.weights),
            a.scales, a.bias, a.mask, a.out, a.K, a.B, a.Dk, a.C, rows,
            lanes);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Each entry point launches on ``stream`` and returns cudaGetLastError().
// portions (K, B, Dk) with unit stride along Dk and element strides ``sk``,
// ``sb``; weights (K, Dk, C), bias (C,), mask (K,) int32 and out (B, C)
// contiguous. ``scales`` may be null on the fp32 path (scale 1); the int8
// path needs it. ``route`` (0 rows, 1 tiles), ``vec``, ``nch``, ``cmax``,
// ``lanes``, ``rows``, ``threads``, the grid and ``smem`` (bytes of dynamic
// shared memory) are the Python plan's; the rows route's vector width 4
// needs the portions' base and strides aligned to 4 elements.
#define QA_ENTRY(name, W)                                                    \
  int name(const void* portions, long long sk, long long sb,                 \
           const void* weights, const void* scales, const void* bias,        \
           const void* mask, void* out, int K, int B, int Dk, int C,         \
           int route, int vec, int nch, int cmax, int lanes, int rows,       \
           int threads, int grid_x, int grid_y, int smem, void* stream) {    \
    const Args a{static_cast<const float*>(portions), sk, sb, weights,       \
                 static_cast<const float*>(scales),                          \
                 static_cast<const float*>(bias),                            \
                 static_cast<const int32_t*>(mask), static_cast<float*>(out), \
                 K, B, Dk, C};                                               \
    return launch<W>(a, route, vec, nch, cmax, lanes, rows, threads, grid_x, \
                     grid_y, smem, stream);                                  \
  }

QA_ENTRY(quorum_aggregate_f32, float)
QA_ENTRY(quorum_aggregate_i8, int8_t)
#undef QA_ENTRY

const char* quorum_aggregate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
