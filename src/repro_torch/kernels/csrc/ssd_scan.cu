// Mamba2 SSD chunked scan for Hopper (sm_90a). For each sequence row bh
// (a (batch, head) pair) and each chunk of Q steps, with la = dt * A <= 0,
// cum = cumsum(la) within the chunk and xb = x * dt:
//
//     y[t] = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) xb_s
//            + exp(cum_t) (C_t . h)                          (h: P x N state)
//     h'   = exp(cum_Q) h + sum_s exp(cum_Q - cum_s) xb_s (x) B_s
//
// fp32 inside; y in x's type or fp32; the final fp32 state optionally.
//
// Replaces repro/kernels/ssd_scan.py:_ssd_kernel (the Pallas TPU kernel):
// grid (BH, chunks) with the chunk axis sequential and the (P, N) state in
// VMEM scratch; per chunk a full (Q, Q) score tile on the MXU. Here:
//   * one block per bh walks the chunks in a loop (blocks run in no order,
//     so nothing can carry across them); the state lives in shared memory,
//     stored transposed (N x (P+1)) so the threads of a warp, which own
//     consecutive p, read consecutive words;
//   * the (Q, Q) score tile does not fit in 227 KB at Q = 256 (256 KB in
//     fp32), so a chunk is cut into 64-row tiles of t and of s. Only tile
//     pairs with s0 <= t0 are visited, and inside the diagonal tile
//     exp(cum_t - cum_s) is evaluated only where s <= t: for s > t the
//     exponent is positive and may overflow, so it is never computed (the
//     TPU kernel computes it and masks the product afterwards);
//   * C_t . B_s is computed once per (t, s) pair and applied to all P
//     columns: a thread owns one p column and up to 32 t rows of the
//     output tile in registers; the reduction axes are read as float4;
//   * the chunk's cumulative log-decay is summed in fp64 (it reaches
//     ~10^3, where fp32 rounds by ~1e-4 and exp(cum_t - cum_s) of nearby t
//     and s would carry that error), then every exponent is taken in fp32;
//   * the inter-chunk term is taken from the old state before the state is
//     updated at the end of the chunk;
//   * operands are strided views: x (B, H, L, P), dt (B, H, L), A (B, H),
//     B/C (B, H, L, N) with any strides but unit stride on the last axis,
//     so the model's (B, L, H, P) projection and its head-shared (stride 0
//     over h) B/C go in without a copy; y is written through strides too.
// Bound: the bytes of x, B, C, y and the state at the serving shapes (the
// products are fp32 FMAs on the CUDA cores from shared memory; tensor cores
// are later work). Requirements: P a power of two in [4, 128]; N a multiple
// of 4 with N * P a multiple of 256 and at most 8192; the shared-memory
// plan within 227 KB.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                    // t rows and s columns per tile
constexpr int kMaxJ = kTile * 128 / kThreads;     // output rows per thread
constexpr int kMaxStateJ = 8192 / kThreads;       // state entries per thread
constexpr int kGRows = kTile * kTile / kThreads;  // score rows per thread

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

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  float* state;                              // nullptr: not written
  int H, L, P, N, Q;
  long long x_sb, x_sh, x_sl;
  long long dt_sb, dt_sh, dt_sl;
  long long a_sb, a_sh;
  long long b_sb, b_sh, b_sl;
  long long c_sb, c_sh, c_sl;
  long long y_sb, y_sh, y_sl;
};

// Floats of shared memory the kernel needs.
__host__ __device__ inline long long smem_floats(int P, int N, int Q) {
  return (long long)N * (P + 1)              // ht: state, transposed
         + (long long)kTile * N              // Cs: C tile, row-major
         + (long long)N * (kTile + 1)        // Bt: B tile (n-major / row-major)
         + (long long)kTile * P              // xs: x * dt tile
         + (long long)kTile * kTile          // G: masked, decayed scores
         + 3LL * Q;                          // cum (fp64), dtc
}

// cum[i] = a * sum_{j<=i} dtc[j] in fp64, by the 32 lanes of one warp: a
// serial sum over each lane's segment, then a shuffle scan of the segment
// sums. |cum| reaches ~10^3 over a chunk, where an fp32 rounding (~1e-4)
// would show in exp(cum_t - cum_s) for nearby t and s; in fp64 the
// differences are exact to fp32 precision.
__device__ void chunk_cumsum(const float* dtc, double* cum, int Q, float a,
                             int lane) {
  const int per = (Q + 31) / 32;
  const int lo = min(lane * per, Q), hi = min(lo + per, Q);
  double s = 0.0;
  for (int i = lo; i < hi; ++i) s += (double)(dtc[i] * a);
  double incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const double before = __shfl_up_sync(0xffffffffu, incl, 1);
  double run = lane == 0 ? 0.0 : before;
  for (int i = lo; i < hi; ++i) {
    run += (double)(dtc[i] * a);
    cum[i] = run;
  }
}

template <typename TX, typename TY>
__global__ void __launch_bounds__(kThreads) ssd_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int P = p.P, N = p.N, Q = p.Q;
  const int PP = P + 1, SP = kTile + 1;
  float* ht = smem;                          // ht[n * PP + q] = h[q, n]
  float* Cs = ht + N * PP;                   // Cs[t * N + n]
  float* Bt = Cs + kTile * N;                // Bt[n * SP + s] or Bs[s * N + n]
  float* xs = Bt + N * SP;                   // xs[s * P + q]
  float* G = xs + kTile * P;                 // G[t * kTile + s]
  double* cum = reinterpret_cast<double*>(G + kTile * kTile);  // 8-aligned
  float* dtc = reinterpret_cast<float*>(cum + Q);

  const int bh = blockIdx.x;
  const int b = bh / p.H, hh = bh % p.H;
  const TX* x = static_cast<const TX*>(p.x) + b * p.x_sb + hh * p.x_sh;
  const float* dt = p.dt + b * p.dt_sb + hh * p.dt_sh;
  const float a = p.A[b * p.a_sb + hh * p.a_sh];
  const TX* Bm = static_cast<const TX*>(p.Bm) + b * p.b_sb + hh * p.b_sh;
  const TX* Cm = static_cast<const TX*>(p.Cm) + b * p.c_sb + hh * p.c_sh;
  TY* y = static_cast<TY*>(p.y) + b * p.y_sb + hh * p.y_sh;

  const int tid = threadIdx.x;
  const int pcol = tid % P;                  // P divides kThreads
  const int rstep = kThreads / P;            // rows apart of a thread's rows
  const int r0 = tid / P;
  const int nj = kTile / rstep;              // output rows per thread
  const int nk = N / rstep;                  // state rows per thread (n)
  const int gs = tid % kTile, gt = tid / kTile;   // score tile mapping

  for (int i = tid; i < N * PP; i += kThreads) ht[i] = 0.f;

  for (int l0 = 0; l0 < p.L; l0 += Q) {
    for (int i = tid; i < Q; i += kThreads) dtc[i] = dt[(l0 + i) * p.dt_sl];
    __syncthreads();
    if (tid < 32) chunk_cumsum(dtc, cum, Q, a, tid);
    __syncthreads();

    for (int t0 = 0; t0 < Q; t0 += kTile) {
      const int nt = min(kTile, Q - t0);
      for (int i = tid; i < nt * N; i += kThreads)
        Cs[i] = to_f32(Cm[(long long)(l0 + t0 + i / N) * p.c_sl + i % N]);
      __syncthreads();

      // inter-chunk term from the state carried into this chunk
      float acc[kMaxJ];
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) acc[j] = 0.f;
      for (int n = 0; n < N; n += 4) {
        const float h0 = ht[n * PP + pcol], h1 = ht[(n + 1) * PP + pcol];
        const float h2 = ht[(n + 2) * PP + pcol], h3 = ht[(n + 3) * PP + pcol];
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j) {
          if (j < nj) {
            const float4 c = *reinterpret_cast<const float4*>(
                &Cs[(r0 + j * rstep) * N + n]);
            acc[j] += c.x * h0 + c.y * h1 + c.z * h2 + c.w * h3;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        const int t = r0 + j * rstep;
        if (j < nj && t < nt) acc[j] *= expf((float)cum[t0 + t]);
      }

      // intra-chunk term over the s tiles at or below the diagonal
      for (int s0 = 0; s0 <= t0; s0 += kTile) {
        const int ns = min(kTile, Q - s0);
        for (int i = tid; i < ns * N; i += kThreads) {
          const int s = i / N, n = i % N;
          Bt[n * SP + s] = to_f32(Bm[(long long)(l0 + s0 + s) * p.b_sl + n]);
        }
        for (int i = tid; i < kTile * P; i += kThreads) {
          const int s = i / P;
          xs[i] = s < ns ? to_f32(x[(long long)(l0 + s0 + s) * p.x_sl + i % P])
                               * dtc[s0 + s]
                         : 0.f;
        }
        __syncthreads();

        float sc[kGRows];
#pragma unroll
        for (int k = 0; k < kGRows; ++k) sc[k] = 0.f;
        for (int n = 0; n < N; n += 4) {
          const float b0 = Bt[n * SP + gs], b1 = Bt[(n + 1) * SP + gs];
          const float b2 = Bt[(n + 2) * SP + gs], b3 = Bt[(n + 3) * SP + gs];
#pragma unroll
          for (int k = 0; k < kGRows; ++k) {
            const float4 c = *reinterpret_cast<const float4*>(
                &Cs[(gt + k * (kThreads / kTile)) * N + n]);
            sc[k] += c.x * b0 + c.y * b1 + c.z * b2 + c.w * b3;
          }
        }
#pragma unroll
        for (int k = 0; k < kGRows; ++k) {
          const int t = gt + k * (kThreads / kTile);
          // never exp(cum_t - cum_s) for s > t: it may overflow
          const bool live = t < nt && gs < ns && s0 + gs <= t0 + t;
          G[t * kTile + gs] =
              live ? sc[k] * expf((float)(cum[t0 + t] - cum[s0 + gs])) : 0.f;
        }
        __syncthreads();

        for (int s = 0; s < kTile; s += 4) {
          const float x0 = xs[s * P + pcol], x1 = xs[(s + 1) * P + pcol];
          const float x2 = xs[(s + 2) * P + pcol], x3 = xs[(s + 3) * P + pcol];
#pragma unroll
          for (int j = 0; j < kMaxJ; ++j) {
            if (j < nj) {
              const float4 g = *reinterpret_cast<const float4*>(
                  &G[(r0 + j * rstep) * kTile + s]);
              acc[j] += g.x * x0 + g.y * x1 + g.z * x2 + g.w * x3;
            }
          }
        }
        __syncthreads();
      }

#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        const int t = r0 + j * rstep;
        if (j < nj && t < nt)
          y[(long long)(l0 + t0 + t) * p.y_sl + pcol] = from_f32<TY>(acc[j]);
      }
    }

    // state update: h' = exp(cum_Q) h + sum_s exp(cum_Q - cum_s) xb_s B_s;
    // a thread owns column pcol and state rows n in [r0 * nk, (r0+1) * nk)
    const double last = cum[Q - 1];
    float hs[kMaxStateJ];
#pragma unroll
    for (int k = 0; k < kMaxStateJ; ++k) hs[k] = 0.f;
    float* Bs = Bt;                          // row-major here: Bs[s * N + n]
    for (int s0 = 0; s0 < Q; s0 += kTile) {
      const int ns = min(kTile, Q - s0);
      for (int i = tid; i < ns * N; i += kThreads) {
        const int s = i / N;
        Bs[i] = to_f32(Bm[(long long)(l0 + s0 + s) * p.b_sl + i % N])
                * expf((float)(last - cum[s0 + s]));
      }
      for (int i = tid; i < ns * P; i += kThreads) {
        const int s = i / P;
        xs[i] = to_f32(x[(long long)(l0 + s0 + s) * p.x_sl + i % P])
                * dtc[s0 + s];
      }
      __syncthreads();
      for (int s = 0; s < ns; ++s) {
        const float xv = xs[s * P + pcol];
        const float* brow = Bs + s * N + r0 * nk;
#pragma unroll
        for (int k = 0; k < kMaxStateJ; ++k)
          if (k < nk) hs[k] += xv * brow[k];
      }
      __syncthreads();
    }
    const float dlast = expf((float)last);
#pragma unroll
    for (int k = 0; k < kMaxStateJ; ++k) {
      if (k < nk) {
        float* hp = &ht[(r0 * nk + k) * PP + pcol];
        *hp = *hp * dlast + hs[k];
      }
    }
    __syncthreads();
  }

  if (p.state != nullptr) {
    float* st = p.state + (long long)bh * P * N;
    for (int i = tid; i < P * N; i += kThreads) st[i] = ht[(i % N) * PP + i / N];
  }
}

template <typename TX, typename TY>
int launch(const Params& p, int BH, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats(p.P, p.N, p.Q) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<TX, TY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ssd_kernel<TX, TY><<<BH, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of shared memory the kernel needs for (P, N, Q).
long long ssd_scan_smem_bytes(int P, int N, int Q) {
  return smem_floats(P, N, Q) * (long long)sizeof(float);
}

// Launches on ``stream`` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for sizes the kernel does not take). ``strides``
// holds 17 element strides: x (b, h, l), dt (b, h, l), A (b, h),
// B (b, h, l), C (b, h, l), y (b, h, l); the last axes of x, B, C and y
// have unit stride. x, B and C share one type (``x_bf16``); dt and A are
// fp32; y is bf16 when ``y_bf16``, else fp32; ``state`` (Bsz*H, P, N)
// fp32 contiguous, or null.
int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, void* y, void* state, int Bsz, int H, int L,
             int P, int N, int Q, const long long* strides, int x_bf16,
             int y_bf16, void* stream) {
  if (Bsz <= 0 || H <= 0 || L <= 0) return 0;
  if (P < 4 || P > 128 || (P & (P - 1)) || N <= 0 || N % 4 ||
      N * P > 8192 || (N * P) % kThreads || Q <= 0 || L % Q)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A),
           Bm, Cm, y, static_cast<float*>(state), H, L, P, N, Q,
           strides[0], strides[1], strides[2], strides[3], strides[4],
           strides[5], strides[6], strides[7], strides[8], strides[9],
           strides[10], strides[11], strides[12], strides[13], strides[14],
           strides[15], strides[16]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = Bsz * H;
  if (x_bf16) {
    return y_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(p, BH, s)
                  : launch<__nv_bfloat16, float>(p, BH, s);
  }
  return y_bf16 ? launch<float, __nv_bfloat16>(p, BH, s)
                : launch<float, float>(p, BH, s);
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
