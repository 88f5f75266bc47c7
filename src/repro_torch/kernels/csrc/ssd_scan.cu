// Mamba2 SSD chunked scan for Hopper (sm_90a). For each sequence row (a
// (batch, head) pair) and each chunk of Q steps, with la = dt * A <= 0,
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
// VMEM scratch; per chunk a full (Q, Q) score tile on the MXU. Hopper's
// blocks run in no order, so nothing can carry a state across them. Two
// paths, chosen by the wrapper from the operands' type and shape:
//
// The tensor-core path (bf16 x, B, C; P and N multiples of 16, P <= 128,
// P * N <= 8192): the SSD decomposition into two launches, in stream order,
// whose plans depend on the shapes alone (no host sync; a CUDA graph can
// capture them).
//   (a) ssd_chunk_state_mma, a block per (b, h, chunk): the chunk's fp64
//       cumsum (kept in a workspace for (b)), exp(cum_Q), and the chunk's
//       own state S_c = sum_s xb_s (x) exp(cum_Q - cum_s) B_s as a (P, N)
//       product over s, (w x)^T B with w_s = dt_s exp(cum_Q - cum_s), all
//       of the chunk's x and B rows loaded at once. Each block then takes
//       a ticket on its (b, h) row's counter; the last of the row's blocks
//       folds the row's states in chunk order, in place, into the states
//       entering each chunk, h_{c+1} = exp(cum_Q,c) h_c + S_c (h_0 = 0),
//       writes the final state, and resets the counter for the next call;
//   (b) ssd_chunk_out_mma, a block per (b, chunk, 64-row t-tile, group of
//       HG heads), heaviest t-tiles first, four warps per head (16 rows
//       each): per s-tile at or below the diagonal the score tile C B^T,
//       computed once for the group (the heads share B and C: stride 0
//       over h; else HG = 1; with HG = 4 each head's warps compute one of
//       its four 16-column pairs into shared memory), times exp(cum_t -
//       cum_s) dt_s per head, then G x; after the s-tiles y += exp(cum_t)
//       C h_c^T with the entering state h_c that (a) left, one read per
//       head.
//       exp(cum_t - cum_s) is never taken for s > t: it may overflow; off
//       the diagonal it is exp(cum_t - r) exp(r - cum_s) for an r between
//       the two, both factors at most 1, with no exp per element. The
//       diagonal's k-steps past a warp's rows are skipped.
//   All four products (C B^T, G x, C h^T, (w x)^T B) are mma.sync m16n8k16,
//   bf16 in and fp32 accumulate. x, B and C enter exactly (they are bf16);
//   each fp32 factor (the decayed, dt-weighted score tile G, the state h_c,
//   the decay-weighted x rows w x) enters as kTerms = 3 bf16 operands, t0 =
//   bf16(v), t1 = bf16(v - t0), t2 = bf16(v - t0 - t1), one product each:
//   the terms carry 24 of v's bits, but the tensor cores' fp32 accumulation
//   is not IEEE fp32's, so the results still differ from fp32 FMAs in the
//   last bits. Rounding those factors to bf16 once breaks the fp32 bound
//   (2e-3) at jamba's shape (P 64, N 16; see tests/test_torch_ssd_chunks.py);
//   two terms (about 2^-17 relative) hold that bound, but flipped a
//   near-tied MoE route of jamba-v0.1-52b in chip_smoke.py's
//   decode-step-vs-prefill check, which three pass (a near tie flips under
//   any change of rounding: against the plain version, this kernel and the
//   CUDA-core one both route rows of jamba's prefill differently; PERF.md).
//   The third term costs half again the products of the fp32 factors.
//   Operand tiles (C, B, x; padded rows of 8 extra bf16, so ldmatrix reads
//   without bank conflicts) arrive by cp.async, in (b) in a ring of two
//   stages: the next s-tile loads while one computes. Ragged edges (any Q
//   with L % Q == 0) are zero-filled by cp.async and masked. The wrapper
//   sizes both launches' shared memory (ssd_scan.py:mma_smem_bytes, the
//   layouts carved below).
//   Bound at the serving shapes: the bytes of x, y, B, C and the state
//   (6.9 us at mamba2-130m's, 31 us at jamba's); the 2.5 GFLOP the scan
//   needs at mamba2's take 2.5 us at the bf16 rate, the kernel's three-term
//   products about 8 GFLOP, 8 us. What bounds it now (globaltimer
//   stamps per block and phase, SASS counts, in an instrumented build on
//   an H100; PERF.md): latency along each warp's chain of an s-tile (C
//   B^T, the decay and the operand terms, G x) with 12-16 warps per SM,
//   well under both the memory and the tensor-core rates.
//
// The CUDA-core path (fp32 operands, and bf16 shapes outside the range
// above), ssd_kernel: one block per (b, h) walks the chunks in a loop with
// the state in shared memory, stored transposed (N x (P+1)) so the threads
// of a warp, which own consecutive p, read consecutive words; a chunk is
// cut into 64-row tiles of t and s, only tile pairs with s0 <= t0 are
// visited; C_t . B_s is computed once per (t, s) pair and applied to all P
// columns, fp32 FMAs from shared memory. Requirements: P a power of two in
// [4, 128]; N a multiple of 4 with N * P a multiple of 256 and at most
// 8192; the shared-memory plan within 227 KB.
//
// Both paths sum the chunk's cumulative log-decay in fp64 (it reaches
// ~10^3, where fp32 rounds by ~1e-4 and exp(cum_t - cum_s) of nearby t and
// s would carry that error), then take every exponent in fp32. Operands
// are strided views: x (B, H, L, P), dt (B, H, L), A (B, H), B/C (B, H, L,
// N) with any strides but unit stride on the last axis, so the model's
// (B, L, H, P) projection and its head-shared (stride 0 over h) B/C go in
// without a copy; y is written through strides too.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// -- the CUDA-core path -------------------------------------------------------

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

// -- the tensor-core path -----------------------------------------------------

constexpr int kMmaThreads = 128;             // 4 warps
constexpr int kRows = 64;                    // rows of a t- or s-tile
constexpr int kPad = 8;                      // bf16 padding of a smem row
constexpr int kTerms = 3;                    // bf16 terms of an fp32 factor
constexpr int kCbs = kRows + 8;              // fp32 row of a shared C B^T
constexpr int kMaxDevices = 64;

struct MmaParams {
  const __nv_bfloat16* x;
  const float* dt;
  const float* A;
  const __nv_bfloat16* Bm;
  const __nv_bfloat16* Cm;
  void* y;
  float* state;                              // nullptr: not written
  float* ws_state;                           // (BH, nc, P, N): S_c
  double* ws_cum;                            // (BH, L): the chunks' cumsums
  float* ws_decay;                           // (BH, nc): exp(cum_Q) per chunk
  int* counters;                             // (BH): tickets, 0 between calls
  int H, L, P, N, Q, nc, y_bf16;
  long long x_sb, x_sh, x_sl;
  long long dt_sb, dt_sh, dt_sl;
  long long a_sb, a_sh;
  long long b_sb, b_sh, b_sl;
  long long c_sb, c_sh, c_sl;
  long long y_sb, y_sh, y_sl;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 or 8 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) as kTerms packed bf16 pairs whose sum is v to fp32's precision:
// t[0] = bf16(v), t[1] = bf16(v - t[0]), t[2] = bf16(v - t[0] - t[1]);
// each difference is exact in fp32
__device__ __forceinline__ void split_terms(float v0, float v1,
                                            uint32_t (&t)[kTerms]) {
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    t[k] = bits(h);
    const float2 hf = __bfloat1622float2(h);
    v0 -= hf.x;
    v1 -= hf.y;
  }
}

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Bytes of one stage of launch (b)'s ring: a B tile and the group's x
// tiles.
__device__ inline long long out_stage_bytes(int P, int N, int HG) {
  return (long long)kRows * (N + kPad) * 2
         + (long long)HG * kRows * (P + kPad) * 2;
}

template <int K>
struct Kind {
  static constexpr int value = K;
};

// The warp's index, as a value the compiler knows is the same across the
// warp, so the warp-wide ldmatrix and mma under conditions on it need no
// divergence handling.
__device__ __forceinline__ int warp_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 5, 0);
}

// Launch (a): a block per (chunk, h, b), one warp per 16 rows p of the
// (P, N) state; NT = N / 8 column tiles per warp. The last block of each
// (b, h) row folds the row's states (see the top of the file).
template <int NT>
__global__ void __launch_bounds__(256) ssd_chunk_state_mma(MmaParams p) {
  extern __shared__ float4 smem4[];
  const int P = p.P, Q = p.Q;
  constexpr int N = NT * 8, NS = N + kPad;
  const int PS = P + kPad;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * p.H + h;
  const int Qp = round_up(Q, kRows);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [Qp][PS]
  __nv_bfloat16* bs = xs + Qp * PS;                             // [Qp][NS]
  double* cum = reinterpret_cast<double*>(bs + Qp * NS);        // [Qp]
  float* w = reinterpret_cast<float*>(cum + Qp);                 // [Qp]

  const int tid = threadIdx.x, lane = tid & 31, warp = warp_index();
  const int nthreads = blockDim.x;
  const long long l0 = (long long)c * Q;
  const __nv_bfloat16* xg = p.x + b * p.x_sb + h * p.x_sh + l0 * p.x_sl;
  const __nv_bfloat16* bg = p.Bm + b * p.b_sb + h * p.b_sh + l0 * p.b_sl;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh + l0 * p.dt_sl;
  const float a = p.A[b * p.a_sb + h * p.a_sh];
  const bool need = c < p.nc - 1 || p.state != nullptr;
  const int P8 = P / 8;

  // dt, then the chunk's x and B rows, all in flight at once (rows past Q
  // zero-filled)
  for (int i = tid; i < Q; i += nthreads) cp_async4(w + i, dtg + i * p.dt_sl);
  cp_async_commit();
  if (need) {
    for (int i = tid; i < Qp * P8; i += nthreads) {
      const int r = i / P8, k = i % P8;
      const bool ok = r < Q;
      cp_async16(xs + r * PS + k * 8, ok ? xg + r * p.x_sl + k * 8 : xg, ok);
    }
    for (int i = tid; i < Qp * NT; i += nthreads) {
      const int r = i / NT, k = i % NT;
      const bool ok = r < Q;
      cp_async16(bs + r * NS + k * 8, ok ? bg + r * p.b_sl + k * 8 : bg, ok);
    }
    cp_async_commit();
    cp_async_wait<1>();                      // dt has landed
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  if (warp == 0) chunk_cumsum(w, cum, Q, a, lane);
  __syncthreads();
  const double last = cum[Q - 1];
  double* cum_out = p.ws_cum + (long long)bh * p.L + l0;
  for (int i = tid; i < Qp; i += nthreads) {
    if (i < Q) {
      cum_out[i] = cum[i];
      w[i] *= expf((float)(last - cum[i]));  // w_s = dt_s exp(cum_Q - cum_s)
    } else {
      w[i] = 0.f;
    }
  }
  if (tid == 0) p.ws_decay[bh * p.nc + c] = expf((float)last);
  const long long PN = (long long)P * N;
  float* srow = p.ws_state + (long long)bh * p.nc * PN;
  if (need) {
    float acc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    const int mi = lane >> 3, r8 = lane & 7, g = lane >> 2, q2 = 2 * (lane & 3);
    cp_async_wait<0>();
    __syncthreads();                           // x, B and w visible
    // S = (w x)^T B: A = x^T rows of this warp's 16 p, read transposed and
    // scaled by w_s in registers, as kTerms bf16 terms; B = the B rows as
    // they are. All products of one term, then of the next, so no mma waits
    // on the one just before it.
    const __nv_bfloat16* xw = xs + ((mi >> 1) * 8 + r8) * PS + warp * 16
                              + (mi & 1) * 8;
    const __nv_bfloat16* bw = bs + ((mi & 1) * 8 + r8) * NS + (mi >> 1) * 8;
    for (int s0 = 0; s0 < Q; s0 += 16) {
      uint32_t xf[4], at[kTerms][4];
      ldsm_x4_t(xf, xw + s0 * PS);
      const float2 w0 = *reinterpret_cast<const float2*>(w + s0 + q2);
      const float2 w8 = *reinterpret_cast<const float2*>(w + s0 + 8 + q2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xf[e]));
        const float2 ws = e < 2 ? w0 : w8;
        uint32_t t[kTerms];
        split_terms(v.x * ws.x, v.y * ws.y, t);
#pragma unroll
        for (int k = 0; k < kTerms; ++k) at[k][e] = t[k];
      }
      uint32_t bf[NT / 2][4];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldsm_x4_t(bf[np], bw + s0 * NS + np * 16);
#pragma unroll
      for (int k = 0; k < kTerms; ++k) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          mma_bf16(acc[2 * np], at[k], bf[np][0], bf[np][1]);
          mma_bf16(acc[2 * np + 1], at[k], bf[np][2], bf[np][3]);
        }
      }
    }

    float* sc = srow + c * PN;
    const int pr = warp * 16 + g;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int n = i * 8 + q2;
      *reinterpret_cast<float2*>(sc + pr * N + n) =
          make_float2(acc[i][0], acc[i][1]);
      *reinterpret_cast<float2*>(sc + (pr + 8) * N + n) =
          make_float2(acc[i][2], acc[i][3]);
    }
  }
  if (p.nc == 1 && p.state == nullptr) return;   // no state to pass on

  // the ticket: every block's S_c and decay are written before its ticket
  // (the fence is cumulative), and the block that takes the row's last one
  // reads them all
  __syncthreads();
  int last_block = 0;
  if (tid == 0) {
    __threadfence();
    last_block = atomicAdd(p.counters + bh, 1) == p.nc - 1;
    if (last_block) {
      p.counters[bh] = 0;                    // ready for the next call
      __threadfence();                       // the others' states, as written
    }
  }
  if (!__syncthreads_or(last_block)) return;
  // the fold, in place: slot k of the row gets h_k, the state entering
  // chunk k (slot 0 stays as it is: (b) passes no state into chunk 0),
  // after S_k is read from it; then the final state h_nc. Each thread
  // folds kFold float4s of the (P, N) state at a time, their S_{k+1} in
  // flight together while h_k is stored. With no final state S_{nc-1} is
  // neither written nor read, and slot nc-1 gets h_{nc-1}.
  constexpr int kFold = 8;
  const int kend = p.state != nullptr ? p.nc : p.nc - 1;
  const float* dk = p.ws_decay + (long long)bh * p.nc;
  float4* s4 = reinterpret_cast<float4*>(srow);
  const long long PN4 = PN / 4;
  for (long long i0 = tid; i0 < PN4; i0 += kFold * nthreads) {
    float4 h[kFold], s[kFold];
#pragma unroll
    for (int u = 0; u < kFold; ++u) {
      const long long i = i0 + u * nthreads;
      h[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      s[u] = i < PN4 ? __ldcg(s4 + i) : h[u];
    }
    for (int k = 0; k < kend; ++k) {
      float4 nxt[kFold];
#pragma unroll
      for (int u = 0; u < kFold; ++u) {
        const long long i = i0 + u * nthreads;
        nxt[u] = k + 1 < kend && i < PN4 ? __ldcg(s4 + (k + 1) * PN4 + i)
                                         : s[u];
      }
      const float d = __ldcg(dk + k);
#pragma unroll
      for (int u = 0; u < kFold; ++u) {
        const long long i = i0 + u * nthreads;
        if (k > 0 && i < PN4) __stcg(s4 + k * PN4 + i, h[u]);
        h[u] = make_float4(h[u].x * d + s[u].x, h[u].y * d + s[u].y,
                           h[u].z * d + s[u].z, h[u].w * d + s[u].w);
        s[u] = nxt[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kFold; ++u) {
      const long long i = i0 + u * nthreads;
      if (i >= PN4) continue;
      if (p.state != nullptr)
        reinterpret_cast<float4*>(p.state + (long long)bh * PN)[i] = h[u];
      else
        __stcg(s4 + kend * PN4 + i, h[u]);   // h_{nc-1}, the last chunk's
    }
  }
}

// Launch (b): a block per (t-tile and chunk, group of HG heads, b), HG
// quads of 4 warps; PT = P / 8 output column tiles per head. Warp w of quad
// q owns rows [16w, 16w + 16) of the t-tile for head h0 + q. The quads
// share the C tile, each s-tile's B tile and one C B^T: with HG > 1 each
// quad computes 4 / HG of its 16-column pairs into shared memory, and
// every warp reads back its rows.
template <int PT, int HG>
__global__ void __launch_bounds__(kMmaThreads * HG)
    ssd_chunk_out_mma(MmaParams p) {
  extern __shared__ float4 smem4[];
  constexpr int P = PT * 8, PS = P + kPad, kThr = kMmaThreads * HG;
  constexpr int NPQ = 4 / HG;                // 16-column pairs per quad
  const int N = p.N, Q = p.Q, NS = N + kPad;
  const int Qp = round_up(Q, kRows);
  const int ntt = Qp / kRows;
  const int ti = ntt - 1 - (int)blockIdx.x / p.nc;   // heaviest tiles first
  const int c = (int)blockIdx.x % p.nc;
  const int h0 = blockIdx.y * HG, b = blockIdx.z;
  const int t0 = ti * kRows, t_end = min(Q, t0 + kRows);
  const long long stage = out_stage_bytes(P, N, HG) / 2;   // in bf16s

  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [64][NS]
  __nv_bfloat16* ring = cs + kRows * NS;     // two stages, then h_c
  const long long hs_elems = (long long)kTerms * P * NS;
  const long long ring_elems = 2 * stage > hs_elems ? 2 * stage : hs_elems;
  float* cbs = reinterpret_cast<float*>(ring + ring_elems);    // [64][kCbs]
  double* cum = reinterpret_cast<double*>(cbs + (HG > 1 ? kRows * kCbs : 0));
  float* dts = reinterpret_cast<float*>(cum + HG * Qp);        // [HG][Qp]
  float* rowf = dts + HG * Qp;                                 // [HG][64]
  __nv_bfloat16* hterm = ring;               // h_c's terms, after the s-tiles

  const int tid = threadIdx.x, lane = tid & 31, warp = warp_index();
  const int jq = warp >> 2, wq = warp & 3;   // this warp's head and rows
  const int mi = lane >> 3, r8 = lane & 7, g = lane >> 2, q2 = 2 * (lane & 3);
  const long long l0 = (long long)c * Q;
  const __nv_bfloat16* cg = p.Cm + b * p.c_sb + h0 * p.c_sh + l0 * p.c_sl;
  const __nv_bfloat16* bg = p.Bm + b * p.b_sb + h0 * p.b_sh + l0 * p.b_sl;
  const __nv_bfloat16* xg = p.x + b * p.x_sb + h0 * p.x_sh + l0 * p.x_sl;
  const int N8 = N / 8;

  auto stage_ptr = [&](int j) { return ring + (j & 1) * stage; };
  auto issue = [&](int j) {                  // s-tile j: B, then x per head
    const int s0 = j * kRows, rows = min(kRows, Q - s0);
    __nv_bfloat16* bd = stage_ptr(j);
    for (int i = tid; i < kRows * N8; i += kThr) {
      const int r = i / N8, k = i % N8;
      const bool ok = r < rows;
      cp_async16(bd + r * NS + k * 8,
                 ok ? bg + (s0 + r) * p.b_sl + k * 8 : bg, ok);
    }
    __nv_bfloat16* xd = bd + kRows * NS;
    for (int i = tid; i < HG * kRows * PT; i += kThr) {
      const int jh = i / (kRows * PT), r = i / PT % kRows, k = i % PT;
      const bool ok = r < rows;
      const __nv_bfloat16* xh = xg + jh * p.x_sh;
      cp_async16(xd + (jh * kRows + r) * PS + k * 8,
                 ok ? xh + (s0 + r) * p.x_sl + k * 8 : xh, ok);
    }
    cp_async_commit();
  };

  for (int i = tid; i < kRows * N8; i += kThr) {   // the C tile
    const int r = i / N8, k = i % N8;
    const bool ok = t0 + r < Q;
    cp_async16(cs + r * NS + k * 8,
               ok ? cg + (t0 + r) * p.c_sl + k * 8 : cg, ok);
  }
  for (int i = tid; i < HG * t_end; i += kThr) {   // cum and dt of s < t_end
    const int jh = i / t_end, s = i % t_end;
    cp_async8(cum + jh * Qp + s,
              p.ws_cum + ((long long)b * p.H + h0 + jh) * p.L + l0 + s);
    cp_async4(dts + jh * Qp + s, p.dt + b * p.dt_sb + (h0 + jh) * p.dt_sh
                                     + (l0 + s) * p.dt_sl);
  }
  cp_async_commit();
  issue(0);

  float acc[PT][4];
#pragma unroll
  for (int pt = 0; pt < PT; ++pt)
    acc[pt][0] = acc[pt][1] = acc[pt][2] = acc[pt][3] = 0.f;
  const int tl = t0 + wq * 16 + g;           // this thread's rows tl, tl + 8
  const int th = tl + 8;
  const __nv_bfloat16* arow = cs + (wq * 16 + (mi & 1) * 8 + r8) * NS
                              + (mi >> 1) * 8;

  // decay factors of the off-diagonal s-tiles (s < t0 <= t): exp(cum_t -
  // cum_s) = exp(cum_t - r) exp(r - cum_s) with r = cum_{t0-1}. cum falls
  // with the step, so both factors are at most 1: neither overflows, and
  // one that underflows to 0 stands for a product under 1e-38. rowf holds
  // exp(cum_t - r) per row; exp(r - cum_s) dt_s goes over dts in place.
  if (ti > 0) {
    cp_async_wait<1>();                      // cum and dt have landed
    __syncthreads();
    for (int i = tid; i < HG * (t0 + kRows); i += kThr) {
      const int jh = i / (t0 + kRows), s = i % (t0 + kRows);
      const double r = cum[jh * Qp + t0 - 1];
      if (s < t0)
        dts[jh * Qp + s] *= expf((float)(r - cum[jh * Qp + s]));
      else
        rowf[jh * kRows + s - t0] =
            s < t_end ? expf((float)(cum[jh * Qp + s] - r)) : 0.f;
    }
  }

  const int tw = t0 + wq * 16;               // this warp's first row
  const bool idle = tw >= t_end;             // all its rows past the chunk
  const double* cj = cum + jq * Qp;
  const float* dj = dts + jq * Qp;           // column factors below t0
  for (int j = 0; j <= ti; ++j) {
    if (j < ti) {
      issue(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                         // s-tile j (and cum, C) visible
    const __nv_bfloat16* bt = stage_ptr(j);
    const __nv_bfloat16* xt = bt + kRows * NS + jq * kRows * PS;
    const int s0 = j * kRows;
    const bool diag = j == ti;
    // on the diagonal, s-columns past the warp's rows are never used
    const int nnp = diag ? wq + 1 : 4;

    // C B^T, 16 t rows x 64 s per row group: this quad's column pairs
    float cbq[NPQ][2][4];
    if (!idle) {
#pragma unroll
      for (int u = 0; u < NPQ; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v)
          cbq[u][v][0] = cbq[u][v][1] = cbq[u][v][2] = cbq[u][v][3] = 0.f;
      // one k-step of C B^T over this quad's column pairs; off the
      // diagonal all of them, without branches
      auto cb_step = [&](int kk, auto all) {
        uint32_t af[4];
        ldsm_x4(af, arow + kk * 16);
#pragma unroll
        for (int u = 0; u < NPQ; ++u) {
          if (decltype(all)::value || jq * NPQ + u < nnp) {
            uint32_t bf[4];
            ldsm_x4(bf, bt + ((jq * NPQ + u) * 16 + (mi >> 1) * 8 + r8) * NS
                            + kk * 16 + (mi & 1) * 8);
            mma_bf16(cbq[u][0], af, bf[0], bf[1]);
            mma_bf16(cbq[u][1], af, bf[2], bf[3]);
          }
        }
      };
      if (!diag) {
#pragma unroll 2
        for (int kk = 0; kk < N / 16; ++kk) cb_step(kk, Kind<1>{});
      } else {
        for (int kk = 0; kk < N / 16; ++kk) cb_step(kk, Kind<0>{});
      }
    }
    float cb[8][4];
    if constexpr (HG == 1) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
          for (int e = 0; e < 4; ++e) cb[2 * u + v][e] = cbq[u][v][e];
    } else {                                 // through shared memory
      if (!idle) {
#pragma unroll
        for (int u = 0; u < NPQ; ++u) {
          const int np = jq * NPQ + u;
          if (np < nnp) {
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              float* o = cbs + (wq * 16 + g) * kCbs + np * 16 + v * 8 + q2;
              *reinterpret_cast<float2*>(o) =
                  make_float2(cbq[u][v][0], cbq[u][v][1]);
              *reinterpret_cast<float2*>(o + 8 * kCbs) =
                  make_float2(cbq[u][v][2], cbq[u][v][3]);
            }
          }
        }
      }
      __syncthreads();                       // the group's C B^T visible
      if (!idle) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt < 2 * nnp) {
            const float* o = cbs + (wq * 16 + g) * kCbs + nt * 8 + q2;
            const float2 lo = *reinterpret_cast<const float2*>(o);
            const float2 hi = *reinterpret_cast<const float2*>(o + 8 * kCbs);
            cb[nt][0] = lo.x, cb[nt][1] = lo.y, cb[nt][2] = hi.x,
            cb[nt][3] = hi.y;
          }
        }
      }
    }

    if (!idle) {                             // G x for this warp's head
      const bool ll = tl < t_end, lh = th < t_end;
      const double cl = cj[min(tl, t_end - 1)], ch = cj[min(th, t_end - 1)];
      // row factors: of the tile's r off the diagonal; on it, of
      // r_w = cum_{tw-1} for the columns below the warp's rows
      float fl, fh;
      double rw = 0.0;
      if (!diag) {
        fl = rowf[jq * kRows + tl - t0];
        fh = rowf[jq * kRows + th - t0];
      } else {
        rw = cj[max(tw - 1, 0)];
        fl = ll ? expf((float)(cl - rw)) : 0.f;
        fh = lh ? expf((float)(ch - rw)) : 0.f;
      }
      // one k-step of 16 s-columns: G's terms, then G x; kind 0 takes
      // columns below every row of the warp with the tile's column
      // factors, kind 1 the same on the diagonal tile (factors of r_w),
      // kind 2 the warp's own 16 x 16 diagonal block, one exp each
      auto kstep = [&](int kk, auto kind) {
        constexpr int K = decltype(kind)::value;
        uint32_t at[kTerms][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nt = 2 * kk + half;
          const int s = s0 + nt * 8 + q2;    // this thread's columns s, s+1
          float g00, g01, g10, g11;
          if constexpr (K < 2) {
            float f0 = dj[s], f1 = dj[s + 1];
            if constexpr (K == 1) {
              f0 *= expf((float)(rw - cj[s]));
              f1 *= expf((float)(rw - cj[s + 1]));
            }
            g00 = cb[nt][0] * fl * f0;
            g01 = cb[nt][1] * fl * f1;
            g10 = cb[nt][2] * fh * f0;
            g11 = cb[nt][3] * fh * f1;
          } else {
            // never exp(cum_t - cum_s) for s > t: it may overflow
            g00 = ll && s <= tl
                ? cb[nt][0] * expf((float)(cl - cj[s])) * dj[s] : 0.f;
            g01 = ll && s + 1 <= tl
                ? cb[nt][1] * expf((float)(cl - cj[s + 1])) * dj[s + 1]
                : 0.f;
            g10 = lh && s <= th
                ? cb[nt][2] * expf((float)(ch - cj[s])) * dj[s] : 0.f;
            g11 = lh && s + 1 <= th
                ? cb[nt][3] * expf((float)(ch - cj[s + 1])) * dj[s + 1]
                : 0.f;
          }
          uint32_t t0v[kTerms], t1v[kTerms];
          split_terms(g00, g01, t0v);
          split_terms(g10, g11, t1v);
#pragma unroll
          for (int k = 0; k < kTerms; ++k) {
            at[k][2 * half] = t0v[k];
            at[k][2 * half + 1] = t1v[k];
          }
        }
        const __nv_bfloat16* xr = xt + (kk * 16 + (mi & 1) * 8 + r8) * PS
                                  + (mi >> 1) * 8;
        uint32_t xf[PT / 2][4];
#pragma unroll
        for (int q = 0; q < PT / 2; ++q) ldsm_x4_t(xf[q], xr + q * 16);
        // one term's products, then the next's: no mma waits on the last
#pragma unroll
        for (int k = 0; k < kTerms; ++k) {
#pragma unroll
          for (int q = 0; q < PT / 2; ++q) {
            mma_bf16(acc[2 * q], at[k], xf[q][0], xf[q][1]);
            mma_bf16(acc[2 * q + 1], at[k], xf[q][2], xf[q][3]);
          }
        }
      };
      if (!diag) {                           // no branches: the compiler
#pragma unroll                               // interleaves the k-steps
        for (int kk = 0; kk < 4; ++kk) kstep(kk, Kind<0>{});
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < wq) kstep(kk, Kind<1>{});
          else if (kk == wq) kstep(kk, Kind<2>{});
        }
      }
    }
    __syncthreads();                         // stage j (and C B^T) consumed
  }

  // y += exp(cum_t) C h_c^T, after the s-tiles, one head at a time, with
  // h_c's terms over the then free ring: h_c, the state entering chunk c,
  // is what launch (a)'s fold left in the chunk's slot of the workspace
  if (c > 0) {
    const long long PN = (long long)P * N;
    for (int jh = 0; jh < HG; ++jh) {
      if (jh > 0) __syncthreads();           // the last head's h_c consumed
      const float4* hc = reinterpret_cast<const float4*>(
          p.ws_state + (((long long)b * p.H + h0 + jh) * p.nc + c) * PN);
      for (int i = tid; i < PN / 4; i += kThr) {
        const float4 v = hc[i];
        const int e = 4 * i, pr = e / N, n = e % N;
        uint32_t t0v[kTerms], t1v[kTerms];
        split_terms(v.x, v.y, t0v);
        split_terms(v.z, v.w, t1v);
#pragma unroll
        for (int k = 0; k < kTerms; ++k)
          *reinterpret_cast<uint2*>(hterm + (k * P + pr) * NS + n) =
              make_uint2(t0v[k], t1v[k]);
      }
      __syncthreads();                       // h_c visible
      if (jq != jh) continue;                // this head's quad only
      float hy[PT][4];
#pragma unroll
      for (int pt = 0; pt < PT; ++pt)
        hy[pt][0] = hy[pt][1] = hy[pt][2] = hy[pt][3] = 0.f;
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, arow + kk * 16);
#pragma unroll
        for (int k = 0; k < kTerms; ++k) {
#pragma unroll
          for (int q = 0; q < PT / 2; ++q) {
            uint32_t bt[4];
            ldsm_x4(bt, hterm + (k * P + q * 16 + (mi >> 1) * 8 + r8) * NS
                            + kk * 16 + (mi & 1) * 8);
            mma_bf16(hy[2 * q], af, bt[0], bt[1]);
            mma_bf16(hy[2 * q + 1], af, bt[2], bt[3]);
          }
        }
      }
      const float el = tl < t_end ? expf((float)cj[tl]) : 0.f;
      const float eh = th < t_end ? expf((float)cj[th]) : 0.f;
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        acc[pt][0] += el * hy[pt][0];
        acc[pt][1] += el * hy[pt][1];
        acc[pt][2] += eh * hy[pt][2];
        acc[pt][3] += eh * hy[pt][3];
      }
    }
  }

  const long long base = b * p.y_sb + (h0 + jq) * p.y_sh + l0 * p.y_sl;
#pragma unroll
  for (int pt = 0; pt < PT; ++pt) {
    const int col = pt * 8 + q2;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int t = rr ? th : tl;
      if (t >= t_end) continue;
      const long long o = base + t * p.y_sl + col;
      const float v0 = acc[pt][2 * rr], v1 = acc[pt][2 * rr + 1];
      if (p.y_bf16) {
        *reinterpret_cast<__nv_bfloat162*>(
            static_cast<__nv_bfloat16*>(p.y) + o) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(p.y) + o) =
            make_float2(v0, v1);
      }
    }
  }
}

// Lets ``kernel`` take up to the whole 227 KB of dynamic shared memory on
// the current device; once per kernel and device (``done`` has a flag per
// device ordinal), as the attribute call costs host time on every launch
template <typename K>
int allow_smem(K kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices && done[dev]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           232448);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return static_cast<int>(e);
}

template <int NT>
int launch_state(const MmaParams& p, int Bsz, int smem, cudaStream_t stream) {
  static bool allowed[kMaxDevices] = {};
  if (const int e = allow_smem(ssd_chunk_state_mma<NT>, allowed)) return e;
  ssd_chunk_state_mma<NT><<<dim3(p.L / p.Q, p.H, Bsz), 32 * (p.P / 16), smem,
                            stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int PT, int HG>
int launch_out(const MmaParams& p, int Bsz, int smem, cudaStream_t stream) {
  static bool allowed[kMaxDevices] = {};
  if (const int e = allow_smem(ssd_chunk_out_mma<PT, HG>, allowed)) return e;
  const dim3 grid(round_up(p.Q, kRows) / kRows * p.nc, p.H / HG, Bsz);
  ssd_chunk_out_mma<PT, HG><<<grid, kMmaThreads * HG, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int PT>
int launch_out_hg(const MmaParams& p, int Bsz, int HG, int smem,
                  cudaStream_t stream) {
  if (HG == 1) return launch_out<PT, 1>(p, Bsz, smem, stream);
  if constexpr (PT * 8 * 4 <= 256) {
    return launch_out<PT, 4>(p, Bsz, smem, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Bytes of shared memory the CUDA-core kernel needs for (P, N, Q).
long long ssd_scan_smem_bytes(int P, int N, int Q) {
  return smem_floats(P, N, Q) * (long long)sizeof(float);
}

// The CUDA-core kernel. Launches on ``stream`` and returns
// cudaGetLastError() (or cudaErrorInvalidValue for sizes the kernel does
// not take). ``strides`` holds 17 element strides: x (b, h, l), dt (b, h,
// l), A (b, h), B (b, h, l), C (b, h, l), y (b, h, l); the last axes of x,
// B, C and y have unit stride. x, B and C share one type (``x_bf16``); dt
// and A are fp32; y is bf16 when ``y_bf16``, else fp32; ``state`` (Bsz*H,
// P, N) fp32 contiguous, or null.
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

// The tensor-core path, bf16 x, B and C: launch (a), then launch (b), on
// ``stream``; returns the first non-zero cudaGetLastError() (or
// cudaErrorInvalidValue for sizes it does not take). ``strides`` as for
// ssd_scan; x, B, C and their b, h and l strides 16-byte aligned. The
// heads of a group of ``head_group`` (1 or 4, dividing H) share B and C:
// their h strides are 0 when head_group is 4. ``smem_a`` and ``smem_b``
// are the launches' shared-memory bytes (the wrapper's mma_smem_bytes).
// Workspaces: ``ws_state`` fp32 (Bsz*H, L/Q, P, N), ``ws_cum`` fp64
// (Bsz*H, L), ``ws_decay`` fp32 (Bsz*H, L/Q); ``counters`` int32 (Bsz*H),
// zero, and left zero by the call.
int ssd_scan_mma(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* state, void* ws_state,
                 void* ws_cum, void* ws_decay, void* counters, int Bsz,
                 int H, int L, int P, int N, int Q, int head_group,
                 const long long* strides, int y_bf16, int smem_a, int smem_b,
                 void* stream) {
  if (Bsz <= 0 || H <= 0 || L <= 0) return 0;
  const int HG = head_group;
  if (P < 16 || P > 128 || P % 16 || N < 16 || N % 16 || P * N > 8192 ||
      Q <= 0 || L % Q || (HG != 1 && HG != 4) || H % HG || HG * P > 256 ||
      (HG > 1 && (strides[9] != 0 || strides[12] != 0)) || smem_a <= 0 ||
      smem_a > 232448 || smem_b <= 0 || smem_b > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  MmaParams p{static_cast<const __nv_bfloat16*>(x),
              static_cast<const float*>(dt), static_cast<const float*>(A),
              static_cast<const __nv_bfloat16*>(Bm),
              static_cast<const __nv_bfloat16*>(Cm), y,
              static_cast<float*>(state), static_cast<float*>(ws_state),
              static_cast<double*>(ws_cum), static_cast<float*>(ws_decay),
              static_cast<int*>(counters), H, L, P, N, Q, L / Q, y_bf16,
              strides[0], strides[1], strides[2], strides[3], strides[4],
              strides[5], strides[6], strides[7], strides[8], strides[9],
              strides[10], strides[11], strides[12], strides[13], strides[14],
              strides[15], strides[16]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e;
  switch (N / 8) {
    case 2: e = launch_state<2>(p, Bsz, smem_a, s); break;
    case 4: e = launch_state<4>(p, Bsz, smem_a, s); break;
    case 6: e = launch_state<6>(p, Bsz, smem_a, s); break;
    case 8: e = launch_state<8>(p, Bsz, smem_a, s); break;
    case 10: e = launch_state<10>(p, Bsz, smem_a, s); break;
    case 12: e = launch_state<12>(p, Bsz, smem_a, s); break;
    case 14: e = launch_state<14>(p, Bsz, smem_a, s); break;
    default: e = launch_state<16>(p, Bsz, smem_a, s); break;
  }
  if (e != 0) return e;
  switch (P / 8) {
    case 2: return launch_out_hg<2>(p, Bsz, HG, smem_b, s);
    case 4: return launch_out_hg<4>(p, Bsz, HG, smem_b, s);
    case 6: return launch_out_hg<6>(p, Bsz, HG, smem_b, s);
    case 8: return launch_out_hg<8>(p, Bsz, HG, smem_b, s);
    case 10: return launch_out_hg<10>(p, Bsz, HG, smem_b, s);
    case 12: return launch_out_hg<12>(p, Bsz, HG, smem_b, s);
    case 14: return launch_out_hg<14>(p, Bsz, HG, smem_b, s);
    default: return launch_out_hg<16>(p, Bsz, HG, smem_b, s);
  }
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
