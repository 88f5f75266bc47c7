// Backward of the Mamba2 SSD chunked scan (csrc/ssd_scan.cu) for Hopper
// (sm_90a). For each sequence row (a (batch, head) pair) and chunk of Q
// steps, with la = dt * A <= 0, cum = cumsum(la) within the chunk, xb = x *
// dt, e_t = exp(cum_t), w_s = exp(cum_Q - cum_s) and, for s <= t only,
// L_ts = exp(cum_t - cum_s), the forward is
//
//     y_t     = sum_{s<=t} (C_t . B_s) L_ts xb_s + e_t h_c C_t
//     h_{c+1} = exp(cum_Q) h_c + sum_s w_s xb_s (x) B_s       (h_0 = 0)
//
// and, for the gradients dy of y and dh of the final state, the backward:
//
//     Hn_c     = the gradient of the state leaving chunk c (Hn_last = dh),
//                Hn_{c-1} = exp(cum_Q) Hn_c + sum_t e_t dy_t (x) C_t
//     dxb_s    = sum_{t>=s} S_ts L_ts dy_t + w_s Hn_c B_s     (S = C B^T)
//     dC_t     = sum_{s<=t} W_ts B_s + e_t dy_t h_c        (W_ts = L_ts dy_t.xb_s)
//     dB_s     = sum_{t>=s} W_ts C_t + w_s xb_s Hn_c
//     dcum_t   = sum_s M_ts - sum_t' M_t't + C_t . (e_t dy_t h_c) - U_t
//                (M = S W, U_s = xb_s . w_s Hn_c B_s), and at the chunk's
//                last step also exp(cum_Q) <Hn_c, h_c> + sum_s U_s
//     dla      = the reverse cumsum of dcum within the chunk
//     ddt      = dla A + dxb . x,   dA = sum dla dt,   dx = dxb dt
//
// Replaces no TPU kernel: the JAX package trains through jax's autodiff of
// the plain ssd_chunked (repro/models/ssm.py:76), whose Pallas forward
// (repro/kernels/ssd_scan.py:_ssd_kernel) has no backward. That autodiff
// takes exp(cum_t - cum_s) over the whole (Q, Q) square before masking it,
// so at chunk 256 and dt near softplus(0) its dt and A gradients are NaN;
// here, as in the plain backward (ssd_scan.py:ssd_scan_bwd_ref), no
// exponent is positive: L_ts is taken for s <= t only, off the diagonal
// tiles as exp(cum_t - r) exp(r - cum_s) with r between t and s.
//
// Two routes, chosen by the wrapper (ssd_scan.py:bwd_plan); neither uses
// atomics, so a rerun is bit-equal.
//
// The tensor route: bf16 x, B and C at the models' (P, N), (64, 128),
// (64, 16) and (32, 16). Five launches in stream order:
//   (1') ssd_bwd_states_mma, blocks (2 nc, H, B) of P / 16 warps: a chunk's
//        own state sum_s (x_s dt_s w_s)^T B_s (and its fp64 cumsum and
//        exp(cum_Q), kept for (3')), or its own state gradient sum_t (dy_t
//        e_t)^T C_t (and dy's bf16 terms, kept for (3')), the chunk's rows
//        64 at a time by cp.async in a ring of two stages;
//   (2)  ssd_bwd_fold, as the CUDA-core route's;
//   (3') ssd_bwd_tiles_mma, a block of 4 warps per (b, h, chunk, 64-row
//        tile) for each of two sides in one grid, heaviest tiles first, as
//        the flash backward splits its key and query tiles
//        (flash_attention_bwd.cu): a (3s) block walks the t-tiles from its
//        s-tile's diagonal down and sums dxb_s and dB_s in registers, plus
//        the column sums of M, U_s and the state terms, and writes dx and
//        dxb . x; a (3t) block walks the s-tiles up to its t-tile's
//        diagonal and sums dC_t in registers, plus the row sums of M and
//        the state term e_t dy_t h_c. S and D = dy xb^T are recomputed by
//        each side, as the flash backward recomputes its scores. Each
//        writes its per-head rows and per-step sums once, into the
//        workspace; nothing is read back and written again;
//   (4') ssd_bwd_scan, a warp per (b, h, chunk): dcum, dla's fp64 reverse
//        scan, ddt and the chunk's share of dA;
//   (5)  ssd_bwd_reduce, as the CUDA-core route's: dB and dC over the
//        heads in head order, dA over the chunks in order.
// Every product is mma.sync m16n8k16, bf16 in and fp32 accumulate, from
// padded shared rows by ldmatrix (the forward's layouts). x, B and C
// enter exactly (they are bf16); each fp32 factor enters as kTerms = 2
// bf16 terms, t0 = bf16(v), t1 = bf16(v - t0): dy (in D, G^T dy and dy
// h_c), the tiles G and W (converted in registers from the accumulators
// that computed them, which are the next product's A fragments), the
// states h_c and Hn_c, and (1')'s scaled rows; a product of two fp32
// factors (G^T dy, dy h_c) takes the cross terms t0 u0 + t0 u1 + t1 u0.
// The counts come from a plain-torch model of this route
// (tests/test_torch_ssd_bwd_chunks.py): two terms leave each gradient
// within about 1e-5 of its largest entry against fp64 at mamba2's and
// jamba's shapes, 200 times inside the 2e-3 bound; one term (bf16 once)
// breaks that bound at both; 3xTF32 for the two-factor products is no
// more accurate and runs the tensor cores at half the bf16 rate. The
// elementwise factors (L, G, W, M), the sums of M, the reverse scan, ddt
// and dA stay in fp32 and fp64. C B^T is computed once per head and tile
// pair, not shared by a head group: taking its products out of (3') saves
// 0.028 ms of the launch's 0.194 at mamba2's shape and 0.004 of 0.562 at
// jamba's on an H100, so a group of two or four heads would save at most
// half to three quarters of that, and it needs the group's x and dy tiles
// resident, 36-80 KB more a block at mamba2's widths (PERF.md).
// What bounds the route now: latency. At mamba2's shape (B 4, L 512, 24
// heads, P 64, N 128, Q 256) it takes 0.266 ms on an H100 (700 W), 3.0x
// the function's bound (0.087 ms, its fp32 operations) and 10x its own
// 25 GFLOP of bf16 products at the tensor-core rate; the tile launch
// holds two blocks of 4 warps an SM (255 registers a thread, 102,912
// bytes of shared memory a block; three at N 16, where the launch
// bounds cap the registers), each warp's products a chain of ldmatrix,
// mma and the elementwise terms between them. What the design does
// about it: every tile product's A fragment is the accumulator of the
// product before it, split into terms in registers, so no (t, s) tile
// goes through shared memory; the next tile's rows load by cp.async
// while one computes; the heaviest tiles start first.
//
// The CUDA-core route: fp32 operands, and bf16 at other (P, N). Four
// launches, fp32 FMAs:
//   (1) ssd_bwd_states, a block per (b, h, chunk): the chunk's fp64
//       cumsum, its own state and own state gradient, and exp(cum_Q);
//   (2) ssd_bwd_fold, a thread per (b, h, state entry): the states entering
//       each chunk (forward, in chunk order) and Hn_c (backward, in reverse
//       chunk order), each written in place of the chunk's own sums;
//   (3) ssd_bwd_chunk, a block of 512 threads per (b, h, chunk) (half the
//       rows a thread, so its accumulators stay in registers at N 128, and
//       16 warps an SM to hide the loads): the intra-chunk terms over 64 x
//       64 tiles of (t, s) at or below the diagonal, for each s-tile (dxb_s,
//       dB_s in registers) the t-tiles from it down; dC_t kept in an fp32
//       workspace that the block alone reads and writes; the state terms
//       from h_c and Hn_c in shared memory; row and column sums of M in a
//       fixed order; then dla by a warp's fp64 reverse scan, ddt, dx, and
//       the chunk's share of dA;
//   (4) ssd_bwd_reduce: dB and dC summed over the heads in head order where
//       the heads share B and C (the model's case: one (B, L, N) gradient,
//       never an (B, H, L, N) one for autograd to sum), else cast per head;
//       dA summed over the chunks in order.
//   Every product is a loop of fp32 FMAs over shared memory, a thread
//   owning one column and the rows a block-stride apart (shared rows
//   padded to an odd length).
//
// Shapes: the CUDA-core route takes P and N powers of two in [4, 128] with
// P * N <= 8192 and its chunk launch's shared memory within 227 KB
// (mamba2's P 64, N 128, Q 256: 225,800 bytes); the tensor route any Q
// with L % Q == 0 (ragged 64-row tiles zero-filled and masked). Operands
// are strided views with unit stride on the last axis (x (B, H, L, P), dt
// (B, H, L), A (B, H), B/C (B, H, L, N), h stride 0 where the heads share
// them), so the model's layouts go in without a copy; dx and ddt are
// written through strides too.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                  // launches (1), (2) and (4)
constexpr int kChunkThreads = 512;             // launch (3)
constexpr int kTile = 64;                      // t and s rows per tile
constexpr int kLdT = kTile + 1;                // padded row of a (t, s) tile
constexpr int kMaxEntries = 8192 / kThreads;   // state entries per thread
constexpr int kTileOut = kTile * kTile / kChunkThreads;  // per thread
constexpr int kHeadLoads = 8;                  // launch (4): heads' loads at once

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

struct BwdParams {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* dy;
  const float* dh;                           // nullptr: zero
  void* dx;
  float* ddt;
  void* dB;                                  // (Bsz, Hout, L, N) contiguous
  void* dC;
  float* dA;                                 // (Bsz, H) contiguous
  float* ws_state;                           // (BH, nc, P, N)
  float* ws_dstate;                          // (BH, nc, P, N)
  float* ws_decay;                           // (BH, nc)
  float* ws_dA;                              // (BH, nc)
  float* ws_dB;                              // (BH, L, N)
  float* ws_dC;                              // (BH, L, N)
  double* ws_cum;                            // tensor route: (BH, L) cumsums
  __nv_bfloat16* ws_dyt;                     // (BH, L, kTerms, P) dy's terms
  float* ws_rs;                              // (BH, L) row sums of M + ...
  float* ws_cs;                              // (BH, L) column sums of M
  float* ws_u;                               // (BH, L) U
  float* ws_xd;                              // (BH, L) dxb . x
  float* ws_hh;                              // (BH, nc) <Hn_c, h_c>
  int Bsz, H, Hout, L, P, N, Q, nc, lgP, lgN;
  long long x_sb, x_sh, x_sl;
  long long dt_sb, dt_sh, dt_sl;
  long long a_sb, a_sh;
  long long b_sb, b_sh, b_sl;
  long long c_sb, c_sh, c_sl;
  long long dy_sb, dy_sh, dy_sl;
  long long dx_sb, dx_sh, dx_sl;
  long long ddt_sb, ddt_sh, ddt_sl;
};

// cum[i] = a * sum_{j<=i} dtc[j] in fp64 by one warp (as in ssd_scan.cu):
// a serial sum over each lane's segment, then a shuffle scan of the sums.
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

// acc[i] += sum_{j<J} A(r_i, j) B(j, k) with A(r, j) = A[r * ar + j * aj]
// and B(j, k) = B[j * bj + k * bk]: this thread's outputs are column k =
// tid mod K (K a power of two dividing kChunkThreads) and rows r_i = tid /
// K + i * (kChunkThreads / K) below R, so B(j, k) is loaded once for all.
template <int MR>
__device__ __forceinline__ void mm(float (&acc)[MR], int R, int lgK, int J,
                                   const float* A, int ar, int aj,
                                   const float* B, int bj, int bk) {
  const int k = threadIdx.x & ((1 << lgK) - 1);
  const int r0 = threadIdx.x >> lgK, rs = kChunkThreads >> lgK;
  const float* Bp = B + k * bk;
  const float* Ap = A + r0 * ar;
  // four j at a time: their loads in flight together (unrolled further,
  // or fully, the accumulators spill past the 128 registers a thread of
  // a 512-thread block has)
#pragma unroll 4
  for (int j = 0; j < J; ++j) {
    const float bv = Bp[j * bj];
#pragma unroll
    for (int i = 0; i < MR; ++i)
      if (r0 + i * rs < R) acc[i] += Ap[i * rs * ar + j * aj] * bv;
  }
}

// Bytes of shared memory of launch (1) and launch (3).
__host__ __device__ inline long long states_smem_bytes(int P, int N, int Q) {
  return 8LL * Q + 12LL * Q + 4LL * kTile * (2 * P + 2 * N);
}
__host__ __device__ inline long long chunk_smem_bytes(int P, int N, int Q) {
  return 8LL * Q                             // cum (fp64)
         + 4LL * (6 * Q + kChunkThreads + kTile + 2)  // dtc fe fw rsum
                                                       // csum xdot, red,
                                                       // u, scalars
         + 4LL * 2 * P * (N + 1)             // h_c, Hn_c
         + 4LL * 2 * kTile * (N + 1)         // B (s rows), C (t rows)
         + 4LL * 2 * kTile * (P + 1)         // xb (s rows), dy (t rows)
         + 4LL * 3 * kTile * kLdT;           // G, W, M (and scratch)
}

template <typename TX>
__global__ void __launch_bounds__(kThreads) ssd_bwd_states(BwdParams p) {
  extern __shared__ float4 smem4[];
  const int P = p.P, N = p.N, Q = p.Q, PN = P * N;
  double* cum = reinterpret_cast<double*>(smem4);
  float* dtc = reinterpret_cast<float*>(cum + Q);
  float* fw = dtc + Q;                       // dt_s exp(cum_Q - cum_s)
  float* fe = fw + Q;                        // exp(cum_t)
  float* xs = fe + Q;                        // x_s dt_s w_s   (kTile x P)
  float* bs = xs + kTile * P;                // B_s            (kTile x N)
  float* ys = bs + kTile * N;                // dy_t e_t       (kTile x P)
  float* cs = ys + kTile * P;                // C_t            (kTile x N)

  const int bid = blockIdx.x, bh = bid / p.nc, c = bid % p.nc;
  const int b = bh / p.H, hh = bh % p.H, l0 = c * Q, tid = threadIdx.x;
  const TX* x = static_cast<const TX*>(p.x) + b * p.x_sb + hh * p.x_sh;
  const float* dt = p.dt + b * p.dt_sb + hh * p.dt_sh;
  const TX* Bm = static_cast<const TX*>(p.Bm) + b * p.b_sb + hh * p.b_sh;
  const TX* Cm = static_cast<const TX*>(p.Cm) + b * p.c_sb + hh * p.c_sh;
  const float* dy = p.dy + b * p.dy_sb + hh * p.dy_sh;
  const float a = p.A[b * p.a_sb + hh * p.a_sh];

  for (int i = tid; i < Q; i += kThreads) dtc[i] = dt[(l0 + i) * p.dt_sl];
  __syncthreads();
  if (tid < 32) chunk_cumsum(dtc, cum, Q, a, tid);
  __syncthreads();
  const double last = cum[Q - 1];
  for (int i = tid; i < Q; i += kThreads) {
    fw[i] = dtc[i] * expf((float)(last - cum[i]));
    fe[i] = expf((float)cum[i]);
  }

  float acc_s[kMaxEntries], acc_d[kMaxEntries];
#pragma unroll
  for (int j = 0; j < kMaxEntries; ++j) acc_s[j] = acc_d[j] = 0.f;
  for (int s0 = 0; s0 < Q; s0 += kTile) {
    const int ns = min(kTile, Q - s0);
    __syncthreads();                         // fw/fe ready; last tile read
    for (int i = tid; i < ns * P; i += kThreads) {
      const int s = i >> p.lgP, q = i & (P - 1);
      const long long l = l0 + s0 + s;
      xs[i] = to_f32(x[l * p.x_sl + q]) * fw[s0 + s];
      ys[i] = dy[l * p.dy_sl + q] * fe[s0 + s];
    }
    for (int i = tid; i < ns * N; i += kThreads) {
      const int s = i >> p.lgN, n = i & (N - 1);
      const long long l = l0 + s0 + s;
      bs[i] = to_f32(Bm[l * p.b_sl + n]);
      cs[i] = to_f32(Cm[l * p.c_sl + n]);
    }
    __syncthreads();
    for (int s = 0; s < ns; ++s) {
#pragma unroll
      for (int j = 0; j < kMaxEntries; ++j) {
        const int e = tid + j * kThreads;
        if (e < PN) {
          const int q = e >> p.lgN, n = e & (N - 1);
          acc_s[j] += xs[s * P + q] * bs[s * N + n];
          acc_d[j] += ys[s * P + q] * cs[s * N + n];
        }
      }
    }
  }
  float* st = p.ws_state + (long long)bid * PN;
  float* ds = p.ws_dstate + (long long)bid * PN;
#pragma unroll
  for (int j = 0; j < kMaxEntries; ++j) {
    const int e = tid + j * kThreads;
    if (e < PN) {
      st[e] = acc_s[j];
      ds[e] = acc_d[j];
    }
  }
  if (tid == 0) p.ws_decay[bid] = expf((float)last);
}

__global__ void __launch_bounds__(kThreads) ssd_bwd_fold(BwdParams p) {
  const int PN = p.P * p.N, nc = p.nc;
  const int bh = blockIdx.x, e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= PN) return;
  float* st = p.ws_state + (long long)bh * nc * PN + e;
  float* ds = p.ws_dstate + (long long)bh * nc * PN + e;
  const float* dec = p.ws_decay + (long long)bh * nc;
  // each chunk's own sum loaded before the slot before it is written, so
  // the loads of a row are in flight together
  float h = 0.f, own = st[0];
  for (int c = 0; c < nc; ++c) {             // states entering each chunk
    const float next = c + 1 < nc ? st[(long long)(c + 1) * PN] : 0.f;
    st[(long long)c * PN] = h;
    h = dec[c] * h + own;
    own = next;
  }
  float g = p.dh != nullptr ? p.dh[(long long)bh * PN + e] : 0.f;
  own = ds[(long long)(nc - 1) * PN];
  for (int c = nc - 1; c >= 0; --c) {        // gradients of states leaving
    const float next = c > 0 ? ds[(long long)(c - 1) * PN] : 0.f;
    ds[(long long)c * PN] = g;
    g = dec[c] * g + own;
    own = next;
  }
}

template <typename TX, int MR>
__global__ void __launch_bounds__(kChunkThreads) ssd_bwd_chunk(BwdParams p) {
  extern __shared__ float4 smem4[];
  const int P = p.P, N = p.N, Q = p.Q, PN = P * N;
  const int lgP = p.lgP, lgN = p.lgN, ldP = P + 1, ldN = N + 1;
  double* cum = reinterpret_cast<double*>(smem4);
  float* dtc = reinterpret_cast<float*>(cum + Q);
  float* fe = dtc + Q;                       // exp(cum_t)
  float* fw = fe + Q;                        // exp(cum_Q - cum_s)
  float* rsum = fw + Q;                      // row sums of M + inter terms
  float* csum = rsum + Q;                    // column sums of M + U
  float* xdot = csum + Q;                    // dxb_s . x_s
  float* red = xdot + Q;                     // kChunkThreads partial sums
  float* uu = red + kChunkThreads;           // U_s of an s-tile
  float* scal = uu + kTile;                  // <Hn, h>, sum of U
  float* h = scal + 2;                       // h_c   [q][n], row ldN
  float* hn = h + P * ldN;                   // Hn_c  [q][n], row ldN
  float* bs = hn + P * ldN;                  // B_s   [s][n]
  float* cs = bs + kTile * ldN;              // C_t   [t][n]
  float* xbs = cs + kTile * ldN;             // xb_s  [s][q]
  float* dys = xbs + kTile * ldP;            // dy_t  [t][q]
  float* Wt = dys + kTile * ldP;             // W     [t][s]
  float* Gt = Wt + kTile * kLdT;             // G     [t][s]
  float* Mt = Gt + kTile * kLdT;             // M     [t][s]
  float* scratch = Gt;                       // row sums' operands (G, M)

  const int bid = blockIdx.x, bh = bid / p.nc, c = bid % p.nc;
  const int b = bh / p.H, hh = bh % p.H, l0 = c * Q, tid = threadIdx.x;
  const TX* x = static_cast<const TX*>(p.x) + b * p.x_sb + hh * p.x_sh;
  const float* dt = p.dt + b * p.dt_sb + hh * p.dt_sh;
  const TX* Bm = static_cast<const TX*>(p.Bm) + b * p.b_sb + hh * p.b_sh;
  const TX* Cm = static_cast<const TX*>(p.Cm) + b * p.c_sb + hh * p.c_sh;
  const float* dy = p.dy + b * p.dy_sb + hh * p.dy_sh;
  TX* dx = static_cast<TX*>(p.dx) + b * p.dx_sb + hh * p.dx_sh;
  float* ddt = p.ddt + b * p.ddt_sb + hh * p.ddt_sh;
  float* wsB = p.ws_dB + (long long)bh * p.L * N;
  float* wsC = p.ws_dC + (long long)bh * p.L * N;
  const float a = p.A[b * p.a_sb + hh * p.a_sh];

  for (int i = tid; i < Q; i += kChunkThreads)
    dtc[i] = dt[(l0 + i) * p.dt_sl];
  for (int e = tid; e < PN; e += kChunkThreads) {
    const int q = e >> lgN, n = e & (N - 1);
    h[q * ldN + n] = p.ws_state[(long long)bid * PN + e];
    hn[q * ldN + n] = p.ws_dstate[(long long)bid * PN + e];
  }
  __syncthreads();
  if (tid < 32) chunk_cumsum(dtc, cum, Q, a, tid);
  float part = 0.f;
  for (int e = tid; e < PN; e += kChunkThreads) {
    const int o = (e >> lgN) * ldN + (e & (N - 1));
    part += hn[o] * h[o];
  }
  red[tid] = part;
  __syncthreads();
  const double last = cum[Q - 1];
  for (int i = tid; i < Q; i += kChunkThreads) {
    fe[i] = expf((float)cum[i]);
    fw[i] = expf((float)(last - cum[i]));
    rsum[i] = 0.f;
    csum[i] = 0.f;
  }
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < kChunkThreads; ++i) s += red[i];
    scal[0] = s;
    scal[1] = 0.f;
  }

  // this thread's columns and first rows for P-wide, N-wide and tile outputs
  const int kP = tid & (P - 1), rP = tid >> lgP, sP = kChunkThreads >> lgP;
  const int kN = tid & (N - 1), rN = tid >> lgN, sN = kChunkThreads >> lgN;
  const int kT = tid & (kTile - 1), rT = tid / kTile;
  const int sT = kChunkThreads / kTile;

  for (int s0 = 0; s0 < Q; s0 += kTile) {
    const int ns = min(kTile, Q - s0);
    __syncthreads();
    for (int i = tid; i < kTile * N; i += kChunkThreads) {
      const int s = i >> lgN, n = i & (N - 1);
      bs[s * ldN + n] =
          s < ns ? to_f32(Bm[(long long)(l0 + s0 + s) * p.b_sl + n]) : 0.f;
    }
    for (int i = tid; i < kTile * P; i += kChunkThreads) {
      const int s = i >> lgP, q = i & (P - 1);
      xbs[s * ldP + q] =
          s < ns ? to_f32(x[(long long)(l0 + s0 + s) * p.x_sl + q]) *
                       dtc[s0 + s]
                 : 0.f;
    }
    __syncthreads();
    // the state terms: w_s Hn B_s and w_s xb_s Hn
    float dxb[MR], dbv[MR];
#pragma unroll
    for (int i = 0; i < MR; ++i) dxb[i] = dbv[i] = 0.f;
    mm(dxb, kTile, lgP, N, bs, ldN, 1, hn, 1, ldN);
    mm(dbv, kTile, lgN, P, xbs, ldP, 1, hn, ldN, 1);
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const int rp = rP + i * sP, rn = rN + i * sN;
      if (rp < kTile) {
        dxb[i] *= rp < ns ? fw[s0 + rp] : 0.f;
        scratch[rp * ldP + kP] = xbs[rp * ldP + kP] * dxb[i];
      }
      if (rn < kTile) dbv[i] *= rn < ns ? fw[s0 + rn] : 0.f;
    }
    __syncthreads();
    if (tid < ns) {
      float u = 0.f;
      for (int q = 0; q < P; ++q) u += scratch[tid * ldP + q];
      uu[tid] = u;
      csum[s0 + tid] += u;
    }
    __syncthreads();
    if (tid == 0) {
      float u = scal[1];
      for (int s = 0; s < ns; ++s) u += uu[s];
      scal[1] = u;
    }

    for (int t0 = s0; t0 < Q; t0 += kTile) {
      const int nt = min(kTile, Q - t0);
      for (int i = tid; i < kTile * N; i += kChunkThreads) {
        const int t = i >> lgN, n = i & (N - 1);
        cs[t * ldN + n] =
            t < nt ? to_f32(Cm[(long long)(l0 + t0 + t) * p.c_sl + n]) : 0.f;
      }
      for (int i = tid; i < kTile * P; i += kChunkThreads) {
        const int t = i >> lgP, q = i & (P - 1);
        dys[t * ldP + q] =
            t < nt ? dy[(long long)(l0 + t0 + t) * p.dy_sl + q] : 0.f;
      }
      __syncthreads();
      {  // the (t, s) tile: S = C B^T, D = dy xb^T, then G, W and M
        float sc[kTileOut], dc[kTileOut];
#pragma unroll
        for (int i = 0; i < kTileOut; ++i) sc[i] = dc[i] = 0.f;
        mm(sc, kTile, 6, N, cs, ldN, 1, bs, 1, ldN);
        mm(dc, kTile, 6, P, dys, ldP, 1, xbs, 1, ldP);
#pragma unroll
        for (int i = 0; i < kTileOut; ++i) {
          const int t = rT + i * sT, s = kT;
          // never exp(cum_t - cum_s) for s > t: it may overflow
          const bool live = t < nt && s < ns && s0 + s <= t0 + t;
          const float l =
              live ? expf((float)(cum[t0 + t] - cum[s0 + s])) : 0.f;
          const float g = sc[i] * l, wv = l * dc[i];
          Gt[t * kLdT + s] = g;
          Wt[t * kLdT + s] = wv;
          Mt[t * kLdT + s] = g * dc[i];
        }
      }
      __syncthreads();
      mm(dxb, kTile, lgP, nt, Gt, 1, kLdT, dys, ldP, 1);
      mm(dbv, kTile, lgN, nt, Wt, 1, kLdT, cs, ldN, 1);
      if (tid < kTile) {
        if (tid < nt) {
          float v = 0.f;
          for (int s = 0; s < ns; ++s) v += Mt[tid * kLdT + s];
          rsum[t0 + tid] += v;
        }
      } else if (tid < 2 * kTile) {
        const int s = tid - kTile;
        if (s < ns) {
          float v = 0.f;
          for (int t = 0; t < nt; ++t) v += Mt[t * kLdT + s];
          csum[s0 + s] += v;
        }
      }
      // dC_t: the score tiles are dead here, so its accumulators never
      // share the registers with theirs
      float dcv[MR];
#pragma unroll
      for (int i = 0; i < MR; ++i) dcv[i] = 0.f;
      if (s0 == 0) {
        // first visit of this t-tile: e_t dy_t h_c, and C_t . that; G and
        // M have been read, so their rows hold the products
        __syncthreads();
        mm(dcv, kTile, lgN, P, dys, ldP, 1, h, ldN, 1);
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          const int rn = rN + i * sN;
          if (rn < kTile) {
            dcv[i] *= rn < nt ? fe[t0 + rn] : 0.f;
            scratch[rn * ldN + kN] = dcv[i] * cs[rn * ldN + kN];
          }
        }
        __syncthreads();
        if (tid < nt) {
          float v = 0.f;
          for (int n = 0; n < N; ++n) v += scratch[tid * ldN + n];
          rsum[t0 + tid] += v;
        }
      } else {
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          const int rn = rN + i * sN;
          if (rn < nt) dcv[i] = wsC[(long long)(l0 + t0 + rn) * N + kN];
        }
      }
      mm(dcv, kTile, lgN, ns, Wt, kLdT, 1, bs, ldN, 1);
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const int rn = rN + i * sN;
        if (rn < nt) wsC[(long long)(l0 + t0 + rn) * N + kN] = dcv[i];
      }
      __syncthreads();
    }

    // this s-tile's dxb and dB are whole: dx, dxb . x, and dB per head
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const int rp = rP + i * sP, rn = rN + i * sN;
      if (rp < ns) {
        const long long l = l0 + s0 + rp;
        dx[l * p.dx_sl + kP] = from_f32<TX>(dxb[i] * dtc[s0 + rp]);
        scratch[rp * ldP + kP] = dxb[i] * to_f32(x[l * p.x_sl + kP]);
      }
      if (rn < ns) wsB[(long long)(l0 + s0 + rn) * N + kN] = dbv[i];
    }
    __syncthreads();
    if (tid < ns) {
      float v = 0.f;
      for (int q = 0; q < P; ++q) v += scratch[tid * ldP + q];
      xdot[s0 + tid] = v;
    }
  }
  __syncthreads();

  // dla = reverse cumsum of dcum in fp64 by one warp: each lane's segment
  // summed from its end, then a shuffle scan of the later lanes' sums
  if (tid < 32) {
    const int lane = tid, per = (Q + 31) / 32;
    const int lo = min(lane * per, Q), hi = min(lo + per, Q);
    const double xterm = (double)expf((float)last) * scal[0] + scal[1];
    auto dcum = [&](int t) {
      return (double)rsum[t] - (double)csum[t] + (t == Q - 1 ? xterm : 0.0);
    };
    double seg = 0.0;
    for (int t = hi - 1; t >= lo; --t) seg += dcum(t);
    double incl = seg;                       // sum of lanes >= this one
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += o;
    }
    double run = incl - seg;                 // lanes after this one
    double da = 0.0;
    for (int t = hi - 1; t >= lo; --t) {
      run += dcum(t);
      ddt[(long long)(l0 + t) * p.ddt_sl] = (float)(run * a) + xdot[t];
      da += run * dtc[t];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      da += __shfl_xor_sync(0xffffffffu, da, off);
    if (lane == 0) p.ws_dA[bid] = (float)da;
  }
}

template <typename TX>
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce(BwdParams p) {
  const long long LN = (long long)p.L * p.N;
  const long long total = (long long)p.Bsz * p.Hout * LN;
  const int per = p.H / p.Hout;              // heads summed per output
  TX* dB = static_cast<TX*>(p.dB);
  TX* dC = static_cast<TX*>(p.dC);
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kThreads) {
    const long long ln = i % LN, bo = i / LN;
    const long long first = (bo / p.Hout) * p.H + (bo % p.Hout) * per;
    float sb = 0.f, sc = 0.f;
    int k = 0;
    for (; k + kHeadLoads <= per; k += kHeadLoads) {
      // kHeadLoads heads' loads in flight together, added in head order
      float vb[kHeadLoads], vc[kHeadLoads];
#pragma unroll
      for (int u = 0; u < kHeadLoads; ++u) {
        vb[u] = p.ws_dB[(first + k + u) * LN + ln];
        vc[u] = p.ws_dC[(first + k + u) * LN + ln];
      }
#pragma unroll
      for (int u = 0; u < kHeadLoads; ++u) {
        sb += vb[u];
        sc += vc[u];
      }
    }
    for (; k < per; ++k) {                   // in head order
      sb += p.ws_dB[(first + k) * LN + ln];
      sc += p.ws_dC[(first + k) * LN + ln];
    }
    dB[i] = from_f32<TX>(sb);
    dC[i] = from_f32<TX>(sc);
  }
  const long long BH = (long long)p.Bsz * p.H;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < BH;
       i += (long long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int c = 0; c < p.nc; ++c) s += p.ws_dA[i * p.nc + c];
    p.dA[i] = s;
  }
}

// -- the tensor-core route ------------------------------------------------------

constexpr int kMmaThreads = 128;             // launch (3'): 4 warps of 16 rows
constexpr int kRows = 64;                    // rows of a t- or s-tile
constexpr int kPad = 8;                      // bf16 padding of a smem row
constexpr int kTerms = 2;                    // bf16 terms of an fp32 factor
constexpr int kMaxDevices = 64;

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

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
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
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

// (v0, v1) as kTerms packed bf16 pairs: t[0] = bf16(v), t[1] = bf16(v -
// t[0]); each difference is exact in fp32
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

// An accumulator tile's 16 x 16 block (n-tiles lo and lo + 1) as the
// terms of an A fragment of the next product, whose k is that tile's n
__device__ __forceinline__ void a_terms(const float (&lo)[4],
                                        const float (&hi)[4],
                                        uint32_t (&a)[kTerms][4]) {
  uint32_t t[kTerms];
  split_terms(lo[0], lo[1], t);
#pragma unroll
  for (int k = 0; k < kTerms; ++k) a[k][0] = t[k];
  split_terms(lo[2], lo[3], t);
#pragma unroll
  for (int k = 0; k < kTerms; ++k) a[k][1] = t[k];
  split_terms(hi[0], hi[1], t);
#pragma unroll
  for (int k = 0; k < kTerms; ++k) a[k][2] = t[k];
  split_terms(hi[2], hi[3], t);
#pragma unroll
  for (int k = 0; k < kTerms; ++k) a[k][3] = t[k];
}

// The warp's index, as a value the compiler knows is the same across the
// warp
__device__ __forceinline__ int warp_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 5, 0);
}

// Sum of the four lanes of a quad (the lanes holding one row of an
// accumulator tile), the same order on every lane
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The tensor route's workspace, carved in this order from one allocation
// (each region starting on 16 bytes); null ``ws`` only sizes it
__host__ __device__ inline long long align16(long long v) {
  return (v + 15) / 16 * 16;
}
inline long long carve(void* ws, int Bsz, int H, int L, int P, int N,
                       int Q, int mma, BwdParams* p) {
  const long long BH = (long long)Bsz * H, nc = L / Q;
  const long long sizes[] = {
      4 * BH * nc * P * N, 4 * BH * nc * P * N, 4 * BH * nc, 4 * BH * nc,
      4 * BH * L * N, 4 * BH * L * N,
      mma ? 8 * BH * L : 0,                  // cumsums (fp64)
      mma ? 2LL * kTerms * BH * L * P : 0,   // dy's terms (bf16)
      mma ? 4 * 4 * BH * L : 0,              // per-row sums
      mma ? 4 * BH * nc : 0};                // <Hn_c, h_c>
  char* base = static_cast<char*>(ws);
  char* at[10];
  long long off = 0;
  for (int i = 0; i < 10; ++i) {
    at[i] = base + off;
    off += align16(sizes[i]);
  }
  if (p != nullptr) {
    p->ws_state = reinterpret_cast<float*>(at[0]);
    p->ws_dstate = reinterpret_cast<float*>(at[1]);
    p->ws_decay = reinterpret_cast<float*>(at[2]);
    p->ws_dA = reinterpret_cast<float*>(at[3]);
    p->ws_dB = reinterpret_cast<float*>(at[4]);
    p->ws_dC = reinterpret_cast<float*>(at[5]);
    p->ws_cum = reinterpret_cast<double*>(at[6]);
    p->ws_dyt = reinterpret_cast<__nv_bfloat16*>(at[7]);
    p->ws_rs = reinterpret_cast<float*>(at[8]);
    p->ws_cs = p->ws_rs + BH * L;
    p->ws_u = p->ws_cs + BH * L;
    p->ws_xd = p->ws_u + BH * L;
    p->ws_hh = reinterpret_cast<float*>(at[9]);
  }
  return off;
}

// Bytes of one stage of launch (1'): the larger of an own block's x and B
// rows and a down block's dy (fp32, rows of P + 4) and C rows, 64 each
__host__ __device__ inline long long states_stage_bytes(int P, int N) {
  const long long own = 2LL * kRows * (P + kPad) + 2LL * kRows * (N + kPad);
  const long long down = 4LL * kRows * (P + 4) + 2LL * kRows * (N + kPad);
  return own > down ? own : down;
}
// Bytes of shared memory of launch (1'): two stages, the cumsum (fp64),
// dt and a row factor per step
__host__ __device__ inline long long states_mma_smem_bytes(int P, int N,
                                                           int Q) {
  return 2 * states_stage_bytes(P, N) + 16LL * round_up(Q, kRows);
}
// Bytes of shared memory of launch (3'): the larger of the (3s) blocks'
// x and B rows of the s-tile and two stages of C rows and dy's terms of a
// t-tile, and the (3t) blocks' C rows and dy's terms of the t-tile and
// two stages of B and x rows of an s-tile; then the chunk's cumsum
// (fp64), dt and a factor per step, and a block's partial sums
__host__ __device__ inline long long s_side_bytes(int P, int N) {
  return 2LL * kRows * (P + kPad) + 2LL * kRows * (N + kPad) +
         2 * (2LL * kRows * (N + kPad) + 2LL * kTerms * kRows * (P + kPad));
}
__host__ __device__ inline long long t_side_bytes(int P, int N) {
  return 2LL * kRows * (N + kPad) + 2LL * kTerms * kRows * (P + kPad) +
         2 * (2LL * kRows * (N + kPad) + 2LL * kRows * (P + kPad));
}
__host__ __device__ inline long long side_bytes(int P, int N) {
  const long long s = s_side_bytes(P, N), t = t_side_bytes(P, N);
  return s > t ? s : t;
}
__host__ __device__ inline long long tiles_mma_smem_bytes(int P, int N,
                                                          int Q) {
  return side_bytes(P, N) + 16LL * round_up(Q, kRows) + 4LL * kMmaThreads;
}

// Launch (1'): blocks (2 nc, H, Bsz), P / 16 warps of 16 state rows p.
// Block x < nc: chunk x's own state sum_s (x_s dt_s w_s)^T B_s, its fp64
// cumsum (kept for (3')) and exp(cum_Q); block nc + c: chunk c's own state
// gradient sum_t (dy_t e_t)^T C_t, and dy's kTerms bf16 terms for (3').
// The chunk's rows arrive 64 at a time in a ring of two stages; each
// scaled row enters its product as kTerms terms.
template <int P, int N>
__global__ void __launch_bounds__(2 * P) ssd_bwd_states_mma(BwdParams p) {
  extern __shared__ float4 smem4[];
  constexpr int PS = P + kPad, NS = N + kPad, YS = P + 4, NT = N / 8;
  constexpr int kThr = 2 * P;
  const int Q = p.Q, nc = p.nc, Qp = round_up(Q, kRows), nj = Qp / kRows;
  const bool down = static_cast<int>(blockIdx.x) >= nc;
  const int c = down ? blockIdx.x - nc : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * p.H + h;
  const long long stage = states_stage_bytes(P, N);
  char* ring = reinterpret_cast<char*>(smem4);
  double* cum = reinterpret_cast<double*>(ring + 2 * stage);   // [Qp]
  float* dtc = reinterpret_cast<float*>(cum + Qp);              // [Qp]
  float* f = dtc + Qp;        // own: dt_s exp(cum_Q - cum_s); down: exp(cum_t)

  const int tid = threadIdx.x, lane = tid & 31, warp = warp_index();
  const int mi = lane >> 3, r8 = lane & 7, g = lane >> 2, q2 = 2 * (lane & 3);
  const long long l0 = (long long)c * Q;
  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(p.x) +
                            b * p.x_sb + h * p.x_sh + l0 * p.x_sl;
  const __nv_bfloat16* bg = static_cast<const __nv_bfloat16*>(p.Bm) +
                            b * p.b_sb + h * p.b_sh + l0 * p.b_sl;
  const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(p.Cm) +
                            b * p.c_sb + h * p.c_sh + l0 * p.c_sl;
  const float* yg = p.dy + b * p.dy_sb + h * p.dy_sh + l0 * p.dy_sl;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh + l0 * p.dt_sl;
  const float a = p.A[b * p.a_sb + h * p.a_sh];

  auto issue = [&](int j) {                  // rows 64 j..: x and B, or dy and C
    char* st = ring + (j & 1) * stage;
    const int r0 = j * kRows;
    __nv_bfloat16* rest;
    const __nv_bfloat16* rg;
    long long rsl;
    if (!down) {
      __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st);
      for (int i = tid; i < kRows * (P / 8); i += kThr) {
        const int r = i / (P / 8), k = i % (P / 8);
        const bool ok = r0 + r < Q;
        cp_async16(xs + r * PS + k * 8, ok ? xg + (r0 + r) * p.x_sl + k * 8 : xg,
                   ok);
      }
      rest = xs + kRows * PS;
      rg = bg;
      rsl = p.b_sl;
    } else {
      float* ys = reinterpret_cast<float*>(st);
      for (int i = tid; i < kRows * (P / 4); i += kThr) {
        const int r = i / (P / 4), k = i % (P / 4);
        const bool ok = r0 + r < Q;
        cp_async16(ys + r * YS + k * 4,
                   ok ? yg + (r0 + r) * p.dy_sl + k * 4 : yg, ok);
      }
      rest = reinterpret_cast<__nv_bfloat16*>(ys + kRows * YS);
      rg = cg;
      rsl = p.c_sl;
    }
    for (int i = tid; i < kRows * NT; i += kThr) {   // B or C rows
      const int r = i / NT, k = i % NT;
      const bool ok = r0 + r < Q;
      cp_async16(rest + r * NS + k * 8, ok ? rg + (r0 + r) * rsl + k * 8 : rg,
                 ok);
    }
    cp_async_commit();
  };

  for (int i = tid; i < Q; i += kThr) cp_async4(dtc + i, dtg + i * p.dt_sl);
  cp_async_commit();
  issue(0);
  cp_async_wait<1>();                        // dt has landed
  __syncthreads();
  if (warp == 0) chunk_cumsum(dtc, cum, Q, a, lane);
  __syncthreads();
  const double last = cum[Q - 1];
  for (int i = tid; i < Qp; i += kThr) {
    if (i < Q)
      f[i] = down ? expf((float)cum[i]) : dtc[i] * expf((float)(last - cum[i]));
    else
      f[i] = 0.f;
  }
  if (!down) {
    for (int i = tid; i < Q; i += kThr)
      p.ws_cum[(long long)bh * p.L + l0 + i] = cum[i];
    if (tid == 0) p.ws_decay[(long long)bh * nc + c] = expf((float)last);
  }

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int pw = warp * 16;
  for (int j = 0; j < nj; ++j) {
    if (j + 1 < nj) {
      issue(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                         // stage j (and f) visible
    char* st = ring + (j & 1) * stage;
    const int r0 = j * kRows;
    const __nv_bfloat16* rows;               // B or C rows, the B operand
    if (!down) {
      rows = reinterpret_cast<const __nv_bfloat16*>(st) + kRows * PS;
    } else {
      const float* ys = reinterpret_cast<const float*>(st);
      rows = reinterpret_cast<const __nv_bfloat16*>(ys + kRows * YS);
      // dy's terms for (3'): (row, term, p) rows of the workspace
      __nv_bfloat16* dyt = p.ws_dyt + ((long long)bh * p.L + l0 + r0) *
                                          kTerms * P;
      for (int i = tid; i < kRows * (P / 2); i += kThr) {
        const int r = i / (P / 2), q = 2 * (i % (P / 2));
        if (r0 + r >= Q) break;
        uint32_t t[kTerms];
        split_terms(ys[r * YS + q], ys[r * YS + q + 1], t);
#pragma unroll
        for (int k = 0; k < kTerms; ++k)
          *reinterpret_cast<uint32_t*>(dyt + ((long long)r * kTerms + k) * P +
                                       q) = t[k];
      }
    }
    const __nv_bfloat16* bw = rows + ((mi & 1) * 8 + r8) * NS + (mi >> 1) * 8;
#pragma unroll
    for (int ks = 0; ks < kRows; ks += 16) {
      uint32_t at[kTerms][4];
      if (!down) {
        // A = (x w)^T, x read transposed and scaled by w_s per k in registers
        const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st);
        uint32_t xf[4];
        ldsm_x4_t(xf, xs + (ks + (mi >> 1) * 8 + r8) * PS + pw + (mi & 1) * 8);
        const float2 w0 = *reinterpret_cast<const float2*>(f + r0 + ks + q2);
        const float2 w8 = *reinterpret_cast<const float2*>(f + r0 + ks + 8 + q2);
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
      } else {
        // A = (dy e)^T from the fp32 rows: element (p, t) = ys[t][p]
        const float* ys = reinterpret_cast<const float*>(st);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pr = pw + g + (e & 1) * 8, t = ks + q2 + (e >> 1) * 8;
          uint32_t tt[kTerms];
          split_terms(ys[t * YS + pr] * f[r0 + t],
                      ys[(t + 1) * YS + pr] * f[r0 + t + 1], tt);
#pragma unroll
          for (int k = 0; k < kTerms; ++k) at[k][e] = tt[k];
        }
      }
      uint32_t bf[NT / 2][4];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldsm_x4_t(bf[np], bw + ks * NS + np * 16);
#pragma unroll
      for (int k = 0; k < kTerms; ++k) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          mma_bf16(acc[2 * np], at[k], bf[np][0], bf[np][1]);
          mma_bf16(acc[2 * np + 1], at[k], bf[np][2], bf[np][3]);
        }
      }
    }
    __syncthreads();                         // stage j consumed
  }
  float* out = (down ? p.ws_dstate : p.ws_state) +
               ((long long)bh * nc + c) * P * N;
  const int pr = pw + g;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int n = i * 8 + q2;
    *reinterpret_cast<float2*>(out + pr * N + n) =
        make_float2(acc[i][0], acc[i][1]);
    *reinterpret_cast<float2*>(out + (pr + 8) * N + n) =
        make_float2(acc[i][2], acc[i][3]);
  }
}

// A (P, N) fp32 state as kTerms bf16 terms in shared memory, [term][p][n]
// with rows of N + kPad
template <int P, int N>
__device__ __forceinline__ void state_terms(const float* src,
                                            __nv_bfloat16* dst) {
  constexpr int NS = N + kPad;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int i = threadIdx.x; i < P * N / 4; i += kMmaThreads) {
    const float4 v = s4[i];
    const int e = 4 * i, pr = e / N, n = e % N;
    uint32_t t0[kTerms], t1[kTerms];
    split_terms(v.x, v.y, t0);
    split_terms(v.z, v.w, t1);
#pragma unroll
    for (int k = 0; k < kTerms; ++k)
      *reinterpret_cast<uint2*>(dst + (k * P + pr) * NS + n) =
          make_uint2(t0[k], t1[k]);
  }
}

// The (3s) block of s-tile i, chunk c, head h, batch row b: the t-tiles j
// >= i in order. Warp w owns the s rows 16w.. of the tile. Per t-tile, with
// C rows and dy's terms by cp.async in a ring of two stages: S^T = B_s
// C_t^T and D^T = x_s dy_t^T (mma.sync, dy in its terms), then per element
// the decay L (off the diagonal exp(cum_t - r) exp(r - cum_s), r the
// tile's last step, both at most 1), W^T = L dt_s D^T, G^T = S^T L and
// the column sums of M = S W, and dxb += G^T dy (the cross terms),
// dB += W^T C (W in terms). Then the state terms w_s Hn B_s and w_s xb_s Hn
// (Hn in terms), U, dx, dxb . x; the block of the chunk's last s-tile also
// sums <Hn_c, h_c>.
template <int P, int N>
__device__ __forceinline__ void s_tile(const BwdParams& p, int i, int c,
                                       int h, int b) {
  extern __shared__ float4 smem4[];
  constexpr int PS = P + kPad, NS = N + kPad, PT = P / 8, NT = N / 8;
  constexpr int stage = kRows * NS + kTerms * kRows * PS;   // bf16s
  const int Q = p.Q, Qp = round_up(Q, kRows), ntt = Qp / kRows;
  const int bh = b * p.H + h;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [64][PS]
  __nv_bfloat16* bs = xs + kRows * PS;                          // [64][NS]
  __nv_bfloat16* ring = bs + kRows * NS;
  double* cum = reinterpret_cast<double*>(reinterpret_cast<char*>(smem4) +
                                          side_bytes(P, N));    // [Qp]
  float* dtc = reinterpret_cast<float*>(cum + Qp);              // [Qp]
  float* tf = dtc + Qp;                      // exp(cum_t - r), t past the tile
  float* red = tf + Qp;                      // [kMmaThreads]

  const int tid = threadIdx.x, lane = tid & 31, w = warp_index();
  const int mi = lane >> 3, r8 = lane & 7, g = lane >> 2, q2 = 2 * (lane & 3);
  const long long l0 = (long long)c * Q, L = p.L;
  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(p.x) +
                            b * p.x_sb + h * p.x_sh + l0 * p.x_sl;
  const __nv_bfloat16* bg = static_cast<const __nv_bfloat16*>(p.Bm) +
                            b * p.b_sb + h * p.b_sh + l0 * p.b_sl;
  const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(p.Cm) +
                            b * p.c_sb + h * p.c_sh + l0 * p.c_sl;
  const __nv_bfloat16* yg = p.ws_dyt + ((long long)bh * L + l0) * kTerms * P;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh + l0 * p.dt_sl;
  const int s0 = i * kRows, s_end = min(Q, s0 + kRows);

  auto issue = [&](int j) {                  // t-tile j: C rows, dy's terms
    __nv_bfloat16* cd = ring + (j & 1) * stage;
    __nv_bfloat16* yd = cd + kRows * NS;
    const int t0 = j * kRows;
    for (int k = tid; k < kRows * NT; k += kMmaThreads) {
      const int r = k / NT, q = k % NT;
      const bool ok = t0 + r < Q;
      cp_async16(cd + r * NS + q * 8, ok ? cg + (t0 + r) * p.c_sl + q * 8 : cg,
                 ok);
    }
    for (int k = tid; k < kRows * kTerms * PT; k += kMmaThreads) {
      const int r = k / (kTerms * PT), tm = k / PT % kTerms, q = k % PT;
      const bool ok = t0 + r < Q;
      cp_async16(yd + (tm * kRows + r) * PS + q * 8,
                 ok ? yg + ((long long)(t0 + r) * kTerms + tm) * P + q * 8 : yg,
                 ok);
    }
    cp_async_commit();
  };

  for (int k = tid; k < Q; k += kMmaThreads) {
    cp_async8(cum + k, p.ws_cum + (long long)bh * L + l0 + k);
    cp_async4(dtc + k, dtg + k * p.dt_sl);
  }
  for (int k = tid; k < kRows * PT; k += kMmaThreads) {   // x and B, s rows
    const int r = k / PT, q = k % PT;
    const bool ok = s0 + r < Q;
    cp_async16(xs + r * PS + q * 8, ok ? xg + (s0 + r) * p.x_sl + q * 8 : xg,
               ok);
  }
  for (int k = tid; k < kRows * NT; k += kMmaThreads) {
    const int r = k / NT, q = k % NT;
    const bool ok = s0 + r < Q;
    cp_async16(bs + r * NS + q * 8, ok ? bg + (s0 + r) * p.b_sl + q * 8 : bg,
               ok);
  }
  cp_async_commit();
  issue(i);
  for (int k = Q + tid; k < Qp; k += kMmaThreads) dtc[k] = 0.f;
  cp_async_wait<1>();
  __syncthreads();                           // cum, dt, x and B visible
  const double r = cum[s_end - 1];
  for (int k = s_end + tid; k < Qp; k += kMmaThreads)
    tf[k] = k < Q ? expf((float)(cum[k] - r)) : 0.f;
  const int sl = s0 + w * 16 + g, sh = sl + 8;      // this thread's rows
  const float bl = sl < Q ? expf((float)(r - cum[sl])) : 0.f;
  const float bh8 = sh < Q ? expf((float)(r - cum[sh])) : 0.f;
  const float dl = dtc[sl], dh8 = dtc[sh];
  const float bdl = bl * dl, bdh = bh8 * dh8;

  float dxb[PT][4], dba[NT][4];
#pragma unroll
  for (int k = 0; k < PT; ++k) dxb[k][0] = dxb[k][1] = dxb[k][2] = dxb[k][3] = 0.f;
#pragma unroll
  for (int k = 0; k < NT; ++k) dba[k][0] = dba[k][1] = dba[k][2] = dba[k][3] = 0.f;
  float csl = 0.f, csh = 0.f;
  const __nv_bfloat16* arow_b = bs + (w * 16 + (mi & 1) * 8 + r8) * NS +
                                (mi >> 1) * 8;
  const __nv_bfloat16* arow_x = xs + (w * 16 + (mi & 1) * 8 + r8) * PS +
                                (mi >> 1) * 8;
  for (int j = i; j < ntt; ++j) {
    if (j + 1 < ntt) {
      issue(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                         // t-tile j (and tf) visible
    const __nv_bfloat16* ct = ring + (j & 1) * stage;
    const __nv_bfloat16* yt = ct + kRows * NS;
    const int t0 = j * kRows;
    const bool diag = j == i;
    // on the diagonal, t-columns below the warp's rows are never used
    const int np0 = diag ? w : 0;
    float st[8][4], dr[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      st[k][0] = st[k][1] = st[k][2] = st[k][3] = dr[k][0] = dr[k][1] =
          dr[k][2] = dr[k][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {    // S^T = B_s C_t^T
      uint32_t af[4];
      ldsm_x4(af, arow_b + kk * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np < np0) continue;
        uint32_t bf[4];
        ldsm_x4(bf, ct + (np * 16 + (mi >> 1) * 8 + r8) * NS + kk * 16 +
                        (mi & 1) * 8);
        mma_bf16(st[2 * np], af, bf[0], bf[1]);
        mma_bf16(st[2 * np + 1], af, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {    // D^T = x_s dy_t^T, dy's terms
      uint32_t af[4];
      ldsm_x4(af, arow_x + kk * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np < np0) continue;
#pragma unroll
        for (int tm = 0; tm < kTerms; ++tm) {
          uint32_t bf[4];
          ldsm_x4(bf, yt + (tm * kRows + np * 16 + (mi >> 1) * 8 + r8) * PS +
                          kk * 16 + (mi & 1) * 8);
          mma_bf16(dr[2 * np], af, bf[0], bf[1]);
          mma_bf16(dr[2 * np + 1], af, bf[2], bf[3]);
        }
      }
    }
    // W^T = L dt_s D^T and G^T = S^T L in place, the column sums of M
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < 2 * np0) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + nt * 8 + q2 + (e & 1), s = e < 2 ? sl : sh;
        float l, ld;
        if (!diag) {
          l = tf[t] * (e < 2 ? bl : bh8);
          ld = tf[t] * (e < 2 ? bdl : bdh);
        } else {
          // never exp(cum_t - cum_s) for s > t: it may overflow
          l = t < Q && s <= t ? expf((float)(cum[t] - cum[s])) : 0.f;
          ld = l * (e < 2 ? dl : dh8);
        }
        const float wv = ld * dr[nt][e];
        if (e < 2) csl += st[nt][e] * wv; else csh += st[nt][e] * wv;
        dr[nt][e] = wv;
        st[nt][e] *= l;
      }
    }
    // dxb += G^T dy (cross terms), dB += W^T C (W's terms)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < np0) continue;
      uint32_t ga[kTerms][4], wa[kTerms][4];
      a_terms(st[2 * kk], st[2 * kk + 1], ga);
      a_terms(dr[2 * kk], dr[2 * kk + 1], wa);
#pragma unroll
      for (int q = 0; q < P / 16; ++q) {
        uint32_t yf[kTerms][4];
#pragma unroll
        for (int tm = 0; tm < kTerms; ++tm)
          ldsm_x4_t(yf[tm], yt + (tm * kRows + kk * 16 + (mi & 1) * 8 + r8) *
                                     PS + q * 16 + (mi >> 1) * 8);
#pragma unroll
        for (int ga_k = 0; ga_k < kTerms; ++ga_k) {
#pragma unroll
          for (int tm = 0; tm + ga_k < kTerms; ++tm) {
            mma_bf16(dxb[2 * q], ga[ga_k], yf[tm][0], yf[tm][1]);
            mma_bf16(dxb[2 * q + 1], ga[ga_k], yf[tm][2], yf[tm][3]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < N / 16; ++q) {
        uint32_t cf[4];
        ldsm_x4_t(cf, ct + (kk * 16 + (mi & 1) * 8 + r8) * NS + q * 16 +
                          (mi >> 1) * 8);
#pragma unroll
        for (int k = 0; k < kTerms; ++k) {
          mma_bf16(dba[2 * q], wa[k], cf[0], cf[1]);
          mma_bf16(dba[2 * q + 1], wa[k], cf[2], cf[3]);
        }
      }
    }
    __syncthreads();                         // stage j consumed
  }

  // the state terms: Hn_c (what the fold left in the dstate slot) as
  // terms over the free ring; <Hn_c, h_c> by the chunk's last s-tile
  const long long PN = (long long)P * N;
  const float* hn = p.ws_dstate + ((long long)bh * p.nc + c) * PN;
  __nv_bfloat16* ht = ring;                  // [kTerms][P][NS]
  state_terms<P, N>(hn, ht);
  const bool dot = i == ntt - 1;
  if (dot) {
    const float4* h4 = reinterpret_cast<const float4*>(
        p.ws_state + ((long long)bh * p.nc + c) * PN);
    const float4* g4 = reinterpret_cast<const float4*>(hn);
    float v = 0.f;
    for (int k = tid; k < PN / 4; k += kMmaThreads) {
      const float4 x4 = h4[k], y4 = g4[k];
      v += x4.x * y4.x + x4.y * y4.y + x4.z * y4.z + x4.w * y4.w;
    }
    red[tid] = v;
  }
  __syncthreads();                           // Hn's terms visible
  if (dot && tid == 0) {
    float v = 0.f;
    for (int k = 0; k < kMmaThreads; ++k) v += red[k];
    p.ws_hh[(long long)bh * p.nc + c] = v;
  }
  // dxb += w_s (B_s Hn^T), and U_s = xb_s . that
  const double lastc = cum[Q - 1];
  const float wl = sl < Q ? expf((float)(lastc - cum[sl])) : 0.f;
  const float wh = sh < Q ? expf((float)(lastc - cum[sh])) : 0.f;
  float ul = 0.f, uh = 0.f;
  {
    float hb[PT][4];
#pragma unroll
    for (int k = 0; k < PT; ++k) hb[k][0] = hb[k][1] = hb[k][2] = hb[k][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, arow_b + kk * 16);
#pragma unroll
      for (int k = 0; k < kTerms; ++k) {
#pragma unroll
        for (int q = 0; q < P / 16; ++q) {
          uint32_t hf[4];
          ldsm_x4(hf, ht + (k * P + q * 16 + (mi >> 1) * 8 + r8) * NS +
                          kk * 16 + (mi & 1) * 8);
          mma_bf16(hb[2 * q], af, hf[0], hf[1]);
          mma_bf16(hb[2 * q + 1], af, hf[2], hf[3]);
        }
      }
    }
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
      const int col = pt * 8 + q2;
      const float2 xl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          xs + (w * 16 + g) * PS + col));
      const float2 xh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          xs + (w * 16 + g + 8) * PS + col));
      const float h0 = wl * hb[pt][0], h1 = wl * hb[pt][1];
      const float h2 = wh * hb[pt][2], h3 = wh * hb[pt][3];
      dxb[pt][0] += h0;
      dxb[pt][1] += h1;
      dxb[pt][2] += h2;
      dxb[pt][3] += h3;
      ul += xl.x * dl * h0 + xl.y * dl * h1;
      uh += xh.x * dh8 * h2 + xh.y * dh8 * h3;
    }
  }
  // dB += (dt_s w_s) (x_s Hn), 16 columns at a time
  const float fl = dl * wl, fh = dh8 * wh;
#pragma unroll
  for (int q = 0; q < N / 16; ++q) {
    float a2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, arow_x + kk * 16);
#pragma unroll
      for (int k = 0; k < kTerms; ++k) {
        uint32_t hf[4];
        ldsm_x4_t(hf, ht + (k * P + kk * 16 + (mi & 1) * 8 + r8) * NS +
                          q * 16 + (mi >> 1) * 8);
        mma_bf16(a2[0], af, hf[0], hf[1]);
        mma_bf16(a2[1], af, hf[2], hf[3]);
      }
    }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      dba[2 * q + v][0] += fl * a2[v][0];
      dba[2 * q + v][1] += fl * a2[v][1];
      dba[2 * q + v][2] += fh * a2[v][2];
      dba[2 * q + v][3] += fh * a2[v][3];
    }
  }

  // dx = dxb dt_s, dxb . x, this head's dB rows and the per-row sums
  __nv_bfloat16* dx = static_cast<__nv_bfloat16*>(p.dx) + b * p.dx_sb +
                      h * p.dx_sh + l0 * p.dx_sl;
  float xdl = 0.f, xdh = 0.f;
#pragma unroll
  for (int pt = 0; pt < PT; ++pt) {
    const int col = pt * 8 + q2;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int s = rr ? sh : sl;
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          xs + (w * 16 + g + 8 * rr) * PS + col));
      const float v0 = dxb[pt][2 * rr], v1 = dxb[pt][2 * rr + 1];
      const float d = rr ? dh8 : dl;
      if (rr) xdh += v0 * xv.x + v1 * xv.y; else xdl += v0 * xv.x + v1 * xv.y;
      if (s < Q)
        *reinterpret_cast<__nv_bfloat162*>(dx + s * p.dx_sl + col) =
            __floats2bfloat162_rn(v0 * d, v1 * d);
    }
  }
  csl = quad_sum(csl);
  csh = quad_sum(csh);
  ul = quad_sum(ul);
  uh = quad_sum(uh);
  xdl = quad_sum(xdl);
  xdh = quad_sum(xdh);
  const long long row = (long long)bh * L + l0;
  if ((lane & 3) == 0) {
    if (sl < Q) {
      p.ws_cs[row + sl] = csl;
      p.ws_u[row + sl] = ul;
      p.ws_xd[row + sl] = xdl;
    }
    if (sh < Q) {
      p.ws_cs[row + sh] = csh;
      p.ws_u[row + sh] = uh;
      p.ws_xd[row + sh] = xdh;
    }
  }
  float* dB = p.ws_dB + (row + s0 + w * 16 + g) * N;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = nt * 8 + q2;
    if (sl < Q)
      *reinterpret_cast<float2*>(dB + n) = make_float2(dba[nt][0], dba[nt][1]);
    if (sh < Q)
      *reinterpret_cast<float2*>(dB + 8 * N + n) =
          make_float2(dba[nt][2], dba[nt][3]);
  }
}

// The (3t) block of t-tile j, chunk c, head h, batch row b: the s-tiles i
// <= j in order. Warp w owns the t rows 16w.. of the tile. Per s-tile, with
// B and x rows by cp.async in a ring of two stages: S = C_t B_s^T and D =
// dy_t x_s^T (dy in its terms), per element the decay (off the diagonal
// exp(cum_t - r) exp(r - cum_s), r the step before the tile), W = L dt_s D
// and the row sums of M = S W, and dC += W B (W in terms). Then the state
// term e_t dy_t h_c (the cross terms of dy and h_c) and C_t . that.
template <int P, int N>
__device__ __forceinline__ void t_tile(const BwdParams& p, int j, int c,
                                       int h, int b) {
  extern __shared__ float4 smem4[];
  constexpr int PS = P + kPad, NS = N + kPad, PT = P / 8, NT = N / 8;
  constexpr int stage = kRows * NS + kRows * PS;   // bf16s
  const int Q = p.Q, Qp = round_up(Q, kRows);
  const int bh = b * p.H + h;
  __nv_bfloat16* ct = reinterpret_cast<__nv_bfloat16*>(smem4);  // [64][NS]
  __nv_bfloat16* yt = ct + kRows * NS;       // [kTerms][64][PS]
  __nv_bfloat16* ring = yt + kTerms * kRows * PS;
  double* cum = reinterpret_cast<double*>(reinterpret_cast<char*>(smem4) +
                                          side_bytes(P, N));    // [Qp]
  float* dtc = reinterpret_cast<float*>(cum + Qp);              // [Qp]
  float* sf = dtc + Qp;           // exp(r - cum_s) dt_s, s before the tile

  const int tid = threadIdx.x, lane = tid & 31, w = warp_index();
  const int mi = lane >> 3, r8 = lane & 7, g = lane >> 2, q2 = 2 * (lane & 3);
  const long long l0 = (long long)c * Q, L = p.L;
  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(p.x) +
                            b * p.x_sb + h * p.x_sh + l0 * p.x_sl;
  const __nv_bfloat16* bg = static_cast<const __nv_bfloat16*>(p.Bm) +
                            b * p.b_sb + h * p.b_sh + l0 * p.b_sl;
  const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(p.Cm) +
                            b * p.c_sb + h * p.c_sh + l0 * p.c_sl;
  const __nv_bfloat16* yg = p.ws_dyt + ((long long)bh * L + l0) * kTerms * P;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh + l0 * p.dt_sl;
  const int t0 = j * kRows;

  auto issue = [&](int i) {                  // s-tile i: B and x rows
    __nv_bfloat16* bd = ring + (i & 1) * stage;
    __nv_bfloat16* xd = bd + kRows * NS;
    const int s0 = i * kRows;
    for (int k = tid; k < kRows * NT; k += kMmaThreads) {
      const int r = k / NT, q = k % NT;
      const bool ok = s0 + r < Q;
      cp_async16(bd + r * NS + q * 8, ok ? bg + (s0 + r) * p.b_sl + q * 8 : bg,
                 ok);
    }
    for (int k = tid; k < kRows * PT; k += kMmaThreads) {
      const int r = k / PT, q = k % PT;
      const bool ok = s0 + r < Q;
      cp_async16(xd + r * PS + q * 8, ok ? xg + (s0 + r) * p.x_sl + q * 8 : xg,
                 ok);
    }
    cp_async_commit();
  };

  for (int k = tid; k < Q; k += kMmaThreads) {
    cp_async8(cum + k, p.ws_cum + (long long)bh * L + l0 + k);
    cp_async4(dtc + k, dtg + k * p.dt_sl);
  }
  for (int k = tid; k < kRows * NT; k += kMmaThreads) {   // C, t rows
    const int r = k / NT, q = k % NT;
    const bool ok = t0 + r < Q;
    cp_async16(ct + r * NS + q * 8, ok ? cg + (t0 + r) * p.c_sl + q * 8 : cg,
               ok);
  }
  for (int k = tid; k < kRows * kTerms * PT; k += kMmaThreads) {  // dy's terms
    const int r = k / (kTerms * PT), tm = k / PT % kTerms, q = k % PT;
    const bool ok = t0 + r < Q;
    cp_async16(yt + (tm * kRows + r) * PS + q * 8,
               ok ? yg + ((long long)(t0 + r) * kTerms + tm) * P + q * 8 : yg,
               ok);
  }
  cp_async_commit();
  issue(0);
  for (int k = Q + tid; k < Qp; k += kMmaThreads) dtc[k] = 0.f;
  cp_async_wait<1>();
  __syncthreads();                           // cum, dt, C and dy visible
  const double r = t0 > 0 ? cum[t0 - 1] : 0.0;
  for (int k = tid; k < t0; k += kMmaThreads)
    sf[k] = expf((float)(r - cum[k])) * dtc[k];
  const int tl = t0 + w * 16 + g, th = tl + 8;      // this thread's rows
  const float al = tl < Q ? expf((float)(cum[tl] - r)) : 0.f;
  const float ah = th < Q ? expf((float)(cum[th] - r)) : 0.f;

  float dca[NT][4];
#pragma unroll
  for (int k = 0; k < NT; ++k) dca[k][0] = dca[k][1] = dca[k][2] = dca[k][3] = 0.f;
  float rsl = 0.f, rsh = 0.f;
  const __nv_bfloat16* arow_c = ct + (w * 16 + (mi & 1) * 8 + r8) * NS +
                                (mi >> 1) * 8;
  const __nv_bfloat16* arow_y = yt + (w * 16 + (mi & 1) * 8 + r8) * PS +
                                (mi >> 1) * 8;
  for (int i = 0; i <= j; ++i) {
    if (i < j) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                         // s-tile i (and sf) visible
    const __nv_bfloat16* bt = ring + (i & 1) * stage;
    const __nv_bfloat16* xt = bt + kRows * NS;
    const int s0 = i * kRows;
    const bool diag = i == j;
    // on the diagonal, s-columns past the warp's rows are never used
    const int npe = diag ? w + 1 : 4;
    float st[8][4], dr[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      st[k][0] = st[k][1] = st[k][2] = st[k][3] = dr[k][0] = dr[k][1] =
          dr[k][2] = dr[k][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {    // S = C_t B_s^T
      uint32_t af[4];
      ldsm_x4(af, arow_c + kk * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np >= npe) continue;
        uint32_t bf[4];
        ldsm_x4(bf, bt + (np * 16 + (mi >> 1) * 8 + r8) * NS + kk * 16 +
                        (mi & 1) * 8);
        mma_bf16(st[2 * np], af, bf[0], bf[1]);
        mma_bf16(st[2 * np + 1], af, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {    // D = dy_t x_s^T, dy's terms
      uint32_t xf[4][4];
#pragma unroll
      for (int np = 0; np < 4; ++np)
        if (np < npe)
          ldsm_x4(xf[np], xt + (np * 16 + (mi >> 1) * 8 + r8) * PS + kk * 16 +
                              (mi & 1) * 8);
#pragma unroll
      for (int tm = 0; tm < kTerms; ++tm) {
        uint32_t af[4];
        ldsm_x4(af, arow_y + tm * kRows * PS + kk * 16);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np >= npe) continue;
          mma_bf16(dr[2 * np], af, xf[np][0], xf[np][1]);
          mma_bf16(dr[2 * np + 1], af, xf[np][2], xf[np][3]);
        }
      }
    }
    // W = L dt_s D in place, the row sums of M
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt >= 2 * npe) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = s0 + nt * 8 + q2 + (e & 1), t = e < 2 ? tl : th;
        float ld;
        if (!diag) {
          ld = (e < 2 ? al : ah) * sf[s];
        } else {
          // never exp(cum_t - cum_s) for s > t: it may overflow
          ld = t < Q && s <= t ? expf((float)(cum[t] - cum[s])) * dtc[s] : 0.f;
        }
        const float wv = ld * dr[nt][e];
        if (e < 2) rsl += st[nt][e] * wv; else rsh += st[nt][e] * wv;
        dr[nt][e] = wv;
      }
    }
    // dC += W B (W's terms)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= npe) continue;
      uint32_t wa[kTerms][4];
      a_terms(dr[2 * kk], dr[2 * kk + 1], wa);
#pragma unroll
      for (int q = 0; q < N / 16; ++q) {
        uint32_t bf[4];
        ldsm_x4_t(bf, bt + (kk * 16 + (mi & 1) * 8 + r8) * NS + q * 16 +
                          (mi >> 1) * 8);
#pragma unroll
        for (int k = 0; k < kTerms; ++k) {
          mma_bf16(dca[2 * q], wa[k], bf[0], bf[1]);
          mma_bf16(dca[2 * q + 1], wa[k], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();                         // stage i consumed
  }

  // the state term e_t dy_t h_c: h_c (what the fold left in the state
  // slot) as terms over the free ring, the cross terms of dy and h_c
  const long long PN = (long long)P * N;
  __nv_bfloat16* ht = ring;                  // [kTerms][P][NS]
  state_terms<P, N>(p.ws_state + ((long long)bh * p.nc + c) * PN, ht);
  __syncthreads();
  const float el = tl < Q ? expf((float)cum[tl]) : 0.f;
  const float eh = th < Q ? expf((float)cum[th]) : 0.f;
#pragma unroll
  for (int q = 0; q < N / 16; ++q) {
    float a2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {
#pragma unroll
      for (int ty = 0; ty < kTerms; ++ty) {
        uint32_t af[4];
        ldsm_x4(af, arow_y + ty * kRows * PS + kk * 16);
#pragma unroll
        for (int k = 0; ty + k < kTerms; ++k) {
          uint32_t hf[4];
          ldsm_x4_t(hf, ht + (k * P + kk * 16 + (mi & 1) * 8 + r8) * NS +
                            q * 16 + (mi >> 1) * 8);
          mma_bf16(a2[0], af, hf[0], hf[1]);
          mma_bf16(a2[1], af, hf[2], hf[3]);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int n = (2 * q + v) * 8 + q2;
      const float2 cl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          ct + (w * 16 + g) * NS + n));
      const float2 ch = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          ct + (w * 16 + g + 8) * NS + n));
      const float v0 = el * a2[v][0], v1 = el * a2[v][1];
      const float v2 = eh * a2[v][2], v3 = eh * a2[v][3];
      dca[2 * q + v][0] += v0;
      dca[2 * q + v][1] += v1;
      dca[2 * q + v][2] += v2;
      dca[2 * q + v][3] += v3;
      rsl += v0 * cl.x + v1 * cl.y;
      rsh += v2 * ch.x + v3 * ch.y;
    }
  }
  rsl = quad_sum(rsl);
  rsh = quad_sum(rsh);
  const long long row = (long long)bh * L + l0;
  if ((lane & 3) == 0) {
    if (tl < Q) p.ws_rs[row + tl] = rsl;
    if (th < Q) p.ws_rs[row + th] = rsh;
  }
  float* dC = p.ws_dC + (row + tl) * N;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = nt * 8 + q2;
    if (tl < Q)
      *reinterpret_cast<float2*>(dC + n) = make_float2(dca[nt][0], dca[nt][1]);
    if (th < Q)
      *reinterpret_cast<float2*>(dC + 8 * N + n) =
          make_float2(dca[nt][2], dca[nt][3]);
  }
}

// Launch (3'): blocks (2 tiles nc, H, Bsz), 128 threads. blockIdx.x / nc
// = 2 rank + side, the chunk blockIdx.x % nc: side 0 the (3s) block of
// s-tile rank, side 1 the (3t) block of t-tile tiles - 1 - rank, so the
// heaviest tiles of both come first.
template <int P, int N>
__global__ void __launch_bounds__(kMmaThreads, N <= 16 ? 3 : 2)
    ssd_bwd_tiles_mma(BwdParams p) {
  const int ntt = round_up(p.Q, kRows) / kRows;
  const int k = blockIdx.x / p.nc, c = blockIdx.x % p.nc, rank = k >> 1;
  if (k & 1)
    t_tile<P, N>(p, ntt - 1 - rank, c, blockIdx.y, blockIdx.z);
  else
    s_tile<P, N>(p, rank, c, blockIdx.y, blockIdx.z);
}

// Launch (4'): a warp per (b, h, chunk). dcum_t = (row sums of M + C_t .
// e_t dy_t h_c) - (column sums of M) - U_t, at the chunk's last step also
// exp(cum_Q) <Hn_c, h_c> + sum_s U_s; dla its reverse cumsum in fp64;
// ddt = dla A + dxb . x; the chunk's share of dA = sum dla dt.
__global__ void __launch_bounds__(kThreads) ssd_bwd_scan(BwdParams p) {
  const int lane = threadIdx.x & 31;
  const long long bhc = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  if (bhc >= (long long)p.Bsz * p.H * p.nc) return;
  const int c = bhc % p.nc;
  const long long bh = bhc / p.nc;
  const int b = bh / p.H, hh = bh % p.H, Q = p.Q;
  const long long row = bh * p.L + (long long)c * Q;
  const float* rs = p.ws_rs + row;
  const float* cs = p.ws_cs + row;
  const float* u = p.ws_u + row;
  const float* xd = p.ws_xd + row;
  const float* dt = p.dt + b * p.dt_sb + hh * p.dt_sh + (long long)c * Q * p.dt_sl;
  float* ddt = p.ddt + b * p.ddt_sb + hh * p.ddt_sh + (long long)c * Q * p.ddt_sl;
  const float a = p.A[b * p.a_sb + hh * p.a_sh];
  const int per = (Q + 31) / 32;
  const int lo = min(lane * per, Q), hi = min(lo + per, Q);
  double us = 0.0;
  for (int t = lo; t < hi; ++t) us += (double)u[t];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    us += __shfl_xor_sync(0xffffffffu, us, off);
  const double xterm = (double)p.ws_decay[bhc] * (double)p.ws_hh[bhc] + us;
  auto dcum = [&](int t) {
    return (double)rs[t] - (double)cs[t] - (double)u[t] +
           (t == Q - 1 ? xterm : 0.0);
  };
  double seg = 0.0;
  for (int t = hi - 1; t >= lo; --t) seg += dcum(t);
  double incl = seg;                         // sum of lanes >= this one
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += o;
  }
  double run = incl - seg;                   // lanes after this one
  double da = 0.0;
  for (int t = hi - 1; t >= lo; --t) {
    run += dcum(t);
    ddt[(long long)t * p.ddt_sl] = (float)(run * a) + xd[t];
    da += run * dt[(long long)t * p.dt_sl];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    da += __shfl_xor_sync(0xffffffffu, da, off);
  if (lane == 0) p.ws_dA[bhc] = (float)da;
}

// Lets ``kernel`` take up to the whole 227 KB of dynamic shared memory on
// the current device; once per kernel and device
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

template <int P, int N>
int launch_mma(const BwdParams& p, int smem1, int smem3, int reduce_blocks,
               cudaStream_t stream) {
  static bool allowed_states[kMaxDevices] = {}, allowed_tiles[kMaxDevices] = {};
  int e = allow_smem(ssd_bwd_states_mma<P, N>, allowed_states);
  if (e != 0) return e;
  e = allow_smem(ssd_bwd_tiles_mma<P, N>, allowed_tiles);
  if (e != 0) return e;
  const int BH = p.Bsz * p.H, PN = P * N;
  const int ntt = round_up(p.Q, kRows) / kRows;
  ssd_bwd_states_mma<P, N><<<dim3(2 * p.nc, p.H, p.Bsz), 2 * P, smem1,
                              stream>>>(p);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  ssd_bwd_fold<<<dim3(BH, (PN + kThreads - 1) / kThreads), kThreads, 0,
                 stream>>>(p);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  ssd_bwd_tiles_mma<P, N><<<dim3(2 * ntt * p.nc, p.H, p.Bsz), kMmaThreads,
                             smem3, stream>>>(p);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  const long long rows = (long long)BH * p.nc, per = kThreads / 32;
  ssd_bwd_scan<<<(int)((rows + per - 1) / per), kThreads, 0, stream>>>(p);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  ssd_bwd_reduce<__nv_bfloat16><<<reduce_blocks, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int set_smem(K kernel, long long bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

template <typename TX, int MR>
int launch(const BwdParams& p, int smem1, int smem3, int reduce_blocks,
           cudaStream_t stream) {
  const int BH = p.Bsz * p.H, PN = p.P * p.N;
  int e = set_smem(ssd_bwd_states<TX>, smem1);
  if (e != 0) return e;
  e = set_smem(ssd_bwd_chunk<TX, MR>, smem3);
  if (e != 0) return e;
  ssd_bwd_states<TX><<<BH * p.nc, kThreads, smem1, stream>>>(p);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  ssd_bwd_fold<<<dim3(BH, (PN + kThreads - 1) / kThreads), kThreads, 0,
                 stream>>>(p);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  ssd_bwd_chunk<TX, MR><<<BH * p.nc, kChunkThreads, smem3, stream>>>(p);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  ssd_bwd_reduce<TX><<<reduce_blocks, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

// The (P, N) the tensor route is built for: the models' (mamba2-130m's,
// jamba's and the tiny configs')
bool mma_shape(int P, int N) {
  return (P == 64 && (N == 128 || N == 16)) || (P == 32 && N == 16);
}

}  // namespace

extern "C" {

// Bytes of shared memory of a launch for (P, N, Q): ``which`` 0 the
// CUDA-core route's launch (1), 1 its launch (3), 2 the tensor route's
// launch (1'), 3 its launch (3').
long long ssd_scan_bwd_smem_bytes(int P, int N, int Q, int which) {
  switch (which) {
    case 0: return states_smem_bytes(P, N, Q);
    case 1: return chunk_smem_bytes(P, N, Q);
    case 2: return states_mma_smem_bytes(P, N, Q);
    default: return tiles_mma_smem_bytes(P, N, Q);
  }
}

// Bytes of workspace a call needs (the tensor route's when ``mma``).
long long ssd_scan_bwd_ws_bytes(int Bsz, int H, int L, int P, int N, int Q,
                                int mma) {
  return carve(nullptr, Bsz, H, L, P, N, Q, mma, nullptr);
}

// The backward on ``stream``: the tensor route's launches (1'), (2), (3'),
// (4'), (5) when ``mma`` (bf16 x, B and C at a (P, N) it is built for),
// else the CUDA-core route's (1)-(4); returns the first non-zero
// cudaGetLastError() (or cudaErrorInvalidValue for sizes it does not
// take). ``strides`` holds 23 element strides: x (b, h, l), dt (b, h, l),
// A (b, h), B (b, h, l), C (b, h, l), dy (b, h, l), dx (b, h, l), ddt (b,
// h, l); the last axes of x, B, C, dy and dx have unit stride (on the
// tensor route x, B, C and dy and their strides also 16-byte aligned). x,
// B, C and dx share one type (``x_bf16``); dt, A, dy, dh, ddt and dA are
// fp32. dh (Bsz*H, P, N) contiguous, or null for zero. dB and dC are
// written contiguous (Bsz, 1, L, N) summed over the heads when
// ``shared_bc``, else (Bsz, H, L, N); dA (Bsz, H). ``ws`` holds
// ``ws_bytes``, at least ssd_scan_bwd_ws_bytes(). ``smem_state`` and
// ``smem_tiles`` (launches (1) and (3) of the route) and
// ``reduce_blocks`` (the head sum) are the Python plan's
// (ssd_scan.py:bwd_plan), each at least what the layouts above need.
int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, const void* dy,
                 const void* dh, void* dx, void* ddt, void* dA, void* dB,
                 void* dC, void* ws, long long ws_bytes, int Bsz, int H,
                 int L, int P, int N, int Q, int shared_bc,
                 const long long* strides, int x_bf16, int mma,
                 int smem_state, int smem_tiles, int reduce_blocks,
                 void* stream) {
  if (Bsz <= 0 || H <= 0 || L <= 0) return 0;
  const int lgP = log2_exact(P), lgN = log2_exact(N);
  const bool bad = mma
      ? (!x_bf16 || !mma_shape(P, N) ||
         smem_state < states_mma_smem_bytes(P, N, Q) ||
         smem_tiles < tiles_mma_smem_bytes(P, N, Q))
      : (lgP < 2 || lgP > 7 || lgN < 2 || lgN > 7 || P * N > 8192 ||
         smem_tiles < chunk_smem_bytes(P, N, Q) ||
         smem_state < states_smem_bytes(P, N, Q));
  if (bad || Q <= 0 || L % Q || smem_tiles > 232448 || smem_state > 232448 ||
      reduce_blocks < 1 ||
      ws_bytes < carve(nullptr, Bsz, H, L, P, N, Q, mma, nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{};
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.Bm = Bm;
  p.Cm = Cm;
  p.dy = static_cast<const float*>(dy);
  p.dh = static_cast<const float*>(dh);
  p.dx = dx;
  p.ddt = static_cast<float*>(ddt);
  p.dB = dB;
  p.dC = dC;
  p.dA = static_cast<float*>(dA);
  carve(ws, Bsz, H, L, P, N, Q, mma, &p);
  p.Bsz = Bsz;
  p.H = H;
  p.Hout = shared_bc ? 1 : H;
  p.L = L;
  p.P = P;
  p.N = N;
  p.Q = Q;
  p.nc = L / Q;
  p.lgP = lgP;
  p.lgN = lgN;
  long long* s[] = {&p.x_sb, &p.x_sh, &p.x_sl, &p.dt_sb, &p.dt_sh, &p.dt_sl,
                    &p.a_sb, &p.a_sh, &p.b_sb, &p.b_sh, &p.b_sl, &p.c_sb,
                    &p.c_sh, &p.c_sl, &p.dy_sb, &p.dy_sh, &p.dy_sl, &p.dx_sb,
                    &p.dx_sh, &p.dx_sl, &p.ddt_sb, &p.ddt_sh, &p.ddt_sl};
  for (int i = 0; i < 23; ++i) *s[i] = strides[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_BWD_PLAN p, smem_state, smem_tiles, reduce_blocks, st
  if (mma) {
    if (P == 64 && N == 128) return launch_mma<64, 128>(SSD_BWD_PLAN);
    if (P == 64) return launch_mma<64, 16>(SSD_BWD_PLAN);
    return launch_mma<32, 16>(SSD_BWD_PLAN);
  }
  const int width = P > N ? P : N;
  if (x_bf16) {                              // MR: rows a thread holds
    if (width <= 32) return launch<__nv_bfloat16, 4>(SSD_BWD_PLAN);
    if (width <= 64) return launch<__nv_bfloat16, 8>(SSD_BWD_PLAN);
    return launch<__nv_bfloat16, 16>(SSD_BWD_PLAN);
  }
  if (width <= 32) return launch<float, 4>(SSD_BWD_PLAN);
  if (width <= 64) return launch<float, 8>(SSD_BWD_PLAN);
  return launch<float, 16>(SSD_BWD_PLAN);
#undef SSD_BWD_PLAN
}

const char* ssd_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
