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
// exponent is positive: L_ts is taken for s <= t only.
//
// Four launches in stream order, fp32 on the CUDA cores for fp32 and bf16
// x, B and C (dy fp32), no atomics (a rerun is bit-equal):
//   (1) ssd_bwd_states, a block per (b, h, chunk): the chunk's fp64 cumsum,
//       its own state sum_s w_s xb_s (x) B_s and its own state gradient
//       sum_t e_t dy_t (x) C_t, a (P, N) pair of sums over the chunk's rows,
//       and exp(cum_Q);
//   (2) ssd_bwd_fold, a thread per (b, h, state entry): the states entering
//       each chunk (forward, in chunk order) and Hn_c (backward, in reverse
//       chunk order), each written in place of the chunk's own sums;
//   (3) ssd_bwd_chunk, a block of 512 threads per (b, h, chunk) (half the
//       rows a thread, so its accumulators stay in registers at mamba2's
//       N 128, and 16 warps an SM to hide the loads): the intra-chunk terms
//       over 64 x 64 tiles of (t, s) at or below the diagonal, for each
//       s-tile (dxb_s, dB_s in registers) the t-tiles from it down; dC_t
//       kept in an fp32 workspace that the block alone reads and writes;
//       the state terms from h_c and Hn_c in shared memory; row and column
//       sums of M in a fixed order; then dla by a warp's fp64 reverse scan,
//       ddt, dx, and the chunk's share of dA;
//   (4) ssd_bwd_reduce: dB and dC summed over the heads in head order where
//       the heads share B and C (the model's case: one (B, L, N) gradient,
//       never an (B, H, L, N) one for autograd to sum), else cast per head;
//       dA summed over the chunks in order.
// Every product is a loop of fp32 FMAs over shared memory, a thread owning
// one column and the rows a block-stride apart (shared rows padded to an
// odd length, so a warp's column reads hit 32 banks and its row reads are
// broadcasts). A simple kernel: its products move to the tensor cores in a
// later redesign (ROADMAP Queue 2).
//
// Shapes: P and N powers of two in [4, 128] with P * N <= 8192, any Q with
// L % Q == 0, the chunk kernel's shared memory within 227 KB (mamba2's P
// 64, N 128, Q 256: 225,800 bytes; jamba's N 16 111,112). Operands are
// strided views with unit stride on the last axis (x (B, H, L, P), dt (B,
// H, L), A (B, H), B/C (B, H, L, N), h stride 0 where the heads share
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
  float h = 0.f;
  for (int c = 0; c < nc; ++c) {             // states entering each chunk
    const float own = st[(long long)c * PN];
    st[(long long)c * PN] = h;
    h = dec[c] * h + own;
  }
  float g = p.dh != nullptr ? p.dh[(long long)bh * PN + e] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {        // gradients of states leaving
    const float own = ds[(long long)c * PN];
    ds[(long long)c * PN] = g;
    g = dec[c] * g + own;
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
    for (int k = 0; k < per; ++k) {          // in head order
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

}  // namespace

extern "C" {

// Bytes of shared memory the backward's launches (1) and (3) need for (P,
// N, Q): ``chunk`` picks (3).
long long ssd_scan_bwd_smem_bytes(int P, int N, int Q, int chunk) {
  return chunk ? chunk_smem_bytes(P, N, Q) : states_smem_bytes(P, N, Q);
}

// The backward. Launches (1)-(4) on ``stream``; returns the first non-zero
// cudaGetLastError() (or cudaErrorInvalidValue for sizes it does not take).
// ``strides`` holds 23 element strides: x (b, h, l), dt (b, h, l), A (b,
// h), B (b, h, l), C (b, h, l), dy (b, h, l), dx (b, h, l), ddt (b, h, l);
// the last axes of x, B, C, dy and dx have unit stride. x, B, C and dx
// share one type (``x_bf16``); dt, A, dy, dh, ddt and dA are fp32. dh
// (Bsz*H, P, N) contiguous, or null for zero. dB and dC are written
// contiguous (Bsz, 1, L, N) summed over the heads when ``shared_bc``, else
// (Bsz, H, L, N); dA (Bsz, H). ``ws`` holds 4 * (2 * BH * nc * (P * N + 1)
// + 2 * BH * L * N) bytes (BH = Bsz * H, nc = L / Q). ``smem_state`` and
// ``smem_chunk`` (launches (1) and (3)) and ``reduce_blocks`` (launch (4))
// are the Python plan's (ssd_scan.py:bwd_plan), each at least what the
// layouts above need.
int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, const void* dy,
                 const void* dh, void* dx, void* ddt, void* dA, void* dB,
                 void* dC, void* ws, int Bsz, int H, int L, int P, int N,
                 int Q, int shared_bc, const long long* strides, int x_bf16,
                 int smem_state, int smem_chunk, int reduce_blocks,
                 void* stream) {
  if (Bsz <= 0 || H <= 0 || L <= 0) return 0;
  const int lgP = log2_exact(P), lgN = log2_exact(N);
  if (lgP < 2 || lgP > 7 || lgN < 2 || lgN > 7 || P * N > 8192 || Q <= 0 ||
      L % Q || smem_chunk < chunk_smem_bytes(P, N, Q) ||
      smem_state < states_smem_bytes(P, N, Q) || smem_chunk > 232448 ||
      smem_state > 232448 || reduce_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = L / Q;
  const long long BH = (long long)Bsz * H, PN = (long long)P * N;
  float* w = static_cast<float*>(ws);
  BwdParams p{x, static_cast<const float*>(dt), static_cast<const float*>(A),
              Bm, Cm, static_cast<const float*>(dy),
              static_cast<const float*>(dh), dx, static_cast<float*>(ddt),
              dB, dC, static_cast<float*>(dA),
              w, w + BH * nc * PN, w + 2 * BH * nc * PN,
              w + 2 * BH * nc * PN + BH * nc,
              w + 2 * BH * nc * (PN + 1),
              w + 2 * BH * nc * (PN + 1) + BH * (long long)L * N,
              Bsz, H, shared_bc ? 1 : H, L, P, N, Q, nc, lgP, lgN,
              strides[0], strides[1], strides[2], strides[3], strides[4],
              strides[5], strides[6], strides[7], strides[8], strides[9],
              strides[10], strides[11], strides[12], strides[13],
              strides[14], strides[15], strides[16], strides[17],
              strides[18], strides[19], strides[20], strides[21],
              strides[22]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = P > N ? P : N;
#define SSD_BWD_PLAN p, smem_state, smem_chunk, reduce_blocks, s
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
