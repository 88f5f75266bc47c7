// GQA attention backward for Hopper (sm_90a). For the forward
//
//     o[b, h, g, i] = sum_j P[i, j] v[b, h, j],
//     P[i, :] = softmax_j(q[b, h, g, i] . k[b, h, j] * scale)
//
// over the keys j <= i when causal (top-left aligned, as the forward's
// ``ki <= qi``) or all Skv of them, and the upstream gradient dO, it gives
//
//     Delta_i = sum_d dO[i, d] o[i, d]
//     dS[i, j] = P[i, j] (dO_i . v_j - Delta_i)
//     dq_i = scale sum_j dS[i, j] k_j
//     dk_j = scale sum_{g, i} dS[i, j] q_i,   dv_j = sum_{g, i} P[i, j] dO_i
//
// fp32 inside, for fp32 or bf16 q, k, v, o and dO (one type); dq, dk and
// dv come out in that type. Query head h*G + g reads kv head h.
//
// Replaces no TPU kernel: the JAX package trains through the plain
// ``_sdpa`` (repro/models/transformer.py) under jax.value_and_grad, with
// no custom_vjp, so there is no backward kernel to carry over. The port's
// forward runs the hand-written flash_attention kernel, whose output
// autograd cannot differentiate, so training needs this one.
//
// In every kernel below the rows of one (b, kv head) are flattened
// query-major, r = i*G + g (as the forward does), so the G query heads of
// a kv head share every K/V tile a block stages, and the GQA sums of dk and
// dv over the G heads fall out of a key tile's walk over the rows. Each
// output tile is written by one block: no atomics, so reruns give the same
// bits. All operands are addressed through their strides (unit stride on
// the last axis), so the forward's permuted views need no copy.
//
// Bound: at llama3.2-1b's training shape (batch 4 x 512, D 64, causal,
// bf16) a layer's call must move ~42 MB and do five products of 2*D flops
// per scored (query, key) pair, 10.8 GFLOP: 12.5 us at 3.35 TB/s against
// 10.9 us at 989 TFLOP/s, so bytes bound it, but only if every product runs
// on the tensor cores. The route follows dtype and head dim, as the
// forward's; ``flash_attention.bwd_plan`` chooses it and plans the tensor
// route's launches (which tile each block takes, in what order, which tiles
// it walks and which of those it masks), and the kernels read that plan:
//
// The tensor-core route (bf16, D = 64 or 128), two launches in stream order,
// every product a wgmma.mma_async m64nNk16 (bf16 in, fp32 accumulate):
//   (a) dq_kernel_wgmma, a warpgroup per 64-row query tile. A first sweep over
//       the key tiles gives each row's log2-sum-exp (S = Q K^T and an online
//       max and sum, as the forward runs them) and Delta = rowsum(dO o);
//       both go to the fp32 stats scratch. A second sweep gives dQ: S = Q K^T
//       and dP = dO V^T, P = 2^(S scale log2e - lse), dS = P (dP - Delta),
//       and dQ += dS K, where dS goes from the accumulator fragment to the
//       bf16 A fragment in registers (as the forward does with P) and the K
//       tile is read MN-major (the transpose flag).
//   (b) dkdv_kernel_wgmma, a block per 64-key tile, walking the 64-row query
//       tiles that can see its keys: S^T = K Q^T and dP^T = V dO^T,
//       P^T = 2^(S^T scale log2e - lse) from (a)'s stats, dV += P^T dO and
//       dK += dS^T Q, P^T and dS^T going to bf16 A fragments, and the Q and
//       dO tiles read MN-major from the stage they were read K-major from.
//       The dV product runs while dS^T is formed. Two warpgroups split the
//       walk (alternate row tiles, each its own ring) and add their sums in
//       a fixed order at the end: the causal triangle's first key tiles see
//       every row, and one warpgroup walking them alone set (b)'s length
//       (0.091 of 0.138 ms at llama3.2-1b's shape on an H100).
//   * Tiles are staged by 16-byte cp.async into the 128-byte swizzle the
//     wgmma descriptors read (row r's 16-byte chunk c at chunk c ^ r % 8 of
//     a 64 x 64 panel), two stages a block, so the next tile's loads fly
//     while this one's products run. cp.async rather than TMA: a 64-row
//     query tile is G heads x 64/G positions of a strided view, any G, which
//     no one TMA box addresses; rows past Sq*G or Skv are zero-filled.
//   * Q and dO (a), K and V (b) stay in shared memory for the block's life
//     and are the A operands of the first two products from there (A by
//     descriptor), which keeps (b)'s two D-wide accumulators, the fp32 S^T
//     and dP^T and the bf16 fragments in registers at D = 128.
//   * Causal, by the plan: a block skips the tiles wholly above the diagonal
//     (top-left aligned, key <= position), masks element by element only the
//     tiles that cross it or the edge of Sq*G or Skv, and the heaviest tiles
//     launch first (the last query tiles in (a), the first key tiles in
//     (b)). Keys that no query sees (Skv > Sq) get a block with no rows to
//     walk, which writes their dk and dv as zeros.
//   * P and dS are rounded to bf16 before their products (the plain version
//     keeps them in fp32): about 2^-9 relative per term, inside the bf16
//     bound of 3e-2, as the forward rounds P.
//
// The CUDA-core route (fp32 at any D; bf16 at D = 32 and 96): wgmma has no
// full-fp32 mode (TF32 would break the fp32 bound of 3e-5), and the small and
// odd head dims stay here until they move onto wgmma. Three launches:
//   1. stats: per block of query rows, the row's log2-sum-exp over its
//      keys and Delta; both into fp32 scratch;
//   2. dkdv: a block owns a tile of keys (each key's k, v, dk and dv in the
//      registers of a group of TPR lanes) and walks the query rows that
//      can see them in tiles staged in shared memory, recomputing P from
//      the stats;
//   3. dq: per block of query rows, the same walk over key tiles as 1.
// Every product runs in fp32 FMAs: a thread holds D/TPR of the head dims
// (dim d = sub + TPR*t, so the lanes of a group read neighbouring shared
// words), and the partial dot products are combined by TPR-lane shuffles.
// Kernels 2 and 3 skip what a causal mask removes.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;                 // keys (1, 3) or query rows (2)
                                          // staged per shared tile
constexpr float kLog2e = 1.4426950408889634f;

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
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// element strides of the operands: a 5-d (B, KV, G, S, D) tensor uses
// [0..3], a 4-d (B, KV, S, D) one [0..2]
struct Strides {
  long long q[4], k[3], v[3], o[4], dO[4], dq[4], dk[3], dv[3];
};

template <int TPR>
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <int TPR>
__device__ __forceinline__ void group_sum2(float& a, float& b) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
}

// rows [j0, j0 + kTile) of a (S, D) slab with row stride ``rs`` into
// shared fp32, zeros past ``n``
template <typename T, int D>
__device__ __forceinline__ void stage(float (*dst)[D], const T* src,
                                      long long rs, int j0, int n) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int row = e / D, col = e % D;
    const int j = j0 + row;
    dst[row][col] = j < n ? to_f32(src[(long long)j * rs + col]) : 0.f;
  }
}

// 1. per query row: lse2 = log2 sum_j 2^(s_j log2e) and Delta
template <typename T, int D, int TPR>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ o, const T* __restrict__ dO, Strides st,
             float* __restrict__ lse, float* __restrict__ delta, int KV,
             int G, int Sq, int Skv, int causal, float scale) {
  constexpr int DPT = D / TPR, ROWS = kThreads / TPR;
  __shared__ float ks[kTile][D];
  const int b = blockIdx.y / KV, h = blockIdx.y % KV;
  const int R = Sq * G;
  const int sub = threadIdx.x % TPR;
  const int r = blockIdx.x * ROWS + threadIdx.x / TPR;
  const bool live = r < R;
  const int i = live ? r / G : 0, g = live ? r % G : 0;
  const float sl2 = scale * kLog2e;

  const T* qr = q + b * st.q[0] + h * st.q[1] + g * st.q[2] + i * st.q[3];
  float qv[DPT];
#pragma unroll
  for (int t = 0; t < DPT; ++t) qv[t] = live ? to_f32(qr[sub + TPR * t]) : 0.f;

  const int rlast = min(R, (blockIdx.x + 1) * ROWS) - 1;
  const int kend = causal ? min(Skv, rlast / G + 1) : Skv;
  const T* kb = k + b * st.k[0] + h * st.k[1];
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < kend; j0 += kTile) {
    __syncthreads();
    stage<T, D>(ks, kb, st.k[2], j0, Skv);
    __syncthreads();
    const int jn = min(kTile, kend - j0);
    for (int jj = 0; jj < jn; ++jj) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < DPT; ++t) s += qv[t] * ks[jj][sub + TPR * t];
      s = group_sum<TPR>(s) * sl2;
      if (live && (!causal || j0 + jj <= i)) {
        if (s > m) {
          l = l * exp2f(m - s) + 1.f;
          m = s;
        } else {
          l += exp2f(s - m);
        }
      }
    }
  }
  const T* orow = o + b * st.o[0] + h * st.o[1] + g * st.o[2] + i * st.o[3];
  const T* drow = dO + b * st.dO[0] + h * st.dO[1] + g * st.dO[2] +
                  i * st.dO[3];
  float dl = 0.f;
#pragma unroll
  for (int t = 0; t < DPT; ++t)
    if (live) dl += to_f32(orow[sub + TPR * t]) * to_f32(drow[sub + TPR * t]);
  dl = group_sum<TPR>(dl);
  if (live && sub == 0) {
    const long long idx = (long long)blockIdx.y * R + r;
    lse[idx] = m + log2f(l);
    delta[idx] = dl;
  }
}

// 2. per key tile: dk and dv over every query row that sees it
template <typename T, int D, int TPR>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dO, Strides st,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int KV, int G, int Sq,
            int Skv, int causal, float scale) {
  constexpr int DPT = D / TPR, KEYS = kThreads / TPR;
  __shared__ float qs[kTile][D];
  __shared__ float dos[kTile][D];          // dO rows
  __shared__ float ls[kTile], dl[kTile];
  const int b = blockIdx.y / KV, h = blockIdx.y % KV;
  const int R = Sq * G;
  const int sub = threadIdx.x % TPR;
  const int j0 = blockIdx.x * KEYS;
  const int j = j0 + threadIdx.x / TPR;
  const bool live = j < Skv;
  const float sl2 = scale * kLog2e;

  const T* kr = k + b * st.k[0] + h * st.k[1] + (live ? j : 0) * st.k[2];
  const T* vr = v + b * st.v[0] + h * st.v[1] + (live ? j : 0) * st.v[2];
  float kv_[DPT], vv[DPT], dka[DPT], dva[DPT];
#pragma unroll
  for (int t = 0; t < DPT; ++t) {
    kv_[t] = live ? to_f32(kr[sub + TPR * t]) : 0.f;
    vv[t] = live ? to_f32(vr[sub + TPR * t]) : 0.f;
    dka[t] = 0.f;
    dva[t] = 0.f;
  }

  // query rows r = i*G + g with i >= j0 can see this tile when causal
  const int rstart = causal ? min(R, j0 * G) / kTile * kTile : 0;
  const long long sidx = (long long)blockIdx.y * R;
  for (int r0 = rstart; r0 < R; r0 += kTile) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
      const int row = e / D, col = e % D;
      const int rr = r0 + row;
      float qe = 0.f, de = 0.f;
      if (rr < R) {
        const int ii = rr / G, gg = rr % G;
        qe = to_f32(q[b * st.q[0] + h * st.q[1] + gg * st.q[2] +
                      ii * st.q[3] + col]);
        de = to_f32(dO[b * st.dO[0] + h * st.dO[1] + gg * st.dO[2] +
                       ii * st.dO[3] + col]);
      }
      qs[row][col] = qe;
      dos[row][col] = de;
    }
    if (threadIdx.x < kTile) {
      const int rr = r0 + threadIdx.x;
      ls[threadIdx.x] = rr < R ? lse[sidx + rr] : 0.f;
      dl[threadIdx.x] = rr < R ? delta[sidx + rr] : 0.f;
    }
    __syncthreads();
    const int rn = min(kTile, R - r0);
    for (int rr = 0; rr < rn; ++rr) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int t = 0; t < DPT; ++t) {
        s += qs[rr][sub + TPR * t] * kv_[t];
        dp += dos[rr][sub + TPR * t] * vv[t];
      }
      group_sum2<TPR>(s, dp);
      const int i = (r0 + rr) / G;
      const bool ok = live && (!causal || j <= i);
      const float p = ok ? exp2f(s * sl2 - ls[rr]) : 0.f;
      const float dsv = p * (dp - dl[rr]);
#pragma unroll
      for (int t = 0; t < DPT; ++t) {
        dva[t] += p * dos[rr][sub + TPR * t];
        dka[t] += dsv * qs[rr][sub + TPR * t];
      }
    }
  }
  if (live) {
    T* dkr = dk + b * st.dk[0] + h * st.dk[1] + j * st.dk[2];
    T* dvr = dv + b * st.dv[0] + h * st.dv[1] + j * st.dv[2];
#pragma unroll
    for (int t = 0; t < DPT; ++t) {
      dkr[sub + TPR * t] = from_f32<T>(dka[t] * scale);
      dvr[sub + TPR * t] = from_f32<T>(dva[t]);
    }
  }
}

// 3. per query row: dq over the keys it sees
template <typename T, int D, int TPR>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dO, Strides st,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int KV, int G, int Sq, int Skv, int causal,
          float scale) {
  constexpr int DPT = D / TPR, ROWS = kThreads / TPR;
  __shared__ float ks[kTile][D];
  __shared__ float vs[kTile][D];
  const int b = blockIdx.y / KV, h = blockIdx.y % KV;
  const int R = Sq * G;
  const int sub = threadIdx.x % TPR;
  const int r = blockIdx.x * ROWS + threadIdx.x / TPR;
  const bool live = r < R;
  const int i = live ? r / G : 0, g = live ? r % G : 0;
  const float sl2 = scale * kLog2e;

  const T* qr = q + b * st.q[0] + h * st.q[1] + g * st.q[2] + i * st.q[3];
  const T* dr = dO + b * st.dO[0] + h * st.dO[1] + g * st.dO[2] +
                i * st.dO[3];
  float qv[DPT], dv_[DPT], acc[DPT];
#pragma unroll
  for (int t = 0; t < DPT; ++t) {
    qv[t] = live ? to_f32(qr[sub + TPR * t]) : 0.f;
    dv_[t] = live ? to_f32(dr[sub + TPR * t]) : 0.f;
    acc[t] = 0.f;
  }
  const long long idx = (long long)blockIdx.y * R + (live ? r : 0);
  const float lrow = live ? lse[idx] : 0.f;
  const float drow = live ? delta[idx] : 0.f;

  const int rlast = min(R, (blockIdx.x + 1) * ROWS) - 1;
  const int kend = causal ? min(Skv, rlast / G + 1) : Skv;
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  for (int j0 = 0; j0 < kend; j0 += kTile) {
    __syncthreads();
    stage<T, D>(ks, kb, st.k[2], j0, Skv);
    stage<T, D>(vs, vb, st.v[2], j0, Skv);
    __syncthreads();
    const int jn = min(kTile, kend - j0);
    for (int jj = 0; jj < jn; ++jj) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int t = 0; t < DPT; ++t) {
        s += qv[t] * ks[jj][sub + TPR * t];
        dp += dv_[t] * vs[jj][sub + TPR * t];
      }
      group_sum2<TPR>(s, dp);
      const bool ok = live && (!causal || j0 + jj <= i);
      const float p = ok ? exp2f(s * sl2 - lrow) : 0.f;
      const float dsv = p * (dp - drow);
#pragma unroll
      for (int t = 0; t < DPT; ++t) acc[t] += dsv * ks[jj][sub + TPR * t];
    }
  }
  if (live) {
    T* out = dq + b * st.dq[0] + h * st.dq[1] + g * st.dq[2] + i * st.dq[3];
#pragma unroll
    for (int t = 0; t < DPT; ++t) out[sub + TPR * t] = from_f32<T>(acc[t] * scale);
  }
}

template <typename T, int D, int TPR>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* dO, void* dq, void* dk, void* dv, float* lse,
             float* delta, const Strides& st, int B, int KV, int G, int Sq,
             int Skv, int causal, float scale, cudaStream_t stream) {
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v), *op = static_cast<const T*>(o),
          *dop = static_cast<const T*>(dO);
  const int R = Sq * G;
  constexpr int ROWS = kThreads / TPR;
  const dim3 rows_grid((R + ROWS - 1) / ROWS, B * KV);
  const dim3 keys_grid((Skv + ROWS - 1) / ROWS, B * KV);
  if (rows_grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  stats_kernel<T, D, TPR><<<rows_grid, kThreads, 0, stream>>>(
      qp, kp, op, dop, st, lse, delta, KV, G, Sq, Skv, causal, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T, D, TPR><<<keys_grid, kThreads, 0, stream>>>(
      qp, kp, vp, dop, st, lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), KV, G, Sq, Skv, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, D, TPR><<<rows_grid, kThreads, 0, stream>>>(
      qp, kp, vp, dop, st, lse, delta, static_cast<T*>(dq), KV, G, Sq, Skv,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}


// -- the tensor-core route (bf16, D = 64, 128) -------------------------------

constexpr int kWgThreads = 128;           // one warpgroup a block
constexpr int kRows = 64;                 // query rows of a tile
constexpr int kKeys = 64;                 // keys of a tile
constexpr int kPanel = 64 * 128;          // bytes of a 64-row x 64-column panel
constexpr int kStages = 2;                // tiles in a warpgroup's ring
constexpr int kDkdvWgs = 2;               // warpgroups of a dkdv block
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest group complete, this thread's writes made visible to
// the tensor cores' async proxy; the caller's __syncthreads() does the rest
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of warpgroup ``wg``'s 128 threads alone (id 1 + wg; 0 is the
// block's __syncthreads)
__device__ __forceinline__ void group_bar(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(kWgThreads) : "memory");
}

// A wgmma shared-memory descriptor of the 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// k-slice kk (16 columns) of a 64-row tile read K-major: the slice's 32
// bytes of every row, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return smem_desc(tile + (kk / 4) * kPanel + (kk % 4) * 32, 16, 1024);
}
// k-slice kk (16 rows) of a tile read MN-major: 64-column panels one panel
// apart, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 16 * 128, kPanel, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator (or from
// reusing an A fragment's registers) across the asynchronous products that
// own it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x on the special-function unit (about 2 ulp; 0 far below -126)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x 64, fp32) += a (64 x 16) * b (16 x 64), both bf16 in shared
// memory, both read K-major through their descriptors.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, fp32) += a (64 x 16, bf16 registers) * b (16 x 64, bf16 in
// shared memory, read MN-major through ``desc``).
__device__ __forceinline__ void wgmma_rs_m64n64k16(
    float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 128, fp32) += a (64 x 16, bf16 registers) * b (16 x 128, bf16 in
// shared memory, read MN-major through ``desc``).
__device__ __forceinline__ void wgmma_rs_m64n128k16(
    float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// acc (64 x D) += a (64 x 64, bf16 fragments) * the 64 x D tile at
// ``tile`` read MN-major (its rows are the products' k)
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&a)[4][4],
                                         uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 64)
      wgmma_rs_m64n64k16(acc, a[kk], desc_mn(tile, kk));
    else
      wgmma_rs_m64n128k16(acc, a[kk], desc_mn(tile, kk));
  }
}

// the accumulator of a 64 x 64 product as bf16 A fragments of the next one:
// n8 group j of the accumulator (columns 8j .. 8j + 7) is half of k-slice
// j / 2, its rows lane/4 and lane/4 + 8 in registers 0, 1 (or 2, 3)
__device__ __forceinline__ void to_frags(const float (&c)[32],
                                         uint32_t (&f)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    f[j / 2][(j % 2) * 2 + 0] = pack_bf16(c[4 * j + 0], c[4 * j + 1]);
    f[j / 2][(j % 2) * 2 + 1] = pack_bf16(c[4 * j + 2], c[4 * j + 3]);
  }
}

// n / d for 0 <= n < 2^31 by a multiply and a shift, d fixed for a launch
// (the round-up reciprocal, as CUTLASS's FastDivmod): an integer division
// is some twenty instructions. (b)'s causal mask takes none at all (key j
// is hidden from row r = i*G + g exactly when j*G > r): its per-element
// r / G took a third of (b)'s time at llama3.2-1b's shape on an H100.
struct FastDiv {
  uint32_t mul, shift;
  int d;
  static FastDiv of(int d) {
    uint32_t s = 0;
    while ((1u << s) < static_cast<uint32_t>(d)) ++s;
    const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
    return FastDiv{static_cast<uint32_t>(m), s, d};
  }
  __device__ __forceinline__ int div(int n) const {
    return static_cast<int>(
        (__umulhi(static_cast<uint32_t>(n), mul) + static_cast<uint32_t>(n)) >>
        shift);
  }
};
constexpr FastDiv kOne{1u, 0u, 1};

// Rows r0 .. r0 + 63 of a slab of ``n`` rows (row r at base + (r / G) s_i +
// (r % G) s_g, D contiguous bf16) into D/64 swizzled panels at ``dst`` by
// 16-byte cp.async: chunk c of row r lands at chunk c ^ (r % 8) of its
// 128-byte panel row, the layout a TMA box of the 128-byte swizzle writes
// and the descriptors above read. Rows past ``n`` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16_bits* base,
                                          long long s_i, long long s_g,
                                          FastDiv G, int r0, int n, int tid) {
  constexpr int kChunks = D / 8;            // 16-byte chunks a row
#pragma unroll
  for (int u = 0; u < kRows * kChunks / kWgThreads; ++u) {
    const int e = tid + u * kWgThreads;
    const int r = e / kChunks, c = e % kChunks;
    const int rr = r0 + r;
    const bool ok = rr < n;
    const int i = G.div(rr);
    const bf16_bits* src =
        ok ? base + i * s_i + (rr - i * G.d) * s_g + 8 * c : base;
    cp_async16(dst + (c / 8) * kPanel + r * 128 + (((c % 8) ^ (r % 8)) << 4),
               src, ok);
  }
}

template <int D>
struct WgSmem {
  static constexpr int kTile = (D / 64) * kPanel;     // a 64 x D bf16 tile
  // (a): Q, dO, a ring of (K, V) stages, Delta of the tile's rows
  static constexpr int kDqBytes = (2 + 2 * kStages) * kTile + 256 + 1024;
  // (b): K, V, and each warpgroup's ring of (Q, dO, lse and Delta of the
  // rows) stages, which also holds group 1's sums at the end
  static constexpr int kStage = 2 * kTile + 1024;
  static constexpr int kDkdvBytes =
      2 * kTile + kDkdvWgs * kStages * kStage + 1024;
  static_assert(kDkdvWgs * kStages * kStage >= 2 * D * kWgThreads * 4,
                "the rings hold a warpgroup's dK and dV sums");
};

// (a) per 64-row query tile: the rows' lse (log2 domain) and Delta into the
// stats, then dQ over the key tiles the rows see.
template <int D>
__global__ void __launch_bounds__(kWgThreads)
dq_kernel_wgmma(const bf16_bits* __restrict__ q,
                const bf16_bits* __restrict__ k,
                const bf16_bits* __restrict__ v,
                const bf16_bits* __restrict__ o,
                const bf16_bits* __restrict__ dO, bf16_bits* __restrict__ dq,
                float* __restrict__ lse, float* __restrict__ delta, Strides st,
                const int* __restrict__ slots, FastDiv gdiv, int B, int KV,
                int G, int Sq, int Skv, int causal, float scale,
                float scale_log2) {
  using L = WgSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the shared address: align tiles to 1 KB
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + L::kTile;
  const uint32_t ring = base + 2 * L::kTile;
  float* const delta_s = reinterpret_cast<float*>(
      smem_raw + (base - raw) + (2 + 2 * kStages) * L::kTile);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int bhs = B * KV, R = Sq * G;
  // the plan's slot: the query tile, the key tiles 0 .. n_kt - 1 it walks
  // (>= 1: key 0 is seen) and the first of them that needs a mask
  const int* slot = slots + 3 * (static_cast<int>(blockIdx.x) / bhs);
  const int qt = __ldg(slot), n_kt = __ldg(slot + 1), n_full = __ldg(slot + 2);
  const int bh = static_cast<int>(blockIdx.x) % bhs;
  const int b = bh / KV, h = bh % KV;
  const int r0 = qt * kRows;

  const bf16_bits* qb = q + b * st.q[0] + h * st.q[1];
  const bf16_bits* dob = dO + b * st.dO[0] + h * st.dO[1];
  const bf16_bits* kb = k + b * st.k[0] + h * st.k[1];
  const bf16_bits* vb = v + b * st.v[0] + h * st.v[1];

  // step t < n_kt stages key tile t's K (the lse sweep), step n_kt + u key
  // tile u's K and V (the dQ sweep)
  auto issue = [&](int t) {
    const int u = t < n_kt ? t : t - n_kt;
    const uint32_t kd = ring + (t % kStages) * 2 * L::kTile;
    load_tile<D>(kd, kb, st.k[2], 0, kOne, u * kKeys, Skv, tid);
    if (t >= n_kt) load_tile<D>(kd + L::kTile, vb, st.v[2], 0, kOne,
                                u * kKeys, Skv, tid);
  };
  load_tile<D>(q_s, qb, st.q[3], st.q[2], gdiv, r0, R, tid);
  load_tile<D>(do_s, dob, st.dO[3], st.dO[2], gdiv, r0, R, tid);
  issue(0);
  cp_async_commit();

  // Delta while the first tiles fly: two threads a row, D/2 columns each
  {
    const int rr = r0 + tid / 2;
    float dl = 0.f;
    if (rr < R) {
      const int i = rr / G, g = rr % G;
      const uint4* orow = reinterpret_cast<const uint4*>(
          o + b * st.o[0] + h * st.o[1] + g * st.o[2] + i * st.o[3] +
          (tid % 2) * (D / 2));
      const uint4* drow = reinterpret_cast<const uint4*>(
          dob + g * st.dO[2] + i * st.dO[3] + (tid % 2) * (D / 2));
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const uint4 a = orow[c], d = drow[c];
        const uint32_t av[4] = {a.x, a.y, a.z, a.w};
        const uint32_t dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          dl += __uint_as_float(av[w] << 16) * __uint_as_float(dv[w] << 16);
          dl += __uint_as_float(av[w] & 0xffff0000u) *
                __uint_as_float(dv[w] & 0xffff0000u);
        }
      }
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    if (tid % 2 == 0) {
      delta_s[tid / 2] = dl;
      if (rr < R) delta[static_cast<long long>(bh) * R + rr] = dl;
    }
  }

  // the thread's two accumulator rows, lane/4 and lane/4 + 8 of its warp's 16
  int rows[2], qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = r0 + warp * 16 + lane / 4 + 8 * i;
    qpos[i] = rows[i] / G;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // step t's tile in place: the next step's tile goes in flight (an empty
  // group past the end keeps the group count uniform), this one is waited
  const int steps = 2 * n_kt;
  auto arrive = [&](int t) -> uint32_t {
    if (t + 1 < steps) issue(t + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    return ring + (t % kStages) * 2 * L::kTile;
  };
  // element e of n8 group j sits at row lane/4 + 8*(e/2), key
  // k0 + 8j + 2*quad + e%2; scores a row must not count are -1e30, only on
  // the key tiles the plan masks (they cross the diagonal or Skv)
  auto mask = [&](float (&s)[32], int t) {
    if (t < n_full) return;
    const int k0 = t * kKeys;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + 2 * quad + (e & 1);
        if (kpos >= Skv || (causal && kpos > qpos[e >> 1]))
          s[4 * j + e] = kNegInf;
      }
  };

  // the lse sweep: S = Q K^T, the online max and sum of 2^(s scale log2e),
  // per row over its quad
  for (int t = 0; t < n_kt; ++t) {
    const uint32_t k_tile = arrive(t);
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(s, desc_k(q_s, kk), desc_k(k_tile, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    mask(s, t);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    float msc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      l[i] *= fast_exp2((m[i] - m_new) * scale_log2);
      m[i] = m_new;
      msc[i] = m_new * scale_log2;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        l[e >> 1] += fast_exp2(fmaf(s[4 * j + e], scale_log2, -msc[e >> 1]));
    __syncthreads();                        // stage t % kStages is free again
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    lse2[i] = m[i] * scale_log2 + log2f(l[i]);
    dl[i] = delta_s[warp * 16 + lane / 4 + 8 * i];
    if (quad == 0 && rows[i] < R)
      lse[static_cast<long long>(bh) * R + rows[i]] = lse2[i];
  }

  // the dQ sweep: S = Q K^T and dP = dO V^T, dS = P (dP - Delta) with
  // P = 2^(s scale log2e - lse) (masked P = 0), dQ += dS K
  for (int t = n_kt; t < steps; ++t) {
    const uint32_t k_tile = arrive(t);
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(s, desc_k(q_s, kk), desc_k(k_tile, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(dp, desc_k(do_s, kk), desc_k(k_tile + L::kTile, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    mask(s, t - n_kt);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = fast_exp2(fmaf(s[4 * j + e], scale_log2, -lse2[i]));
        dp[4 * j + e] = p * (dp[4 * j + e] - dl[i]);
      }
    uint32_t dsf[4][4];
    to_frags(dp, dsf);
    fence_regs(acc);
    wgmma_fence();
    issue_rs<D>(acc, dsf, k_tile);          // dQ += dS K, K read MN-major
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_frags(dsf);
    __syncthreads();                        // stage t % kStages is free again
  }

  // dq = scale * acc; element e of n8 group j at column 8j + 2*quad + e%2
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= R) continue;
    bf16_bits* out = dq + b * st.dq[0] + h * st.dq[1] +
                     (rows[i] % G) * st.dq[2] + qpos[i] * st.dq[3];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * quad) =
          pack_bf16(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
  }
}

// (b) per 64-key tile: dK and dV over the query tiles that see its keys,
// the walk split between two warpgroups (row tiles 0, 2, 4, ... and 1, 3,
// 5, ...), whose sums are added in that order at the end.
template <int D>
__global__ void __launch_bounds__(kDkdvWgs * kWgThreads, 1)
dkdv_kernel_wgmma(const bf16_bits* __restrict__ q,
                  const bf16_bits* __restrict__ k,
                  const bf16_bits* __restrict__ v,
                  const bf16_bits* __restrict__ dO,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16_bits* __restrict__ dk,
                  bf16_bits* __restrict__ dv, Strides st,
                  const int* __restrict__ slots, FastDiv gdiv, int B, int KV,
                  int G, int Sq, int Skv, int causal, float scale,
                  float scale_log2) {
  using L = WgSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t k_s = base, v_s = base + L::kTile;
  const uint32_t ring0 = base + 2 * L::kTile;

  const int wg = threadIdx.x / kWgThreads;
  const int tid = threadIdx.x % kWgThreads, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  const uint32_t ring = ring0 + wg * kStages * L::kStage;  // this group's
  const int bhs = B * KV, R = Sq * G;
  // the plan's slot: the key tile, the row tiles t0 .. t0 + n_rt - 1 it
  // walks (the 64-row tiles of (a); none for keys no query sees) and the
  // unmasked ones among them, [lo, hi)
  const int* slot = slots + 5 * (static_cast<int>(blockIdx.x) / bhs);
  const int kt = __ldg(slot), t0 = __ldg(slot + 1), n_rt = __ldg(slot + 2);
  const int full_lo = __ldg(slot + 3), full_hi = __ldg(slot + 4);
  const int bh = static_cast<int>(blockIdx.x) % bhs;
  const int b = bh / KV, h = bh % KV;
  const int j0 = kt * kKeys;
  const int n_mine = (n_rt - wg + kDkdvWgs - 1) / kDkdvWgs;

  const bf16_bits* qb = q + b * st.q[0] + h * st.q[1];
  const bf16_bits* dob = dO + b * st.dO[0] + h * st.dO[1];
  const float* lse_b = lse + static_cast<long long>(bh) * R;
  const float* delta_b = delta + static_cast<long long>(bh) * R;

  auto issue = [&](int s) {       // this group's s-th row tile: Q, dO, stats
    const int r0 = (t0 + wg + kDkdvWgs * s) * kRows;
    const uint32_t qd = ring + (s % kStages) * L::kStage;
    load_tile<D>(qd, qb, st.q[3], st.q[2], gdiv, r0, R, tid);
    load_tile<D>(qd + L::kTile, dob, st.dO[3], st.dO[2], gdiv, r0, R, tid);
    const int rr = r0 + tid % kRows;
    const float* src = tid < kRows ? lse_b : delta_b;
    cp_async4(qd + 2 * L::kTile + 4 * tid, rr < R ? src + rr : src, rr < R);
  };

  // the thread's two accumulator rows are keys j0 + warp*16 + lane/4 (+8);
  // row r = i*G + g sees key j when j <= i, that is when j*G <= r
  int keys[2], key_g[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    keys[i] = j0 + warp * 16 + lane / 4 + 8 * i;
    key_g[i] = causal ? keys[i] * G : 0;
  }
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  // K (group 0's loads) and V (group 1's) with each group's first tile,
  // seen by both groups after the block's barrier
  if (n_rt > 0) {
    if (wg == 0)
      load_tile<D>(k_s, k + b * st.k[0] + h * st.k[1], st.k[2], 0, kOne, j0,
                   Skv, tid);
    else
      load_tile<D>(v_s, v + b * st.v[0] + h * st.v[1], st.v[2], 0, kOne, j0,
                   Skv, tid);
    if (n_mine > 0) issue(0);
    cp_async_commit();
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  for (int s = 0; s < n_mine; ++s) {
    if (s + 1 < n_mine) issue(s + 1);
    cp_async_commit();
    cp_async_wait_prev();
    group_bar(wg);
    const uint32_t q_tile = ring + (s % kStages) * L::kStage;
    const uint32_t do_tile = q_tile + L::kTile;
    const float* ls = reinterpret_cast<const float*>(
        base_ptr + (q_tile - base) + 2 * L::kTile);
    const float* ds_ = ls + kRows;
    const int rt = t0 + wg + kDkdvWgs * s, r0 = rt * kRows;
    const bool edge = rt < full_lo || rt >= full_hi;

    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(sc, desc_k(k_s, kk), desc_k(q_tile, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(dp, desc_k(v_s, kk), desc_k(do_tile, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // element e of n8 group j sits at key keys[e/2], query row
    // r0 + 8j + 2*quad + e%2: P^T from the row's lse, masked P = 0
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * quad;
      const float2 lc = *reinterpret_cast<const float2*>(ls + c);
      const float lr[2] = {lc.x, lc.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp2(fmaf(sc[4 * j + e], scale_log2, -lr[e & 1]));
        if (edge) {
          const int rr = r0 + c + (e & 1);
          if (keys[e >> 1] >= Skv || rr >= R || key_g[e >> 1] > rr) p = 0.f;
        }
        sc[4 * j + e] = p;
      }
    }
    uint32_t pf[4][4];
    to_frags(sc, pf);
    fence_regs(dva);
    wgmma_fence();
    issue_rs<D>(dva, pf, do_tile);           // dV += P^T dO, dO MN-major
    wgmma_commit();

    // dS^T = P^T (dP^T - Delta) while the dV product runs
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dc =
          *reinterpret_cast<const float2*>(ds_ + 8 * j + 2 * quad);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - (e & 1 ? dc.y : dc.x));
    }
    uint32_t dsf[4][4];
    to_frags(dp, dsf);
    fence_regs(dka);
    wgmma_fence();
    issue_rs<D>(dka, dsf, q_tile);           // dK += dS^T Q, Q MN-major
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dva);
    fence_regs(dka);
    fence_frags(pf);
    fence_frags(dsf);
    group_bar(wg);                           // stage s % kStages is free again
  }

  // group 1's sums go through the (idle) ring to group 0, which adds them
  // to its own, in that order: dk = scale * dka and dv = dva, keys past
  // Skv not written (a key no query sees is written as zeros)
  __syncthreads();
  float* const red = reinterpret_cast<float*>(base_ptr + (ring0 - base));
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      red[i * kWgThreads + tid] = dka[i];
      red[(D / 2 + i) * kWgThreads + tid] = dva[i];
    }
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dka[i] += red[i * kWgThreads + tid];
    dva[i] += red[(D / 2 + i) * kWgThreads + tid];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= Skv) continue;
    bf16_bits* dko = dk + b * st.dk[0] + h * st.dk[1] + keys[i] * st.dk[2];
    bf16_bits* dvo = dv + b * st.dv[0] + h * st.dv[1] + keys[i] * st.dv[2];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dko + 8 * j + 2 * quad) = pack_bf16(
          dka[4 * j + 2 * i] * scale, dka[4 * j + 2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvo + 8 * j + 2 * quad) =
          pack_bf16(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
    }
  }
}

// the dynamic shared memory above 48 KB, allowed once per device and kernel
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev] = true;
  }
  return 0;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dO, void* dq, void* dk, void* dv, float* lse,
                 float* delta, const Strides& st, const int* slots,
                 int dq_slots, int dkdv_slots, int B, int KV, int G, int Sq,
                 int Skv, int causal, float scale, cudaStream_t stream) {
  // the plan's slots: a query tile each in (a), a key tile each in (b)
  if (slots == nullptr ||
      dq_slots != (static_cast<long long>(Sq) * G + kRows - 1) / kRows ||
      dkdv_slots != (Skv + kKeys - 1) / kKeys)
    return static_cast<int>(cudaErrorInvalidValue);
  // every row is read 16 bytes at a time (cp.async, Delta's loads) and dq,
  // dk, dv written 4 bytes at a time
  long long ins = 0, outs = 0;
  for (int a = 0; a < 4; ++a) {
    ins |= st.q[a] | st.o[a] | st.dO[a];
    outs |= st.dq[a];
  }
  for (int a = 0; a < 3; ++a) {
    ins |= st.k[a] | st.v[a];
    outs |= st.dk[a] | st.dv[a];
  }
  ins |= static_cast<long long>(
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(dO)) / 2);
  outs |= static_cast<long long>(
      (reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
       reinterpret_cast<uintptr_t>(dv)) / 2);
  if ((ins & 7) || (outs & 1))            // in elements: 16 and 4 bytes
    return static_cast<int>(cudaErrorMisalignedAddress);
  static bool allowed_a[kMaxDevices] = {}, allowed_b[kMaxDevices] = {};
  int rc = allow_smem(dq_kernel_wgmma<D>, WgSmem<D>::kDqBytes, allowed_a);
  if (rc == 0)
    rc = allow_smem(dkdv_kernel_wgmma<D>, WgSmem<D>::kDkdvBytes, allowed_b);
  if (rc != 0) return rc;
  const long long bhs = static_cast<long long>(B) * KV;
  const long long qblocks = dq_slots * bhs, kblocks = dkdv_slots * bhs;
  if (qblocks > 0x7fffffffLL || kblocks > 0x7fffffffLL ||
      static_cast<long long>(Sq) * G > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bf16_bits *qp = static_cast<const bf16_bits*>(q),
                  *kp = static_cast<const bf16_bits*>(k),
                  *vp = static_cast<const bf16_bits*>(v),
                  *dop = static_cast<const bf16_bits*>(dO);
  const float scale_log2 = scale * kLog2e;
  dq_kernel_wgmma<D><<<static_cast<unsigned>(qblocks), kWgThreads,
                       WgSmem<D>::kDqBytes, stream>>>(
      qp, kp, vp, static_cast<const bf16_bits*>(o), dop,
      static_cast<bf16_bits*>(dq), lse, delta, st, slots, FastDiv::of(G), B,
      KV, G, Sq, Skv, causal, scale, scale_log2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel_wgmma<D><<<static_cast<unsigned>(kblocks),
                         kDkdvWgs * kWgThreads, WgSmem<D>::kDkdvBytes,
                         stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<bf16_bits*>(dk),
      static_cast<bf16_bits*>(dv), st, slots + 3 * dq_slots, FastDiv::of(G), B,
      KV, G, Sq, Skv, causal, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, void* dq, void* dk, void* dv, float* lse,
           float* delta, const Strides& st, const int* slots, int dq_slots,
           int dkdv_slots, int B, int KV, int G, int Sq, int Skv, int D,
           int causal, float scale, cudaStream_t stream) {
#define FB_ARGS q, k, v, o, dO, dq, dk, dv, lse, delta, st, B, KV, G, Sq, Skv, \
                causal, scale, stream
  if (slots != nullptr) {                 // the tensor cores: bf16, D 64, 128
    if constexpr (sizeof(T) == 2) {
#define FB_PLAN q, k, v, o, dO, dq, dk, dv, lse, delta, st, slots, dq_slots, \
                dkdv_slots, B, KV, G, Sq, Skv, causal, scale, stream
      if (D == 64) return launch_wgmma<64>(FB_PLAN);
      if (D == 128) return launch_wgmma<128>(FB_PLAN);
#undef FB_PLAN
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (D) {
    case 32: return launch_d<T, 32, 2>(FB_ARGS);
    case 64: return launch_d<T, 64, 4>(FB_ARGS);
    case 96: return launch_d<T, 96, 8>(FB_ARGS);
    case 128: return launch_d<T, 128, 8>(FB_ARGS);
  }
#undef FB_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches the route's kernels (two on the tensor cores, three on the CUDA
// cores) on ``stream`` and returns cudaGetLastError(). ``strides`` holds 28
// element strides in the order of ``Strides``: q, o, dO and dq are
// (B, KV, G, Sq, D) (4 each), k, v, dk and dv (B, KV, Skv, D) (3 each), the
// last axis unit-stride. ``lse`` and ``delta`` are fp32 scratch of
// B*KV*G*Sq each. ``bf16`` selects bf16 (1) or fp32 (0) for every operand;
// D is 32, 64, 96 or 128; Sq, Skv >= 1. ``slots`` selects the route: null
// for the CUDA-core kernels (any dtype and D), or the tensor route's plan
// (bf16 at D 64 and 128) as ``flash_attention.bwd_plan`` lays it out, int32
// on the device: ``dq_slots`` = ceil(Sq*G/64) slots of 3 for (a), then
// ``dkdv_slots`` = ceil(Skv/64) slots of 5 for (b). The tensor route needs
// q, k, v, o and dO 16-byte aligned (base and strides) and returns
// cudaErrorMisalignedAddress otherwise.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dO, void* dq, void* dk,
                        void* dv, void* lse, void* delta,
                        const long long* strides, const int* slots,
                        int dq_slots, int dkdv_slots, int B, int KV, int G,
                        int Sq, int Skv, int D, int causal, float scale,
                        int bf16, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || Sq <= 0 || Skv <= 0) return 0;
  Strides st;
  const long long* s = strides;
  for (int a = 0; a < 4; ++a) st.q[a] = *s++;
  for (int a = 0; a < 3; ++a) st.k[a] = *s++;
  for (int a = 0; a < 3; ++a) st.v[a] = *s++;
  for (int a = 0; a < 4; ++a) st.o[a] = *s++;
  for (int a = 0; a < 4; ++a) st.dO[a] = *s++;
  for (int a = 0; a < 4; ++a) st.dq[a] = *s++;
  for (int a = 0; a < 3; ++a) st.dk[a] = *s++;
  for (int a = 0; a < 3; ++a) st.dv[a] = *s++;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(delta);
  if (bf16)
    return launch<bf16_bits>(q, k, v, o, dO, dq, dk, dv, l, d, st, slots,
                             dq_slots, dkdv_slots, B, KV, G, Sq, Skv, D,
                             causal, scale, cs);
  return launch<float>(q, k, v, o, dO, dq, dk, dv, l, d, st, slots, dq_slots,
                       dkdv_slots, B, KV, G, Sq, Skv, D, causal, scale, cs);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
