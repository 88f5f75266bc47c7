// One-token GQA decode attention against a KV cache for Hopper (sm_90a):
//
//     o[b, h, g] = sum_{j < length} softmax_j(q[b, h, g] . k[b, h, j] / sqrt(D)) v[b, h, j]
//
// with the scores, the online softmax and the sums in fp32, for fp32 or
// bf16 q and caches; the output in q's type. ``length`` (the cache fill)
// is a host int or an int32 on the device, read by the kernel itself, so a
// decode loop that keeps its position on the card needs no host sync.
// Where the caller asks for it, the kernel also writes each query row's
// log-sum-exp of its scaled scores, lse[b, h, g] = log sum_{j < length}
// exp(q . k_j / sqrt(D)), in fp32: what a caller that holds the cache in
// sequence blocks on several ranks needs to merge their outputs by their
// softmax weights. A row over no position (length 0) gets o = 0 and
// lse = -inf, so that such a block weighs nothing in that merge.
//
// Replaces repro/kernels/decode_attention.py:_decode_kernel (the Pallas
// TPU kernel), which walks a (B, KV, kv block) grid with the kv axis
// sequential, the state in VMEM scratch, the length prefetched into SMEM
// so that blocks past it skip their products.
//
// Bound: memory. Every cache row below ``length`` is read once (K and V,
// 2*D elements per kv head) for 4*G*D flops, far below the card's
// flop-per-byte balance point; at the serving shape (llama3.2-1b, B=4,
// length ~528, bf16) one layer's call must move 4.3 MB, 1.3 us at
// 3.35 TB/s. Reading it that fast takes bytes in flight on every SM, and
// one block per (b, kv head) is only 32 blocks for 132 SMs there. So:
//   * split-KV: the grid is (split, kv head x query-head chunk, b). The
//     number of splits is fixed at launch by the wrapper (about two blocks
//     per SM; ``decode_attention.split_plan``), and the kernel divides the
//     positions [0, length) among them after it reads ``length``: split s
//     takes [s*per, min(length, (s+1)*per)) with per = ceil(length /
//     splits). Every split is busy whatever the fill, and the launch does
//     not depend on ``length`` (a CUDA-graph capture of the step needs
//     that). Positions at or past ``length`` are never read;
//   * a block of 4 warps; a cache row is read by LPR lanes with 16-byte
//     loads (LPR = 8 for D = 64 bf16, so one warp instruction covers 4
//     rows), and a warp issues 4 such loads of K and of V before it uses
//     any; each group of LPR lanes keeps its own online softmax (m, l,
//     acc) per query head, over its share of D, in registers;
//   * the states are merged in fp32: the row groups of a warp by
//     shuffles, the 4 warps through shared memory (empty states skipped),
//     and the splits in the same launch: each block writes its (m, l, acc)
//     to a scratch that the wrapper allocates, then takes a ticket with
//     atomicAdd on a per-(b, kv head, chunk) counter after a
//     __threadfence(); the block that takes the last ticket merges the
//     splits (a split that saw no position, l = 0, is skipped), writes the
//     output and resets the counter to 0 for the next call. With one split
//     the block writes the output itself;
//   * the G query heads of a kv head share every K/V row a block reads
//     (GQA); a kv head with more than 8 query heads (MQA at G = 48) reads
//     its rows once per chunk of 8; the chunk width (G itself when it is
//     1, 2 or 4, else 8) is a template argument, so the per-head state is
//     unrolled in registers;
//   * the caches are addressed through their strides, so the model passes
//     views of its (B, S, KV, hd) cache.
// What bounds it now (globaltimer stamps per phase in an instrumented build
// on an H100, llama3.2-1b's shape): the cache loads, near the bytes' time
// plus one trip to memory, are about a third of the kernel; the merge in
// the launch (shuffles, shared memory, the fence and ticket, the last
// block's two dependent trips to L2) about half. More splits cost more
// than they gain there.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;                // loads of K and V in flight per lane
constexpr int kMaxHeads = 8;              // query heads per block, at most
constexpr int kMaxSplits = 64;            // blocks per (b, kv head, chunk)
constexpr float kNegInf = -1e30f;
constexpr uint32_t kMinusInfBits = 0xff800000u;   // the lse of no position

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
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

struct Strides {      // element strides; the last axis of every tensor is 1
  long long qb, qh, qg;
  long long kb, kh, ks;
  long long vb, vh, vs;
};

constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// How a warp reads a cache row of D elements of T: LPR lanes a row, each
// holding VEC consecutive elements (16 bytes where D allows, 12 at D = 96).
template <typename T, int D>
struct RowSplit {
  static constexpr int LPR = pow2_at_least(D * int(sizeof(T)) / 16) < 32
                                 ? pow2_at_least(D * int(sizeof(T)) / 16)
                                 : 32;
  static constexpr int VEC = D / LPR;
  static constexpr int RPW = 32 / LPR;               // rows a warp covers
  static constexpr int WORDS = VEC * int(sizeof(T)) / 4;
  static_assert(D % LPR == 0 && (VEC * sizeof(T)) % 4 == 0, "row split");
};

// WORDS 32-bit words from ``p`` (16-byte loads where the count allows)
template <int WORDS>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[WORDS]) {
  if constexpr (WORDS % 4 == 0) {
#pragma unroll
    for (int i = 0; i < WORDS / 4; ++i) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = x.x, w[4 * i + 1] = x.y, w[4 * i + 2] = x.z,
      w[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < WORDS; ++i)
      w[i] = __ldg(reinterpret_cast<const uint32_t*>(p) + i);
  }
}

template <typename T, int VEC, int WORDS>
__device__ __forceinline__ float element(const uint32_t (&w)[WORDS], int e) {
  if constexpr (sizeof(T) == 4)
    return __uint_as_float(w[e]);
  else
    return (e & 1) ? bf16_hi(w[e / 2]) : bf16_lo(w[e / 2]);
}

template <typename T, int D, int kHeads>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, T* __restrict__ o,
              float* __restrict__ lse, float* __restrict__ ws,
              int* __restrict__ counters, Strides st,
              int B, int KV, int G, int S,
              const int32_t* __restrict__ length_ptr, int length_val,
              float scale) {
  using Split = RowSplit<T, D>;
  constexpr int LPR = Split::LPR, VEC = Split::VEC, RPW = Split::RPW;
  constexpr int WORDS = Split::WORDS, kRows = RPW * kUnroll;
  __shared__ float sm_m[kWarps][kHeads];
  __shared__ float sm_l[kWarps][kHeads];
  __shared__ float sm_acc[kWarps][kHeads][D];
  __shared__ int sm_last;
  static_assert(kWarps * kHeads * D >= kHeads * kMaxSplits, "merge weights");

  const int nchunk = (G + kHeads - 1) / kHeads;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int h = blockIdx.y / nchunk, chunk = blockIdx.y % nchunk;
  const int b = blockIdx.z;
  const int g0 = chunk * kHeads, gc = min(kHeads, G - g0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / LPR, part = lane % LPR;

  int len = length_ptr != nullptr ? *length_ptr : length_val;
  len = max(0, min(len, S));
  const int per = (len + nsplit - 1) / nsplit;
  const int lo = min(len, split * per), hi = min(len, lo + per);

  float qr[kHeads][VEC], acc[kHeads][VEC], m[kHeads], l[kHeads];
  const T* qp = q + b * st.qb + h * st.qh + part * VEC;
#pragma unroll
  for (int gi = 0; gi < kHeads; ++gi) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qr[gi][e] = gi < gc ? to_f32(qp[(g0 + gi) * st.qg + e]) : 0.f;
      acc[gi][e] = 0.f;
    }
    m[gi] = kNegInf;
    l[gi] = 0.f;
  }

  const T* kp = kc + b * st.kb + h * st.kh + part * VEC;
  const T* vp = vc + b * st.vb + h * st.vh + part * VEC;
  for (int p0 = lo + warp * kRows; p0 < hi; p0 += kWarps * kRows) {
    uint32_t kw[kUnroll][WORDS], vw[kUnroll][WORDS];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * RPW + rg;
      if (p < hi) {
        load_words(kp + p * st.ks, kw[u]);
        load_words(vp + p * st.vs, vw[u]);
      } else {
#pragma unroll
        for (int i = 0; i < WORDS; ++i) kw[u][i] = vw[u][i] = 0u;
      }
    }
    float s[kUnroll][kHeads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int gi = 0; gi < kHeads; ++gi) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          dot += qr[gi][e] * element<T, VEC, WORDS>(kw[u], e);
        s[u][gi] = dot;
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int gi = 0; gi < kHeads; ++gi)
          s[u][gi] += __shfl_xor_sync(0xffffffffu, s[u][gi], off);
#pragma unroll
    for (int gi = 0; gi < kHeads; ++gi) {
      float cmax = kNegInf;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool in = p0 + u * RPW + rg < hi;
        s[u][gi] = in ? s[u][gi] * scale : kNegInf;
        cmax = fmaxf(cmax, s[u][gi]);
      }
      const float m_new = fmaxf(m[gi], cmax);
      const float alpha = expf(m[gi] - m_new);
      l[gi] *= alpha;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[gi][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool in = p0 + u * RPW + rg < hi;
        const float p = in ? expf(s[u][gi] - m_new) : 0.f;
        l[gi] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[gi][e] += p * element<T, VEC, WORDS>(vw[u], e);
      }
      m[gi] = m_new;
    }
  }

  // the RPW row groups of the warp into one state per warp
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int gi = 0; gi < kHeads; ++gi) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[gi], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[gi], off);
      const float m_new = fmaxf(m[gi], m_o);
      const float f = expf(m[gi] - m_new), f_o = expf(m_o - m_new);
      l[gi] = l[gi] * f + l_o * f_o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float a_o = __shfl_xor_sync(0xffffffffu, acc[gi][e], off);
        acc[gi][e] = acc[gi][e] * f + a_o * f_o;
      }
      m[gi] = m_new;
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int gi = 0; gi < kHeads; ++gi) {
      if (part == 0) {
        sm_m[warp][gi] = m[gi];
        sm_l[warp][gi] = l[gi];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][gi][part * VEC + e] = acc[gi][e];
    }
  }
  __syncthreads();

  // the block's state per (query head, element), the warps merged
  const long long bh = static_cast<long long>(b) * KV + h;
  T* op = o + (bh * G + g0) * D;
  const long long rows = static_cast<long long>(B) * KV * G;
  float* ws_acc = ws;                                 // (B·KV·G, nsplit, D)
  float* ws_ml = ws + rows * nsplit * D;              // (B·KV·G, nsplit, 2)
  for (int e = threadIdx.x; e < gc * D; e += kThreads) {
    const int gi = e / D, d = e % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (sm_l[w][gi] > 0.f) mx = fmaxf(mx, sm_m[w][gi]);
    float tot_l = 0.f, tot_a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (sm_l[w][gi] == 0.f) continue;   // a warp that saw no position
      const float f = expf(sm_m[w][gi] - mx);
      tot_l += sm_l[w][gi] * f;
      tot_a += sm_acc[w][gi][d] * f;
    }
    if (nsplit == 1) {
      op[gi * D + d] = from_f32<T>(tot_a / fmaxf(tot_l, 1e-20f));
      if (lse != nullptr && d == 0)
        lse[bh * G + g0 + gi] = tot_l > 0.f ? mx + logf(tot_l)
                                            : __uint_as_float(kMinusInfBits);
    } else {
      const long long row = (bh * G + g0 + gi) * nsplit + split;
      ws_acc[row * D + d] = tot_a;
      if (d == 0) {
        ws_ml[2 * row] = mx;
        ws_ml[2 * row + 1] = tot_l;
      }
    }
  }
  if (nsplit == 1) return;

  // the last block of this (b, kv head, chunk) to finish merges the
  // splits. After the barrier, one thread's fence orders all the block's
  // writes before its ticket (the fence is cumulative; cooperative groups'
  // grid barrier relies on the same)
  __syncthreads();
  int* counter = counters + bh * nchunk + chunk;
  if (threadIdx.x == 0) {
    __threadfence();
    const int ticket = atomicAdd(counter, 1);
    sm_last = ticket == nsplit - 1;
    if (sm_last) {
      *counter = 0;                       // ready for the next call
      __threadfence();                    // the others' states, as written
    }
  }
  __syncthreads();
  if (!sm_last) return;
  // each split's weight exp(m_s - max) / sum, zero for a split that saw no
  // position: warp w takes query heads w, w + kWarps, ..., a lane per split
  float* sm_w = &sm_acc[0][0][0];         // (kHeads, kMaxSplits), reused
  for (int gi = warp; gi < gc; gi += kWarps) {
    const long long row0 = (bh * G + g0 + gi) * nsplit;
    float ms[kMaxSplits / 32], ls[kMaxSplits / 32];
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kMaxSplits / 32; ++i) {
      const int sp = lane + 32 * i;
      ms[i] = sp < nsplit ? __ldcg(ws_ml + 2 * (row0 + sp)) : kNegInf;
      ls[i] = sp < nsplit ? __ldcg(ws_ml + 2 * (row0 + sp) + 1) : 0.f;
      if (ls[i] > 0.f) mx = fmaxf(mx, ms[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxSplits / 32; ++i) {
      ms[i] = ls[i] > 0.f ? expf(ms[i] - mx) : 0.f;
      tot += ls[i] * ms[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tot += __shfl_xor_sync(0xffffffffu, tot, off);
    const float inv = 1.f / fmaxf(tot, 1e-20f);
    if (lse != nullptr && lane == 0)
      lse[bh * G + g0 + gi] = tot > 0.f ? mx + logf(tot)
                                        : __uint_as_float(kMinusInfBits);
#pragma unroll
    for (int i = 0; i < kMaxSplits / 32; ++i)
      sm_w[gi * kMaxSplits + lane + 32 * i] = ms[i] * inv;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < gc * D; e += kThreads) {
    const int gi = e / D, d = e % D;
    const float* a = ws_acc + (bh * G + g0 + gi) * nsplit * D + d;
    float out = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < nsplit; ++sp)
      out += __ldcg(a + sp * D) * sm_w[gi * kMaxSplits + sp];
    op[gi * D + d] = from_f32<T>(out);
  }
}

template <typename T, int D, int kHeads>
int launch_g(const void* q, const void* kc, const void* vc, void* o,
             float* lse, float* ws, int* counters, const Strides& st, int B,
             int KV, int G, int S, int nsplit, const int32_t* length_ptr,
             int length_val, float scale, cudaStream_t stream) {
  const int nchunk = (G + kHeads - 1) / kHeads;
  const dim3 grid(nsplit, nchunk * KV, B);
  decode_kernel<T, D, kHeads><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<T*>(o), lse, ws, counters, st, B,
      KV, G, S, length_ptr, length_val, scale);
  return static_cast<int>(cudaGetLastError());
}

// the block's query-head chunk: G itself when it is 1, 2 or 4, else 8
template <typename T, int D>
int launch_d(const void* q, const void* kc, const void* vc, void* o,
             float* lse, float* ws, int* counters, const Strides& st, int B,
             int KV, int G, int S, int nsplit, const int32_t* length_ptr,
             int length_val, float scale, cudaStream_t stream) {
  if (G == 1)
    return launch_g<T, D, 1>(q, kc, vc, o, lse, ws, counters, st, B, KV, G, S,
                             nsplit, length_ptr, length_val, scale, stream);
  if (G == 2)
    return launch_g<T, D, 2>(q, kc, vc, o, lse, ws, counters, st, B, KV, G, S,
                             nsplit, length_ptr, length_val, scale, stream);
  if (G <= 4)
    return launch_g<T, D, 4>(q, kc, vc, o, lse, ws, counters, st, B, KV, G, S,
                             nsplit, length_ptr, length_val, scale, stream);
  return launch_g<T, D, kMaxHeads>(q, kc, vc, o, lse, ws, counters, st, B, KV,
                                   G, S, nsplit, length_ptr, length_val,
                                   scale, stream);
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, void* o, float* lse,
           float* ws, int* counters, const Strides& st, int B, int KV, int G,
           int S, int D, int nsplit, const int32_t* length_ptr, int length_val,
           float scale, cudaStream_t stream) {
  if (B <= 0 || KV <= 0 || G <= 0) return 0;
  if (nsplit < 1 || nsplit > kMaxSplits ||
      (nsplit > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the caches are read 16 bytes (12 at D = 96) at a time
  const long long odd = (st.kb | st.kh | st.ks | st.vb | st.vh | st.vs) *
                        static_cast<long long>(sizeof(T));
  if ((odd % 4) || reinterpret_cast<uintptr_t>(kc) % 16 ||
      reinterpret_cast<uintptr_t>(vc) % 16 || (D != 96 && odd % 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, kc, vc, o, lse, ws, counters, st, B, KV, G, S,
                             nsplit, length_ptr, length_val, scale, stream);
    case 64:
      return launch_d<T, 64>(q, kc, vc, o, lse, ws, counters, st, B, KV, G, S,
                             nsplit, length_ptr, length_val, scale, stream);
    case 96:
      return launch_d<T, 96>(q, kc, vc, o, lse, ws, counters, st, B, KV, G, S,
                             nsplit, length_ptr, length_val, scale, stream);
    case 128:
      return launch_d<T, 128>(q, kc, vc, o, lse, ws, counters, st, B, KV, G, S,
                              nsplit, length_ptr, length_val, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches on ``stream`` and returns cudaGetLastError(). q is (B, KV, G, D)
// and the caches (B, KV, S, D), each given by its element strides (the last
// axis has stride 1; the caches' base and strides 16-byte aligned); o is
// (B, KV, G, D) contiguous; D is 32, 64, 96 or 128. ``lse``, when not
// null, receives the (B, KV, G) fp32 log-sum-exp of each row's scaled
// scores (-inf over no position). ``length_ptr`` (an
// int32 on the device) wins over ``length_val`` when it is not null.
// ``nsplit`` blocks share each (b, kv head, chunk); with more than one,
// ``ws`` is B·KV·G·nsplit·(D + 2) floats of scratch and ``counters`` one
// zeroed int per (b, kv head, chunk), left zeroed. ``bf16`` selects bf16
// (1) or fp32 (0) for q, the caches and o.
int decode_attention(const void* q, const void* kc, const void* vc, void* o,
                     void* lse, long long qb, long long qh, long long qg,
                     long long kb, long long kh, long long ks, long long vb,
                     long long vh, long long vs, int B, int KV, int G, int S,
                     int D,
                     const void* length_ptr, int length_val, float scale,
                     int bf16, int nsplit, void* ws, void* counters,
                     void* stream) {
  const Strides st{qb, qh, qg, kb, kh, ks, vb, vh, vs};
  const int32_t* lp = static_cast<const int32_t*>(length_ptr);
  float* w = static_cast<float*>(ws);
  float* ls = static_cast<float*>(lse);
  int* c = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, kc, vc, o, ls, w, c, st, B, KV, G,
                                      S, D, nsplit, lp, length_val, scale, s)
              : launch<float>(q, kc, vc, o, ls, w, c, st, B, KV, G, S, D,
                              nsplit, lp, length_val, scale, s);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
