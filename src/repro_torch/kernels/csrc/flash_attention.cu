// Causal (or full) GQA prefill attention for Hopper (sm_90a), flash style:
//
//     o[b, h, g, i] = sum_j softmax_j(q[b, h, g, i] . k[b, h, j] / sqrt(D)) v[b, h, j]
//
// over the keys j <= i when causal (all Skv keys otherwise), with the
// scores, the online softmax and the sums in fp32, for fp32 or bf16 q, k,
// v; the output in q's type. Masked scores are -1e30, as in the reference.
//
// Replaces repro/kernels/flash_attention.py:_flash_kernel (the Pallas TPU
// kernel). The TPU version walks a (B, KV, q block, kv block) grid whose
// last axis is sequential, carrying m, l and acc in VMEM scratch between
// grid steps, and feeds (G*bq, D) x (D, bkv) tiles to the matrix unit.
// Hopper blocks run in no order, so here a block owns a set of query rows
// and loops over the kv tiles itself, the state in registers. In both
// kernels below the rows of one (b, kv head) are flattened query-major,
// r = i*G + g, so the G query heads of a kv head share every K/V tile the
// block stages (GQA) and a block's rows span few query positions (a tight
// causal extent); kv tiles wholly above a block's last query are never
// loaded (the TPU kernel's `run` skip); q, k, v and o are addressed
// through their strides (unit stride on the last axis), so the model
// hands in views of its projections; any Sq and Skv work.
//
// Bound: at the serving shape (llama3.2-1b, B=4, S=512, bf16) one layer's
// call must move 21 MB (q, k, v once, the output once) and do 4.3 GFLOP of
// causal products: 6.3 us at 3.35 TB/s against 4.3 us at 989 TFLOP/s, so
// bytes bound it, but only if both products run on the tensor cores. The
// kernel is chosen by dtype and head dim:
//
// flash_kernel_wgmma (bf16, D = 64 or 128), the serving path:
//   * a block of 256 threads is two warpgroups of 64 query rows each (128
//     rows); both products are wgmma.mma_async m64nNk16, bf16 in, fp32
//     accumulate: S = Q K^T with Q as the register A operand (loaded once
//     into the A fragment layout) and the K tile K-major in shared memory;
//     O += P V with P rounded to bf16 in registers (the S accumulator's
//     fragment is the A fragment of the next product, no shared memory
//     round trip) and the V tile read MN-major (the transpose flag);
//   * K/V tiles of 64 keys arrive by TMA (cp.async.bulk.tensor, 4-d maps
//     over the strided (B, KV, Skv, D) views, encoded on the host per call
//     through cudaGetDriverEntryPoint, no -lcuda) into a ring of 3 stages
//     of dynamic shared memory, each stage's completion on an mbarrier: the
//     loads of the next two tiles are in flight while a tile's products
//     run. TMA writes the 128-byte swizzle that the wgmma descriptors
//     read, and zero-fills keys past Skv. TMA was chosen over cp.async:
//     one thread issues a whole tile, and encoding the two maps is host
//     work inside the ctypes call, which a call spends anyway;
//   * the online softmax runs on the accumulator fragments in fp32, in
//     the log2 domain (one FFMA and one ex2.approx a score): the running
//     max and the rescale of O are per query row, reduced over the four
//     lanes that hold a row; the row sums stay per lane until the end.
//     Only tiles that cross a warpgroup's diagonal (or Skv) are masked
//     element by element; a warpgroup skips the tiles wholly above its own
//     last query;
//   * query tiles launch heaviest first (the last query tile of the
//     causal triangle first), and the hardware hands the light ones to the
//     SMs that free up, so the triangle leaves no tail of idle SMs.
//   Rounding P to bf16 before P V (the plain version and the TPU kernel
//   keep P in fp32) costs about 2^-9 relative per weight, inside the bf16
//   bound of 3e-2.
//   What bounds it now (per-phase clock64 counters in an instrumented build
//   on an H100, llama3.2-1b's shape): latency along each warpgroup's chain
//   of a tile (wait, Q K^T, softmax, P V). The softmax takes the largest
//   share (the special-function units' exp2 rate, four warpgroups to an
//   SM), the products less, the TMA waits little; neither the tensor cores
//   nor the memory are near their rate. Tried and slower or no faster on
//   the card: a persistent grid, 128-key tiles, 2 or 4 stages, one block
//   per SM, and a ping-pong of the two warpgroups' products (with or
//   without turn barriers) in place of the per-tile __syncthreads.
//
// flash_kernel (fp32 any D; bf16 D = 32 or 96), on the CUDA cores: wgmma
// has no full-fp32 mode (TF32 would break the fp32 bound of 3e-5), and the
// small and odd head dims stay here until they move onto wgmma.
//   * TPR threads share a row (TPR = 1, 2, 4 for D = 32, 64, 96/128), each
//     holding D/TPR of q and of the fp32 accumulator in registers, with
//     the q.k partial sums combined by TPR-lane shuffles;
//   * K/V tiles of BKV rows are staged in shared memory as fp32 (32 KB),
//     read as broadcasts; keys are taken in chunks of 16, so the running
//     max and the rescale of acc happen once per chunk.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;                // keys per online-softmax update
constexpr float kNegInf = -1e30f;

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

struct Strides {      // element strides; the last axis of every tensor is 1
  long long qb, qh, qg, qs;
  long long kb, kh, ks;
  long long vb, vh, vs;
  long long ob, oh, og, os;
};

// -- the CUDA-core kernel (fp32; bf16 at D = 32, 96) ---------------------------

template <typename T, int D, int TPR, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Strides st, int G,
             int Sq, int Skv, int causal, float scale) {
  constexpr int DP = D / TPR;             // elements of a row per thread
  constexpr int ROWS = kThreads / TPR;    // query rows per block
  __shared__ float ks[BKV][D];
  __shared__ float vs[BKV][D];

  const int h = blockIdx.y, b = blockIdx.z;
  const int R = Sq * G;
  const int row0 = blockIdx.x * ROWS;
  const int row = row0 + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const bool valid = row < R;
  const int qpos = valid ? row / G : 0;
  const int g = valid ? row % G : 0;

  float qr[DP], acc[DP];
  const T* qp = q + b * st.qb + h * st.qh + g * st.qg + qpos * st.qs;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = valid ? to_f32(qp[i * TPR + part]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const int q_hi = (min(row0 + ROWS, R) - 1) / G;   // block's last query
  const int kv_end = causal ? min(Skv, q_hi + 1) : Skv;
  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;

  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();                      // the previous tile is consumed
    for (int e = threadIdx.x; e < BKV * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const bool in = k0 + j < Skv;
      ks[j][d] = in ? to_f32(kp[(k0 + j) * st.ks + d]) : 0.f;
      vs[j][d] = in ? to_f32(vp[(k0 + j) * st.vs + d]) : 0.f;
    }
    __syncthreads();
    const int jmax = min(BKV, kv_end - k0);
    for (int j0 = 0; j0 < jmax; j0 += kChunk) {
      float s[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DP; ++i) dot += qr[i] * ks[j][i * TPR + part];
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const int kpos = k0 + j;
        const bool ok = j < jmax && (!causal || kpos <= qpos);
        s[c] = ok ? dot * scale : kNegInf;
        cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] *= alpha;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float p = s[c] > 0.5f * kNegInf ? expf(s[c] - m_new) : 0.f;
        l += p;
#pragma unroll
        for (int i = 0; i < DP; ++i) acc[i] += p * vs[j0 + c][i * TPR + part];
      }
      m = m_new;
    }
  }

  if (valid) {
    T* op = o + b * st.ob + h * st.oh + g * st.og + qpos * st.os;
    const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
    for (int i = 0; i < DP; ++i) op[i * TPR + part] = from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int D, int TPR, int BKV>
int launch_d(const void* q, const void* k, const void* v, void* o,
             const Strides& st, int B, int KV, int G, int Sq, int Skv,
             int causal, float scale, cudaStream_t stream) {
  constexpr int ROWS = kThreads / TPR;
  const dim3 grid((Sq * G + ROWS - 1) / ROWS, KV, B);
  flash_kernel<T, D, TPR, BKV><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st, G, Sq, Skv, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// -- the tensor-core kernel (bf16, D = 64, 128) -------------------------------

constexpr int kWgThreads = 256;           // two consumer warpgroups
constexpr int kWgRows = 128;              // query rows per block
constexpr int kBkv = 64;                  // keys per K/V tile
constexpr int kStages = 3;                // K/V tiles in the ring
constexpr int kBox = 64;                  // D columns per TMA box (128 bytes)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Waits until the barrier's phase with parity ``parity`` completes. A tile
// that never arrives (a fault of the kernel) traps after 2^24 polls
// (seconds), so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1u << 24)) __trap();
  }
}

// one TMA box of a 4-d map, coordinates innermost first, into shared memory
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor of the 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
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

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
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

// d (64 x 64, fp32) += a (64 x 16, bf16 registers) * b (16 x 64, bf16
// in shared memory through ``desc``); ``TransB`` 1 reads b MN-major.
template <int TransB>
__device__ __forceinline__ void wgmma_m64n64k16(
    float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(TransB));
}

// d (64 x 128, fp32) += a (64 x 16, bf16 registers) * b (16 x 128, bf16
// in shared memory through ``desc``); ``TransB`` 1 reads b MN-major.
template <int TransB>
__device__ __forceinline__ void wgmma_m64n128k16(
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
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(TransB));
}

template <int D>
struct WgmmaTile {
  static constexpr int kTileBytes = kBkv * D * 2;    // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 64;
};

// S (64 x kBkv) = Q (64 x D) K^T for one warpgroup; K K-major in shared
// memory, D/64 swizzled boxes of (kBkv keys x 64 columns).
template <int D>
__device__ __forceinline__ void qk_product(float (&s)[kBkv / 2],
                                           const uint32_t (&qf)[D / 16][4],
                                           uint32_t k_tile) {
  static_assert(kBkv == 64, "S is one m64n64 product per k-slice");
#pragma unroll
  for (int i = 0; i < kBkv / 2; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t addr = k_tile + (kk / 4) * (kBkv * 128) + (kk % 4) * 32;
    wgmma_m64n64k16<0>(s, qf[kk], smem_desc(addr, 16, 1024));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
}

// O (64 x D) += P (64 x kBkv) V; V read MN-major: 64-column boxes at a
// leading offset of one box, 8-key groups at 1024 bytes.
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&pf)[kBkv / 16][4],
                                           uint32_t v_tile) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBkv / 16; ++kk) {
    const uint64_t desc = smem_desc(v_tile + kk * 16 * 128, kBkv * 128, 1024);
    if constexpr (D == 64)
      wgmma_m64n64k16<1>(o, pf[kk], desc);
    else
      wgmma_m64n128k16<1>(o, pf[kk], desc);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, D == 64 ? 2 : 1)
flash_kernel_wgmma(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __nv_bfloat16* __restrict__ q,
                   __nv_bfloat16* __restrict__ o, Strides st, int B, int KV,
                   int G, int Sq, int Skv, int causal, float scale_log2) {
  using Tile = WgmmaTile<D>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the shared address: align tiles to 1 KB
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * Tile::kStageBytes;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32, quad = lane % 4;
  const int n_qtiles = gridDim.x / (B * KV);
  const int qtile = n_qtiles - 1 - static_cast<int>(blockIdx.x) / (B * KV);
  const int h = static_cast<int>(blockIdx.x) % KV;
  const int b = (static_cast<int>(blockIdx.x) / KV) % B;

  const int R = Sq * G;
  const int row0 = qtile * kWgRows;
  const int q_hi = (min(row0 + kWgRows, R) - 1) / G;  // block's last query
  const int kv_end = causal ? min(Skv, q_hi + 1) : Skv;
  const int n_tiles = (kv_end + kBkv - 1) / kBkv;

  // this warpgroup's rows and the tiles it needs
  const int wg_row0 = row0 + wg * 64;
  const bool wg_live = wg_row0 < R;
  const int wg_q_lo = wg_row0 / G;
  const int wg_q_hi = wg_live ? (min(wg_row0 + 64, R) - 1) / G : 0;
  const int wg_end = causal ? min(Skv, wg_q_hi + 1) : Skv;
  const int wg_tiles = wg_live ? (wg_end + kBkv - 1) / kBkv : 0;

  // the thread's two rows (accumulator rows lane/4 and lane/4 + 8)
  int rows[2], qpos[2];
  const __nv_bfloat16* qrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = wg_row0 + warp * 16 + lane / 4 + 8 * i;
    const int r = min(rows[i], R - 1);
    qpos[i] = r / G;
    qrow[i] = q + b * st.qb + h * st.qh + (r % G) * st.qg + qpos[i] * st.qs;
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  auto load_tile = [&](int t) {
    const int s = t % kStages;
    const uint32_t bar = bars + 8 * s;
    const uint32_t k_dst = base + s * Tile::kStageBytes;
    const uint32_t v_dst = k_dst + Tile::kTileBytes;
    mbar_expect_tx(bar, Tile::kStageBytes);
#pragma unroll
    for (int c = 0; c < D / kBox; ++c) {
      tma_load_4d(k_dst + c * kBkv * 128, &kmap, bar, c * kBox, t * kBkv, h, b);
      tma_load_4d(v_dst + c * kBkv * 128, &vmap, bar, c * kBox, t * kBkv, h, b);
    }
  };
  if (tid == 0)
    for (int t = 0; t < min(kStages - 1, n_tiles); ++t) load_tile(t);

  // Q in the A fragment layout: register j of k-slice kk holds columns
  // 16kk + 2*quad (+8 for j = 2, 3) of row lane/4 (+8 for j = 1, 3)
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = j & 1, col = 16 * kk + 2 * quad + (j >> 1) * 8;
      qf[kk][j] = rows[i] < R
                      ? *reinterpret_cast<const uint32_t*>(qrow[i] + col)
                      : 0u;
    }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    if (tid == 0 && t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    __syncwarp();
    if (t < wg_tiles) {
      const int s = t % kStages;
      mbar_wait(bars + 8 * s, (t / kStages) & 1);
      const uint32_t k_tile = base + s * Tile::kStageBytes;
      float sc[kBkv / 2];
      qk_product<D>(sc, qf, k_tile);

      // raw scores; element e of n8 group j sits at row lane/4 + 8*(e/2),
      // key 8j + 2*quad + e%2. The softmax runs in the log2 domain, p =
      // 2^(s*c - m*c) with c = scale*log2(e): one FFMA and one ex2 a score
      const int k0 = t * kBkv;
      const bool edge = k0 + kBkv > Skv || (causal && k0 + kBkv - 1 > wg_q_lo);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kBkv / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge) {
            const int kpos = k0 + 8 * j + 2 * quad + (e & 1);
            if (kpos >= Skv || (causal && kpos > qpos[e >> 1]))
              sc[4 * j + e] = kNegInf;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
        }
      float alpha[2], msc[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = fast_exp2((m[i] - m_new) * scale_log2);
        msc[i] = m_new * scale_log2;
        m[i] = m_new;
        l[i] *= alpha[i];
      }
      uint32_t pf[kBkv / 16][4];
#pragma unroll
      for (int j = 0; j < kBkv / 8; ++j) {
        const float p0 = fast_exp2(fmaf(sc[4 * j + 0], scale_log2, -msc[0]));
        const float p1 = fast_exp2(fmaf(sc[4 * j + 1], scale_log2, -msc[0]));
        const float p2 = fast_exp2(fmaf(sc[4 * j + 2], scale_log2, -msc[1]));
        const float p3 = fast_exp2(fmaf(sc[4 * j + 3], scale_log2, -msc[1]));
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pf[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);
        pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 0] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      pv_product<D>(acc, pf, k_tile + Tile::kTileBytes);
    }
    __syncthreads();                      // stage t % kStages is free again
  }

  if (!wg_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = 1.f / fmaxf(l[i], 1e-20f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= R) continue;
    const int r = rows[i];
    __nv_bfloat16* orow =
        o + b * st.ob + h * st.oh + (r % G) * st.og + qpos[i] * st.os;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * quad) =
          pack_bf16(acc[4 * j + 2 * i] * l[i], acc[4 * j + 2 * i + 1] * l[i]);
  }
}

// -- host side -----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point lookup, so the
// library needs no -lcuda; null where it is not offered
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-d map (D, Skv, KV, B) over a strided bf16 view, boxes of (64
// columns, kBkv keys), 128-byte swizzle, zero fill past Skv. A size-1 axis
// may carry any stride; it gets a legal one.
int encode_kv_map(CUtensorMap* map, const void* ptr, long long sb,
                  long long sh, long long ss, int B, int KV, int Skv, int D) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const long long fill = 16;
  long long st[3] = {ss, sh, sb};
  const int n[3] = {Skv, KV, B};
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(Skv),
                        static_cast<cuuint64_t>(KV), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    const long long bytes = (n[i] == 1 ? fill : st[i] * 2);
    if (bytes <= 0 || bytes % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    strides[i] = static_cast<cuuint64_t>(bytes);
  }
  const cuuint32_t box[4] = {kBox, kBkv, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 const Strides& st, int B, int KV, int G, int Sq, int Skv,
                 int causal, float scale, cudaStream_t stream) {
  // q and o are read and written two elements (4 bytes) at a time
  const long long odd = st.qb | st.qh | st.qg | st.qs | st.ob | st.oh |
                        st.og | st.os;
  if ((odd & 1) || reinterpret_cast<uintptr_t>(q) % 4 ||
      reinterpret_cast<uintptr_t>(o) % 4 || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap kmap, vmap;
  int rc = encode_kv_map(&kmap, k, st.kb, st.kh, st.ks, B, KV, Skv, D);
  if (rc == 0) rc = encode_kv_map(&vmap, v, st.vb, st.vh, st.vs, B, KV, Skv, D);
  if (rc != 0) return rc;
  // the dynamic shared memory above 48 KB, allowed once per device
  constexpr int smem = WgmmaTile<D>::kSmemBytes;
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(flash_kernel_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev] = true;
  }
  const long long n_qtiles =
      (static_cast<long long>(Sq) * G + kWgRows - 1) / kWgRows;
  const long long blocks = n_qtiles * KV * B;
  if (blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_kernel_wgmma<D>
      <<<static_cast<unsigned>(blocks), kWgThreads, smem, stream>>>(
          kmap, vmap, static_cast<const __nv_bfloat16*>(q),
          static_cast<__nv_bfloat16*>(o), st, B, KV, G, Sq, Skv, causal,
          scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides& st, int B, int KV, int G, int Sq, int Skv, int D,
           int causal, float scale, cudaStream_t stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || Sq <= 0 || Skv <= 0) return 0;
  if constexpr (sizeof(T) == 2) {         // bf16 at 64 and 128: tensor cores
    if (D == 64)
      return launch_wgmma<64>(q, k, v, o, st, B, KV, G, Sq, Skv, causal,
                              scale, stream);
    if (D == 128)
      return launch_wgmma<128>(q, k, v, o, st, B, KV, G, Sq, Skv, causal,
                               scale, stream);
  }
  switch (D) {
    case 32:
      return launch_d<T, 32, 1, 64>(q, k, v, o, st, B, KV, G, Sq, Skv, causal,
                                    scale, stream);
    case 64:
      return launch_d<T, 64, 2, 64>(q, k, v, o, st, B, KV, G, Sq, Skv, causal,
                                    scale, stream);
    case 96:
      return launch_d<T, 96, 4, 32>(q, k, v, o, st, B, KV, G, Sq, Skv, causal,
                                    scale, stream);
    case 128:
      return launch_d<T, 128, 4, 32>(q, k, v, o, st, B, KV, G, Sq, Skv,
                                     causal, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches on ``stream`` and returns cudaGetLastError(). q/o are
// (B, KV, G, Sq, D) and k/v (B, KV, Skv, D), each given by its element
// strides (the last axis has stride 1); D is 32, 64, 96 or 128. ``bf16``
// selects bf16 (1) or fp32 (0) for all four tensors.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    long long qb, long long qh, long long qg, long long qs,
                    long long kb, long long kh, long long ks, long long vb,
                    long long vh, long long vs, long long ob, long long oh,
                    long long og, long long os, int B, int KV, int G, int Sq,
                    int Skv, int D, int causal, float scale, int bf16,
                    void* stream) {
  const Strides st{qb, qh, qg, qs, kb, kh, ks, vb, vh, vs, ob, oh, og, os};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, o, st, B, KV, G, Sq, Skv, D,
                                      causal, scale, s)
              : launch<float>(q, k, v, o, st, B, KV, G, Sq, Skv, D, causal,
                              scale, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
