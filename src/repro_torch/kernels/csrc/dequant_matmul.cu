// Weight-dequant matmul for Hopper (sm_90a): int8 weights, fp32 activations.
//
//     y (B, N) = x (B, D) @ (q (D, N) * scale),  scale () or (N,)
//
// Replaces repro/kernels/dequant_matmul.py:_dqmm_kernel (the Pallas TPU
// kernel). The TPU version gives a grid step a (bb rows x bn columns) output
// tile with the whole reduction dim D in VMEM and lets the MXU do the
// product; only the int8 weight bytes cross device memory. Here a block owns
// an output tile too and walks D itself, on one of two routes that the
// wrapper picks from (B, D, N) alone (dequant_matmul.py:route), never from
// the tile: a tile changes which block owns an output, never the order of
// its sum, so every tile of a route gives the same bits.
//
// Bound: operations at the shapes where the kernel sets the time (2*B*D*N
// flops against 4B*D + D*N + 4B*N bytes: 1,000+ flops per byte at
// llama3.2-1b's gate projection over 2048 rows), launch latency and one
// memory round trip at bench_roofline's small shapes. fp32 FMAs on the CUDA
// cores (67 TFLOP/s) cannot pass 1.03 ms at the gate projection; the tensor
// cores can, which is what the first route is for.
//
// The tensor route (dq_tensor_kernel; D > 64, N % 16 == 0 and D % 4 == 0,
// so every row of q and x starts on 16 bytes):
//   * q is int8, so every weight is exact in bf16 (bf16 holds every integer
//     up to 256). x is split on the fly into three bf16 terms, t0 = bf16(x),
//     t1 = bf16(x - t0), t2 = bf16(x - t0 - t1), each difference exact in
//     fp32. For 2^-110 <= |x| <= 3.38e38 the terms hold x exactly; below
//     that range what is lost is under 2^-133 in absolute value (bf16's
//     subnormals are coarser than fp32's); above it t0 rounds to inf. When
//     t0 is not finite (x inf or NaN, or past bf16's range) t1 = t2 = 0, so
//     the product is inf or NaN where the plain product is, never NaN from
//     inf - inf. Then x @ q = t0 @ q + t1 @ q + t2 @ q: three bf16
//     wgmma.mma_async m64n128k16 products a k16 step with fp32 accumulation,
//     the x terms as the register A operand (no shared-memory pass) and the
//     converted q tile as B in shared memory, read MN-major (the transpose
//     flag) through the 128-byte swizzle.
//   * The tensor cores' fp32 accumulation is not IEEE round-to-nearest
//     (the low bits of an addend below the largest one are cut), so a long
//     chain of products into one accumulator drifts with the number of
//     steps, not with its square root. So each 64-deep k-tile sums into a
//     fresh accumulator, the small terms first (t2, then t1, then t0, each
//     over the k-tile's four k16 steps), and the finished k-tile is added
//     into an fp32 register sum with an ordinary FADD (on an H100, one
//     accumulator over D 2048 read 22-32x further from the fp64 product
//     than this; PERF.md).
//   * The scale multiplies the finished sum in the epilogue, per column or
//     per tensor, where the plain version (and the CUDA-core route) expands
//     the weight first: the two differ in the last bits, inside the
//     kernel's tolerances (1e-5 of the plain version; the fp32 random-walk
//     bound of the fp64 product at D 2048).
//   * A block is one or two consumer warpgroups (64 or 128 rows, the
//     tile's block_batch) by 128 columns; the x (fp32) and q (int8) tiles of
//     three k-tiles are in flight at once by 16-byte cp.async into a ring
//     of shared memory (rows past B, D or N zero-filled, so D % 64 != 0
//     ends on a zero-padded k-tile), and while one k-tile's products run
//     the next tile's int8 q is converted to bf16 (exact; a magic-number
//     conversion, no I2F) into the other of two swizzled buffers.
//
// The CUDA-core route (every other shape): fp32 FMAs on the weight expanded
// first (q * scale, the plain version's product), so at D <= 64 the kernel
// stays within 1e-5 of the plain version at every output, which the tensor
// cores' own rounding of a k-tile's sum does not near zero
// (tools/dq_accumulation.py launches the tensor route there; PERF.md). A
// block of 256 threads (16 x 16) owns a (bb x bn) tile, bb and bn in [1,
// 128]; each thread holds the fewest rows and columns of it, 1, 2, 4 or
// 8 each, that cover the tile, and the block walks D in 16-deep slices. dq_core_vec_kernel (rows on 16 bytes: N % 16 == 0, D %
// 4 == 0, bn a multiple of 16) stages x and the int8 q by 16-byte cp.async
// into a ring of four slices, so at D <= 64 all of a block's loads are in
// flight at once; dq_core_kernel (rows that do not start on 16 bytes, so
// its loads are scalar) loads the next slice's x and expanded weights into
// registers while this one's FMAs run. Every output's sum runs d = 0, 1,
// ..., D-1 in one thread (fmaf), so both give the same bits for any tile.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- the CUDA-core route --------------------------------------------------------

constexpr int kCoreThreads = 256;              // 16 x 16
constexpr int kMaxOut = 8;                     // most outputs a thread
                                               // along a row or a column
constexpr int kTD = 16;                        // depth of one D slice
constexpr int kMaxTile = 128;                  // largest bb and bn
constexpr int kStaged = kMaxTile * kTD / kCoreThreads;  // values a thread stages

template <int kTM, int kTN>
__global__ void __launch_bounds__(kCoreThreads)
dq_core_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale, int scale_stride,
               float* __restrict__ y, int B, int D, int N, int bb, int bn,
               int col_tiles) {
  __shared__ float xs[2][kMaxTile][kTD + 1];   // x slice, (bb, kTD)
  __shared__ float ws[2][kTD][kMaxTile];       // expanded weights, (kTD, bn)

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int tid = threadIdx.x;
  const int r0 = (blockIdx.x / col_tiles) * bb;
  const int c0 = (blockIdx.x % col_tiles) * bn;

  float xv[kStaged], wv[kStaged];
  auto load = [&](int d0) {
#pragma unroll
    for (int u = 0; u < kStaged; ++u) {
      const int e = tid + u * kCoreThreads;
      const int r = e / kTD, d = e % kTD;
      const int gr = r0 + r, gd = d0 + d;
      xv[u] = (r < bb && gr < B && gd < D) ? x[(size_t)gr * D + gd] : 0.f;
      const int dw = e / bn, c = e % bn;
      const int gdw = d0 + dw, gc = c0 + c;
      float w = 0.f;
      if (dw < kTD && gdw < D && gc < N)
        w = static_cast<float>(q[(size_t)gdw * N + gc]) *
            scale[gc * scale_stride];
      wv[u] = w;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int u = 0; u < kStaged; ++u) {
      const int e = tid + u * kCoreThreads;
      if (e / kTD < bb) xs[buf][e / kTD][e % kTD] = xv[u];
      if (e / bn < kTD) ws[buf][e / bn][e % bn] = wv[u];
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int slices = (D + kTD - 1) / kTD;
  load(0);
  store(0);
  __syncthreads();
  for (int sl = 0; sl < slices; ++sl) {
    const int buf = sl & 1;
    if (sl + 1 < slices) load((sl + 1) * kTD);   // in flight during the FMAs
#pragma unroll
    for (int d = 0; d < kTD; ++d) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int r = ty + 16 * i;
        a[i] = r < bb ? xs[buf][r][d] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int c = tx + 16 * j;
        b[j] = c < bn ? ws[buf][d][c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (sl + 1 < slices) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty + 16 * i, gr = r0 + r;
    if (r >= bb || gr >= B) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = tx + 16 * j, gc = c0 + c;
      if (c < bn && gc < N) y[(size_t)gr * N + gc] = acc[i][j];
    }
  }
}

// The aligned shapes' version: the same tile, threads, outputs and sums,
// its slices staged by 16-byte cp.async into a ring of kCoreStages, so at D
// <= 64 every slice of x and of the int8 q is in flight at once; the weight
// is expanded (q * scale, the same product) as each FMA takes it.
constexpr int kCoreStages = 4;
constexpr int kXPad = kTD + 4;                 // fp32 row of a staged x slice

template <int kTM, int kTN>
__global__ void __launch_bounds__(kCoreThreads)
dq_core_vec_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, int scale_stride,
                   float* __restrict__ y, int B, int D, int N, int bb, int bn,
                   int col_tiles) {
  __shared__ __align__(16) float xs[kCoreStages][16 * kTM][kXPad];
  __shared__ __align__(16) int8_t qs[kCoreStages][kTD][16 * kTN];

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int tid = threadIdx.x;
  const int r0 = (blockIdx.x / col_tiles) * bb;
  const int c0 = (blockIdx.x % col_tiles) * bn;
  float s[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int gc = c0 + tx + 16 * j;
    s[j] = gc < N ? scale[gc * scale_stride] : 0.f;
  }

  auto load = [&](int sl) {
    const int d0 = sl * kTD, st = sl % kCoreStages;
    for (int c = tid; c < bb * (kTD / 4); c += kCoreThreads) {
      const int r = c / (kTD / 4), d = 4 * (c % (kTD / 4));
      const int gr = r0 + r, gd = d0 + d;
      const bool ok = gr < B && gd < D;
      cp_async16(smem_u32(&xs[st][r][d]), ok ? x + (size_t)gr * D + gd : x,
                 ok);
    }
    for (int c = tid; c < kTD * (bn / 16); c += kCoreThreads) {
      const int d = c / (bn / 16), col = 16 * (c % (bn / 16));
      const int gd = d0 + d, gc = c0 + col;
      const bool ok = gd < D && gc < N;
      cp_async16(smem_u32(&qs[st][d][col]), ok ? q + (size_t)gd * N + gc : q,
                 ok);
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int slices = (D + kTD - 1) / kTD;
#pragma unroll
  for (int sl = 0; sl < kCoreStages - 1; ++sl) {
    if (sl < slices) load(sl);
    cp_async_commit();
  }
  for (int sl = 0; sl < slices; ++sl) {
    if (sl + kCoreStages - 1 < slices) load(sl + kCoreStages - 1);
    cp_async_commit();
    cp_async_wait<kCoreStages - 1>();
    __syncthreads();
    const int st = sl % kCoreStages;
#pragma unroll
    for (int d = 0; d < kTD; ++d) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int r = ty + 16 * i;
        a[i] = r < bb ? xs[st][r][d] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int c = tx + 16 * j;
        b[j] = c < bn ? static_cast<float>(qs[st][d][c]) * s[j] : 0.f;
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
    const int r = ty + 16 * i, gr = r0 + r;
    if (r >= bb || gr >= B) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = tx + 16 * j, gc = c0 + c;
      if (c < bn && gc < N) y[(size_t)gr * N + gc] = acc[i][j];
    }
  }
}

// -- the tensor route -------------------------------------------------------------

constexpr int kKT = 64;                    // depth of a k-tile
constexpr int kCols = 128;                 // columns of a block
constexpr int kStages = 3;                 // k-tiles in flight
constexpr int kXStride = kKT + 8;          // fp32 row of a staged x tile:
                                           // conflict-free fragment reads
constexpr int kQRawBytes = kKT * kCols;    // int8 q tile
constexpr int kQbBytes = kKT * kCols * 2;  // bf16 q tile, two 64-column boxes
constexpr int kBoxBytes = kKT * 128;       // one box: 64 rows of 128 bytes
constexpr int kTerms = 3;

template <int kWGs>
struct TensorSmem {
  static constexpr int kXBytes = 64 * kWGs * kXStride * 4;
  static constexpr int kStageBytes = kXBytes + kQRawBytes;
  // 1 KB to align the swizzled buffers, two bf16 q tiles, the ring
  static constexpr int kBytes = 1024 + 2 * kQbBytes + kStages * kStageBytes;
};

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

// d (64 x 128, fp32) = a (64 x 16, bf16 registers) * b (16 x 128, bf16 in
// shared memory through ``desc``, MN-major) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc,
                                                 int accumulate) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// (v0, v1) as three packed bf16 pairs t[0] + t[1] + t[2]; a term whose
// first is not finite carries the whole value (the rest are 0)
__device__ __forceinline__ void split_terms(float v0, float v1,
                                            uint32_t (&t)[kTerms]) {
  bool finite0 = true, finite1 = true;
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    t[k] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 hf = __bfloat1622float2(h);
    if (k == 0) {
      finite0 = isfinite(hf.x);
      finite1 = isfinite(hf.y);
    }
    v0 = finite0 ? v0 - hf.x : 0.f;
    v1 = finite1 ? v1 - hf.y : 0.f;
  }
}

// four int8 (one word) as two packed bf16 pairs, exactly: each byte b as
// the fp32 2^23 + (b + 128), less 2^23 + 128, whose high half is bf16(b)
__device__ __forceinline__ void int8x4_to_bf16(uint32_t v, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = v ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

template <int kWGs, bool kPerChannel>
__global__ void __launch_bounds__(128 * kWGs, kWGs == 1 ? 2 : 1)
dq_tensor_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, float* __restrict__ y,
                 int B, int D, int N, int col_tiles) {
  using Smem = TensorSmem<kWGs>;
  constexpr int kThreads = 128 * kWGs, kRows = 64 * kWGs;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the shared address: align to 1 KB
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t qb = base;                          // two bf16 q tiles
  const uint32_t ring = base + 2 * kQbBytes;
  uint8_t* const ring_ptr = base_ptr + 2 * kQbBytes;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32, g = lane / 4, quad = lane % 4;
  const int row0 = (blockIdx.x / col_tiles) * kRows;
  const int col0 = (blockIdx.x % col_tiles) * kCols;
  const int ktiles = (D + kKT - 1) / kKT;

  auto load_tile = [&](int t) {
    const int k0 = t * kKT;
    const uint32_t xs = ring + (t % kStages) * Smem::kStageBytes;
    const uint32_t qr = xs + Smem::kXBytes;
#pragma unroll
    for (int u = 0; u < kRows * (kKT / 4) / kThreads; ++u) {
      const int c = tid + u * kThreads;
      const int r = c / (kKT / 4), ch = c % (kKT / 4);
      const int gr = row0 + r, gk = k0 + 4 * ch;
      const bool ok = gr < B && gk < D;
      cp_async16(xs + (r * kXStride + 4 * ch) * 4,
                 ok ? x + (size_t)gr * D + gk : x, ok);
    }
#pragma unroll
    for (int u = 0; u < kKT * (kCols / 16) / kThreads; ++u) {
      const int c = tid + u * kThreads;
      const int kr = c / (kCols / 16), ch = c % (kCols / 16);
      const int gk = k0 + kr, gc = col0 + 16 * ch;
      const bool ok = gk < D && gc < N;
      cp_async16(qr + kr * kCols + 16 * ch,
                 ok ? q + (size_t)gk * N + gc : q, ok);
    }
  };

  // the int8 q tile of k-tile t, in the ring, as bf16 into buffer t % 2:
  // element (k, n) of box n / 64 at row k, 16-byte chunk (n % 64) / 8
  // swizzled by k % 8, as the 128-byte-swizzle descriptor reads it
  auto convert_tile = [&](int t) {
    const uint8_t* qr = ring_ptr + (t % kStages) * Smem::kStageBytes +
                        Smem::kXBytes;
    uint8_t* dst = base_ptr + (t % 2) * kQbBytes;
#pragma unroll
    for (int u = 0; u < kKT * (kCols / 16) / kThreads; ++u) {
      const int c = tid + u * kThreads;
      const int kr = c / (kCols / 16), ch = c % (kCols / 16);
      const uint4 v = *reinterpret_cast<const uint4*>(qr + kr * kCols +
                                                      16 * ch);
      uint4 lo, hi;
      int8x4_to_bf16(v.x, lo.x, lo.y);
      int8x4_to_bf16(v.y, lo.z, lo.w);
      int8x4_to_bf16(v.z, hi.x, hi.y);
      int8x4_to_bf16(v.w, hi.z, hi.w);
      const int box = ch / 4, c8 = 2 * (ch % 4);
      uint8_t* row = dst + box * kBoxBytes + kr * 128;
      *reinterpret_cast<uint4*>(row + ((c8 ^ (kr & 7)) * 16)) = lo;
      *reinterpret_cast<uint4*>(row + (((c8 + 1) ^ (kr & 7)) * 16)) = hi;
    }
    // generic-proxy writes, read next by the tensor cores' async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  // the prologue: k-tiles 0 .. kStages - 2 in flight, tile 0 converted
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ktiles) load_tile(t);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  convert_tile(0);
  __syncthreads();

  // this thread's fragment rows within the block (A rows lane/4 and +8)
  const int frow = wg * 64 + warp * 16 + g;
  float part[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = sum[i] = 0.f;

  for (int t = 0; t < ktiles; ++t) {
    // the k-tile kStages - 1 ahead goes in flight (an empty group past the
    // end keeps the group count uniform)
    if (t + kStages - 1 < ktiles) load_tile(t + kStages - 1);
    cp_async_commit();

    // x terms of this k-tile in the A fragment layout: register j of k16
    // step kk holds columns 16kk + 2*quad (+8 for j = 2, 3) of row frow
    // (+8 for j = 1, 3)
    const float* xs = reinterpret_cast<const float*>(
        ring_ptr + (t % kStages) * Smem::kStageBytes);
    uint32_t terms[kTerms][kKT / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = frow + 8 * (j & 1);
        const int c = 16 * kk + 2 * quad + 8 * (j >> 1);
        const float2 v = *reinterpret_cast<const float2*>(
            xs + r * kXStride + c);
        uint32_t tv[kTerms];
        split_terms(v.x, v.y, tv);
#pragma unroll
        for (int k = 0; k < kTerms; ++k) terms[k][kk][j] = tv[k];
      }

    // the small terms first, each over the k-tile's k16 steps, into a
    // fresh accumulator
    const uint32_t qtile = qb + (t % 2) * kQbBytes;
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int k = kTerms - 1; k >= 0; --k)
#pragma unroll
      for (int kk = 0; kk < kKT / 16; ++kk)
        wgmma_m64n128k16(part, terms[k][kk],
                         smem_desc(qtile + kk * 16 * 128, kBoxBytes, 1024),
                         !(k == kTerms - 1 && kk == 0));
    wgmma_commit();

    // while they run: the next k-tile's q, converted into the other buffer
    if (t + 1 < ktiles) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      convert_tile(t + 1);
    }
    wgmma_wait_all();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += part[i];
    __syncthreads();
  }

  // epilogue: element e of n8 group j sits at row frow + 8 * (e / 2),
  // column 8j + 2 * quad + e % 2; the scale multiplies the finished sum
  const float s0 = kPerChannel ? 1.f : scale[0];
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
    const int gc = col0 + 8 * j + 2 * quad;
    if (gc >= N) continue;
    float2 s = make_float2(s0, s0);
    if (kPerChannel) s = *reinterpret_cast<const float2*>(scale + gc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + frow + 8 * h;
      if (gr < B)
        *reinterpret_cast<float2*>(y + (size_t)gr * N + gc) =
            make_float2(sum[4 * j + 2 * h] * s.x, sum[4 * j + 2 * h + 1] * s.y);
    }
  }
}

template <int kWGs, bool kPerChannel>
int launch_tensor(const float* x, const int8_t* q, const float* scale,
                  float* y, int B, int D, int N, cudaStream_t s) {
  constexpr int smem = TensorSmem<kWGs>::kBytes;
  auto kernel = dq_tensor_kernel<kWGs, kPerChannel>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int col_tiles = (N + kCols - 1) / kCols;
  const int row_tiles = (B + 64 * kWGs - 1) / (64 * kWGs);
  kernel<<<(unsigned)row_tiles * (unsigned)col_tiles, 128 * kWGs, smem, s>>>(
      x, q, scale, y, B, D, N, col_tiles);
  return static_cast<int>(cudaGetLastError());
}

// Outputs a thread holds along a tile side of ``n`` (16 threads a side):
// the least power of two that covers it, at most kMaxOut.
int tile_outputs(int n) {
  int t = 1;
  while (16 * t < n && t < kMaxOut) t *= 2;
  return t;
}

struct CoreLaunch {
  const float* x;
  const int8_t* q;
  const float* scale;
  int scale_stride;
  float* y;
  int B, D, N, bb, bn;
  bool vec;
  cudaStream_t stream;
};

template <int kTM, int kTN>
int launch_core(const CoreLaunch& c) {
  const int col_tiles = (c.N + c.bn - 1) / c.bn;
  const dim3 grid((unsigned)((c.B + c.bb - 1) / c.bb) * (unsigned)col_tiles);
  if (c.vec)
    dq_core_vec_kernel<kTM, kTN><<<grid, kCoreThreads, 0, c.stream>>>(
        c.x, c.q, c.scale, c.scale_stride, c.y, c.B, c.D, c.N, c.bb, c.bn,
        col_tiles);
  else
    dq_core_kernel<kTM, kTN><<<grid, kCoreThreads, 0, c.stream>>>(
        c.x, c.q, c.scale, c.scale_stride, c.y, c.B, c.D, c.N, c.bb, c.bn,
        col_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int kTM>
int launch_core_tn(int tn, const CoreLaunch& c) {
  switch (tn) {
    case 1: return launch_core<kTM, 1>(c);
    case 2: return launch_core<kTM, 2>(c);
    case 4: return launch_core<kTM, 4>(c);
    default: return launch_core<kTM, 8>(c);
  }
}

int launch_core_tm(int tm, int tn, const CoreLaunch& c) {
  switch (tm) {
    case 1: return launch_core_tn<1>(tn, c);
    case 2: return launch_core_tn<2>(tn, c);
    case 4: return launch_core_tn<4>(tn, c);
    default: return launch_core_tn<8>(tn, c);
  }
}

}  // namespace

extern "C" {

// Launches on ``stream`` and returns cudaGetLastError(). ``route`` 1 is the
// tensor route (N % 16 == 0, D % 4 == 0, x and q on 16-byte bases), with
// ``bb`` 64 or 128 rows a block (``bn`` unused: 128 columns); ``route`` 0
// the CUDA-core route with scalar loads, 2 the same with 16-byte cp.async
// (N % 16 == 0, D % 4 == 0, 16-byte bases, ``bn`` a multiple of 16), ``bb``
// and ``bn`` in [1, 128] (the Python wrapper clamps a table's entry there).
// ``per_channel`` selects a (N,) scale over a single () one.
int dequant_matmul_f32(const void* x, const void* q, const void* scale,
                       void* y, int B, int D, int N, int route, int bb,
                       int bn, int per_channel, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto qp = static_cast<const int8_t*>(q);
  auto sp = static_cast<const float*>(scale);
  auto yp = static_cast<float*>(y);
  if (route == 1) {
    if (N % 16 != 0 || D % 4 != 0 || (bb != 64 && bb != 128))
      return static_cast<int>(cudaErrorInvalidValue);
    if (bb == 128)
      return per_channel ? launch_tensor<2, true>(xp, qp, sp, yp, B, D, N, s)
                         : launch_tensor<2, false>(xp, qp, sp, yp, B, D, N, s);
    return per_channel ? launch_tensor<1, true>(xp, qp, sp, yp, B, D, N, s)
                       : launch_tensor<1, false>(xp, qp, sp, yp, B, D, N, s);
  }
  if (route < 0 || route > 2 || bb < 1 || bb > kMaxTile || bn < 1 ||
      bn > kMaxTile)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 2 && (N % 16 != 0 || D % 4 != 0 || bn % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const CoreLaunch c{xp, qp, sp, per_channel ? 1 : 0, yp, B, D, N, bb, bn,
                     route == 2, s};
  return launch_core_tm(tile_outputs(bb), tile_outputs(bn), c);
}

const char* dequant_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
