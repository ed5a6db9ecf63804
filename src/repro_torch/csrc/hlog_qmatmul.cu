// hlog_qmatmul: hlog(xq) @ hlog(wq) on integer-valued float32 codes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hlog_qmatmul.py, function
// hlog_qmatmul (bodies _hlog_project_inkernel and _kernel): the first-stage
// product of the SPLS attention predictor, the 8-bit codes of X and W_Q /
// W_K after HLog projection (Sec. IV-B of the paper).
//
// HLog projection.  |q| = 2^m * r with r in [1, 2): r < 1.25 -> 2^m,
// r < 1.75 -> 1.5 * 2^m, otherwise 2^(m+1); 0 -> 0; the sign is kept.  That
// is the mantissa rounded to one bit, ties up: on the bits of the value,
// add a quarter of the leading bit's weight to the mantissa field and clear
// everything below its top bit -- the shift detector of the paper's
// bit-level unit, not a log2.  An integer of magnitude <= 255 has at most 8
// significant bits, so its bf16 (the top half of its float32 bits) is
// exact, and the rule runs on two bf16 lanes of one 32-bit word at once:
// ((hi16(a) | hi16(b) << 16) + 0x00200020) & 0xffc0ffc0 -- one byte
// permute, one add and one and for two elements.  The result is the level
// in bf16, exactly: every HLog level (1, 2, 3, 4, 6, ..., 96, 128) has at
// most two significant bits.  The rule carries the sign and maps 0 to 0.
//
// Contract and exactness.  Inputs are integer-valued in [-127, 127] (the
// reference's contract; the wrapper does not scan values).  Every product
// of two levels is an integer of magnitude <= 16384.  The bf16 tensor cores
// (wgmma, float32 accumulators) sum them; how they align and round inside
// an accumulation near 2^24 is not documented, so the kernel never lets
// them get there: every 256 of K (every 4 slices) it waits for its
// products, converts the float32 accumulators -- exact integers of
// magnitude <= 256 * 16384 = 2^22 -- to int32, adds them to int32 sums and
// restarts them at 0.  The int32 sums are exact for K < 131072; the store
// converts each to float32 once (__int2float_rn), so the kernel equals the
// plain version (float64 product, rounded once) bit for bit at every K the
// wrapper takes.  Outside the contract (non-integers, |q| > 127) the bit
// rule differs from the plain version's level table, as the earlier kernel
// did above 127.
//
// What bounds it on an H100: at the predictor's shape (M 3072 = 8 x 384
// rows, K = N = 768) the bytes -- 21.2 MB, 6.3 us at 3.35 TB/s -- over the
// 3.6 G bf16 tensor-core operations (3.7 us at 989 TFLOP/s).  A GEMM's
// blocks read their operand tiles again and again from L2 (x once per
// column tile, w once per row tile: 23.6 M elements at 128 x 192 tiles).
// Read as the raw float32 codes and projected in every block, as a first
// version of this kernel did, that is 94 MB, and ablation builds of that
// version on an H100 showed its loads to take most of its time.  As bf16
// levels it is 47 MB.
//
// Design -- two kernels on the stream, one call:
//  - hlog_project_kernel reads each code once and writes its level once as
//    bf16 into a workspace the wrapper allocates: x as (M, Kp), w
//    transposed to (N, Kp), Kp = K rounded up to 8 with zero levels, so
//    both operands are K-major and every 8-element chunk of a row is one
//    aligned 16-byte copy.
//  - hlog_qmatmul_kernel: a block owns a 128 x BN output tile (BN 64, 128
//    or 192, picked by hlog_tiling in kernels/hlog_qmatmul.py to fill the
//    132 SMs in as few waves as possible: at the predictor's shape 128 x
//    192 gives 96 tiles, one wave, where 128 x 128 gives 144, a wave and a
//    tail).  Two warpgroups (256 threads) each own 64 rows x BN columns.
//    The bf16 tiles of each 64-deep K slice arrive by 16-byte cp.async in
//    a ring of 5 stages, three slices in flight while one is multiplied;
//    ragged M and N are zero-filled by the copies' source size.  They land
//    in the 128-byte swizzle layout (a row's 16-byte chunk c at position c
//    xor row % 8): in the same ablation builds wgmma read the plain
//    no-swizzle layout far more slowly.  Each warpgroup issues wgmma
//    m64nBNk16 (A and B from shared memory) for the slice, commits, and
//    waits only for the slice before, so one barrier a slice separates the
//    copies from the products.  Every 4 slices: the drain above.  The
//    store writes float32 of the int32 sums, masked at the ragged edges.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;           // output rows per block: 2 warpgroups x 64
constexpr int BK = 64;            // K slice per ring stage
constexpr int STAGES = 5;         // bf16 operand ring depth
constexpr int THREADS = 256;
constexpr int DRAIN_SLICES = 256 / BK;   // drain every 256 of K
constexpr int ROW = BK * 2;       // bytes of a tile row's K slice: 128
constexpr int ATOM = 8 * ROW;     // 8 rows: one 128-byte swizzle atom
constexpr int PROJECT_THREADS = 256;

template <int BN>
struct Tile {
  static constexpr int A = BM * ROW;              // bytes per stage
  static constexpr int B = BN * ROW;
  static constexpr int SMEM = STAGES * (A + B);
  static constexpr int ACC = BN / 2;              // accumulators a thread
};

// wgmma m64nNk16, bf16 x bf16 -> float32, A and B K-major in shared memory
// (descriptors a, b), accumulating into d.
template <int BN>
__device__ void wgmma_bf16(float (&d)[BN / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32],
                                                uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64],
                                                uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<192>(float (&d)[96],
                                                uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// this thread's generic-proxy shared-memory writes, visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The asynchronous products write d behind the compiler's back: after a
// wait for all of them, keep every access of d below this point.  (Only
// there: touching d while products are in flight makes ptxas wait for
// them.)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle
// layout: start address, 8-row atoms ATOM bytes apart, swizzle mode 1
// (the leading offset is unused in this mode; 16 bytes by convention)
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFFu) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(ATOM >> 4) << 32) | (1ull << 62);
}

// HLog levels of two integer-valued floats as a pair of bf16 (see above):
// lo in the low half, hi in the high half
__device__ __forceinline__ uint32_t hlog2(float lo, float hi) {
  const uint32_t w =
      __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
  return (w + 0x00200020u) & 0xffc0ffc0u;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Pass 1: the levels of x as (M, Kp) bf16 and of w transposed as (N, Kp),
// one 16-byte chunk of 8 K values a thread; K values past K are level 0.
__global__ void __launch_bounds__(PROJECT_THREADS)
hlog_project_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    uint4* __restrict__ xl, uint4* __restrict__ wt, int M,
                    int K, int N, int Kp, int vec) {
  const long long chunks = Kp / 8;
  const long long nx = (long long)M * chunks, total = nx + N * chunks;
  for (long long t = blockIdx.x * (long long)PROJECT_THREADS + threadIdx.x;
       t < total; t += (long long)gridDim.x * PROJECT_THREADS) {
    float f[8];
    if (t < nx) {                           // x row m, K values 8c ..
      const long long m = t / chunks;
      const int k0 = (int)(t % chunks) * 8;
      const float* src = x + m * K + k0;
      if (vec) {                            // K % 8 == 0, x 16-byte aligned
        const float4 a = __ldg(reinterpret_cast<const float4*>(src));
        const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
        f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
        f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = k0 + j < K ? __ldg(src + j) : 0.f;
      }
      xl[t] = make_uint4(hlog2(f[0], f[1]), hlog2(f[2], f[3]),
                         hlog2(f[4], f[5]), hlog2(f[6], f[7]));
    } else {                                // w column n, K values 8c ..
      const long long u = t - nx;
      const int n = (int)(u % N);
      const int c = (int)(u / N);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        f[j] = 8 * c + j < K ? __ldg(w + (size_t)(8 * c + j) * N + n) : 0.f;
      wt[(size_t)n * chunks + c] =
          make_uint4(hlog2(f[0], f[1]), hlog2(f[2], f[3]), hlog2(f[4], f[5]),
                     hlog2(f[6], f[7]));
    }
  }
}

// Pass 2: out = xl @ wt^T on the bf16 tensor cores, exact integer sums.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
hlog_qmatmul_kernel(const uint16_t* __restrict__ xl,
                    const uint16_t* __restrict__ wt, float* __restrict__ out,
                    int M, int Kp, int N) {
  using T = Tile<BN>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x;
  const int wg = tid >> 7;                  // warpgroup: rows 64 wg ..
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int slices = (Kp + BK - 1) / BK;

  // slice `slice` of both operands into ring stage `stage`: the 16-byte
  // chunk c of row r lands at row r, position c ^ (r % 8) -- the 128-byte
  // swizzle; eight neighbouring threads write rows r .. r + 7 of one chunk,
  // eight distinct bank groups
  constexpr int CH = BK / 8;
  auto load = [&](int stage, int slice) {
    const int k0 = slice * BK;
    unsigned char* a = smem + stage * (T::A + T::B);
    unsigned char* b = a + T::A;
#pragma unroll
    for (int s = 0; s < BM * (BK / 8) / THREADS; ++s) {
      const int i = tid + s * THREADS;
      const int r = i / (8 * CH) * 8 + (i & 7), c = (i >> 3) % CH;
      const bool in = m0 + r < M && k0 + 8 * c < Kp;
      cp_async16(a + r * ROW + ((c ^ (r & 7)) << 4),
                 in ? xl + (size_t)(m0 + r) * Kp + k0 + 8 * c : xl,
                 in ? 16 : 0);
    }
#pragma unroll
    for (int s = 0; s < BN * (BK / 8) / THREADS; ++s) {
      const int i = tid + s * THREADS;
      const int r = i / (8 * CH) * 8 + (i & 7), c = (i >> 3) % CH;
      const bool in = n0 + r < N && k0 + 8 * c < Kp;
      cp_async16(b + r * ROW + ((c ^ (r & 7)) << 4),
                 in ? wt + (size_t)(n0 + r) * Kp + k0 + 8 * c : wt,
                 in ? 16 : 0);
    }
  };

  float acc[T::ACC];
  int sum[T::ACC];
#pragma unroll
  for (int j = 0; j < T::ACC; ++j) {
    acc[j] = 0.f;
    sum[j] = 0;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < slices) load(s, s);
    cp_async_commit();
  }
  for (int d0 = 0; d0 < slices; d0 += DRAIN_SLICES) {
    const int d1 = min(slices, d0 + DRAIN_SLICES);
    for (int i = d0; i < d1; ++i) {
      cp_async_wait<STAGES - 3>();   // slice i landed (this thread's part)
      fence_proxy_async();           // ... visible to wgmma
      __syncthreads();               // ... all of it; slice i-2's products
                                     // are done in both warpgroups
      if (i + STAGES - 2 < slices)
        load((i + STAGES - 2) % STAGES, i + STAGES - 2);
      cp_async_commit();

      const unsigned char* a =
          smem + (i % STAGES) * (T::A + T::B) + wg * 64 * ROW;
      const unsigned char* b = smem + (i % STAGES) * (T::A + T::B) + T::A;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_bf16<BN>(acc, smem_desc(a + 32 * kk), smem_desc(b + 32 * kk));
      wgmma_commit();
      wgmma_wait<1>();               // slice i-1's products are done
    }
    // every 256 of K: all products done, the exact float32 integers
    // drained into int32 and the accumulators restarted
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < T::ACC; ++j) {
      sum[j] += __float2int_rn(acc[j]);
      acc[j] = 0.f;
    }
  }

  // accumulator layout of wgmma m64nN: warp w of the warpgroup holds rows
  // 16 w + lane / 4 (+ 8); element 4 j + e is column 8 j + 2 (lane % 4) +
  // e % 2, in the upper row for e >= 2
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int r0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int c0 = n0 + 2 * (lane & 3);
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = c0 + 8 * j;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      if (r >= M || c >= N) continue;
      float* o = out + (size_t)r * N + c;
      const float v0 = __int2float_rn(sum[4 * j + 2 * hh]);
      const float v1 = __int2float_rn(sum[4 * j + 2 * hh + 1]);
      if (pairs) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        o[0] = v0;
        if (c + 1 < N) o[1] = v1;
      }
    }
  }
}

template <int BN>
int launch(const uint16_t* xl, const uint16_t* wt, float* out, int M,
           int Kp, int N, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        hlog_qmatmul_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile<BN>::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  hlog_qmatmul_kernel<BN><<<grid, THREADS, Tile<BN>::SMEM, stream>>>(
      xl, wt, out, M, Kp, N);
  return (int)cudaGetLastError();
}

}  // namespace

// xq (M, K), wq (K, N) -> out (M, N); float32, row-major and contiguous.
// ws: a workspace of (M + N) * Kp bf16 (2-byte) elements, Kp = K rounded
// up to 8, 16-byte aligned.  bn (64, 128 or 192) is the output tile's
// width, chosen by the caller (hlog_tiling).  Launches both passes on
// `stream`; returns the first failed launch's cudaError_t, else 0.
extern "C" int hlog_qmatmul_f32(const float* x, const float* w, void* ws,
                                float* out, int M, int K, int N, int bn,
                                void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (M + BM - 1) / BM > 65535 ||
      (reinterpret_cast<uintptr_t>(ws) & 15) != 0 ||
      (bn != 64 && bn != 128 && bn != 192))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int Kp = (K + 7) / 8 * 8;
  uint16_t* xl = static_cast<uint16_t*>(ws);
  uint16_t* wt = xl + (size_t)M * Kp;
  const long long chunks = (long long)(M + N) * (Kp / 8);
  const long long blocks = (chunks + PROJECT_THREADS - 1) / PROJECT_THREADS;
  const int vec = K % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  hlog_project_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096),
                        PROJECT_THREADS, 0, s>>>(
      x, w, reinterpret_cast<uint4*>(xl), reinterpret_cast<uint4*>(wt), M, K,
      N, Kp, vec);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  switch (bn) {
    case 64: return launch<64>(xl, wt, out, M, Kp, N, s);
    case 128: return launch<128>(xl, wt, out, M, Kp, N, s);
    default: return launch<192>(xl, wt, out, M, Kp, N, s);
  }
}
