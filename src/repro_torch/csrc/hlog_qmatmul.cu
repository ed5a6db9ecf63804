// hlog_qmatmul: hlog(xq) @ hlog(wq) on integer-valued float32 codes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hlog_qmatmul.py, function
// hlog_qmatmul (bodies _hlog_project_inkernel and _kernel): the first-stage
// product of the SPLS attention predictor, the 8-bit codes of X and W_Q /
// W_K after HLog projection (Sec. IV-B of the paper).
//
// HLog projection.  |q| = 2^m * r with r in [1, 2): r < 1.25 -> 2^m,
// r < 1.75 -> 1.5 * 2^m, otherwise 2^(m+1); 0 -> 0; the sign is kept.  m is
// the float's exponent field and the level comes from the top mantissa bits
// (r < 1.25 <=> mantissa < 0x200000, r < 1.75 <=> mantissa < 0x600000):
// the shift detector of the paper's bit-level unit, not a log2.  A magnitude
// below 1 snaps to 1, as the reference's max(|q|, 1) does.  Each operand
// element is projected once, as its tile is loaded into shared memory.
//
// Exactness.  Inputs are integer-valued in [-127, 127] (the reference's
// contract; the wrapper does not scan values).  Every level is then an
// integer (1, 2, 3, 4, 6, 8, 12, ..., 96, 128), every product an integer of
// magnitude <= 16384, and the kernel holds levels and sums in int32: exact
// for K < 131072.  It converts to float32 once, at the store, so it equals
// the plain version (float64 product, rounded once) bit for bit.
//
// What bounds it on an H100: at the predictor's shape (M 3072 = 8 x 384
// rows, K = N = 768) the bytes -- 21.2 MB, about 6.3 us at 3.35 TB/s --
// over the 3.6 G operations, which the bf16 tensor cores could do exactly
// (the levels are exact in bf16, the partial sums in their float32
// accumulators for K <= 1024) in 3.7 us.  This simple kernel multiplies on
// the CUDA cores' int32 IMAD, 64 lanes per SM per clock (about 33.5 TOP/s),
// so its own design limit is about 0.11 ms at that shape; a wgmma path is
// later work.
//
// Design: 64 x 64 output tiles, 256 threads, a 4 x 4 patch per thread, K in
// steps of 16.  Each step's 64 x 16 tile of xq and 16 x 64 tile of wq arrive
// in registers with coalesced reads, are projected to signed integer levels
// and stored in shared memory (the x tile padded to 17 columns so the two
// rows a warp reads sit in different banks; a thread reads its four w
// columns as one int4).  The raw floats of the next step are fetched right
// after the store, so their device-memory latency overlaps this step's
// products: the first version, without that prefetch, took about twice as
// long at the predictor's shape for the same IMAD count -- the kernel waits
// on memory, not on IMAD.  Three blocks per SM (at most 80 registers a
// thread, at which ptxas spills a few bytes) keep more warps in flight.
// Ragged M, N and K are masked: elements outside the matrices load as
// level 0 and are never stored.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;
constexpr int XPER = BM * BK / THREADS, WPER = BK * BN / THREADS;

__device__ __forceinline__ int hlog_level(float v) {
  const unsigned u = __float_as_uint(v);
  const unsigned mag = u & 0x7fffffffu;
  if (mag == 0u) return 0;
  int m = (int)(mag >> 23) - 127;            // floor(log2 |v|)
  const unsigned mant = mag & 0x7fffffu;
  int lvl;
  if (m < 0) {
    lvl = 1;                                 // 0 < |v| < 1: max(|v|, 1)
  } else {
    m = m > 29 ? 29 : m;                     // far outside the contract
    if (mant < 0x200000u) {
      lvl = 1 << m;
    } else if (mant < 0x600000u) {
      lvl = (3 << m) >> 1;                   // 1.5 * 2^m; m >= 1 on integers
    } else {
      lvl = 2 << m;
    }
  }
  return (u >> 31) ? -lvl : lvl;
}

// Raw floats of the k tile at k0: thread tid holds elements tid + s *
// THREADS of the x tile (row-major 64 x 16) and of the w tile (16 x 64);
// a warp reads runs of 16 and 32 consecutive floats.
__device__ __forceinline__ void fetch_tiles(
    const float* __restrict__ x, const float* __restrict__ w, int M, int K,
    int N, int m0, int n0, int k0, int tid, float (&xr)[XPER],
    float (&wr)[WPER]) {
#pragma unroll
  for (int s = 0; s < XPER; ++s) {
    const int e = tid + s * THREADS;
    const int gm = m0 + e / BK, gk = k0 + e % BK;
    xr[s] = (gm < M && gk < K) ? __ldg(x + (size_t)gm * K + gk) : 0.f;
  }
#pragma unroll
  for (int s = 0; s < WPER; ++s) {
    const int e = tid + s * THREADS;
    const int gk = k0 + e / BN, gn = n0 + e % BN;
    wr[s] = (gk < K && gn < N) ? __ldg(w + (size_t)gk * N + gn) : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS, 3)
hlog_qmatmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int M, int K, int N) {
  __shared__ int xs[BM][BK + 1];
  __shared__ __align__(16) int ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;    // patch: rows ty*4+i, cols tx*4+j
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  float xr[XPER], wr[WPER];
  fetch_tiles(x, w, M, K, N, m0, n0, 0, tid, xr, wr);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int s = 0; s < XPER; ++s) {
      const int e = tid + s * THREADS;
      xs[e / BK][e % BK] = hlog_level(xr[s]);
    }
#pragma unroll
    for (int s = 0; s < WPER; ++s) {
      const int e = tid + s * THREADS;
      ws[e / BN][e % BN] = hlog_level(wr[s]);
    }
    __syncthreads();
    if (k0 + BK < K)                         // in flight during the products
      fetch_tiles(x, w, M, K, N, m0, n0, k0 + BK, tid, xr, wr);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const int4 b4 = *reinterpret_cast<const int4*>(&ws[kk][tx * 4]);
      const int b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = xs[ty * 4 + i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a * b[j];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) out[(size_t)gm * N + gn] = __int2float_rn(acc[i][j]);
    }
  }
}

}  // namespace

// xq (M, K), wq (K, N) -> out (M, N); float32, row-major and contiguous.
// Launches on `stream`; returns the launch's cudaError_t.
extern "C" int hlog_qmatmul_f32(const float* x, const float* w, float* out,
                                int M, int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  hlog_qmatmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, w, out,
                                                                  M, K, N);
  return (int)cudaGetLastError();
}
