// gathered_matmul: out = x[perm] @ w, float32 in and out, with the row
// gather fused into the tile loads.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gathered_matmul.py,
// function gathered_matmul (kernel body _gmm_kernel): the packed Q
// projection and the FFN up-projection of the SPLS chunked prefill, where
// only the critical rows of a 64-row chunk are computed.
//
// What bounds it on an H100: at the serving shapes (C <= 64 packed rows,
// D = 768, F = 768 or 3072) the product is small.  2*C*D*F operations on
// the CUDA cores' float32 rate (67 TFLOP/s) take about 4.5 us at C = 64,
// F = 3072, against about 3.1 us to move x's rows, w and the output once
// at 3.35 TB/s: it sits near the ridge, and at these sizes launch latency
// and the few blocks in flight (24 to 96) dominate.
//
// Design: each block owns a 32 x 64 output tile.  It loads its tile's perm
// entries once into shared memory, then walks the contraction in K-slices
// of 32: the x rows are gathered by those indices straight into a shared
// tile (TMA has no row gather on sm_90, so these are indexed, coalesced
// loads along each row), w's slice is staged beside it, and every thread
// accumulates a 2 x 4 block of the output in registers.  Ragged C, F and
// D are masked in the kernel instead of padded.  Indices outside [0, L)
// are clamped, as the reference's gathers clamp.
//
// Accumulation is in float64, rounded to float32 once at the end.  The
// product of two float32 values is exact in float64, so the rounded
// result is the correctly rounded sum in all but a vanishing fraction of
// elements, whatever the summation order: this kernel and the plain
// version (a float64 matrix product) agree bit for bit.  That matters
// here because SPLS thresholds quantized predictions of the next layer's
// input -- a last-bit difference in a projection can flip a plan and
// change the generated tokens.  Float64 FMA runs at half the float32
// rate on the CUDA cores; tensor cores (wgmma, TMA) are later work.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 32;   // contraction slice staged per step
constexpr int TM = 2;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int TX = BN / TN;                  // 16 column groups
constexpr int THREADS = (BM / TM) * TX;      // 256

__global__ void __launch_bounds__(THREADS)
gmm_kernel(const float* __restrict__ x, const float* __restrict__ w,
           const int* __restrict__ perm, float* __restrict__ out,
           int L, int D, int F, int C) {
  __shared__ int rows[BM];
  __shared__ float As[BK][BM + 1];   // transposed x tile, padded
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  if (tid < BM) {
    const int c = m0 + tid;
    int r = -1;                      // -1: row past C, loads zeros
    if (c < C) {
      r = perm[c];
      r = r < 0 ? 0 : (r >= L ? L - 1 : r);
    }
    rows[tid] = r;
  }
  __syncthreads();

  const int tx = tid % TX;
  const int ty = tid / TX;
  double acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0;

  for (int k0 = 0; k0 < D; k0 += BK) {
    // gather: consecutive threads read consecutive k of one source row
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int m = i / BK, kk = i % BK, k = k0 + kk;
      const int r = rows[m];
      As[kk][m] = (r >= 0 && k < D) ? __ldg(x + (size_t)r * D + k) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, n = i % BN, k = k0 + kk, col = n0 + n;
      Bs[kk][n] = (k < D && col < F) ? __ldg(w + (size_t)k * F + col) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      double a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = (double)As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = (double)Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + j * TX;
      if (col < F) out[(size_t)row * F + col] = (float)acc[i][j];
    }
  }
}

}  // namespace

// x (L, D), w (D, F), perm (C,) int32 -> out (C, F); all float32,
// row-major and contiguous.  Launches on `stream`; returns the launch's
// cudaError_t (0 on success).
extern "C" int gathered_matmul_f32(const float* x, const float* w,
                                   const int* perm, float* out, int L, int D,
                                   int F, int C, void* stream) {
  if (L <= 0 || D <= 0 || F <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM);
  gmm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, w, perm, out, L,
                                                         D, F, C);
  return (int)cudaGetLastError();
}
