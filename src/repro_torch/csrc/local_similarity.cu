// local_similarity_dist: unnormalized pairwise L1 distances of the w rows of
// every row window of the SPA.
//
// Replaces the Pallas TPU kernel src/repro/kernels/local_similarity.py,
// function local_similarity_dist (body _kernel): the similarity unit of the
// paper (Sec. III-B), the numerator of core/similarity.windowed_l1:
//
//   out[g, i, j] = sum_c |spa[g*w + i, c] - spa[g*w + j, c]|
//
// for window g of the (B * H * L / w) windows, rows i, j < w.
//
// What bounds it on an H100: the bytes.  Every SPA element is read from
// device memory once and reused for all its pairs from registers, so at the
// path shape (8 x 12 x 384 x 384 float32: 56.6 MB in, 1.2 MB out) the floor
// is about 17 us at 3.35 TB/s; the 3 w^2 operations per column of a window
// (0.34 G at that shape) take 5 us at the card's 67 TFLOP/s float32 rate.
//
// Design: one warp per window, eight windows per 256-thread block.  Lane l
// streams columns l, l + 32, ... of the window's w rows from device memory
// into registers (a warp reads 32 consecutive floats of each row per step,
// so the reads are coalesced) and adds |a_i - a_j| into the w(w-1)/2
// upper-triangle pair sums it keeps in registers, in float32.  No element
// is used by two threads, so nothing needs staging in shared memory.  A
// butterfly of warp shuffles then sums every pair over the 32 lanes, and
// the lanes write the w x w tile: the upper triangle mirrored into the
// lower one and a zero diagonal, so the result is exactly symmetric.  w is
// a template parameter (1 to 16: at most 120 pair sums in registers);
// ragged Lk is the column loop's own bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;

// index of pair (i, j), i < j, in the row-major upper triangle of a w x w
// tile; constant once the loops over i and j are unrolled
__host__ __device__ constexpr int pair_index(int w, int i, int j) {
  return i * (2 * w - i - 1) / 2 + (j - i - 1);
}

template <int W>
__global__ void __launch_bounds__(WARPS * 32)
local_similarity_kernel(const float* __restrict__ spa, float* __restrict__ out,
                        long long n_windows, int Lk) {
  constexpr int P = W * (W - 1) / 2;
  const int lane = threadIdx.x % 32;
  const long long g = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (g >= n_windows) return;                  // whole warps leave together
  const float* rows = spa + (size_t)g * W * Lk;
  float acc[P > 0 ? P : 1];
#pragma unroll
  for (int p = 0; p < (P > 0 ? P : 1); ++p) acc[p] = 0.f;

  for (int c = lane; c < Lk; c += 32) {
    float v[W];
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = __ldg(rows + (size_t)i * Lk + c);
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int j = i + 1; j < W; ++j)
        acc[pair_index(W, i, j)] += fabsf(v[i] - v[j]);
  }
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[p] += __shfl_xor_sync(0xffffffffu, acc[p], off);

  // every lane holds every pair sum; lane l writes the tile entries e with
  // e % 32 == l (the conditions fold to predicates: no dynamic indexing)
  float* tile = out + (size_t)g * W * W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if ((i * W + i) % 32 == lane) tile[i * W + i] = 0.f;
#pragma unroll
    for (int j = i + 1; j < W; ++j) {
      const float d = acc[pair_index(W, i, j)];
      if ((i * W + j) % 32 == lane) tile[i * W + j] = d;
      if ((j * W + i) % 32 == lane) tile[j * W + i] = d;
    }
  }
}

template <int W>
int launch(const float* spa, float* out, long long n_windows, int Lk,
           cudaStream_t stream) {
  const long long blocks = (n_windows + WARPS - 1) / WARPS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  local_similarity_kernel<W><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
      spa, out, n_windows, Lk);
  return (int)cudaGetLastError();
}

}  // namespace

// spa (n_windows * w, Lk) -> out (n_windows, w, w); float32, row-major and
// contiguous; 1 <= w <= 16.  Launches on `stream`; returns the launch's
// cudaError_t.
extern "C" int local_similarity_dist_f32(const float* spa, float* out,
                                         long long n_windows, int w, int Lk,
                                         void* stream) {
  if (n_windows <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (w) {
    case 1: return launch<1>(spa, out, n_windows, Lk, s);
    case 2: return launch<2>(spa, out, n_windows, Lk, s);
    case 3: return launch<3>(spa, out, n_windows, Lk, s);
    case 4: return launch<4>(spa, out, n_windows, Lk, s);
    case 5: return launch<5>(spa, out, n_windows, Lk, s);
    case 6: return launch<6>(spa, out, n_windows, Lk, s);
    case 7: return launch<7>(spa, out, n_windows, Lk, s);
    case 8: return launch<8>(spa, out, n_windows, Lk, s);
    case 9: return launch<9>(spa, out, n_windows, Lk, s);
    case 10: return launch<10>(spa, out, n_windows, Lk, s);
    case 11: return launch<11>(spa, out, n_windows, Lk, s);
    case 12: return launch<12>(spa, out, n_windows, Lk, s);
    case 13: return launch<13>(spa, out, n_windows, Lk, s);
    case 14: return launch<14>(spa, out, n_windows, Lk, s);
    case 15: return launch<15>(spa, out, n_windows, Lk, s);
    case 16: return launch<16>(spa, out, n_windows, Lk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
