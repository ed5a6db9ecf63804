// gathered_matmul: out = x[perm] @ w, float32 in and out, with the row
// gather fused into the tile loads.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gathered_matmul.py,
// function gathered_matmul (kernel body _gmm_kernel): the packed Q
// projection and the FFN up-projection of the SPLS chunked prefill, where
// only the critical rows of a 64-row chunk are computed.
//
// Numerics.  Every operand is converted to float64 once, as its fragment
// is loaded from shared memory, and the products are summed in float64 on
// the FP64 tensor cores (DMMA: mma.sync m16n8k8 .f64), then rounded to
// float32 once.  A float32 product is exact in float64, so the rounded
// result is the correctly rounded sum in all but a vanishing fraction of
// elements, whatever the summation order -- any tile order, any split of
// the contraction: this kernel and its plain version (a float64 matrix
// product) agree bit for bit.  That matters because SPLS thresholds
// quantized predictions of the next layer's input: a last-bit difference
// in a projection can flip a plan and change the generated tokens.  The
// faster tensor-core paths do not keep that: wgmma has no float64 form, and
// every TF32 / bf16 path (3xTF32 included) accumulates in float32, rounding
// each partial sum.
//
// What bounds it on an H100: at the serving shapes (C <= 64 packed rows,
// D = 768, F = 768 or 3072) 2*C*D*F float64 operations take 4.5 us at the
// card's 67 TFLOP/s float64 peak (DMMA; the CUDA cores' DFMA give half) at
// C = 64, F = 3072, against 2.8 us to read w once at 3.35 TB/s; at F = 768
// a quarter of each.  So the product is small, and what limits it is
// filling 132 SMs and keeping copies in flight.
//
// Design:
//  - A block owns a BM x 64 output tile (BM = 16, 32 or 64 by C, chosen
//    with the split factor by gmm_tiling in kernels/gathered_matmul.py)
//    and one contiguous share of the contraction (split-K): at C <= 64
//    there are only 2 to 48 output tiles, so the splits fill the card.
//  - The block loads its perm entries once (out-of-range indices clamp, as
//    the reference's gathers clamp; rows past C load zeros).  The gathered
//    x rows and the w slice stream through a ring of 4 shared-memory
//    stages by 16-byte cp.async (TMA has no row gather on sm_90, so a row's
//    index is only the source address of its copies): slices k+1..k+3 are
//    in flight while slice k computes.  Ragged D and F are zero-filled by
//    the copies' source size; a D or F that is no multiple of 4 takes
//    4-byte copies.
//  - 4 warps, each a BM x 16 strip: per 8-deep step, (BM/16) x 2 DMMA with
//    the accumulators in registers.  Shared rows are padded so the fragment
//    loads hit 32 distinct banks.
//  - The splits of one output tile form a thread-block cluster.  Each block
//    leaves its float64 partial tile in its own shared memory; after a
//    cluster barrier, block r reads the r-th share of the tile from every
//    split through distributed shared memory (all splits' loads in flight
//    at once), sums them in split order and rounds once.  No atomics and
//    no workspace: the result is the same in every run, and the whole
//    product is one launch.
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BN = 64;          // output columns per block
constexpr int BK = 32;          // contraction slice per pipeline stage
constexpr int STAGES = 4;       // cp.async ring depth
constexpr int THREADS = 128;    // warp w owns output columns 16w .. 16w+15
constexpr int AS = BK + 4;      // x-tile row stride (floats): 4g + t banks
constexpr int BS = BN + 8;      // w-tile row stride (floats): 8t + g banks
constexpr int PS = BN + 8;      // partial-tile row stride (doubles)
constexpr int MAX_SPLITS = 8;   // the portable cluster size

__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// 16-byte (or 4-byte) asynchronous copy; bytes past src_bytes are zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// MT: m16 tiles per block (BM = 16 * MT).  The cluster (splits, 1, 1) holds
// the splits of one output tile; `per` is each split's count of K-slices.
template <int MT>
__global__ void __launch_bounds__(THREADS)
gmm_kernel(const float* __restrict__ x, const float* __restrict__ w,
           const int* __restrict__ perm, float* __restrict__ out, int L,
           int D, int F, int C, int per, int vec) {
  constexpr int BM = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);          // STAGES x BM x AS
  float* Bs = As + STAGES * BM * AS;                   // STAGES x BK x BS
  int* rows = reinterpret_cast<int*>(Bs + STAGES * BK * BS);   // BM

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / S) * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int s0 = split * per;
  const int ns = max(0, min((D + BK - 1) / BK, s0 + per) - s0);

  if (tid < BM) {
    const int c = m0 + tid;
    int r = -1;                                   // past C: zeros
    if (c < C) {
      r = perm[c];
      r = r < 0 ? 0 : (r >= L ? L - 1 : r);
    }
    rows[tid] = r;
  }
  __syncthreads();

  auto load = [&](int stage, int slice) {
    const int k0 = slice * BK;
    float* a = As + stage * BM * AS;
    float* b = Bs + stage * BK * BS;
    if (vec) {                                    // D % 4 == F % 4 == 0
      for (int i = tid; i < BM * (BK / 4); i += THREADS) {
        const int m = i / (BK / 4), k = k0 + (i % (BK / 4)) * 4;
        const int r = rows[m];
        const bool in = r >= 0 && k < D;
        cp_async16(a + m * AS + (k - k0), in ? x + (size_t)r * D + k : x,
                   in ? 16 : 0);
      }
      for (int i = tid; i < BK * (BN / 4); i += THREADS) {
        const int kk = i / (BN / 4), c = (i % (BN / 4)) * 4;
        const bool in = k0 + kk < D && n0 + c < F;
        cp_async16(b + kk * BS + c,
                   in ? w + (size_t)(k0 + kk) * F + n0 + c : w, in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int m = i / BK, k = k0 + i % BK;
        const int r = rows[m];
        const bool in = r >= 0 && k < D;
        cp_async4(a + m * AS + (k - k0), in ? x + (size_t)r * D + k : x,
                  in ? 4 : 0);
      }
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int kk = i / BN, c = i % BN;
        const bool in = k0 + kk < D && n0 + c < F;
        cp_async4(b + kk * BS + c,
                  in ? w + (size_t)(k0 + kk) * F + n0 + c : w, in ? 4 : 0);
      }
    }
  };

  double acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ns) load(s, s0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<STAGES - 2>();    // slice i has landed
    __syncthreads();                // ... for every thread; stage i-1 free
    const int next = i + STAGES - 1;
    if (next < ns) load(next % STAGES, s0 + next);
    cp_async_commit();
    const float* a = As + (i % STAGES) * BM * AS;
    const float* b = Bs + (i % STAGES) * BK * BS + warp * 16 + g;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      double bf[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        bf[nt][0] = (double)b[(kk + t) * BS + nt * 8];
        bf[nt][1] = (double)b[(kk + t + 4) * BS + nt * 8];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* ar = a + (mt * 16 + g) * AS + kk + t;
        const double af[4] = {(double)ar[0], (double)ar[8 * AS],
                              (double)ar[4], (double)ar[8 * AS + 4]};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) dmma(acc[mt][nt], af, bf[nt]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                  // every copy landed, every read done

  // this block's float64 partial tile, then the cluster's sum over the
  // splits (a cluster of one when there is one split)
  double* part = reinterpret_cast<double*>(smem);      // BM x PS
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<double2*>(
            part + (mt * 16 + g + 8 * h) * PS + warp * 16 + nt * 8 + 2 * t) =
            make_double2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  cluster.sync();
  // block `split` owns one share of the tile's column pairs
  const double2* peer[MAX_SPLITS];
#pragma unroll
  for (int r = 0; r < MAX_SPLITS; ++r)
    peer[r] = reinterpret_cast<const double2*>(
        cluster.map_shared_rank(part, r < S ? r : 0));
  constexpr int PAIRS = BM * BN / 2;
  const int share = (PAIRS + S - 1) / S;
  const int e1 = min(PAIRS, (split + 1) * share);
  for (int e = split * share + tid; e < e1; e += THREADS) {
    const int r = e / (BN / 2), c = (e % (BN / 2)) * 2;
    const int at = (r * PS + c) / 2;
    double2 v[MAX_SPLITS];
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q)
      if (q < S) v[q] = peer[q][at];
    double2 sum = v[0];
#pragma unroll
    for (int q = 1; q < MAX_SPLITS; ++q)
      if (q < S) {
        sum.x += v[q].x;
        sum.y += v[q].y;
      }
    const int row = m0 + r, col = n0 + c;
    if (row < C) {
      if (col < F) out[(size_t)row * F + col] = (float)sum.x;
      if (col + 1 < F) out[(size_t)row * F + col + 1] = (float)sum.y;
    }
  }
  cluster.sync();                   // peers read this block's partial tile
}

template <int MT>
int launch(const float* x, const float* w, const int* perm, float* out,
           int L, int D, int F, int C, int splits, cudaStream_t stream) {
  constexpr int BM = 16 * MT;
  const size_t smem = sizeof(float) * STAGES * (BM * AS + BK * BS) +
                      sizeof(int) * BM;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int slices = (D + BK - 1) / BK;
  const int per = (slices + splits - 1) / splits;
  const int vec = D % 4 == 0 && F % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((F + BN - 1) / BN) * splits, (C + BM - 1) / BM, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, gmm_kernel<MT>, x, w, perm,
                                           out, L, D, F, C, per, vec);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// x (L, D), w (D, F), perm (C,) int32 -> out (C, F); all float32,
// row-major and contiguous.  bm (16, 32 or 64) is the block's row tile and
// splits (1..8) the split-K factor, both chosen by the caller
// (gmm_tiling).  Launches on `stream`; returns the launch's cudaError_t (0
// on success).
extern "C" int gathered_matmul_f32(const float* x, const float* w,
                                   const int* perm, float* out, int L, int D,
                                   int F, int C, int bm, int splits,
                                   void* stream) {
  if (L <= 0 || D <= 0 || F <= 0 || C <= 0 || splits < 1 ||
      splits > MAX_SPLITS || (C + bm - 1) / bm > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bm) {
    case 16: return launch<1>(x, w, perm, out, L, D, F, C, splits, s);
    case 32: return launch<2>(x, w, perm, out, L, D, F, C, splits, s);
    case 64: return launch<4>(x, w, perm, out, L, D, F, C, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
