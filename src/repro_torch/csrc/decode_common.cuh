// Shared parts of the two one-token decode kernels (flash_decode.cu over a
// contiguous cache, paged_decode.cu over the page pool).
//
// Both split a (b, kv head) pair's live slots over the blocks of a
// thread-block cluster.  Inside a block (THREADS threads), a row group of R
// lanes holds one K / V row: lane li holds elements (vi * R + li) * VW + e
// for vi < NV, e < VW, those below Dh -- VW elements per 16-byte load (4
// float32 or 8 bf16), or VW = 1 for a scalar load when Dh is no multiple of
// VW or a tensor is misaligned.  The groups take slots in turn, U at once
// (4, or at E = VW * NV = 8 elements a lane 2, or 1 with a pass of 8 rows
// or with 8 scalar loads a lane: no spills),
// and keep the online-softmax state (m, l, acc) of up to GM query rows in
// registers, so those rows share every K / V load.  Elements are bf16 or
// float32 and are cast to float32 on load; all arithmetic is float32; the
// output is stored in the input's type (bf16 rounded to nearest even).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;
constexpr int MAX_SPLITS = 8;     // the portable cluster size
constexpr int GM = 8;             // query rows a pass holds (G > 8 loops)

using bf16 = uint16_t;            // bf16 bits; the C entries take dtype 1

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __uint_as_float((uint32_t)x << 16);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (bf16)0x7fc0;    // NaN
  return (bf16)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);       // to even
}

// VW elements at p into dst (one 16-byte load when VW > 1).
template <typename T, int VW>
__device__ __forceinline__ void load_vec(const T* p, float* dst) {
  if constexpr (VW == 1) {
    dst[0] = to_float(__ldg(p));
  } else {
    static_assert(VW * sizeof(T) == 16, "vector loads are 16 bytes");
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        dst[i] = __uint_as_float(w[i]);
      } else {                            // two bf16, the lower one first
        dst[2 * i] = __uint_as_float(w[i] << 16);
        dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

// This lane's elements of row `row` (zeros where `ok` is false or past Dh).
template <typename T, int VW, int NV>
__device__ __forceinline__ void load_row(const T* row, bool ok, int li, int R,
                                         int Dh, float* dst) {
#pragma unroll
  for (int vi = 0; vi < NV; ++vi) {
    const int d = (vi * R + li) * VW;
    if (ok && d < Dh) {
      load_vec<T, VW>(row + d, dst + vi * VW);
    } else {
#pragma unroll
      for (int e = 0; e < VW; ++e) dst[vi * VW + e] = 0.f;
    }
  }
}

// The pass's query rows g < gn (as float32) and a fresh state.
template <typename T, int VW, int NV, int GMI>
__device__ __forceinline__ void init_pass(const T* q, int gn, int li, int R,
                                          int Dh, float (&qr)[GMI][VW * NV],
                                          float (&acc)[GMI][VW * NV],
                                          float (&m)[GMI], float (&l)[GMI]) {
#pragma unroll
  for (int g = 0; g < GMI; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int vi = 0; vi < NV; ++vi)
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const int d = (vi * R + li) * VW + e;
        qr[g][vi * VW + e] = g < gn && d < Dh ? to_float(q[g * Dh + d]) : 0.f;
        acc[g][vi * VW + e] = 0.f;
      }
  }
}

// Fold U loaded slots (ok[u] false: masked) into the online softmax of the
// pass's rows.  Every lane of the block runs it (the dot products are
// shuffle reductions over the group's R lanes).
template <int GMI, int U, int E>
__device__ __forceinline__ void online_update(
    const float (&kr)[U][E], const float (&vr)[U][E], const bool (&ok)[U],
    const float (&qr)[GMI][E], float (&m)[GMI], float (&l)[GMI],
    float (&acc)[GMI][E], int gn, int R, float scale, float softcap) {
#pragma unroll
  for (int g = 0; g < GMI; ++g) {
    if (g >= gn) break;
    float sc[U];
    float mx = m[g];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot = fmaf(qr[g][e], kr[u][e], dot);
      for (int off = R >> 1; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      float s = dot * scale;
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      sc[u] = ok[u] ? s : -INFINITY;
      mx = fmaxf(mx, sc[u]);
    }
    if (mx == -INFINITY) continue;         // no live slot for this group yet
    const float c = expf(m[g] - mx);       // exp(-inf) = 0 on the first
    float lsum = l[g] * c;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] *= c;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float pu = expf(sc[u] - mx);    // dead: exp(-inf) = 0
      lsum += pu;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pu, vr[u][e], acc[g][e]);
    }
    l[g] = lsum;
    m[g] = mx;
  }
}

// Floats of shared memory merge_store needs.
__host__ __device__ inline int merge_floats(int NG, int GMI, int Dh) {
  return (NG * GMI + GMI) * (Dh + 2);
}

// End of a pass: the row groups' states merge in group order into the
// block's partial (shared memory); after a cluster barrier, block `split`
// merges its share of the gn x Dh outputs over all splits in split order,
// reading the other blocks' partials through distributed shared memory,
// divides by l (a row with nothing live gives zeros) and stores at `out`
// (the pass's first row).  A second barrier keeps the partials alive until
// every peer has read them.  One launch, no workspace, no atomics: the same
// bits in every run.
template <typename T, int VW, int NV, int GMI>
__device__ __forceinline__ void merge_store(
    float* smem, const float (&m)[GMI], const float (&l)[GMI],
    const float (&acc)[GMI][VW * NV], int gn, int Dh, int R, T* out,
    cg::cluster_group& cluster) {
  const int NG = THREADS / R;
  const int tid = threadIdx.x, rg = tid / R, li = tid % R;
  float* pm = smem;                        // NG x GMI
  float* pl = pm + NG * GMI;               // NG x GMI
  float* pa = pl + NG * GMI;               // NG x GMI x Dh
  float* bm = pa + NG * GMI * Dh;          // GMI: the block's partial
  float* bl = bm + GMI;                    // GMI
  float* ba = bl + GMI;                    // GMI x Dh
#pragma unroll
  for (int g = 0; g < GMI; ++g) {
    if (g >= gn) break;
    if (li == 0) {
      pm[rg * GMI + g] = m[g];
      pl[rg * GMI + g] = l[g];
    }
#pragma unroll
    for (int vi = 0; vi < NV; ++vi)
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const int d = (vi * R + li) * VW + e;
        if (d < Dh) pa[(rg * GMI + g) * Dh + d] = acc[g][vi * VW + e];
      }
  }
  __syncthreads();
  for (int i = tid; i < gn * Dh; i += THREADS) {
    const int g = i / Dh, d = i % Dh;
    float M = -INFINITY;
    for (int r = 0; r < NG; ++r) M = fmaxf(M, pm[r * GMI + g]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
      for (int r = 0; r < NG; ++r) {
        const float mr = pm[r * GMI + g];
        const float w = mr == -INFINITY ? 0.f : expf(mr - M);
        L = fmaf(pl[r * GMI + g], w, L);
        A = fmaf(pa[(r * GMI + g) * Dh + d], w, A);
      }
    }
    ba[i] = A;
    if (d == 0) {
      bm[g] = M;
      bl[g] = L;
    }
  }

  cluster.sync();
  const int nsplit = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  // each split's partial (bm, then bl = bm + GMI, then ba = bm + 2 GMI):
  // one mapped pointer a split
  const float* peer[MAX_SPLITS];
#pragma unroll
  for (int r = 0; r < MAX_SPLITS; ++r)
    peer[r] = cluster.map_shared_rank(bm, r < nsplit ? r : 0);
  const int total = gn * Dh;
  const int share = (total + nsplit - 1) / nsplit;
  const int e1 = min(total, (split + 1) * share);
  for (int i = split * share + tid; i < e1; i += THREADS) {
    const int g = i / Dh;
    float ms[MAX_SPLITS], ls[MAX_SPLITS], as[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < nsplit) {
        ms[r] = peer[r][g];
        ls[r] = peer[r][GMI + g];
        as[r] = peer[r][2 * GMI + i];
      }
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < nsplit) M = fmaxf(M, ms[r]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int r = 0; r < MAX_SPLITS; ++r)
        if (r < nsplit) {
          const float w = ms[r] == -INFINITY ? 0.f : expf(ms[r] - M);
          L = fmaf(ls[r], w, L);
          A = fmaf(as[r], w, A);
        }
    }
    out[i] = from_float<T>(L > 0.f ? A / L : 0.f);
  }
  cluster.sync();
}

inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Launch kern on `blocks` blocks in clusters of nsplit, with `smem` bytes
// of dynamic shared memory, on `stream`; returns the cudaError_t.
template <typename Kern, typename... Args>
int launch_cluster(Kern kern, int blocks, int nsplit, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The row layout for Dh elements of `esize` bytes: (VW, R, NV) with R
// lanes a row (a power of two, at most 32).  vec: 16-byte loads allowed
// (Dh a multiple of 16 / esize, pointers aligned).
struct Layout {
  int vw, r, nv;
};
inline Layout layout(int Dh, int esize, bool vec) {
  const int vw = vec ? 16 / esize : 1;
  const int units = Dh / vw;
  const int r = pow2_at_least(units) < 32 ? pow2_at_least(units) : 32;
  return {vw, r, (units + r - 1) / r};
}

}  // namespace decode
