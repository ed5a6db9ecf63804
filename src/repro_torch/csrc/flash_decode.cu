// flash_decode: one-token GQA attention over a contiguous KV cache, the
// cache axis split across the blocks of a thread-block cluster.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py,
// function flash_decode (kernel body _kernel): every decode tick of the
// dense fixed-slot serving engine, once per layer (model.decode_step ->
// attention_decode -> the cuda_flash_decode backend).
//
// Inputs (float32 unless noted, all contiguous):
//   q (B, KV, G, Dh) one token per row; k / v (B, KV, S, Dh) caches;
//   pos (B,) int32 the current write index (inclusive).
// Output (B, KV, G, Dh).  Slot j of row b is attended iff j <= pos[b] and,
// with a window, pos[b] - j < window.  Scores are scaled, softcapped and
// softmaxed in float32 (decode builds no SPLS plan, so float32 is safe);
// a row with no live slot gives zeros.
//
// What bounds it on an H100: the bytes of the live K/V slots (2 * live *
// KV * Dh * 4 over all rows) plus q and out, over 3.35 TB/s: 2.9 us at the
// dense engine's shape (B 4, KV 12, Dh 64, about 400 live slots a row).
// The operations are ~1 FLOP/byte.  So what limits it is keeping enough
// loads in flight on enough SMs: one block per (b, kv head) gives 48 blocks
// for 132 SMs there, and a serial walk over the cache inside each.
//
// Design:
//  - The live slots of row b, [max(0, pos[b] - window + 1), min(pos[b],
//    S - 1)], are cut into nsplit contiguous, near-equal shares (nsplit 1
//    to 8, chosen by decode_split_count in kernels/flash_decode.py from
//    B * KV, S and the window; 8 at the dense engine's shape: 384 blocks).
//    Each share is one block of a thread-block cluster per (b, kv head).
//    A block reads no slot outside its share, so no slot outside the live
//    range: the role of the Pallas kernel's block skips.
//  - Inside a block (4 warps), a row group of R lanes holds one K / V row:
//    at Dh 64, 16 lanes of one float4 each (16-byte loads; a Dh that is no
//    multiple of 4, or a misaligned tensor, takes 4-byte loads, one float
//    per lane).  The row groups take the share's slots in turn, each group
//    U slots at once (all their K and V loads in flight together); a dot
//    product is a shuffle reduction over the group's lanes, and each group
//    keeps its own online-softmax statistics (m, l) and output acc for all
//    G query rows of the kv head in registers, so the G rows share every
//    K / V load.  No thread waits on another inside the loop.
//  - The block's row groups merge in group order through shared memory;
//    after a cluster barrier, block r merges the r-th share of the G x Dh
//    outputs over all splits in split order, reading the other blocks'
//    partial (m, l, acc) through distributed shared memory, divides by l
//    and stores.  One launch, no workspace, no atomics: the same bits in
//    every run.
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int MAX_SPLITS = 8;   // the portable cluster size

// VW floats per load (4 or 1), NV loads per lane and row, GM the most query
// rows per kv head the instance holds (1 or 8).  R lanes (a power of two,
// at most 32) hold one row: lane li of a group holds elements
// (vi * R + li) * VW + e for vi < NV, e < VW, those below Dh.
template <int VW, int NV, int GM>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ pos,
                    float* __restrict__ out, int KV, int G, int S, int Dh,
                    int R, float scale, float softcap, int window) {
  constexpr int E = VW * NV;               // elements of a row per lane
  constexpr int U = E >= 8 ? 2 : 4;        // slots a group loads at once
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nsplit = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  const int bh = blockIdx.x / nsplit;      // b * KV + kv head
  const int b = bh / KV;
  const int tid = threadIdx.x;
  const int NG = THREADS / R;              // row groups of the block
  const int rg = tid / R, li = tid % R;

  // this block's share of row b's live slots
  const int p = pos[b];
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
  const int n = max(0, min(p, S - 1) - lo + 1);
  const int chunk = (n + nsplit - 1) / nsplit;
  const int s0 = lo + min(n, split * chunk);
  const int s1 = lo + min(n, (split + 1) * chunk);

  const size_t qoff = (size_t)bh * G * Dh;
  const float* kb = k + (size_t)bh * S * Dh;
  const float* vb = v + (size_t)bh * S * Dh;

  float qr[GM][E], acc[GM][E], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int vi = 0; vi < NV; ++vi)
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const int d = (vi * R + li) * VW + e;
        qr[g][vi * VW + e] = g < G && d < Dh ? q[qoff + g * Dh + d] : 0.f;
        acc[g][vi * VW + e] = 0.f;
      }
  }

  // every thread runs the same number of steps (the shuffles need whole
  // warps); a slot past the share is loaded as zeros and masked
  const int steps = (s1 - s0 + NG * U - 1) / (NG * U);
  for (int it = 0; it < steps; ++it) {
    const int jb = s0 + it * NG * U + rg;
    float kr[U][E], vr[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = jb + u * NG;
      const bool ok = j < s1;
#pragma unroll
      for (int vi = 0; vi < NV; ++vi) {
        const int d = (vi * R + li) * VW;
        const bool in = ok && d < Dh;
        if constexpr (VW == 4) {
          float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
          if (in) {
            const size_t at = (size_t)j * Dh + d;
            kk = __ldg(reinterpret_cast<const float4*>(kb + at));
            vv = __ldg(reinterpret_cast<const float4*>(vb + at));
          }
          kr[u][vi * VW + 0] = kk.x; kr[u][vi * VW + 1] = kk.y;
          kr[u][vi * VW + 2] = kk.z; kr[u][vi * VW + 3] = kk.w;
          vr[u][vi * VW + 0] = vv.x; vr[u][vi * VW + 1] = vv.y;
          vr[u][vi * VW + 2] = vv.z; vr[u][vi * VW + 3] = vv.w;
        } else {
          kr[u][vi] = in ? __ldg(kb + (size_t)j * Dh + d) : 0.f;
          vr[u][vi] = in ? __ldg(vb + (size_t)j * Dh + d) : 0.f;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
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
        sc[u] = jb + u * NG < s1 ? s : -INFINITY;
        mx = fmaxf(mx, sc[u]);
      }
      if (mx == -INFINITY) continue;       // no live slot for this group yet
      const float c = expf(m[g] - mx);     // exp(-inf) = 0 on the first
      float lsum = l[g] * c;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= c;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float pu = expf(sc[u] - mx);  // dead: exp(-inf) = 0
        lsum += pu;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] = fmaf(pu, vr[u][e], acc[g][e]);
      }
      l[g] = lsum;
      m[g] = mx;
    }
  }

  // the row groups' partials, merged in group order
  float* pm = smem;                        // NG x G
  float* pl = pm + NG * G;                 // NG x G
  float* pa = pl + NG * G;                 // NG x G x Dh
  float* bm = pa + NG * G * Dh;            // G: the block's partial
  float* bl = bm + G;                      // G
  float* ba = bl + G;                      // G x Dh
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
    if (li == 0) {
      pm[rg * G + g] = m[g];
      pl[rg * G + g] = l[g];
    }
#pragma unroll
    for (int vi = 0; vi < NV; ++vi)
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const int d = (vi * R + li) * VW + e;
        if (d < Dh) pa[(rg * G + g) * Dh + d] = acc[g][vi * VW + e];
      }
  }
  __syncthreads();
  for (int i = tid; i < G * Dh; i += THREADS) {
    const int g = i / Dh, d = i % Dh;
    float M = -INFINITY;
    for (int r = 0; r < NG; ++r) M = fmaxf(M, pm[r * G + g]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
      for (int r = 0; r < NG; ++r) {
        const float mr = pm[r * G + g];
        const float w = mr == -INFINITY ? 0.f : expf(mr - M);
        L = fmaf(pl[r * G + g], w, L);
        A = fmaf(pa[(r * G + g) * Dh + d], w, A);
      }
    }
    ba[i] = A;
    if (d == 0) {
      bm[g] = M;
      bl[g] = L;
    }
  }

  // the splits' partials, merged in split order: block `split` owns one
  // share of the G x Dh outputs
  cluster.sync();
  const float* rm[MAX_SPLITS];
  const float* rl[MAX_SPLITS];
  const float* ra[MAX_SPLITS];
#pragma unroll
  for (int r = 0; r < MAX_SPLITS; ++r) {
    const int rr = r < nsplit ? r : 0;
    rm[r] = cluster.map_shared_rank(bm, rr);
    rl[r] = cluster.map_shared_rank(bl, rr);
    ra[r] = cluster.map_shared_rank(ba, rr);
  }
  const int total = G * Dh;
  const int share = (total + nsplit - 1) / nsplit;
  const int e1 = min(total, (split + 1) * share);
  for (int i = split * share + tid; i < e1; i += THREADS) {
    const int g = i / Dh;
    float ms[MAX_SPLITS], ls[MAX_SPLITS], as[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < nsplit) {
        ms[r] = rm[r][g];
        ls[r] = rl[r][g];
        as[r] = ra[r][i];
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
    out[qoff + i] = L > 0.f ? A / L : 0.f;
  }
  cluster.sync();                  // peers have read this block's partial
}

template <int VW, int NV, int GM>
int launch(const float* q, const float* k, const float* v, const int* pos,
           float* out, int B, int KV, int G, int S, int Dh, int R,
           float scale, float softcap, int window, int nsplit,
           cudaStream_t stream) {
  // at most 41,280 bytes (Dh 256, G 8, 4 row groups): no opt-in needed
  const int NG = THREADS / R;
  const size_t smem = sizeof(float) * ((size_t)NG * G * (Dh + 2) +
                                       (size_t)G * (Dh + 2));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * KV * nsplit), 1, 1);
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
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, flash_decode_kernel<VW, NV, GM>, q, k, v, pos, out, KV, G, S,
      Dh, R, scale, softcap, window);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int VW, int NV>
int by_group(const float* q, const float* k, const float* v, const int* pos,
             float* out, int B, int KV, int G, int S, int Dh, int R,
             float scale, float softcap, int window, int nsplit,
             cudaStream_t s) {
  return G == 1 ? launch<VW, NV, 1>(q, k, v, pos, out, B, KV, G, S, Dh, R,
                                    scale, softcap, window, nsplit, s)
                : launch<VW, NV, 8>(q, k, v, pos, out, B, KV, G, S, Dh, R,
                                    scale, softcap, window, nsplit, s);
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

// See the header comment for the layout.  softcap <= 0 and window <= 0
// mean "none"; nsplit (1..8) is the cluster size, G <= 8, Dh <= 256.
// Launches on `stream`; returns the launch's cudaError_t.
extern "C" int flash_decode_f32(const float* q, const float* k,
                                const float* v, const int* pos, float* out,
                                int B, int KV, int G, int S, int Dh,
                                float scale, float softcap, int window,
                                int nsplit, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || G > 8 || S <= 0 || Dh <= 0 ||
      Dh > 256 || nsplit < 1 || nsplit > MAX_SPLITS ||
      (long long)B * KV * nsplit > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(out);
  if (Dh % 4 == 0 && (any & 15) == 0) {
    const int R = pow2_at_least(Dh / 4) < 32 ? pow2_at_least(Dh / 4) : 32;
    if (Dh / 4 <= R)
      return by_group<4, 1>(q, k, v, pos, out, B, KV, G, S, Dh, R, scale,
                            softcap, window, nsplit, s);
    return by_group<4, 2>(q, k, v, pos, out, B, KV, G, S, Dh, R, scale,
                          softcap, window, nsplit, s);
  }
  const int R = pow2_at_least(Dh) < 32 ? pow2_at_least(Dh) : 32;
  const int nv = (Dh + R - 1) / R;          // 1 .. 8
  if (nv == 1)
    return by_group<1, 1>(q, k, v, pos, out, B, KV, G, S, Dh, R, scale,
                          softcap, window, nsplit, s);
  if (nv == 2)
    return by_group<1, 2>(q, k, v, pos, out, B, KV, G, S, Dh, R, scale,
                          softcap, window, nsplit, s);
  if (nv <= 4)
    return by_group<1, 4>(q, k, v, pos, out, B, KV, G, S, Dh, R, scale,
                          softcap, window, nsplit, s);
  return by_group<1, 8>(q, k, v, pos, out, B, KV, G, S, Dh, R, scale,
                        softcap, window, nsplit, s);
}
