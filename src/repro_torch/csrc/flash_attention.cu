// flash_attention: block online-softmax attention with the SPLS block skips.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py,
// function flash_attention (kernel body _make_kernel): every attention
// layer of a whole-prompt prefill (model.prefill -> block_forward ->
// attention_forward -> the cuda_flash backend) and of models.forward.
//
// Inputs (float32 unless noted, all contiguous):
//   q (B, H, Lq, Dh); k / v (B, KV, Lk, Dh) with H = KV * G (head h reads
//   the K/V row of group h / G); kv_keep (B, H, Lk) uint8 or null (all
//   kept); q_pos (B, H, Lq) int32 or null (row i sits at position i).
// Output (B, H, Lq, Dh), 0 < Dh <= 128.  Row i attends column j iff j < Lk,
// kv_keep[j], causal: j <= q_pos[i], window: q_pos[i] - j < window and,
// without causal, j - q_pos[i] < window (a symmetric band).  Scores are
// scaled, softcapped (tanh(s / cap) * cap), softmaxed over the live
// columns; a row with no live column gives zeros.
//
// Block skips, exactly the Pallas predicates (flash_attention.py:91-108),
// on this kernel's own tiles (32 or 64 query rows x 64 key columns): with
// q_lo / q_hi the min / max of the tile's real q_pos, a K tile starting at
// k0 is live iff (causal) k0 <= q_hi, (window) k0 + 63 > q_lo - window and,
// without causal, k0 < q_hi + window, and (kv_keep) some real column of
// the tile is kept.  Each predicate only drops tiles with no live (row,
// column) pair, so skipping changes no result; the kv_keep skip is what
// turns SPLS column pruning into saved work.
//
// Numerics.  Q.K^T and P.V run on the FP64 tensor cores (DMMA: mma.sync
// m16n8k16 .f64, m16n8k8 at Dh 128) with float64 accumulators in registers;
// the running max, sum and correction are float64, and the output is rounded
// to float32 once.  Products of float32 values are exact in float64, so this
// kernel and its plain version (flash_attention_plain, a dense float64
// softmax) agree to the last float32 bit in practice, whatever their summation
// orders.  That matters here: the output is the residual the next layer's
// 8-bit SPLS predictor quantizes, and a last-bit difference can move a plan.
// wgmma has no float64 form, and TF32 / bf16 paths (3xTF32 with error-free
// splitting included) accumulate in float32, rounding every partial sum, so
// they cannot give that equality.  exp stays float64 (as the plain version
// computes it); a masked entry's score is -inf, so its weight is exp(-inf) = 0
// exactly.  exp runs on every entry of a live tile, dead ones included:
// branching around it per entry serialized a thread's entries, which cost more
// than the dead entries' exp.
//
// What bounds it on an H100: operations.  4 * Dh flops per (row, column)
// pair of every live tile, at the card's 67 TFLOP/s float64 peak, which
// DMMA reaches; beside them, one float64 exp per pair of a live tile on the
// CUDA cores' FP64 pipe (some twenty float64 operations each, at 34 TFLOP/s:
// about 12 us for the 10 M pairs of path (d)'s batch of 8), the float32 ->
// float64 conversion of every K / V fragment, and the masks.  The bytes (q,
// k, v, out, a few MB) take a microsecond at 3.35 TB/s.  On the card the
// DMMA products are the smaller share of the time: the fragments' shared
// loads and conversions, the softmax and each block's fixed costs (Q
// staging, tile list, merge) take the rest (PERF.md).
//
// Design, FlashAttention-2 style:
//  - A block owns 32 q rows of one (b * H + h); the TPU's sequential K grid
//    axis becomes a loop inside the block.  Each warp owns 16 rows (row
//    group w % 2) and one of KQ column slices of every 64-column K tile,
//    with an online-softmax state of its own (a split of the keys inside
//    the block); the KQ states of each row merge once, through shared
//    memory, in slice order, at the end.  KQ = 2 (4 warps, two blocks per
//    SM) up to Dh 64: 144 blocks at the serving shape (B 1, H 12, L 384),
//    where 64-row tiles gave 72 for 132 SMs; at Dh 128 the O fragment alone
//    takes 128 registers, so KQ = 4 (8 warps) keeps the S fragment small.
//  - Q is converted to float64 once into shared memory (rows padded so the
//    fragment loads hit distinct banks; Dh zero-padded to 16, 32, 64 or
//    128, the template's width).  The S tile (16 rows x the warp's slice)
//    and the O accumulator (16 x Dh) stay in registers for the whole loop.
//  - P goes from the accumulator layout straight into the A operand of
//    P.V: the contraction index of each 8-column n-tile is permuted (k = t
//    takes column 2t, k = t + 4 column 2t + 1) and V's rows are read in the
//    same permuted order, so no shuffle moves P.
//  - The live K tiles are listed up front (a block-uniform pass over the
//    skip predicates); their K/V rows stream through two shared-memory
//    stages by 16-byte cp.async, tile i + 1 copying while tile i computes.
//    A warp whose slice of a tile has no kept column skips it.
//  - Padded q rows of a ragged last tile repeat the last real position and
//    are never written; padded K columns are dead.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;          // q rows per block: 2 row groups of 16
constexpr int BKT = 64;         // K tile (the skip predicates' unit)
constexpr int CHUNK = 256;      // K tiles listed per pass
constexpr double NEG = -1e30;   // running-max start: finite, below any score

__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[8],
                                     const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ double quad_max(double x) {
  x = fmax(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmax(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ double quad_sum(double x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DHP>
constexpr size_t smem_bytes() {
  return sizeof(double) * BQ * (DHP + 4) +           // Q, float64
         sizeof(float) * 2 * 2 * BKT * (DHP + 4) +   // 2 stages of K, V
         sizeof(int) * (BQ + CHUNK + 1) + CHUNK;     // q_pos, tile list
}

// DHP: Dh zero-padded to 16, 32, 64 or 128; 2 row groups of 16 q rows x KQ
// column slices of each K tile, one warp each.
template <int DHP, int KQ>
__global__ void __launch_bounds__(64 * KQ, KQ <= 2 ? 2 : 1)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const unsigned char* __restrict__ keep,
                       const int* __restrict__ q_pos,
                       float* __restrict__ out, int Lq, int Lk, int Dh,
                       int G, double scale, int causal, int window,
                       double softcap, int vec) {
  constexpr int WARPS = 2 * KQ;
  constexpr int THREADS = 32 * WARPS;
  constexpr int CW = BKT / KQ;    // columns per warp per tile
  constexpr int NJ = CW / 8;      // 8-column n-tiles per warp
  constexpr int RS = DHP + 4;     // row stride of Q (doubles), K, V (floats)
  constexpr int NT = DHP / 8;     // 8-wide steps over Dh
  // DMMA depth: m16n8k16; m16n8k8 at Dh 128, whose smaller fragments keep
  // the 128-register O accumulator from spilling
  constexpr int KS = DHP == 128 ? 8 : 16;
  constexpr int XS = DHP + 8;     // merge row stride (doubles): 16-byte
                                  // stores of a quarter warp hit 32 banks
  static_assert(NJ % (KS / 8) == 0, "P.V steps over whole n-tiles");
  static_assert(sizeof(double) * ((2 * KQ - 1) * BQ + (KQ - 1) * BQ * XS) <=
                    sizeof(float) * 2 * 2 * BKT * RS,
                "the merge buffer reuses the K/V stages");
  extern __shared__ __align__(16) unsigned char smem[];
  double* qs = reinterpret_cast<double*>(smem);              // BQ x RS
  float* kvs = reinterpret_cast<float*>(qs + BQ * RS);       // [2][2][BKT][RS]
  int* qp = reinterpret_cast<int*>(kvs + 2 * 2 * BKT * RS);  // BQ
  int* list = qp + BQ;                                       // CHUNK
  int* n_list = list + CHUNK;                                // 1
  unsigned char* live_t = reinterpret_cast<unsigned char*>(n_list + 1);

  const int bh = blockIdx.y;                     // b * H + h
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, Lq - q0);               // real rows of this tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 1, kq = warp >> 1;      // row group, column slice
  const size_t qoff = ((size_t)bh * Lq + q0) * Dh;
  const size_t kvoff = (size_t)(bh / G) * Lk * Dh;
  const unsigned char* keep_row = keep ? keep + (size_t)bh * Lk : nullptr;

  // Q -> float64 (zero rows past nq, zero columns past Dh); K/V stages
  // zeroed once where Dh or Lk is ragged, so the Dh padding stays zero and
  // rows past Lk stay finite
  if (vec) {                                     // Dh % 4 == 0, aligned
    for (int i = tid; i < BQ * (DHP / 4); i += THREADS) {
      const int r = i / (DHP / 4), d = (i % (DHP / 4)) * 4;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nq && d < Dh)
        f = *reinterpret_cast<const float4*>(q + qoff + (size_t)r * Dh + d);
      double* dst = qs + r * RS + d;
      dst[0] = f.x;
      dst[1] = f.y;
      dst[2] = f.z;
      dst[3] = f.w;
    }
  } else {
    for (int i = tid; i < BQ * DHP; i += THREADS) {
      const int r = i / DHP, d = i % DHP;
      qs[r * RS + d] =
          (r < nq && d < Dh) ? (double)q[qoff + (size_t)r * Dh + d] : 0.0;
    }
  }
  if (Dh < DHP || Lk % BKT)        // else every value read is copied first
    for (int i = tid; i < 2 * 2 * BKT * RS / 4; i += THREADS)
      reinterpret_cast<float4*>(kvs)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = tid; r < BQ; r += THREADS) {
    const int pr = r < nq ? r : nq - 1;          // pad rows: last real pos
    qp[r] = q_pos ? q_pos[(size_t)bh * Lq + q0 + pr] : q0 + pr;
  }
  __syncthreads();
  int q_lo = qp[0], q_hi = qp[0];
  for (int r = 1; r < nq; ++r) {
    q_lo = min(q_lo, qp[r]);
    q_hi = max(q_hi, qp[r]);
  }
  const int pos0 = qp[rg * 16 + g], pos1 = qp[rg * 16 + g + 8];

  // this warp's online-softmax state: rows g and g + 8 of its 16
  double o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0;
  double m0 = NEG, m1 = NEG, l0 = 0.0, l1 = 0.0;

  // the K and V rows of one tile into stage st (two stages: tile i + 1
  // copies while tile i computes)
  auto stage_k = [&](int st) { return kvs + st * 2 * BKT * RS; };
  auto fetch = [&](int st, int tile) {
    const int k0 = tile * BKT, nk = min(BKT, Lk - k0);
    float* ks = stage_k(st);
    float* vs = ks + BKT * RS;
    const float* kg = k + kvoff + (size_t)k0 * Dh;
    const float* vg = v + kvoff + (size_t)k0 * Dh;
    if (vec) {
      for (int i = tid; i < BKT * (DHP / 4); i += THREADS) {
        const int j = i / (DHP / 4), d = (i % (DHP / 4)) * 4;
        if (j < nk && d < Dh) {
          cp_async16(ks + j * RS + d, kg + (size_t)j * Dh + d);
          cp_async16(vs + j * RS + d, vg + (size_t)j * Dh + d);
        }
      }
    } else {
      for (int i = tid; i < BKT * DHP; i += THREADS) {
        const int j = i / DHP, d = i % DHP;
        if (j < nk && d < Dh) {
          cp_async4(ks + j * RS + d, kg + (size_t)j * Dh + d);
          cp_async4(vs + j * RS + d, vg + (size_t)j * Dh + d);
        }
      }
    }
    cp_async_commit();
  };

  // kept columns of this thread in the warp's slice of a tile: n-tile j,
  // column 2t + e -> bit 2j + e
  auto kept_bits = [&](int cb) {
    unsigned kept = 0;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = cb + j * 8 + 2 * t + e;
        if (col < Lk && (!keep_row || keep_row[col]))
          kept |= 1u << (2 * j + e);
      }
    return kept;
  };

  // S = Q K^T for the warp's 16 rows x CW columns
  const double* qa = qs + (rg * 16 + g) * RS + t;
  auto qk = [&](const float* ks, double (&sc)[NJ][4]) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0;
#pragma unroll
    for (int kk = 0; kk < DHP; kk += KS) {
      // A: row g (+8), column t + 4i; B: K row g, column t + 4i
      double a[KS / 2], b[KS / 4];
#pragma unroll
      for (int i = 0; i < KS / 2; ++i)
        a[i] = qa[(i & 1) * 8 * RS + kk + 4 * (i >> 1)];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* kb = ks + (j * 8 + g) * RS + kk + t;
#pragma unroll
        for (int i = 0; i < KS / 4; ++i) b[i] = (double)kb[4 * i];
        dmma(sc[j], a, b);
      }
    }
  };

  // the online softmax of one S tile, then O += P V
  auto softmax_pv = [&](double (&sc)[NJ][4], unsigned kept, int cb,
                        const float* vs) {
    // masks, scale, softcap; a dead entry becomes -inf.  Branch-free, so
    // the entries' float64 work (and below their exp) interleaves: a
    // branch per entry ran them one after another
    double mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cb + j * 8 + 2 * t + (e & 1);
        const int qi = e < 2 ? pos0 : pos1;
        bool live = (kept >> (2 * j + (e & 1))) & 1;
        if (causal) live = live && col <= qi;
        if (window > 0) {
          live = live && qi - col < window;
          if (!causal) live = live && col - qi < window;
        }
        double xv = sc[j][e] * scale;
        if (softcap > 0.0) xv = tanh(xv / softcap) * softcap;
        xv = live ? xv : -INFINITY;
        sc[j][e] = xv;
        if (e < 2) mx0 = fmax(mx0, xv); else mx1 = fmax(mx1, xv);
      }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const double mn0 = fmax(m0, mx0), mn1 = fmax(m1, mx1);  // finite
    const double c0r = mn0 == m0 ? 1.0 : exp(m0 - mn0);
    const double c1r = mn1 == m1 ? 1.0 : exp(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    double sum0 = 0.0, sum1 = 0.0;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const double p = exp(sc[j][e] - (e < 2 ? mn0 : mn1));  // dead: 0
        sc[j][e] = p;
        if (e < 2) sum0 += p; else sum1 += p;
      }
    l0 = l0 * c0r + sum0;
    l1 = l1 * c1r + sum1;
#pragma unroll
    for (int n2 = 0; n2 < NT; ++n2) {
      o[n2][0] *= c0r;
      o[n2][1] *= c0r;
      o[n2][2] *= c1r;
      o[n2][3] *= c1r;
    }
    // O += P V, KS / 8 n-tiles of P per step as the contraction: in n-tile
    // j + h, k = t + 8h takes column 2t and k = t + 8h + 4 column 2t + 1
#pragma unroll
    for (int j = 0; j < NJ; j += KS / 8) {
      double a[KS / 2], b[KS / 4];
#pragma unroll
      for (int h = 0; h < KS / 8; ++h) {
        a[4 * h] = sc[j + h][0];
        a[4 * h + 1] = sc[j + h][2];
        a[4 * h + 2] = sc[j + h][1];
        a[4 * h + 3] = sc[j + h][3];
      }
      const float* vb = vs + (j * 8 + 2 * t) * RS + g;
#pragma unroll
      for (int n2 = 0; n2 < NT; ++n2) {
#pragma unroll
        for (int i = 0; i < KS / 4; ++i)
          b[i] = (double)vb[((i >> 1) * 8 + (i & 1)) * RS + n2 * 8];
        dmma(o[n2], a, b);
      }
    }
  };

  const int n_tiles_all = (Lk + BKT - 1) / BKT;
  const int n_tiles = causal ? min(n_tiles_all, q_hi / BKT + 1) : n_tiles_all;
  for (int c0 = 0; c0 < n_tiles; c0 += CHUNK) {
    // list this pass's live tiles: one warp per tile, block-uniform result
    const int nc = min(CHUNK, n_tiles - c0);
    for (int i = warp; i < nc; i += WARPS) {
      const int k0 = (c0 + i) * BKT;
      bool live = !(causal && k0 > q_hi);
      if (window > 0) {
        live = live && k0 + BKT - 1 > q_lo - window;
        if (!causal) live = live && k0 < q_hi + window;
      }
      if (live) {
        const int j0 = k0 + lane, j1 = k0 + lane + 32;
        const bool any = (j0 < Lk && (!keep_row || keep_row[j0])) ||
                         (j1 < Lk && (!keep_row || keep_row[j1]));
        live = __any_sync(0xffffffffu, any);
      }
      if (lane == 0) live_t[i] = live;
    }
    __syncthreads();
    if (warp == 0) {                             // compact, in tile order
      int n = 0;
      for (int b0 = 0; b0 < nc; b0 += 32) {
        const bool f = b0 + lane < nc && live_t[b0 + lane];
        const unsigned bits = __ballot_sync(0xffffffffu, f);
        if (f) list[n + __popc(bits & ((1u << lane) - 1))] = c0 + b0 + lane;
        n += __popc(bits);
      }
      if (lane == 0) *n_list = n;
    }
    __syncthreads();
    const int n = *n_list;
    if (n > 0) fetch(0, list[0]);
    for (int it = 0; it < n; ++it) {
      if (it + 1 < n) {
        fetch((it + 1) & 1, list[it + 1]);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();                           // tile `it` is in shared
      const int cb = list[it] * BKT + kq * CW;   // this warp's first column
      const unsigned kept = kept_bits(cb);
      if (__any_sync(0xffffffffu, kept != 0)) {
        const float* ks = stage_k(it & 1) + kq * CW * RS;
        double sc[NJ][4];
        qk(ks, sc);
        softmax_pv(sc, kept, cb, ks + BKT * RS);
      }
      __syncthreads();                           // stage free for it + 2
    }
  }

  // merge the KQ column slices of each row, in slice order, through the
  // (now free) K/V stages: every slice scales its state to the row's
  // common max, slices 1 .. KQ - 1 hand theirs to slice 0, which sums
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  double* xm = reinterpret_cast<double*>(kvs);   // [KQ][BQ] m
  double* xl = xm + KQ * BQ;                     // [KQ - 1][BQ] scaled l
  double* xo = xl + (KQ - 1) * BQ;               // [KQ - 1][BQ][XS] scaled O
  const int r0 = rg * 16 + g, r1 = r0 + 8;
  if (t == 0) {
    xm[kq * BQ + r0] = m0;
    xm[kq * BQ + r1] = m1;
  }
  __syncthreads();
  double mm0 = xm[r0], mm1 = xm[r1];
#pragma unroll
  for (int s2 = 1; s2 < KQ; ++s2) {
    mm0 = fmax(mm0, xm[s2 * BQ + r0]);
    mm1 = fmax(mm1, xm[s2 * BQ + r1]);
  }
  const double a0 = m0 == mm0 ? 1.0 : exp(m0 - mm0);
  const double a1 = m1 == mm1 ? 1.0 : exp(m1 - mm1);
  if (kq > 0) {
    double* mo = xo + (kq - 1) * BQ * XS;
#pragma unroll
    for (int n2 = 0; n2 < NT; ++n2) {
      *reinterpret_cast<double2*>(mo + r0 * XS + n2 * 8 + 2 * t) =
          make_double2(o[n2][0] * a0, o[n2][1] * a0);
      *reinterpret_cast<double2*>(mo + r1 * XS + n2 * 8 + 2 * t) =
          make_double2(o[n2][2] * a1, o[n2][3] * a1);
    }
    if (t == 0) {
      xl[(kq - 1) * BQ + r0] = l0 * a0;
      xl[(kq - 1) * BQ + r1] = l1 * a1;
    }
  }
  __syncthreads();
  if (kq > 0) return;
  double lt0 = l0 * a0, lt1 = l1 * a1;
#pragma unroll
  for (int s2 = 1; s2 < KQ; ++s2) {
    lt0 += xl[(s2 - 1) * BQ + r0];
    lt1 += xl[(s2 - 1) * BQ + r1];
  }
  const double inv0 = 1.0 / (lt0 > 0.0 ? lt0 : 1.0);
  const double inv1 = 1.0 / (lt1 > 0.0 ? lt1 : 1.0);
#pragma unroll
  for (int n2 = 0; n2 < NT; ++n2)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? r1 : r0;
      const int d = n2 * 8 + 2 * t;
      const double a = h ? a1 : a0;
      double ox = o[n2][2 * h] * a, oy = o[n2][2 * h + 1] * a;
#pragma unroll
      for (int s2 = 1; s2 < KQ; ++s2) {
        const double2 x = *reinterpret_cast<const double2*>(
            xo + ((s2 - 1) * BQ + r) * XS + d);
        ox += x.x;
        oy += x.y;
      }
      const double inv = h ? inv1 : inv0;
      float* dst = out + qoff + (size_t)r * Dh + d;
      if (r < nq && d < Dh) {
        if (Dh % 2 == 0) {
          *reinterpret_cast<float2*>(dst) =
              make_float2((float)(ox * inv), (float)(oy * inv));
        } else {
          dst[0] = (float)(ox * inv);
          if (d + 1 < Dh) dst[1] = (float)(oy * inv);
        }
      }
    }
}

// 2 column slices (4 warps, two blocks per SM) up to Dh 64; at Dh 128 the
// O fragment alone takes 128 registers, so 4 slices of 16 columns (8
// warps) keep S small
template <int DHP>
int launch(const float* q, const float* k, const float* v,
           const unsigned char* keep, const int* q_pos, float* out, int B,
           int H, int KV, int Lq, int Lk, int Dh, double scale, int causal,
           int window, double softcap, cudaStream_t stream) {
  constexpr int KQ = DHP <= 64 ? 2 : 4;
  constexpr size_t smem = smem_bytes<DHP>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<DHP, KQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int vec = Dh % 4 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(k) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  flash_attention_kernel<DHP, KQ><<<grid, 64 * KQ, smem, stream>>>(
      q, k, v, keep, q_pos, out, Lq, Lk, Dh, H / KV, scale, causal, window,
      softcap, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// See the header comment for the layout.  keep / q_pos may be null;
// softcap <= 0 and window <= 0 mean "none".  Launches on `stream`; returns
// the launch's cudaError_t.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, const unsigned char* keep,
                                   const int* q_pos, float* out, int B, int H,
                                   int KV, int Lq, int Lk, int Dh,
                                   double scale, int causal, int window,
                                   double softcap, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || Lq <= 0 || Lk <= 0 ||
      Dh <= 0 || Dh > 128 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (Dh <= 16)
    return launch<16>(q, k, v, keep, q_pos, out, B, H, KV, Lq, Lk, Dh,
                      scale, causal, window, softcap, s);
  if (Dh <= 32)
    return launch<32>(q, k, v, keep, q_pos, out, B, H, KV, Lq, Lk, Dh,
                      scale, causal, window, softcap, s);
  if (Dh <= 64)
    return launch<64>(q, k, v, keep, q_pos, out, B, H, KV, Lq, Lk, Dh,
                      scale, causal, window, softcap, s);
  return launch<128>(q, k, v, keep, q_pos, out, B, H, KV, Lq, Lk, Dh, scale,
                     causal, window, softcap, s);
}
