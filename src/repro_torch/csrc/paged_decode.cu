// paged_flash_decode: one-token GQA attention over a block-pool KV cache,
// each row's written pages split across the blocks of a thread-block
// cluster.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_decode.py,
// function paged_flash_decode (kernel body _kernel): every decode tick of
// the paged serving engine, once per layer.
//
// Inputs (all contiguous; q / k_pages / v_pages / out of one type, float32
// or bf16):
//   q (B, KV, G, Dh); k_pages / v_pages (KV, N, ps, Dh); pos_pages (N, ps)
//   int32 original token ids; tables (B, P) int32 block tables; kv_len (B,)
//   int32 written slots; pos (B,) int32 the query's original position.
// Output (B, KV, G, Dh) in q's type.  Slot s of row b is attended iff s <
// kv_len[b] and, with a window, pos[b] - id < window, where id is the
// slot's original token id from pos_pages -- not its slot index, because
// SPLS page pruning compacts kept columns so slot != position.  Elements
// are cast to float32 on load, as the Pallas kernel casts its tiles;
// scores are scaled, softcapped and softmaxed in float32; a row with
// nothing live gives zeros.  Page ids outside [0, N) are clamped.  Any G
// (passes of at most decode::GM rows); Dh <= 256.
//
// What bounds it on an H100: the bytes of the live K/V slots (2 * live *
// KV * Dh * element size over all rows) plus q and out, over 3.35 TB/s:
// 0.0014562 ms at the paged engine's decode shape (B 4, KV 12, G 1, Dh 64,
// ps 16, P 32, 790 live slots, float32).  The operations are ~1 FLOP/byte.
// The first design (one block per (b, kv head): 48 blocks for 132 SMs, a
// serial walk over the block table staging each page through shared
// memory behind four barriers, 16 of 128 threads computing scores at G 1)
// took 52x that bound.
//
// Design, after flash_decode.cu (decode_common.cuh holds the shared parts):
//  - The written slots [0, n), n = min(kv_len[b], P * ps), of each (b, kv
//    head) pair are cut into nsplit contiguous shares of whole pages
//    (nsplit 1 to 8, chosen by paged_split_count in kernels/paged_decode.py
//    from the shapes alone; 8 at the engine's decode shape: 384 blocks).
//    Each share is one block of a thread-block cluster.  Table entries past
//    the written pages are never read, so the null page 0 that fills them
//    is never read live.
//  - A block first loads its share's table entries (a tile of up to
//    THREADS pages, one per thread, clamped into [0, N)) into shared
//    memory, so the page-id loads are off the critical path; with a window
//    it marks a page dead when none of its written slots is in the window
//    (the Pallas kernel's page skip), and dead pages are not read.
//  - Row groups of R lanes hold one K / V row (16-byte loads: 16 lanes of
//    a float4, or 8 lanes of 8 bf16, at Dh 64; scalar loads for a ragged or
//    misaligned row).  The groups take the share's slots in turn, U at
//    once, all their loads in flight together; dots are shuffle
//    reductions; each group keeps (m, l, acc) of the pass's query rows in
//    registers.  No barrier inside the slot loop.
//  - The groups merge in group order in shared memory; after a cluster
//    barrier, block r merges the r-th share of the outputs over all splits
//    in split order through distributed shared memory, divides by l and
//    stores.  One launch, no workspace, no atomics: the same bits in every
//    run.
#include "decode_common.cuh"

namespace {

namespace cg = cooperative_groups;
using decode::THREADS;

constexpr int TP = THREADS;      // table entries a tile holds

// A pass of 8 rows takes up to 255 registers (one block an SM will do).
// A single row is held to 128, four blocks an SM: with more registers a
// thread, the 8-block clusters of a split grid no longer all fit on the
// card at once, which measured markedly slower on the H100.
template <typename T, int VW, int NV, int GMI>
__global__ void __launch_bounds__(THREADS, GMI == 1 ? 4 : 1)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ pos_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ kv_len,
                    const int* __restrict__ pos, T* __restrict__ out, int KV,
                    int G, int Dh, int N, int ps, int P, int R, float scale,
                    float softcap, int window) {
  constexpr int E = VW * NV;               // elements of a row per lane
  // slots a group loads at once (one at E 8 with 8 rows or scalar loads:
  // no spills)
  constexpr int U = E >= 8 ? (GMI > 1 || VW == 1 ? 1 : 2) : 4;
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nsplit = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  const int bh = blockIdx.x / nsplit;      // b * KV + kv head
  const int b = bh / KV, h = bh % KV;
  const int tid = threadIdx.x;
  const int NG = THREADS / R;              // row groups of the block
  const int rg = tid / R, li = tid % R;
  int* tp = reinterpret_cast<int*>(smem + decode::merge_floats(NG, GMI, Dh));

  // this block's share: whole pages [pg0, pg1) of the written slots
  const int n = min(max(kv_len[b], 0), P * ps);
  const int npages = (n + ps - 1) / ps;
  const int chunk = (npages + nsplit - 1) / nsplit;
  const int pg0 = min(npages, split * chunk);
  const int pg1 = min(npages, pg0 + chunk);
  const int s1 = min(n, pg1 * ps);
  const int cur = pos[b];

  const size_t qoff = (size_t)bh * G * Dh;
  const T* kh = k_pages + (size_t)h * N * ps * Dh;
  const T* vh = v_pages + (size_t)h * N * ps * Dh;

  for (int g0 = 0; g0 < G; g0 += GMI) {
    const int gn = min(GMI, G - g0);
    float qr[GMI][E], acc[GMI][E], m[GMI], l[GMI];
    decode::init_pass<T, VW, NV, GMI>(q + qoff + (size_t)g0 * Dh, gn, li, R,
                                      Dh, qr, acc, m, l);
    for (int t0 = pg0; t0 < pg1; t0 += TP) {
      const int t1 = min(pg1, t0 + TP);
      __syncthreads();                     // the last tile's ids are read
      if (tid < t1 - t0) {
        int page = tables[(size_t)b * P + t0 + tid];
        page = page < 0 ? 0 : (page >= N ? N - 1 : page);
        if (window > 0) {                  // dead: no written slot in window
          const int first = (t0 + tid) * ps;
          const int cnt = min(ps, n - first);
          bool live = false;
          for (int s = 0; s < cnt; ++s)
            live |= cur - __ldg(pos_pages + (size_t)page * ps + s) < window;
          if (!live) page = -1;
        }
        tp[tid] = page;
      }
      __syncthreads();
      // every thread runs the same number of steps (the shuffles need
      // whole warps); a slot past the tile or on a dead page is masked
      const int ts0 = t0 * ps, ts1 = min(s1, t1 * ps);
      const int steps = (ts1 - ts0 + NG * U - 1) / (NG * U);
      for (int it = 0; it < steps; ++it) {
        const int jb = ts0 + it * NG * U + rg;
        float kr[U][E], vr[U][E];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = jb + u * NG;
          int page = -1, s = 0;
          if (j < ts1) {
            const int pi = j / ps;
            s = j - pi * ps;
            page = tp[pi - t0];
          }
          ok[u] = page >= 0 &&
                  (window <= 0 ||
                   cur - __ldg(pos_pages + (size_t)page * ps + s) < window);
          const size_t at =
              ok[u] ? ((size_t)page * ps + s) * (size_t)Dh : (size_t)0;
          decode::load_row<T, VW, NV>(kh + at, ok[u], li, R, Dh, kr[u]);
          decode::load_row<T, VW, NV>(vh + at, ok[u], li, R, Dh, vr[u]);
        }
        decode::online_update<GMI, U, E>(kr, vr, ok, qr, m, l, acc, gn, R,
                                         scale, softcap);
      }
    }
    decode::merge_store<T, VW, NV, GMI>(smem, m, l, acc, gn, Dh, R,
                                        out + qoff + (size_t)g0 * Dh,
                                        cluster);
  }
}

struct Args {
  const void *q, *k_pages, *v_pages;
  const int *pos_pages, *tables, *kv_len, *pos;
  void* out;
  int B, KV, G, Dh, N, ps, P;
  float scale, softcap;
  int window, nsplit;
  cudaStream_t stream;
};

template <typename T, int VW, int NV, int GMI>
int launch(const Args& a, int R) {
  const int NG = THREADS / R;
  const size_t smem = sizeof(float) * decode::merge_floats(NG, GMI, a.Dh) +
                      sizeof(int) * TP;
  return decode::launch_cluster(
      paged_decode_kernel<T, VW, NV, GMI>, a.B * a.KV * a.nsplit, a.nsplit,
      smem, a.stream, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k_pages), static_cast<const T*>(a.v_pages),
      a.pos_pages, a.tables, a.kv_len, a.pos, static_cast<T*>(a.out), a.KV,
      a.G, a.Dh, a.N, a.ps, a.P, R, a.scale, a.softcap, a.window);
}

template <typename T, int VW, int NV>
int by_rows(const Args& a, int R) {
  return a.G == 1 ? launch<T, VW, NV, 1>(a, R)
                  : launch<T, VW, NV, decode::GM>(a, R);
}

template <typename T>
int by_layout(const Args& a) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const uintptr_t any = reinterpret_cast<uintptr_t>(a.q) |
                        reinterpret_cast<uintptr_t>(a.k_pages) |
                        reinterpret_cast<uintptr_t>(a.v_pages) |
                        reinterpret_cast<uintptr_t>(a.out);
  const bool vec = a.Dh % VEC == 0 && (any & 15) == 0;
  const decode::Layout lay = decode::layout(a.Dh, (int)sizeof(T), vec);
  if (vec) {
    if (lay.nv == 1) return by_rows<T, VEC, 1>(a, lay.r);
    if constexpr (VEC == 4) return by_rows<T, VEC, 2>(a, lay.r);
    return (int)cudaErrorInvalidValue;
  }
  if (lay.nv == 1) return by_rows<T, 1, 1>(a, lay.r);
  if (lay.nv == 2) return by_rows<T, 1, 2>(a, lay.r);
  if (lay.nv <= 4) return by_rows<T, 1, 4>(a, lay.r);
  return by_rows<T, 1, 8>(a, lay.r);
}

}  // namespace

// See the header comment for the layout.  dtype 0: float32, 1: bf16 (q,
// the pages and out alike).  softcap <= 0 and window <= 0 mean "none";
// nsplit (1..8) is the cluster size; Dh <= 256.  Launches on `stream`;
// returns the launch's cudaError_t.
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const int* pos_pages,
                            const int* tables, const int* kv_len,
                            const int* pos, void* out, int dtype, int B,
                            int KV, int G, int Dh, int N, int ps, int P,
                            float scale, float softcap, int window,
                            int nsplit, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || Dh <= 0 || Dh > 256 || N <= 0 ||
      ps <= 0 || P <= 0 || dtype < 0 || dtype > 1 || nsplit < 1 ||
      nsplit > decode::MAX_SPLITS ||
      (long long)B * KV * nsplit > 0x7fffffffLL ||
      (long long)P * ps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Args a{q,  k_pages, v_pages, pos_pages, tables, kv_len,
               pos, out,    B,       KV,        G,      Dh,
               N,  ps,      P,       scale,     softcap, window,
               nsplit, (cudaStream_t)stream};
  return dtype == 1 ? by_layout<decode::bf16>(a) : by_layout<float>(a);
}
