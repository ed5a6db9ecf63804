// flash_decode: one-token GQA attention over a contiguous KV cache, the
// cache axis split across the blocks of a thread-block cluster.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py,
// function flash_decode (kernel body _kernel): every decode tick of the
// dense fixed-slot serving engine, once per layer (model.decode_step ->
// attention_decode -> the cuda_flash_decode backend).
//
// Inputs (all contiguous, q / k / v / out of one type, float32 or bf16):
//   q (B, KV, G, Dh) one token per row; k / v (B, KV, S, Dh) caches;
//   pos (B,) int32 the current write index (inclusive).
// Output (B, KV, G, Dh) in q's type.  Slot j of row b is attended iff j <=
// pos[b] and, with a window, pos[b] - j < window.  Elements are cast to
// float32 on load, as the Pallas kernel casts its tiles; scores are
// scaled, softcapped and softmaxed in float32; a row with no live slot
// gives zeros.  Any G: the rows of a kv head go through in passes of at
// most decode::GM (8), each pass walking the block's share again (the
// second walk reads from L2).  Dh <= 256.
//
// What bounds it on an H100: the bytes of the live K/V slots (2 * live *
// KV * Dh * element size over all rows) plus q and out, over 3.35 TB/s:
// 2.9 us at the dense engine's shape (B 4, KV 12, Dh 64, about 400 live
// slots a row, float32).  The operations are ~1 FLOP/byte.  So what limits
// it is keeping enough loads in flight on enough SMs: one block per (b, kv
// head) gives 48 blocks for 132 SMs there, and a serial walk over the cache
// inside each.
//
// Design (decode_common.cuh holds the parts shared with paged_decode.cu):
//  - The live slots of row b, [max(0, pos[b] - window + 1), min(pos[b],
//    S - 1)], are cut into nsplit contiguous, near-equal shares (nsplit 1
//    to 8, chosen by decode_split_count in kernels/flash_decode.py from
//    B * KV, S and the window; 8 at the dense engine's shape: 384 blocks).
//    Each share is one block of a thread-block cluster per (b, kv head).
//    A block reads no slot outside its share, so no slot outside the live
//    range: the role of the Pallas kernel's block skips.
//  - Inside a block (4 warps), a row group of R lanes holds one K / V row:
//    at Dh 64, 16 lanes of one float4 each, or 8 lanes of 8 bf16 (16-byte
//    loads; a Dh that is no multiple of the vector, or a misaligned tensor,
//    takes scalar loads).  The row groups take the share's slots in turn,
//    each group U slots at once (all their K and V loads in flight
//    together); a dot product is a shuffle reduction over the group's
//    lanes, and each group keeps its own online-softmax statistics (m, l)
//    and output acc for the pass's query rows in registers, so those rows
//    share every K / V load.  No thread waits on another inside the loop.
//  - The block's row groups merge in group order through shared memory;
//    after a cluster barrier, block r merges the r-th share of the pass's
//    outputs over all splits in split order, reading the other blocks'
//    partial (m, l, acc) through distributed shared memory, divides by l
//    and stores.  One launch, no workspace, no atomics: the same bits in
//    every run.
#include "decode_common.cuh"

namespace {

namespace cg = cooperative_groups;
using decode::THREADS;

// T the element type, VW elements per load, NV loads per lane and row,
// GMI the most query rows a pass holds (1 or decode::GM).
// A pass of 8 rows takes up to 255 registers (one block an SM will do).
// A single row is held to 128, four blocks an SM: with more registers a
// thread, the 8-block clusters of a split grid no longer all fit on the
// card at once, which measured markedly slower on the H100.
template <typename T, int VW, int NV, int GMI>
__global__ void __launch_bounds__(THREADS, GMI == 1 ? 4 : 1)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    T* __restrict__ out, int KV, int G, int S, int Dh, int R,
                    float scale, float softcap, int window) {
  constexpr int E = VW * NV;               // elements of a row per lane
  // slots a group loads at once (one at E 8 with 8 rows or scalar loads:
  // no spills)
  constexpr int U = E >= 8 ? (GMI > 1 || VW == 1 ? 1 : 2) : 4;
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
  const T* kb = k + (size_t)bh * S * Dh;
  const T* vb = v + (size_t)bh * S * Dh;
  // every thread runs the same number of steps (the shuffles need whole
  // warps); a slot past the share is loaded as zeros and masked
  const int steps = (s1 - s0 + NG * U - 1) / (NG * U);

  for (int g0 = 0; g0 < G; g0 += GMI) {
    const int gn = min(GMI, G - g0);
    float qr[GMI][E], acc[GMI][E], m[GMI], l[GMI];
    decode::init_pass<T, VW, NV, GMI>(q + qoff + (size_t)g0 * Dh, gn, li, R,
                                      Dh, qr, acc, m, l);
    for (int it = 0; it < steps; ++it) {
      const int jb = s0 + it * NG * U + rg;
      float kr[U][E], vr[U][E];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = jb + u * NG;
        ok[u] = j < s1;
        const size_t at = (size_t)(ok[u] ? j : 0) * Dh;
        decode::load_row<T, VW, NV>(kb + at, ok[u], li, R, Dh, kr[u]);
        decode::load_row<T, VW, NV>(vb + at, ok[u], li, R, Dh, vr[u]);
      }
      decode::online_update<GMI, U, E>(kr, vr, ok, qr, m, l, acc, gn, R,
                                       scale, softcap);
    }
    decode::merge_store<T, VW, NV, GMI>(smem, m, l, acc, gn, Dh, R,
                                        out + qoff + (size_t)g0 * Dh,
                                        cluster);
  }
}

template <typename T, int VW, int NV>
int by_rows(const void* q, const void* k, const void* v, const int* pos,
            void* out, int B, int KV, int G, int S, int Dh, int R,
            float scale, float softcap, int window, int nsplit,
            cudaStream_t s) {
  const int NG = THREADS / R;
  const int blocks = B * KV * nsplit;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (G == 1)
    return decode::launch_cluster(
        flash_decode_kernel<T, VW, NV, 1>, blocks, nsplit,
        sizeof(float) * decode::merge_floats(NG, 1, Dh), s, qt, kt, vt, pos,
        ot, KV, G, S, Dh, R, scale, softcap, window);
  return decode::launch_cluster(
      flash_decode_kernel<T, VW, NV, decode::GM>, blocks, nsplit,
      sizeof(float) * decode::merge_floats(NG, decode::GM, Dh), s, qt, kt, vt,
      pos, ot, KV, G, S, Dh, R, scale, softcap, window);
}

template <typename T>
int by_layout(const void* q, const void* k, const void* v, const int* pos,
              void* out, int B, int KV, int G, int S, int Dh, float scale,
              float softcap, int window, int nsplit, cudaStream_t s) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(out);
  const bool vec = Dh % VEC == 0 && (any & 15) == 0;
  const decode::Layout lay = decode::layout(Dh, (int)sizeof(T), vec);
#define FD_ARGS q, k, v, pos, out, B, KV, G, S, Dh, lay.r, scale, softcap, \
                window, nsplit, s
  if (vec) {
    if (lay.nv == 1) return by_rows<T, VEC, 1>(FD_ARGS);
    if constexpr (VEC == 4) return by_rows<T, VEC, 2>(FD_ARGS);
    return (int)cudaErrorInvalidValue;
  }
  if (lay.nv == 1) return by_rows<T, 1, 1>(FD_ARGS);
  if (lay.nv == 2) return by_rows<T, 1, 2>(FD_ARGS);
  if (lay.nv <= 4) return by_rows<T, 1, 4>(FD_ARGS);
  return by_rows<T, 1, 8>(FD_ARGS);
#undef FD_ARGS
}

}  // namespace

// See the header comment for the layout.  dtype 0: float32, 1: bf16 (q,
// k, v and out alike).  softcap <= 0 and window <= 0 mean "none"; nsplit
// (1..8) is the cluster size; Dh <= 256.  Launches on `stream`; returns the
// launch's cudaError_t.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const int* pos, void* out, int dtype, int B,
                            int KV, int G, int S, int Dh, float scale,
                            float softcap, int window, int nsplit,
                            void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || S <= 0 || Dh <= 0 || Dh > 256 ||
      nsplit < 1 || nsplit > decode::MAX_SPLITS || dtype < 0 || dtype > 1 ||
      (long long)B * KV * nsplit > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return by_layout<decode::bf16>(q, k, v, pos, out, B, KV, G, S, Dh, scale,
                                   softcap, window, nsplit, s);
  return by_layout<float>(q, k, v, pos, out, B, KV, G, S, Dh, scale, softcap,
                          window, nsplit, s);
}
