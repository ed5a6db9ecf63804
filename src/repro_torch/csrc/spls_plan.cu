// spls_plan_block: the per-head plan block of a progressive SPLS plan step
// (core/spls_chunked.plan_chunk) in one launch; spls_mfi: its MFI vote.
//
// Replaces no TPU kernel: the reference computes this block with XLA ops
// (src/repro/core/spls_chunked.py: _block_pam_mask, bisect_topk_mask,
// core/similarity.local_similarity; core/mfi.mfi_ffn_sparsity).  On the card
// the same chain was ~290 small PyTorch ops a layer, whose enqueueing held a
// serving chunk step, so it was fused by hand.  For every (head, window of w
// rows) of a row block of the PAM, over S column slots:
//
//   pam[r, c] = bf16(scores[r, c] * scale), CAUSAL_FILL where c >= n_cols or
//               (causal) c > row0 + r; widened to float32
//   lo, hi    = bisection of the row's top-k threshold (12 halvings)
//   mask[r,c] = pam >= lo, on valid columns and rows < n_valid_rows
//   spa       = mask ? pam : 0
//   d[i, j]   = sum_c |spa_i - spa_j| / (sum_c |spa_i| + sum_c |spa_j| + 1e-6)
//   critical / leader: the greedy scan (d <= s, first earlier critical row)
//   kv_any[c] = OR over the block's rows of mask[r, c]
//
// What bounds it on an H100: the bytes of the scores.  At the serving shape
// (16 heads x 256 rows x 2176 slots, float32) a block is 35.7 MB read once
// and 8.9 MB of mask written: 13 us at 3.35 TB/s.  The 12 halvings re-read
// each row 12 times and the w(w-1)/2 distances each element ~w times, so
// those reads must not go to device memory.
//
// Design: one block of 8 warps for each (head, window).  Each warp takes the
// window's rows r = warp, warp + 8, ...: it loads the row once (coalesced),
// rounds it to bf16 as the plain chain does and keeps it in shared memory
// (w * S * 2 bytes: 35 KB at the serving shape), then runs the bisection on
// it with one warp-wide count a halving, op for op as bisect_topk_mask
// (mid = 0.5 * (lo + hi) in float32, cnt >= k), so mask and threshold are
// bit-equal to the plain chain.  The warp writes the mask row, stores 1 into
// the head's kv_any (zeroed before the launch; idempotent stores) where a
// column is kept, and turns its row into the SPA in place.  After a barrier
// the warps share the w(w-1)/2 pair distances and the w row norms, one item
// a warp at a time, each summed over the columns in float64 (lanes, then a
// butterfly) and rounded once to float32 as a distance; one thread runs the
// greedy leader scan over the w <= 16 rows.  One kernel serves every w (a
// runtime width, arrays sized for 16 rows).  Where a window's rows do not fit
// in shared memory (w * S * 2 above ~227 KB: S above ~14,500 at w 8, the
// long-sequence plan of a prompt of 16k tokens or more), its second
// instantiation re-reads the scores of a row from global memory (L2-resident:
// one window is w * S * 4 bytes) and rounds them again at each pass: the same
// values.  The choice is a template argument, not a runtime flag: a branch
// in the column loops cost the cached kernel 1.6-2.7x its time on an H100.
// The runtime w costs 7 % at the serving shape (5 us a layer of a chunk
// step, which no end-to-end metric sees) and 50 % at 8192 slots against one
// instantiation per w (H100), for one kernel in place of sixteen.
//
// spls_mfi: one thread per token reads the token's H head leaders, takes the
// first most frequent window offset, applies the f vote and does 3 pointer
// jumps.  Leaders stay inside the token's window, so a block holds whole
// windows and the jumps go through shared memory.  Integer arithmetic only.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_W = 16;
constexpr int HALVINGS = 12;
constexpr int POINTER_JUMPS = 3;
constexpr unsigned FULL = 0xffffffffu;

struct PlanArgs {
  const float* scores;    // (n_heads, C, S)
  unsigned char* mask;    // (n_heads, C, S) or null (votes only)
  unsigned char* crit;    // (n_heads, C)
  int* leader;            // (n_heads, C), block-local row ids
  unsigned char* kv_any;  // (n_heads, S), zeroed
  int C, S, w;             // w: rows of a window (votes only: WARPS)
  float scale, fill, s;
  int k, row0, n_valid_rows, n_cols, causal, votes_only;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// the plain chain's PAM entry: the float32 product rounded to bf16 (nearest
// even) and widened, or the fill on a column the row may not see
__device__ __forceinline__ float pam_entry(float score, float scale,
                                           bool visible, float fill) {
  return visible ? __bfloat162float(__float2bfloat16_rn(__fmul_rn(score, scale)))
                 : fill;
}

// index of pair (i, j), i < j, in the row-major upper triangle of a w x w
// tile (as csrc/local_similarity.cu)
__host__ __device__ constexpr int pair_index(int w, int i, int j) {
  return i * (2 * w - i - 1) / 2 + (j - i - 1);
}

// item q of a window's sums: the pair (i, j) of pair_index q, or for
// q = P .. P + w - 1 the norm of row i = q - P (j = -1)
__device__ __forceinline__ void item_rows(int w, int q, int& i, int& j) {
  const int P = w * (w - 1) / 2;
  if (q >= P) {
    i = q - P;
    j = -1;
    return;
  }
  i = 0;
  while (q >= w - 1 - i) {
    q -= w - 1 - i;
    ++i;
  }
  j = i + 1 + q;
}

template <bool CACHED>
__global__ void __launch_bounds__(THREADS)
spls_plan_kernel(PlanArgs a) {
  const int W = a.w, P = W * (W - 1) / 2;
  extern __shared__ __nv_bfloat16 rows_sm[];  // W x S when CACHED
  __shared__ float thr[MAX_W];
  __shared__ double sums[MAX_W * (MAX_W - 1) / 2 + MAX_W];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_win = (a.C + W - 1) / W;
  const long long head = blockIdx.x / n_win;
  const int r0 = (int)(blockIdx.x % n_win) * W;  // first row of the window
  const size_t S = (size_t)a.S;
  const float* sc = a.scores + ((size_t)head * a.C + r0) * S;
  unsigned char* kv_any = a.kv_any + (size_t)head * S;

  auto visible = [&](int r, int c) {
    return c < a.n_cols && (!a.causal || c <= a.row0 + r0 + r);
  };
  // row r's PAM entry at column c; CACHED: before the row became the SPA
  auto pam = [&](int r, int c) -> float {
    if constexpr (CACHED) return __bfloat162float(rows_sm[r * S + c]);
    return pam_entry(__ldg(sc + r * S + c), a.scale, visible(r, c), a.fill);
  };
  auto valid_row = [&](int r) { return r0 + r < a.n_valid_rows; };

  // 1. every row of the warp: load, round, bisect, mask, kv_any, SPA
  for (int r = warp; r < W && r0 + r < a.C; r += WARPS) {
    unsigned char* mrow =
        a.mask ? a.mask + ((size_t)head * a.C + r0 + r) * S : nullptr;
    if (!valid_row(r)) {  // a padded row keeps nothing
      for (int c = lane; c < a.S; c += 32) {
        if (mrow) mrow[c] = 0;
        if constexpr (CACHED) rows_sm[r * S + c] = __float2bfloat16_rn(0.f);
      }
      continue;
    }
    float hi = -INFINITY, lo_live = INFINITY;
    for (int c = lane; c < a.S; c += 32) {
      const float v = pam_entry(__ldg(sc + r * S + c), a.scale,
                                visible(r, c), a.fill);
      if constexpr (CACHED) rows_sm[r * S + c] = __float2bfloat16_rn(v);  // exact
      hi = fmaxf(hi, v);
      if (!(v < -1e29f)) lo_live = fminf(lo_live, v);
    }
    hi = warp_max(hi);
    // amin over the row with fill entries replaced by hi
    float lo = fminf(warp_min(lo_live), hi);
    __syncwarp();
    for (int it = 0; it < HALVINGS; ++it) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      int cnt = 0;
      for (int c = lane; c < a.S; c += 32) cnt += pam(r, c) >= mid;
      if (__reduce_add_sync(FULL, cnt) >= a.k) lo = mid;
      else hi = mid;
    }
    if (lane == 0) thr[r] = lo;
    for (int c = lane; c < a.S; c += 32) {
      const float v = pam(r, c);
      const bool m = visible(r, c) && v >= lo;
      if (mrow) mrow[c] = m;
      if (m) kv_any[c] = 1;
      if (CACHED && !m) rows_sm[r * S + c] = __float2bfloat16_rn(0.f);
    }
  }
  if (a.votes_only) return;
  __syncthreads();

  // row r's SPA entry at column c
  auto spa = [&](int r, int c) -> float {
    if constexpr (CACHED) return __bfloat162float(rows_sm[r * S + c]);
    if (!valid_row(r) || !visible(r, c)) return 0.f;
    const float v = pam(r, c);
    return v >= thr[r] ? v : 0.f;
  };

  // 2. pair L1 distances and row norms, float64, one item a warp at a time
  for (int q = warp; q < P + W; q += WARPS) {
    int i, j;
    item_rows(W, q, i, j);
    double acc = 0.0;
    if (j < 0) {
      for (int c = lane; c < a.S; c += 32) acc += fabs((double)spa(i, c));
    } else {
      for (int c = lane; c < a.S; c += 32)
        acc += fabs((double)spa(i, c) - (double)spa(j, c));
    }
    acc = warp_sum(acc);
    if (lane == 0) sums[q] = acc;
  }
  __syncthreads();

  // 3. the greedy leader scan of core/similarity.local_similarity
  if (threadIdx.x == 0) {
    unsigned crit = 0;  // bit j: row j of the window is critical
    for (int j = 0; j < W; ++j) {
      int lead = j;
      if (valid_row(j)) {
        crit |= 1u << j;
        for (int i = 0; i < j; ++i) {
          if (!(crit >> i & 1u)) continue;
          const double den = sums[P + i] + sums[P + j] + 1e-6;
          if ((float)(sums[pair_index(W, i, j)] / den) <= a.s) {
            lead = i;
            crit &= ~(1u << j);
            break;
          }
        }
      }
      const size_t o = (size_t)head * a.C + r0 + j;
      a.crit[o] = crit >> j & 1u;
      a.leader[o] = r0 + lead;
    }
  }
}

// the window's rows go to shared memory where they fit beside the static
// arrays (the card's opt-in limit: 227 KB on an H100), else each pass
// re-reads them from global memory
int launch_plan(const PlanArgs& a, long long n_heads, cudaStream_t stream) {
  static size_t room = 0;  // dynamic bytes the cached kernel may take
  if (room == 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, spls_plan_kernel<true>);
    if (e == cudaSuccess && (size_t)optin > fa.sharedSizeBytes)
      e = cudaFuncSetAttribute(spls_plan_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
    if (e != cudaSuccess) return (int)e;
    room = (size_t)optin - fa.sharedSizeBytes;
  }
  const size_t rows = sizeof(__nv_bfloat16) * a.w * (size_t)a.S;
  const long long blocks = n_heads * ((a.C + a.w - 1) / a.w);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (rows <= room)
    spls_plan_kernel<true><<<(unsigned)blocks, THREADS, rows, stream>>>(a);
  else
    spls_plan_kernel<false><<<(unsigned)blocks, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(THREADS)
spls_mfi_kernel(const int* __restrict__ leader, unsigned char* crit,
                int* out_leader, int* votes, int H, int L, int w, int f) {
  __shared__ int jump[THREADS];
  const int per = (THREADS / w) * w;  // whole windows a block
  const int base = blockIdx.x * per;
  const int t = threadIdx.x, tok = base + t;
  const size_t b = blockIdx.y;
  const bool live = t < per && tok < L;
  int led = tok, best_votes = 0;
  if (live) {
    int counts[MAX_W];
#pragma unroll
    for (int o = 0; o < MAX_W; ++o) counts[o] = 0;
    const int* ld = leader + b * H * L + tok;
    for (int h = 0; h < H; ++h) ++counts[(ld[(size_t)h * L] % w + w) % w];
    int best = 0;
    best_votes = counts[0];
    for (int o = 1; o < w; ++o)
      if (counts[o] > best_votes) {  // the first maximum
        best_votes = counts[o];
        best = o;
      }
    const int g = min((tok / w) * w + best, L - 1);
    if (best_votes >= f && g != tok) led = g;
  }
  jump[t] = led;
  __syncthreads();
  for (int n = 0; n < POINTER_JUMPS; ++n) {
    const int next = live ? jump[led - base] : led;
    __syncthreads();
    jump[t] = led = next;
    __syncthreads();
  }
  if (live) {
    crit[b * L + tok] = led == tok;
    out_leader[b * L + tok] = led;
    votes[b * L + tok] = best_votes;
  }
}

}  // namespace

// scores (n_heads, C, S) float32 -> mask (n_heads, C, S) bool (null when
// votes_only), crit (n_heads, C) bool, leader (n_heads, C) int32 block-local
// rows, kv_any (n_heads, S) bool; every array row-major and contiguous;
// C % w == 0, 1 <= w <= 16.  votes_only: kv_any alone (w is not read: a
// block takes 8 rows, one a warp).  Launches on `stream`; returns the first
// cudaError_t.
extern "C" int spls_plan_block_f32(const float* scores, unsigned char* mask,
                                   unsigned char* crit, int* leader,
                                   unsigned char* kv_any, long long n_heads,
                                   int C, int S, int w, float scale,
                                   float fill, int k, int row0,
                                   int n_valid_rows, int n_cols, int causal,
                                   float s_threshold, int votes_only,
                                   void* stream) {
  if (n_heads <= 0 || C <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (!votes_only &&
      (w < 1 || w > MAX_W || C % w || !mask || !crit || !leader))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(kv_any, 0, (size_t)n_heads * S, st);
  if (e != cudaSuccess) return (int)e;
  const PlanArgs a{scores, mask, crit, leader, kv_any, C, S,
                   votes_only ? WARPS : w, scale, fill, s_threshold, k,
                   row0, n_valid_rows, n_cols, causal, votes_only};
  return launch_plan(a, n_heads, st);
}

// leader (B, H, L) int32 per-head window leaders -> crit (B, L) bool, the
// FFN leader (B, L) int32 and the MFI votes (B, L) int32, as
// core/mfi.mfi_ffn_sparsity with 3 pointer jumps; 1 <= w <= 16.
extern "C" int spls_mfi_i32(const int* leader, unsigned char* crit,
                            int* out_leader, int* votes, int B, int H, int L,
                            int w, int f_threshold, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || L <= 0 || w < 1 || w > MAX_W)
    return (int)cudaErrorInvalidValue;
  const int per = (THREADS / w) * w;
  const dim3 grid((L + per - 1) / per, B);
  spls_mfi_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      leader, crit, out_leader, votes, H, L, w, f_threshold);
  return (int)cudaGetLastError();
}
