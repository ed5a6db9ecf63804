// flash_attention: block online-softmax attention with the SPLS block skips.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py,
// function flash_attention (kernel body _make_kernel): every attention
// layer of a whole-prompt prefill (model.prefill -> block_forward ->
// attention_forward -> the cuda_flash backend).
//
// Inputs (float32 unless noted, all contiguous):
//   q (B, H, Lq, Dh); k / v (B, KV, Lk, Dh) with H = KV * G (head h reads
//   the K/V row of group h / G); kv_keep (B, H, Lk) uint8 or null (all
//   kept); q_pos (B, H, Lq) int32 or null (row i sits at position i).
// Output (B, H, Lq, Dh).  Row i attends column j iff j < Lk, kv_keep[j],
// causal: j <= q_pos[i], window: q_pos[i] - j < window and, without
// causal, j - q_pos[i] < window (a symmetric band).  Scores are scaled,
// softcapped (tanh(s / cap) * cap), softmaxed over the live columns; a
// row with no live column gives zeros.
//
// Block skips, exactly the Pallas predicates (flash_attention.py:91-108),
// on this kernel's own 64 x 64 tiles: with q_lo / q_hi the min / max of the
// tile's real q_pos, a K tile starting at k0 is live iff (causal) k0 <=
// q_hi, (window) k0 + 63 > q_lo - window and, without causal, k0 < q_hi +
// window, and (kv_keep) some real column of the tile is kept.  Each
// predicate only drops tiles with no live (row, column) pair, so skipping
// changes no result; the kv_keep skip is what turns SPLS column pruning
// into saved work.
//
// Arithmetic: scores, the running max and sum, and P.V accumulate in
// float64 and round once to float32 at the output.  Products of float32
// values are exact in float64, so this kernel and its plain version
// (flash_attention_plain, a dense float64 softmax) agree to the last
// float32 bit in practice whatever their summation orders.  That matters
// here: the output is the residual the next layer's 8-bit SPLS predictor
// quantizes, and a last-bit difference can move a plan.
//
// What bounds it on an H100: operations.  4 * Dh flops per live (row,
// column) pair in float64; the card's float64 peak is 67 TFLOP/s through
// the FP64 tensor cores (DMMA), and this kernel's own limit is half that,
// since it issues DFMA on the CUDA cores.  The bytes (q, k, v, out, a few
// MB) take a microsecond at 3.35 TB/s.
//
// Design: one block of 256 threads per (b * H + h, 64-row q tile); the
// TPU's sequential K grid axis becomes a loop inside the block.  Q stays
// in shared memory for the whole loop; each live K/V tile (64 x Dh) is
// staged in shared memory (K rows padded by one float so threads reading
// different rows hit different banks).  A thread computes a 4 x 4 patch of
// the 64 x 64 score tile; four threads share each row's online-softmax
// update (warp shuffles); the float64 accumulator (64 x Dh) lives in
// shared memory.  Padded q rows of a ragged last tile repeat the last real
// position and are never written; padded K columns are dead.
//
// Later work: float64 halves the rate and the 64-row tiles leave 72 blocks
// for the 132 SMs at the serving shape; 3xTF32 wgmma with error-free
// splitting and smaller q tiles would fill the card.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr double NEG = -1e30;

__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const unsigned char* __restrict__ keep,
                       const int* __restrict__ q_pos,
                       float* __restrict__ out, int Lq, int Lk, int Dh,
                       int G, double scale, int causal, int window,
                       double softcap) {
  extern __shared__ double smem[];
  const int KS = Dh + 1;                         // padded K row stride
  double* s = smem;                              // BQ * BK scores / weights
  double* acc = s + BQ * BK;                     // BQ * Dh
  double* m_run = acc + BQ * Dh;                 // BQ
  double* l_run = m_run + BQ;                    // BQ
  double* corr = l_run + BQ;                     // BQ
  float* qs = reinterpret_cast<float*>(corr + BQ);  // BQ * Dh
  float* ks = qs + BQ * Dh;                      // BK * KS
  float* vs = ks + BK * KS;                      // BK * Dh
  int* qp = reinterpret_cast<int*>(vs + BK * Dh);   // BQ
  unsigned char* kb = reinterpret_cast<unsigned char*>(qp + BQ);  // BK

  const int bh = blockIdx.y;                     // b * H + h
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, Lq - q0);               // real rows of this tile
  const int tid = threadIdx.x;
  const size_t qoff = ((size_t)bh * Lq + q0) * Dh;
  const size_t kvoff = (size_t)(bh / G) * Lk * Dh;

  for (int i = tid; i < BQ * Dh; i += THREADS) {
    qs[i] = i / Dh < nq ? q[qoff + i] : 0.f;
    acc[i] = 0.0;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    const int pr = r < nq ? r : nq - 1;          // pad rows: last real pos
    qp[r] = q_pos ? q_pos[(size_t)bh * Lq + q0 + pr] : q0 + pr;
    m_run[r] = NEG;
    l_run[r] = 0.0;
  }
  __syncthreads();
  int q_lo = qp[0], q_hi = qp[0];
  for (int r = 1; r < nq; ++r) {
    q_lo = min(q_lo, qp[r]);
    q_hi = max(q_hi, qp[r]);
  }

  const int ty = tid >> 4, tx = tid & 15;        // 4 x 4 score patch
  const int sr = tid >> 2, part = tid & 3;       // softmax: 4 thr per row
  for (int k0 = 0; k0 < Lk; k0 += BK) {
    // block-level skip (uniform across the block)
    if (causal && k0 > q_hi) break;
    if (window > 0) {
      if (!(k0 + BK - 1 > q_lo - window)) continue;
      if (!causal && !(k0 < q_hi + window)) continue;
    }
    const int nk = min(BK, Lk - k0);
    int mine = 0;
    for (int j = tid; j < BK; j += THREADS) {
      const unsigned char live =
          j < nk && (keep == nullptr || keep[(size_t)bh * Lk + k0 + j]);
      kb[j] = live;
      mine |= live;
    }
    // barrier + block-wide OR: skip a tile with no kept column
    if (!__syncthreads_or(mine)) continue;

    for (int i = tid; i < BK * Dh; i += THREADS) {
      const int j = i / Dh, d = i % Dh;
      float kv_k = 0.f, kv_v = 0.f;
      if (j < nk) {
        kv_k = __ldg(k + kvoff + (size_t)k0 * Dh + i);
        kv_v = __ldg(v + kvoff + (size_t)k0 * Dh + i);
      }
      ks[j * KS + d] = kv_k;
      vs[i] = kv_v;
    }
    __syncthreads();

    {
      double sacc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) sacc[a][b] = 0.0;
      for (int d = 0; d < Dh; ++d) {
        double qa[4], kc[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) qa[a] = (double)qs[(ty + 16 * a) * Dh + d];
#pragma unroll
        for (int b = 0; b < 4; ++b) kc[b] = (double)ks[(tx + 16 * b) * KS + d];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) sacc[a][b] = fma(qa[a], kc[b], sacc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
        const int qi = qp[r];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = tx + 16 * b;
          const int kj = k0 + c;
          double x = sacc[a][b] * scale;
          if (softcap > 0.0) x = tanh(x / softcap) * softcap;
          bool ok = kb[c];
          if (causal) ok = ok && kj <= qi;
          if (window > 0) {
            ok = ok && qi - kj < window;
            if (!causal) ok = ok && kj - qi < window;
          }
          // a dead entry is -inf: exp() gives it weight 0 below
          s[r * BK + c] = ok ? x : -INFINITY;
        }
      }
    }
    __syncthreads();

    {
      double* row = s + sr * BK + part * 16;
      double mx = -INFINITY;
      for (int c = 0; c < 16; ++c) mx = fmax(mx, row[c]);
      mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const double m_prev = m_run[sr];
      const double m_new = fmax(m_prev, mx);     // finite: m_run starts at NEG
      double sum = 0.0;
      for (int c = 0; c < 16; ++c) {
        const double p = exp(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const double cr = exp(m_prev - m_new);
        corr[sr] = cr;
        l_run[sr] = l_run[sr] * cr + sum;
        m_run[sr] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < nq * Dh; i += THREADS) {
      const int r = i / Dh, d = i % Dh;
      const double* pr = s + r * BK;
      double a = acc[i] * corr[r];
      for (int c = 0; c < BK; ++c) a = fma(pr[c], (double)vs[c * Dh + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < nq * Dh; i += THREADS) {
    const double l = l_run[i / Dh];
    out[qoff + i] = (float)(acc[i] / (l > 0.0 ? l : 1.0));
  }
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
  const size_t smem = sizeof(double) * ((size_t)BQ * BK + (size_t)BQ * Dh +
                                        3 * BQ) +
                      sizeof(float) * ((size_t)BQ * Dh + (size_t)BK * (Dh + 1) +
                                       (size_t)BK * Dh) +
                      sizeof(int) * BQ + BK;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  flash_attention_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, keep, q_pos, out, Lq, Lk, Dh, H / KV, scale, causal, window,
      softcap);
  return (int)cudaGetLastError();
}
