// flash_decode: one-token GQA attention over a contiguous KV cache.
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
// KV * Dh * 4 over all rows) plus q and out, over 3.35 TB/s; a few
// microseconds at the serving shapes.  The operations are ~1 FLOP/byte.
//
// Design: one block per (b, kv head), carrying the group's G query rows
// together so they share every K/V read (the point of GQA at decode).  The
// TPU's sequential cache axis becomes a loop inside the block over 64-slot
// tiles; it stops at the first tile past pos and skips a tile whose slots
// have all left the window (flash_decode.py:45-49).  Each tile's (64, Dh)
// K and V are staged in shared memory (K rows padded by one float); the G
// rows' scores are masked, softcapped and folded into an online softmax;
// the last step divides by l where l > 0.
//
// Later work: at B * KV = 48 blocks the card's 132 SMs are under-occupied;
// split-K over the cache with a second reduction pass, and cp.async / TMA
// staging, would fill it.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int BK = 64;
constexpr float NEG = -1e30f;

__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ pos,
                    float* __restrict__ out, int KV, int G, int S, int Dh,
                    float scale, float softcap, int window) {
  extern __shared__ float smem[];
  const int KS = Dh + 1;                 // padded K row stride
  float* qs = smem;                      // G * Dh
  float* ks = qs + G * Dh;               // BK * KS
  float* vs = ks + BK * KS;              // BK * Dh
  float* sc = vs + BK * Dh;              // G * BK scores, then weights
  float* acc = sc + G * BK;              // G * Dh
  float* m_run = acc + G * Dh;           // G
  float* l_run = m_run + G;              // G
  float* corr = l_run + G;               // G

  const int b = blockIdx.x / KV;
  const int tid = threadIdx.x;
  const size_t qoff = (size_t)blockIdx.x * G * Dh;
  const size_t kvoff = (size_t)blockIdx.x * S * Dh;

  for (int i = tid; i < G * Dh; i += THREADS) {
    qs[i] = q[qoff + i];
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_run[g] = NEG;
    l_run[g] = 0.f;
  }
  const int cur = pos[b];
  __syncthreads();

  for (int k0 = 0; k0 < S; k0 += BK) {
    if (k0 > cur) break;                                   // past pos
    if (window > 0 && !(k0 + BK - 1 > cur - window)) continue;  // behind
    const int nk = min(BK, S - k0);
    for (int i = tid; i < BK * Dh; i += THREADS) {
      const int j = i / Dh, d = i % Dh;
      float kk = 0.f, vv = 0.f;
      if (j < nk) {
        kk = __ldg(k + kvoff + (size_t)k0 * Dh + i);
        vv = __ldg(v + kvoff + (size_t)k0 * Dh + i);
      }
      ks[j * KS + d] = kk;
      vs[i] = vv;
    }
    __syncthreads();

    for (int i = tid; i < G * BK; i += THREADS) {
      const int g = i / BK, j = i % BK;
      const int kj = k0 + j;
      float dot = 0.f;
      for (int d = 0; d < Dh; ++d) dot = fmaf(qs[g * Dh + d], ks[j * KS + d], dot);
      float x = dot * scale;
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      const bool ok = j < nk && kj <= cur &&
                      (window <= 0 || cur - kj < window);
      sc[i] = ok ? x : -INFINITY;
    }
    __syncthreads();

    // online-softmax statistics, one thread per query row
    for (int g = tid; g < G; g += THREADS) {
      float mx = m_run[g];
      for (int j = 0; j < BK; ++j) mx = fmaxf(mx, sc[g * BK + j]);
      const float c = expf(m_run[g] - mx);
      float sum = 0.f;
      for (int j = 0; j < BK; ++j) {
        const float p = expf(sc[g * BK + j] - mx);   // dead: exp(-inf) = 0
        sc[g * BK + j] = p;
        sum += p;
      }
      l_run[g] = l_run[g] * c + sum;
      m_run[g] = mx;
      corr[g] = c;
    }
    __syncthreads();

    for (int i = tid; i < G * Dh; i += THREADS) {
      const int g = i / Dh, d = i % Dh;
      float a = acc[i] * corr[g];
      for (int j = 0; j < BK; ++j) a = fmaf(sc[g * BK + j], vs[j * Dh + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * Dh; i += THREADS) {
    const float l = l_run[i / Dh];
    out[qoff + i] = acc[i] / (l > 0.f ? l : 1.f);
  }
}

}  // namespace

// See the header comment for the layout.  softcap <= 0 and window <= 0
// mean "none".  Launches on `stream`; returns the launch's cudaError_t.
extern "C" int flash_decode_f32(const float* q, const float* k,
                                const float* v, const int* pos, float* out,
                                int B, int KV, int G, int S, int Dh,
                                float scale, float softcap, int window,
                                void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || S <= 0 || Dh <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)2 * G * Dh +
                                       (size_t)BK * (Dh + 1) +
                                       (size_t)BK * Dh + (size_t)G * BK +
                                       3 * (size_t)G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  flash_decode_kernel<<<B * KV, THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, pos, out, KV, G, S, Dh, scale, softcap, window);
  return (int)cudaGetLastError();
}
