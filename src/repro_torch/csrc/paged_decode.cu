// paged_flash_decode: one-token GQA attention over a block-pool KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_decode.py,
// function paged_flash_decode (kernel body _kernel): every decode tick of
// the paged serving engine, once per layer.
//
// Inputs (float32 unless noted, all contiguous):
//   q (B, KV, G, Dh); k_pages / v_pages (KV, N, ps, Dh); pos_pages (N, ps)
//   int32 original token ids; tables (B, P) int32 block tables; kv_len (B,)
//   int32 written slots; pos (B,) int32 the query's original position.
// Output (B, KV, G, Dh).  Slot s of row b is attended iff s < kv_len[b]
// and, with a window, pos[b] - id < window, where id is the slot's
// original token id from pos_pages -- not its slot index, because SPLS
// page pruning compacts kept columns so slot != position.
//
// What bounds it on an H100: the bytes of the live K/V slots (2 * live *
// KV * Dh * 4 over all rows) plus q and out, over 3.35 TB/s; a few
// microseconds at the serving shapes.  The operations are ~1 FLOP/byte.
//
// Design: one block per (b, kv head).  The TPU's sequential page axis
// becomes a loop inside the block over the row's block table.  The loop
// stops at the first page whose first slot is at or past kv_len (the table
// is filled in slot order), and skips a page whose written slots have all
// left the window.  Each page's (ps, Dh) K and V tiles are staged in
// shared memory (K rows padded by one float so threads walking different
// slots hit different banks); the G query rows' scores are masked,
// softcapped and folded into a float32 online softmax; the last step
// divides by l where l > 0, so a row with nothing to attend (kv_len 0)
// gives zeros.  The null page 0 only ever sits at table entries past
// kv_len, so it never contributes.  Page ids outside [0, N) are clamped.
//
// Later work: at B * KV = 48 blocks the card's 132 SMs are under-occupied;
// splitting the page loop across blocks (split-K with a second reduction
// pass) and staging pages with cp.async / TMA would fill it.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr float NEG = -1e30f;

__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_pages,
                    const float* __restrict__ v_pages,
                    const int* __restrict__ pos_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ kv_len,
                    const int* __restrict__ pos, float* __restrict__ out,
                    int KV, int G, int Dh, int N, int ps, int P, float scale,
                    float softcap, int window) {
  extern __shared__ float smem[];
  const int KS = Dh + 1;                 // padded K row stride
  float* qs = smem;                      // G * Dh
  float* ks = qs + G * Dh;               // ps * KS
  float* vs = ks + ps * KS;              // ps * Dh
  float* sc = vs + ps * Dh;              // G * ps scores, then weights
  float* acc = sc + G * ps;              // G * Dh
  float* m_run = acc + G * Dh;           // G
  float* l_run = m_run + G;              // G
  float* corr = l_run + G;               // G
  int* pid = reinterpret_cast<int*>(corr + G);  // ps

  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const size_t qoff = (size_t)blockIdx.x * G * Dh;

  for (int i = tid; i < G * Dh; i += THREADS) {
    qs[i] = q[qoff + i];
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_run[g] = NEG;
    l_run[g] = 0.f;
  }
  const int n_valid = kv_len[b];
  const int cur = pos[b];
  __syncthreads();

  for (int j = 0; j < P; ++j) {
    const int slot0 = j * ps;
    if (slot0 >= n_valid) break;         // no written slot from here on
    int page = tables[(size_t)b * P + j];
    page = page < 0 ? 0 : (page >= N ? N - 1 : page);

    int mine = 0;
    for (int s = tid; s < ps; s += THREADS) {
      const int id = pos_pages[(size_t)page * ps + s];
      pid[s] = id;
      mine |= (slot0 + s < n_valid) && (window <= 0 || cur - id < window);
    }
    // barrier + block-wide OR: skip the page if no written slot is live
    if (!__syncthreads_or(mine)) continue;

    const size_t base = ((size_t)h * N + page) * ps * Dh;
    for (int i = tid; i < ps * Dh; i += THREADS) {
      const int s = i / Dh, d = i % Dh;
      ks[s * KS + d] = __ldg(k_pages + base + i);
      vs[i] = __ldg(v_pages + base + i);
    }
    __syncthreads();

    for (int i = tid; i < G * ps; i += THREADS) {
      const int g = i / ps, s = i % ps;
      float dot = 0.f;
      for (int d = 0; d < Dh; ++d) dot = fmaf(qs[g * Dh + d], ks[s * KS + d], dot);
      float v = dot * scale;
      if (softcap > 0.f) v = tanhf(v / softcap) * softcap;
      const bool ok = (slot0 + s < n_valid) &&
                      (window <= 0 || cur - pid[s] < window);
      sc[i] = ok ? v : NEG;
    }
    __syncthreads();

    // online-softmax statistics, one thread per query row
    for (int g = tid; g < G; g += THREADS) {
      float mx = m_run[g];
      for (int s = 0; s < ps; ++s) mx = fmaxf(mx, sc[g * ps + s]);
      const float c = expf(m_run[g] - mx);
      float sum = 0.f;
      for (int s = 0; s < ps; ++s) {
        const bool ok = (slot0 + s < n_valid) &&
                        (window <= 0 || cur - pid[s] < window);
        const float p = ok ? expf(sc[g * ps + s] - mx) : 0.f;
        sc[g * ps + s] = p;
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
      for (int s = 0; s < ps; ++s) a = fmaf(sc[g * ps + s], vs[s * Dh + d], a);
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
extern "C" int paged_decode_f32(const float* q, const float* k_pages,
                                const float* v_pages, const int* pos_pages,
                                const int* tables, const int* kv_len,
                                const int* pos, float* out, int B, int KV,
                                int G, int Dh, int N, int ps, int P,
                                float scale, float softcap, int window,
                                void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || Dh <= 0 || N <= 0 || ps <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)2 * G * Dh + (size_t)ps * (Dh + 1) +
                                       (size_t)ps * Dh + (size_t)G * ps + 3 * G) +
                      sizeof(int) * ps;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_decode_kernel<<<B * KV, THREADS, smem, (cudaStream_t)stream>>>(
      q, k_pages, v_pages, pos_pages, tables, kv_len, pos, out, KV, G, Dh, N,
      ps, P, scale, softcap, window);
  return (int)cudaGetLastError();
}
