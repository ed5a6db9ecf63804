// gather_rows: out[i] = src[idx[i]], float32 rows.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gathered_matmul.py,
// function gather_rows_kernel (kernel body _gather_kernel): the leader
// scatter of the packed FFN output back to every chunk row, where similar
// rows read their leader's packed slot.
//
// What bounds it on an H100: it is a pure copy, so the bytes -- each output
// row read once and written once, 2 * M * F * 4 bytes -- over the 3.35 TB/s
// of device memory; at the serving shape (64 rows of 768) that is about
// 0.12 us, far below a launch, so a call's device time is a launch and one
// round trip to memory.
//
// Design: one block per output row, copying with 16-byte vector loads and
// stores when the row width is a multiple of 4 floats and both rows are
// 16-byte aligned (scalar otherwise).  Source indices outside [0, C) are
// clamped, as the reference's gathers clamp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_rows_kernel(const float* __restrict__ src,
                                   const int* __restrict__ idx,
                                   float* __restrict__ out, int C, int F,
                                   int vec) {
  const int r = blockIdx.x;
  int s = idx[r];
  s = s < 0 ? 0 : (s >= C ? C - 1 : s);
  const float* srow = src + (size_t)s * F;
  float* orow = out + (size_t)r * F;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(srow);
    float4* o4 = reinterpret_cast<float4*>(orow);
    for (int i = threadIdx.x; i < F / 4; i += blockDim.x) o4[i] = __ldg(s4 + i);
  } else {
    for (int i = threadIdx.x; i < F; i += blockDim.x) orow[i] = __ldg(srow + i);
  }
}

}  // namespace

// src (C, F), idx (M,) int32 -> out (M, F); float32, row-major and
// contiguous.  Launches on `stream`; returns the launch's cudaError_t.
extern "C" int gather_rows_f32(const float* src, const int* idx, float* out,
                               int C, int F, int M, void* stream) {
  if (C <= 0 || F <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const int vec = (F % 4 == 0) && ((uintptr_t)src % 16 == 0) &&
                  ((uintptr_t)out % 16 == 0);
  const int work = vec ? F / 4 : F;
  int threads = ((work + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  gather_rows_kernel<<<M, threads, 0, (cudaStream_t)stream>>>(src, idx, out,
                                                              C, F, vec);
  return (int)cudaGetLastError();
}
