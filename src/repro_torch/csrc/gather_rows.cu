// gather_rows: out[i] = src[idx[i]], rows copied as bytes (any element
// size: float32, bf16, ...).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gathered_matmul.py,
// function gather_rows_kernel (kernel body _gather_kernel): the leader
// scatter of the packed FFN output back to every chunk row, where similar
// rows read their leader's packed slot.
//
// What bounds it on an H100: it is a pure copy, so the bytes -- each output
// row read once and written once, 2 * M * row_bytes -- over the 3.35 TB/s
// of device memory; at the serving shape (64 rows of 768 float32) that is
// about 0.12 us, far below a launch, so a call's device time is a launch
// and one round trip to memory.
//
// Design: one block per output row, copying the row's bytes in the widest
// unit that the row size and both base addresses allow (16-byte vectors
// when rows are 16-byte multiples and aligned, then 8, 4, 2, 1 bytes), so
// a bf16 row moves as 2-byte elements would, without a cast to float32
// around the call.  Source indices outside [0, C) are clamped, as the
// reference's gathers clamp.
//
// Not done: two rows a block with both rows' loads issued before the
// stores.  A build of it timed slower on the card than this one (an
// uncommitted build; no committed script measured it, so no number is
// kept).  It halves the blocks (32 for the 64-row serving call, on 132
// SMs) and leaves the critical path -- one row's load, then its store --
// as long, so it has nothing to win while the launch and that one round
// trip are the whole time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ src,
                                   const int* __restrict__ idx,
                                   T* __restrict__ out, int C, int n) {
  const int r = blockIdx.x;
  int s = idx[r];
  s = s < 0 ? 0 : (s >= C ? C - 1 : s);
  const T* srow = src + (size_t)s * n;
  T* orow = out + (size_t)r * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) orow[i] = __ldg(srow + i);
}

template <typename T>
int launch(const void* src, const int* idx, void* out, int C, int row_bytes,
           int M, cudaStream_t stream) {
  const int n = row_bytes / (int)sizeof(T);
  int threads = ((n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  gather_rows_kernel<T><<<M, threads, 0, stream>>>(
      static_cast<const T*>(src), idx, static_cast<T*>(out), C, n);
  return (int)cudaGetLastError();
}

}  // namespace

// src (C, row_bytes) bytes, idx (M,) int32 -> out (M, row_bytes); row-major
// and contiguous.  Launches on `stream`; returns the launch's cudaError_t.
extern "C" int gather_rows_bytes(const void* src, const int* idx, void* out,
                                 int C, int row_bytes, int M, void* stream) {
  if (C <= 0 || row_bytes <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t a = (uintptr_t)src | (uintptr_t)out | (uintptr_t)row_bytes;
  cudaStream_t st = (cudaStream_t)stream;
  if (a % 16 == 0) return launch<uint4>(src, idx, out, C, row_bytes, M, st);
  if (a % 8 == 0) return launch<uint2>(src, idx, out, C, row_bytes, M, st);
  if (a % 4 == 0) return launch<uint32_t>(src, idx, out, C, row_bytes, M, st);
  if (a % 2 == 0) return launch<uint16_t>(src, idx, out, C, row_bytes, M, st);
  return launch<uint8_t>(src, idx, out, C, row_bytes, M, st);
}
