// The host->device copy of one piece of a row-major host array, for the
// serving arena's copy stream (runtime/arena.py, ops/cuda/upload.py).
//
// Replaces no TPU kernel and launches none.  A piece of the arena's
// slot-major (capacity, 2, L) int16 frame array is 2 capacity rows of
// `width` bytes at a pitch of L samples: one cudaMemcpy2DAsync from pinned
// host memory, which a copy engine runs at the pace of PCIe while the
// compute stream works.  PyTorch's copy of such a strided host view first
// makes it contiguous in pageable memory, and the copy turns synchronous.
// A plain C interface, so ctypes binds it as it binds the kernels
// (ops/cuda/build.py).

#include <cuda_runtime.h>

#include <cstddef>

extern "C" int upload_rows(void* dst, size_t dpitch, const void* src,
                           size_t spitch, size_t width, size_t height,
                           void* stream) {
  return static_cast<int>(cudaMemcpy2DAsync(
      dst, dpitch, src, spitch, width, height, cudaMemcpyHostToDevice,
      static_cast<cudaStream_t>(stream)));
}
