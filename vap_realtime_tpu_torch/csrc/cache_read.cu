// The cache-read floor, for Hopper (sm_90a).  Hand-written replacement of
// the TPU lab kernel `read_all` (tools/component_bench.py:393, body
// `_sum_kernel`:383): the float32 column sums of the whole phase-major KV
// cache, out[c] = sum over (b, p, t) of float(cache[b, p, t, c]), one
// (1, 4D) float32 row.  The TPU kernel carried the sum in its output block
// across a sequential grid; blocks on the card run in parallel, so:
//
//   pass 1 (cache_read_partial): the cache is read as rows of 16-byte
//     chunks; a block of 32-lane warps owns `rpb` row slots of the chunk
//     columns (thread t reads chunk column t % cols16 of rows t / cols16,
//     t / cols16 + rpb, ...), strided over the grid, with one 16-byte
//     vector load per chunk and several loads in flight per thread; each
//     thread keeps the float32 sums of its chunk's 16 / es columns in
//     registers, the block adds its row slots in shared memory in a fixed
//     order and writes one partial row (4D floats) per block;
//   pass 2 (cache_read_final): one thread per column adds the partial rows
//     in block order.
// No float atomics: the result does not change from run to run.  The
// cache element type (float32, bf16, int8) is a template parameter.
//
// Bound on the H100 (3.35 TB/s HBM): bytes.  At B=4096, P=7, T=50, 4D=1024
// the bf16 cache is 2.94 GB (0.877 ms); the partial rows (a few MB) are
// noise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte loads in flight per thread

template <typename C>
struct Chunk;  // 16 bytes of C <-> float sums

template <>
struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void add(const uint4& u, float* s) {
    s[0] += __uint_as_float(u.x);
    s[1] += __uint_as_float(u.y);
    s[2] += __uint_as_float(u.z);
    s[3] += __uint_as_float(u.w);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void add(const uint4& u, float* s) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> float: the high half-word
      s[2 * i] += __uint_as_float(w[i] << 16);
      s[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Chunk<int8_t> {
  static constexpr int N = 16;
  static __device__ __forceinline__ void add(const uint4& u, float* s) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[4 * i + j] += static_cast<float>(
            static_cast<int8_t>((w[i] >> (8 * j)) & 0xffu));
  }
};

// grid: nblk blocks of kThreads; rows of cols16 16-byte chunks.
template <typename C>
__global__ void cache_read_partial(const uint4* __restrict__ x,
                                   long long rows, int cols16,
                                   float* __restrict__ partial) {
  constexpr int N = Chunk<C>::N;
  extern __shared__ float smem[];  // [rpb][cols16 * N]
  const int rpb = kThreads / cols16;
  const int c = threadIdx.x % cols16;
  const int slot = threadIdx.x / cols16;
  float s[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = 0.f;
  const long long step = static_cast<long long>(rpb) * gridDim.x;
  long long r = static_cast<long long>(blockIdx.x) * rpb + slot;
  for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
    uint4 u[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      u[k] = __ldg(x + (r + k * step) * cols16 + c);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) Chunk<C>::add(u[k], s);
  }
  for (; r < rows; r += step) Chunk<C>::add(__ldg(x + r * cols16 + c), s);
#pragma unroll
  for (int i = 0; i < N; ++i) smem[slot * cols16 * N + c * N + i] = s[i];
  __syncthreads();
  const int width = cols16 * N;
  for (int col = threadIdx.x; col < width; col += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < rpb; ++k) acc += smem[k * width + col];
    partial[static_cast<long long>(blockIdx.x) * width + col] = acc;
  }
}

__global__ void cache_read_final(const float* __restrict__ partial,
                                 int nblk, int width,
                                 float* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= width) return;
  float acc = 0.f;
  for (int k = 0; k < nblk; ++k)
    acc += partial[static_cast<long long>(k) * width + col];
  out[col] = acc;
}

template <typename C>
int launch(const void* x, long long rows, int cols16, float* partial,
           int nblk, float* out, cudaStream_t stream) {
  const int width = cols16 * Chunk<C>::N;
  const size_t smem = sizeof(float) * (kThreads / cols16) * width;
  cache_read_partial<C><<<nblk, kThreads, smem, stream>>>(
      static_cast<const uint4*>(x), rows, cols16, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  cache_read_final<<<(width + 255) / 256, 256, 0, stream>>>(partial, nblk,
                                                           width, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8.  x: `rows` rows of cols16
// 16-byte chunks, 16-byte aligned; cols16 divides 256 (at most 256 chunks
// per row).  partial: nblk * (row width in elements) floats of scratch;
// out: the row width in floats.  Returns the launches' cudaError_t.
extern "C" int cache_read_launch(int dtype, const void* x, long long rows,
                                 int cols16, float* partial, int nblk,
                                 float* out, void* stream) {
  if (rows <= 0 || cols16 <= 0 || kThreads % cols16 != 0 || nblk <= 0 ||
      (reinterpret_cast<uintptr_t>(x) & 15u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, rows, cols16, partial, nblk, out, st);
    case 1:
      return launch<__nv_bfloat16>(x, rows, cols16, partial, nblk, out, st);
    case 2:
      return launch<int8_t>(x, rows, cols16, partial, nblk, out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
