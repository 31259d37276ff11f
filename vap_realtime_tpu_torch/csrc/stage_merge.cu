// The staged KV ring's merge, for Hopper (sm_90a), in one launch.
//
// Replaces no TPU kernel: the JAX package's merge (`_kv_core` in
// vap_realtime_tpu/runtime/incremental.py) is XLA scatters.  The port's plain
// version (`stage_merge_plain` in ops/cuda/merge.py) is 3 x S row scatters of
// several PyTorch ops each, over a hundred launches a merge.
// Every STAGE_S ticks the serving step moves each valid staged row
// (stage_stamp[i, b] >= 0) to its stream's own ring position
// t = stage_stamp[i, b] % T:
//
//   cache[b, p, t, :] = stage[i, b, p*X:(p+1)*X]   for every phase p
//   stamp[b, t]       = stage_stamp[i, b]
//   scale[b, p, t]    = stage_scale[i, b, p]       (int8 rows, quant="row")
//   stage_stamp[i, b] = -1                         for every i
//
// Invalid rows (frozen ticks, slots reset since) read no payload.
//
// Bound on the H100 (3.35 TB/s HBM): bytes.  The valid stage rows are read
// once and written once into the ring: at S = 8, B = 20,480, P = 7,
// X = 1,024 bf16 that is 2.35 GB each way, 4.70 GB, 1.40 ms; at B = 14,336,
// 3.29 GB, 0.98 ms.  The stamps and scales are noise.
//
// Design.  The merge copies bytes, so one body serves every element type
// (bf16 phase rows of 2 KB, float32 4 KB, int8 1 KB): the row width in bytes
// is an argument, a whole number of 16-byte vectors.  A block owns one
// stream at a time, grid-stride over the streams with as many blocks as the
// card holds at once.  Its threads read the stream's S stage stamps into
// shared memory once, then copy the valid staged rows in stage order:
// thread j moves the same vectors of every row, with several 16-byte loads
// in flight before their stores, both with the streaming hint (the stage
// is read once; the ring, gigabytes, does not stay in the 50 MB L2 until
// the next tick reads it).  Then the stamps and row scales are written and
// the stream's stage stamps reset.  The reset follows the block's only read
// of those stamps, so no thread skips a row.  Two staged rows of one stream
// with one ring target (the serving step never makes them: S <= T, and a
// slot reset clears its stage stamps) still end as the plain version's
// sequential writes do, with the later row: each ring byte of the stream
// is written by one thread, in stage order.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vector loads in flight per thread
constexpr int kMaxS = 64;   // stage depth held in shared memory

// cache (B, P, T, row_bytes), stamp (B, T) int32, stage (S, B, P, row_bytes),
// stage_stamp (S, B) int32; scale (B, P, T) and stage_scale (S, B, P)
// float32, or both null.
__global__ void __launch_bounds__(kThreads)
    stage_merge_kernel(char* __restrict__ cache, int* __restrict__ stamp,
                       const char* __restrict__ stage,
                       int* __restrict__ stage_stamp,
                       float* __restrict__ scale,
                       const float* __restrict__ stage_scale, int S, int B,
                       int P, int T, long long row_bytes) {
  using U = uint4;
  __shared__ int s_stamp[kMaxS];
  const int row_vecs = static_cast<int>(row_bytes / sizeof(U));
  const int nvec = P * row_vecs;                 // one staged row, P phases
  const long long plane = T * row_bytes;         // one phase's ring
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    for (int i = threadIdx.x; i < S; i += kThreads)
      s_stamp[i] = stage_stamp[static_cast<long long>(i) * B + b];
    __syncthreads();
    char* ring = cache + static_cast<long long>(b) * P * plane;
    for (int i = 0; i < S; ++i) {
      const int st = s_stamp[i];
      if (st < 0) continue;
      char* dst_row = ring + static_cast<long long>(st % T) * row_bytes;
      const U* src = reinterpret_cast<const U*>(
          stage + (static_cast<long long>(i) * B + b) * P * row_bytes);
      for (int v0 = threadIdx.x; v0 < nvec; v0 += kUnroll * kThreads) {
        U u[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int v = v0 + k * kThreads;
          if (v < nvec) u[k] = __ldcs(src + v);
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int v = v0 + k * kThreads;
          if (v < nvec) {
            const int p = v / row_vecs;
            U* dst = reinterpret_cast<U*>(dst_row + p * plane) +
                     (v - p * row_vecs);
            __stcs(dst, u[k]);
          }
        }
      }
    }
    if (threadIdx.x == 0) {
      for (int i = 0; i < S; ++i) {
        const int st = s_stamp[i];
        if (st >= 0) stamp[static_cast<long long>(b) * T + st % T] = st;
      }
    }
    if (scale != nullptr) {
      for (int p = threadIdx.x; p < P; p += kThreads) {
        for (int i = 0; i < S; ++i) {
          const int st = s_stamp[i];
          if (st >= 0)
            scale[(static_cast<long long>(b) * P + p) * T + st % T] =
                stage_scale[(static_cast<long long>(i) * B + b) * P + p];
        }
      }
    }
    for (int i = threadIdx.x; i < S; i += kThreads)
      stage_stamp[static_cast<long long>(i) * B + b] = -1;
    __syncthreads();  // s_stamp is the next stream's
  }
}

int launch(void* cache, int* stamp, const void* stage, int* stage_stamp,
           float* scale, const float* stage_scale, int S, int B, int P, int T,
           long long row_bytes, cudaStream_t stream) {
  static int per_sm = 0;  // resident blocks an SM holds
  if (per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stage_merge_kernel, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) per_sm = 1;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long room = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(B < room ? B : room);
  stage_merge_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<char*>(cache), stamp, static_cast<const char*>(stage),
      stage_stamp, scale, stage_scale, S, B, P, T, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// In place on the current device: cache (B, P, T, X), stamp (B, T) int32,
// stage (S, B, P*X) of the cache's element type, stage_stamp (S, B) int32,
// scale (B, P, T) / stage_scale (S, B, P) float32 or both null; all
// contiguous, cache and stage 16-byte aligned.  row_bytes: X times the
// element size, a multiple of 16.  Returns the launch's cudaError_t.
extern "C" int stage_merge_launch(void* cache, void* stamp, const void* stage,
                                  void* stage_stamp, void* scale,
                                  const void* stage_scale, int S, int B, int P,
                                  int T, long long row_bytes, void* stream) {
  if (S <= 0 || S > kMaxS || B <= 0 || P <= 0 || T <= 0 || row_bytes <= 0 ||
      ((reinterpret_cast<uintptr_t>(cache) |
        reinterpret_cast<uintptr_t>(stage) |
        static_cast<uintptr_t>(row_bytes)) & 15u) != 0 ||
      (scale == nullptr) != (stage_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(cache, static_cast<int*>(stamp), stage,
                static_cast<int*>(stage_stamp), static_cast<float*>(scale),
                static_cast<const float*>(stage_scale), S, B, P, T, row_bytes,
                static_cast<cudaStream_t>(stream));
}
