// One-pass ChannelNorm + ReLU over an NCW activation, for Hopper (sm_90a).
// Hand-written replacement of the TPU kernel `channel_norm_relu`
// (vap_realtime_tpu/ops/pallas/channorm.py:43, body `_kernel`:29).
//
// What it computes, for every column (n, t) of x (N, C, T):
//   mean = s1 / C,  var = max((s2 - C * mean^2) / (C - 1), 0)
//   y    = relu(cast(( x - mean) * rsqrt(var + 1e-5)) * w[c] + b[c])
// with s1, s2 the float32 sum and sum of squares over the C channels (one
// stats pass, unbiased variance, clamped), the normalised value cast to
// the activation dtype BEFORE the affine, and the affine done in the
// activation dtype (each op rounded, as the plain PyTorch version does).
//
// Layout choice: columns in registers.  The reduction runs over C = 256
// channels at stride T, and T is 160, 40, 20, 10 or 5 on the serving
// path.  A block of 256 threads (8 warps) takes 32 consecutive columns of
// the flattened (n, t) index j = n*T + t, one per lane; warp w holds the
// channels c = w, w+8, ..., i.e. C/8 values per thread, in registers.  So
// each element is read once and written once, the whole column never
// leaves the SM, and nothing but the 8 x 32 partial sums passes through
// shared memory.  A warp's load of one channel covers 32 consecutive j:
// one contiguous run when T >= 32, and for T < 32 runs of T elements
// from consecutive n whose neighbouring channel rows are read by the
// other warps at the same time, so each DRAM sector is fetched once into
// L2.  The other simple option, one block per n with a (C, T) tile in
// shared memory, needs 160 KB of shared memory per block at T = 160 in
// float32 (one block per SM) and idles most threads at T = 5.
//
// Bound on the H100 (3.35 TB/s HBM): memory.  One read and one write of
// x: at N = 8192 (B = 4096 stereo streams), bf16, T = 160 that is
// 2 x 671 MB, ~0.40 ms; over the five layers (T = 160, 40, 20, 10, 5)
// 1.97 GB, ~0.59 ms per step.  ~10 FLOPs per element are negligible.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;
constexpr int kCols = 32;  // columns per block, one per lane
constexpr float kEps = 1e-5f;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  // cast(y) * w + b, each op rounded in float32 (no fused multiply-add)
  static __device__ __forceinline__ float affine(float y, float w, float b) {
    return __fadd_rn(__fmul_rn(y, w), b);
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float param(const float* p) { return *p; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  // cast(y) * w + b in bf16: each op computed in float32 and rounded to
  // bf16, as PyTorch's bf16 elementwise ops do
  static __device__ __forceinline__ float affine(float y, float w, float b) {
    const float yb = __bfloat162float(__float2bfloat16_rn(y));
    const float t = __bfloat162float(__float2bfloat16_rn(yb * w));
    return __bfloat162float(__float2bfloat16_rn(t + b));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float param(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

// grid: ceil(N*T / 32) blocks; block: 32 x 8 threads.  kPer = C / 8.
template <typename X, int kPer>
__global__ void __launch_bounds__(kCols * kWarps)
    channel_norm_relu_kernel(const X* __restrict__ x, const X* __restrict__ w,
                             const X* __restrict__ b, X* __restrict__ out,
                             long long NT, int T) {
  constexpr int C = kPer * kWarps;
  __shared__ float red1[kWarps][kCols], red2[kWarps][kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long j = static_cast<long long>(blockIdx.x) * kCols + lane;
  const bool valid = j < NT;
  const long long n = valid ? j / T : 0;
  const long long base = n * C * T + (valid ? j - n * T : 0);

  float v[kPer];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = warp + kWarps * i;
    v[i] = valid ? Elem<X>::load(x + base + static_cast<long long>(c) * T)
                 : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    s1 += v[i];
    s2 = fmaf(v[i], v[i], s2);
  }
  red1[warp][lane] = s1;
  red2[warp][lane] = s2;
  __syncthreads();
  s1 = 0.f;
  s2 = 0.f;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    s1 += red1[k][lane];
    s2 += red2[k][lane];
  }
  if (!valid) return;
  const float mean = __fdiv_rn(s1, static_cast<float>(C));
  const float var = fmaxf(
      __fdiv_rn(__fsub_rn(s2, __fmul_rn(static_cast<float>(C),
                                        __fmul_rn(mean, mean))),
                static_cast<float>(C - 1)),
      0.f);
  const float rstd = rsqrtf(var + kEps);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = warp + kWarps * i;
    const float y = __fmul_rn(__fsub_rn(v[i], mean), rstd);
    const float o = Elem<X>::affine(y, Elem<X>::param(w + c),
                                    Elem<X>::param(b + c));
    Elem<X>::store(out + base + static_cast<long long>(c) * T, fmaxf(o, 0.f));
  }
}

template <typename X>
int launch(const void* x, const void* w, const void* b, void* out, int N,
           int C, int T, cudaStream_t stream) {
  const long long NT = static_cast<long long>(N) * T;
  const unsigned grid = static_cast<unsigned>((NT + kCols - 1) / kCols);
  const X* xp = static_cast<const X*>(x);
  const X* wp = static_cast<const X*>(w);
  const X* bp = static_cast<const X*>(b);
  X* op = static_cast<X*>(out);
  switch (C) {
    case 64:
      channel_norm_relu_kernel<X, 8>
          <<<grid, kCols * kWarps, 0, stream>>>(xp, wp, bp, op, NT, T);
      break;
    case 128:
      channel_norm_relu_kernel<X, 16>
          <<<grid, kCols * kWarps, 0, stream>>>(xp, wp, bp, op, NT, T);
      break;
    case 256:
      channel_norm_relu_kernel<X, 32>
          <<<grid, kCols * kWarps, 0, stream>>>(xp, wp, bp, op, NT, T);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype of x, w, b and out: 0 = float32, 1 = bfloat16.  x, out (N, C, T)
// contiguous; w, b (C,).  C must be 64, 128 or 256.  Returns the launch's
// cudaError_t (0 = success).
extern "C" int channel_norm_relu_launch(int dtype, const void* x,
                                        const void* w, const void* b,
                                        void* out, int N, int C, int T,
                                        void* stream) {
  if (N <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, b, out, N, C, T, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, b, out, N, C, T, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
