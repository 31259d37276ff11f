// Fused short-sequence LSTM scan over precomputed input gates, for Hopper
// (sm_90a).  Hand-written replacement of the TPU kernel `lstm_scan`
// (vap_realtime_tpu/ops/pallas/lstm.py:48, body `_lstm_kernel`:26).
//
// What it computes, per stream n, for t = 0 .. T-1 (T = 5 at 20 Hz):
//   g    = (gi[n, t] + b_hh) + h W_hh^T           (4H gates: i, f, g, o)
//   c    = sigmoid(g_f) c + sigmoid(g_i) tanh(g_g)
//   h    = sigmoid(g_o) tanh(c),  ys[n, t] = h
// with h, c, W_hh^T and every gate in float32; ys is stored in gi's
// dtype, h_T and c_T in h0's (the TPU kernel's rounding points).
//
// Design: one block of H = 256 threads owns kNB = 16 streams for all T
// steps; thread u owns hidden unit u, i.e. gate columns u, H+u, 2H+u, 3H+u
// of every one of its streams, so its four gate sums give it c and h of
// unit u without any exchange.  Each step needs all of h before the next
// product, so h (16 x 256 float32, 16 KB) lives in shared memory and the
// block synchronises twice a step; c stays in registers.  The product
// walks k four at a time: 16 coalesced float32 loads of W_hh^T (4 rows x
// 4 gates, read from L2: the 1 MB matrix does not fit shared memory) feed
// 256 multiply-adds against h[n][k..k+3], which every lane reads as one
// shared-memory broadcast.  W_hh^T is read once per block and step: 2.6 GB
// of L2 reads per call at 8192 streams.
//
// Bound on the H100: operations.  2 * T * B * H * 4H = 21.5 GFLOP at
// B = 8192, T = 5, H = 256: 0.32 ms at the 67 TFLOP/s float32 CUDA-core
// peak; the bytes (gates in, outputs, weights) are ~0.12 GB (0.036 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kH = 256;  // hidden width = threads per block
constexpr int kNB = 16;  // streams per block

template <typename T>
struct E;

template <>
struct E<float> {
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
  static __device__ __forceinline__ void st(float* p, float v) { *p = v; }
};

template <>
struct E<__nv_bfloat16> {
  static __device__ __forceinline__ float ld(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// grid: ceil(B / kNB) blocks; block: kH threads.
template <typename G, typename S>
__global__ void __launch_bounds__(kH)
    lstm_scan_kernel(const G* __restrict__ gi, const S* __restrict__ h0,
                     const S* __restrict__ c0, const float* __restrict__ w,
                     const float* __restrict__ b, G* __restrict__ ys,
                     S* __restrict__ h_out, S* __restrict__ c_out, int B,
                     int T) {
  __shared__ __align__(16) float hs[kNB][kH];
  const int u = threadIdx.x;
  const int n0 = blockIdx.x * kNB;
  constexpr int H4 = 4 * kH;
  float c[kNB];
  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = b[g * kH + u];
#pragma unroll
  for (int n = 0; n < kNB; ++n) {
    const bool ok = n0 + n < B;
    const size_t o = static_cast<size_t>(n0 + n) * kH + u;
    hs[n][u] = ok ? E<S>::ld(h0 + o) : 0.f;
    c[n] = ok ? E<S>::ld(c0 + o) : 0.f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    float acc[kNB][4];
#pragma unroll
    for (int n = 0; n < kNB; ++n)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[n][g] = 0.f;
    for (int k = 0; k < kH; k += 4) {
      float wv[4][4];  // [row k+i][gate]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          wv[i][g] = w[static_cast<size_t>(k + i) * H4 + g * kH + u];
#pragma unroll
      for (int n = 0; n < kNB; ++n) {
        const float4 hv = *reinterpret_cast<const float4*>(&hs[n][k]);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float a = acc[n][g];
          a = fmaf(hv.x, wv[0][g], a);
          a = fmaf(hv.y, wv[1][g], a);
          a = fmaf(hv.z, wv[2][g], a);
          a = fmaf(hv.w, wv[3][g], a);
          acc[n][g] = a;
        }
      }
    }
    __syncthreads();  // every thread has read h_{t-1}
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
      const bool ok = n0 + n < B;
      const size_t row = (static_cast<size_t>(n0 + n) * T + t) * H4;
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float x = ok ? E<G>::ld(gi + row + g * kH + u) : 0.f;
        gate[g] = __fadd_rn(__fadd_rn(x, bias[g]), acc[n][g]);
      }
      const float ig = sigmoid(gate[0]);
      const float fg = sigmoid(gate[1]);
      const float gg = tanhf(gate[2]);
      const float og = sigmoid(gate[3]);
      c[n] = __fadd_rn(__fmul_rn(fg, c[n]), __fmul_rn(ig, gg));
      const float h = __fmul_rn(og, tanhf(c[n]));
      hs[n][u] = h;
      if (ok)
        E<G>::st(ys + (static_cast<size_t>(n0 + n) * T + t) * kH + u, h);
    }
    __syncthreads();  // h_t complete before the next product
  }
#pragma unroll
  for (int n = 0; n < kNB; ++n) {
    if (n0 + n >= B) break;
    const size_t o = static_cast<size_t>(n0 + n) * kH + u;
    E<S>::st(h_out + o, hs[n][u]);
    E<S>::st(c_out + o, c[n]);
  }
}

template <typename G, typename S>
int launch(const void* gi, const void* h0, const void* c0, const float* w,
           const float* b, void* ys, void* h_t, void* c_t, int B, int T,
           cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((B + kNB - 1) / kNB);
  lstm_scan_kernel<G, S><<<grid, kH, 0, stream>>>(
      static_cast<const G*>(gi), static_cast<const S*>(h0),
      static_cast<const S*>(c0), w, b, static_cast<G*>(ys),
      static_cast<S*>(h_t), static_cast<S*>(c_t), B, T);
  return static_cast<int>(cudaGetLastError());
}

template <typename G>
int dispatch(int h_dtype, const void* gi, const void* h0, const void* c0,
             const float* w, const float* b, void* ys, void* h_t, void* c_t,
             int B, int T, cudaStream_t st) {
  return h_dtype == 0
             ? launch<G, float>(gi, h0, c0, w, b, ys, h_t, c_t, B, T, st)
             : launch<G, __nv_bfloat16>(gi, h0, c0, w, b, ys, h_t, c_t, B, T,
                                        st);
}

}  // namespace

// gi_dtype (gi, ys) and h_dtype (h0, c0, h_T, c_T): 0 = float32, 1 =
// bfloat16.  gi (B, T, 4H), h0/c0/h_T/c_T (B, H), w_hh_t (H, 4H) float32,
// b_hh (4H,) float32, ys (B, T, H), all contiguous; H must be 256.
// Returns the launch's cudaError_t (0 = success).
extern "C" int lstm_scan_launch(int gi_dtype, int h_dtype, const void* gi,
                                const void* h0, const void* c0,
                                const float* w_hh_t, const float* b_hh,
                                void* ys, void* h_t, void* c_t, int B, int T,
                                int H, void* stream) {
  if (B <= 0 || T <= 0 || H != kH || (gi_dtype != 0 && gi_dtype != 1) ||
      (h_dtype != 0 && h_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return gi_dtype == 0 ? dispatch<float>(h_dtype, gi, h0, c0, w_hh_t, b_hh,
                                         ys, h_t, c_t, B, T, st)
                       : dispatch<__nv_bfloat16>(h_dtype, gi, h0, c0, w_hh_t,
                                                 b_hh, ys, h_t, c_t, B, T, st);
}
