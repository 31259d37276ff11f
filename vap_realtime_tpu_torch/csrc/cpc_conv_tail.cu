// The chunked CPC encoder's conv tail, conv1..conv4 each followed by
// ChannelNorm + ReLU, for Hopper (sm_90a).  Hand-written replacement of the
// TPU kernel `cpc_conv_tail` (vap_realtime_tpu/ops/pallas/cpc_conv.py:108,
// body `_tail_kernel`:89 with `_phase_conv`:53 and `_channel_norm_relu`:79).
//
// What it computes, per channel-stream n, on x0 = conv0's normalised and
// ReLU'd output (L0, C = 256), time-major, cast to float32 (bf16 or float32
// in; the weights float32).  For each layer (k, s, p) in ((8,4,2), (4,2,1),
// (4,2,1), (4,2,1)):
//   conv  y[t, u] = b[u] + sum_{i < k} sum_c x[s t + i - p, c] W[i, c, u],
//         x zero outside [0, L), L_out = (L + 2p - k) / s + 1;
//   norm  mean = sum_u y / C,  var = sum_u (y - mean)^2 / (C - 1)  (the
//         centred two-pass variance, no clamp), z = (y - mean) rsqrt(var +
//         1e-5) nw[u] + nb[u], then ReLU — all in float32.
// The activations between layers stay float32; only the last layer's
// output is cast to x0's dtype.  These are the TPU kernel's rounding
// points; the products are float32 on the CUDA cores (no TF32, which
// would miss the 1e-4 float32 contract).
//
// Design (a simple, right first version on the CUDA cores): one block of
// C = 256 threads per channel-stream; thread u owns output channel u of
// every layer and keeps up to kTT = 32 output rows of it in registers.  A
// tap weight W[i, c, u] is read once per row tile (coalesced over u, from
// L2: the 5.2 MB of weights do not fit shared memory) and feeds kTT fused
// multiply-adds; the inputs x[row, c..c+3] are one float4 shared-memory
// read that every lane of the block shares (a broadcast).
// Shared memory (float32):
//   Q  conv1's output (L1 + 2 rows: one zero row each side is conv2's
//      padding), later conv3's output;
//   P  conv1's input tile: the padded rows s t0 - p .. of one kCK = 32
//      channel slice, read from device memory chunk by chunk (conv1's
//      whole input, ~230 KB at 20 Hz in float32, does not fit); then
//      conv2's output (with its zero rows), then conv4's before it is
//      normalised into device memory;
//   the (mean, rstd) of the rows of the current tile.
// At 20 Hz (L0 = 224, L1 = 56) a block takes ~90 KB: two blocks per SM.
// After each row tile the block writes the sums to shared memory, each warp
// reduces rows over the 256 channels (mean, then the centred sum of
// squares), and every thread normalises its channel.
//
// Bound on the H100: operations.  Per channel-stream at L0 = 224: 84.4
// MFLOP (conv1 58.7, conv2-4 14.7, 7.3, 3.7); at 8192 channel-streams 0.69
// TFLOP, 10.3 ms at the 67 TFLOP/s float32 CUDA-core peak.  The bytes
// (x0 1.88 GB in float32, 0.94 GB in bf16; 5.2 MB of weights) take ~0.56 ms.
// The weights stream from L2 once per row tile of each block (~57 GB of L2
// reads per call at 20 Hz); more channel-streams per block, and bf16
// tensor cores for a bf16 input, are the levers a later version has.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kC = 256;   // channels = threads per block
constexpr int kTT = 32;   // output rows per tile (accumulators per thread)
constexpr int kCK = 32;   // conv1 input channels per shared-memory chunk
constexpr int kWarps = kC / 32;

// (kernel, stride, padding) of conv l (0..3 = conv1..conv4), and the
// offset of its first tap in the packed weights
__host__ __device__ constexpr int ker(int l) { return l == 0 ? 8 : 4; }
__host__ __device__ constexpr int str(int l) { return l == 0 ? 4 : 2; }
__host__ __device__ constexpr int pad(int l) { return l == 0 ? 2 : 1; }
__host__ __device__ constexpr int tap0(int l) { return l == 0 ? 0 : 4 + 4 * l; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ constexpr int out_len(int L, int l) {
  return (L + 2 * pad(l) - ker(l)) / str(l) + 1;
}

// The floats of the P region (see the header) for conv1 output length L1.
__host__ __device__ constexpr int p_floats(int L1) {
  return imax(imax((str(0) * (kTT - 1) + ker(0)) * kCK,
                   (out_len(L1, 1) + 2) * kC),
              out_len(out_len(out_len(L1, 1), 2), 3) * kC);
}

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

// acc[t] += sum_{i < k} sum_{c < nc} X[(s t + i) * ld + c] W[tap i, c0 + c, u]
// for t < nt; X points at row 0 of the rows the tile reads, W at column u
// of the layer's first tap.
__device__ __forceinline__ void accumulate(float (&acc)[kTT], int nt,
                                           const float* X, int ld, int s,
                                           int k, int nc, const float* W,
                                           int c0) {
  for (int i = 0; i < k; ++i) {
    const float* wi = W + (static_cast<size_t>(i) * kC + c0) * kC;
#pragma unroll 2
    for (int c = 0; c < nc; c += 4) {
      const float w0 = wi[(c + 0) * kC];
      const float w1 = wi[(c + 1) * kC];
      const float w2 = wi[(c + 2) * kC];
      const float w3 = wi[(c + 3) * kC];
      const float* xr = X + i * ld + c;
#pragma unroll
      for (int t = 0; t < kTT; ++t) {
        if (t < nt) {
          const float4 x = *reinterpret_cast<const float4*>(xr + s * t * ld);
          float a = acc[t];
          a = fmaf(x.x, w0, a);
          a = fmaf(x.y, w1, a);
          a = fmaf(x.z, w2, a);
          a = fmaf(x.w, w3, a);
          acc[t] = a;
        }
      }
    }
  }
}

// ChannelNorm + ReLU of the nt rows Y[t * kC + u] (the tile's conv sums in
// shared memory): each warp reduces rows w, w + 8, ...; then thread u
// normalises its channel of every row into Y, or (out != nullptr) into
// out[t * kC + u] in the output dtype.  Ends with a block barrier.
template <typename O>
__device__ __forceinline__ void norm_relu(float* Y, int nt, float* stats,
                                          float nw, float nb, O* out) {
  const int u = threadIdx.x;
  const int lane = u & 31, w = u >> 5;
  __syncthreads();  // the tile's sums are in Y
  for (int t = w; t < nt; t += kWarps) {
    const float* row = Y + t * kC;
    float v[kC / 32];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kC / 32; ++j) {
      v[j] = row[lane + 32 * j];
      sum += v[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / kC;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < kC / 32; ++j) {
      const float d = v[j] - mean;
      ss = fmaf(d, d, ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) {
      stats[2 * t] = mean;
      stats[2 * t + 1] = 1.f / sqrtf(ss / (kC - 1) + 1e-5f);
    }
  }
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    const float z = fmaxf(
        __fadd_rn(__fmul_rn(__fmul_rn(Y[t * kC + u] - stats[2 * t],
                                      stats[2 * t + 1]),
                            nw),
                  nb),
        0.f);
    if (out != nullptr)
      E<O>::st(out + static_cast<size_t>(t) * kC + u, z);
    else
      Y[t * kC + u] = z;
  }
  __syncthreads();  // Y and stats free for the next tile
}

// One layer l >= 1 over an input X in shared memory (row 0 = the zero row
// before position 0): output rows into Y (row 0 and row L_out + 1 zero), or,
// for the last layer, through `scratch` into out (device memory).
template <typename O>
__device__ void smem_layer(int l, const float* X, int L_in, float* Y,
                           float* scratch, float* stats, const float* W,
                           const float* aux, O* out) {
  const int u = threadIdx.x;
  const int L_out = out_len(L_in, l);
  const float bias = aux[(3 * l) * kC + u];
  const float nw = aux[(3 * l + 1) * kC + u];
  const float nb = aux[(3 * l + 2) * kC + u];
  if (out == nullptr) {  // the zero rows around the output: next padding
    Y[u] = 0.f;
    Y[(L_out + 1) * kC + u] = 0.f;
  }
  for (int t0 = 0; t0 < L_out; t0 += kTT) {
    const int nt = min(kTT, L_out - t0);
    float acc[kTT];
#pragma unroll
    for (int t = 0; t < kTT; ++t) acc[t] = bias;
    accumulate(acc, nt, X + str(l) * t0 * kC, kC, str(l), ker(l), kC,
               W + static_cast<size_t>(tap0(l)) * kC * kC + u, 0);
    float* dst = out == nullptr ? Y + (t0 + 1) * kC : scratch;
#pragma unroll
    for (int t = 0; t < kTT; ++t)
      if (t < nt) dst[t * kC + u] = acc[t];
    norm_relu<O>(dst, nt, stats, nw, nb,
                 out == nullptr ? nullptr : out + static_cast<size_t>(t0) * kC);
  }
}

// grid: one block per channel-stream; block: kC threads.
template <typename T>
__global__ void __launch_bounds__(kC, 2)
    cpc_conv_tail_kernel(const T* __restrict__ x0, const float* __restrict__ W,
                         const float* __restrict__ aux, T* __restrict__ out,
                         int L0) {
  extern __shared__ __align__(16) float smem[];
  const int u = threadIdx.x;
  const int n = blockIdx.x;
  const int L1 = out_len(L0, 0), L2 = out_len(L1, 1), L3 = out_len(L2, 2);
  const int L4 = out_len(L3, 3);
  float* Q = smem;                      // (L1 + 2) x C
  float* Pb = smem + (L1 + 2) * kC;     // p_floats(L1)
  float* stats = Pb + p_floats(L1);     // 2 x kTT
  const T* xn = x0 + static_cast<size_t>(n) * L0 * kC;

  // conv1: row tiles of kTT outputs; the padded input rows of a tile, one
  // kCK-channel slice at a time, staged in P
  {
    const float bias = aux[u];
    const float nw = aux[kC + u];
    const float nb = aux[2 * kC + u];
    Q[u] = 0.f;
    Q[(L1 + 1) * kC + u] = 0.f;
    for (int t0 = 0; t0 < L1; t0 += kTT) {
      const int nt = min(kTT, L1 - t0);
      const int rows = str(0) * (nt - 1) + ker(0);
      const int pos0 = str(0) * t0 - pad(0);
      float acc[kTT];
#pragma unroll
      for (int t = 0; t < kTT; ++t) acc[t] = bias;
      for (int c0 = 0; c0 < kC; c0 += kCK) {
        for (int e = u; e < rows * kCK; e += kC) {
          const int r = e / kCK, c = e % kCK;
          const int pos = pos0 + r;
          Pb[e] = (pos >= 0 && pos < L0)
                      ? E<T>::ld(xn + static_cast<size_t>(pos) * kC + c0 + c)
                      : 0.f;
        }
        __syncthreads();
        accumulate(acc, nt, Pb, kCK, str(0), ker(0), kCK, W + u, c0);
        __syncthreads();  // P free for the next slice
      }
      float* dst = Q + (t0 + 1) * kC;
#pragma unroll
      for (int t = 0; t < kTT; ++t)
        if (t < nt) dst[t * kC + u] = acc[t];
      norm_relu<T>(dst, nt, stats, nw, nb, nullptr);
    }
  }
  smem_layer<T>(1, Q, L1, Pb, nullptr, stats, W, aux, nullptr);  // conv2 -> P
  smem_layer<T>(2, Pb, L2, Q, nullptr, stats, W, aux, nullptr);   // conv3 -> Q
  smem_layer<T>(3, Q, L3, nullptr, Pb, stats, W, aux,
                out + static_cast<size_t>(n) * L4 * kC);          // conv4
}

template <typename T>
int launch(const void* x0, const float* W, const float* aux, void* out,
           int N, int L0, cudaStream_t stream) {
  const int L1 = out_len(L0, 0);
  if (out_len(out_len(out_len(L1, 1), 2), 3) <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      (static_cast<size_t>(L1 + 2) * kC + p_floats(L1) + 2 * kTT) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cpc_conv_tail_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cpc_conv_tail_kernel<T><<<N, kC, bytes, stream>>>(
      static_cast<const T*>(x0), W, aux, static_cast<T*>(out), L0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (x0 and out): 0 = float32, 1 = bfloat16.  x0 (N, L0, 256) and out
// (N, L4, 256) contiguous; W (20, 256, 256) float32, the taps of conv1..4
// in order, each (C_in, C_out); aux (4, 3, 256) float32, per layer the conv
// bias, the norm weight and the norm bias.  Returns the launch's
// cudaError_t (0 = success); a length whose buffers exceed shared memory
// is refused there.
extern "C" int cpc_conv_tail_launch(int dtype, const void* x0, const float* W,
                                    const float* aux, void* out, int N,
                                    int L0, int C, void* stream) {
  if (N <= 0 || C != kC || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(x0, W, aux, out, N, L0, st)
                    : launch<__nv_bfloat16>(x0, W, aux, out, N, L0, st);
}
