// The chunked CPC encoder's conv tail, conv1..conv4 each followed by
// ChannelNorm + ReLU, for Hopper (sm_90a), on the tensor cores in 3xTF32.
// Hand-written replacement of the TPU kernel `cpc_conv_tail`
// (vap_realtime_tpu/ops/pallas/cpc_conv.py:108, body `_tail_kernel`:89
// with `_phase_conv`:53 and `_channel_norm_relu`:79).
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
// The activations between layers stay float32 (in device memory); only
// the last layer's output is cast to x0's dtype.  These are the TPU
// kernel's rounding points.  The products run on the tensor cores in
// 3xTF32 (tf32_mma.cuh): three TF32 MMAs per k step give float32 accuracy
// (a single TF32 pass misses the 1e-4 float32 contract by ~25x).  With a
// bf16 x0, conv1's A operand is exact in TF32 and its lo pass is skipped.
//
// Design: one launch per layer, each an implicit GEMM with M = (channel-
// stream, output row), N = C = 256 output channels, K = k * 256.  A block
// of 256 threads (8 warps) takes a tile of at most 128 rows over the full
// N, so bias + ChannelNorm + ReLU is local to the block: a row's 256
// channels lie in its 8 warps' registers (warp w owns columns 32 w .. +32,
// all row tiles: up to 8 x 4 m16n8 accumulator tiles, 128 floats a lane)
// and are reduced across them in shared memory.  Tiles hold whole
// channel-streams, so the zero padding stays per stream: G = 128 / L_out
// streams a tile (at 20 Hz 2, 4, 8, 16 streams of 56, 28, 14, 7 rows: 112
// rows, 7 row tiles, in every layer); a longer stream is cut into chunks
// of at most 128 rows (127 in conv1); a ragged last group is masked.
// The input is staged 32 channels at a time, with cp.async, as the TPU
// kernel's phase planes: plane j of a stream holds its padded rows s a + j,
// so tap i = s a_i + j_i reads plane j_i from row t + a_i on: a
// contiguous row block, no gather and no im2col in memory.  The input
// slices are double-buffered and the (tap, 32 channels, 256) weight
// slices (32 KB) go through a ring of 2-4 slots (as many as shared memory
// holds beside the input: 4 for a bf16 x0 and for conv2-4 at 20 Hz, 2 for
// a float32 x0's conv1), each issued as one cp.async group ahead of the
// MMAs that read it; one barrier per (slice, tap).  (The ring's depth
// gained nothing measurable, but with a bf16 x0 this loop measured 11.1
// ms against 14.7 for the same kernel with a two-buffer loop that issues
// the next copy under a branch, chip_smoke.py's timing in two calls on
// the H100: ptxas schedules the two differently.)  Within an MMA k step
// of 8 channels, logical k = q takes channel 2 q and k = q + 4 channel
// 2 q + 1, and the wrapper stores the weights with input channels in
// pairs, so a lane's A and B fragment pairs are one 8-byte load each;
// staged rows are padded to 40 elements and weight pair rows to 520
// floats, which keeps those loads free of bank conflicts.  mma.sync
// fragments are loaded row by row, so a tap's row offset a_i in {0, 1}
// costs nothing (a swizzled wgmma descriptor would need 8-row
// alignment).  At 20 Hz a block takes 201-208 KB: one block of 8 warps
// per SM.
//
// Bound on the H100: operations.  Per channel-stream at L0 = 224: 84.4
// MFLOP (conv1 58.7, conv2-4 14.7, 7.3, 3.7); at 8192 channel-streams 0.69
// TFLOP: 10.3 ms at the 67 TFLOP/s float32 CUDA-core peak; as 3xTF32
// 2.07 TFLOP of TF32, 4.19 ms at 495 TFLOP/s (bf16 x0: conv1 in two
// passes, 3.22 ms); mma.sync does not reach that peak, wgmma does.  The
// bytes (x0 1.88 GB in float32, 0.94 GB in bf16; the float32
// intermediates ~1.6 GB written and read; 5.2 MB of weights) take
// ~0.5-1 ms.  The weights stream from L2 once per 112-row tile: ~12 GB
// of L2 reads per call (the CUDA-core version read ~57 GB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

#include "tf32_mma.cuh"

constexpr int kC = 256;        // channels
constexpr int kThreads = 256;  // 8 warps, 32 output channels each
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 128;  // output rows per tile
constexpr int kMaxMT = kMaxRows / 16;
constexpr int kCK = 32;        // input channels per staged slice
constexpr int kXLd = kCK + 8;  // staged row stride (elements)
constexpr int kWLd = 2 * kC + 8;  // weight slice channel-pair row stride
constexpr int kMaxIn = 512;    // staged input rows per slice, all planes
constexpr int kMaxStages = 4;  // weight slices in flight
constexpr size_t kSmemMax = 232448;  // a block's shared memory on sm_90
constexpr size_t kWSlice = (kCK / 2) * kWLd * sizeof(float);

// (kernel, stride, padding) of conv l (0..3 = conv1..conv4), and the
// offset of its first tap in the packed weights
__host__ __device__ constexpr int ker(int l) { return l == 0 ? 8 : 4; }
__host__ __device__ constexpr int str(int l) { return l == 0 ? 4 : 2; }
__host__ __device__ constexpr int pad(int l) { return l == 0 ? 2 : 1; }
__host__ __device__ constexpr int tap0(int l) {
  return l == 0 ? 0 : 4 + 4 * l;
}

__host__ __device__ constexpr int out_len(int L, int l) {
  return (L + 2 * pad(l) - ker(l)) / str(l) + 1;
}

// The tiling of one layer: G streams of MTr rows (or one chunk of MTr
// rows of one stream), R rows per phase plane; `stages` weight slices in
// the ring (as many as shared memory holds beside the input slices).
struct Tiling {
  int MTr, chunks, G, R, tiles, stages;
};

// bytes of the input region: two staged slices, or the epilogue's sums
template <typename In>
__host__ __device__ size_t x_bytes(int in_rows) {
  const size_t x = 2 * static_cast<size_t>(in_rows) * kXLd * sizeof(In);
  const size_t red = 2 * kWarps * kMaxRows * sizeof(float);
  return x > red ? x : red;
}

template <typename In>
Tiling tiling(int N, int L_out, int K, int S) {
  Tiling t;
  const int extra = (K + S - 1) / S - 1;  // plane rows past the outputs
  const int most = kMaxIn / S - extra < kMaxRows ? kMaxIn / S - extra
                                                 : kMaxRows;
  t.MTr = L_out < most ? L_out : most;
  t.chunks = (L_out + t.MTr - 1) / t.MTr;
  t.R = t.MTr + extra;
  t.G = 1;
  if (t.chunks == 1) {
    const int by_rows = kMaxRows / t.MTr, by_smem = kMaxIn / (S * t.R);
    t.G = by_rows < by_smem ? by_rows : by_smem;
    if (t.G < 1) t.G = 1;
  }
  t.tiles = t.chunks == 1 ? (N + t.G - 1) / t.G : N * t.chunks;
  const size_t fit = (kSmemMax - x_bytes<In>(t.G * S * t.R)) / kWSlice;
  t.stages = fit < kMaxStages ? static_cast<int>(fit) : kMaxStages;
  return t;
}

// Two consecutive elements of a staged row as floats (one 8- or 4-byte
// shared-memory load).
__device__ __forceinline__ void ld_pair(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void ld_pair(const __nv_bfloat16* p, float& a,
                                        float& b) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  a = __uint_as_float(v << 16);
  b = __uint_as_float(v & 0xffff0000u);
}

// One layer: y = ReLU(ChannelNorm(conv(x) + b)) for the tile blockIdx.x.
// x (N, L_in, C) In; W (K, C / 2, C, 2) float32 tap-major, input channels
// in pairs (W[i, c / 2, u, c % 2] is tap i from input channel c to output
// u); aux (3, C) float32: the conv bias, the norm weight, the norm bias;
// y (N, L_out, C) Out.  Within each MMA k step of 8 channels, logical k =
// q takes channel 2 q and k = q + 4 channel 2 q + 1, so a lane's A and B
// fragment pairs are one shared-memory load each.
template <typename In, typename Out, int K, int S, int P>
__global__ void __launch_bounds__(kThreads, 1)
    conv_norm_kernel(const In* __restrict__ x, const float* __restrict__ W,
                     const float* __restrict__ aux, Out* __restrict__ y,
                     int N, int L_in, int L_out, Tiling tl) {
  constexpr bool kExact = sizeof(In) == 2;  // bf16 A: lo = 0
  constexpr int XLD = kXLd;
  constexpr int kCPR = kCK * sizeof(In) / 16;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int in_rows = tl.G * S * tl.R;
  In* xbuf = reinterpret_cast<In*>(smem_raw);  // [2][in_rows][XLD]
  // the weight ring [stages][kCK / 2][kWLd], channel pairs of each slice
  float* wbuf = reinterpret_cast<float*>(smem_raw + x_bytes<In>(in_rows));
  float* red = reinterpret_cast<float*>(smem_raw);  // after the main loop

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  int s0, t0;  // first stream and first output row of the tile
  if (tl.chunks == 1) {
    s0 = blockIdx.x * tl.G;
    t0 = 0;
  } else {
    s0 = blockIdx.x / tl.chunks;
    t0 = (blockIdx.x % tl.chunks) * tl.MTr;
  }
  const int M = tl.G * tl.MTr;
  const int n_mt = (M + 15) / 16;

  // shared-memory offset of output row m's plane-0 row (the tap adds its
  // plane and row offset); rows past M read row 0 and are not stored
  int roff[kMaxMT][2];
#pragma unroll
  for (int mt = 0; mt < kMaxMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * mt + g + 8 * h;
      roff[mt][h] =
          m < M ? ((m / tl.MTr) * S * tl.R + m % tl.MTr) * XLD : 0;
    }

  // input slice cs (channels 32 cs .. +32) of every plane row -> buffer
  auto stage_x = [&](int cs) {
    In* dst0 = xbuf + (cs & 1) * in_rows * XLD;
    for (int e = tid; e < in_rows * kCPR; e += kThreads) {
      const int row = e / kCPR, ch = e % kCPR;
      const int gs = row / (S * tl.R), rem = row % (S * tl.R);
      const int j = rem / tl.R, a = rem % tl.R;
      const int pos = S * (t0 + a) + j - P;  // input row (padded: zero)
      const int n = s0 + gs;
      In* dst = dst0 + row * XLD + ch * (16 / sizeof(In));
      if (n < N && pos >= 0 && pos < L_in)
        cp_async16(dst, x + (static_cast<size_t>(n) * L_in + pos) * kC +
                            kCK * cs + ch * (16 / sizeof(In)));
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // weight slice it = (cs, tap) = (it / K, it % K) -> ring slot
  auto stage_w = [&](int it) {
    const float* src = W + (static_cast<size_t>(it % K) * kC +
                            kCK * (it / K)) * kC;
    float* dst = wbuf + (it % tl.stages) * (kCK / 2) * kWLd;
    for (int e = tid; e < kCK * kC / 4; e += kThreads) {
      const int r = e / (kC / 2), c4 = 4 * (e % (kC / 2));
      cp_async16(dst + r * kWLd + c4, src + r * 2 * kC + c4);
    }
  };

  float acc[kMaxMT][4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const float b0 = __ldg(aux + 32 * w + 8 * nt + 2 * q);
    const float b1 = __ldg(aux + 32 * w + 8 * nt + 2 * q + 1);
#pragma unroll
    for (int mt = 0; mt < kMaxMT; ++mt) {
      acc[mt][nt][0] = acc[mt][nt][2] = b0;
      acc[mt][nt][1] = acc[mt][nt][3] = b1;
    }
  }

  // iteration it = (slice cs, tap): cp.async group it holds weight slice
  // it and, where it % K == 0, input slice cs; it is issued D = stages - 1
  // iterations ahead, into the ring slot that iteration it - 1 read
  constexpr int n_it = (kC / kCK) * K;
  const int D = tl.stages - 1;
  auto issue = [&](int j) {
    if (j < n_it) {
      if (j % K == 0) stage_x(j / K);
      stage_w(j);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  for (int j = 0; j < D; ++j) issue(j);
#pragma unroll 1
  for (int it = 0; it < n_it; ++it) {
    if (D >= 3)
      cp_async_wait<2>();
    else if (D == 2)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // group it landed; every warp is done with it - 1
    issue(it + D);
    const int cs = it / K, tap = it % K;
    const In* xs = xbuf + (cs & 1) * in_rows * XLD +
                   ((tap % S) * tl.R + tap / S) * XLD + 2 * q;
    const float* ws = wbuf + (it % tl.stages) * (kCK / 2) * kWLd +
                      q * kWLd + 2 * (32 * w + g);
#pragma unroll
    for (int kk = 0; kk < kCK / 8; ++kk) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float b0, b1;
        ld_pair(ws + 4 * kk * kWLd + 16 * nt, b0, b1);
        split_tf32(b0, bh[nt][0], bl[nt][0]);
        split_tf32(b1, bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < kMaxMT; ++mt) {
        if (mt < n_mt) {
          float v[4];
          ld_pair(xs + roff[mt][0] + 8 * kk, v[0], v[2]);
          ld_pair(xs + roff[mt][1] + 8 * kk, v[1], v[3]);
          uint32_t ah[4], al[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (kExact) {
              ah[r] = __float_as_uint(v[r]);
              al[r] = 0u;
            } else {
              split_tf32(v[r], ah[r], al[r]);
            }
          }
          mma_3xtf32<kExact>(acc[mt], ah, al, bh, bl);
        }
      }
    }
  }

  // ChannelNorm + ReLU: row sums over the lane's 8 columns, its quad, then
  // the 8 warps through shared memory; mean first, then the centred sum
  __syncthreads();  // every warp is done with the staged slices
  float* red_s = red;                        // [kWarps][kMaxRows]
  float* red_q = red + kWarps * kMaxRows;    // [kWarps][kMaxRows]
  float mean[kMaxMT][2], rstd[kMaxMT][2];
#pragma unroll
  for (int mt = 0; mt < kMaxMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        s += acc[mt][nt][2 * h] + acc[mt][nt][2 * h + 1];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (q == 0 && mt < n_mt) red_s[w * kMaxRows + 16 * mt + g + 8 * h] = s;
    }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < kMaxMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
      if (mt < n_mt)
#pragma unroll
        for (int v = 0; v < kWarps; ++v)
          s += red_s[v * kMaxRows + 16 * mt + g + 8 * h];
      mean[mt][h] = s / kC;
      float ss = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = acc[mt][nt][2 * h + e] - mean[mt][h];
          ss = fmaf(d, d, ss);
        }
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      if (q == 0 && mt < n_mt) red_q[w * kMaxRows + 16 * mt + g + 8 * h] = ss;
    }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < kMaxMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ss = 0.f;
      if (mt < n_mt)
#pragma unroll
        for (int v = 0; v < kWarps; ++v)
          ss += red_q[v * kMaxRows + 16 * mt + g + 8 * h];
      rstd[mt][h] = 1.f / sqrtf(ss / (kC - 1) + 1e-5f);
    }
  float nw[4][2], nb[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      nw[nt][e] = __ldg(aux + kC + 32 * w + 8 * nt + 2 * q + e);
      nb[nt][e] = __ldg(aux + 2 * kC + 32 * w + 8 * nt + 2 * q + e);
    }
#pragma unroll
  for (int mt = 0; mt < kMaxMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * mt + g + 8 * h;
      if (mt >= n_mt || m >= M) continue;
      const int n = s0 + m / tl.MTr, t = t0 + m % tl.MTr;
      if (n >= N || t >= L_out) continue;
      Out* yr = y + (static_cast<size_t>(n) * L_out + t) * kC + 32 * w + 2 * q;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float z[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          z[e] = fmaxf(
              __fadd_rn(__fmul_rn(__fmul_rn(acc[mt][nt][2 * h + e] -
                                                mean[mt][h],
                                            rstd[mt][h]),
                                  nw[nt][e]),
                        nb[nt][e]),
              0.f);
        E<Out>::st(yr + 8 * nt, z[0]);
        E<Out>::st(yr + 8 * nt + 1, z[1]);
      }
    }
}

template <typename In, typename Out, int L>
int launch_layer(const In* x, const float* W, const float* aux, Out* y,
                 int N, int L_in, cudaStream_t stream) {
  constexpr int K = ker(L), S = str(L), P = pad(L);
  const int L_out = out_len(L_in, L);
  const Tiling tl = tiling<In>(N, L_out, K, S);
  if (tl.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      x_bytes<In>(tl.G * S * tl.R) + tl.stages * kWSlice;
  auto kernel = conv_norm_kernel<In, Out, K, S, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<tl.tiles, kThreads, bytes, stream>>>(x, W, aux, y, N, L_in, L_out,
                                                tl);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x0, const float* W, const float* aux, void* out,
           float* y1, float* y2, float* y3, int N, int L0,
           cudaStream_t st) {
  const int L1 = out_len(L0, 0), L2 = out_len(L1, 1), L3 = out_len(L2, 2);
  if (out_len(L3, 3) <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int rc = launch_layer<T, float, 0>(static_cast<const T*>(x0), W, aux, y1,
                                     N, L0, st);
  if (rc == 0)
    rc = launch_layer<float, float, 1>(y1, W + tap0(1) * kC * kC, aux + 3 * kC,
                                       y2, N, L1, st);
  if (rc == 0)
    rc = launch_layer<float, float, 2>(y2, W + tap0(2) * kC * kC,
                                       aux + 6 * kC, y3, N, L2, st);
  if (rc == 0)
    rc = launch_layer<float, T, 3>(y3, W + tap0(3) * kC * kC, aux + 9 * kC,
                                   static_cast<T*>(out), N, L3, st);
  return rc;
}

}  // namespace

// dtype (x0 and out): 0 = float32, 1 = bfloat16.  x0 (N, L0, 256) and out
// (N, L4, 256) contiguous; W (20, 256, 256) float32, the taps of conv1..4
// in order, each (C_in, C_out); aux (4, 3, 256) float32, per layer the conv
// bias, the norm weight and the norm bias; y1, y2, y3 float32 scratch for
// the outputs of conv1..3, (N, L_l, 256).  Four launches on `stream`.
// Returns the first failing launch's cudaError_t (0 = success).
extern "C" int cpc_conv_tail_launch(int dtype, const void* x0, const float* W,
                                    const float* aux, void* out, float* y1,
                                    float* y2, float* y3, int N, int L0,
                                    int C, void* stream) {
  if (N <= 0 || C != kC || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch<float>(x0, W, aux, out, y1, y2, y3, N, L0, st)
             : launch<__nv_bfloat16>(x0, W, aux, out, y1, y2, y3, N, L0, st);
}
