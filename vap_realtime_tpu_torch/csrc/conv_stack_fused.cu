// The whole streaming CPC conv stack (conv0..conv4, each followed by
// ChannelNorm + ReLU), for Hopper (sm_90a).  Hand-written replacement of
// the TPU kernel `conv_stack_fused_call`
// (vap_realtime_tpu/ops/pallas/encoder.py:291, bodies `_kernel`:190 and
// `_kernel_v3`:89; its modes are VMEM layouts of this one function).
//
// What it computes, per channel-stream n, on one frame's L fresh samples:
//   xc0 = [c0 (5 carried samples) | new (L)];  T0 = L / 5
//   conv0: y[t] = sum_j xc0[5t + j] w0[j, :] + b0          (k 10, s 5)
//   conv1-4 (k = 2s; s = 4, 2, 2, 2): x = [carry (k-s rows) | previous
//     output], channels-last (T_in, 256); y[t] = sum_{j<k} x[st + j] W_j + b
//     = xm[t] W[0] + xm[t+1] W[1] over the stride blocks xm[t] = x rows
//     [st, st + s) laid end to end (the TPU kernel's two stride-block
//     matmuls); T_out = T_in / s - 1 = 40, 20, 10, 5 at L = 800
//   after each conv (`_cnorm_relu`, encoder.py:76): float32 sum and sum of
//     squares over the 256 channels, var = max((s2 - n mean^2)/(n-1), 0),
//     (y - mean) * rsqrt(var + 1e-5) in float32, cast to the activation
//     dtype BEFORE the affine, the affine rounded op by op in that dtype
//     (multiply, then add), ReLU.
//   new carries: the last 5 samples of xc0 and the last k-s rows of each
//     layer's input, in the activation dtype; output z = conv4's (5, 256).
// Products are of activation-dtype values, accumulated in float32 with a
// float32 bias (so bf16 results are MORE precise than the cuDNN `conv`
// path, which rounds every conv output to bf16).
//
// bf16 body: five launches a call.
//   conv0 (K = 10, 0.8 of the ~61 MFLOP a channel-stream) is a
//     statistics pass: per 16 output rows of a stream, a (16 x 16) .
//     (16 x 256) product on mma.sync m16n8k16 (samples as A, taps 10-15
//     zero), 8 columns at a time, 32 rows a warp task, gives each row's
//     float32 sums, and the row's ChannelNorm (mean, rstd) goes to a (N,
//     T0) float2 buffer: 8 bytes a row where the normalised bf16 row
//     would be 512.  It also
//     writes the new c0, the new c1 (the last 4 rows, normalised: the
//     product taken a second time) and the carries c2-c4 into the first
//     rows of X2-X4.  A lane holds 8 accumulators, not 128; 32 warps an
//     SM hide the products' latency.
//   conv1's input X1 = [c1 | conv0 rows] (N, T0 + 4, 256) never exists in
//     device memory: conv1's producer warpgroup builds its A stages from
//     the samples (below), with the same mma.sync product, the stored
//     (mean, rstd) and the same roundings, so their values are X1's, bit
//     for bit.
//   conv1-4: one launch each of an implicit GEMM on wgmma.  Its M runs
//     over the stride-block rows of ALL channel-streams at once: X_l is
//     (N, T_in, 256) contiguous, i.e. the (N (T_out + 1), s 256) matrix xm
//     of stride blocks, so output row m = xm[m] W[0] + xm[m + 1] W[1] for
//     every m; the row m = n (T_out + 1) + T_out, which straddles streams
//     n and n + 1, is junk and is dropped by the epilogue (1 row in
//     T_out + 1: 2.4% of conv1's work at L = 800).  A tile computes 128
//     such rows over all 256 output channels: two consumer warpgroups of
//     64 rows each, so every weight tile staged in shared memory serves
//     128 rows, whatever the stream boundaries; only the launch's last
//     tile is ragged (its rows past the end read as zeros; the epilogue
//     masks them).  The A tile of k slice [k0, k0 + 64) is the box of xm
//     at (column k0 mod s 256, row m0 + (k0 >= s 256)).  For conv2-4 it is
//     a TMA 2-D tensor map over xm, so the one-row offset of W[1]'s half
//     costs nothing.
//   conv1 (`conv_layer_kernel<true>`) builds its A instead.  Built row r
//     of X1 row block cb (0..3) is X1 row 4 m + cb of xm row m = m0 + r;
//     with T1 + 1 stride blocks a stream, m is stream n = m / (T1 + 1)'s
//     block tm = m mod (T1 + 1), so the row is c1 row cb (tm = 0) or
//     conv0 row 4 (tm - 1) + cb: per 16 rows a (16 x 16) . (16 x 64)
//     slice of conv0's product, normalised with the rows' stored (mean,
//     rstd).  conv1 runs its K slices in the order (W[0], c), (W[1], c)
//     for c = 0 .. 15 (the TMA body: all of W[0]'s, then W[1]'s), so the
//     64 columns c of the 128 built rows, held in registers, fill W[0]'s
//     stage as they are and W[1]'s one row up: each X1 value is built
//     once, not twice.  W[1]'s stage then lacks xm row m0 + 128 (its last
//     row is zero), so conv1's tiles keep 127 of their 128 rows.  The
//     other order of conv1's float32 sums moves z and c2-c4 by a bf16
//     rounding here and there against the TMA body (max |d| 2^-5 at
//     (83,968, 3,200), 2.7% of z; c0 and c1 bit-equal; PERF.md §6).
//     The producer warpgroup's four warps build 32 rows each (the next
//     row block's loads in flight while they build this one, the
//     products of 4 column blocks issued together) and store them with
//     stmatrix in the swizzle TMA would, then arrive on the stage's full
//     barrier (after fence.proxy.async: wgmma reads through the async
//     proxy).
//   The weights go in as W^T (256, 2 s 256), K-major, through a second
//     map.  Both land 128-byte swizzled; wgmma m64n256k16 reads them
//     through shared-memory descriptors.  A third warpgroup (one thread
//     for conv2-4; for conv1 four warps, with the weights loaded by
//     consumer thread 0 two slices ahead) keeps a ring of 3 stages (16 KB
//     of A + 32 KB of W each) in flight against full / empty mbarriers,
//     whose waiters sleep rather than spin; blocks are persistent (one
//     per SM, walking the tiles), so the producer runs ahead into the
//     next tile while the consumers finish the epilogue.  setmaxnreg
//     gives the consumers 232 registers a thread and the producer's
//     warpgroup 40 (conv1: 168 each).
//   Epilogue in registers: a warpgroup's m64n256 accumulator gives thread
//     (warp w, lane l) rows 16w + l/4 and + 8, columns 8i + 2(l%4) + {0, 1}
//     (i < 32): a row's 256 values lie in the 4 lanes of one quad, so the
//     ChannelNorm sums are 64 in-thread adds and two shfl_xor steps: no
//     shared-memory exchange and no barrier.  The bf16 rows go through
//     the warp's own 16-row slice of shared memory and leave as one
//     512-byte bulk asynchronous copy each (cp.async.bulk), to the next
//     layer's input (after its 2 carry rows) or z, and the last two rows
//     of a stream to the new carry too.
//   Between the launches the activations go through device memory once:
//     conv0's statistics are 1.3 KB a channel-stream at L = 800 (10.5 MB
//     at N = 8192, where X1 was 84 KB and 688 MB), X2-X4 21, 11 and 6 KB:
//     ~40 KB of scratch a channel-stream in all (~123 KB with X1).
//   L2 -> SM weight traffic per call: one 2 s 256 x 256 bf16 weight matrix
//     per tile: ceil(N (T_out + 1) / rows) tiles a layer (rows 127 for
//     conv1, 128 after), 4.05 GB at N = 8192, L = 800 (conv1 2.77 GB,
//     conv2 0.70, conv3 0.37, conv4 0.20), where the one-block-per-stream
//     body this replaced read all 2.6 MB of weights per channel-stream,
//     ~21 GB.
//   On the H100 (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase
//     (k7bits), N = 8192, L = 800): 1.23 ms a call (1.32 while X1 was
//     stored): conv0 0.12 ms (0.35, most of it the 688 MB of X1 it
//     wrote), conv1 0.76 (0.62 reading X1 by TMA; 0.51 with the A build
//     taken out, tools/k7_ablate.py zero_a_build), conv2-4 0.17, 0.10,
//     0.05.  The A warps bound conv1: per 64-column slice (clock64 in
//     the kernel) ~1,000 cycles of products and normalising, ~300 of row
//     loads, ~300 of stores and fences, against ~1,000 of wgmma; at the
//     5 Hz cell's (83,968, 3,200) a frame takes 47.7 ms (53.0).  Each
//     GEMM's epilogue runs while the tensor cores wait (~0.21 ms over
//     conv1-4).
// float32 body: one block of 256 threads (8 warps) per channel-stream, on
//   the CUDA cores (no TF32).  The activations never leave shared memory:
//   the samples, buffer A (conv1's input, 164 x 256 floats at L = 800;
//   later conv3's) and buffer B (conv2's, later conv4's).  conv0: thread c
//   computes output channel c of every row from the shared samples (a
//   sliding window of 10 in registers); conv1-4: thread c owns output
//   channel c over chunks of RT rows (RT divides T_out), streaming its
//   weight column from L2 and reading the RT input rows as 4-element
//   vectors the warp shares.  The epilogue has thread c hold column c of
//   a chunk: warp butterflies plus an 8-warp exchange through shared
//   memory give each row's (mean, rstd).  168 KB of buffer A limit it to
//   T1 <= 40 rows (L <= 800 at 20 Hz).
//
// Bound on the H100: operations.  ~63.6 MFLOP per channel-stream in the
// TPU kernel's stride-block form (61.2 in this direct form), 0.50 TFLOP
// per call at 8192 channel-streams: 0.51 ms at the 989 TFLOP/s bf16
// tensor-core peak (7.5 ms at the 67 TFLOP/s float32 CUDA-core peak for
// float32).  The bytes (waveform, carries, output, weights) are ~0.13 GB.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 256;            // channels
constexpr int kWarps = kC / 32;    // float32 body: one thread per channel
constexpr int kK0 = 10, kS0 = 5;   // conv0 kernel and stride
constexpr int kMaxT1 = 80;         // most conv1 rows per stream a call takes
constexpr int kMaxRT = 40;         // float32 body: most rows per chunk
constexpr float kEps = 1e-5f;

// Output rows of each layer for conv0 length T0 (-1: invalid).
struct Lens {
  int T0, T1, T2, T3, T4;
};

__host__ __device__ inline Lens lens_of(int T0) {
  Lens l{T0, -1, -1, -1, -1};
  int T = T0;
  const int ks[4][2] = {{8, 4}, {4, 2}, {4, 2}, {4, 2}};
  int* out[4] = {&l.T1, &l.T2, &l.T3, &l.T4};
  for (int i = 0; i < 4; ++i) {
    const int T_in = T + ks[i][0] - ks[i][1];
    if (T_in % ks[i][1] != 0) return Lens{T0, -1, -1, -1, -1};
    T = T_in / ks[i][1] - 1;
    *out[i] = T;
  }
  return l;
}

__host__ __device__ inline size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// (mean, rstd) of a row of kC values from their float32 sum and sum of
// squares: the unbiased variance, clamped at 0.
__device__ __forceinline__ void row_stats(float s1, float s2, float& mean,
                                          float& rstd) {
  const float n = static_cast<float>(kC);
  mean = __fmul_rn(s1, 1.f / kC);  // exact: kC is a power of two
  const float var = fmaxf(
      __fdiv_rn(__fsub_rn(s2, __fmul_rn(__fmul_rn(n, mean), mean)), n - 1.f),
      0.f);
  rstd = __frsqrt_rn(__fadd_rn(var, kEps));
}

// ---------------------------------------------------------------------
// float32 body: one block per channel-stream, CUDA cores.

// Shared memory (bytes): samples, buffer A (conv1's and conv3's input),
// buffer B (conv2's and conv4's), the reductions' two parities.
struct Layout {
  size_t a, b, red, total;
};

// Floats of one parity of the reduction scratch: the warps' partial sums
// and sums of squares of each row, then each row's (mean, rstd).
constexpr int kRedFloats = (2 * kWarps + 2) * kMaxRT;

__host__ __device__ inline Layout layout_of(int T0) {
  const Lens l = lens_of(T0);
  const size_t row = kC * sizeof(float);
  Layout s;
  s.a = align128((static_cast<size_t>(T0) * kS0 + kS0) * sizeof(float));
  s.b = s.a + align128(imax(T0 + 4, l.T2 + 2) * row);
  s.red = s.b + align128(imax(l.T1 + 2, l.T3 + 2) * row);
  s.total = s.red + 2 * kRedFloats * sizeof(float);
  return s;
}

struct F32Args {
  const float* x_new;  // (B, L) fresh samples
  const float* c[5];   // carries in: c0 (B, 5), c1 (B, 4, C), c2-c4 (B, 2, C)
  const float* w[5];   // w0 (10, C); w1..w4 (k*C, C): tap j rows [jC, (j+1)C)
  const float* aux;    // (15, C): per layer [bias, norm w, norm b]
  float* z;            // (B, T4, C)
  float* n[5];         // carries out, shaped as c
  int B, L;
};

// Sum over the 32 lanes of each of the R values.
template <int R>
__device__ __forceinline__ void warp_sums(float* v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] += __shfl_xor_sync(0xffffffffu, v[r], o);
}

// Bias + ChannelNorm + ReLU of RT complete output rows (thread c holds
// column c of each in acc), written to out rows [0, RT) (row stride C).
// red: this chunk's parity of the reduction scratch.
template <int RT>
__device__ __forceinline__ void epilogue(float* acc, const float* aux_row,
                                         float* out, float* red) {
  static_assert(RT <= kMaxRT, "chunk longer than the reduction scratch");
  const int col = threadIdx.x;
  const int lane = col & 31, warp = col >> 5;
  const float bias = aux_row[col];
  const float nw = aux_row[kC + col];
  const float nb = aux_row[2 * kC + col];
  float s1[RT], s2[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    acc[r] = __fadd_rn(acc[r], bias);
    s1[r] = acc[r];
    s2[r] = __fmul_rn(acc[r], acc[r]);
  }
  warp_sums<RT>(s1);
  warp_sums<RT>(s2);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      red[warp * kMaxRT + r] = s1[r];
      red[(kWarps + warp) * kMaxRT + r] = s2[r];
    }
  }
  __syncthreads();
  // warp w finishes the statistics of rows w, w + 8, ...: lanes 0-7 hold
  // the 8 warps' partial sums; lane 0 stores (mean, rstd) once per row
  float* stats = red + 2 * kWarps * kMaxRT;
  for (int r = warp; r < RT; r += kWarps) {
    float t1 = lane < kWarps ? red[lane * kMaxRT + r] : 0.f;
    float t2 = lane < kWarps ? red[(kWarps + lane) * kMaxRT + r] : 0.f;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) {
      t1 += __shfl_xor_sync(0xffffffffu, t1, o);
      t2 += __shfl_xor_sync(0xffffffffu, t2, o);
    }
    if (lane == 0) row_stats(t1, t2, stats[2 * r], stats[2 * r + 1]);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const float y = __fmul_rn(__fsub_rn(acc[r], stats[2 * r]),
                              stats[2 * r + 1]);
    out[static_cast<size_t>(r) * kC + col] =
        fmaxf(__fadd_rn(__fmul_rn(y, nw), nb), 0.f);
  }
}

// conv0 over chunks of RT rows: samples xs (T0*5 + 5) -> out rows.  Row t
// reads samples [5t, 5t + 10): the thread keeps that window in registers
// and loads only the 5 new samples of each row.
template <int RT>
__device__ void conv0_f32(const float* xs, int T0, const float* __restrict__ w0,
                          const float* aux, float* out, float* red,
                          int& parity) {
  const int col = threadIdx.x;
  float w[kK0];
#pragma unroll
  for (int j = 0; j < kK0; ++j) w[j] = w0[j * kC + col];
  for (int r0 = 0; r0 < T0; r0 += RT) {
    float acc[RT], win[kK0];
#pragma unroll
    for (int j = 0; j < kS0; ++j) win[j] = xs[r0 * kS0 + j];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float* p = xs + (r0 + r + 1) * kS0;
#pragma unroll
      for (int j = 0; j < kS0; ++j) win[kS0 + j] = p[j];
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < kK0; ++j) a = fmaf(win[j], w[j], a);
      acc[r] = a;
#pragma unroll
      for (int j = 0; j < kS0; ++j) win[j] = win[kS0 + j];
    }
    epilogue<RT>(acc, aux, out + static_cast<size_t>(r0) * kC,
                 red + parity * kRedFloats);
    parity ^= 1;
  }
}

// conv with kernel k = 2s over a channels-last input (rows of C): output
// row t = sum_{j<k} in[s t + j] . W_j, in chunks of RT rows.
template <int RT>
__device__ void conv_tail(const float* in, int s, int k, int T_out,
                          const float* __restrict__ W, const float* aux,
                          float* out, float* red, int& parity) {
  const int col = threadIdx.x;
  const int K = k * kC;
  const size_t rs = static_cast<size_t>(s) * kC;  // input stride of a row
  for (int r0 = 0; r0 < T_out; r0 += RT) {
    const float* a = in + r0 * rs;
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.f;
    for (int kk = 0; kk < K; kk += 4) {
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = W[static_cast<size_t>(kk + i) * kC + col];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(a + r * rs + kk);
        acc[r] = fmaf(x.x, w[0], acc[r]);
        acc[r] = fmaf(x.y, w[1], acc[r]);
        acc[r] = fmaf(x.z, w[2], acc[r]);
        acc[r] = fmaf(x.w, w[3], acc[r]);
      }
    }
    epilogue<RT>(acc, aux, out + static_cast<size_t>(r0) * kC,
                 red + parity * kRedFloats);
    parity ^= 1;
  }
}

// One tail layer, with chunks of the largest of 40, 20, 10, 5, 4, 1 rows
// dividing T_out.
__device__ void conv_any(const float* in, int s, int k, int T_out,
                         const float* W, const float* aux, float* out,
                         float* red, int& parity) {
  if (T_out % 40 == 0)
    conv_tail<40>(in, s, k, T_out, W, aux, out, red, parity);
  else if (T_out % 20 == 0)
    conv_tail<20>(in, s, k, T_out, W, aux, out, red, parity);
  else if (T_out % 10 == 0)
    conv_tail<10>(in, s, k, T_out, W, aux, out, red, parity);
  else if (T_out % 5 == 0)
    conv_tail<5>(in, s, k, T_out, W, aux, out, red, parity);
  else if (T_out % 4 == 0)
    conv_tail<4>(in, s, k, T_out, W, aux, out, red, parity);
  else
    conv_tail<1>(in, s, k, T_out, W, aux, out, red, parity);
}

__device__ void conv0_any(const float* xs, int T0, const float* w0,
                          const float* aux, float* out, float* red,
                          int& parity) {
  if (T0 % 40 == 0)
    conv0_f32<40>(xs, T0, w0, aux, out, red, parity);
  else if (T0 % 10 == 0)
    conv0_f32<10>(xs, T0, w0, aux, out, red, parity);
  else if (T0 % 4 == 0)
    conv0_f32<4>(xs, T0, w0, aux, out, red, parity);
  else
    conv0_f32<1>(xs, T0, w0, aux, out, red, parity);
}

// Copy `rows` rows of C (thread c: column c) between row-major buffers.
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int rows) {
  for (int r = 0; r < rows; ++r)
    dst[static_cast<size_t>(r) * kC + threadIdx.x] =
        src[static_cast<size_t>(r) * kC + threadIdx.x];
}

// grid: B blocks (one channel-stream each); block: 256 threads.
__global__ void __launch_bounds__(kC, 1) f32_stack_kernel(const F32Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = blockIdx.x;
  const int L = a.L;
  const int T0 = L / kS0;
  const Lens ln = lens_of(T0);
  const Layout lay = layout_of(T0);
  float* xs = reinterpret_cast<float*>(smem);
  float* bufA = reinterpret_cast<float*>(smem + lay.a);
  float* bufB = reinterpret_cast<float*>(smem + lay.b);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  const size_t C = kC;
  int parity = 0;

  // samples [c0 | new]; the carries fill the first k - s rows of each
  // layer's input
  const float* xn = a.x_new + static_cast<size_t>(n) * L;
  for (int i = threadIdx.x; i < L + kS0; i += kC)
    xs[i] = i < kS0 ? a.c[0][n * kS0 + i] : xn[i - kS0];
  copy_rows(bufA, a.c[1] + n * 4 * C, 4);
  copy_rows(bufB, a.c[2] + n * 2 * C, 2);
  __syncthreads();
  if (threadIdx.x < kS0) a.n[0][n * kS0 + threadIdx.x] = xs[L + threadIdx.x];

  conv0_any(xs, T0, a.w[0], a.aux, bufA + 4 * C, red, parity);
  __syncthreads();
  copy_rows(a.n[1] + n * 4 * C, bufA + T0 * C, 4);
  conv_any(bufA, 4, 8, ln.T1, a.w[1], a.aux + 3 * C, bufB + 2 * C, red,
           parity);
  __syncthreads();
  copy_rows(a.n[2] + n * 2 * C, bufB + ln.T1 * C, 2);
  copy_rows(bufA, a.c[3] + n * 2 * C, 2);
  __syncthreads();
  conv_any(bufB, 2, 4, ln.T2, a.w[2], a.aux + 6 * C, bufA + 2 * C, red,
           parity);
  __syncthreads();
  copy_rows(a.n[3] + n * 2 * C, bufA + ln.T2 * C, 2);
  copy_rows(bufB, a.c[4] + n * 2 * C, 2);
  __syncthreads();
  conv_any(bufA, 2, 4, ln.T3, a.w[3], a.aux + 9 * C, bufB + 2 * C, red,
           parity);
  __syncthreads();
  copy_rows(a.n[4] + n * 2 * C, bufB + ln.T3 * C, 2);
  conv_any(bufB, 2, 4, ln.T4, a.w[4], a.aux + 12 * C,
           a.z + static_cast<size_t>(n) * ln.T4 * C, red, parity);
}

// ---------------------------------------------------------------------
// bf16 body: conv0 on mma.sync, conv1-4 implicit GEMMs on wgmma.

constexpr int kBM = 128;            // GEMM rows a tile: 2 warpgroups x 64
constexpr int kBK = 64;             // K of a stage: one 128-byte swizzle row
constexpr int kStages = 3;          // ring depth
constexpr int kConsumers = 256;     // two warpgroups
constexpr int kGemmThreads = kConsumers + 128;  // + the producer warpgroup
constexpr uint32_t kABytes = kBM * kBK * sizeof(bf16);  // 16 KB
constexpr uint32_t kWBytes = kC * kBK * sizeof(bf16);   // 32 KB
// a staged output row (bf16): 528 bytes put the 8 rows a warp's store
// instruction touches on distinct banks
constexpr int kOutLd = kC + 8;
constexpr uint32_t kOutBytes = kBM * kOutLd * sizeof(bf16);  // 66 KB

// conv0's operands in shared memory, for its own pass and for conv1's A
// build: the (10, C) weight as mma.sync B fragments ([n tile][lane]; taps
// 10-15 zero), its bias, and its norm w and b as bf16 pairs (the affine's
// operands, rounded as norm_rows16 rounds them).
struct Conv0Smem {
  uint2 sb[32][32];
  float bias[kC];
  uint2 wb[kC / 2];  // {norm w, norm b} of columns 2 p and 2 p + 1
};

// + conv0's operands (conv1 only), the layer's bias and norm parameters,
// the barriers, a row conv1's A warps drop, the alignment
constexpr size_t kGemmSmem = kStages * (kABytes + kWBytes) + kOutBytes +
                             sizeof(Conv0Smem) + 3 * kC * sizeof(float) +
                             2 * kStages * sizeof(uint64_t) + 128 + 1024;
static_assert(kGemmSmem <= 232448, "more than a block's shared memory");
constexpr int kConv0Warps = 4;      // conv0: warps a block
constexpr int kConv0Rows = 32;      // conv0: rows a warp's task
constexpr int kConv0Blocks = 8;     // conv0: blocks an SM (64 registers)

struct Conv0Args {
  const bf16* x_new;  // (N, L)
  const bf16* c[5];   // carries in
  const bf16* w0;     // (10, C)
  const float* aux;   // conv0's bias, norm w, norm b (3, C)
  float2* stats;      // (N, T0): each conv0 row's (mean, rstd)
  bf16* x[3];         // layer inputs X2-X4 (N, T + 2, C)
  bf16* n0;           // (N, 5)
  bf16* n1;           // (N, 4, C)
  int N, L, T0, T1, T2, T3;
};

// What conv1's producer builds its A stages from.
struct Conv1In {
  const bf16* x_new;    // (N, L)
  const bf16* c0;       // (N, 5) carry in
  const bf16* c1;       // (N, 4, C) carry in: X1's first 4 rows
  const float2* stats;  // (N, T0) from conv0_kernel
  const bf16* w0;       // (10, C)
  const float* aux;     // conv0's bias, norm w, norm b (3, C)
  int L, T0;
};

// Two bf16 in one 32-bit word (lo in the low half).
__device__ __forceinline__ uint32_t pack_bits(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// Conv0Smem from the (10, C) weight and conv0's aux rows, by all threads
// of the block (the caller synchronises).  Fragment [i][lane] holds, for
// column 8 i + lane / 4, taps 2 q and 2 q + 1 (q = lane % 4) and, for
// q = 0, taps 8 and 9.
__device__ __forceinline__ void load_conv0(Conv0Smem& s, const bf16* w0,
                                           const float* aux) {
  const uint16_t* w = reinterpret_cast<const uint16_t*>(w0);
  for (int e = threadIdx.x; e < 32 * 32; e += blockDim.x) {
    const int i = e >> 5, l = e & 31, q = l & 3, col = 8 * i + (l >> 2);
    s.sb[i][l] = make_uint2(
        pack_bits(w[2 * q * kC + col], w[(2 * q + 1) * kC + col]),
        q == 0 ? pack_bits(w[8 * kC + col], w[9 * kC + col]) : 0u);
  }
  for (int c = threadIdx.x; c < kC; c += blockDim.x) s.bias[c] = aux[c];
  for (int p = threadIdx.x; p < kC / 2; p += blockDim.x) {
    const __nv_bfloat162 wv =
        __floats2bfloat162_rn(aux[kC + 2 * p], aux[kC + 2 * p + 1]);
    const __nv_bfloat162 bv =
        __floats2bfloat162_rn(aux[2 * kC + 2 * p], aux[2 * kC + 2 * p + 1]);
    s.wb[p] = make_uint2(*reinterpret_cast<const uint32_t*>(&wv),
                         *reinterpret_cast<const uint32_t*>(&bv));
  }
}

// Sample j of a stream's xc0 = [c0 (5) | new], as bits.
__device__ __forceinline__ uint16_t sample(const bf16* c0, const bf16* xn,
                                           int j) {
  return *reinterpret_cast<const uint16_t*>(j < kS0 ? c0 + j : xn + j - kS0);
}

// The A fragment words of one conv0 row t on mma.sync m16n8k16 for lane
// quad position q: samples 5 t + 2 q and + 1 of xc0 (lo) and, for q = 0,
// 5 t + 8 and + 9 (hi); taps 10-15 are zero.
__device__ __forceinline__ void conv0_frag(const bf16* c0, const bf16* xn,
                                           int t, int q, uint32_t& lo,
                                           uint32_t& hi) {
  const int j = kS0 * t;
  lo = pack_bits(sample(c0, xn, j + 2 * q), sample(c0, xn, j + 2 * q + 1));
  hi = q == 0 ? pack_bits(sample(c0, xn, j + 8), sample(c0, xn, j + 9)) : 0u;
}

// The normalised pair (y0, y1) of a row with (mean, rstd) through the
// affine (w2, b2: packed bf16) and ReLU, as two packed bf16: the cast to
// bf16 before the affine, then a bf16 multiply and a bf16 add, each
// rounded to nearest on its own (.rn: never contracted into one fma).
// float32 has more than twice bf16's bits, so each equals the float32
// operation rounded to bf16, as the plain version computes them.
__device__ __forceinline__ uint32_t norm_affine_relu2(float y0, float y1,
                                                      float mean, float rstd,
                                                      uint32_t w2,
                                                      uint32_t b2) {
  const __nv_bfloat162 v =
      __floats2bfloat162_rn(__fmul_rn(__fsub_rn(y0, mean), rstd),
                            __fmul_rn(__fsub_rn(y1, mean), rstd));
  uint32_t o = *reinterpret_cast<const uint32_t*>(&v);
  asm("mul.rn.bf16x2 %0, %0, %1;\n"
      "add.rn.bf16x2 %0, %0, %2;\n"
      "max.bf16x2 %0, %0, %3;\n"
      : "+r"(o)
      : "r"(w2), "r"(b2), "r"(0u));
  return o;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Bulk asynchronous copy of `bytes` (a multiple of 16) from shared to
// global memory, in this thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// Wait until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Wait until this thread's bulk stores have completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The 16 rows staged in `stage` go out as one 512-byte bulk copy each,
// lane rr issuing row rr's to where rows(rr, dst, car) says (and to the
// carry too if car; null: dropped); the warp goes on without waiting for
// them.  Before it writes `stage` again, a warp calls bulk_wait_read().
template <class Rows>
__device__ __forceinline__ void flush_rows16(const bf16* stage,
                                             const Rows& rows) {
  const int lane = threadIdx.x & 31;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane < 16) {
    bf16* dst;
    bf16* car;
    rows(lane, dst, car);
    const bf16* src = stage + lane * kOutLd;
    if (dst != nullptr) bulk_store(dst, src, kC * sizeof(bf16));
    if (car != nullptr) bulk_store(car, src, kC * sizeof(bf16));
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// Bias + ChannelNorm + ReLU of the 16 rows a warp holds in the m16n8
// accumulator layout (that of wgmma m64n256 too, a warp's quarter of it):
// d[4i + {0, 1}] is row lane / 4, columns 8i + 2 (lane % 4) + {0, 1};
// d[4i + {2, 3}] row lane / 4 + 8.  A row's 256 values lie in the 4 lanes
// of one quad: its sums are 64 adds and two shfl_xor steps.  The bf16
// rows are staged in the warp's own 16 x kOutLd slice of shared memory
// and leave through flush_rows16.  The caller waits for the copies
// (bulk_wait) before it exits.
// aux: bias, norm w, norm b (3, C) float32, in shared memory.
template <class Rows>
__device__ __forceinline__ void norm_rows16(float* d, const float* aux,
                                            bf16* stage, const Rows& rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, cq = 2 * (lane & 3);
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float2 b = *reinterpret_cast<const float2*>(aux + 8 * i + cq);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float& y0 = d[4 * i + 2 * h];
      float& y1 = d[4 * i + 2 * h + 1];
      y0 = __fadd_rn(y0, b.x);
      y1 = __fadd_rn(y1, b.y);
      s1[h] += y0 + y1;
      s2[h] += __fmul_rn(y0, y0) + __fmul_rn(y1, y1);
    }
  }
  float mean[2], rstd[2];
  bulk_wait_read();  // the slice's previous rows have gone out
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], o);
      s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], o);
    }
    row_stats(s1[h], s2[h], mean[h], rstd[h]);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = 8 * i + cq;
    const float2 w = *reinterpret_cast<const float2*>(aux + kC + c);
    const float2 b = *reinterpret_cast<const float2*>(aux + 2 * kC + c);
    const __nv_bfloat162 wv = __floats2bfloat162_rn(w.x, w.y);
    const __nv_bfloat162 bv = __floats2bfloat162_rn(b.x, b.y);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * h) * kOutLd + c) =
          norm_affine_relu2(d[4 * i + 2 * h], d[4 * i + 2 * h + 1], mean[h],
                            rstd[h], *reinterpret_cast<const uint32_t*>(&wv),
                            *reinterpret_cast<const uint32_t*>(&bv));
  }
  flush_rows16(stage, rows);
}

// One m16n8k16 product on the tensor cores: c = A B (bf16 fragments,
// float32 accumulators from zero).
__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint2 b) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.x), "r"(b.y));
}

// conv0 as a (16 x 16) . (16 x 256) product per 16 output rows on
// mma.sync m16n8k16 (bf16 in, float32 accumulators): row r of A is
// samples xc0[5 (t0 + r) + k], k < 10, zero for k >= 10; B the (10, C)
// weight, zero rows 10-15, its fragments in shared memory.  Each warp
// takes tasks (stream n, rows t0 .. t0 + 31: two 16-row groups, each B
// fragment read once for both) in turn; the warp of a stream's first
// task also copies the carries c2..c4 in (rows 0-1 of X2..X4) and writes
// the new c0.  A task takes the products 8 columns at a time for the
// rows' float32 sums, and stores each row's (mean, rstd); the stream's
// last task takes them again to normalise its last 4 rows, the new c1.
// A lane holds 8 accumulators instead of 128, and with no staging buffer
// 8 blocks of 4 warps fit an SM.
__global__ void __launch_bounds__(kConv0Warps * 32, kConv0Blocks)
    conv0_kernel(const Conv0Args a) {
  __shared__ Conv0Smem s0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, cq = 2 * q;
  load_conv0(s0, a.w0, a.aux);
  __syncthreads();
  const int per = a.T0 / kConv0Rows;  // T0 is a multiple of 32 (lens_of)
  const int tasks = a.N * per;
  for (int task = blockIdx.x * kConv0Warps + warp; task < tasks;
       task += gridDim.x * kConv0Warps) {
    const int n = task / per, t0 = kConv0Rows * (task - n * per);
    const bf16* xn = a.x_new + static_cast<size_t>(n) * a.L;
    const bf16* cz = a.c[0] + static_cast<size_t>(n) * kS0;
    if (t0 == 0) {
      const int rows_in[3] = {a.T1 + 2, a.T2 + 2, a.T3 + 2};
      const int kv = kC / 8;  // 16-byte words a row
      for (int i = lane; i < 6 * kv; i += 32) {
        const int row = i / kv, l = row / 2, r = row % 2, cw = 8 * (i % kv);
        const uint4 v = *reinterpret_cast<const uint4*>(
            a.c[l + 2] + (static_cast<size_t>(n) * 2 + r) * kC + cw);
        *reinterpret_cast<uint4*>(
            a.x[l] + (static_cast<size_t>(n) * rows_in[l] + r) * kC + cw) = v;
      }
      if (lane < kS0) a.n0[n * kS0 + lane] = xn[a.L - kS0 + lane];
    }
    uint32_t f[2][4];  // per 16-row group: rows g, g + 8
#pragma unroll
    for (int rg = 0; rg < 2; ++rg) {
      conv0_frag(cz, xn, t0 + 16 * rg + g, q, f[rg][0], f[rg][2]);
      conv0_frag(cz, xn, t0 + 16 * rg + g + 8, q, f[rg][1], f[rg][3]);
    }
    // the float32 sums of y = A B + b over each row's 256 channels
    float s1[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float s2[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const uint2 wf = s0.sb[i][lane];
      const float2 b = *reinterpret_cast<const float2*>(s0.bias + 8 * i + cq);
#pragma unroll
      for (int rg = 0; rg < 2; ++rg) {
        float c[4];
        mma16816(c, f[rg][0], f[rg][1], f[rg][2], f[rg][3], wf);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y0 = __fadd_rn(c[2 * h], b.x);
          const float y1 = __fadd_rn(c[2 * h + 1], b.y);
          s1[rg][h] += y0 + y1;
          s2[rg][h] += __fmul_rn(y0, y0) + __fmul_rn(y1, y1);
        }
      }
    }
    float mean[2][2], rstd[2][2];
#pragma unroll
    for (int rg = 0; rg < 2; ++rg)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          s1[rg][h] += __shfl_xor_sync(0xffffffffu, s1[rg][h], o);
          s2[rg][h] += __shfl_xor_sync(0xffffffffu, s2[rg][h], o);
        }
        row_stats(s1[rg][h], s2[rg][h], mean[rg][h], rstd[rg][h]);
        if (q == 0)
          a.stats[static_cast<size_t>(n) * a.T0 + t0 + 16 * rg + g + 8 * h] =
              make_float2(mean[rg][h], rstd[rg][h]);
      }
    if (t0 + kConv0Rows < a.T0) continue;
    // the stream's last 4 rows (28-31 of its last task: row group 1, h =
    // 1, g >= 4): the same products again, normalised, to the new c1
    bf16* c1row = a.n1 + (static_cast<size_t>(n) * 4 + g - 4) * kC;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float c[4];
      mma16816(c, f[1][0], f[1][1], f[1][2], f[1][3], s0.sb[i][lane]);
      const int col = 8 * i + cq;
      const float2 b = *reinterpret_cast<const float2*>(s0.bias + col);
      if (g >= 4)
        *reinterpret_cast<uint32_t*>(c1row + col) = norm_affine_relu2(
            __fadd_rn(c[2], b.x), __fadd_rn(c[3], b.y), mean[1][1],
            rstd[1][1], s0.wb[col >> 1].x, s0.wb[col >> 1].y);
    }
  }
}

// What A warp w needs to build its kRG row groups (16 rows each:
// tile rows 16 (kRG w + rg) + [0, 16)) of X1 row block cb for four 64-column
// blocks (cc = 0, 64, 128, 192): tile row r is X1 row 4 m + cb of xm row
// m = m0 + r.  Stream n = m / (T1 + 1)'s stride block tm = m mod (T1 + 1)
// holds c1's 4 rows (tm = 0) or conv0 rows 4 (tm - 1) .. + 3; rows m >= M
// are zeros, as TMA fills them.  Per row group the lane holds rows g and
// g + 8 (hh): the conv0 product's A fragments, the rows' stored (mean,
// rstd) and their kind (1: conv0 row; 0: zeros; < 0: -1 - its c1 row n 4
// + cb).  Loaded once for the four blocks, so their latency is paid once.
constexpr int kAWarps = 4;                   // conv1: the warps that build A
constexpr int kRG = kBM / 16 / kAWarps;      // row groups an A warp

struct A1Rows {
  uint32_t f[kRG][4];
  float mean[kRG][2], rstd[kRG][2];
  int kind[kRG][2];
  // the lane's c1 row, or null: one at most, as T1 + 1 (odd, > 3) divides
  // none of the gaps 8, 16, 24 between the lane's rows
  const bf16* c1;
  bool patch;      // some lane of the warp holds a c1 or a zero row
};

// A1Rows' loads in flight: issued a group ahead of their use, so that
// their latency passes while the A warp works on the group before.
struct A1Raw {
  uint16_t s[kRG][2][4];  // samples 5 t + 2 q, + 1, 5 t + 8, + 9
  float2 ms[kRG][2];      // the rows' (mean, rstd)
  int kind[kRG][2];
};

__device__ __forceinline__ void issue_a1_rows(A1Raw& r, const Conv1In& b,
                                              int m0, int cb, int M, int w) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int blocks = b.T0 / 4 + 1;
#pragma unroll
  for (int rg = 0; rg < kRG; ++rg)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + 16 * (kRG * w + rg) + g + 8 * hh;
      const int n = m / blocks, tm = m - n * blocks;
      const int kind = m >= M ? 0 : tm == 0 ? -1 - (4 * n + cb) : 1;
      // a zero or c1 row reads conv0 row 0 of stream 0 and drops it
      const int nn = kind == 1 ? n : 0;
      const int t = kind == 1 ? 4 * (tm - 1) + cb : 0;
      const bf16* cz = b.c0 + nn * kS0;
      const bf16* xn = b.x_new + static_cast<size_t>(nn) * b.L;
      const int js[4] = {kS0 * t + 2 * q, kS0 * t + 2 * q + 1, kS0 * t + 8,
                         kS0 * t + 9};  // of xc0 = [c0 | new]
#pragma unroll
      for (int k = 0; k < 4; ++k) r.s[rg][hh][k] = sample(cz, xn, js[k]);
      r.ms[rg][hh] = b.stats[static_cast<size_t>(nn) * b.T0 + t];
      r.kind[rg][hh] = kind;
    }
}

__device__ __forceinline__ void finish_a1_rows(A1Rows& a, const A1Raw& r,
                                               const Conv1In& b) {
  const int q = threadIdx.x & 3;
  bool patch = false;
  a.c1 = nullptr;
#pragma unroll
  for (int rg = 0; rg < kRG; ++rg)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kind = r.kind[rg][hh];
      const uint16_t* sm = r.s[rg][hh];
      a.f[rg][hh] = kind == 1 ? pack_bits(sm[0], sm[1]) : 0u;
      a.f[rg][hh + 2] = kind == 1 && q == 0 ? pack_bits(sm[2], sm[3]) : 0u;
      a.mean[rg][hh] = r.ms[rg][hh].x;
      a.rstd[rg][hh] = r.ms[rg][hh].y;
      a.kind[rg][hh] = kind;
      patch = patch || kind <= 0;
      if (kind < 0) a.c1 = b.c1 + static_cast<size_t>(-1 - kind) * kC;
    }
  a.patch = __any_sync(0xffffffffu, patch);
  // the c1 row's 512 bytes into L1 now, not at its first read
  if (a.c1 != nullptr)
#pragma unroll
    for (int l = 0; l < 4; ++l)
      asm volatile("prefetch.global.L1 [%0];\n" ::"l"(a.c1 + 64 * l));
}

// A warp w's rows of conv1's A tile for channels [cc, cc + 64) of
// X1 row block cb (A1Rows: which rows), as packed bf16 pairs in registers
// (v[i][rg][hh]: row 16 (kRG w + rg) + g + 8 hh, columns cc + 8 i + 2 q
// and + 1): a conv0 row is conv0_kernel's product on the same fragments,
// 8 columns at a time, normalised with its stored (mean, rstd) as
// norm_rows16 does: X1's value, bit for bit; a c1 row its c1 values;
// rows past the last stream zeros.  The operands are read from shared
// memory at once and the products issued together, so one warp on each
// SM sub-partition pays each latency once, not once a product.
struct A1Out {
  uint32_t v[8][kRG][2];
};
constexpr int kBatch = 4;  // column blocks whose products issue together

__device__ __forceinline__ void build_conv1_a(A1Out& o, const A1Rows& a,
                                              const Conv0Smem& s0, int cc) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  // the lane's c1 values, read first: used at the end
  uint32_t cv[8];
  if (a.c1 != nullptr)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      cv[i] = *reinterpret_cast<const uint32_t*>(a.c1 + cc + 8 * i + 2 * q);
#pragma unroll
  for (int i0 = 0; i0 < 8; i0 += kBatch) {  // kBatch column blocks at once
    uint2 wf[kBatch], wb[kBatch];
    float2 bias[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int col = cc + 8 * (i0 + j) + 2 * q;
      wf[j] = s0.sb[(cc >> 3) + i0 + j][lane];
      wb[j] = s0.wb[col >> 1];
      bias[j] = *reinterpret_cast<const float2*>(s0.bias + col);
    }
    float c[kBatch][kRG][4];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int rg = 0; rg < kRG; ++rg)
        mma16816(c[j][rg], a.f[rg][0], a.f[rg][1], a.f[rg][2], a.f[rg][3],
                 wf[j]);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int rg = 0; rg < kRG; ++rg)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          o.v[i0 + j][rg][hh] = norm_affine_relu2(
              __fadd_rn(c[j][rg][2 * hh], bias[j].x),
              __fadd_rn(c[j][rg][2 * hh + 1], bias[j].y), a.mean[rg][hh],
              a.rstd[rg][hh], wb[j].x, wb[j].y);
  }
  // c1's rows (a stream's first stride block: one row in T1 + 1) and the
  // rows past the last stream
  if (a.patch)
#pragma unroll
    for (int rg = 0; rg < kRG; ++rg)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (a.kind[rg][hh] <= 0)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            o.v[i][rg][hh] = a.kind[rg][hh] < 0 ? cv[i] : 0u;
}

// Four 8 x 8 bf16 matrices from the mma fragment layout (lane l: row l /
// 4, columns 2 (l % 4) and + 1 of each, one register a matrix) to shared
// memory, lane l giving the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void stmatrix_x4(uint32_t row_addr, uint32_t m0,
                                            uint32_t m1, uint32_t m2,
                                            uint32_t m3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(row_addr),
      "r"(m0), "r"(m1), "r"(m2), "r"(m3)
      : "memory");
}

// The built rows into A stage `sa`, `shift` rows up (0: the W[0] slice,
// stage row r = xm row m0 + r; 1: the W[1] slice, stage row r = xm row m0
// + 1 + r, its last row zero: it feeds only the tile's dropped row kBM -
// 1; the row shifted out goes to `spill`, 16 bytes x 8).  Each 16-byte
// chunk i of row r lands where TMA's 128-byte swizzle puts it, at chunk
// i ^ (r mod 8) (the stage is 1024-byte aligned): one stmatrix.x4 stores
// two column blocks of a row group's 16 rows.
__device__ __forceinline__ void store_conv1_a(bf16* sa, const A1Out& o,
                                              int w, int shift,
                                              unsigned char* spill) {
  const int lane = threadIdx.x & 31, j = lane >> 3;  // j: lane's matrix
  const uint32_t base = smem_u32(sa);
#pragma unroll
  for (int rg = 0; rg < kRG; ++rg) {
    const int r = 16 * (kRG * w + rg) + (lane & 7) + 8 * (j & 1) - shift;
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      const int ij = i + (j >> 1);
      const uint32_t addr = r >= 0 ? base + r * 128 + ((ij ^ (r & 7)) << 4)
                                   : smem_u32(spill) + 16 * (lane & 7);
      stmatrix_x4(addr, o.v[i][rg][0], o.v[i][rg][1], o.v[i + 1][rg][0],
                  o.v[i + 1][rg][1]);
    }
  }
  if (shift > 0 && w == kAWarps - 1 && lane < 8)
    reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(sa) +
                             (kBM - 1) * 128)[lane] = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ void mbar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

// Wait until the phase of parity `parity` of barrier b has completed; a
// waiting thread sleeps (up to kSuspendNs a try) instead of spinning, so
// it leaves its sub-partition's issue slots to the warps that work.
constexpr uint32_t kSuspendNs = 1000000;
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t addr = smem_u32(b);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity), "r"(kSuspendNs)
        : "memory");
  } while (!done);
}

// TMA: the box of `map` at (column x, row y) into dst, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x),
      "r"(y)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile whose rows are 64 bf16
// (128 bytes) with the 128-byte swizzle: 8-row groups 1024 bytes apart.
// The tile starts on a 1024-byte boundary; +2 per 16 columns of K.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, float32) += A (64 x 16) . B (16 x 256), both bf16 from
// shared memory.
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da,
                                                 uint64_t db,
                                                 uint32_t scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

struct Layer {
  int M;             // stride-block rows of all streams: N (T_out + 1)
  int T_out;         // valid output rows per stream
  int K;             // 2 s C
  int half;          // s C: K of one stride block
  int rows;          // output rows a tile: kBM, or kBM - 1 for conv1
  int tiles;         // ceil(M / rows)
  const float* aux;  // the layer's bias, norm w, norm b (3, C)
  bf16* out;         // (N, T_out + cn, C): the next input, or z (cn = 0)
  int cn;            // carry rows leading each stream in out
  bf16* carry;       // (N, 2, C) new carry (the last 2 rows), or null
};

// Output row m0 + rr of a layer: where it goes (null: a junk, ragged or
// dropped row), and to the new carry if it is one of a stream's last 2.
struct GemmRows {
  bf16* out;
  bf16* carry;
  int end, T_out, cn, m0;  // end: min(M, the tile's first row + its rows)
  __device__ __forceinline__ void operator()(int rr, bf16*& dst,
                                             bf16*& car) const {
    const int r = m0 + rr;
    dst = car = nullptr;
    if (r >= end) return;
    const int n = r / (T_out + 1), t = r - n * (T_out + 1);
    if (t == T_out) return;  // straddles streams n and n + 1
    dst = out + (static_cast<size_t>(n) * (T_out + cn) + cn + t) * kC;
    if (carry != nullptr && t >= T_out - 2)
      car = carry + (static_cast<size_t>(n) * 2 + t - (T_out - 2)) * kC;
  }
};

// One tail layer as an implicit GEMM: out rows = ReLU(ChannelNorm(xm[m]
// W[0] + xm[m + 1] W[1] + b)).  mapA: xm (M rows of s C bf16), box 64 x
// 128 (conv2-4); kBuildA (conv1): the A stages are built from `in` by
// build_conv1_a instead.  mapW: W^T (C rows of 2 s C), box 64 x 256.
// Persistent: block b takes tiles b, b + gridDim.x, ...  Warpgroups 0 and
// 1 consume (rows 0-63 and 64-127 of a tile, all 256 columns: 128
// accumulators a thread); warpgroup 2 produces: its first thread issues
// the TMA loads; with kBuildA its four warps build A, one on each SM
// sub-partition, and consumer thread 0 loads the weights (load_w).
// setmaxnreg moves the producer's registers to the
// consumers (40 / 232 of the 168 a thread of 384 gets at launch); ptxas
// allocates every thread's code within those 168 all the same (a wgmma
// m64n256 alone takes 154), so the A warps keep them.
template <bool kBuildA>
__global__ void __launch_bounds__(kGemmThreads, 1)
    conv_layer_kernel(const __grid_constant__ CUtensorMap mapA,
                      const __grid_constant__ CUtensorMap mapW,
                      const Layer a, const Conv1In in) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned by pointer arithmetic, not through an integer, so
  // the compiler still knows every access below is to shared memory
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sW = reinterpret_cast<bf16*>(smem + kStages * kABytes);
  bf16* sOut = reinterpret_cast<bf16*>(smem + kStages * (kABytes + kWBytes));
  Conv0Smem* s0 = reinterpret_cast<Conv0Smem*>(
      smem + kStages * (kABytes + kWBytes) + kOutBytes);
  float* sAux = reinterpret_cast<float*>(s0 + 1);
  uint64_t* full = reinterpret_cast<uint64_t*>(sAux + 3 * kC);
  uint64_t* empty = full + kStages;
  unsigned char* spill = reinterpret_cast<unsigned char*>(empty + kStages);
  const int slices = a.K / kBK;
  for (int i = threadIdx.x; i < 3 * kC; i += blockDim.x) sAux[i] = a.aux[i];
  if (kBuildA) load_conv0(*s0, in.w0, in.aux);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the TMA issuer's arrival (+ the bytes), and each A warp's
      mbar_init(&full[s], kBuildA ? 1 + kAWarps : 1);
      mbar_init(&empty[s], kConsumers / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup(s)
    if (!kBuildA)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pw = (threadIdx.x - kConsumers) >> 5;
    if (kBuildA) {
      // conv1's K slices in the order (W[0], c), (W[1], c), c = 0, 1, ...:
      // the 64 columns c of the X1 rows built once serve W[0]'s slice and,
      // one row up, W[1]'s
      int it = 0;
      A1Raw raw;
      A1Rows rows;
      A1Out out;
      if (blockIdx.x < a.tiles)
        issue_a1_rows(raw, in, blockIdx.x * a.rows, 0, a.M, pw);
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
        const int m0 = tile * a.rows;
        for (int c = 0; c < a.half / kBK; ++c) {
          if ((c & 3) == 0) {
            finish_a1_rows(rows, raw, in);
            // the next group's: the next row block, or the next tile's first
            const int next = tile + static_cast<int>(gridDim.x);
            if (c + 4 < a.half / kBK)
              issue_a1_rows(raw, in, m0, (c + 4) >> 2, a.M, pw);
            else if (next < a.tiles)
              issue_a1_rows(raw, in, next * a.rows, 0, a.M, pw);
          }
          __syncwarp();  // mma.sync wants the warp converged
          build_conv1_a(out, rows, *s0, (c & 3) * kBK);
          for (int h = 0; h < 2; ++h, ++it) {
            const int st = it % kStages;
            mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
            __syncwarp();
            store_conv1_a(sA + st * (kBM * kBK), out, pw, h, spill);
            // wgmma reads the stage through the async proxy
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            __syncwarp();
            if ((threadIdx.x & 31) == 0) mbar_arrive(&full[st]);
          }
        }
      }
    } else if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
        const int m0 = tile * a.rows;
        for (int q = 0; q < slices; ++q, ++it) {
          const int st = it % kStages;
          mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[st], kABytes + kWBytes);
          const int k0 = q * kBK, h = k0 >= a.half ? 1 : 0;
          tma_load(sA + st * (kBM * kBK), &mapA, &full[st], k0 - h * a.half,
                   m0 + h);
          tma_load(sW + st * (kC * kBK), &mapW, &full[st], k0, 0);
        }
      }
    }
  } else {
    if (!kBuildA)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    float d[128];
    int it = 0;
    // conv1: thread 0 keeps the weight slices kStages - 1 ahead, so the
    // A warps' stores are all a stage waits for: slice j of the block (K
    // order (W[0], c), (W[1], c)) into stage j mod kStages, once every
    // consumer warp has released slice j - kStages there (an iteration
    // ago: thread 0 seldom waits for the other warpgroup)
    const int total =
        slices * ((a.tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) /
                  gridDim.x);
    auto load_w = [&](int j) {
      if (!kBuildA || threadIdx.x != 0 || j >= total) return;
      const int q = j % slices, st = j % kStages;
      if (j >= kStages) mbar_wait(&empty[st], ((j / kStages) & 1) ^ 1);
      mbar_expect_tx(&full[st], kWBytes);
      tma_load(sW + st * (kC * kBK), &mapW, &full[st],
               (q & 1) * a.half + (q >> 1) * kBK, 0);
    };
    for (int j = 0; j < kStages; ++j) load_w(j);
    __syncwarp();
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.f;
      int prev = 0;
      for (int q = 0; q < slices; ++q, ++it) {
        const int st = it % kStages;
        mbar_wait(&full[st], (it / kStages) & 1);
        const uint64_t da =
            desc_sw128(sA + st * (kBM * kBK) + wg * 64 * kBK);
        const uint64_t dw = desc_sw128(sW + st * (kC * kBK));
        wgmma_fence();
        fence_acc(d);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_m64n256k16(d, da + 2 * kk, dw + 2 * kk, 1);
        wgmma_commit();
        fence_acc(d);
        // the previous slice's products are done: release its stage
        wgmma_wait<1>();
        fence_acc(d);
        if (q > 0 && lane == 0) mbar_arrive(&empty[prev]);
        if (it >= kStages - 1) load_w(it + 1);
        __syncwarp();
        prev = st;
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (lane == 0) mbar_arrive(&empty[prev]);
      norm_rows16(d, sAux, sOut + warp * 16 * kOutLd,
                  GemmRows{a.out, a.carry, min(a.M, (tile + 1) * a.rows),
                           a.T_out, a.cn, tile * a.rows + 16 * warp});
    }
    bulk_wait();
  }
}

// cuTensorMapEncodeTiled, looked up in the driver at run time (no link
// against libcuda).
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encoder() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// A row-major bf16 (rows x cols) matrix as a TMA map with boxes of
// box_cols (64: 128 bytes) x box_rows, 128-byte swizzled; rows past the
// end read as zeros.
bool make_map(CUtensorMap* m, const void* base, uint64_t cols, uint64_t rows,
              uint32_t box_rows) {
  const EncodeFn fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(bf16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), box_rows};
  const cuuint32_t es[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool valid(int L) {
  if (L <= 0 || L % kS0 != 0) return false;
  const Lens l = lens_of(L / kS0);
  return l.T4 > 0 && l.T1 <= kMaxT1;
}

}  // namespace

// Bytes of shared memory a block needs for conv0 length T0 (dtype 0 =
// float32, 1 = bfloat16; the bf16 GEMM blocks' need is fixed); 0 if the
// stack's lengths do not divide or T1 > 80.
extern "C" int conv_stack_fused_smem(int dtype, int T0) {
  if (T0 <= 0 || !valid(T0 * kS0) || (dtype != 0 && dtype != 1)) return 0;
  return static_cast<int>(dtype == 0 ? layout_of(T0).total : kGemmSmem);
}

// float32 body.  All tensors contiguous float32: new (B, L); c0/n0 (B,
// 5); c1/n1 (B, 4, 256); c2-c4, n2-n4 (B, 2, 256); w0 (10, 256); w1
// (2048, 256); w2-w4 (1024, 256); aux (15, 256); z (B, T4, 256).  Returns
// the launch's cudaError_t.
extern "C" int conv_stack_fused_f32_launch(
    const float* x_new, const float* c0, const float* c1, const float* c2,
    const float* c3, const float* c4, const float* w0, const float* w1,
    const float* w2, const float* w3, const float* w4, const float* aux,
    float* z, float* n0, float* n1, float* n2, float* n3, float* n4, int B,
    int L, void* stream) {
  const int smem = conv_stack_fused_smem(0, L / kS0);
  if (B <= 0 || L % kS0 != 0 || smem == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const F32Args a{x_new, {c0, c1, c2, c3, c4}, {w0, w1, w2, w3, w4}, aux, z,
                  {n0, n1, n2, n3, n4}, B, L};
  cudaError_t e = cudaFuncSetAttribute(
      f32_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  f32_stack_kernel<<<B, kC, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// bf16 body: five launches.  new (B, L); c0/n0 (B, 5); c1/n1 (B, 4, 256);
// c2-c4, n2-n4 (B, 2, 256); w0 (10, 256); wt1 (256, 2048) and wt2-wt4
// (256, 1024): the stride-block weights transposed, W^T[u, j C + c] = tap
// j from input channel c to output u; aux (15, 256) float32; z (B, T4,
// 256); scratch: stats (B, T0) float2 (conv0 rows' mean, rstd), x2-x4
// (B, T + 2, 256) for the inputs of conv2-4 (T = T1, T2, T3).  All
// contiguous.  Returns the first failing launch's cudaError_t
// (cudaErrorNotSupported: no TMA encoder).
extern "C" int conv_stack_fused_bf16_launch(
    const void* x_new, const void* c0, const void* c1, const void* c2,
    const void* c3, const void* c4, const void* w0, const void* wt1,
    const void* wt2, const void* wt3, const void* wt4, const float* aux,
    void* z, void* n0, void* n1, void* n2, void* n3, void* n4, void* stats,
    void* x2, void* x3, void* x4, int B, int L, void* stream) {
  if (B <= 0 || !valid(L)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Lens ln = lens_of(L / kS0);
  const int T[5] = {ln.T0, ln.T1, ln.T2, ln.T3, ln.T4};
  bf16* x[3] = {static_cast<bf16*>(x2), static_cast<bf16*>(x3),
                static_cast<bf16*>(x4)};
  bf16* nout[5] = {static_cast<bf16*>(n0), static_cast<bf16*>(n1),
                   static_cast<bf16*>(n2), static_cast<bf16*>(n3),
                   static_cast<bf16*>(n4)};
  const bf16* cin[5] = {
      static_cast<const bf16*>(c0), static_cast<const bf16*>(c1),
      static_cast<const bf16*>(c2), static_cast<const bf16*>(c3),
      static_cast<const bf16*>(c4)};
  const bf16* xn = static_cast<const bf16*>(x_new);
  const bf16* w0b = static_cast<const bf16*>(w0);
  float2* st0 = static_cast<float2*>(stats);
  const Conv0Args c{xn, {cin[0], cin[1], cin[2], cin[3], cin[4]}, w0b, aux,
                    st0, {x[0], x[1], x[2]}, nout[0], nout[1], B, L, ln.T0,
                    ln.T1, ln.T2, ln.T3};
  const Conv1In in{xn, cin[0], cin[1], st0, w0b, aux, L, ln.T0};
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tasks0 = B * (ln.T0 / kConv0Rows);  // a warp's tasks
  const int blocks0 = (tasks0 + kConv0Warps - 1) / kConv0Warps;
  conv0_kernel<<<blocks0 < kConv0Blocks * sms ? blocks0 : kConv0Blocks * sms,
                 kConv0Warps * 32, 0, st>>>(c);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  e = cudaFuncSetAttribute(conv_layer_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kGemmSmem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(conv_layer_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kGemmSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* wt[4] = {wt1, wt2, wt3, wt4};
  for (int l = 0; l < 4; ++l) {
    const int s = l == 0 ? 4 : 2;
    Layer a;
    a.T_out = T[l + 1];
    a.M = B * (a.T_out + 1);
    a.half = s * kC;
    a.K = 2 * a.half;
    // conv1's tiles drop their last row: the built rows serve both halves
    // of its K (build_conv1_a)
    a.rows = l == 0 ? kBM - 1 : kBM;
    a.tiles = (a.M + a.rows - 1) / a.rows;
    a.aux = aux + 3 * (l + 1) * kC;
    a.out = l < 3 ? x[l] : static_cast<bf16*>(z);
    a.cn = l < 3 ? 2 : 0;
    a.carry = l < 3 ? nout[l + 2] : nullptr;
    CUtensorMap mapA{}, mapW;  // conv1 builds its A: no map
    if ((l > 0 && !make_map(&mapA, x[l - 1], a.half, a.M, kBM)) ||
        !make_map(&mapW, wt[l], a.K, kC, kC))
      return static_cast<int>(cudaErrorNotSupported);
    const int grid = a.tiles < sms ? a.tiles : sms;
    if (l == 0)
      conv_layer_kernel<true><<<grid, kGemmThreads, kGemmSmem, st>>>(
          mapA, mapW, a, in);
    else
      conv_layer_kernel<false><<<grid, kGemmThreads, kGemmSmem, st>>>(
          mapA, mapW, a, Conv1In{});
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
