// The whole streaming CPC conv stack (conv0..conv4, each followed by
// ChannelNorm + ReLU) in one kernel, for Hopper (sm_90a).  Hand-written
// replacement of the TPU kernel `conv_stack_fused_call`
// (vap_realtime_tpu/ops/pallas/encoder.py:291, bodies `_kernel`:190 and
// `_kernel_v3`:89; its modes are VMEM layouts of this one function).
//
// What it computes, per channel-stream n, on one frame's L fresh samples:
//   xc0 = [c0 (5 carried samples) | new (L)];  T0 = L / 5
//   conv0: y[t] = sum_j xc0[5t + j] w0[j, :] + b0          (k 10, s 5)
//   conv1-4 (k = 2s; s = 4, 2, 2, 2): x = [carry (k-s rows) | previous
//     output], channels-last (T_in, 256); y[t] = sum_{j<k} x[st + j] W_j + b
//     (the TPU kernel's two stride-block matmuls y = xm[t] W0 + xm[t+1] W1
//     are this sum split at j = s); T_out = T_in / s - 1 = 40, 20, 10, 5
//     at L = 800
//   after each conv (`_cnorm_relu`, encoder.py:76): float32 sum and sum of
//     squares over the 256 channels, var = max((s2 - n mean^2)/(n-1), 0),
//     (y - mean) * rsqrt(var + 1e-5) in float32, cast to the activation
//     dtype BEFORE the affine, the affine rounded op by op in that dtype
//     (multiply, then add), ReLU.
//   new carries: the last 5 samples of xc0 and the last k-s rows of each
//     layer's input, in the activation dtype; output z = conv4's (5, 256).
// Products are of activation-dtype values, accumulated in float32 with a
// float32 bias (so bf16 results are MORE precise than the cuDNN `conv`
// path, which rounds every conv output to bf16).  float32 activations
// compute in float32 on the CUDA cores: no TF32.
//
// Design: one block of 256 threads (8 warps) per channel-stream.  The
// activations never leave shared memory: the samples, buffer A (conv1's
// input, 164 x 256 at L = 800; later conv3's) and buffer B (conv2's input,
// 42 x 256; later conv4's), channels-last, written straight by the
// previous layer's epilogue after its carry rows.  Buffer A is the widest
// activation, 84 KB in bf16 (two blocks per SM) and 168 KB in float32
// (one).  conv0 (K = 10) runs on the CUDA cores, thread c computing output
// channel c of every row from the shared samples (float32, a sliding
// window of 10 in registers).
//   conv1-4, bf16: on the tensor cores (warp-level wmma 16 x 16 x 16 bf16
//     tiles, float32 accumulators).  The A operand is the layer's input
//     itself: row t of the (T_out x k*C) im2col matrix is input rows
//     [s t, s t + k), i.e. stride blocks t and t + 1 of s rows, so no copy
//     is made.  Each layer input is laid out in stride blocks with 16
//     elements of padding after each block: without it the 16 rows of an
//     A tile (s*C elements apart, a multiple of 128 bytes) fell on the
//     same shared-memory banks, and the 8-way conflicts dominated.  Warp
//     w owns output columns [32w, 32w + 32) for all 16-row tiles (3 at
//     T_out = 40).  The weights stream from L2 once per block (2.6 MB per
//     channel-stream, ~21 GB of L2 reads per step at 8192 streams): the
//     16 rows of each k step are copied with 16-byte cp.async into a
//     two-stage ring in shared memory while the previous step multiplies;
//     each warp copies and reads only its own 32 columns, so it waits for
//     its own copies and the warps need no block-wide barrier per step.
//     The ring borrows rows of the buffer the layer will write (its
//     epilogue fills them only after the products), so a block needs
//     ~112 KB and two blocks fit an SM.  The float32 results go to shared
//     memory over the now-dead input buffer.
//   conv1-4, float32: on the CUDA cores (no TF32).  Thread c owns output
//     channel c; a layer runs in chunks of RT output rows (RT divides
//     T_out: 40, 20, 10, 5 at L = 800) with RT float32 accumulators; the
//     thread streams its weight column from L2 (4 k at a time, coalesced
//     across the warp) and reads the RT input rows as 4-element vectors
//     that the whole warp shares (a shared-memory broadcast).
// The epilogue (bias, ChannelNorm, ReLU) has thread c hold column c of a
// chunk of rows: the row sums are a warp butterfly plus an 8-warp exchange
// through shared memory, one lane per row turns them into (mean, rstd),
// then each thread normalises its column and writes the next layer's
// input row (or z).
//
// Bound on the H100: operations.  ~63.6 MFLOP per channel-stream in the
// TPU kernel's stride-block form (61.2 in this direct form), 0.52 TFLOP
// per step at 8192 channel-streams: 0.53 ms at the 989 TFLOP/s bf16
// tensor-core peak (7.8 ms at the 67 TFLOP/s float32 CUDA-core peak for
// float32).  The bytes (waveform, carries, output, 2.6 MB of weights) are
// ~0.13 GB.  This version is far from the bound: its weight tiles come
// from L2 for every block (several streams per block, weights staged in
// shared memory by TMA, and wgmma are later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kC = 256;            // channels: one thread per output channel
constexpr int kWarps = kC / 32;
constexpr int kK0 = 10, kS0 = 5;   // conv0 kernel and stride
constexpr int kMaxRT = 40;         // most output rows per chunk (float32)
constexpr int kMaxRTh = 10;        // most output rows per chunk (bf16)
constexpr int kTile = 16;          // wmma tile: 16 x 16 x 16
constexpr int kMaxMT = 5;          // most 16-row output tiles of a layer
// weight ring row stride (elements): 528 bytes put the 8 rows of a
// 16 x 16 tile load on distinct banks, and 16 rows stay 32-byte aligned
constexpr int kRS = kC + 8;
constexpr float kEps = 1e-5f;

template <typename T>
struct E;

template <>
struct E<float> {
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
  static __device__ __forceinline__ void ld4(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  static __device__ __forceinline__ void st(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct E<__nv_bfloat16> {
  static __device__ __forceinline__ float ld(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void ld4(const __nv_bfloat16* p,
                                             float* f) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

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

// Regions start on 128-byte boundaries (wmma needs 32-byte alignment).
__host__ __device__ inline size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Input rows a layer's 16-row tiles read: s (max(T_out, 16) - 1) + k.
__host__ __device__ inline int tile_rows(int s, int k, int T_out) {
  return s * (imax(T_out, kTile) - 1) + k;
}

// A layer's input lies in stride blocks of s rows (s = the layer's
// stride), each block followed by `pad` elements: 16 in bf16, which spreads
// the tensor-core A tiles' rows (s blocks apart) over the shared-memory
// banks; 0 in float32.  Row r is at block r / s, row r % s.
__host__ __device__ inline int pad_of(size_t es) { return es == 2 ? 16 : 0; }

// Rows per chunk the reduction scratch holds: bf16 keeps its chunks short
// (registers; and the scratch then leaves room for two blocks per SM).
__host__ __device__ inline int red_rt(size_t es) {
  return es == 2 ? kMaxRTh : kMaxRT;
}

// Floats of one parity of the reduction scratch: the warps' partial sums
// and sums of squares of each row, then each row's (mean, rstd).
__host__ __device__ inline int red_floats(size_t es) {
  return (2 * kWarps + 2) * red_rt(es);
}

template <typename T>
struct Dst {
  T* base;
  int s, pad;
  __device__ __forceinline__ T* row(int r) const {
    return base + static_cast<size_t>(r / s) * (s * kC + pad) + (r % s) * kC;
  }
};

__host__ __device__ inline size_t in_bytes(int rows, int s, size_t es) {
  return static_cast<size_t>((rows + s - 1) / s) * (s * kC + pad_of(es)) *
         es;
}

__host__ __device__ inline size_t smax(size_t a, size_t b) {
  return a > b ? a : b;
}

// Shared memory layout (bytes): samples, buffer A (conv1's and conv3's
// input; the bf16 weight ring of conv2 and conv4), buffer B (conv2's and
// conv4's input; the ring of conv1 and conv3), reductions.  An input
// buffer also takes its layer's float32 products (max(T_out, 16) rows).
struct Layout {
  size_t xs, a, b, red, total;
};

__host__ __device__ inline Layout layout_of(int T0, size_t es) {
  const Lens l = lens_of(T0);
  const size_t ring = (2 * kC + pad_of(es)) * es +
                      2 * kTile * kRS * sizeof(__nv_bfloat16);
  const size_t a = smax(
      smax(in_bytes(imax(T0 + 4, tile_rows(4, 8, l.T1)), 4, es),
           in_bytes(imax(l.T2 + 2, tile_rows(2, 4, l.T3)), 2, es)),
      smax(ring, static_cast<size_t>(imax(imax(l.T1, l.T3), kTile)) * kC *
                     sizeof(float)));
  const size_t b = smax(
      smax(in_bytes(imax(l.T1 + 2, tile_rows(2, 4, l.T2)), 2, es),
           in_bytes(imax(l.T3 + 2, tile_rows(2, 4, l.T4)), 2, es)),
      smax(ring, static_cast<size_t>(imax(imax(l.T2, l.T4), kTile)) * kC *
                     sizeof(float)));
  Layout s;
  s.xs = 0;
  s.a = align128((static_cast<size_t>(T0) * kS0 + kS0) * sizeof(float));
  s.b = s.a + align128(a);
  s.red = s.b + align128(b);
  s.total = s.red + 2 * red_floats(es) * sizeof(float);
  return s;
}

struct Args {
  const void* x_new;   // (B, L) fresh samples
  const void* c[5];    // carries in: c0 (B, 5), c1 (B, 4, C), c2-c4 (B, 2, C)
  const void* w[5];    // w0 (10, C); w1..w4 (k*C, C): tap j rows [jC, (j+1)C)
  const float* aux;    // (15, C): per layer [bias, norm w, norm b]
  void* z;             // (B, T4, C)
  void* n[5];          // carries out, shaped as c
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
// column c of each in acc), written to out rows [row0, row0 + RT).
// red: 2 x kWarps x kMaxRT floats of this chunk's parity.
template <typename T, int RT>
__device__ __forceinline__ void epilogue(float* acc, const float* aux_row,
                                         const Dst<T>& out, int row0,
                                         float* red) {
  constexpr int R = static_cast<int>(sizeof(T)) == 2 ? kMaxRTh : kMaxRT;
  static_assert(RT <= R, "chunk longer than the reduction scratch");
  const int col = threadIdx.x;
  const int lane = col & 31, warp = col >> 5;
  const float bias = aux_row[col];
  const float nw = E<T>::round(aux_row[kC + col]);
  const float nb = E<T>::round(aux_row[2 * kC + col]);
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
      red[warp * R + r] = s1[r];
      red[(kWarps + warp) * R + r] = s2[r];
    }
  }
  __syncthreads();
  // warp w finishes the statistics of rows w, w + 8, ...: lanes 0-7 hold
  // the 8 warps' partial sums; lane 0 stores (mean, rstd) once per row
  float* stats = red + 2 * kWarps * R;
  const float n = static_cast<float>(kC);
  for (int r = warp; r < RT; r += kWarps) {
    float t1 = lane < kWarps ? red[lane * R + r] : 0.f;
    float t2 = lane < kWarps ? red[(kWarps + lane) * R + r] : 0.f;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) {
      t1 += __shfl_xor_sync(0xffffffffu, t1, o);
      t2 += __shfl_xor_sync(0xffffffffu, t2, o);
    }
    if (lane == 0) {
      const float mean = __fdiv_rn(t1, n);
      const float var = fmaxf(
          __fdiv_rn(__fsub_rn(t2, __fmul_rn(__fmul_rn(n, mean), mean)),
                    n - 1.f),
          0.f);
      stats[2 * r] = mean;
      stats[2 * r + 1] = __frsqrt_rn(__fadd_rn(var, kEps));
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const float mean = stats[2 * r], rstd = stats[2 * r + 1];
    const float y = E<T>::round(__fmul_rn(__fsub_rn(acc[r], mean), rstd));
    const float o =
        E<T>::round(__fadd_rn(E<T>::round(__fmul_rn(y, nw)), nb));
    E<T>::st(out.row(row0 + r) + col, fmaxf(o, 0.f));
  }
}

// conv0 over chunks of RT rows: samples xs (T0*5 + 5, float32) -> out
// rows.  Row t reads samples [5t, 5t + 10): the thread keeps that window in
// registers and loads only the 5 new samples of each row.
template <typename T, int RT>
__device__ void conv0(const float* xs, int T0, const T* __restrict__ w0,
                      const float* aux, const Dst<T>& out, int row0,
                      float* red, int& parity) {
  const int col = threadIdx.x;
  float w[kK0];
#pragma unroll
  for (int j = 0; j < kK0; ++j) w[j] = E<T>::ld(w0 + j * kC + col);
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
    epilogue<T, RT>(acc, aux, out, row0 + r0,
                    red + parity * red_floats(sizeof(T)));
    parity ^= 1;
  }
}

// conv with kernel k = 2s over a channels-last float32 input (rows of C,
// no padding): output row t = sum_{j<k} in[s t + j] . W_j, in chunks of RT
// rows.
template <typename T, int RT>
__device__ void conv_tail(const T* in, int s, int k, int T_out,
                          const T* __restrict__ W, const float* aux,
                          const Dst<T>& out, int row0, float* red,
                          int& parity) {
  const int col = threadIdx.x;
  const int K = k * kC;
  const size_t rs = static_cast<size_t>(s) * kC;  // input stride of a row
  for (int r0 = 0; r0 < T_out; r0 += RT) {
    const T* a = in + r0 * rs;
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.f;
    for (int kk = 0; kk < K; kk += 4) {
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = E<T>::ld(W + static_cast<size_t>(kk + i) * kC + col);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float x[4];
        E<T>::ld4(a + r * rs + kk, x);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r] = fmaf(x[i], w[i], acc[r]);
      }
    }
    epilogue<T, RT>(acc, aux, out, row0 + r0,
                    red + parity * red_floats(sizeof(T)));
    parity ^= 1;
  }
}

// 16-byte asynchronous copy global -> shared (cp.async, L2 only).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// bf16 on the tensor cores: output rows t = sum_{j<k} in[s t + j] . W_j
// as one (T_out x k*C) x (k*C x C) product of wmma 16 x 16 x 16 tiles with
// float32 accumulators.  A row t of the A operand is in[s t .. s t + k) laid
// end to end: stride blocks t and t + 1 (k = 2s), so the A tile of a k step
// in the first (second) half is block t0 (t0 + 1) onwards with leading
// dimension s*C + pad (no im2col copy; the pad spreads the rows over the
// banks).  Warp w owns output columns [32w, 32w + 32), two 16-column
// tiles, for all MT row tiles, so each weight tile is loaded (from L2)
// once per block.  Row tiles start at min(16 i, T_out - 16), so a layer
// with T_out >= 16 reads no row past its input; the tiles of a smaller
// layer read up to tile_rows() rows (the buffers hold them) and their
// extra output rows are dropped.  The float32 results land in y (row
// stride C), which may alias `in`: every warp finishes its products first.
template <int MT>
__device__ void mma_rows(const __nv_bfloat16* in, int s, int k, int T_out,
                         const __nv_bfloat16* __restrict__ W, float* y,
                         __nv_bfloat16* ring) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int half = s * kC;                     // K of one stride block
  const int lda = half + pad_of(sizeof(__nv_bfloat16));
  const int K = k * kC;
  int t0[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
    t0[i] = T_out >= kTile ? min(kTile * i, T_out - kTile) : 0;
  wmma::fragment<wmma::accumulator, kTile, kTile, kTile, float> acc[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    wmma::fill_fragment(acc[i][0], 0.f);
    wmma::fill_fragment(acc[i][1], 0.f);
  }
  // the warp's 16 x 32 weight tile of step st + 1 (1 KB) copies into its
  // own columns of the two-stage ring with 16-byte cp.async (two per lane)
  // while step st multiplies; as no warp reads another's columns, a warp
  // waits only for its own copies (no block-wide barrier per step)
  const int lane = threadIdx.x & 31;
  const int steps = K / kTile;
  auto stage = [&](int step) {
    const __nv_bfloat16* src =
        W + static_cast<size_t>(step) * kTile * kC + 32 * warp;
    __nv_bfloat16* dst = ring + (step & 1) * kTile * kRS + 32 * warp;
    for (int c = lane; c < kTile * 4; c += 32) {  // 16 rows x 4 chunks
      const int r = c >> 2, q = c & 3;
      cp_async16(dst + r * kRS + q * 8, src + r * kC + q * 8);
    }
    cp_async_commit();
  };
  stage(0);
  for (int st = 0; st < steps; ++st) {
    const int kk = st * kTile;
    const int blk = kk / half, kin = kk - blk * half;
    cp_async_wait_all();
    __syncwarp();  // step st landed; the warp is done with step st - 1
    if (st + 1 < steps) stage(st + 1);
    wmma::fragment<wmma::matrix_b, kTile, kTile, kTile, __nv_bfloat16,
                   wmma::row_major>
        b0, b1;
    const __nv_bfloat16* wt = ring + (st & 1) * kTile * kRS + 32 * warp;
    wmma::load_matrix_sync(b0, wt, kRS);
    wmma::load_matrix_sync(b1, wt + kTile, kRS);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      wmma::fragment<wmma::matrix_a, kTile, kTile, kTile, __nv_bfloat16,
                     wmma::row_major>
          a;
      wmma::load_matrix_sync(
          a, in + static_cast<size_t>(t0[i] + blk) * lda + kin, lda);
      wmma::mma_sync(acc[i][0], a, b0, acc[i][0]);
      wmma::mma_sync(acc[i][1], a, b1, acc[i][1]);
    }
  }
  __syncthreads();  // every warp has read `in`
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float* yt = y + static_cast<size_t>(t0[i]) * kC + 32 * warp;
    wmma::store_matrix_sync(yt, acc[i][0], kC, wmma::mem_row_major);
    wmma::store_matrix_sync(yt + kTile, acc[i][1], kC, wmma::mem_row_major);
  }
  __syncthreads();
}

// Epilogue of the tensor-core layer over chunks of RT rows of y.
template <int RT>
__device__ void epilogue_rows(const float* y, int T_out, const float* aux,
                              const Dst<__nv_bfloat16>& out, int row0,
                              float* red, int& parity) {
  for (int r0 = 0; r0 < T_out; r0 += RT) {
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
      acc[r] = y[static_cast<size_t>(r0 + r) * kC + threadIdx.x];
    epilogue<__nv_bfloat16, RT>(
        acc, aux, out, row0 + r0,
        red + parity * red_floats(sizeof(__nv_bfloat16)));
    parity ^= 1;
  }
}

__device__ void conv_mma(__nv_bfloat16* in, int s, int k, int T_out,
                         const __nv_bfloat16* W, const float* aux,
                         const Dst<__nv_bfloat16>& out, int row0, float* red,
                         int& parity, __nv_bfloat16* ring) {
  float* y = reinterpret_cast<float*>(in);  // the input is dead after mma
  switch ((imax(T_out, kTile) + kTile - 1) / kTile) {
    case 1: mma_rows<1>(in, s, k, T_out, W, y, ring); break;
    case 2: mma_rows<2>(in, s, k, T_out, W, y, ring); break;
    case 3: mma_rows<3>(in, s, k, T_out, W, y, ring); break;
    case 4: mma_rows<4>(in, s, k, T_out, W, y, ring); break;
    default: mma_rows<5>(in, s, k, T_out, W, y, ring); break;
  }
  // chunks of at most 10 rows keep the bf16 kernel's registers within two
  // blocks per SM
  if (T_out % 10 == 0)
    epilogue_rows<10>(y, T_out, aux, out, row0, red, parity);
  else if (T_out % 5 == 0)
    epilogue_rows<5>(y, T_out, aux, out, row0, red, parity);
  else if (T_out % 4 == 0)
    epilogue_rows<4>(y, T_out, aux, out, row0, red, parity);
  else
    epilogue_rows<1>(y, T_out, aux, out, row0, red, parity);
}

// One tail layer: bf16 on the tensor cores, float32 on the CUDA cores
// with chunks of the largest of 40, 20, 10, 5, 4, 1 rows dividing T_out.
template <typename T>
__device__ void conv_any(T* in, int s, int k, int T_out, const T* W,
                         const float* aux, const Dst<T>& out, int row0,
                         float* red, int& parity, T* ring) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    conv_mma(in, s, k, T_out, W, aux, out, row0, red, parity, ring);
  } else {
    if (T_out % 40 == 0)
      conv_tail<T, 40>(in, s, k, T_out, W, aux, out, row0, red, parity);
    else if (T_out % 20 == 0)
      conv_tail<T, 20>(in, s, k, T_out, W, aux, out, row0, red, parity);
    else if (T_out % 10 == 0)
      conv_tail<T, 10>(in, s, k, T_out, W, aux, out, row0, red, parity);
    else if (T_out % 5 == 0)
      conv_tail<T, 5>(in, s, k, T_out, W, aux, out, row0, red, parity);
    else if (T_out % 4 == 0)
      conv_tail<T, 4>(in, s, k, T_out, W, aux, out, row0, red, parity);
    else
      conv_tail<T, 1>(in, s, k, T_out, W, aux, out, row0, red, parity);
  }
}

template <typename T>
__device__ void conv0_any(const float* xs, int T0, const T* w0,
                          const float* aux,
                          const Dst<T>& out, int row0, float* red,
                          int& parity) {
  // float32: long chunks; bf16: at most 10 rows (registers, see conv_mma)
  constexpr bool kLong = std::is_same<T, float>::value;
  if (kLong && T0 % 40 == 0)
    conv0<T, kLong ? 40 : 10>(xs, T0, w0, aux, out, row0, red, parity);
  else if (T0 % 10 == 0)
    conv0<T, 10>(xs, T0, w0, aux, out, row0, red, parity);
  else if (T0 % 4 == 0)
    conv0<T, 4>(xs, T0, w0, aux, out, row0, red, parity);
  else
    conv0<T, 1>(xs, T0, w0, aux, out, row0, red, parity);
}

// Copy `rows` rows of C (thread c: column c) between row-major buffers.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int rows) {
  for (int r = 0; r < rows; ++r)
    dst[static_cast<size_t>(r) * kC + threadIdx.x] =
        src[static_cast<size_t>(r) * kC + threadIdx.x];
}

// grid: B blocks (one channel-stream each); block: 256 threads.
template <typename T>
__global__ void __launch_bounds__(kC, sizeof(T) == 2 ? 2 : 1)
    conv_stack_fused_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = blockIdx.x;
  const int L = a.L;
  const int T0 = L / kS0;
  const Lens ln = lens_of(T0);
  const Layout lay = layout_of(T0, sizeof(T));
  float* xs = reinterpret_cast<float*>(smem + lay.xs);
  T* bufA = reinterpret_cast<T*>(smem + lay.a);
  T* bufB = reinterpret_cast<T*>(smem + lay.b);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  const T* c[5];
  const T* w[5];
  T* nout[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    c[i] = static_cast<const T*>(a.c[i]);
    w[i] = static_cast<const T*>(a.w[i]);
    nout[i] = static_cast<T*>(a.n[i]);
  }
  const size_t C = kC;
  const int pad = pad_of(sizeof(T));
  int parity = 0;
  // the layer inputs: conv1's (stride 4) and conv3's (stride 2) in A,
  // conv2's and conv4's (stride 2) in B; z rows unpadded
  const Dst<T> in1{bufA, 4, pad}, in2{bufB, 2, pad}, in3{bufA, 2, pad},
      in4{bufB, 2, pad};
  const Dst<T> zout{static_cast<T*>(a.z) + static_cast<size_t>(n) * ln.T4 * C,
                    1, 0};
  // the bf16 weight rings: past block 0 (the carry) of the buffer the layer
  // does not read, whose rows its epilogue writes only after the products
  T* ringA = bufA + 2 * C + pad;
  T* ringB = bufB + 2 * C + pad;

  // samples [c0 | new]; the carries fill block 0 of each layer input (the
  // k - s = s carry rows are exactly one stride block)
  const T* xn = static_cast<const T*>(a.x_new) + static_cast<size_t>(n) * L;
  for (int i = threadIdx.x; i < L + kS0; i += kC)
    xs[i] = E<T>::ld(i < kS0 ? c[0] + n * kS0 + i : xn + i - kS0);
  copy_rows(bufA, c[1] + n * 4 * C, 4);
  copy_rows(bufB, c[2] + n * 2 * C, 2);
  __syncthreads();
  if (threadIdx.x < kS0)
    E<T>::st(nout[0] + n * kS0 + threadIdx.x, xs[L + threadIdx.x]);

  conv0_any<T>(xs, T0, w[0], a.aux, in1, 4, red, parity);
  __syncthreads();
  copy_rows(nout[1] + n * 4 * C, in1.row(T0), 4);
  conv_any<T>(bufA, 4, 8, ln.T1, w[1], a.aux + 3 * C, in2, 2, red, parity,
              ringB);
  __syncthreads();
  copy_rows(nout[2] + n * 2 * C, in2.row(ln.T1), 2);
  copy_rows(bufA, c[3] + n * 2 * C, 2);
  __syncthreads();
  conv_any<T>(bufB, 2, 4, ln.T2, w[2], a.aux + 6 * C, in3, 2, red, parity,
              ringA);
  __syncthreads();
  copy_rows(nout[3] + n * 2 * C, in3.row(ln.T2), 2);
  copy_rows(bufB, c[4] + n * 2 * C, 2);
  __syncthreads();
  conv_any<T>(bufA, 2, 4, ln.T3, w[3], a.aux + 9 * C, in4, 2, red, parity,
              ringB);
  __syncthreads();
  copy_rows(nout[4] + n * 2 * C, in4.row(ln.T3), 2);
  conv_any<T>(bufB, 2, 4, ln.T4, w[4], a.aux + 12 * C, zout, 0, red, parity,
              ringA);
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const Layout lay = layout_of(a.L / kS0, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      conv_stack_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.total));
  if (e != cudaSuccess) return static_cast<int>(e);
  conv_stack_fused_kernel<T><<<a.B, kC, lay.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of shared memory a block needs for conv0 length T0 (dtype 0 =
// float32, 1 = bfloat16); 0 if the stack's lengths do not divide.
extern "C" int conv_stack_fused_smem(int dtype, int T0) {
  const Lens l = lens_of(T0);
  if (T0 <= 0 || l.T4 <= 0 || (dtype != 0 && dtype != 1) ||
      l.T1 > kMaxMT * kTile)
    return 0;
  return static_cast<int>(layout_of(T0, dtype == 0 ? 4 : 2).total);
}

// dtype of every tensor but aux: 0 = float32, 1 = bfloat16.  All tensors
// contiguous: new (B, L); c0/n0 (B, 5); c1/n1 (B, 4, 256); c2-c4, n2-n4
// (B, 2, 256); w0 (10, 256); w1 (2048, 256); w2-w4 (1024, 256); aux (15,
// 256) float32; z (B, T4, 256).  Returns the launch's cudaError_t.
extern "C" int conv_stack_fused_launch(
    int dtype, const void* x_new, const void* c0, const void* c1,
    const void* c2, const void* c3, const void* c4, const void* w0,
    const void* w1, const void* w2, const void* w3, const void* w4,
    const float* aux, void* z, void* n0, void* n1, void* n2, void* n3,
    void* n4, int B, int L, void* stream) {
  if (B <= 0 || L <= 0 || L % kS0 != 0 ||
      conv_stack_fused_smem(dtype, L / kS0) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x_new, {c0, c1, c2, c3, c4}, {w0, w1, w2, w3, w4}, aux, z,
               {n0, n1, n2, n3, n4}, B, L};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(a, st) : launch<__nv_bfloat16>(a, st);
}
