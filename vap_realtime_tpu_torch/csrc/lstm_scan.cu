// Fused short-sequence LSTM scan over precomputed input gates, for Hopper
// (sm_90a), on the tensor cores in 3xTF32.  Hand-written replacement of
// the TPU kernel `lstm_scan` (vap_realtime_tpu/ops/pallas/lstm.py:48, body
// `_lstm_kernel`:26).
//
// What it computes, per stream n, for t = 0 .. T-1 (T = 5 at 20 Hz):
//   g    = (gi[n, t] + b_hh) + h W_hh^T           (4H gates: i, f, g, o)
//   c    = sigmoid(g_f) c + sigmoid(g_i) tanh(g_g)
//   h    = sigmoid(g_o) tanh(c),  ys[n, t] = h
// with h, c, W_hh^T and every gate in float32; ys is stored in gi's
// dtype, h_T and c_T in h0's (the TPU kernel's rounding points).  The
// step's product h W_hh^T runs on the tensor cores in 3xTF32 (see
// tf32_mma.cuh): float32 accuracy from three TF32 MMAs per k step.
//
// Design: one block of 512 threads (16 warps) owns kNB = 64 streams for
// all T steps, the MMA's M.  The wrapper packs W_hh^T (H, 4H) into four
// column passes of 64 units (`pack_w_hh`, ops/cuda/lstm.py) so that one
// m16n8 accumulator tile holds the four gates of two units, lanes q and
// q ^ 1 hold a unit's (i, f) and (g, o), and a lane's four column tiles
// are four consecutive units: one __shfl_xor hands each lane all four
// gates of its cells, and its gates, c and h are 16-byte vectors.  Warp w
// computes rows 32 (w & 1) .. +32 and columns 32 (w >> 1) .. +32 of each
// pass.  Its accumulators start at gi + b_hh; the lane's gi of the next
// pass are loaded (8 vector loads) while this pass's MMAs run.  W_hh^T
// streams from L2 through shared memory in (32 K rows x 256 columns)
// tiles, double-buffered with cp.async and shared by all 16 warps: 1 MB
// per block and step, 0.64 GB per call at 8192 streams (the CUDA-core
// version read 2.6 GB); one barrier per tile.  K rows are paired in the
// packing and h's rows padded to 264 floats, so a lane's A and B pairs
// are conflict-free 8-byte loads.  c stays in shared memory; h_t goes to
// a float32 scratch in device memory (L2) and, at the step's end, back
// into the one shared-memory copy of h and out as ys[:, t], so h needs
// no second buffer.  The gate functions use the fast exponential
// (__expf; the accurate expf / tanhf made the scan slower).  Shared
// memory: h and c (2 x 64 x 264 float32) and the tile ring (2 x 16 x 520
// float32): 197 KB, one block per SM.
//
// Bound on the H100: operations.  2 * T * B * H * 4H = 21.5 GFLOP at
// B = 8192, T = 5, H = 256: 0.32 ms at the 67 TFLOP/s float32 CUDA-core
// peak; as 3xTF32 on the tensor cores 64.4 GFLOP of TF32, 0.13 ms at 495
// TFLOP/s (mma.sync does not reach that peak: wgmma does); the bytes
// (gates in, outputs, weights) are ~0.12 GB (0.036 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

#include "tf32_mma.cuh"

constexpr int kH = 256;                   // hidden width
constexpr int kG = 4 * kH;                // gate columns
constexpr int kNB = 64;                   // streams per block
constexpr int kThreads = 512;             // 16 warps: 2 row x 8 column groups
constexpr int kPass = 4;                  // column passes per step
constexpr int kPassCols = kG / kPass;     // 256 = 64 units x 4 gates
constexpr int kKS = 32;                   // K rows per weight tile
constexpr int kSlices = kH / kKS;         // tiles per pass
constexpr int kTiles = kPass * kSlices;   // tiles per step
constexpr int kLd = kH + 8;               // h and c row stride (floats)
constexpr int kWLd = 2 * kPassCols + 8;   // tile row stride: K row pairs
constexpr size_t kSmemBytes =
    (2 * kNB * kLd + kKS * kWLd) * sizeof(float);

// The gate functions in float32 with the fast exponential (__expf, a few
// ulp) and division: sigmoid(x) = 1 / (1 + e^-x), tanh(x) = 2 sigmoid(2x)
// - 1.
__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float tanh_fast(float x) {
  return __fdividef(2.f, 1.f + __expf(-2.f * x)) - 1.f;
}

// Four consecutive gate pre-activations of one row (one 16- or 8-byte
// load), held raw until used.
template <typename G>
struct Gates4;

template <>
struct Gates4<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ void zero() {
    v = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ float get(int i) const {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};

template <>
struct Gates4<__nv_bfloat16> {
  uint2 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ void zero() { v = make_uint2(0u, 0u); }
  __device__ __forceinline__ float get(int i) const {
    const uint32_t u = i < 2 ? v.x : v.y;
    return __uint_as_float(i & 1 ? u & 0xffff0000u : u << 16);
  }
};

// grid: ceil(B / kNB) blocks; block: kThreads.  wp: the packed weights
// (kPass, kH / 2, kPassCols, 2), see the header: K rows in pairs, so that
// with logical k = q of an MMA k step taking K row 2 q and k = q + 4 row
// 2 q + 1, a lane's A pair (h) and B pair (W) are one 8-byte load each.
// hx: (B, kH) float32 scratch that carries h_t from the cell updates to
// the next step's shared-memory copy.
template <typename G, typename S>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_scan_kernel(const G* __restrict__ gi, const S* __restrict__ h0,
                     const S* __restrict__ c0, const float* __restrict__ wp,
                     const float* __restrict__ b, G* __restrict__ ys,
                     S* __restrict__ h_out, S* __restrict__ c_out,
                     float* __restrict__ hx, int B, int T) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                    // [kNB][kLd]: h_{t-1}
  float* cs = smem + kNB * kLd;        // [kNB][kLd]: c
  float* wbuf = smem + 2 * kNB * kLd;  // [2][kKS / 2][kWLd]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int row0 = 32 * (w & 1) + g;       // + 16 mt (+ 8)
  const int col0 = 32 * (w >> 1);          // + 8 nt within a pass
  const int ub = 8 * (w >> 1) + 4 * (q >> 1);  // + 64 p + nt: the units
  const int n0 = blockIdx.x * kNB;
  const int n_tiles = T * kTiles;

  // weight tile i (pass (i % kTiles) / kSlices, K slice i % kSlices) ->
  // ring slot i & 1, as one cp.async group
  auto load_tile = [&](int i) {
    const int p = (i % kTiles) / kSlices, sl = i % kSlices;
    const float* src =
        wp + (static_cast<size_t>(p) * kH + sl * kKS) * kPassCols;
    float* dst = wbuf + (i & 1) * (kKS / 2) * kWLd;
    for (int e = tid; e < kKS * kPassCols / 4; e += kThreads) {
      const int r = e / (kPassCols / 2), c4 = 4 * (e % (kPassCols / 2));
      cp_async16(dst + r * kWLd + c4, src + r * 2 * kPassCols + c4);
    }
    cp_async_commit();
  };
  // The lane's accumulator element (mt, nt, e) is row row0 + 16 mt + 8 (e
  // >> 1), gate 2 (q & 1) + (e & 1) of unit 64 p + ub + nt (the packing
  // puts a lane's four column tiles on consecutive units): its gates of
  // step t, pass p are 8 loads of 4, issued a pass ahead.
  Gates4<G> gv[2][4];
  auto load_gates = [&](int t, int p) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + 16 * mt + 8 * (e >> 1);
        const int col = (2 * (q & 1) + (e & 1)) * kH + 64 * p + ub;
        if (n0 + r < B)
          gv[mt][e].load(gi + (static_cast<size_t>(n0 + r) * T + t) * kG +
                         col);
        else
          gv[mt][e].zero();
      }
  };

  load_tile(0);
  load_gates(0, 0);
  for (int e = tid; e < kNB * kH; e += kThreads) {
    const int r = e / kH, u = e % kH;
    const bool ok = n0 + r < B;
    const size_t o = static_cast<size_t>(n0 + r) * kH + u;
    hs[r * kLd + u] = ok ? E<S>::ld(h0 + o) : 0.f;
    cs[r * kLd + u] = ok ? E<S>::ld(c0 + o) : 0.f;
  }

  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int p = 0; p < kPass; ++p) {
      float acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = (2 * (q & 1) + (e & 1)) * kH + 64 * p + ub;
          const float4 bias = __ldg(reinterpret_cast<const float4*>(b + col));
          acc[mt][0][e] = __fadd_rn(gv[mt][e].get(0), bias.x);
          acc[mt][1][e] = __fadd_rn(gv[mt][e].get(1), bias.y);
          acc[mt][2][e] = __fadd_rn(gv[mt][e].get(2), bias.z);
          acc[mt][3][e] = __fadd_rn(gv[mt][e].get(3), bias.w);
        }
      if (p + 1 < kPass)
        load_gates(t, p + 1);
      else if (t + 1 < T)
        load_gates(t + 1, 0);
#pragma unroll 1
      for (int sl = 0; sl < kSlices; ++sl) {
        const int i = (t * kPass + p) * kSlices + sl;
        cp_async_wait<0>();
        __syncthreads();  // tile i landed; every warp is done with i - 1
        if (i + 1 < n_tiles) load_tile(i + 1);
        const float* wt = wbuf + (i & 1) * (kKS / 2) * kWLd + q * kWLd +
                          2 * (col0 + g);
#pragma unroll
        for (int kk = 0; kk < kKS / 8; ++kk) {
          const int k0 = sl * kKS + 8 * kk + 2 * q;
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const float* hr = hs + (row0 + 16 * mt) * kLd + k0;
            const float2 a02 = *reinterpret_cast<const float2*>(hr);
            const float2 a13 = *reinterpret_cast<const float2*>(hr + 8 * kLd);
            split_tf32(a02.x, ah[mt][0], al[mt][0]);
            split_tf32(a13.x, ah[mt][1], al[mt][1]);
            split_tf32(a02.y, ah[mt][2], al[mt][2]);
            split_tf32(a13.y, ah[mt][3], al[mt][3]);
          }
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const float2 bv =
                *reinterpret_cast<const float2*>(wt + 4 * kk * kWLd + 16 * nt);
            split_tf32(bv.x, bh[nt][0], bl[nt][0]);
            split_tf32(bv.y, bh[nt][1], bl[nt][1]);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_3xtf32<false>(acc[mt], ah[mt], al[mt], bh, bl);
        }
      }
      // the cell update: lane q even holds (i, f) of row g and of row g + 8,
      // its partner q ^ 1 the (g, o) of both; swap so the even lane has all
      // four gates of row g and the odd lane of row g + 8, for the units
      // 64 p + ub + nt.  c lives in shared memory, h_t goes to hx.
      const bool odd = q & 1;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = row0 + 16 * mt + 8 * (q & 1);
        float* cr = cs + r * kLd + 64 * p + ub;
        float4 cv = *reinterpret_cast<float4*>(cr);
        float c4[4] = {cv.x, cv.y, cv.z, cv.w}, h4[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* a = acc[mt][nt];
          const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
          const float ig = sigmoid(odd ? r0 : a[0]);
          const float fg = sigmoid(odd ? r1 : a[1]);
          const float gg = tanh_fast(odd ? a[2] : r0);
          const float og = sigmoid(odd ? a[3] : r1);
          c4[nt] = __fadd_rn(__fmul_rn(fg, c4[nt]), __fmul_rn(ig, gg));
          h4[nt] = __fmul_rn(og, tanh_fast(c4[nt]));
        }
        *reinterpret_cast<float4*>(cr) =
            make_float4(c4[0], c4[1], c4[2], c4[3]);
        if (n0 + r < B)
          *reinterpret_cast<float4*>(hx + static_cast<size_t>(n0 + r) * kH +
                                     64 * p + ub) =
              make_float4(h4[0], h4[1], h4[2], h4[3]);
      }
    }
    // h_t is complete in hx (and every warp is done reading h_{t-1}): copy
    // it into shared memory for the next step, and out as ys[:, t]
    __syncthreads();
    for (int e = tid; e < kNB * kH / 4; e += kThreads) {
      const int r = e / (kH / 4), u = 4 * (e % (kH / 4));
      if (n0 + r >= B) continue;
      const float4 v = *reinterpret_cast<const float4*>(
          hx + static_cast<size_t>(n0 + r) * kH + u);
      *reinterpret_cast<float4*>(hs + r * kLd + u) = v;
      G* y = ys + (static_cast<size_t>(n0 + r) * T + t) * kH + u;
      E<G>::st(y, v.x);
      E<G>::st(y + 1, v.y);
      E<G>::st(y + 2, v.z);
      E<G>::st(y + 3, v.w);
    }
  }
  __syncthreads();  // c_T in shared memory, h_T in hs
  for (int e = tid; e < kNB * kH; e += kThreads) {
    const int r = e / kH, u = e % kH;
    if (n0 + r >= B) continue;
    const size_t o = static_cast<size_t>(n0 + r) * kH + u;
    E<S>::st(h_out + o, hs[r * kLd + u]);
    E<S>::st(c_out + o, cs[r * kLd + u]);
  }
}

template <typename G, typename S>
int launch(const void* gi, const void* h0, const void* c0, const float* wp,
           const float* b, void* ys, void* h_t, void* c_t, float* hx, int B,
           int T, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lstm_scan_kernel<G, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((B + kNB - 1) / kNB);
  lstm_scan_kernel<G, S><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const G*>(gi), static_cast<const S*>(h0),
      static_cast<const S*>(c0), wp, b, static_cast<G*>(ys),
      static_cast<S*>(h_t), static_cast<S*>(c_t), hx, B, T);
  return static_cast<int>(cudaGetLastError());
}

template <typename G>
int dispatch(int h_dtype, const void* gi, const void* h0, const void* c0,
             const float* wp, const float* b, void* ys, void* h_t, void* c_t,
             float* hx, int B, int T, cudaStream_t st) {
  return h_dtype == 0 ? launch<G, float>(gi, h0, c0, wp, b, ys, h_t, c_t, hx,
                                         B, T, st)
                      : launch<G, __nv_bfloat16>(gi, h0, c0, wp, b, ys, h_t,
                                                 c_t, hx, B, T, st);
}

}  // namespace

// gi_dtype (gi, ys) and h_dtype (h0, c0, h_T, c_T): 0 = float32, 1 =
// bfloat16.  gi (B, T, 4H), h0/c0/h_T/c_T (B, H), w_packed (4, H / 2, H,
// 2) float32 (the column passes of W_hh^T with interleaved gates and
// paired K rows, see the header), b_hh (4H,) float32 in the gate-major
// order, ys (B, T, H), hx (B, H) float32 scratch, all contiguous; H must
// be 256.  Returns the launch's cudaError_t (0 = success).
extern "C" int lstm_scan_launch(int gi_dtype, int h_dtype, const void* gi,
                                const void* h0, const void* c0,
                                const float* w_packed, const float* b_hh,
                                void* ys, void* h_t, void* c_t, float* hx,
                                int B, int T, int H, void* stream) {
  if (B <= 0 || T <= 0 || H != kH || (gi_dtype != 0 && gi_dtype != 1) ||
      (h_dtype != 0 && h_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return gi_dtype == 0 ? dispatch<float>(h_dtype, gi, h0, c0, w_packed, b_hh,
                                         ys, h_t, c_t, hx, B, T, st)
                       : dispatch<__nv_bfloat16>(h_dtype, gi, h0, c0,
                                                 w_packed, b_hh, ys, h_t, c_t,
                                                 hx, B, T, st);
}
