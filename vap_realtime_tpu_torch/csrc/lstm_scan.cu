// Fused LSTM scan over precomputed input gates, for Hopper (sm_90a), on
// the tensor cores in 3xTF32.  Hand-written replacement of the TPU kernel
// `lstm_scan` (vap_realtime_tpu/ops/pallas/lstm.py:48, body
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
// Two bodies; the wrapper picks one from (B, T) alone (`_body`,
// ops/cuda/lstm.py), by the crossover measured on the card.
//
// The serving body (lstm_scan_kernel, lstm_scan_launch), for many short
// streams (8192 channel-streams x 5 steps at 20 Hz).
// One block of 512 threads (16 warps) owns kNB = 64 streams for
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
// The sequence body (lstm_seq_kernel, lstm_seq_launch), for long
// sequences at small batch (the training encoder's 16 x 1998 steps over
// 20 s).  One thread-block cluster of CS blocks (16, non-portable, or 8)
// owns 16 streams, the M of one m16n8k8 tile, for all T steps; rows past
// B are zero and never stored.  Block r owns units kU r .. kU r + kU - 1
// (kU = 256 / CS) and their four gates, interleaved by `pack_w_hh_seq`
// as the serving body's are, so one __shfl_xor gives a lane all four
// gates of its cell and c stays in a register.  Its slice of W_hh^T (256
// x 4 kU) is loaded once and stays in shared memory for all T steps: at
// CS = 16 split into its TF32 hi and lo parts at load time, at CS = 8 raw
// and split as it is read.  A step: the 16 warps are column groups x K
// slices (CS = 16: 2 x 8, each 4 column tiles over 32 K rows; CS = 8: 4
// x 4); the K slices' partial sums meet in shared memory and the tile's
// owner warp adds them in K order, then gi + b_hh (g = (gi + b_hh) + s,
// the plain version's order), and updates its cells.  The block's slice
// of h_t is staged in shared memory and sent to the next h buffer of
// every block of the cluster with 16-byte st.async stores, each counted
// on the receiving block's mbarrier for that buffer; a block waits only
// on its own barrier, so the loop has no cluster-wide barrier.  The
// gates come through a 4-step cp.async ring; ys leaves coalesced from the
// stage.  Shared memory: 214 KB (CS = 16) / 223 KB (CS = 8), one block
// an SM.  On the H100 (tools/k5_ablate.py) a step at CS = 16 is ~2.5 us:
// the MMA phase ~1.1, the exchange (stage, stores, wait) ~0.8, the
// reduction and the cell update the rest: the latency of a chain of
// ~2,000 dependent steps, not the bound below, sets the time.
//
// Bound on the H100: operations, 2 T B H 4H float32 FLOP (as 3xTF32,
// three times that in TF32 at 495 TFLOP/s; mma.sync does not reach that
// peak: wgmma does).  Serving, B = 8192, T = 5: 21.5 GFLOP, 0.32 ms at the
// 67 TFLOP/s float32 CUDA-core peak, 64.4 GFLOP of TF32, 0.13 ms; the
// bytes (gates in, outputs, weights) ~0.12 GB (0.036 ms).  Training, B =
// 16, T = 1998: 16.8 GFLOP, 50.3 GFLOP of TF32, 0.10 ms; 0.165 GB.

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

// ---------------------------------------------------------------------------
// The sequence body: long sequences at small batch (the training encoder's
// (16, 1998, 256)).  See the file header.

constexpr int kSeqRows = 16;                  // streams a cluster: the MMA's M
constexpr int kSeqWarps = 16;
constexpr int kSeqThreads = 32 * kSeqWarps;

// Cluster-scope pieces: the block's rank in its cluster, a shared-memory
// address mapped into another block of the cluster, a store there that
// counts on that block's mbarrier, the mbarrier's own operations, and the
// cluster barrier (release on arrive, acquire on wait) that the sequence
// body takes once at its start and once at its end.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(addr), "r"(rank));
  return d;
}
// 16 bytes into a block of the cluster that, on landing, complete 16
// bytes of transactions on that block's mbarrier `mbar`.
__device__ __forceinline__ void st_async4(uint32_t addr, float4 v,
                                          uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(mbar)
      : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t mbar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mbar),
               "r"(count)
               : "memory");
}
// One arrival on `mbar` that also expects `bytes` of transactions.
__device__ __forceinline__ void mbar_expect(uint32_t mbar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mbar),
      "r"(bytes)
      : "memory");
}
// Whether the phase of `mbar` with parity `parity` has completed (the
// try waits a while in hardware before it answers no).
__device__ __forceinline__ bool mbar_try(uint32_t mbar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
      "%2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(mbar), "r"(parity)
      : "memory");
  return ok != 0;
}
// Wait for that phase; a phase that never completes (a lost store) ends
// the kernel with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t mbar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try(mbar, parity); ++n)
    if (n == (1u << 24)) __trap();
}
// Four consecutive outputs in one 16-byte (float32) or 8-byte (bf16) store.
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<const uint32_t*>(&a),
      *reinterpret_cast<const uint32_t*>(&b));
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shapes of one cluster of CS blocks: each block owns kU = 256 / CS
// units, i.e. kN = 4 kU gate columns in kNT column tiles of 8.  The
// block's 16 warps are kGroups column groups x kKSplit K slices: a warp
// takes kNTW tiles over kH / kKSplit K rows.  W_hh^T's slice lives in
// shared memory as K row pairs of stride kWLd (= 8 mod 32: conflict-free
// 8-byte B loads): at CS = 16 (kSplit) as its TF32 hi and lo parts,
// split once at load time; at CS = 8 raw float32 (the parts would not
// fit).  The reduction keeps kKSplit - 1
// partial tiles a column tile (the owner's own stays in registers); the
// stage holds the block's slice of h_t (16 rows x kU units).
template <int CS>
struct SeqShape {
  static constexpr bool kSplit = CS == 16;
  static constexpr int kKSplit = CS == 16 ? 8 : 4;
  static constexpr int kGroups = kSeqWarps / kKSplit;
  static constexpr int kKSteps = kH / 8 / kKSplit;
  static constexpr int kU = kH / CS;
  static constexpr int kN = 4 * kU;
  static constexpr int kNT = kN / 8;
  static constexpr int kNTW = kNT / kGroups;
  static constexpr int kWLd = 2 * kN + 8;
  static constexpr int kWFloats = kH / 2 * kWLd;
  static constexpr int kHFloats = kSeqRows * kLd;  // one h buffer
  static constexpr int kRedFloats = (kKSplit - 1) * kNT * 32 * 4;
  static constexpr int kStageFloats = kSeqRows * kU;
  // the gates' ring: kGiDepth steps of the block's 16 rows x 4 gates x kU
  // units (float32 room; bf16 gates take half)
  static constexpr int kGiDepth = 4;
  static constexpr int kGiFloats = kSeqRows * 4 * kU;
  // 16-byte DSMEM stores a thread a step: CS blocks x the 16 x kU slice
  static constexpr int kSends = CS * kSeqRows * kU / 4 / kSeqThreads;
  // + the two h buffers' mbarriers (8 bytes each)
  static constexpr size_t kSmemBytes =
      ((kSplit ? 2 : 1) * kWFloats + 2 * kHFloats + kRedFloats +
       kStageFloats + kGiDepth * kGiFloats + 4) *
      sizeof(float);
  // the bytes of h_t a block receives a step: its 16 rows, all units
  static constexpr uint32_t kHBytes = kSeqRows * kH * sizeof(float);
  static_assert(kNTW >= 1 && kNTW <= kKSplit, "one owner warp a tile");
  static_assert(kSends * kSeqThreads * 4 == CS * kSeqRows * kU, "sends");
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
};

// grid: (ceil(B / 16) clusters) x CS blocks, cluster (CS, 1, 1); block:
// kSeqThreads.  wp: (CS, kH / 2, kN, 2) float32, block r's slice of
// W_hh^T with its columns in `pack_w_hh_seq` order (ops/cuda/lstm.py):
// local column j = 8 nt + 2 q + e is gate 2 (q & 1) + e of unit kU r + 2
// nt + (q >> 1), K rows in pairs as in the serving body.
template <typename G, typename S, int CS>
__global__ void __launch_bounds__(kSeqThreads, 1)
    lstm_seq_kernel(const G* __restrict__ gi, const S* __restrict__ h0,
                    const S* __restrict__ c0, const float* __restrict__ wp,
                    const float* __restrict__ b, G* __restrict__ ys,
                    S* __restrict__ h_out, S* __restrict__ c_out, int B,
                    int T) {
  using Sh = SeqShape<CS>;
  constexpr bool kSplit = Sh::kSplit;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                                   // W hi (or raw)
  float* wl = smem + Sh::kWFloats;                    // W lo (kSplit)
  float* hs = smem + (kSplit ? 2 : 1) * Sh::kWFloats; // [2][16][kLd]
  float4* red = reinterpret_cast<float4*>(hs + 2 * Sh::kHFloats);
  float* stage = hs + 2 * Sh::kHFloats + Sh::kRedFloats;  // [16][kU]
  float* gring_f = stage + Sh::kStageFloats;  // [kGiDepth][16][4][kU]
  G* gring = reinterpret_cast<G*>(gring_f);
  // mbar[b]: h buffer b's arrivals (an expect_tx a use, then the
  // cluster's st.async bytes)
  const uint32_t mbar = static_cast<uint32_t>(__cvta_generic_to_shared(
      gring_f + Sh::kGiDepth * Sh::kGiFloats));
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int kq = w % Sh::kKSplit, grp = w / Sh::kKSplit;
  const uint32_t rank = cluster_rank();
  const int n0 = (blockIdx.x / CS) * kSeqRows;

  // W_hh^T's slice, once: raw, or split into TF32 hi and lo
  const float* src = wp + static_cast<size_t>(rank) * kH * Sh::kN;
  for (int e = tid; e < kH * Sh::kN / 4; e += kSeqThreads) {
    const int r = e / (Sh::kN / 2), c4 = 4 * (e % (Sh::kN / 2));
    const float4 v =
        *reinterpret_cast<const float4*>(src + r * 2 * Sh::kN + c4);
    float* d = ws + r * Sh::kWLd + c4;
    if (kSplit) {
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t hi, lo;
        split_tf32(x[i], hi, lo);
        d[i] = __uint_as_float(hi);
        wl[r * Sh::kWLd + c4 + i] = __uint_as_float(lo);
      }
    } else {
      *reinterpret_cast<float4*>(d) = v;
    }
  }
  // the gates' ring starts at zero: dead rows stay so
  for (int e = tid; e < Sh::kGiDepth * Sh::kGiFloats; e += kSeqThreads)
    gring_f[e] = 0.f;
  // h_{-1}: every block holds all 16 rows; dead rows are zero
  for (int e = tid; e < kSeqRows * kH; e += kSeqThreads) {
    const int r = e / kH, u = e % kH;
    hs[r * kLd + u] =
        n0 + r < B ? E<S>::ld(h0 + static_cast<size_t>(n0 + r) * kH + u)
                   : 0.f;
  }

  // The owner warp of column tile nt (the one that sums its K slices and
  // updates its cells) is the warp of nt's group whose K slice is nt %
  // kNTW.  Its lane holds accumulator e = row g + 8 (e >> 1), gate
  // 2 (q & 1) + (e & 1) of unit u; after the shuffle, the cell (row r,
  // unit u).
  const bool owner = kq < Sh::kNTW;
  const int nt_own = grp * Sh::kNTW + kq;
  const int u = Sh::kU * static_cast<int>(rank) + 2 * nt_own + (q >> 1);
  const int gate0 = 2 * (q & 1);
  const int r = g + 8 * (q & 1);
  const bool odd = q & 1;
  float bias[2] = {0.f, 0.f}, cst = 0.f;
  if (owner) {
    bias[0] = __ldg(b + gate0 * kH + u);
    bias[1] = __ldg(b + (gate0 + 1) * kH + u);
    if (n0 + r < B) cst = E<S>::ld(c0 + static_cast<size_t>(n0 + r) * kH + u);
  }
  // The block's gates of `step` (its kU units of each gate, 16 rows) into
  // ring slot step % kGiDepth, 16 bytes a copy, one cp.async group a step
  // (empty past T); live rows only.
  constexpr int kChunk = 16 / sizeof(G);
  constexpr int kRowChunks = 4 * Sh::kU / kChunk;
  auto copy_gates = [&](int step) {
    if (step < T) {
      G* dst = gring + (step % Sh::kGiDepth) * Sh::kGiFloats;
      for (int c = tid; c < kSeqRows * kRowChunks; c += kSeqThreads) {
        const int row = c / kRowChunks, rem = c % kRowChunks;
        const int gate = rem / (Sh::kU / kChunk);
        const int k = kChunk * (rem % (Sh::kU / kChunk));
        if (n0 + row < B)
          cp_async16(dst + (row * 4 + gate) * Sh::kU + k,
                     gi + (static_cast<size_t>(n0 + row) * T + step) * kG +
                         gate * kH + Sh::kU * rank + k);
      }
    }
    cp_async_commit();
  };
  const uint32_t hs_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(hs));
  if (tid == 0) {
    // buffer 1 takes h_0, buffer 0 h_1 (and h_{-1} came from h0)
    mbar_init(mbar, 1);
    mbar_init(mbar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(mbar + 8, Sh::kHBytes);
    if (T > 1) mbar_expect(mbar, Sh::kHBytes);
  }
  cluster_arrive();  // W, h_{-1}, the mbarriers in place; the cluster runs
  cluster_wait();
  for (int i = 0; i + 1 < Sh::kGiDepth; ++i) copy_gates(i);

  for (int t = 0; t < T; ++t) {
    const float* hcur = hs + (t & 1) * Sh::kHFloats;
    if (t > 0) {
      // h_{t-1} landed: the phase (t - 1) / 2 of buffer t & 1's barrier
      mbar_wait(mbar + 8 * (t & 1), ((t - 1) >> 1) & 1);
      // re-armed for h_{t+1}: no block sends it before it has h_t,
      // which this block sends after this wait
      if (tid == 0 && t + 1 < T) mbar_expect(mbar + 8 * (t & 1), Sh::kHBytes);
    }
    // the gates of step t + kGiDepth - 1 into the slot step t - 1 freed
    copy_gates(t + Sh::kGiDepth - 1);
    // h_{t-1} W_hh^T over this warp's K slice and column tiles
    float acc[Sh::kNTW][4];
#pragma unroll
    for (int i = 0; i < Sh::kNTW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < Sh::kKSteps; ++kk) {
      const int k0 = (kq * Sh::kKSteps + kk) * 8;
      uint32_t ah[4], al[4];
      const float2 a02 =
          *reinterpret_cast<const float2*>(hcur + g * kLd + k0 + 2 * q);
      const float2 a13 = *reinterpret_cast<const float2*>(
          hcur + (g + 8) * kLd + k0 + 2 * q);
      split_tf32(a02.x, ah[0], al[0]);
      split_tf32(a13.x, ah[1], al[1]);
      split_tf32(a02.y, ah[2], al[2]);
      split_tf32(a13.y, ah[3], al[3]);
      uint32_t bh[Sh::kNTW][2], bl[Sh::kNTW][2];
      const int wo = (k0 / 2 + q) * Sh::kWLd + 2 * (8 * grp * Sh::kNTW + g);
#pragma unroll
      for (int i = 0; i < Sh::kNTW; ++i) {
        const float2 bv = *reinterpret_cast<const float2*>(ws + wo + 16 * i);
        if (kSplit) {
          const float2 lv =
              *reinterpret_cast<const float2*>(wl + wo + 16 * i);
          bh[i][0] = __float_as_uint(bv.x);
          bh[i][1] = __float_as_uint(bv.y);
          bl[i][0] = __float_as_uint(lv.x);
          bl[i][1] = __float_as_uint(lv.y);
        } else {
          split_tf32(bv.x, bh[i][0], bl[i][0]);
          split_tf32(bv.y, bh[i][1], bl[i][1]);
        }
      }
      mma_3xtf32<false>(acc, ah, al, bh, bl);
    }
    // the K slices' partial sums meet in shared memory: tile i's owner
    // has K slice i, so K slice kq's partial goes to slot kq - (kq > i)
#pragma unroll
    for (int i = 0; i < Sh::kNTW; ++i)
      if (i != kq)
        red[((kq - (kq > i)) * Sh::kNT + grp * Sh::kNTW + i) * 32 + lane] =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    cp_async_wait<Sh::kGiDepth - 1>();  // this thread's copies of step t
    __syncthreads();  // the partials and step t's gates in place
    float h = 0.f;
    if (owner) {
      // s = P_0 + P_1 + ... in K order; g = (gi + b_hh) + s
      float own[4], a[4];
#pragma unroll
      for (int i = 0; i < Sh::kNTW; ++i)
        if (i == kq)
#pragma unroll
          for (int e = 0; e < 4; ++e) own[e] = acc[i][e];
#pragma unroll
      for (int j = 0; j < Sh::kKSplit; ++j) {
        float p[4] = {own[0], own[1], own[2], own[3]};
        if (j != kq) {
          const float4 v = red[((j - (j > kq)) * Sh::kNT + nt_own) * 32 +
                               lane];
          p[0] = v.x, p[1] = v.y, p[2] = v.z, p[3] = v.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = j == 0 ? p[e] : __fadd_rn(a[e], p[e]);
      }
      const G* gs = gring + (t % Sh::kGiDepth) * Sh::kGiFloats +
                    2 * nt_own + (q >> 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x =
            E<G>::ld(gs + ((g + 8 * (e >> 1)) * 4 + gate0 + (e & 1)) * Sh::kU);
        a[e] = __fadd_rn(__fadd_rn(x, bias[e & 1]), a[e]);
      }
      // even lane q: (i, f) of rows g and g + 8; odd lane: (g, o) of both
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
      const float ig = sigmoid(odd ? r0 : a[0]);
      const float fg = sigmoid(odd ? r1 : a[1]);
      const float gg = tanh_fast(odd ? a[2] : r0);
      const float og = sigmoid(odd ? a[3] : r1);
      cst = __fadd_rn(__fmul_rn(fg, cst), __fmul_rn(ig, gg));
      h = __fmul_rn(og, tanh_fast(cst));
      stage[r * Sh::kU + 2 * nt_own + (q >> 1)] = h;
    }
    __syncthreads();  // the block's slice of h_t is in the stage
    // h_t's slice into the next buffer of every block of the cluster, 16
    // bytes a store: CS x 16 rows x kU / 4 = 1024 stores, 2 a thread,
    // each counted on that block's barrier of the buffer (none after the
    // last step)
    if (t + 1 < T) {
      const uint32_t nb = hs_addr + ((t + 1) & 1) * Sh::kHFloats *
                                        sizeof(float);
      const uint32_t nm = mbar + 8 * ((t + 1) & 1);
#pragma unroll
      for (int i = 0; i < Sh::kSends; ++i) {
        const int e = tid + i * kSeqThreads;
        const int j = e / (kSeqRows * Sh::kU / 4);
        const int rr = (e / (Sh::kU / 4)) % kSeqRows;
        const int c4 = 4 * (e % (Sh::kU / 4));
        const float4 v =
            *reinterpret_cast<const float4*>(stage + rr * Sh::kU + c4);
        st_async4(map_rank(nb + (rr * kLd + Sh::kU * rank + c4) *
                                    sizeof(float),
                           j),
                  v, map_rank(nm, j));
      }
    }
    // then the outputs
    if (tid < kSeqRows * Sh::kU / 4) {
      const int rr = tid / (Sh::kU / 4), c4 = 4 * (tid % (Sh::kU / 4));
      if (n0 + rr < B)
        store4(ys + (static_cast<size_t>(n0 + rr) * T + t) * kH +
                   Sh::kU * rank + c4,
               *reinterpret_cast<const float4*>(stage + rr * Sh::kU + c4));
    }
    if (owner && t + 1 == T && n0 + r < B) {
      E<S>::st(h_out + static_cast<size_t>(n0 + r) * kH + u, h);
      E<S>::st(c_out + static_cast<size_t>(n0 + r) * kH + u, cst);
    }
  }
  cluster_arrive();  // no block leaves while the cluster still runs
  cluster_wait();
}

template <typename G, typename S, int CS>
int launch_seq(const void* gi, const void* h0, const void* c0,
               const float* wp, const float* b, void* ys, void* h_t,
               void* c_t, int B, int T, cudaStream_t stream,
               int* max_clusters) {
  auto kernel = lstm_seq_kernel<G, S, CS>;
  const int smem = static_cast<int>(SeqShape<CS>::kSmemBytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && CS > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((B + kSeqRows - 1) / kSeqRows) *
                     CS);
  cfg.blockDim = dim3(kSeqThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1) return static_cast<int>(cudaErrorInvalidClusterSize);
  if (max_clusters != nullptr) *max_clusters = n;
  if (ys == nullptr) return 0;  // the occupancy query alone
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const G*>(gi),
                           static_cast<const S*>(h0),
                           static_cast<const S*>(c0), wp, b,
                           static_cast<G*>(ys), static_cast<S*>(h_t),
                           static_cast<S*>(c_t), B, T);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// cluster 8: W_hh^T raw in shared memory (the portable size); 16: its
// TF32 hi and lo parts (non-portable).
template <typename G, typename S>
int dispatch_seq(int cluster, const void* gi, const void* h0, const void* c0,
                 const float* wp, const float* b, void* ys, void* h_t,
                 void* c_t, int B, int T, cudaStream_t st, int* max_clusters) {
  if (cluster == 8)
    return launch_seq<G, S, 8>(gi, h0, c0, wp, b, ys, h_t, c_t, B, T, st,
                               max_clusters);
  if (cluster == 16)
    return launch_seq<G, S, 16>(gi, h0, c0, wp, b, ys, h_t, c_t, B, T, st,
                                max_clusters);
  return static_cast<int>(cudaErrorInvalidValue);
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

// The sequence body (see the header): gi, h0, c0, b_hh, ys, h_T, c_T and
// the dtypes as for lstm_scan_launch; w_packed (cluster, H / 2, 4H /
// cluster, 2) float32 from `pack_w_hh_seq`; cluster 8 (the portable size)
// or 16 (non-portable).  With ys == nullptr nothing launches.
// *max_clusters (if not null) gets cudaOccupancyMaxActiveClusters.
// Returns cudaErrorInvalidClusterSize where no cluster of that size fits
// on the card, else the launch's cudaError_t (0 = success).
extern "C" int lstm_seq_launch(int gi_dtype, int h_dtype, const void* gi,
                               const void* h0, const void* c0,
                               const float* w_packed, const float* b_hh,
                               void* ys, void* h_t, void* c_t, int B, int T,
                               int H, int cluster, void* stream,
                               int* max_clusters) {
  if (B <= 0 || T <= 0 || H != kH || (gi_dtype != 0 && gi_dtype != 1) ||
      (h_dtype != 0 && h_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gi_dtype == 0)
    return h_dtype == 0
               ? dispatch_seq<float, float>(cluster, gi, h0, c0, w_packed,
                                            b_hh, ys, h_t, c_t, B, T, st,
                                            max_clusters)
               : dispatch_seq<float, __nv_bfloat16>(cluster, gi, h0, c0,
                                                    w_packed, b_hh, ys, h_t,
                                                    c_t, B, T, st,
                                                    max_clusters);
  return h_dtype == 0
             ? dispatch_seq<__nv_bfloat16, float>(cluster, gi, h0, c0,
                                                  w_packed, b_hh, ys, h_t,
                                                  c_t, B, T, st, max_clusters)
             : dispatch_seq<__nv_bfloat16, __nv_bfloat16>(
                   cluster, gi, h0, c0, w_packed, b_hh, ys, h_t, c_t, B, T,
                   st, max_clusters);
}
