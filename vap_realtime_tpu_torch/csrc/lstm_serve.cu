// The serving LSTM of the CPC context net in bf16, for Hopper (sm_90a):
// all T steps of one streaming frame in one launch.  It replaces no TPU
// kernel: the JAX package's serving step runs this LSTM as XLA ops, as
// `ops/basic.py` `lstm` does on every other device and dtype (one GEMM
// and ~10 elementwise launches a step).  K5 (`lstm_scan.cu`) is the
// float32 scan of the training encoder; its 3xTF32 serving body does not
// pay at the 5 Hz frame's 20 steps.
//
// What it computes, per channel-stream row n, for t = 0 .. T-1 (T = 5 at
// 20 Hz, 20 at 5 Hz), gates i, f, g, o:
//   G    = [x_t | h] [W_ih | W_hh]^T + (b_ih + b_hh)      (1024 gates)
//   c    = sigmoid(G_f) c + sigmoid(G_i) tanh(G_g)
//   h    = sigmoid(G_o) tanh(c),   ys[n, t] = bf16(h)
// x, h and the weights are bf16 operands of the tensor cores with
// float32 accumulation; the bias sum, the gates and c are float32 and
// never leave registers; h is rounded to bf16 once a step (ys, and the
// next step's operand); h_T and c_T leave in bf16 at the end.  The plain
// bf16 path rounds each gate, c and every product to bf16: this is the
// same function at no lower precision.  The gate functions take one
// tanh.approx.f32 each (max relative error ~2^-11, four times finer than
// a bf16 rounding): sigmoid(v) = 0.5 tanh(v / 2) + 0.5.
//
// Layout.  A tile is 128 rows (two consumer warpgroups of 64: wgmma's M)
// and a block owns it for all T steps; blocks are persistent (one per
// SM, walking the tiles).  The packed weights W (1024, 512) bf16
// (`pack_w_serve`, ops/cuda/lstm.py) hold the gate columns in chunks of
// 128: chunk j is units 32 j .. 32 j + 31, in 4 groups of 8 units, each
// group's i, f, g, o rows in turn.  So in wgmma m64n128's accumulator
// (thread (warp w, lane l): rows 16 w + l / 4 and + 8, columns 8 i +
// 2 (l % 4) + {0, 1}) a thread holds all four gates of 2 units x 4 groups
// for its 2 rows: its 16 cells of the chunk, with c in registers (128
// floats a thread over the 8 chunks).  A step is 8 chunks, each a
// K = 512 product in 8 slices of 64 (4 of x_t, then 4 of h), the
// accumulators starting at the bias, then the chunk's cell update.
// Shared memory: x_t and h (128 x 256 bf16 each, 4 TMA boxes of 64
// columns, 128-byte swizzled: the A operands) and a ring of 6 W slices
// (128 x 64 bf16, 16 KB each) that one producer thread keeps full with
// TMA against full / empty mbarriers.  h_t leaves registers straight to
// ys in device memory (it stays in L2) and comes back into the one h
// buffer by TMA once the step's last chunk has read h_{t-1}, so h needs
// no second buffer; x_{t+1} is loaded once the last chunk has read x_t.
// The producer is a warpgroup of its own: producer code between a
// warpgroup's wgmma makes ptxas serialize them (C7518), and a single
// producer warp caps every thread at 168 registers all the same (three
// warps on one SM sub-partition).  ptxas allocates 168 registers a thread
// and spills ~0.5 KB of the consumers' 192 live values (c and the
// accumulators); a second accumulator set, to run a chunk's cell update
// under the next chunk's products, spilled more and ran slower on the
// card (PERF.md §6).
//
// Bound on the H100: operations, 2 T B 512 1024 bf16 FLOP at 989 TFLOP/s:
// 1.78 ms at (83,968, 20), 0.27 ms at (51,200, 5).  Bytes: x in, ys out,
// h and c in and out (1.89 GB at (83,968, 20): 0.57 ms at 3.35 TB/s).
// L2 -> SM: the 1 MB of W per tile and step (13.1 GB at (83,968, 20)).
// On an H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py `time_serve`):
// 3.38-3.43 ms at (83,968, 20), 52% of the bound; 0.72-0.74 ms at
// (51,200, 5), 38%: its 400 tiles take four rounds of 132 blocks, the
// last with 4.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kH = 256;                 // hidden units
constexpr int kBM = 128;                // rows a tile: 2 warpgroups x 64
constexpr int kBN = 128;                // gate columns a chunk: 32 units
constexpr int kBK = 64;                 // K of a slice: one 128-byte row
constexpr int kChunks = 4 * kH / kBN;   // 8
constexpr int kSlices = 2 * kH / kBK;   // 8: 4 of x_t, then 4 of h
constexpr int kStages = 6;              // W ring depth
constexpr int kConsumers = 256;         // two warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr uint32_t kBoxBytes = kBM * kBK * sizeof(bf16);    // 16 KB
constexpr uint32_t kOperandBytes = 4 * kBoxBytes;           // 64 KB
constexpr uint32_t kWBytes = kBN * kBK * sizeof(bf16);      // 16 KB
constexpr size_t kSmem = 2 * kOperandBytes + kStages * kWBytes +
                         (2 * kStages + 4) * sizeof(uint64_t) + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// wait that never completes (a fault) traps after 2^26 polls (seconds)
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t addr = smem_u32(b);
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
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
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, float32) += A (64 x 16) . B (16 x 128), both bf16 from
// shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ float tanh_fast(float v) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(v));
  return y;
}

__device__ __forceinline__ float sigmoid_fast(float v) {
  return fmaf(0.5f, tanh_fast(0.5f * v), 0.5f);
}

struct Args {
  const bf16* c0;     // (B, 256)
  const float* bias;  // (1024,) b_ih + b_hh in the packed column order
  bf16* ys;           // (B, T, 256)
  bf16* h_t;          // (B, 256)
  bf16* c_t;          // (B, 256)
  int B, T, tiles;
};

// The cell update of chunk J from its accumulators d: the thread's 16
// cells c[4 m + 2 rr + e] (group m, row rr, unit 32 J + 8 m + 2 q + e),
// updated in place; h to ys (and h_T, c_T at the last step).  row0: the
// thread's first row (-1 past B), row1 its second.
template <int J>
__device__ __forceinline__ void cell_update(const float* d, float* c,
                                            const Args& a, int row0,
                                            int row1, int t, int q) {
  const bool last = t == a.T - 1;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = rr == 0 ? row0 : row1;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float h[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float gi = d[4 * (4 * m + 0) + 2 * rr + e];
        const float gf = d[4 * (4 * m + 1) + 2 * rr + e];
        const float gg = d[4 * (4 * m + 2) + 2 * rr + e];
        const float go = d[4 * (4 * m + 3) + 2 * rr + e];
        float& cc = c[4 * m + 2 * rr + e];
        cc = fmaf(sigmoid_fast(gf), cc, sigmoid_fast(gi) * tanh_fast(gg));
        h[e] = sigmoid_fast(go) * tanh_fast(cc);
      }
      if (row >= 0) {
        const int unit = 32 * J + 8 * m + 2 * q;
        const __nv_bfloat162 hv = __floats2bfloat162_rn(h[0], h[1]);
        *reinterpret_cast<__nv_bfloat162*>(
            a.ys + (static_cast<size_t>(row) * a.T + t) * kH + unit) = hv;
        if (last) {
          *reinterpret_cast<__nv_bfloat162*>(
              a.h_t + static_cast<size_t>(row) * kH + unit) = hv;
          *reinterpret_cast<__nv_bfloat162*>(
              a.c_t + static_cast<size_t>(row) * kH + unit) =
              __floats2bfloat162_rn(c[4 * m + 2 * rr], c[4 * m + 2 * rr + 1]);
        }
      }
    }
  }
}

// The consumers' view of the block's shared memory: x_t, h, the W ring,
// the barriers.
struct Block {
  const bf16* sX;
  const bf16* sH;
  const bf16* sW;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* x_full;
  uint64_t* x_empty;
  uint64_t* h_full;
};

// One chunk J of one step: its K = 512 product from the x_t and h buffers
// and the ring (the accumulators starting at the bias), then its cell
// update.  it: the ring's slice counter; gs: the step counter (the x / h
// barriers' parity).  A warp releases a stage once the wgmma reading it
// has completed.
template <int J>
__device__ __forceinline__ void chunk(float* d, float* c, const Args& a,
                                      const Block& k, int& it, int gs,
                                      int wg, int lane, int row0, int row1,
                                      int t) {
  const int q = lane & 3;
  // columns 8 i + 2 q + {0, 1} of the chunk
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(
        a.bias + J * kBN + 8 * i + 2 * q));
    d[4 * i] = d[4 * i + 2] = b.x;
    d[4 * i + 1] = d[4 * i + 3] = b.y;
  }
  int prev = 0;
  for (int s = 0; s < kSlices; ++s, ++it) {
    if (J == 0 && s == 0) mbar_wait(k.x_full, gs & 1);
    if (J == 0 && s == 4) mbar_wait(k.h_full, gs & 1);
    const int st = it % kStages;
    mbar_wait(&k.full[st], (it / kStages) & 1);
    const bf16* src =
        s < 4 ? k.sX + s * (kBM * kBK) : k.sH + (s - 4) * (kBM * kBK);
    const uint64_t da = desc_sw128(src + wg * 64 * kBK);
    const uint64_t dw = desc_sw128(k.sW + st * (kBN * kBK));
    wgmma_fence();
    fence_acc(d);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64n128k16(d, da + 2 * kk, dw + 2 * kk);
    wgmma_commit();
    fence_acc(d);
    // the previous slice's products are done: release its stage
    wgmma_wait<1>();
    fence_acc(d);
    if (s > 0 && lane == 0) mbar_arrive(&k.empty[prev]);
    // the step's last read of x_t (chunk 7, slice 3) is done
    if (J == kChunks - 1 && s == 4 && lane == 0) mbar_arrive(k.x_empty);
    prev = st;
  }
  wgmma_wait<0>();
  fence_acc(d);
  if (lane == 0) mbar_arrive(&k.empty[prev]);
  cell_update<J>(d, c + 16 * J, a, row0, row1, t, q);
}

// The producer: W slice s of chunk j into the ring's next stage once the
// consumers have released it.
__device__ __forceinline__ void load_w(bf16* sW, const CUtensorMap* mapW,
                                       uint64_t* full, uint64_t* empty,
                                       int& it, int j, int s) {
  const int st = it % kStages;
  mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
  mbar_expect_tx(&full[st], kWBytes);
  tma_load(sW + st * (kBN * kBK), mapW, &full[st], s * kBK, j * kBN);
  ++it;
}

// Persistent: block b takes tiles b, b + gridDim.x, ...  mapX: x as
// (B rows, T 256 columns); mapH0: h0 (B, 256); mapY: ys (B, T 256);
// mapW: the packed weights (1024, 512); boxes of 64 columns x 128 rows
// (mapW: 128 weight rows), 128-byte swizzled, rows past B read as zeros.
// Warpgroups 0 and 1 consume (rows 0-63 and 64-127 of a tile); one
// thread of warpgroup 2 produces.  setmaxnreg moves the producer's
// registers to the consumers (40 / 232 of the 168 a thread of 384 gets
// at launch).
__global__ void __launch_bounds__(kThreads, 1)
    lstm_serve_kernel(const __grid_constant__ CUtensorMap mapX,
                      const __grid_constant__ CUtensorMap mapH0,
                      const __grid_constant__ CUtensorMap mapY,
                      const __grid_constant__ CUtensorMap mapW,
                      const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sH = reinterpret_cast<bf16*>(smem + kOperandBytes);
  bf16* sW = reinterpret_cast<bf16*>(smem + 2 * kOperandBytes);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + 2 * kOperandBytes + kStages * kWBytes);
  uint64_t* empty = full + kStages;
  uint64_t* x_full = empty + kStages;
  uint64_t* x_empty = x_full + 1;
  uint64_t* h_full = x_full + 2;
  uint64_t* h_free = x_full + 3;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);  // one arrival per warp
    }
    mbar_init(x_full, 1);
    mbar_init(x_empty, kConsumers / 32);
    mbar_init(h_full, 1);
    mbar_init(h_free, kConsumers);  // every consumer thread, after its
                                    // ys stores and proxy fence
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      int it = 0, gs = 0;
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
        const int m0 = tile * kBM;
        for (int t = 0; t < a.T; ++t, ++gs) {
          // x_t, once the last step's last chunk has read x_{t-1}
          mbar_wait(x_empty, (gs & 1) ^ 1);
          mbar_expect_tx(x_full, kOperandBytes);
          for (int s = 0; s < 4; ++s)
            tma_load(sX + s * (kBM * kBK), &mapX, x_full, t * kH + s * kBK,
                     m0);
          for (int s = 0; s < 4; ++s)
            load_w(sW, &mapW, full, empty, it, 0, s);
          // h_{t-1}: h0, or ys[:, t - 1] once every consumer has stored
          // it and the last chunk has read h_{t-2}
          mbar_wait(h_free, (gs & 1) ^ 1);
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          mbar_expect_tx(h_full, kOperandBytes);
          for (int s = 0; s < 4; ++s) {
            if (t == 0)
              tma_load(sH + s * (kBM * kBK), &mapH0, h_full, s * kBK, m0);
            else
              tma_load(sH + s * (kBM * kBK), &mapY, h_full,
                       (t - 1) * kH + s * kBK, m0);
          }
          for (int s = 4; s < kSlices; ++s)
            load_w(sW, &mapW, full, empty, it, 0, s);
          for (int j = 1; j < kChunks; ++j)
            for (int s = 0; s < kSlices; ++s)
              load_w(sW, &mapW, full, empty, it, j, s);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const Block k{sX, sH, sW, full, empty, x_full, x_empty, h_full};
    const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31, q = lane & 3;
    float d[64];
    float c[kChunks * 16];  // the thread's 128 cells, chunk by chunk
    int it = 0, gs = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      const int r0 = tile * kBM + 16 * warp + (lane >> 2);
      const int row0 = r0 < a.B ? r0 : -1;
      const int row1 = r0 + 8 < a.B ? r0 + 8 : -1;
#pragma unroll
      for (int j = 0; j < kChunks; ++j)
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int row = rr == 0 ? row0 : row1;
            float2 v = make_float2(0.f, 0.f);
            if (row >= 0)
              v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  a.c0 + static_cast<size_t>(row) * kH + 32 * j + 8 * m +
                  2 * q));
            c[16 * j + 4 * m + 2 * rr] = v.x;
            c[16 * j + 4 * m + 2 * rr + 1] = v.y;
          }
      for (int t = 0; t < a.T; ++t, ++gs) {
        chunk<0>(d, c, a, k, it, gs, wg, lane, row0, row1, t);
        chunk<1>(d, c, a, k, it, gs, wg, lane, row0, row1, t);
        chunk<2>(d, c, a, k, it, gs, wg, lane, row0, row1, t);
        chunk<3>(d, c, a, k, it, gs, wg, lane, row0, row1, t);
        chunk<4>(d, c, a, k, it, gs, wg, lane, row0, row1, t);
        chunk<5>(d, c, a, k, it, gs, wg, lane, row0, row1, t);
        chunk<6>(d, c, a, k, it, gs, wg, lane, row0, row1, t);
        chunk<7>(d, c, a, k, it, gs, wg, lane, row0, row1, t);
        // h_t is in ys and h_{t-1} read: the producer may reload the buffer
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        mbar_arrive(h_free);
      }
    }
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

// A row-major bf16 (rows x cols) matrix as a TMA map with boxes of 64
// columns (128 bytes) x box_rows, 128-byte swizzled; rows past the end
// read as zeros.
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

}  // namespace

// x (B, T, 256), h0, c0 (B, 256) bf16; w (1024, 512) bf16 and bias
// (1024,) float32 packed (`pack_w_serve`); ys (B, T, 256), h_T, c_T
// (B, 256) bf16.  All contiguous, x and h0 16-byte aligned.  Returns the
// launch's cudaError_t (cudaErrorNotSupported: no TMA encoder).
extern "C" int lstm_serve_launch(const void* x, const void* h0,
                                 const void* c0, const void* w,
                                 const float* bias, void* ys, void* h_t,
                                 void* c_t, int B, int T, void* stream) {
  if (B <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(lstm_serve_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint64_t cols = static_cast<uint64_t>(T) * kH;
  CUtensorMap mapX, mapH0, mapY, mapW;
  if (!make_map(&mapX, x, cols, B, kBM) || !make_map(&mapH0, h0, kH, B, kBM) ||
      !make_map(&mapY, ys, cols, B, kBM) ||
      !make_map(&mapW, w, 2 * kH, 4 * kH, kBN))
    return static_cast<int>(cudaErrorNotSupported);
  Args a;
  a.c0 = static_cast<const bf16*>(c0);
  a.bias = bias;
  a.ys = static_cast<bf16*>(ys);
  a.h_t = static_cast<bf16*>(h_t);
  a.c_t = static_cast<bf16*>(c_t);
  a.B = B;
  a.T = T;
  a.tiles = (B + kBM - 1) / kBM;
  lstm_serve_kernel<<<a.tiles < sms ? a.tiles : sms, kThreads, kSmem,
                      static_cast<cudaStream_t>(stream)>>>(mapX, mapH0, mapY,
                                                           mapW, a);
  return static_cast<int>(cudaGetLastError());
}
