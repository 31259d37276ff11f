// Twin single-query attention of one layer phase over the phase-major KV
// cache, for Hopper (sm_90a).  Hand-written replacement of the TPU kernel
// `fused_attend_pair` (vap_realtime_tpu/ops/pallas/attend.py:454), all of
// the bodies the serving step reaches:
//   K1 `_kernel_pair` (ring rows only) and K2 `_kernel_pair_st` (ring rows
//      + the S staged rows of the frame-major stage), float caches;
//   K3 the same bodies on an int8 cache and stage (quant="global": the
//      frozen per-stream scales are folded into q, k_cur, v_cur and the
//      output by the caller, so the body is K1/K2 on code values);
//   K4 `_kernel_pair_q` / `_kernel_pair_stq`: an int8 cache and stage with
//      one float32 scale per row (quant="row");
// K8 `fused_attend` (attend.py:396, body `_kernel`:311): the K1 body for
//      ONE k/v slot pair (B blocks instead of 2B), float caches only;
// and, as a second kernel, the compact body K10 (`impl="compact"`,
// `_kernel_pair_c`:282 and `_kernel_pair_cq`:296, math
// `_attend_math_compact`:201; attend_impl "pallas3", the port's "kernel3").
//
// K10, ring rows only, float / int8 caches (codes under the caller's
// frozen-scale fold, or with row scales):
//   q'    = q / sqrt(D)                             (prescaled by the caller)
//   s_r   = sum_{d in head h} k_r,d q'_d (* sc_r) - age_r * m_h,
//   s_cur = sum_{d in head h} kc_d q'_d,            m_h = 2^(-8(h+1)/H)
//   mx    = max(max_r s_r, s_cur)
//   w_r   = exp(s_r - mx),  w_cur = exp(s_cur - mx)
//   out   = (sum_r w_r sc_r v_r + w_cur v_cur) / (sum_r w_r + w_cur)
// in natural-log units, the max-shifted softmax of the TPU body; the
// denominator sums the unscaled weights.  DEAD rows (age 1e9) give
// exp(-3.9e6 - mx) = 0 exactly, so all-DEAD rows give v_cur exactly.
//
// K10 on float / bf16 caches (`attend_compact_kernel`): a one-pass kernel
// cannot know the max in advance, so each warp keeps an ONLINE state
// (running max, denominator and value sums, rescaled by exp(old - new
// max) when the max grows), started at the current position (max s_cur,
// weight 1).  Loads and lanes are those of K1/K2: a warp per head, a row
// per warp load, 2 head columns a lane.
//
// K10 on int8 caches (`attend_q8_kernel`, both the frozen-scale fold and
// row scales), redesigned for Hopper.  The K1-K4 layout (16 lanes a row,
// a char4 a lane, a 4-level shuffle sum, an exp on all 16 lanes and an
// online rescale a row step) bound it by issue, not by bytes: 43-44% of
// its bound.  Now a persistent block of 256 threads takes one stream
// (both sets) at a time, streams k, k + grid, ... (2 blocks an SM):
//   - the phase plane cache[b, p] (T rows of 4D bytes, one contiguous run:
//     51,200 B at T=50, D=256) comes into shared memory as ONE bulk copy
//     (cp.async.bulk), completed on an mbarrier; its ages and row scales
//     by 4-byte cp.async copies; q, k_cur and v_cur are loaded into
//     registers a stream ahead;
//   - a ring of 2 stages a block: stream i + 1's plane is in flight while
//     stream i is computed, so an SM always has 100-200 KB on the way;
//   - a plane longer than a stage (52 KB) comes in chunks of rows through
//     the same ring, any T;
//   - scores: thread (set, head, part) holds 16 q values in registers and
//     reads its 16-byte K slice of a row (a warp reads 512 contiguous
//     bytes: no bank conflicts), one partial sum per 4 codes; 2 shuffles
//     sum a head; the compact score
//     (times the row scale, minus age * m_h) goes to shared memory;
//   - the softmax once per (row, head), one warp per (set, head): max
//     (with the running max, which starts at s_cur), one exp a row, the
//     denominator over the unscaled weights, the row scale folded into
//     the weight after it; across chunks the state (max, denominator,
//     value sums) is rescaled by exp(old - new max) once per chunk;
//   - the weighted V sum: a thread owns 4 output columns of one row group
//     (2 groups at D=256, rows interleaved), reading 4 codes a row, the
//     current position counted by group 0 from the start; at the end the
//     groups add up in order and divide by the denominator;
//   - int8 codes become floats exactly by a byte permute into the mantissa
//     of 2^23 and one subtraction (`codes4`), not by the quarter-rate
//     int-to-float conversion.
//
// K1-K4 compute, for stream b, twin set s, phase p (one block each):
//   q'    = q * log2(e) / sqrt(D)                  (prescaled by the caller)
//   K1-K3: arg_r = sum_{d in head h} (k_r,d - kc_d) q'_d - age_r * m_h
//   K4:    arg_r = sc_r * sum_h k_r,d q'_d - age_r * m_h - sum_h kc_d q'_d
//   w_r   = exp2(min(arg_r, 86)),   m_h = 2^(-8(h+1)/H) * log2(e)
//   out   = (sum_r w_r u_r v_r + v_cur) / (sum_r w_r + 1),
//           u_r = sc_r for K4, else 1
// over the T ring rows of cache[b, p, :, 2sD:(2s+2)D] and, when a stage
// is given, the S staged rows stage[i, b, p*4D + 2sD : ...].  The softmax
// is shifted by the CURRENT position's score, so the current weight is
// exactly 1, no running max is needed and the denominator is >= 1 (no
// NaN even when every row is dead).  Dead rows carry age = 1e9: their
// argument is <= -5.6e6 and exp2 underflows to exactly 0.  With row
// scales the denominator sums the UNSCALED weights (the scale dequantises
// the value, not the probability), as in the TPU kernel.
//
// Design (a simple, right first version): one block of H warps per
// (stream, twin set) — for K8 per stream, the set fixed by the slot pair's
// column half (slot_k % 4) / 2; warp h owns head h (Dh = 64).  Each lane loads V
// adjacent elements of a row as one 4- or 8-byte vector: V = 2 for float
// and bf16 caches (float2 / bf16x2), so the 32 lanes of a warp cover one
// row's 64 head columns, one 128/256-byte run; V = 4 for int8 (char4), so
// 16 lanes cover a row and a warp takes TWO rows per load, two 64-byte
// runs (with one row per warp an int8 load moved 64 bytes per warp
// instruction, and the kernel ran at a quarter of its bound).  The head
// sum is a butterfly of __shfl_xor_sync over the lanes of one row; the
// row groups of a warp keep their own partial sums and combine them with
// one more butterfly at the end.  Four row steps are processed at a time
// with their loads issued first, which keeps several rows in flight per
// warp.  The cache element type (float, bf16, int8) is a template
// parameter separate from the q/out type; int8 codes are converted to
// float32 in registers, so the dequantised cache never exists in memory.
// All arithmetic accumulates in float32.
//
// Bound on the H100 (3.35 TB/s HBM): memory.  At B=4096, T=50, S=8 one
// launch must read the phase plane and the stage slice once: bf16 419 +
// 67 MB (~0.15 ms); int8 210 + 34 MB plus the row scales (~0.078 ms); K10
// reads the phase plane only (bf16 ~0.13 ms, int8 ~0.068 ms).  The
// FLOPs (~6 per element) are negligible.  K8 reads one (T, 2D) half-plane:
// bf16 210 MB at B=4096 (~0.065 ms).  Reaching that bound (TMA bulk
// copies, deeper pipelining) is later work for every body but K10's int8
// one (above); chip_smoke.py measures how far each is from it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClamp = 86.f;
constexpr float kDead = 1e9f;

#include "attend_common.cuh"

// Running state of one lane: the softmax denominator of its row group's
// rows (identical on the group's lanes) and its V output accumulators.
template <int V>
struct Acc {
  float denom, o[V];
};

// One strided sequence of rows: row r's k vector lives at k + r * stride,
// its v vector D elements later, its age at ages[r * age_stride] and (row
// scales only) its scale at scales[r * scale_stride].
template <typename C>
struct Rows {
  const C* k;
  size_t stride;
  const float* ages;
  size_t age_stride;
  const float* scales;
  size_t scale_stride;
  int n;
};

// Folds rows [0, n) into `acc`: row group g of the warp takes rows
// g, g + R, g + 2R, ...  kScale: per-row dequant scales with the explicit
// current score s_cur (K4); otherwise the current score is folded into
// the shift as (k - kc) . q (K1-K3).
template <typename C, int V, bool kScale>
__device__ __forceinline__ void fold_rows(Acc<V>& acc, const Rows<C>& rows,
                                          int D, int group, const float* q,
                                          const float* kc, float s_cur,
                                          float m) {
  constexpr int L = kDh / V;   // lanes per row
  constexpr int R = 32 / L;    // rows per warp load
  for (int r0 = 0; r0 < rows.n; r0 += kUnroll * R) {
    float kk[kUnroll][V], vv[kUnroll][V];
    float ag[kUnroll], sc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * R + group;
      if (r < rows.n) {
        const C* row = rows.k + static_cast<size_t>(r) * rows.stride;
        Vec<C, V>::load(row, kk[u]);
        Vec<C, V>::load(row + D, vv[u]);
        ag[u] = rows.ages[static_cast<size_t>(r) * rows.age_stride];
        sc[u] = kScale ? rows.scales[static_cast<size_t>(r) *
                                     rows.scale_stride]
                       : 1.f;
      } else {  // past the end: a dead row, weight exactly 0
#pragma unroll
        for (int i = 0; i < V; ++i) {
          kk[u][i] = kScale ? 0.f : kc[i];
          vv[u][i] = 0.f;
        }
        ag[u] = kDead;
        sc[u] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i)
        p = fmaf(kScale ? kk[u][i] : kk[u][i] - kc[i], q[i], p);
      p = group_sum<L>(p);
      if constexpr (kScale) p = p * sc[u] - s_cur;
      float w = exp2f(fminf(fmaf(-ag[u], m, p), kClamp));
      acc.denom += w;
      if constexpr (kScale) w *= sc[u];  // dequantise the value
#pragma unroll
      for (int i = 0; i < V; ++i) acc.o[i] = fmaf(w, vv[u][i], acc.o[i]);
    }
  }
}

// Launch arguments: untyped pointers, element strides.
struct Args {
  const void* cache;
  const void* q;
  const void* k_cur;
  const void* v_cur;
  const float* age;          // (B, T)
  const float* scale;        // row scales of the phase, stream b at b*scale_b
  long long scale_b;
  const void* stage;         // (S, B, P*4D) or nullptr
  const float* stage_age;    // (S, B)
  const float* stage_scale;  // row i of stream b at i*sscale_s + b*sscale_b
  long long sscale_s, sscale_b;
  void* out;
  int B, P, T, D, H, S, phase;
  int half;  // one-set launches (K8): the pair's column half of the phase
};

// grid: kSets*B blocks (block = b*kSets + s); block: 32*H threads.  kSets
// = 2: the twin sets, q/k_cur/v_cur/out (B, 2, D); kSets = 1 (K8): set
// a.half of the phase, q/k_cur/v_cur/out (B, D).
template <typename Q, typename C, bool kScale, int kSets = 2>
__global__ void attend_pair_kernel(const Args a) {
  constexpr int V = sizeof(C) == 1 ? 4 : 2;  // elements per lane
  constexpr int L = kDh / V;                 // lanes per row
  const int b = kSets == 2 ? blockIdx.x >> 1 : blockIdx.x;
  const int s = kSets == 2 ? blockIdx.x & 1 : a.half;
  const int h = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = lane / L;                // row group within the warp
  const int D = a.D;
  const int d = h * kDh + V * (lane % L);    // column inside the set's D
  const size_t D4 = 4 * static_cast<size_t>(D);

  // q, k_cur, v_cur, out: (B, kSets, D) contiguous
  const size_t io =
      (static_cast<size_t>(b) * kSets + (kSets == 2 ? s : 0)) * D + d;
  float qv[V], kcv[V], vcv[V];
  Vec<Q, V>::load(static_cast<const Q*>(a.q) + io, qv);
  Vec<Q, V>::load(static_cast<const Q*>(a.k_cur) + io, kcv);
  Vec<Q, V>::load(static_cast<const Q*>(a.v_cur) + io, vcv);
  const float m = exp2f(-8.f * static_cast<float>(h + 1) / a.H) * kLog2e;
  float s_cur = 0.f;
  if constexpr (kScale) {
#pragma unroll
    for (int i = 0; i < V; ++i) s_cur = fmaf(kcv[i], qv[i], s_cur);
    s_cur = group_sum<L>(s_cur);
  }

  // the current position (weight exactly 1) is counted by row group 0
  Acc<V> acc;
  acc.denom = group == 0 ? 1.f : 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) acc.o[i] = group == 0 ? vcv[i] : 0.f;

  // ring rows: plane ((b*P + phase)*T + t)*4D, set s at column 2sD
  const C* cache = static_cast<const C*>(a.cache);
  Rows<C> ring{cache + (static_cast<size_t>(b) * a.P + a.phase) * a.T * D4 +
                   2 * static_cast<size_t>(s) * D + d,
               D4,
               a.age + static_cast<size_t>(b) * a.T,
               1,
               kScale ? a.scale + b * a.scale_b : nullptr,
               1,
               a.T};
  fold_rows<C, V, kScale>(acc, ring, D, group, qv, kcv, s_cur, m);

  if (a.stage != nullptr) {
    // staged rows: stage (S, B, P*4D), row i of stream b at
    // (i*B + b)*P*4D + phase*4D; ages (S, B)
    const C* stage = static_cast<const C*>(a.stage);
    Rows<C> st{stage + static_cast<size_t>(b) * a.P * D4 + a.phase * D4 +
                   2 * static_cast<size_t>(s) * D + d,
               static_cast<size_t>(a.B) * a.P * D4,
               a.stage_age + b,
               static_cast<size_t>(a.B),
               kScale ? a.stage_scale + b * a.sscale_b : nullptr,
               static_cast<size_t>(a.sscale_s),
               a.S};
    fold_rows<C, V, kScale>(acc, st, D, group, qv, kcv, s_cur, m);
  }

  // combine the row groups of the warp
#pragma unroll
  for (int o = L; o < 32; o <<= 1) {
    acc.denom += __shfl_xor_sync(0xffffffffu, acc.denom, o);
#pragma unroll
    for (int i = 0; i < V; ++i)
      acc.o[i] += __shfl_xor_sync(0xffffffffu, acc.o[i], o);
  }
  if (group == 0) {
    float out[V];
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = acc.o[i] / acc.denom;
    Vec<Q, V>::store(static_cast<Q*>(a.out) + io, out);
  }
}

// --- K10: the compact body (max-shifted softmax, ring rows only) -------

// Online softmax state of one lane: the running max m, the denominator d
// of weights exp(s - m), and its 2 V output accumulators.
struct AccC {
  float m, d, o[2];
};

// Rescales `acc` to the max mn; a state already at mn keeps its scale 1.
__device__ __forceinline__ void rescale(AccC& acc, float mn) {
  const float corr = acc.m == mn ? 1.f : expf(acc.m - mn);
  acc.d *= corr;
  acc.o[0] *= corr;
  acc.o[1] *= corr;
  acc.m = mn;
}

// Folds ring rows [0, n) of a float / bf16 cache into `acc` (the warp
// takes every row, a lane 2 head columns): s_r = sum_{head} k_r,d q_d -
// age_r m_h, natural-log units; w_r = exp(s_r - max); d += w_r;
// o += w_r v_r.
template <typename C>
__device__ __forceinline__ void fold_rows_compact(AccC& acc,
                                                  const Rows<C>& rows, int D,
                                                  const float* q, float m) {
  for (int r0 = 0; r0 < rows.n; r0 += kUnroll) {
    float kk[kUnroll][2], vv[kUnroll][2], ag[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u;
      if (r < rows.n) {
        const C* row = rows.k + static_cast<size_t>(r) * rows.stride;
        Vec<C, 2>::load(row, kk[u]);
        Vec<C, 2>::load(row + D, vv[u]);
        ag[u] = rows.ages[static_cast<size_t>(r) * rows.age_stride];
      } else {
        kk[u][0] = kk[u][1] = vv[u][0] = vv[u][1] = 0.f;
        ag[u] = kDead;
      }
    }
    // the kUnroll head sums first, their shuffles interleaved; a row past
    // the end (uniform over the warp) is dropped after its sum
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float p = fmaf(kk[u][1], q[1], fmaf(kk[u][0], q[0], 0.f));
      p = group_sum<32>(p);
      if (r0 + u >= rows.n) continue;
      const float s = p - ag[u] * m;
      if (s > acc.m) rescale(acc, s);
      const float w = expf(s - acc.m);
      acc.d += w;
      acc.o[0] = fmaf(w, vv[u][0], acc.o[0]);
      acc.o[1] = fmaf(w, vv[u][1], acc.o[1]);
    }
  }
}

// grid: 2*B blocks (block = b*2 + s); block: 32*H threads, warp h owns
// head h.  Float / bf16 caches (cache type = Q), ring rows only (the
// compact body has no staged form).
template <typename Q>
__global__ void attend_compact_kernel(const Args a) {
  const int b = blockIdx.x >> 1;
  const int s = blockIdx.x & 1;
  const int h = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int D = a.D;
  const int d = h * kDh + 2 * lane;
  const size_t D4 = 4 * static_cast<size_t>(D);

  const size_t io = (static_cast<size_t>(b) * 2 + s) * D + d;
  float qv[2], kcv[2], vcv[2];
  Vec<Q, 2>::load(static_cast<const Q*>(a.q) + io, qv);
  Vec<Q, 2>::load(static_cast<const Q*>(a.k_cur) + io, kcv);
  Vec<Q, 2>::load(static_cast<const Q*>(a.v_cur) + io, vcv);
  const float m = exp2f(-8.f * static_cast<float>(h + 1) / a.H);
  const float s_cur =
      group_sum<32>(fmaf(kcv[1], qv[1], fmaf(kcv[0], qv[0], 0.f)));

  // the state starts at the current position: max s_cur, weight 1
  AccC acc{s_cur, 1.f, {vcv[0], vcv[1]}};
  const Q* cache = static_cast<const Q*>(a.cache);
  Rows<Q> ring{cache + (static_cast<size_t>(b) * a.P + a.phase) * a.T * D4 +
                   2 * static_cast<size_t>(s) * D + d,
               D4,
               a.age + static_cast<size_t>(b) * a.T,
               1,
               nullptr,
               1,
               a.T};
  fold_rows_compact<Q>(acc, ring, D, qv, m);
  float out[2] = {acc.o[0] / acc.d, acc.o[1] / acc.d};
  Vec<Q, 2>::store(static_cast<Q*>(a.out) + io, out);
}

template <typename Q>
int launch_compact(const Args& a, cudaStream_t stream) {
  attend_compact_kernel<Q><<<2 * a.B, 32 * a.H, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// --- K10 on an int8 cache: the compact body on a bulk copy of the plane --

constexpr int kQ8Threads = 256;         // 8 warps, one stream at a time
constexpr int kQ8Stages = 2;            // ring of stages a block
constexpr int kQ8Stage = 52 * 1024;     // bytes of rows a stage holds
constexpr float kQ8Magic = 8388736.f;   // 2^23 + 128

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count));
}

// Wait until the phase of parity `parity` of barrier b has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t addr = smem_u32(b);
  uint32_t done;
  do {
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

// One bulk asynchronous copy of `bytes` (a multiple of 16, both ends
// 16-byte aligned) from global to shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A 4-byte asynchronous copy into shared memory (cp.async, this thread's
// current group).
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// Four int8 codes (one 32-bit word) -> four floats, exactly, without the
// quarter-rate int-to-float conversion: the code's byte with its sign bit
// flipped (x + 128) becomes the low mantissa byte of 2^23, so the float
// is 2^23 + 128 + x; one byte permute and one subtraction a code.
__device__ __forceinline__ void codes4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + i)) -
           kQ8Magic;
}

// N values of q's type Q as raw 32-bit words, loaded with 16-byte (or,
// for 4 bf16, 8-byte) loads and converted to float when used: a load
// issued a stream ahead stays in flight until then.
template <typename Q, int N>
struct Raw {
  static constexpr int W = N * static_cast<int>(sizeof(Q)) / 4;
  uint32_t w[W];
  __device__ __forceinline__ void load(const Q* p) {
    if constexpr (W % 4 == 0) {
#pragma unroll
      for (int i = 0; i < W / 4; ++i) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
    } else {
      static_assert(W == 2, "4 bf16 values");
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x;
      w[1] = v.y;
    }
  }
  __device__ __forceinline__ void to_float(float* f) const {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if constexpr (sizeof(Q) == 4) {
        f[i] = __uint_as_float(w[i]);
      } else {  // bf16 pairs, low half first: exact
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
      }
    }
  }
};

// Chunk geometry of a plane of T rows of `rb` bytes: `rows` a chunk (the
// whole plane when it fits a stage), `nchunks` chunks a stream.
struct Q8Geom {
  int rows, nchunks;
  __host__ __device__ Q8Geom(int T, int rb) {
    rows = static_cast<long long>(T) * rb <= kQ8Stage ? T : kQ8Stage / rb;
    nchunks = (T + rows - 1) / rows;
  }
};

// The block's dynamic shared memory: offsets (bytes) and total.
template <int H>
struct Q8Smem {
  static constexpr int D = kDh * H, RB = 4 * D;
  static constexpr int G = 32 * H >= kQ8Threads ? 1 : kQ8Threads / (32 * H);
  size_t buf, w, age, sc, red, stat, bar, total;
  __host__ __device__ explicit Q8Smem(const Q8Geom& g) {
    buf = 0;                                          // kQ8Stages x rows x RB
    w = buf + static_cast<size_t>(kQ8Stages) * g.rows * RB;  // 2H x rows
    age = w + sizeof(float) * 2 * H * g.rows;             // kQ8Stages x rows
    sc = age + sizeof(float) * kQ8Stages * g.rows;        // kQ8Stages x rows
    red = sc + sizeof(float) * kQ8Stages * g.rows;        // (G-1) x 2D
    stat = red + sizeof(float) * (G - 1) * 2 * D;         // 3 x 2H
    bar = (stat + sizeof(float) * 3 * 2 * H + 7) & ~size_t(7);
    total = bar + sizeof(uint64_t) * kQ8Stages;
  }
};

// grid: persistent, at most B blocks (block k takes streams k, k + grid,
// ...); block: 256 threads; dynamic shared memory Q8Smem<H>.  See the
// header for the design.
template <typename Q, bool kScale, int H>
__global__ void __launch_bounds__(kQ8Threads, 2)
    attend_q8_kernel(const Args a) {
  constexpr int D = kDh * H, RB = 4 * D, J = 2 * H;  // J: (set, head) pairs
  constexpr int U = 8 * H;                   // 16-byte K slices of a row
  constexpr int RPP = kQ8Threads / U;        // rows per K pass
  constexpr int Q4 = 32 * H;                 // 4-byte V quads of a row
  constexpr int G = Q8Smem<H>::G;            // V row groups
  constexpr int NQ = Q4 > kQ8Threads ? Q4 / kQ8Threads : 1;  // quads/thread
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = a.T;
  const Q8Geom geo(T, RB);
  const Q8Smem<H> lay(geo);
  const int TC = geo.rows, NC = geo.nchunks;
  int8_t* buf = reinterpret_cast<int8_t*>(smem + lay.buf);
  float* sw = reinterpret_cast<float*>(smem + lay.w);     // [j][row]
  float* sage = reinterpret_cast<float*>(smem + lay.age);
  float* ssc = reinterpret_cast<float*>(smem + lay.sc);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* mrun = reinterpret_cast<float*>(smem + lay.stat);  // running max
  float* drun = mrun + J;                                   // denominator
  float* corr = drun + J;                      // this chunk's rescale
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);
  const int tid = threadIdx.x;
  // this block's items: chunk c of its i-th stream is item i * NC + c
  const int k0 = blockIdx.x, grid = gridDim.x;
  const int nitems = (a.B - 1 - k0) / grid * NC + NC;
  const auto stream_of = [&](int it) { return k0 + it / NC * grid; };

  // item `it` into stage it % kQ8Stages: the rows by one bulk copy (thread
  // 0), their ages and scales by 4-byte cp.async copies; every thread
  // commits one cp.async group a call, empty past the last item
  const auto issue = [&](int it) {
    if (it < nitems) {
      const int st = it % kQ8Stages, b = stream_of(it);
      const int c0 = it % NC * TC, n = min(TC, T - c0);
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_load(buf + static_cast<size_t>(st) * TC * RB,
                  static_cast<const int8_t*>(a.cache) +
                      ((static_cast<size_t>(b) * a.P + a.phase) * T + c0) *
                          RB,
                  n * RB, &bar[st]);
      }
      const float* age = a.age + static_cast<size_t>(b) * T + c0;
      for (int r = tid; r < n; r += kQ8Threads) {
        copy4(&sage[st * TC + r], age + r);
        if constexpr (kScale)
          copy4(&ssc[st * TC + r], a.scale + b * a.scale_b + c0 + r);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (tid == 0) {
    for (int i = 0; i < kQ8Stages; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int it = 0; it < kQ8Stages; ++it) issue(it);

  // K pass thread: slice `unit` = (set, head, part) of rows r0 + k RPP,
  // its 16 q values in registers; threads of row slot 0 also take the
  // current position's score
  const int unit = tid % U, r0 = tid / U;
  const int kset = unit / (4 * H), khead = (unit >> 2) % H, part = unit & 3;
  const int kcol = kset * 2 * D + khead * kDh + part * 16;
  const int kj = kset * H + khead;
  const bool scur_thread = tid < (U < 32 ? 32 : U);  // whole warps
  const float mh = exp2f(-8.f * static_cast<float>(khead + 1) / H);
  const size_t qoff = static_cast<size_t>(kset) * D + khead * kDh + part * 16;
  // V pass thread: quads (4 output columns each) of rows g + k G
  const int g = G > 1 ? tid / Q4 : 0;
  int vcol[NQ], vj[NQ], voff[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int col = 4 * ((G > 1 ? tid % Q4 : tid) + i * kQ8Threads);
    const int set = col / D, cin = col % D;
    vcol[i] = set * 2 * D + D + cin;
    vj[i] = set * H + cin / kDh;
    voff[i] = set * D + cin;
  }
  // a stream's q, k_cur, v_cur, loaded one stream ahead
  Raw<Q, 16> nq, nkc;
  Raw<Q, 4> nvc[NQ];
  const auto prefetch = [&](int b) {
    const size_t io = static_cast<size_t>(b) * 2 * D;  // (B, 2, D)
    nq.load(static_cast<const Q*>(a.q) + io + qoff);
    if (scur_thread) nkc.load(static_cast<const Q*>(a.k_cur) + io + qoff);
    if (g == 0)
#pragma unroll
      for (int i = 0; i < NQ; ++i)
        nvc[i].load(static_cast<const Q*>(a.v_cur) + io + voff[i]);
  };
  prefetch(k0);

  float qv[16], acc[NQ][4], s_cur = 0.f;
  for (int it = 0; it < nitems; ++it) {
    const int st = it % kQ8Stages, c = it % NC, b = stream_of(it);
    const int n = min(TC, T - c * TC);
    const int8_t* rows = buf + static_cast<size_t>(st) * TC * RB;
    const float* cage = sage + st * TC;
    const float* csc = ssc + st * TC;
    if (c == 0) {  // a new stream: its q in registers, the next one's loads
      nq.to_float(qv);
      float kc[16];
      if (scur_thread) nkc.to_float(kc);
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        if (g == 0) {
          nvc[i].to_float(acc[i]);  // v_cur: weight 1 at the max s_cur
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
        }
      }
      if (b + grid < a.B) prefetch(b + grid);
      if (scur_thread) {
        s_cur = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) s_cur = fmaf(kc[i], qv[i], s_cur);
        s_cur += __shfl_xor_sync(0xffffffffu, s_cur, 1);
        s_cur += __shfl_xor_sync(0xffffffffu, s_cur, 2);
      }
    }
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kQ8Stages - 1)
                 : "memory");
    mbar_wait(&bar[st], (it / kQ8Stages) & 1);
    __syncthreads();  // the stage has landed; the last stream is written
    if (c == 0 && scur_thread && r0 == 0 && part == 0) {
      mrun[kj] = s_cur;  // the running max starts at s_cur, denominator 1
      drun[kj] = 1.f;
    }

    // scores s_r = (k_r . q)(* sc_r) - age_r m_h of (row, set, head) into
    // sw[j][r]: 16 codes a thread, the head's 4 threads summed by shuffles
    for (int rb = 0; rb < n; rb += 2 * RPP) {
      uint4 w[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = rb + u * RPP + r0;
        w[u] = r < n ? *reinterpret_cast<const uint4*>(rows + r * RB + kcol)
                     : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint32_t ws[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
        float pk[4];  // one partial sum a word: 4 short chains, not one
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float f[4];
          codes4(ws[k], f);
          pk[k] = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) pk[k] = fmaf(f[i], qv[4 * k + i], pk[k]);
        }
        float p = (pk[0] + pk[1]) + (pk[2] + pk[3]);
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        const int r = rb + u * RPP + r0;
        if (r < n && part == 0) {
          if constexpr (kScale) p *= csc[r];
          sw[kj * TC + r] = p - cage[r] * mh;
        }
      }
    }
    __syncthreads();

    // the softmax of each (set, head), one warp each: the chunk's max
    // (with the running max), one exp a row, the denominator over the
    // unscaled weights; the row scale folds into the weight after it
    const int warp = tid >> 5, lane = tid & 31;
    for (int j = warp; j < J; j += kQ8Threads / 32) {
      float* s = sw + j * TC;
      float mx = mrun[j];
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, s[r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float e = expf(s[r] - mx);
        sum += e;
        s[r] = kScale ? e * csc[r] : e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float m0 = mrun[j];
        const float cr = m0 == mx ? 1.f : expf(m0 - mx);
        corr[j] = cr;
        drun[j] = fmaf(drun[j], cr, sum);
        mrun[j] = mx;
      }
    }
    __syncthreads();

    // the weighted V sum: acc = acc * corr + sum_r w_r (sc_r) v_r
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const float cr = corr[vj[i]];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] *= cr;
    }
    for (int r = g; r < n; r += 4 * G) {
      uint32_t wv[4][NQ];
      float pw[4][NQ];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int rr = r + u * G;
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          wv[u][i] = rr < n ? *reinterpret_cast<const uint32_t*>(
                                  rows + rr * RB + vcol[i])
                            : 0u;  // past the end: codes 0, weight 0
          pw[u][i] = rr < n ? sw[vj[i] * TC + rr] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          float f[4];
          codes4(wv[u][i], f);
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(pw[u][i], f[k],
                                                        acc[i][k]);
        }
      }
    }
    __syncthreads();  // stage st, sw and the chunk's ages are free
    issue(it + kQ8Stages);
    if (c + 1 < NC) continue;

    // the stream's last chunk: row groups 1..G-1 hand their sums to group
    // 0, which adds them in order, divides by the denominator and writes
    if constexpr (G > 1) {
      if (g > 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          red[(g - 1) * 2 * D + 4 * (tid % Q4) + k] = acc[0][k];
      }
      __syncthreads();
      if (g == 0) {
#pragma unroll
        for (int gg = 1; gg < G; ++gg)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[0][k] += red[(gg - 1) * 2 * D + 4 * tid + k];
      }
    }
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const float d = drun[vj[i]];
        float out[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) out[k] = acc[i][k] / d;
        Vec<Q, 4>::store(static_cast<Q*>(a.out) +
                             static_cast<size_t>(b) * 2 * D + voff[i],
                         out);
      }
    }
  }
}

// The persistent grid of attend_q8_kernel<Q, kScale, H> with `smem`
// bytes: the blocks an SM holds times the SMs.  The kernel's shared
// memory attributes are set, and the grid computed, once per device and
// size (a host call per launch would cost more than the attribute).
template <typename Q, bool kScale, int H>
int q8_grid(size_t smem) {
  static int cached[64][2] = {};  // [device] = {smem, grid}
  void (*kernel)(Args) = attend_q8_kernel<Q, kScale, H>;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return -1;
  if (cached[dev][0] != static_cast<int>(smem) || cached[dev][1] <= 0) {
    int per_sm = 0, sms = 0;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess ||
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kQ8Threads, smem) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || per_sm <= 0)
      return -1;
    cached[dev][0] = static_cast<int>(smem);
    cached[dev][1] = per_sm * sms;
  }
  return cached[dev][1];
}

template <typename Q, bool kScale, int H>
int launch_q8(const Args& a, cudaStream_t stream) {
  const Q8Smem<H> lay(Q8Geom(a.T, 4 * kDh * H));
  const int grid = q8_grid<Q, kScale, H>(lay.total);
  if (grid <= 0) {
    const cudaError_t e = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e
                                             : cudaErrorInvalidConfiguration);
  }
  attend_q8_kernel<Q, kScale, H>
      <<<grid < a.B ? grid : a.B, kQ8Threads, lay.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Q, bool kScale>
int dispatch_q8(const Args& a, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<size_t>(p) % 16 == 0;
  };
  if (!aligned(a.cache) || !aligned(a.q) || !aligned(a.k_cur) ||
      !aligned(a.v_cur) || !aligned(a.out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch (a.H) {
    case 1: return launch_q8<Q, kScale, 1>(a, stream);
    case 2: return launch_q8<Q, kScale, 2>(a, stream);
    case 4: return launch_q8<Q, kScale, 4>(a, stream);
    case 8: return launch_q8<Q, kScale, 8>(a, stream);
    case 16: return launch_q8<Q, kScale, 16>(a, stream);
    case 32: return launch_q8<Q, kScale, 32>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Q>
int dispatch_compact(int cache_dtype, const Args& a, cudaStream_t stream) {
  if (cache_dtype == 2)
    return a.scale != nullptr ? dispatch_q8<Q, true>(a, stream)
                              : dispatch_q8<Q, false>(a, stream);
  return launch_compact<Q>(a, stream);
}

template <typename Q, typename C, bool kScale>
int launch(const Args& a, cudaStream_t stream) {
  attend_pair_kernel<Q, C, kScale><<<2 * a.B, 32 * a.H, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Q>
int dispatch(int cache_dtype, const Args& a, cudaStream_t stream) {
  if (cache_dtype == 2)
    return a.scale != nullptr ? launch<Q, int8_t, true>(a, stream)
                              : launch<Q, int8_t, false>(a, stream);
  return launch<Q, Q, false>(a, stream);
}

template <typename Q>
int launch_single(const Args& a, cudaStream_t stream) {
  attend_pair_kernel<Q, Q, false, 1><<<a.B, 32 * a.H, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (q, k_cur, v_cur, out): 0 = float32, 1 = bfloat16.  cache_dtype
// (cache and stage): the same as dtype, or 2 = int8.  scale == nullptr:
// no row scales (float caches, or int8 with the scales folded outside);
// otherwise int8 only, and with a stage stage_scale is required.  stage
// == nullptr (or S == 0) gives the ring-only body.  Returns the launch's
// cudaError_t (0 = success).
extern "C" int attend_pair_launch(
    int dtype, int cache_dtype, const void* cache, const void* q,
    const void* k_cur, const void* v_cur, const float* age,
    const float* scale, long long scale_b, const void* stage,
    const float* stage_age, const float* stage_scale, long long sscale_s,
    long long sscale_b, void* out, int B, int P, int T_rows, int D, int H,
    int S, int phase, void* stream) {
  if (H <= 0 || H > 32 || D != kDh * H || B <= 0 || T_rows <= 0 ||
      phase < 0 || phase >= P || S < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) stage = nullptr;
  const bool int8 = cache_dtype == 2;
  if (!int8 && cache_dtype != dtype)  // float caches: the q dtype
    return static_cast<int>(cudaErrorInvalidValue);
  if (scale != nullptr &&
      (!int8 || (stage != nullptr) != (stage_scale != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (scale == nullptr) stage_scale = nullptr;
  const Args a{cache,     q,           k_cur,    v_cur,    age,
               scale,     scale_b,     stage,    stage_age, stage_scale,
               sscale_s,  sscale_b,    out,      B,        P,
               T_rows,    D,           H,        S,        phase,
               0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(cache_dtype, a, st)
                    : dispatch<__nv_bfloat16>(cache_dtype, a, st);
}

// The compact body (K10, `_kernel_pair_c` / `_kernel_pair_cq`): the same
// arguments as attend_pair_launch without a stage; q prescaled by
// 1/sqrt(D) only (natural-log units).  An int8 cache takes the bulk-copy
// body: H a power of 2, and cache, q, k_cur, v_cur, out 16-byte aligned
// (cudaErrorMisalignedAddress otherwise).  Returns the launch's
// cudaError_t.
extern "C" int attend_compact_launch(int dtype, int cache_dtype,
                                     const void* cache, const void* q,
                                     const void* k_cur, const void* v_cur,
                                     const float* age, const float* scale,
                                     long long scale_b, void* out, int B,
                                     int P, int T_rows, int D, int H,
                                     int phase, void* stream) {
  if (H <= 0 || H > 32 || D != kDh * H || B <= 0 || T_rows <= 0 ||
      phase < 0 || phase >= P || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool int8 = cache_dtype == 2;
  if ((!int8 && cache_dtype != dtype) || (scale != nullptr && !int8))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{cache,   q,       k_cur,   v_cur,   age,
               scale,   scale_b, nullptr, nullptr, nullptr,
               0,       0,       out,     B,       P,
               T_rows,  D,       H,       0,       phase,
               0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch_compact<float>(cache_dtype, a, st)
                    : dispatch_compact<__nv_bfloat16>(cache_dtype, a, st);
}

// K8, the single-pair body: the K1 math for the k/v pair at column half
// `half` (0 or 1) of phase `phase`, float caches (cache dtype = dtype);
// q prescaled as for attend_pair_launch; q, k_cur, v_cur, out (B, D).
// Returns the launch's cudaError_t.
extern "C" int attend_single_launch(int dtype, const void* cache,
                                    const void* q, const void* k_cur,
                                    const void* v_cur, const float* age,
                                    void* out, int B, int P, int T_rows,
                                    int D, int H, int phase, int half,
                                    void* stream) {
  if (H <= 0 || H > 32 || D != kDh * H || B <= 0 || T_rows <= 0 ||
      phase < 0 || phase >= P || (half != 0 && half != 1) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{cache,   q,       k_cur,   v_cur,   age,
               nullptr, 0,       nullptr, nullptr, nullptr,
               0,       0,       out,     B,       P,
               T_rows,  D,       H,       0,       phase,
               half};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_single<float>(a, st)
                    : launch_single<__nv_bfloat16>(a, st);
}
