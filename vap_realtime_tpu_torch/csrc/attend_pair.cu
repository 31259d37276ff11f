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
// denominator sums the unscaled weights.  A one-pass kernel cannot know
// the max in advance, so each row group keeps an ONLINE state (running
// max, denominator and value sums, rescaled by exp(old - new max) when the
// max grows), started at the current position (max s_cur, weight 1), and
// the row groups of a warp merge their states at their common max.  DEAD
// rows (age 1e9) give exp(-3.9e6 - mx) = 0 exactly, so all-DEAD rows give
// v_cur exactly.  Loads, lanes and row groups are those of K1-K4.
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
// copies, deeper pipelining) is later work; chip_smoke.py measures how
// far this version is from it.

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

// Online softmax state of one lane's row group: the running max m, the
// denominator d of weights exp(s - m), and the V output accumulators.
template <int V>
struct AccC {
  float m, d, o[V];
};

// Rescales `acc` to the max mn; exp(-inf - -inf) never occurs: a state
// already at mn keeps its scale 1.
template <int V>
__device__ __forceinline__ void rescale(AccC<V>& acc, float mn) {
  const float corr = acc.m == mn ? 1.f : expf(acc.m - mn);
  acc.d *= corr;
#pragma unroll
  for (int i = 0; i < V; ++i) acc.o[i] *= corr;
  acc.m = mn;
}

// Folds ring rows [0, n) into `acc` (row group g takes rows g, g + R, ...):
// s_r = sum_{head} k_r,d q_d (* sc_r) - age_r m_h, natural-log units;
// w_r = exp(s_r - max); d += w_r; o += w_r sc_r v_r.
template <typename C, int V, bool kScale>
__device__ __forceinline__ void fold_rows_compact(AccC<V>& acc,
                                                  const Rows<C>& rows, int D,
                                                  int group, const float* q,
                                                  float m) {
  constexpr int L = kDh / V;
  constexpr int R = 32 / L;
  for (int r0 = 0; r0 < rows.n; r0 += kUnroll * R) {
    float kk[kUnroll][V], vv[kUnroll][V];
    float ag[kUnroll], sc[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * R + group;
      ok[u] = r < rows.n;
      if (ok[u]) {
        const C* row = rows.k + static_cast<size_t>(r) * rows.stride;
        Vec<C, V>::load(row, kk[u]);
        Vec<C, V>::load(row + D, vv[u]);
        ag[u] = rows.ages[static_cast<size_t>(r) * rows.age_stride];
        sc[u] = kScale ? rows.scales[static_cast<size_t>(r) *
                                     rows.scale_stride]
                       : 1.f;
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) kk[u][i] = vv[u][i] = 0.f;
        ag[u] = kDead;
        sc[u] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) p = fmaf(kk[u][i], q[i], p);
      p = group_sum<L>(p);  // every lane of the warp takes part
      if (!ok[u]) continue;
      if constexpr (kScale) p *= sc[u];
      const float s = p - ag[u] * m;
      if (s > acc.m) rescale(acc, s);
      float w = expf(s - acc.m);
      acc.d += w;
      if constexpr (kScale) w *= sc[u];  // dequantise the value
#pragma unroll
      for (int i = 0; i < V; ++i) acc.o[i] = fmaf(w, vv[u][i], acc.o[i]);
    }
  }
}

// grid: 2*B blocks (block = b*2 + s); block: 32*H threads.  Ring rows
// only (the compact body has no staged form).
template <typename Q, typename C, bool kScale>
__global__ void attend_compact_kernel(const Args a) {
  constexpr int V = sizeof(C) == 1 ? 4 : 2;
  constexpr int L = kDh / V;
  const int b = blockIdx.x >> 1;
  const int s = blockIdx.x & 1;
  const int h = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = lane / L;
  const int D = a.D;
  const int d = h * kDh + V * (lane % L);
  const size_t D4 = 4 * static_cast<size_t>(D);

  const size_t io = (static_cast<size_t>(b) * 2 + s) * D + d;
  float qv[V], kcv[V], vcv[V];
  Vec<Q, V>::load(static_cast<const Q*>(a.q) + io, qv);
  Vec<Q, V>::load(static_cast<const Q*>(a.k_cur) + io, kcv);
  Vec<Q, V>::load(static_cast<const Q*>(a.v_cur) + io, vcv);
  const float m = exp2f(-8.f * static_cast<float>(h + 1) / a.H);
  float s_cur = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) s_cur = fmaf(kcv[i], qv[i], s_cur);
  s_cur = group_sum<L>(s_cur);

  // the current position (weight exp(s_cur - m) = 1 at m = s_cur) is
  // counted by row group 0; the other groups start empty
  AccC<V> acc;
  acc.m = group == 0 ? s_cur : __int_as_float(0xff800000);  // -inf
  acc.d = group == 0 ? 1.f : 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) acc.o[i] = group == 0 ? vcv[i] : 0.f;

  const C* cache = static_cast<const C*>(a.cache);
  Rows<C> ring{cache + (static_cast<size_t>(b) * a.P + a.phase) * a.T * D4 +
                   2 * static_cast<size_t>(s) * D + d,
               D4,
               a.age + static_cast<size_t>(b) * a.T,
               1,
               kScale ? a.scale + b * a.scale_b : nullptr,
               1,
               a.T};
  fold_rows_compact<C, V, kScale>(acc, ring, D, group, qv, m);

  // combine the row groups of the warp at their common max
#pragma unroll
  for (int o = L; o < 32; o <<= 1) {
    AccC<V> other;
    other.m = __shfl_xor_sync(0xffffffffu, acc.m, o);
    other.d = __shfl_xor_sync(0xffffffffu, acc.d, o);
#pragma unroll
    for (int i = 0; i < V; ++i)
      other.o[i] = __shfl_xor_sync(0xffffffffu, acc.o[i], o);
    const float mn = fmaxf(acc.m, other.m);
    rescale(acc, mn);
    rescale(other, mn);
    acc.d += other.d;
#pragma unroll
    for (int i = 0; i < V; ++i) acc.o[i] += other.o[i];
  }
  if (group == 0) {
    float out[V];
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = acc.o[i] / acc.d;
    Vec<Q, V>::store(static_cast<Q*>(a.out) + io, out);
  }
}

template <typename Q, typename C, bool kScale>
int launch_compact(const Args& a, cudaStream_t stream) {
  attend_compact_kernel<Q, C, kScale><<<2 * a.B, 32 * a.H, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Q>
int dispatch_compact(int cache_dtype, const Args& a, cudaStream_t stream) {
  if (cache_dtype == 2)
    return a.scale != nullptr ? launch_compact<Q, int8_t, true>(a, stream)
                              : launch_compact<Q, int8_t, false>(a, stream);
  return launch_compact<Q, Q, false>(a, stream);
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
// 1/sqrt(D) only (natural-log units).  Returns the launch's cudaError_t.
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
