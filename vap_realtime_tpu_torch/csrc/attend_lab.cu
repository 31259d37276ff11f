// The attend-lab ablations, for Hopper (sm_90a).  Hand-written replacement
// of the TPU lab kernel `launch` (tools/attend_lab.py:304) over its
// ablated bodies (attend_lab.py:51-262): each reads ONE phase plane
// cache[b, phase] (T rows of k|v for both twin sets, 4D wide) and writes
// (B, 2D).  The lab times them to split the attend kernel's time into
// parts.  Modes (scale = 1/sqrt(D), m_h = 2^(-8(h+1)/H) in natural units,
// S(x) = sum of x over the lanes of head h; q, kc, vc of set s):
//   dma     `_k_dma` / `_k_q8dma`: out = sum_t plane[t, :2D] (set 0's k|v);
//           the set-1 blocks read their half too (the DMA floor reads the
//           whole plane) and store only under a flag that is never set
//   mxu     `_k_mxu`: out = sum_t S(k q) v, no softmax
//   nomax   `_bcast_body` modes, s_t = S(k q) scale - age_t m_h,
//   noexp     s_cur = S(kc q) scale; w = exp(min(s, 60)) (noexp:
//   f32out    min(s, 60)); out = (sum_t w v + w_cur vc) / (sum_t w +
//   nodenom   w_cur); f32out keeps w * v in float32; nodenom: out =
//   noout     sum_t w v + vc; noout: out = w_0 / (sum_t w + w_cur);
//   bf16exp   bf16exp: w = bf16(exp(bf16(s - mx))), mx = max(max_t s,
//             s_cur), the products with bf16(v) rounded to bf16
//   q8glb   `_k_q8glb` (int8 codes): q prescaled by log2(e) scale,
//           arg = S((k - kc) q) - age m_h, w = exp2(min(arg, 86)),
//           out = (C_V sum_t w v + vc) / (sum_t w + 1), C_V = 0.0123
//   v5      `_k_v5`: q prescaled, arg = S(k q) - (age m_h + S(kc q)),
//           w = exp2(min(arg, 86)), out = (sum_t w v + vc) / (sum_t w + 1)
// Where the TPU body rounds to q's dtype (`k * q`, `(k - kc) * q`,
// `w.astype(v.dtype) * v`), so does this kernel, so that an ablation
// removes work from the body it models and nothing else.  The production
// bodies of the lab (`bcast`, `compact`, `q8_row`) are the serving kernels
// (attend_pair.cu); the lab calls them there.
//
// Design: the K1 block layout of attend_pair.cu — a warp per (stream, set,
// head), lanes loading V adjacent elements of a row (V = 2 for float and
// bf16, 4 for int8, two rows per warp load), four row steps in flight, the
// head sum a butterfly over a row group's lanes, row groups combined at
// the end — with kStreams streams per block (the counterpart of the TPU
// grid's stream block Bb): grid 2 * ceil(B / kStreams) blocks of 32 H
// kStreams threads.  Rows past T are skipped (not padded as DEAD rows:
// the ablations without an exp would not zero them).  bf16exp needs the
// max before its rounding, so it keeps the T scores of a warp in shared
// memory and reads v in a second pass over the rows.
//
// Bound on the H100 (3.35 TB/s): bytes, the phase plane read once (bf16
// 0.42 GB at B=4096, T=50: 0.125 ms; int8 half) plus q, kc, vc, age and
// out for the modes that read them; noout and bf16exp read k in one pass
// and (bf16exp) v in another, noout no v at all.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

#include "attend_common.cuh"

enum Mode : int {
  kDma = 0,
  kMxu,
  kNomax,
  kNoexp,
  kF32out,
  kNodenom,
  kNoout,
  kBf16exp,
  kQ8glb,
  kV5,
  kModes
};

constexpr float kCv = 0.0123f;  // `_k_q8glb`'s compile-time value scale

// x rounded to T's precision.
template <typename T>
__device__ __forceinline__ float rnd(float x);

template <>
__device__ __forceinline__ float rnd<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct LabArgs {
  const void* cache;       // (B, P, T, 4D)
  const void* q;           // q, kc, vc, out: (B, 2D), set s at column sD
  const void* kc;
  const void* vc;
  const float* age;        // (B, T)
  void* out;
  int B, P, T, D, H, phase;
  float scale;             // the bcast modes' score scale 1/sqrt(D)
  int sink;                // dma: the set-1 blocks store too (never set)
};

template <int kMode>
constexpr bool kBcast = kMode >= kNomax && kMode <= kBf16exp;

template <typename Q, typename C, int kMode, int kStreams>
__global__ void attend_lab_kernel(const LabArgs a) {
  constexpr int V = sizeof(C) == 1 ? 4 : 2;  // elements per lane
  constexpr int L = kDh / V;                 // lanes per row
  constexpr int R = 32 / L;                  // rows per warp load
  constexpr bool kLoadV = kMode != kNoout && kMode != kBf16exp;
  constexpr bool kLoadAge = kMode != kDma && kMode != kMxu;
  extern __shared__ float scores[];          // bf16exp: T per warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = (blockIdx.x >> 1) * kStreams + warp / a.H;
  const int s = blockIdx.x & 1;
  const int h = warp % a.H;
  if (b >= a.B) return;
  const int group = lane / L;
  const int D = a.D;
  const int d = h * kDh + V * (lane % L);
  const size_t D4 = 4 * static_cast<size_t>(D);
  const size_t io = (static_cast<size_t>(b) * 2 + s) * D + d;
  const C* plane = static_cast<const C*>(a.cache) +
                   (static_cast<size_t>(b) * a.P + a.phase) * a.T * D4 +
                   2 * static_cast<size_t>(s) * D + d;
  const float* ages = a.age + static_cast<size_t>(b) * a.T;
  const float m = exp2f(-8.f * static_cast<float>(h + 1) / a.H);

  float qv[V] = {}, kcv[V] = {}, vcv[V] = {};
  if constexpr (kMode != kDma)
    Vec<Q, V>::load(static_cast<const Q*>(a.q) + io, qv);
  if constexpr (kMode != kDma && kMode != kMxu) {
    Vec<Q, V>::load(static_cast<const Q*>(a.kc) + io, kcv);
    if constexpr (kMode != kNoout)
      Vec<Q, V>::load(static_cast<const Q*>(a.vc) + io, vcv);
  }
  float s_cur = 0.f;
  if constexpr (kBcast<kMode> || kMode == kV5) {
#pragma unroll
    for (int i = 0; i < V; ++i) s_cur += rnd<Q>(kcv[i] * qv[i]);
    s_cur = group_sum<L>(s_cur);
    if constexpr (kBcast<kMode>) s_cur *= a.scale;
  }

  float denom = 0.f, w0 = 0.f, mx = __int_as_float(0xff800000);  // -inf
  float o[V] = {}, ov[V] = {};  // ov: dma's v sums
  for (int r0 = 0; r0 < a.T; r0 += kUnroll * R) {
    float kk[kUnroll][V], vv[kUnroll][V], ag[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * R + group;
#pragma unroll
      for (int i = 0; i < V; ++i) kk[u][i] = vv[u][i] = 0.f;
      ag[u] = 0.f;
      if (r < a.T) {
        const C* row = plane + static_cast<size_t>(r) * D4;
        Vec<C, V>::load(row, kk[u]);
        if constexpr (kLoadV) Vec<C, V>::load(row + D, vv[u]);
        if constexpr (kLoadAge) ag[u] = ages[r];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * R + group;
      if constexpr (kMode == kDma) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          o[i] += kk[u][i];
          ov[i] += vv[u][i];
        }
        continue;
      }
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i)
        p += kMode == kQ8glb ? rnd<Q>(rnd<Q>(kk[u][i] - kcv[i]) * qv[i])
                             : rnd<Q>(kk[u][i] * qv[i]);
      p = group_sum<L>(p);  // every lane of the warp takes part
      if (r >= a.T) continue;
      float w = 0.f;
      if constexpr (kMode == kMxu) {
#pragma unroll
        for (int i = 0; i < V; ++i) o[i] = fmaf(p, vv[u][i], o[i]);
        continue;
      } else if constexpr (kBcast<kMode>) {
        const float sc = p * a.scale - ag[u] * m;
        if constexpr (kMode == kBf16exp) {
          if (lane % L == 0) scores[warp * a.T + r] = sc;
          mx = fmaxf(mx, sc);
          continue;
        }
        w = kMode == kNoexp ? fminf(sc, 60.f) : expf(fminf(sc, 60.f));
        if constexpr (kMode == kNoout) {
          denom += w;
          if (r == 0) w0 = w;
          continue;
        }
      } else if constexpr (kMode == kQ8glb) {
        w = exp2f(fminf(p - ag[u] * m, 86.f));
      } else {  // kV5
        w = exp2f(fminf(p - (ag[u] * m + s_cur), 86.f));
      }
      if constexpr (kMode != kNodenom) denom += w;
      if constexpr (kMode == kF32out) {
#pragma unroll
        for (int i = 0; i < V; ++i) o[i] = fmaf(w, vv[u][i], o[i]);
      } else {
        const float wr = rnd<Q>(w);
#pragma unroll
        for (int i = 0; i < V; ++i) o[i] += rnd<Q>(wr * vv[u][i]);
      }
    }
  }

  if constexpr (kMode == kBf16exp) {
    // second pass: the max of the warp's rows and the current position,
    // then the bf16 weights and their products with bf16 values
#pragma unroll
    for (int off = L; off < 32; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    mx = fmaxf(mx, s_cur);
    __syncwarp();
    for (int r0 = 0; r0 < a.T; r0 += kUnroll * R) {
      float vv[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * R + group;
        if (r < a.T) Vec<C, V>::load(plane + static_cast<size_t>(r) * D4 + D,
                                     vv[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * R + group;
        if (r >= a.T) continue;
        const float w = rnd<__nv_bfloat16>(
            expf(rnd<__nv_bfloat16>(scores[warp * a.T + r] - mx)));
        denom += w;
#pragma unroll
        for (int i = 0; i < V; ++i)
          o[i] += rnd<__nv_bfloat16>(w * rnd<__nv_bfloat16>(vv[u][i]));
      }
    }
  }

  // combine the row groups of the warp
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
    denom += __shfl_xor_sync(0xffffffffu, denom, off);
    w0 += __shfl_xor_sync(0xffffffffu, w0, off);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      o[i] += __shfl_xor_sync(0xffffffffu, o[i], off);
      ov[i] += __shfl_xor_sync(0xffffffffu, ov[i], off);
    }
  }
  if (group != 0) return;
  Q* out = static_cast<Q*>(a.out);
  if constexpr (kMode == kDma) {
    if (s == 0 || a.sink) {
      const size_t base = static_cast<size_t>(b) * 2 * D + d;
      Vec<Q, V>::store(out + base, o);
      Vec<Q, V>::store(out + base + D, ov);
    }
    return;
  }
  float res[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if constexpr (kMode == kMxu) {
      res[i] = o[i];
    } else if constexpr (kMode == kNodenom) {
      res[i] = o[i] + vcv[i];
    } else if constexpr (kMode == kNoout) {
      res[i] = w0 / (denom + expf(fminf(s_cur, 60.f)));
    } else if constexpr (kMode == kQ8glb) {
      res[i] = (o[i] * kCv + vcv[i]) / (denom + 1.f);
    } else if constexpr (kMode == kV5) {
      res[i] = (o[i] + vcv[i]) / (denom + 1.f);
    } else {
      const float wc = kMode == kNoexp      ? fminf(s_cur, 60.f)
                       : kMode == kBf16exp ? expf(s_cur - mx)
                                           : expf(fminf(s_cur, 60.f));
      res[i] = (o[i] + wc * vcv[i]) / (denom + wc);
    }
  }
  Vec<Q, V>::store(out + io, res);
}

template <typename Q, typename C, int kMode>
int launch(const LabArgs& a, int streams, cudaStream_t stream) {
  const int grid = 2 * ((a.B + streams - 1) / streams);
  const size_t smem =
      kMode == kBf16exp ? sizeof(float) * streams * a.H * a.T : 0;
  if (streams == 1)
    attend_lab_kernel<Q, C, kMode, 1><<<grid, 32 * a.H, smem, stream>>>(a);
  else
    attend_lab_kernel<Q, C, kMode, 2><<<grid, 64 * a.H, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Q>
int dispatch(int mode, bool int8, const LabArgs& a, int streams,
             cudaStream_t st) {
  if (int8) {  // the lab's int8 bodies: q8_dma, q8_glb
    if (mode == kDma) return launch<Q, int8_t, kDma>(a, streams, st);
    if (mode == kQ8glb) return launch<Q, int8_t, kQ8glb>(a, streams, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (mode) {
    case kDma: return launch<Q, Q, kDma>(a, streams, st);
    case kMxu: return launch<Q, Q, kMxu>(a, streams, st);
    case kNomax: return launch<Q, Q, kNomax>(a, streams, st);
    case kNoexp: return launch<Q, Q, kNoexp>(a, streams, st);
    case kF32out: return launch<Q, Q, kF32out>(a, streams, st);
    case kNodenom: return launch<Q, Q, kNodenom>(a, streams, st);
    case kNoout: return launch<Q, Q, kNoout>(a, streams, st);
    case kBf16exp: return launch<Q, Q, kBf16exp>(a, streams, st);
    case kV5: return launch<Q, Q, kV5>(a, streams, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// mode: 0..9 in the order of `Mode` (dma, mxu, nomax, noexp, f32out,
// nodenom, noout, bf16exp, q8glb, v5).  dtype (q, kc, vc, out): 0 =
// float32, 1 = bfloat16; int8: the cache holds int8 codes (dma and q8glb
// only), else the cache has q's dtype.  q8glb and v5 take q prescaled by
// log2(e) / sqrt(D).  streams: streams per block, 1 or 2.  Returns the
// launch's cudaError_t (0 = success).
extern "C" int attend_lab_launch(int mode, int dtype, int int8,
                                 const void* cache, const void* q,
                                 const void* kc, const void* vc,
                                 const float* age, void* out, int B, int P,
                                 int T_rows, int D, int H, int phase,
                                 float scale, int streams, void* stream) {
  if (mode < 0 || mode >= kModes || (dtype != 0 && dtype != 1) ||
      (streams != 1 && streams != 2) || H <= 0 || 32 * H * streams > 1024 ||
      D != kDh * H || B <= 0 || T_rows <= 0 || phase < 0 || phase >= P)
    return static_cast<int>(cudaErrorInvalidValue);
  const LabArgs a{cache, q, kc, vc, age, out, B, P, T_rows, D, H, phase,
                  scale, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(mode, int8 != 0, a, streams, st)
                    : dispatch<__nv_bfloat16>(mode, int8 != 0, a, streams,
                                              st);
}
