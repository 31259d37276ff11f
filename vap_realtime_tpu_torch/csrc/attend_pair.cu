// Twin single-query attention of one layer phase over the phase-major KV
// cache, for Hopper (sm_90a).  Hand-written replacement of the TPU kernel
// `fused_attend_pair` (vap_realtime_tpu/ops/pallas/attend.py:454), both of
// its float bodies: `_kernel_pair` (ring rows only) and `_kernel_pair_st`
// (ring rows + the S staged rows of the frame-major stage).
//
// What it computes, for stream b, twin set s, phase p (one block each):
//   q'    = q * log2(e) / sqrt(D)                  (prescaled by the caller)
//   arg_r = sum_{d in head h} (k_r,d - kc_d) q'_d - age_r * m_h
//   w_r   = exp2(min(arg_r, 86)),   m_h = 2^(-8(h+1)/H) * log2(e)
//   out   = (sum_r w_r v_r + v_cur) / (sum_r w_r + 1)
// over the T ring rows of cache[b, p, :, 2sD:(2s+2)D] and, when a stage
// is given, the S staged rows stage[i, b, p*4D + 2sD : ...].  The softmax
// is shifted by the CURRENT position's score, so the current weight is
// exactly 1, no running max is needed and the denominator is >= 1 (no
// NaN even when every row is dead).  Dead rows carry age = 1e9: their
// argument is <= -5.6e6 and exp2 underflows to exactly 0.
//
// Design (a simple, right first version): one block of H warps per
// (stream, twin set); warp h owns head h (Dh = 64 = 32 lanes x 2), each
// lane loads two adjacent elements (one 4-byte bf16x2 or 8-byte float2),
// so a warp reads one contiguous 128/256-byte run of a k or v row.  The
// head sum is a butterfly of __shfl_xor_sync.  Rows are processed kUnroll
// at a time with their loads issued first, which keeps several rows in
// flight per warp.  All arithmetic accumulates in float32.
//
// Bound on the H100 (3.35 TB/s HBM): memory.  At B=4096, T=50, S=8, bf16,
// one launch must read the phase plane 4096*50*1024*2 B = 419 MB and the
// stage slice 8*4096*1024*2 B = 67 MB, ~0.49 GB: ~0.145 ms per launch,
// ~1.0 ms for the 7 launches of a step.  The FLOPs (~6 per element) are
// negligible.  Reaching that bound (TMA bulk copies, deeper pipelining) is
// later work; chip_smoke.py measures how far this version is from it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClamp = 86.f;
constexpr float kDead = 1e9f;
constexpr int kUnroll = 4;

template <typename T>
struct Pair;

template <>
struct Pair<float> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float2 v) {
    *reinterpret_cast<float2*>(p) = v;
  }
};

template <>
struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float2 v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Running state of one lane: the two output accumulators and the
// softmax denominator (identical on all lanes of a warp).
struct Acc {
  float denom, o0, o1;
};

// Folds rows [0, n) of a strided row sequence into `acc`: row r's k pair
// lives at k + r * stride, its v pair D elements later, its age at
// ages[r * age_stride].
template <typename T>
__device__ __forceinline__ void fold_rows(Acc& acc, const T* __restrict__ k,
                                          size_t stride, int D,
                                          const float* __restrict__ ages,
                                          size_t age_stride, int n,
                                          float2 q, float2 kc, float m) {
  for (int r0 = 0; r0 < n; r0 += kUnroll) {
    float2 kk[kUnroll], vv[kUnroll];
    float ag[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u;
      if (r < n) {
        const T* row = k + static_cast<size_t>(r) * stride;
        kk[u] = Pair<T>::load(row);
        vv[u] = Pair<T>::load(row + D);
        ag[u] = ages[static_cast<size_t>(r) * age_stride];
      } else {  // past the end: a dead row, weight exactly 0
        kk[u] = kc;
        vv[u] = make_float2(0.f, 0.f);
        ag[u] = kDead;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float p = (kk[u].x - kc.x) * q.x;
      p = fmaf(kk[u].y - kc.y, q.y, p);
      p = warp_sum(p);
      const float w = exp2f(fminf(fmaf(-ag[u], m, p), kClamp));
      acc.denom += w;
      acc.o0 = fmaf(w, vv[u].x, acc.o0);
      acc.o1 = fmaf(w, vv[u].y, acc.o1);
    }
  }
}

// grid: 2*B blocks (block = b*2 + s); block: 32*H threads.
template <typename T>
__global__ void attend_pair_kernel(const T* __restrict__ cache,
                                   const T* __restrict__ q,
                                   const T* __restrict__ k_cur,
                                   const T* __restrict__ v_cur,
                                   const float* __restrict__ age,
                                   const T* __restrict__ stage,
                                   const float* __restrict__ stage_age,
                                   T* __restrict__ out, int B, int P,
                                   int T_rows, int D, int H, int S,
                                   int phase) {
  const int b = blockIdx.x >> 1;
  const int s = blockIdx.x & 1;
  const int h = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d = h * (D / H) + 2 * lane;  // column inside the set's D
  const size_t D4 = 4 * static_cast<size_t>(D);

  // q, k_cur, v_cur, out: (B, 2, D) contiguous
  const size_t io = (static_cast<size_t>(b) * 2 + s) * D + d;
  const float2 qv = Pair<T>::load(q + io);
  const float2 kcv = Pair<T>::load(k_cur + io);
  const float2 vcv = Pair<T>::load(v_cur + io);
  const float m = exp2f(-8.f * static_cast<float>(h + 1) / H) * kLog2e;

  Acc acc{1.f, vcv.x, vcv.y};  // the current position: weight exactly 1

  // ring rows: plane ((b*P + phase)*T + t)*4D, set s at column 2sD
  const T* ring = cache + (static_cast<size_t>(b) * P + phase) * T_rows * D4 +
                  2 * static_cast<size_t>(s) * D + d;
  fold_rows<T>(acc, ring, D4, D, age + static_cast<size_t>(b) * T_rows, 1,
               T_rows, qv, kcv, m);

  if (stage != nullptr) {
    // staged rows: stage (S, B, P*4D), row i of stream b at
    // (i*B + b)*P*4D + phase*4D; ages (S, B)
    const T* st = stage + static_cast<size_t>(b) * P * D4 + phase * D4 +
                  2 * static_cast<size_t>(s) * D + d;
    fold_rows<T>(acc, st, static_cast<size_t>(B) * P * D4, D, stage_age + b,
                 static_cast<size_t>(B), S, qv, kcv, m);
  }
  Pair<T>::store(out + io, make_float2(acc.o0 / acc.denom,
                                       acc.o1 / acc.denom));
}

template <typename T>
void launch(const void* cache, const void* q, const void* k_cur,
            const void* v_cur, const float* age, const void* stage,
            const float* stage_age, void* out, int B, int P, int T_rows,
            int D, int H, int S, int phase, cudaStream_t stream) {
  attend_pair_kernel<T><<<2 * B, 32 * H, 0, stream>>>(
      static_cast<const T*>(cache), static_cast<const T*>(q),
      static_cast<const T*>(k_cur), static_cast<const T*>(v_cur), age,
      static_cast<const T*>(stage), stage_age, static_cast<T*>(out), B, P,
      T_rows, D, H, S, phase);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  stage == nullptr (or S == 0) gives
// the ring-only body.  Returns the launch's cudaError_t (0 = success).
extern "C" int attend_pair_launch(int dtype, const void* cache, const void* q,
                                  const void* k_cur, const void* v_cur,
                                  const float* age, const void* stage,
                                  const float* stage_age, void* out, int B,
                                  int P, int T_rows, int D, int H, int S,
                                  int phase, void* stream) {
  if (H <= 0 || H > 32 || D != 64 * H || B <= 0 || T_rows <= 0 ||
      phase < 0 || phase >= P || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) stage = nullptr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(cache, q, k_cur, v_cur, age, stage, stage_age, out, B, P,
                  T_rows, D, H, S, phase, st);
  else if (dtype == 1)
    launch<__nv_bfloat16>(cache, q, k_cur, v_cur, age, stage, stage_age, out,
                          B, P, T_rows, D, H, S, phase, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
