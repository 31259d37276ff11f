// Shared pieces of the attend kernels (attend_pair.cu, attend_lab.cu):
// the head width, the row-step unroll, the vector loads and stores of V
// consecutive row elements as floats, and the sum over one row group's
// lanes.  Included inside each kernel file's anonymous namespace.

#pragma once

constexpr int kDh = 64;     // head width: D = 64 * H
constexpr int kUnroll = 4;  // row steps whose loads are issued together

// V consecutive elements of a row <-> V floats.
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x;
    f[1] = v.y;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    f[0] = v.x;
    f[1] = v.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* f) {
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __float22bfloat162_rn(make_float2(f[0], f[1]));
  }
};

template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    Vec<__nv_bfloat16, 2>::load(p, f);
    Vec<__nv_bfloat16, 2>::load(p + 2, f + 2);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* f) {
    Vec<__nv_bfloat16, 2>::store(p, f);
    Vec<__nv_bfloat16, 2>::store(p + 2, f + 2);
  }
};

template <>
struct Vec<int8_t, 4> {  // int8 codes: exact in float32 (and in bf16)
  static __device__ __forceinline__ void load(const int8_t* p, float* f) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    f[0] = static_cast<float>(c.x);
    f[1] = static_cast<float>(c.y);
    f[2] = static_cast<float>(c.z);
    f[3] = static_cast<float>(c.w);
  }
};

// Sum over the L lanes of one row group (aligned groups of L lanes).
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
