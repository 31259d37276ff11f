// Shared pieces of the 3xTF32 tensor-core kernels (cpc_conv_tail.cu,
// lstm_scan.cu): the TF32 split, the m16n8k8 TF32 MMA, 16-byte cp.async,
// and float32 / bf16 element loads and stores.  Included inside each
// kernel file's anonymous namespace, after <cuda_bf16.h> and <cstdint>.
//
// 3xTF32: a float32 operand x is split into hi = tf32(x) and lo =
// tf32(x - hi), both rounded as cvt.rna.tf32.f32 rounds (to nearest, ties
// away from zero, the 13 low mantissa bits cleared; truncation would
// roughly double the error), and a product a b is taken as hi_a hi_b +
// (hi_a lo_b + lo_a hi_b) with float32 accumulators: the lo_a lo_b term
// and the roundings of lo leave ~2^-22 relative, float32's own accuracy
// for sums this short.  `tf32_split` in ops/cuda/tf32.py emulates the
// split bit for bit.

#pragma once

// x rounded to TF32 (returned as the float32 bit pattern): the rounding
// of cvt.rna.tf32.f32 for finite x, as two integer operations (half a
// TF32 ulp added to the sign-magnitude bits, then the low 13 bits
// cleared).  ptxas expands cvt.rna with a NaN / Inf guard, which made
// both kernels slower on the H100.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b for one m16n8k8 tile: a row-major (16 x 8), b column-major
// (8 x 8), TF32 operands, float32 accumulators.  Fragments (lane = 4 g +
// q): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4); b0 (q,
// g), b1 (q + 4, g); d0 (g, 2q), d1 (g, 2q + 1), d2 (g + 8, 2q), d3 (g +
// 8, 2q + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[j] += a b[j] in 3xTF32 for N column tiles sharing one A fragment:
// per accumulator the two correction products first, then hi hi; issued
// in passes over the N tiles (all lo_a hi_b, then hi_a lo_b, then hi_a
// hi_b), so consecutive MMAs never wait on one accumulator.  With lo_a =
// 0 (A exact in TF32, e.g. from bf16) pass kAExact and the lo_a pass is
// skipped.
template <bool kAExact, int N>
__device__ __forceinline__ void mma_3xtf32(float (&d)[N][4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[N][2],
                                           const uint32_t (&b_lo)[N][2]) {
  if (!kAExact) {
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(d[j], a_lo, b_hi[j][0], b_hi[j][1]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], a_hi, b_lo[j][0], b_lo[j][1]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], a_hi, b_hi[j][0], b_hi[j][1]);
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

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
struct E;

template <>
struct E<float> {
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
  static __device__ __forceinline__ void st(float* p, float v) { *p = v; }
};

template <>
struct E<__nv_bfloat16> {
  static __device__ __forceinline__ float ld(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};
