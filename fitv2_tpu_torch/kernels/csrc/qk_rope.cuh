// The per-head q/k LayerNorm (no affine) + split RoPE arithmetic of K2
// (qk_rope.cu), shared with K5 (fused_attention.cu), which applies it to
// the q and k rows it stages in shared memory:
//   x' = LN(x)                      stats in fp32, result cast to T
//   y  = x' * cos + [-x'[d:], x'[:d]] * sin   in T, d = Dh / 2
// Every elementwise step of the rotation is rounded to T, as the reference
// chain computes it in T (fitv2_tpu/ops/fused_qk_rope.py:36-58): the fp32
// tables are cast to T first, and the two products and the sum are each
// rounded (never contracted into a fused multiply-add).
//
// The arithmetic works on 32-bit words of T: one fp32 value, or two bf16
// values (elements 2i and 2i + 1, the low half first). In bf16 the rotation
// runs on the packed mul/add/sub.rn.bf16x2, each instruction rounding two
// values once, which is what the reference's fp32 op and cast give (see
// wmul); fp32 -> bf16 conversions issue at a fraction of the fp32 rate, so
// only the LayerNorm result is converted, two values an instruction.
#pragma once

#include "common.cuh"

namespace fitv2 {

template <typename T>
constexpr int kWordElems = 4 / sizeof(T);

__device__ __forceinline__ void to_floats(unsigned w, float (&f)[1]) {
  f[0] = __uint_as_float(w);
}
__device__ __forceinline__ void to_floats(unsigned w, float (&f)[2]) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned from_floats(const float (&f)[1]) {
  return __float_as_uint(f[0]);
}
__device__ __forceinline__ unsigned from_floats(const float (&f)[2]) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(f[0], f[1]);  // RN
  return *reinterpret_cast<const unsigned*>(&p);
}

// Each op rounded to T, never contracted into a fused multiply-add. A bf16
// x bf16 product is exact in fp32 and the sum of two bf16 values either
// exact in fp32 or off by less than a quarter bf16 ulp, so rounding once to
// bf16 gives what the reference's fp32 op followed by a cast to bf16 gives.
template <typename T>
__device__ __forceinline__ unsigned wmul(unsigned a, unsigned b);
template <typename T>
__device__ __forceinline__ unsigned wadd(unsigned a, unsigned b);
template <typename T>
__device__ __forceinline__ unsigned wsub(unsigned a, unsigned b);
template <>
__device__ __forceinline__ unsigned wmul<float>(unsigned a, unsigned b) {
  return __float_as_uint(__fmul_rn(__uint_as_float(a), __uint_as_float(b)));
}
template <>
__device__ __forceinline__ unsigned wadd<float>(unsigned a, unsigned b) {
  return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
}
template <>
__device__ __forceinline__ unsigned wsub<float>(unsigned a, unsigned b) {
  return __float_as_uint(__fsub_rn(__uint_as_float(a), __uint_as_float(b)));
}
template <>
__device__ __forceinline__ unsigned wmul<__nv_bfloat16>(unsigned a,
                                                        unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
template <>
__device__ __forceinline__ unsigned wadd<__nv_bfloat16>(unsigned a,
                                                        unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
template <>
__device__ __forceinline__ unsigned wsub<__nv_bfloat16>(unsigned a,
                                                        unsigned b) {
  unsigned d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// A word of the fp32 table at p, cast to T (round to nearest even).
template <typename T>
__device__ __forceinline__ unsigned table_word(const float* p);
template <>
__device__ __forceinline__ unsigned table_word<float>(const float* p) {
  return __float_as_uint(__ldg(p));
}
template <>
__device__ __forceinline__ unsigned table_word<__nv_bfloat16>(const float* p) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  return from_floats({v.x, v.y});
}

// (x - mean) * rstd of each value of the word, rounded to T.
template <typename T>
__device__ __forceinline__ unsigned ln_word(unsigned w, float mean,
                                            float rstd) {
  float f[kWordElems<T>];
  to_floats(w, f);
#pragma unroll
  for (int e = 0; e < kWordElems<T>; ++e) f[e] = (f[e] - mean) * rstd;
  return from_floats(f);
}

// The rotation of a word a of the first half of a row and its partner b,
// Dh / 2 elements on: a' = a cos_a - b sin_a, b' = b cos_b + a sin_b.
template <typename T>
__device__ __forceinline__ void rope_pair(unsigned& a, unsigned& b,
                                          unsigned cos_a, unsigned cos_b,
                                          unsigned sin_a, unsigned sin_b) {
  const unsigned x = a, y = b;
  a = wsub<T>(wmul<T>(x, cos_a), wmul<T>(y, sin_a));
  b = wadd<T>(wmul<T>(y, cos_b), wmul<T>(x, sin_b));
}

}  // namespace fitv2
