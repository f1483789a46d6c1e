// The bf16 tensor-core core shared by the attention kernels (K3/K4,
// attention.cu; K5, fused_attention.cu): mma.sync m16n8k16 in the
// FlashAttention-2 register layout, its ldmatrix operand loads, and the
// softmax helpers over the accumulators.
//
// Accumulator e of an m16n8 tile sits at row g + 8 * (e >> 1), column
// 2t + (e & 1), where g = lane / 4 and t = lane % 4; a row's values are
// spread over the 4 lanes of a quad, so a row max or sum is two shuffles.
#pragma once

#include "common.cuh"

namespace fitv2 {

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special function unit (ex2.approx: ~2 ulp, -inf -> 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16, the first in the low half (lower column)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// S (kMt m16 row tiles x 8 * kNk keys, fp32) = Q K^T: qf holds the warp's
// Q A fragments over the kKSteps k16 steps; k points at a shared tile of
// 8 * kNk keys with row stride ld elements. ldmatrix of 16 keys x 16 dims
// gives the two n8 B fragments of a key pair, each feeding kMt MMAs.
template <int kMt, int kKSteps, int kNk>
__device__ __forceinline__ void qk_mma(float (&s)[kMt][kNk][4],
                                       unsigned (&qf)[kMt][kKSteps][4],
                                       const __nv_bfloat16* k, int ld,
                                       int lane) {
#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int j = 0; j < kNk; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
    for (int jp = 0; jp < kNk / 2; ++jp) {
      unsigned kf[4];
      ldsm_x4(kf, k + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                      kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < kMt; ++i) {
        mma_bf16(s[i][2 * jp], qf[i][kk], kf[0], kf[1]);
        mma_bf16(s[i][2 * jp + 1], qf[i][kk], kf[2], kf[3]);
      }
    }
  }
}

// O (kMt m16 row tiles x 8 * kNd columns, fp32) += P V over kBK keys: P
// (the softmax numerators or probabilities, fp32 in the layout of S) is
// rounded to bf16 into the A fragments of each 16 keys; v points at the
// first key's V row (row stride ld elements). ldmatrix.trans gives V's B
// fragments; an odd kNd (Dh = 72) takes its last n8 column tile with a
// two-matrix load.
template <int kMt, int kNk, int kNd>
__device__ __forceinline__ void pv_mma(float (&o)[kMt][kNd][4],
                                       float (&p)[kMt][kNk][4],
                                       const __nv_bfloat16* v, int ld,
                                       int lane) {
#pragma unroll
  for (int kc = 0; kc < kNk / 2; ++kc) {
    unsigned pa[kMt][4];
#pragma unroll
    for (int i = 0; i < kMt; ++i) {
      pa[i][0] = pack_bf16(p[i][2 * kc][0], p[i][2 * kc][1]);
      pa[i][1] = pack_bf16(p[i][2 * kc][2], p[i][2 * kc][3]);
      pa[i][2] = pack_bf16(p[i][2 * kc + 1][0], p[i][2 * kc + 1][1]);
      pa[i][3] = pack_bf16(p[i][2 * kc + 1][2], p[i][2 * kc + 1][3]);
    }
    const __nv_bfloat16* vrow = v + (kc * 16 + (lane & 15)) * ld;
#pragma unroll
    for (int dp = 0; dp < kNd / 2; ++dp) {
      unsigned vf[4];
      ldsm_x4_trans(vf, vrow + dp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < kMt; ++i) {
        mma_bf16(o[i][2 * dp], pa[i], vf[0], vf[1]);
        mma_bf16(o[i][2 * dp + 1], pa[i], vf[2], vf[3]);
      }
    }
    if constexpr (kNd % 2) {
      unsigned vf[2];
      ldsm_x2_trans(vf, vrow + (kNd - 1) * 8);
#pragma unroll
      for (int i = 0; i < kMt; ++i)
        mma_bf16(o[i][kNd - 1], pa[i], vf[0], vf[1]);
    }
  }
}

}  // namespace fitv2
