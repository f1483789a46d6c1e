// Fused per-head q/k LayerNorm (no affine) + split-layout RoPE + masked
// softmax attention, straight off the flat qkv projection:
//   q, k, v = qkv[..., h*Dh], qkv[..., C + h*Dh], qkv[..., 2C + h*Dh]
//   q' = rope(LN(q)), k' = rope(LN(k))     as in csrc/qk_rope.cu (LN stats
//                                           in fp32, cast back; the rotation
//                                           rounded to the input dtype)
//   l  = (q' . k') * Dh^-1/2 in fp32; masked keys -1e30
//   p  = T(exp(l - max l) / sum exp(l - max l))   normalised, THEN rounded
//   o  = T(sum p v)                         fp32 accumulator
// qkv: (B, N, 3C) contiguous; cos/sin: (B, N, Dh) fp32, cast to the input
// dtype; mask: (B, N) fp32 (> 0 valid) or null; out: (B, N, C). Padded
// query rows are computed like any other; the caller zeroes them.
//
// Replaces the TPU kernel fitv2_tpu/ops/fused_attention.py:_kernel (entry
// point fused_qkln_rope_attention).
//
// What bounds it on an H100: at the sampler's shape (B = 16, N = 256,
// H = 16, Dh = 72, bf16) the attention is 4.8 GFLOP over 28 MB read and
// written, ~170 flops per byte; this kernel computes the logits twice (9.7
// GFLOP on scalar fp32 FMAs, ~67 TFLOP/s peak), so fp32 arithmetic and
// shared-memory operand traffic bound it, as in csrc/attention.cu. Neither
// the normalised q/k nor the logits reach device memory.
//
// Design: one block per (b * head, 64-query tile), 256 threads as a 16 x 16
// grid, each thread owning a 4 x 4 block of logits (rows ty + 16 i, keys
// tx + 16 j) and the same 4 rows of the output over head dims tx + 16 j.
// The query tile is LayerNormed and rotated once into shared memory (fp32
// rows padded to Dh + 1 floats), one warp per row. Unlike csrc/attention.cu,
// p is normalised before p.v and rounded to the input dtype there
// (fitv2_tpu/ops/fused_attention.py:95-101), so the key tiles are swept
// twice: the first sweep takes each row's max and sum (online, rescaling the
// sum when the max grows), the second forms p = T(exp(l - m) / s) and
// accumulates p.v. Each sweep normalises and rotates every key tile again
// (a 64 x Dh tile is cheap beside its 64 x 64 x Dh logits), which keeps
// shared memory at three Dh-wide tiles plus p for any N (1024 and beyond).
#include <math_constants.h>

#include "common.cuh"

namespace {

using namespace fitv2;

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMaskedLogit = -1e30f;

template <int kDh>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBQ + 2 * kBK) * (kDh + 1) + kBQ * (kBK + 1));
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp: dst[0:Dh] = rope(LN(src)) (LN only if `norm`), each value
// rounded to T as the plain chain computes it in T. Every lane of the warp
// must call it (the statistics are warp reductions).
template <typename T, int kDh>
__device__ __forceinline__ void ln_rope_row(const T* __restrict__ src,
                                            const float* __restrict__ cs,
                                            const float* __restrict__ sn,
                                            float* dst, bool norm, float eps,
                                            int lane) {
  constexpr int kPer = (kDh + 31) / 32;
  constexpr int kHalf = kDh / 2;
  float v[kPer];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < kDh ? to_float(src[i]) : 0.f;
    sum += v[j];
  }
  if (norm) {
    const float mean = warp_sum(sum) / kDh;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float d = lane + 32 * j < kDh ? v[j] - mean : 0.f;
      sq += d * d;
    }
    const float rstd = 1.f / sqrtf(warp_sum(sq) / kDh + eps);
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = round_to<T>((v[j] - mean) * rstd);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = lane + 32 * j;
    if (i < kDh) dst[i] = v[j];
  }
  __syncwarp();
  float r[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = lane + 32 * j;
    if (i < kDh) {
      const float rot = i < kHalf ? -dst[i + kHalf] : dst[i - kHalf];
      const float a = round_to<T>(__fmul_rn(v[j], round_to<T>(cs[i])));
      const float b = round_to<T>(__fmul_rn(rot, round_to<T>(sn[i])));
      r[j] = round_to<T>(__fadd_rn(a, b));
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = lane + 32 * j;
    if (i < kDh) dst[i] = r[j];
  }
}

template <typename T, int kDh, bool kMasked>
__global__ void __launch_bounds__(kThreads)
fused_attention_kernel(const T* __restrict__ qkv, const float* __restrict__ cos,
                       const float* __restrict__ sin,
                       const float* __restrict__ mask, T* __restrict__ out,
                       int n, int h, float scale, float eps, int norm_q,
                       int norm_k) {
  constexpr int kLd = kDh + 1;
  constexpr int kNd = (kDh + 15) / 16;  // output column groups per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // kBQ x kLd
  float* Ks = Qs + kBQ * kLd;     // kBK x kLd
  float* Vs = Ks + kBK * kLd;     // kBK x kLd
  float* Ps = Vs + kBK * kLd;     // kBQ x (kBK + 1)
  __shared__ float key_state[kBK];  // 1 valid, 0 masked, -1 beyond n

  const int b = blockIdx.y / h, head = blockIdx.y % h;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const long long c = (long long)h * kDh, stride = 3 * c;
  const T* base = qkv + (long long)b * n * stride + head * kDh;
  const float* cos_b = cos + (long long)b * n * kDh;
  const float* sin_b = sin + (long long)b * n * kDh;

  for (int r = warp; r < kBQ; r += kWarps) {
    const int row = q0 + r;
    if (row < n) {
      ln_rope_row<T, kDh>(base + row * stride, cos_b + row * kDh,
                          sin_b + row * kDh, Qs + r * kLd, norm_q, eps, lane);
    } else {
      for (int d = lane; d < kDh; d += 32) Qs[r * kLd + d] = 0.f;
    }
  }

  // stage key tile k0: normalised, rotated keys (and the values if asked)
  auto load_keys = [&](int k0, bool values) {
    for (int r = warp; r < kBK; r += kWarps) {
      const int row = k0 + r;
      if (row < n) {
        ln_rope_row<T, kDh>(base + row * stride + c, cos_b + row * kDh,
                            sin_b + row * kDh, Ks + r * kLd, norm_k, eps,
                            lane);
      } else {
        for (int d = lane; d < kDh; d += 32) Ks[r * kLd + d] = 0.f;
      }
    }
    if (values) {
      for (int idx = tid; idx < kBK * kDh; idx += kThreads) {
        const int r = idx / kDh, d = idx - r * kDh, row = k0 + r;
        Vs[r * kLd + d] = row < n ? to_float(base[row * stride + 2 * c + d]) : 0.f;
      }
    }
    if (tid < kBK) {
      const int row = k0 + tid;
      key_state[tid] = row >= n ? -1.f
                       : (!kMasked || mask[(long long)b * n + row] > 0.f) ? 1.f
                                                                          : 0.f;
    }
  };

  // scaled logits of the thread's 4 x 4 block; -1e30 masked, -inf beyond n
  auto logits = [&](float (&s)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kDh; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = Ks[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float st = key_state[tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][j] = st > 0.f ? s[i][j] * scale
                  : st == 0.f ? kMaskedLogit : -CUDART_INF_F;
    }
  };

  // sweep 1: row max and row sum of exp(l - max)
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += kBK) {
    __syncthreads();  // Qs is written / the previous tile's reads are done
    load_keys(k0, false);
    __syncthreads();
    float s[4][4];
    logits(s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mt = half_warp_max(fmaxf(fmaxf(s[i][0], s[i][1]),
                                           fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m[i], mt);  // finite: key k0 is within n
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) e += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + half_warp_sum(e);
      m[i] = m_new;
    }
  }

  // sweep 2: p = T(exp(l - m) / s), acc += p v
  float acc[4][kNd];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNd; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kBK) {
    __syncthreads();
    load_keys(k0, true);
    __syncthreads();
    float s[4][4];
    logits(s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] =
            round_to<T>(expf(s[i][j] - m[i]) / l[i]);
    __syncthreads();
#pragma unroll 4
    for (int cc = 0; cc < kBK; ++cc) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (kBK + 1) + cc];
#pragma unroll
      for (int j = 0; j < kNd; ++j) {
        const int d = tx + 16 * j;
        if (kDh % 16 == 0 || d < kDh) {
          const float vv = Vs[cc * kLd + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    T* o = out + ((long long)b * n + row) * c + head * kDh;
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      const int d = tx + 16 * j;
      if (kDh % 16 == 0 || d < kDh) o[d] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T, int kDh, bool kMasked>
cudaError_t launch(const void* qkv, const float* cos, const float* sin,
                   const float* mask, void* out, int b, int n, int h,
                   float scale, float eps, int norm_q, int norm_k,
                   cudaStream_t stream) {
  auto kern = fused_attention_kernel<T, kDh, kMasked>;
  constexpr size_t smem = smem_bytes<kDh>();
  // set once per process (the port drives one device): the attribute
  // outlives the launch
  static bool smem_raised = false;
  if (!smem_raised) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_raised = true;
  }
  const dim3 grid((n + kBQ - 1) / kBQ, b * h);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), cos, sin, mask, static_cast<T*>(out), n, h,
      scale, eps, norm_q, norm_k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* qkv, const float* cos, const float* sin,
                     const float* mask, void* out, int b, int n, int h,
                     int dh, float scale, float eps, int nq, int nk,
                     cudaStream_t st) {
#define FITV2_FA_CASE(D)                                                 \
  case D:                                                                \
    return mask ? launch<T, D, true>(qkv, cos, sin, mask, out, b, n, h,  \
                                     scale, eps, nq, nk, st)             \
                : launch<T, D, false>(qkv, cos, sin, mask, out, b, n, h, \
                                      scale, eps, nq, nk, st);
  switch (dh) {
    FITV2_FA_CASE(64)
    FITV2_FA_CASE(72)
    FITV2_FA_CASE(96)
    FITV2_FA_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef FITV2_FA_CASE
}

}  // namespace

// mask: (B, N) float32 (> 0 = valid key) or null for "every key valid".
extern "C" int fitv2_fused_attention(const void* qkv, const void* cos,
                                     const void* sin, const void* mask,
                                     void* out, int b, int n, int h, int dh,
                                     float scale, float eps, int norm_q,
                                     int norm_k, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto cs = static_cast<const float*>(cos);
  auto sn = static_cast<const float*>(sin);
  auto m = static_cast<const float*>(mask);
  switch (dtype) {
    case kFloat32:
      return dispatch<float>(qkv, cs, sn, m, out, b, n, h, dh, scale, eps,
                             norm_q, norm_k, st);
    case kBFloat16:
      return dispatch<__nv_bfloat16>(qkv, cs, sn, m, out, b, n, h, dh,
                                     scale, eps, norm_q, norm_k, st);
    default:
      return cudaErrorInvalidValue;
  }
}
