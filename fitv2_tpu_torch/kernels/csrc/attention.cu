// Softmax attention with a key-padding mask, in two variants chosen at
// compile time:
//   kBounded = false  online softmax with a running row max (flash style):
//                     replaces fitv2_tpu/ops/flash_attention.py:_flash_kernel
//                     (entry point flash_masked_attention).
//   kBounded = true   bounded softmax, exp(logit) with no max pass, legal
//                     when q and k are both no-affine LayerNormed so that
//                     |logit| <= sqrt(Dh): replaces
//                     fitv2_tpu/ops/attention_core.py:_kernel/_kernel_masked
//                     (entry point attention_core).
//   kMasked           padded keys (mask <= 0) get the -1e30 logit, as in both
//                     TPU kernels; with no mask every key is valid.
// q, k, v: (B, N, H, Dh), each with its own token stride (v is a column
// block of the fused qkv projection), heads and head dim contiguous.
// out: (B, N, H, Dh) contiguous. Accumulation is fp32 throughout; the output
// is acc / max(l, 1e-20) cast to the input dtype.
//
// What bounds it on an H100: at the sampler's shape (B = 16, H = 16,
// N = 256, Dh = 72) a call is 4.8 GFLOP (QK^T and PV) over 28 MB of q/k/v/o
// in bf16, ~170 flops per byte: below the tensor cores' ridge (~295) but far
// above the fp32 CUDA cores' (~20), so this scalar-FMA kernel is bound by its
// fp32 arithmetic and shared-memory operand traffic. The logits never
// reach device memory.
//
// Design: one block per (batch * head, 64-query tile). The query tile and
// each 64-key tile of K and V are staged in shared memory as fp32 with rows
// padded to Dh + 1 floats, so the column reads of the 16 x 16 thread grid
// fall in distinct banks. Each thread owns a 4 x 4 block of logits (rows
// ty + 16 i, keys tx + 16 j) and the same 4 rows of the output over head
// dims tx + 16 j. Dh = 72 is neither a power of two nor a multiple of the
// 16-wide bf16 MMA K step: it is a compile-time template parameter, the dot
// loops run over exactly 72, and the last 16-wide output column group is
// guarded. A row's 16 owners are one half-warp, so row max and row sum are
// xor-shuffles within it. Tensor cores (mma.sync / wgmma) are the next step.
#include <math_constants.h>

#include "common.cuh"

namespace {

using namespace fitv2;

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 256;
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

template <typename T, int kDh, bool kBounded, bool kMasked>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ out, int n, int h, long long q_stride,
                 long long k_stride, long long v_stride, float scale) {
  constexpr int kLd = kDh + 1;          // padded tile row
  constexpr int kNd = (kDh + 15) / 16;  // output column groups per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // kBQ x kLd
  float* Ks = Qs + kBQ * kLd;       // kBK x kLd
  float* Vs = Ks + kBK * kLd;       // kBK x kLd
  float* Ps = Vs + kBK * kLd;       // kBQ x (kBK + 1)
  __shared__ float key_state[kBK];  // 1 valid, 0 masked, -1 beyond n

  const int b = blockIdx.y / h, head = blockIdx.y % h;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qb = q + (long long)b * n * q_stride + head * kDh;
  const T* kb = k + (long long)b * n * k_stride + head * kDh;
  const T* vb = v + (long long)b * n * v_stride + head * kDh;

  for (int idx = tid; idx < kBQ * kDh; idx += kThreads) {
    const int r = idx / kDh, d = idx - r * kDh, row = q0 + r;
    Qs[r * kLd + d] = row < n ? to_float(qb[row * q_stride + d]) : 0.f;
  }

  float acc[4][kNd];
  float m[4], l[4];  // running row max (unbounded only), partial row sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskedLogit;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kNd; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += kBK) {
    __syncthreads();  // the previous tile's K/V/P reads are finished
    for (int idx = tid; idx < kBK * kDh; idx += kThreads) {
      const int r = idx / kDh, d = idx - r * kDh, row = k0 + r;
      Ks[r * kLd + d] = row < n ? to_float(kb[row * k_stride + d]) : 0.f;
      Vs[r * kLd + d] = row < n ? to_float(vb[row * v_stride + d]) : 0.f;
    }
    if (tid < kBK) {
      const int row = k0 + tid;
      key_state[tid] = row >= n ? -1.f
                       : (!kMasked || mask[(long long)b * n + row] > 0.f) ? 1.f
                                                                          : 0.f;
    }
    __syncthreads();

    float s[4][4];
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
    for (int i = 0; i < 4; ++i) {
      float p[4];
      if constexpr (kBounded) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p[j] = key_state[tx + 16 * j] > 0.f ? expf(s[i][j] * scale) : 0.f;
      } else {
        float logit[4], mt = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float st = key_state[tx + 16 * j];
          logit[j] = st > 0.f ? s[i][j] * scale
                     : st == 0.f ? kMaskedLogit
                                 : -CUDART_INF_F;
          mt = fmaxf(mt, logit[j]);
        }
        const float m_new = fmaxf(m[i], half_warp_max(mt));
        const float alpha = expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha;
#pragma unroll
        for (int j = 0; j < kNd; ++j) acc[i][j] *= alpha;
#pragma unroll
        for (int j = 0; j < 4; ++j) p[j] = expf(logit[j] - m_new);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        l[i] += p[j];
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p[j];
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < kNd; ++j) {
        const int d = tx + 16 * j;
        if (kDh % 16 == 0 || d < kDh) {
          const float vv = Vs[c * kLd + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = fmaxf(half_warp_sum(l[i]), 1e-20f);
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    T* o = out + (((long long)b * n + row) * h + head) * kDh;
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      const int d = tx + 16 * j;
      if (kDh % 16 == 0 || d < kDh) o[d] = from_float<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int kDh, bool kBounded, bool kMasked>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, void* out, int b, int n, int h,
                   long long q_stride, long long k_stride, long long v_stride,
                   float scale, cudaStream_t stream) {
  auto kern = attention_kernel<T, kDh, kBounded, kMasked>;
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
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), n, h, q_stride,
      k_stride, v_stride, scale);
  return cudaGetLastError();
}

template <typename T, int kDh>
cudaError_t dispatch_flags(const void* q, const void* k, const void* v,
                           const float* mask, void* out, int b, int n, int h,
                           long long qs, long long ks, long long vs,
                           float scale, int bounded, cudaStream_t st) {
  if (bounded) {
    return mask ? launch<T, kDh, true, true>(q, k, v, mask, out, b, n, h, qs, ks, vs, scale, st)
                : launch<T, kDh, true, false>(q, k, v, mask, out, b, n, h, qs, ks, vs, scale, st);
  }
  return mask ? launch<T, kDh, false, true>(q, k, v, mask, out, b, n, h, qs, ks, vs, scale, st)
              : launch<T, kDh, false, false>(q, k, v, mask, out, b, n, h, qs, ks, vs, scale, st);
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v,
                        const float* mask, void* out, int b, int n, int h,
                        int dh, long long qs, long long ks, long long vs,
                        float scale, int bounded, cudaStream_t st) {
  switch (dh) {
    case 64: return dispatch_flags<T, 64>(q, k, v, mask, out, b, n, h, qs, ks, vs, scale, bounded, st);
    case 72: return dispatch_flags<T, 72>(q, k, v, mask, out, b, n, h, qs, ks, vs, scale, bounded, st);
    case 96: return dispatch_flags<T, 96>(q, k, v, mask, out, b, n, h, qs, ks, vs, scale, bounded, st);
    case 128: return dispatch_flags<T, 128>(q, k, v, mask, out, b, n, h, qs, ks, vs, scale, bounded, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// mask: (B, N) float32 (> 0 = valid key) or null for "every key valid".
extern "C" int fitv2_attention(const void* q, const void* k, const void* v,
                               const void* mask, void* out, int b, int n,
                               int h, int dh, long long q_stride,
                               long long k_stride, long long v_stride,
                               float scale, int bounded, int dtype,
                               void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto m = static_cast<const float*>(mask);
  switch (dtype) {
    case kFloat32:
      return dispatch_dh<float>(q, k, v, m, out, b, n, h, dh, q_stride,
                                k_stride, v_stride, scale, bounded, st);
    case kBFloat16:
      return dispatch_dh<__nv_bfloat16>(q, k, v, m, out, b, n, h, dh,
                                        q_stride, k_stride, v_stride, scale,
                                        bounded, st);
    default:
      return cudaErrorInvalidValue;
  }
}
