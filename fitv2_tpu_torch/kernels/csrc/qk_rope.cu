// Fused per-head q/k LayerNorm (no affine) + split-layout RoPE.
//   x' = LN(x)                      stats in fp32, result cast to x's dtype
//   y  = x' * cos + [-x'[d:], x'[:d]] * sin   in x's dtype, d = Dh / 2
// q, k: (B, N, H, Dh) with any token stride (they are column blocks of the
// fused qkv projection), heads and head dim contiguous; cos/sin: (B, N, Dh)
// fp32; outputs: (B, N, H, Dh) contiguous.
//
// Replaces the TPU kernel fitv2_tpu/ops/fused_qk_rope.py:_kernel (entry
// point fused_qk_rope).
//
// What bounds it on an H100: bytes. At the sampler's shape (B = 16,
// N = 256, H = 16, Dh = 72, bf16) a call reads q and k (2 x 9.4 MB) and the
// tables (2 x 1.2 MB) and writes 2 x 9.4 MB: 40 MB, a 12 us floor at
// 3.35 TB/s. The work per byte is a few flops.
//
// Design: one block per token; each warp takes one (tensor, head) row of
// Dh <= 128 values, up to 4 per lane, so the LN statistics are two warp
// shuffles reductions (two-pass, fp32) with no block barrier. The
// normalised row is staged in the warp's slice of shared memory so each lane
// can read its rotation partner i +- Dh/2. Every elementwise step of the
// rotation is rounded to the input dtype, as the reference chain computes it
// in that dtype (fitv2_tpu/ops/fused_qk_rope.py:36-58): the products and the
// sum are each rounded, and the tables are cast to the input dtype first.
// Dh = 72 is not a power of two: lanes past Dh idle.
#include "common.cuh"

namespace {

using namespace fitv2;

constexpr int kWarps = 8;
constexpr int kMaxDh = 128;
constexpr int kPerLane = kMaxDh / 32;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
qk_rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const float* __restrict__ cos, const float* __restrict__ sin,
               T* __restrict__ oq, T* __restrict__ ok, int h, int dh,
               long long q_stride, long long k_stride, float eps, int norm_q,
               int norm_k) {
  __shared__ float buf[kWarps][kMaxDh];
  const long long tok = blockIdx.x;  // b * N + n
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = dh / 2;
  const float* c = cos + tok * dh;
  const float* s = sin + tok * dh;

  for (int job = warp; job < 2 * h; job += kWarps) {
    const bool is_k = job >= h;
    const int head = is_k ? job - h : job;
    const T* src = (is_k ? k + tok * k_stride : q + tok * q_stride) +
                   (long long)head * dh;
    T* dst = (is_k ? ok : oq) + (tok * h + head) * dh;

    float v[kPerLane];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int i = lane + 32 * j;
      v[j] = i < dh ? to_float(src[i]) : 0.f;
      sum += v[j];
    }
    if (is_k ? norm_k : norm_q) {
      const float mean = warp_sum(sum) / dh;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const float d = lane + 32 * j < dh ? v[j] - mean : 0.f;
        sq += d * d;
      }
      const float rstd = 1.f / sqrtf(warp_sum(sq) / dh + eps);
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) v[j] = round_to<T>((v[j] - mean) * rstd);
    }
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int i = lane + 32 * j;
      if (i < dh) buf[warp][i] = v[j];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int i = lane + 32 * j;
      if (i < dh) {
        const float rot = i < half ? -buf[warp][i + half] : buf[warp][i - half];
        const float a = round_to<T>(__fmul_rn(v[j], round_to<T>(c[i])));
        const float b = round_to<T>(__fmul_rn(rot, round_to<T>(s[i])));
        dst[i] = from_float<T>(__fadd_rn(a, b));
      }
    }
    __syncwarp();  // buf is rewritten by the warp's next job
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* cos,
                   const void* sin, void* oq, void* ok, int tokens, int h,
                   int dh, long long q_stride, long long k_stride, float eps,
                   int norm_q, int norm_k, cudaStream_t stream) {
  if (dh > kMaxDh || dh % 2) return cudaErrorInvalidValue;
  qk_rope_kernel<T><<<tokens, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const float*>(cos), static_cast<const float*>(sin),
      static_cast<T*>(oq), static_cast<T*>(ok), h, dh, q_stride, k_stride,
      eps, norm_q, norm_k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fitv2_qk_rope(const void* q, const void* k, const void* cos,
                             const void* sin, void* oq, void* ok, int tokens,
                             int h, int dh, long long q_stride,
                             long long k_stride, float eps, int norm_q,
                             int norm_k, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(q, k, cos, sin, oq, ok, tokens, h, dh, q_stride,
                           k_stride, eps, norm_q, norm_k, st);
    case kBFloat16:
      return launch<__nv_bfloat16>(q, k, cos, sin, oq, ok, tokens, h, dh,
                                   q_stride, k_stride, eps, norm_q, norm_k,
                                   st);
    default:
      return cudaErrorInvalidValue;
  }
}
