// Fused no-affine LayerNorm + adaLN modulation:
//   out = LN(x) * (1 + scale) + shift
// x: (B, N, D) contiguous; shift/scale: (B, D) rows with a row stride (they
// are column chunks of the (B, 6D) modulation); out: (B, N, D) in x's dtype.
//
// Replaces the TPU kernel fitv2_tpu/ops/fused_adaln.py:_kernel (entry point
// fused_adaln_norm).
//
// What bounds it on an H100: bytes. At the sampler's shape (B = 16,
// N = 256, D = 1152, bf16) one call reads x (9.4 MB) and writes out
// (9.4 MB); the arithmetic is ~10 flops per element, far below the ~295
// flops per byte the card needs before compute matters. The floor is
// 18.9 MB / 3.35 TB/s = 5.6 us.
//
// Design: one block per token row. The row is read from device memory once
// into shared memory as fp32; the mean and then the variance are two passes
// over shared memory (two-pass fp32 moments, as the TPU kernel), and the
// (1 + scale) * xhat + shift epilogue writes the row once. So device memory
// sees one read of x, one write of out and the (L2-resident) shift/scale
// rows. D = 1152 is not a power of two: threads stride over the row.
#include "common.cuh"

namespace {

using namespace fitv2;

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
adaln_kernel(const T* __restrict__ x, const T* __restrict__ shift,
             const T* __restrict__ scale, T* __restrict__ out, int n_tokens,
             int d, long long mod_stride, float eps) {
  extern __shared__ float row[];  // d floats
  __shared__ float red[32];
  const long long r = blockIdx.x;  // token row in [0, B * N)
  const long long b = r / n_tokens;
  const T* xr = x + r * d;

  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_float(xr[i]);
    row[i] = v;  // each thread reads back only the entries it wrote
    s += v;
  }
  const float mean = block_sum(s, red) / d;
  float s2 = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float c = row[i] - mean;
    s2 += c * c;
  }
  const float var = block_sum(s2, red) / d;
  const float rstd = 1.f / sqrtf(var + eps);

  const T* sh = shift + b * mod_stride;
  const T* sc = scale + b * mod_stride;
  T* o = out + r * d;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float xhat = (row[i] - mean) * rstd;
    o[i] = from_float<T>(xhat * (1.f + to_float(sc[i])) + to_float(sh[i]));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* shift, const void* scale,
                   void* out, int rows, int n_tokens, int d,
                   long long mod_stride, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * d;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        adaln_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  adaln_kernel<T><<<rows, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(shift),
      static_cast<const T*>(scale), static_cast<T*>(out), n_tokens, d,
      mod_stride, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fitv2_adaln(const void* x, const void* shift,
                           const void* scale, void* out, int rows,
                           int n_tokens, int d, long long mod_stride,
                           float eps, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(x, shift, scale, out, rows, n_tokens, d,
                           mod_stride, eps, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(x, shift, scale, out, rows, n_tokens, d,
                                   mod_stride, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}
