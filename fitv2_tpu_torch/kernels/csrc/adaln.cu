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
// Design (adaln_kernel_vec): one warp per token row, the whole row in
// registers. D is a template parameter (the model widths 128, 384, 1152,
// 2304 = 128 * kVecs), so every loop unrolls and each lane holds kVecs
// vectors of 4 elements (8-byte loads in bf16, 16-byte in fp32): a warp
// instruction moves 256 or 512 contiguous bytes, and every load of the row
// (and, where registers allow, of its shift/scale rows, which wins when
// the inputs are L2-warm, as in the model) is issued before the first
// reduction, so a warp keeps the whole row (2.3 KB at XL) in flight. The
// two-pass fp32 moments (mean, then the centred sum of squares, as the TPU
// kernel) are warp shuffles: no shared memory, no block barrier. At XL in
// bf16 (89 registers) 20 warps fit an SM, so the 4,096 rows run in ~1.5
// waves. The epilogue follows the plain version's rounding: xhat *
// (1 + scale), then + shift, each rounded in fp32, then one rounding to T.
//
// Any other width, or operands off the 4-element vector alignment (a
// column slice starting at an odd element), take adaln_kernel_scalar: one
// block per row, scalar loads, the row staged in shared memory. The wrapper
// picks the instantiation (fused_adaln.py vector_path) and this file checks
// the choice.
#include <cstdint>

#include "common.cuh"

namespace {

using namespace fitv2;

constexpr int kRowWarps = 4;        // rows (one a warp) per block
constexpr int kScalarThreads = 128;

// 4 consecutive elements in one load: 16 bytes of fp32, 8 of bf16
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
};

__device__ __forceinline__ void to_floats(const float4& v, float (&f)[4]) {
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void to_floats(const uint2& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x << 16), f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16), f[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&f)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
  uint2 v;
  v.x = *reinterpret_cast<const unsigned*>(&a);
  v.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = v;
}

template <typename T, int kVecs>
__global__ void __launch_bounds__(kRowWarps * 32)
adaln_kernel_vec(const T* __restrict__ x, const T* __restrict__ shift,
                 const T* __restrict__ scale, T* __restrict__ out, int rows,
                 int n_tokens, long long mod_stride, float eps) {
  using V = typename Vec4<T>::type;
  constexpr int kD = 128 * kVecs;
  // shift/scale are loaded with x, before the reductions, where their raw
  // vectors fit in 36 more registers (bf16 up to D 1152, fp32 up to 384);
  // otherwise after them, as the epilogue reads them
  constexpr bool kEarly = 2 * kVecs * sizeof(V) / 4 <= 36;
  const int lane = threadIdx.x & 31;
  const long long r =
      (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);  // token row
  if (r >= rows) return;  // the whole warp: the shuffles below see 32 lanes
  // lane l holds elements 4l..4l+3 of each 128-element slice of the row
  const V* xr = reinterpret_cast<const V*>(x + r * kD) + lane;
  const long long b = r / n_tokens;
  const V* sh = reinterpret_cast<const V*>(shift + b * mod_stride) + lane;
  const V* sc = reinterpret_cast<const V*>(scale + b * mod_stride) + lane;
  float v[kVecs][4];
  V shv[kEarly ? kVecs : 1], scv[kEarly ? kVecs : 1];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) to_floats(__ldg(xr + 32 * j), v[j]);
  if constexpr (kEarly) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      shv[j] = __ldg(sh + 32 * j);
      scv[j] = __ldg(sc + 32 * j);
    }
  }

  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) s += v[j][u];
  const float mean = warp_sum(s) / kD;
  float s2 = 0.f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float c = v[j][u] - mean;
      s2 += c * c;
    }
  const float rstd = 1.f / sqrtf(warp_sum(s2) / kD + eps);

  T* o = out + r * kD + 4 * lane;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    float a[4], m[4], y[4];
    if constexpr (kEarly) {
      to_floats(shv[j], a);
      to_floats(scv[j], m);
    } else {
      to_floats(__ldg(sh + 32 * j), a);
      to_floats(__ldg(sc + 32 * j), m);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float xhat = (v[j][u] - mean) * rstd;
      y[u] = __fadd_rn(__fmul_rn(xhat, 1.f + m[u]), a[u]);
    }
    store4(o + 128 * j, y);
  }
}

// Any width and alignment: one block per row, the row read once into
// shared memory as fp32, the moments two passes over it.
template <typename T>
__global__ void __launch_bounds__(kScalarThreads)
adaln_kernel_scalar(const T* __restrict__ x, const T* __restrict__ shift,
                    const T* __restrict__ scale, T* __restrict__ out,
                    int n_tokens, int d, long long mod_stride, float eps) {
  extern __shared__ float row[];  // d floats
  __shared__ float red[32];
  const long long r = blockIdx.x;  // token row in [0, B * N)
  const long long b = r / n_tokens;
  const T* xr = x + r * d;

  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += kScalarThreads) {
    const float v = to_float(xr[i]);
    row[i] = v;  // each thread reads back only the entries it wrote
    s += v;
  }
  const float mean = block_sum(s, red) / d;
  float s2 = 0.f;
  for (int i = threadIdx.x; i < d; i += kScalarThreads) {
    const float c = row[i] - mean;
    s2 += c * c;
  }
  const float var = block_sum(s2, red) / d;
  const float rstd = 1.f / sqrtf(var + eps);

  const T* sh = shift + b * mod_stride;
  const T* sc = scale + b * mod_stride;
  T* o = out + r * d;
  for (int i = threadIdx.x; i < d; i += kScalarThreads) {
    const float xhat = (row[i] - mean) * rstd;
    o[i] = from_float<T>(
        __fadd_rn(__fmul_rn(xhat, 1.f + to_float(sc[i])), to_float(sh[i])));
  }
}

template <typename T, int kVecs>
cudaError_t launch_vec(const T* x, const T* shift, const T* scale, T* out,
                       int rows, int n_tokens, long long mod_stride, float eps,
                       cudaStream_t stream) {
  const int blocks = (rows + kRowWarps - 1) / kRowWarps;
  adaln_kernel_vec<T, kVecs><<<blocks, kRowWarps * 32, 0, stream>>>(
      x, shift, scale, out, rows, n_tokens, mod_stride, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xv, const void* shiftv, const void* scalev,
                   void* outv, int rows, int n_tokens, int d,
                   long long mod_stride, float eps, int vector,
                   cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* shift = static_cast<const T*>(shiftv);
  const T* scale = static_cast<const T*>(scalev);
  T* out = static_cast<T*>(outv);
  if (vector) {
    const uintptr_t vec = 4 * sizeof(T);
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(shift) |
         reinterpret_cast<uintptr_t>(scale) |
         reinterpret_cast<uintptr_t>(out)) % vec ||
        mod_stride % 4)
      return cudaErrorMisalignedAddress;
    switch (d) {
      case 128:
        return launch_vec<T, 1>(x, shift, scale, out, rows, n_tokens,
                                mod_stride, eps, stream);
      case 384:
        return launch_vec<T, 3>(x, shift, scale, out, rows, n_tokens,
                                mod_stride, eps, stream);
      case 1152:
        return launch_vec<T, 9>(x, shift, scale, out, rows, n_tokens,
                                mod_stride, eps, stream);
      case 2304:
        return launch_vec<T, 18>(x, shift, scale, out, rows, n_tokens,
                                 mod_stride, eps, stream);
      default:
        return cudaErrorInvalidValue;  // no vector instantiation for d
    }
  }
  const size_t smem = sizeof(float) * d;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        adaln_kernel_scalar<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  adaln_kernel_scalar<T><<<rows, kScalarThreads, smem, stream>>>(
      x, shift, scale, out, n_tokens, d, mod_stride, eps);
  return cudaGetLastError();
}

}  // namespace

// vector: 1 = adaln_kernel_vec (d one of 128, 384, 1152, 2304; operands on
// 4-element boundaries), 0 = adaln_kernel_scalar (any d, any alignment)
extern "C" int fitv2_adaln(const void* x, const void* shift,
                           const void* scale, void* out, int rows,
                           int n_tokens, int d, long long mod_stride,
                           float eps, int vector, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(x, shift, scale, out, rows, n_tokens, d,
                           mod_stride, eps, vector, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(x, shift, scale, out, rows, n_tokens, d,
                                   mod_stride, eps, vector, s);
    default:
      return cudaErrorInvalidValue;
  }
}
