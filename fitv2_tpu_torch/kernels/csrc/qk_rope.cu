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
// Rounding, in both instantiations: every elementwise step of the rotation
// is rounded to the input dtype, as the reference chain computes it in that
// dtype (fitv2_tpu/ops/fused_qk_rope.py:36-58): the tables are cast to the
// input dtype first, and the two products and the sum are each rounded
// (never contracted into a fused multiply-add).
//
// Design (qk_rope_kernel_vec): rows are (token, tensor, head) in the order
// [q heads of token 0, k heads of token 0, q heads of token 1, ...]; a warp
// takes 32 consecutive rows (at H = 16 exactly one token) and one lane
// computes one row of Dh values (a template parameter: 32, 64, 72, 96,
// 128) held in registers, so the LayerNorm statistics need no shuffle and
// the rotation partner i +- Dh/2 is a register. Device memory sees only
// 16-byte accesses by consecutive lanes to consecutive addresses: the warp
// copies its 32 rows in 16-byte chunks into its slice of shared memory
// (every load issued before the first store, so a warp has 4.6 KB in
// flight at XL), each lane reads its row from there, writes the result
// back into the same slot, and the warp copies the rows out in chunks. A
// shared row is an odd number of 16-byte chunks long, so the 8 lanes of
// each phase of a 16-byte shared access hit distinct banks.
//
// In bf16 the next limit after bytes is conversions: the reference's chain
// rounds a value ~6 times (the two table values, the two products, the sum,
// the LayerNorm result), and fp32 -> bf16 conversions issue at a fraction
// of the fp32 rate. So the warp casts the tables of its tokens once into
// shared memory instead of each lane casting its own copy, and the rotation
// runs on packed bf16 pairs (mul/add/sub.rn.bf16x2), each instruction
// rounding two values once, which is what the reference's fp32 op and cast
// give (qk_rope.cuh); only the LayerNorm result is converted, two values an
// instruction.
//
// A head dim outside the templates, or q/k/tables off 16-byte boundaries
// (a column slice starting at an odd element), take qk_rope_kernel_scalar:
// one block per token, one warp per (tensor, head) row, scalar loads, the
// rotation partner through shared memory. The wrapper picks the
// instantiation (fused_qk_rope.py vector_path) and this file checks it.
#include <cstdint>

#include "common.cuh"
#include "qk_rope.cuh"

namespace {

using namespace fitv2;

constexpr int kVecWarps = 4;  // warps (32 rows each) per block
constexpr int kWarps = 8;     // scalar kernel: warps per block (token)
constexpr int kMaxDh = 128;
constexpr int kPerLane = kMaxDh / 32;

// Table slots a warp needs: its 32 rows span at most 31 / (2H) + 2 tokens.
__host__ __device__ constexpr int table_slots(int h) { return 31 / (2 * h) + 2; }

template <typename T, int kDh>
__global__ void __launch_bounds__(kVecWarps * 32)
qk_rope_kernel_vec(const T* __restrict__ q, const T* __restrict__ k,
                   const float* __restrict__ cos,
                   const float* __restrict__ sin, T* __restrict__ oq,
                   T* __restrict__ ok, int rows, int h, long long q_stride,
                   long long k_stride, float eps, int norm_q, int norm_k) {
  constexpr int kE = 16 / sizeof(T);    // elements a 16-byte chunk
  constexpr int kC = kDh / kE;          // chunks a row
  constexpr int kLd = kC | 1;           // shared row stride in chunks (odd)
  constexpr int kEw = kWordElems<T>;    // elements a word
  constexpr int kW = kDh / kEw;         // words a row, and a table row
  constexpr int kHalfW = kW / 2;        // the rotation partner, in words
  static_assert(kDh % kE == 0 && kHalfW % 2 == 0, "head dim");
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slots = table_slots(h);
  uint4* buf = smem + warp * 32 * kLd;
  unsigned* tables = reinterpret_cast<unsigned*>(smem + kVecWarps * 32 * kLd) +
                     warp * slots * 2 * kW;
  const int row0 = (blockIdx.x * kVecWarps + warp) * 32;
  if (row0 >= rows) return;  // the whole warp

  // this lane's row: its token, tensor and head, where it is read from and
  // where it goes; the copies below take other lanes' addresses by shuffle
  const int r = row0 + lane;
  const bool valid = r < rows;
  const int tok = valid ? r / (2 * h) : 0;
  const int j = r - tok * 2 * h;
  const bool is_k = valid && j >= h;
  const int head = is_k ? j - h : j;
  const T* src = (is_k ? k + tok * k_stride : q + tok * q_stride) +
                 head * kDh;
  T* dst = (is_k ? ok : oq) + ((long long)tok * h + head) * kDh;
  const auto src_u = reinterpret_cast<unsigned long long>(src);
  const auto dst_u = reinterpret_cast<unsigned long long>(dst);

  // copy in: chunk c of the warp's rows is chunk c % kC of row c / kC, so
  // consecutive lanes read consecutive 16 bytes of a token's q or k heads
  uint4 in[kC];
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int c = lane + 32 * i, rl = c / kC, cc = c - rl * kC;
    const auto from = reinterpret_cast<const uint4*>(
        __shfl_sync(0xffffffffu, src_u, rl));
    if (row0 + rl < rows) in[i] = __ldg(from + cc);
  }
  // meanwhile the tables of the warp's tokens, cast to T once for all the
  // lanes that share them: a token's cos words, then its sin words
  const int tok0 = row0 / (2 * h);
  const int ntok = min(row0 + 31, rows - 1) / (2 * h) - tok0 + 1;
  for (int i = lane; i < ntok * kW; i += 32) {
    const int t = i / kW, w = i - t * kW;
    const long long at = (long long)(tok0 + t) * kDh + w * kEw;
    tables[t * 2 * kW + w] = table_word<T>(cos + at);
    tables[t * 2 * kW + kW + w] = table_word<T>(sin + at);
  }
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int c = lane + 32 * i, rl = c / kC, cc = c - rl * kC;
    if (row0 + rl < rows) buf[rl * kLd + cc] = in[i];
  }
  __syncwarp();

  if (valid) {
    unsigned w[kW];
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const uint4 c = buf[lane * kLd + i];
      w[4 * i] = c.x;
      w[4 * i + 1] = c.y;
      w[4 * i + 2] = c.z;
      w[4 * i + 3] = c.w;
    }
    if (is_k ? norm_k : norm_q) {
      float x[kDh];
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        float f[kEw];
        to_floats(w[i], f);
#pragma unroll
        for (int e = 0; e < kEw; ++e) x[i * kEw + e] = f[e];
      }
      float s[4] = {0.f, 0.f, 0.f, 0.f};  // four chains: shorter latency
#pragma unroll
      for (int i = 0; i < kDh; ++i) s[i % 4] += x[i];
      const float mean = ((s[0] + s[1]) + (s[2] + s[3])) / kDh;
      float s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kDh; ++i) {
        const float c = x[i] - mean;
        s2[i % 4] += c * c;
      }
      const float var = ((s2[0] + s2[1]) + (s2[2] + s2[3])) / kDh;
      const float rstd = 1.f / sqrtf(var + eps);
#pragma unroll
      for (int i = 0; i < kW; ++i) w[i] = ln_word<T>(w[i], mean, rstd);
    }
    // y[i] = x[i] cos[i] - x[i + Dh/2] sin[i], y[i + Dh/2] =
    // x[i + Dh/2] cos[i + Dh/2] + x[i] sin[i + Dh/2], two words at a time
    const unsigned* cw = tables + (tok - tok0) * 2 * kW;
    const unsigned* sw = cw + kW;
#pragma unroll
    for (int i = 0; i < kHalfW; i += 2) {
      const uint2 c0 = *reinterpret_cast<const uint2*>(cw + i);
      const uint2 c1 = *reinterpret_cast<const uint2*>(cw + i + kHalfW);
      const uint2 s0 = *reinterpret_cast<const uint2*>(sw + i);
      const uint2 s1 = *reinterpret_cast<const uint2*>(sw + i + kHalfW);
      const unsigned cl[2] = {c0.x, c0.y}, ch[2] = {c1.x, c1.y};
      const unsigned sl[2] = {s0.x, s0.y}, sh[2] = {s1.x, s1.y};
#pragma unroll
      for (int u = 0; u < 2; ++u)
        rope_pair<T>(w[i + u], w[i + kHalfW + u], cl[u], ch[u], sl[u], sh[u]);
    }
#pragma unroll
    for (int i = 0; i < kC; ++i)
      buf[lane * kLd + i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  }
  __syncwarp();

  // copy out: the same chunk order into the contiguous outputs
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int c = lane + 32 * i, rl = c / kC, cc = c - rl * kC;
    const auto to = reinterpret_cast<uint4*>(
        __shfl_sync(0xffffffffu, dst_u, rl));
    if (row0 + rl < rows) to[cc] = buf[rl * kLd + cc];
  }
}

// Any even head dim <= 128 and any alignment: one block per token; each
// warp takes one (tensor, head) row of Dh values, up to 4 per lane, so the
// LN statistics are two warp shuffle reductions with no block barrier. The
// normalised row is staged in the warp's slice of shared memory so each
// lane can read its rotation partner i +- Dh/2.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
qk_rope_kernel_scalar(const T* __restrict__ q, const T* __restrict__ k,
                      const float* __restrict__ cos,
                      const float* __restrict__ sin, T* __restrict__ oq,
                      T* __restrict__ ok, int h, int dh, long long q_stride,
                      long long k_stride, float eps, int norm_q, int norm_k) {
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

template <typename T, int kDh>
cudaError_t launch_vec(const T* q, const T* k, const float* cos,
                       const float* sin, T* oq, T* ok, int rows, int h,
                       long long q_stride, long long k_stride, float eps,
                       int norm_q, int norm_k, cudaStream_t stream) {
  constexpr int kLd = (kDh * (int)sizeof(T) / 16) | 1;
  // the warps' rows, then their tables (table_slots tokens of cos and sin
  // rows of Dh values in T)
  const size_t smem = sizeof(uint4) * kVecWarps * 32 * kLd +
                      sizeof(T) * kVecWarps * table_slots(h) * 2 * kDh;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        qk_rope_kernel_vec<T, kDh>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (rows + 32 * kVecWarps - 1) / (32 * kVecWarps);
  qk_rope_kernel_vec<T, kDh><<<blocks, kVecWarps * 32, smem, stream>>>(
      q, k, cos, sin, oq, ok, rows, h, q_stride, k_stride, eps, norm_q,
      norm_k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* qv, const void* kv, const void* cosv,
                   const void* sinv, void* oqv, void* okv, int tokens, int h,
                   int dh, long long q_stride, long long k_stride, float eps,
                   int norm_q, int norm_k, int vector, cudaStream_t stream) {
  const T* q = static_cast<const T*>(qv);
  const T* k = static_cast<const T*>(kv);
  const float* cos = static_cast<const float*>(cosv);
  const float* sin = static_cast<const float*>(sinv);
  T* oq = static_cast<T*>(oqv);
  T* ok = static_cast<T*>(okv);
  if (dh > kMaxDh || dh % 2) return cudaErrorInvalidValue;
  if (vector) {
    const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(cos) |
                          reinterpret_cast<uintptr_t>(sin) |
                          reinterpret_cast<uintptr_t>(oq) |
                          reinterpret_cast<uintptr_t>(ok);
    if (any % 16 || (q_stride * (long long)sizeof(T)) % 16 ||
        (k_stride * (long long)sizeof(T)) % 16)
      return cudaErrorMisalignedAddress;
    // rows (and the row index of the last warp's lanes) stay in int
    if (2LL * tokens * h > (1LL << 31) - 256) return cudaErrorInvalidValue;
    const int rows = 2 * tokens * h;
#define FITV2_QK_ROPE_VEC(DH)                                              \
  case DH:                                                                 \
    return launch_vec<T, DH>(q, k, cos, sin, oq, ok, rows, h, q_stride,    \
                             k_stride, eps, norm_q, norm_k, stream);
    switch (dh) {
      FITV2_QK_ROPE_VEC(32)
      FITV2_QK_ROPE_VEC(64)
      FITV2_QK_ROPE_VEC(72)
      FITV2_QK_ROPE_VEC(96)
      FITV2_QK_ROPE_VEC(128)
      default:
        return cudaErrorInvalidValue;  // no vector instantiation for dh
    }
#undef FITV2_QK_ROPE_VEC
  }
  qk_rope_kernel_scalar<T><<<tokens, kWarps * 32, 0, stream>>>(
      q, k, cos, sin, oq, ok, h, dh, q_stride, k_stride, eps, norm_q, norm_k);
  return cudaGetLastError();
}

}  // namespace

// vector: 1 = qk_rope_kernel_vec (dh one of 32, 64, 72, 96, 128; operands
// and token strides on 16 bytes), 0 = qk_rope_kernel_scalar (any even
// dh <= 128, any alignment)
extern "C" int fitv2_qk_rope(const void* q, const void* k, const void* cos,
                             const void* sin, void* oq, void* ok, int tokens,
                             int h, int dh, long long q_stride,
                             long long k_stride, float eps, int norm_q,
                             int norm_k, int vector, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(q, k, cos, sin, oq, ok, tokens, h, dh, q_stride,
                           k_stride, eps, norm_q, norm_k, vector, st);
    case kBFloat16:
      return launch<__nv_bfloat16>(q, k, cos, sin, oq, ok, tokens, h, dh,
                                   q_stride, k_stride, eps, norm_q, norm_k,
                                   vector, st);
    default:
      return cudaErrorInvalidValue;
  }
}
