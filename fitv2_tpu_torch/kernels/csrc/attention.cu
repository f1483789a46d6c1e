// Softmax attention with a key-padding mask, in two variants chosen at
// compile time:
//   kBounded = false  online softmax with a running row max (flash style):
//                     replaces fitv2_tpu/ops/flash_attention.py:_flash_kernel
//                     (entry point flash_masked_attention), K3.
//   kBounded = true   bounded softmax, exp(logit) with no max pass, legal
//                     when q and k are both no-affine LayerNormed so that
//                     |logit| <= sqrt(Dh): replaces
//                     fitv2_tpu/ops/attention_core.py:_kernel/_kernel_masked
//                     (entry point attention_core), K4.
//   kMasked           padded keys (mask <= 0) get the -1e30 logit, as in both
//                     TPU kernels; with no mask every key is valid. Keys past
//                     n get -inf.
// q, k, v: (B, N, H, Dh), each with its own token stride (v is a column
// block of the fused qkv projection), heads and head dim contiguous.
// out: (B, N, H, Dh) contiguous, acc / max(l, 1e-20) cast to the input
// dtype, where l, the row sum of p, is accumulated in fp32. So a row whose
// keys are all masked averages its n values (online) or gives 0 (bounded).
//
// What bounds it on an H100: at the sampler's shape (B = 16, H = 16,
// N = 256, Dh = 72) a call is 4.83 GFLOP (Q K^T and P V) and must move
// 37.7 MB in bf16 (q, k and v read once, o written once, 9.44 MB each):
// 128 flops per byte, below the bf16 tensor cores' ridge (~295), so the
// bytes bound it, 11.3 us at 3.35 TB/s (the flops alone take 4.9 us at
// 989 TFLOP/s). The logits never reach device memory.
//
// bf16, the sampler's path (attention_mma_kernel): tensor cores through
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) in the FlashAttention-2
// register layout. One block per (batch * head, 128 query rows); each warp
// owns 32 rows (two m16 tiles, so every K and V fragment loaded feeds two
// MMAs) for Dh <= 96, 16 rows above (Dh = 128 would need > 255 registers).
// The query tile and a two-stage ring of 64-key K and V tiles arrive by
// 16-byte cp.async (rows past n zero-filled), so the next tile's copies
// overlap this one's products; the Q fragments are loaded once with
// ldmatrix and stay in registers. S = Q K^T stays in the accumulators and
// the softmax runs on them in the log2 domain (a thread holds rows g and
// g + 8 of each m16 tile; a row max or sum takes two shuffles within the
// quad): one FFMA gives scale * log2(e) * s plus the key's bias (0, -1e30
// masked, -inf past n; full unmasked tiles skip the bias), and ex2.approx
// the power, which keeps the special-function unit, whose exp count per
// tile rivals the MMA work at Dh = 72, to one instruction a logit. p is
// rounded to bf16 in registers into the A fragments of P V, as both TPU
// kernels round p before that product, while l sums the unrounded p. V's B
// fragments come from ldmatrix.trans. Dh = 72 is not a multiple of the
// MMA's k16: Q and K columns 72-79 are zeroed in shared memory (never read
// from memory) for Q K^T, and P V runs over exactly 9 n8 column tiles.
// Shared rows are padded by 16 bytes so the 8 rows of an ldmatrix fall in
// distinct banks. The mask reaches shared memory by 4-byte cp.async with
// the tile. The output is staged through the warp's own query rows of
// shared memory and stored in 16-byte row chunks. The copies need 16-byte
// aligned rows: the entry point refuses other pointers and token strides
// (the wrapper checks them first, with a message). At Dh = 72 a thread
// holds ~240 registers, so two blocks (8 warps) share an SM; the XL call
// is 512 blocks, ~2 waves on 132 SMs. wgmma + TMA is the next step (a
// 144-byte row is wider than TMA's 128-byte swizzle).
//
// fp32 (attention_fp32_kernel) keeps the scalar design: a TF32 tensor-core
// path would round the operands to 10 mantissa bits and fail both gates the
// fp32 path serves, 1e-5 of the kernel against its plain version and the
// XL fp32 CUDA-vs-CPU model parity (relative L2 1e-4). The query tile and
// each 64-key tile of K and V are staged in shared memory as fp32 with rows
// padded to Dh + 1 floats, so the column reads of the 16 x 16 thread grid
// fall in distinct banks. Each thread owns a 4 x 4 block of logits (rows
// ty + 16 i, keys tx + 16 j) and the same 4 rows of the output over head
// dims tx + 16 j; the dot loops run over exactly Dh and the last 16-wide
// output column group is guarded. A row's 16 owners are one half-warp, so
// row max and row sum are xor-shuffles within it.
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace fitv2;

constexpr int kBQ = 64;  // query rows per block of the fp32 kernel
constexpr int kBK = 64;  // keys per tile
constexpr float kMaskedLogit = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---- fp32: scalar FMAs through shared memory ------------------------------

constexpr int kFp32Threads = 256;

template <int kDh>
constexpr size_t fp32_smem_bytes() {
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

template <int kDh, bool kBounded, bool kMasked>
__global__ void __launch_bounds__(kFp32Threads)
attention_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ mask, float* __restrict__ out,
                      int n, int h, long long q_stride, long long k_stride,
                      long long v_stride, float scale) {
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
  const float* qb = q + (long long)b * n * q_stride + head * kDh;
  const float* kb = k + (long long)b * n * k_stride + head * kDh;
  const float* vb = v + (long long)b * n * v_stride + head * kDh;

  for (int idx = tid; idx < kBQ * kDh; idx += kFp32Threads) {
    const int r = idx / kDh, d = idx - r * kDh, row = q0 + r;
    Qs[r * kLd + d] = row < n ? qb[row * q_stride + d] : 0.f;
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
    for (int idx = tid; idx < kBK * kDh; idx += kFp32Threads) {
      const int r = idx / kDh, d = idx - r * kDh, row = k0 + r;
      Ks[r * kLd + d] = row < n ? kb[row * k_stride + d] : 0.f;
      Vs[r * kLd + d] = row < n ? vb[row * v_stride + d] : 0.f;
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
    float* o = out + (((long long)b * n + row) * h + head) * kDh;
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      const int d = tx + 16 * j;
      if (kDh % 16 == 0 || d < kDh) o[d] = acc[i][j] / denom;
    }
  }
}

// ---- bf16: tensor cores (mma.sync m16n8k16) --------------------------------

constexpr int kMmaBQ = 128;  // query rows per block
constexpr int kStages = 2;   // K/V tiles in flight

template <int kDh>
struct MmaTile {
  static constexpr int kDp = (kDh + 15) / 16 * 16;  // Q K^T depth, zero-padded
  static constexpr int kLd = kDp + 8;      // shared row stride (elements)
  static constexpr int kChunks = kDh / 8;  // 16-byte chunks of a q/k/v row
  static constexpr int kKV = kBK * kLd;    // one K or V tile
  // m16 row tiles per warp: two up to Dh = 96 (a thread's Q fragments,
  // logits and output then take 241-255 registers, and Dh = 96 spills up
  // to 64 bytes), one above
  static constexpr int kMt = kDh <= 96 ? 2 : 1;
  static constexpr int kThreads = 32 * kMmaBQ / (16 * kMt);
  // the Q tile, the K ring, the V ring, then the key biases of the ring
  static constexpr size_t kSmem =
      (kMmaBQ * kLd + 2 * kStages * kKV) * sizeof(__nv_bfloat16) +
      kStages * kBK * sizeof(float);
  static_assert(kDh % 8 == 0, "rows are copied in 16-byte chunks");
};

// Rows [r0, r0 + kRows) of an (n, kDh) matrix with token stride `ld` into a
// shared tile by cp.async; rows past n are zero-filled.
template <int kDh, int kRows>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* src,
                                          long long ld, int r0, int n) {
  using T = MmaTile<kDh>;
  for (int idx = threadIdx.x; idx < kRows * T::kChunks; idx += T::kThreads) {
    const int r = idx / T::kChunks, c = idx - r * T::kChunks;
    const bool valid = r0 + r < n;
    cp_async16(tile + r * T::kLd + c * 8,
               src + (valid ? (r0 + r) * ld : 0) + c * 8, valid);
  }
}

template <int kDh, bool kBounded, bool kMasked>
__global__ void __launch_bounds__(MmaTile<kDh>::kThreads)
attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ mask,
                     __nv_bfloat16* __restrict__ out, int n, int h,
                     long long q_stride, long long k_stride,
                     long long v_stride, float scale_log2) {
  using T = MmaTile<kDh>;
  constexpr int kLd = T::kLd, kMt = T::kMt;
  constexpr int kKSteps = T::kDp / 16;  // k16 steps of Q K^T
  constexpr int kNk = kBK / 8;          // n8 key tiles of S
  constexpr int kNd = kDh / 8;          // n8 column tiles of P V and O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Kring = Qs + kMmaBQ * kLd;
  __nv_bfloat16* Vring = Kring + kStages * T::kKV;
  float* key_bias = reinterpret_cast<float*>(Vring + kStages * T::kKV);

  const int b = blockIdx.y / h, head = blockIdx.y % h;
  const int q0 = blockIdx.x * kMmaBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp * 16 * kMt;  // the warp's first row of the tile
  // accumulator e of an m16n8 tile: row g + 8 * (e >> 1), column 2t + (e & 1)
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qb = q + (long long)b * n * q_stride + head * kDh;
  const __nv_bfloat16* kb = k + (long long)b * n * k_stride + head * kDh;
  const __nv_bfloat16* vb = v + (long long)b * n * v_stride + head * kDh;

  // columns [kDh, kDp) of the Q tile and the K ring (consecutive shared
  // rows) take part in Q K^T as zeros; the copies never write them
  if constexpr (T::kDp > kDh) {
    constexpr int kPad = (T::kDp - kDh) / 8;  // 16-byte chunks a row
    for (int idx = tid; idx < (kMmaBQ + kStages * kBK) * kPad;
         idx += T::kThreads) {
      const int r = idx / kPad, c = idx - r * kPad;
      *reinterpret_cast<int4*>(Qs + r * kLd + kDh + c * 8) =
          make_int4(0, 0, 0, 0);
    }
  }

  // K/V tile `tile` into its ring stage, with a mask also its keys' mask
  // values; then close the cp.async group, empty past the last tile so
  // that every iteration waits alike
  const int n_tiles = (n + kBK - 1) / kBK;
  auto load_keys = [&](int tile) {
    if (tile < n_tiles) {
      const int k0 = tile * kBK, stage = tile % kStages;
      load_tile<kDh, kBK>(Kring + stage * T::kKV, kb, k_stride, k0, n);
      load_tile<kDh, kBK>(Vring + stage * T::kKV, vb, v_stride, k0, n);
      if (kMasked && tid < kBK && k0 + tid < n)
        cp_async4(key_bias + stage * kBK + tid,
                  mask + (long long)b * n + k0 + tid);
    }
    cp_async_commit();
  };

  load_tile<kDh, kMmaBQ>(Qs, qb, q_stride, q0, n);  // joins tile 0's group
#pragma unroll
  for (int tile = 0; tile < kStages - 1; ++tile) load_keys(tile);

  unsigned qf[kMt][kKSteps][4];
  float o[kMt][kNd][4];
  float m[kMt][2], l[kMt][2];  // running row max (online), the thread's
                               // part of the row sums
#pragma unroll
  for (int i = 0; i < kMt; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[i][r] = kMaskedLogit;
      l[i][r] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < kNd; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][d][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    // the stage of tile it + kStages - 1 was read in iteration it - 1
    load_keys(it + kStages - 1);
    cp_async_wait<kStages - 1>();
    const int stage = it % kStages, k0 = it * kBK;
    if (kMasked && tid < kBK) {
      // the thread's own mask copy has landed: its key's logit bias, 0
      // valid, -1e30 masked, -inf past n
      float& bias = key_bias[stage * kBK + tid];
      bias = k0 + tid >= n ? -CUDART_INF_F : bias > 0.f ? 0.f : kMaskedLogit;
    }
    __syncthreads();  // tile `it` (and at it = 0 the Q tile) has landed
    if (it == 0) {
#pragma unroll
      for (int i = 0; i < kMt; ++i)
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk)
          ldsm_x4(qf[i][kk], Qs + (row0 + 16 * i + (lane & 15)) * kLd +
                                 kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* Kt = Kring + stage * T::kKV;
    const __nv_bfloat16* Vt = Vring + stage * T::kKV;

    float s[kMt][kNk][4];
    qk_mma(s, qf, Kt, kLd, lane);  // S = Q K^T

    // logits in the log2 domain, s * scale_log2 + bias: a masked key's sum
    // rounds to -1e30 exactly, a key past n gets -inf; full tiles without a
    // mask skip the bias
    if (kMasked || k0 + kBK > n) {
#pragma unroll
      for (int j = 0; j < kNk; ++j) {
        const int col = 8 * j + 2 * t;
        float2 bias;
        if constexpr (kMasked) {
          bias = *reinterpret_cast<const float2*>(key_bias + stage * kBK + col);
        } else {
          bias.x = k0 + col < n ? 0.f : -CUDART_INF_F;
          bias.y = k0 + col + 1 < n ? 0.f : -CUDART_INF_F;
        }
#pragma unroll
        for (int i = 0; i < kMt; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[i][j][e] = fmaf(s[i][j][e], scale_log2, e & 1 ? bias.y : bias.x);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kMt; ++i)
#pragma unroll
        for (int j = 0; j < kNk; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j][e] *= scale_log2;
    }

#pragma unroll
    for (int i = 0; i < kMt; ++i) {
      if constexpr (kBounded) {
#pragma unroll
        for (int j = 0; j < kNk; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j][e] = ex2(s[i][j][e]);
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mt = -CUDART_INF_F;
#pragma unroll
          for (int j = 0; j < kNk; ++j)
            mt = fmaxf(mt, fmaxf(s[i][j][2 * r], s[i][j][2 * r + 1]));
          const float m_new = fmaxf(m[i][r], quad_max(mt));
          const float alpha = ex2(m[i][r] - m_new);
          m[i][r] = m_new;
          l[i][r] *= alpha;
#pragma unroll
          for (int d = 0; d < kNd; ++d) {
            o[i][d][2 * r] *= alpha;
            o[i][d][2 * r + 1] *= alpha;
          }
#pragma unroll
          for (int j = 0; j < kNk; ++j) {
            s[i][j][2 * r] = ex2(s[i][j][2 * r] - m_new);
            s[i][j][2 * r + 1] = ex2(s[i][j][2 * r + 1] - m_new);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kNk; ++j) {
        l[i][0] += s[i][j][0] + s[i][j][1];
        l[i][1] += s[i][j][2] + s[i][j][3];
      }
    }

    // O += P V: the S tiles of 16 keys become one bf16 A fragment
    pv_mma(o, s, Vt, kLd, lane);
    __syncthreads();  // every warp is done with this stage before a refill
  }

  // O / max(l, 1e-20) in bf16 through the warp's own rows of the Q tile,
  // then 16-byte row chunks to memory
  __nv_bfloat16* rows = Qs + row0 * kLd;
#pragma unroll
  for (int i = 0; i < kMt; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / fmaxf(quad_sum(l[i][r]), 1e-20f);
#pragma unroll
      for (int d = 0; d < kNd; ++d)
        *reinterpret_cast<unsigned*>(rows + (16 * i + g + 8 * r) * kLd +
                                     d * 8 + 2 * t) =
            pack_bf16(o[i][d][2 * r] * inv, o[i][d][2 * r + 1] * inv);
    }
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * kMt * T::kChunks; idx += 32) {
    const int r = idx / T::kChunks, c = idx - r * T::kChunks;
    const int row = q0 + row0 + r;
    if (row < n)
      *reinterpret_cast<int4*>(out + (((long long)b * n + row) * h + head) *
                                         kDh + c * 8) =
          *reinterpret_cast<const int4*>(rows + r * kLd + c * 8);
  }
}

// ---- launch ----------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const float* mask;  // (B, N), > 0 = valid key, or null
  void* out;
  int b, n, h;
  long long q_stride, k_stride, v_stride;
  float scale;
  cudaStream_t stream;
};

// Raise the kernel's dynamic shared memory limit once per process (the port
// drives one device: the attribute outlives the launch), then launch it on
// the (query tiles of `rows`, batch * heads) grid.
template <auto kKernel, typename T>
cudaError_t launch(const Args& a, int rows, int threads, size_t smem,
                   float scale) {
  static bool smem_raised = false;
  if (!smem_raised) {
    cudaError_t e = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_raised = true;
  }
  const dim3 grid((a.n + rows - 1) / rows, a.b * a.h);
  kKernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, static_cast<T*>(a.out), a.n, a.h,
      a.q_stride, a.k_stride, a.v_stride, scale);
  return cudaGetLastError();
}

template <int kDh, bool kBounded, bool kMasked>
cudaError_t run(const Args& a, int dtype) {
  if (dtype == kFloat32)
    return launch<&attention_fp32_kernel<kDh, kBounded, kMasked>, float>(
        a, kBQ, kFp32Threads, fp32_smem_bytes<kDh>(), a.scale);
  return launch<&attention_mma_kernel<kDh, kBounded, kMasked>, __nv_bfloat16>(
      a, kMmaBQ, MmaTile<kDh>::kThreads, MmaTile<kDh>::kSmem,
      a.scale * kLog2e);
}

template <int kDh>
cudaError_t dispatch_flags(const Args& a, int bounded, int dtype) {
  if (bounded)
    return a.mask ? run<kDh, true, true>(a, dtype)
                  : run<kDh, true, false>(a, dtype);
  return a.mask ? run<kDh, false, true>(a, dtype)
                : run<kDh, false, false>(a, dtype);
}

}  // namespace

// mask: (B, N) float32 (> 0 = valid key) or null for "every key valid".
// bf16 needs 16-byte aligned pointers and token strides (multiples of 8
// elements); fp32 takes any.
extern "C" int fitv2_attention(const void* q, const void* k, const void* v,
                               const void* mask, void* out, int b, int n,
                               int h, int dh, long long q_stride,
                               long long k_stride, long long v_stride,
                               float scale, int bounded, int dtype,
                               void* stream) {
  if (dtype == kBFloat16) {
    const auto bits = reinterpret_cast<uintptr_t>(q) |
                      reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v) |
                      reinterpret_cast<uintptr_t>(out);
    if (bits % 16 || (q_stride | k_stride | v_stride) % 8)
      return cudaErrorMisalignedAddress;
  } else if (dtype != kFloat32) {
    return cudaErrorInvalidValue;
  }
  const Args a{q, k, v, static_cast<const float*>(mask), out, b, n, h,
               q_stride, k_stride, v_stride, scale,
               static_cast<cudaStream_t>(stream)};
  switch (dh) {
    case 32: return dispatch_flags<32>(a, bounded, dtype);
    case 64: return dispatch_flags<64>(a, bounded, dtype);
    case 72: return dispatch_flags<72>(a, bounded, dtype);
    case 96: return dispatch_flags<96>(a, bounded, dtype);
    case 128: return dispatch_flags<128>(a, bounded, dtype);
    default: return cudaErrorInvalidValue;
  }
}
