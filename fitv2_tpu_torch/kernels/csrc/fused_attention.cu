// K5, fused per-head q/k LayerNorm (no affine) + split-layout RoPE + masked
// softmax attention, straight off the flat qkv projection:
//   q, k, v = qkv[..., h*Dh], qkv[..., C + h*Dh], qkv[..., 2C + h*Dh]
//   q' = rope(LN(q)), k' = rope(LN(k))     K2's arithmetic (qk_rope.cuh): LN
//                                           stats in fp32, cast back; the
//                                           rotation rounded to the input
//                                           dtype
//   l  = (q' . k') * Dh^-1/2 in fp32; masked keys -1e30, keys past n -inf
//   p  = T(exp(l - max l) / sum exp(l - max l))   normalised, THEN rounded
//   o  = T(sum p v)                         fp32 accumulator
// qkv: (B, N, 3C) contiguous; cos/sin: (B, N, Dh) fp32, cast to the input
// dtype; mask: (B, N) fp32 (> 0 valid) or null; out: (B, N, C). Padded
// query rows are computed like any other; the caller zeroes them. A row
// whose keys are all masked averages the values of its n keys.
//
// Replaces the TPU kernel fitv2_tpu/ops/fused_attention.py:_kernel (entry
// point fused_qkln_rope_attention).
//
// What bounds it on an H100: at the sampler's shape (B = 16, N = 256,
// H = 16, Dh = 72, bf16) the attention is 4.8 GFLOP (Q K^T and P V) over
// 40 MB read and written (qkv, the output, the tables): the bytes bound it,
// 12.0 us at 3.35 TB/s. Neither the normalised q/k nor the logits reach
// device memory.
//
// Two passes over the keys are part of the semantics: p is normalised
// before p.v and rounded to the input dtype there
// (fitv2_tpu/ops/fused_attention.py:95-101), so a row's max and sum must be
// final before any p.v. Pass 1 takes each row's max and sum of
// exp(l - max) (online: the sum is rescaled when the max grows); pass 2
// computes the logits again, forms p and accumulates p.v.
//
// bf16 (fused_attention_mma_kernel): the tensor-core core of csrc/
// attention.cu (mma_bf16.cuh: mma.sync m16n8k16 in the FlashAttention-2
// register layout, ldmatrix, Dh 72 zero-padded to 80 for Q K^T). One block
// per (batch * head, 256 query rows; 128 above Dh 72), a warp for 16 query
// rows; the Q fragments stay in registers for both passes. Keys are staged
// 256 at a time (4 tiles of 64) into shared memory. When N <= 256 (the XL
// path: one block a head) the normalised keys and the values stay resident
// for both passes, so each key row is normalised once per head; past that
// (N = 1024) each pass stages the chunks again. Staging is what costs: at
// XL the q/k normalisation took more of the call than both passes, so
// - the raw q and k rows arrive by 16-byte cp.async (rows past n
//   zero-filled), one group for each round of 128 tokens, all issued at
//   once;
// - each round's cos/sin rows are read coalesced and cast to bf16 once
//   into the V area (stage_tables) while its copies land (read scattered,
//   a thread's own table values cost more than the rest of the prologue);
// - two threads a row LayerNorm and rotate the round's k rows and the q
//   rows of the same tokens in place (ln_rope_rows), with the same tables;
// - only then are the v rows' copies issued, to land while pass 1 runs.
// The logits take one FMA each (s * scale * log2(e) + the key's bias) and
// ex2.approx the power; in pass 2, p = 2^(s - m) * (1 / sum) is rounded to
// bf16 into the A fragments of P V (V's B fragments from ldmatrix.trans).
// The output goes out through the warp's own Q rows in 16-byte row chunks.
// At Dh 72 a block takes 136 KB of shared memory and 512 threads, one an
// SM; the XL call is 256 blocks.
//
// fp32 (fused_attention_fp32_kernel) keeps a scalar core: TF32 tensor cores
// would fail its 1e-5 gate (as in attention.cu). One block per (batch *
// head, 64 query rows), 256 threads as a 16 x 16 grid, each thread owning a
// 4 x 4 block of logits (rows ty + 16 i, keys tx + 16 j) and the same 4
// rows of the output over head dims tx + 16 j; tiles are fp32 rows padded
// to Dh + 1 floats in shared memory, and both sweeps stage and normalise
// each 64-key tile again, four threads a row (the fp32 tables need no
// cast, so they are read where they are).
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"
#include "mma_bf16.cuh"
#include "qk_rope.cuh"

namespace {

using namespace fitv2;

constexpr int kBK = 64;  // keys per tile
constexpr float kMaskedLogit = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The cos and sin rows of `rows` consecutive tokens (Dh fp32 values a
// token, contiguous in device memory, on 16 bytes) cast to bf16 words in
// shared memory by 16-byte loads of consecutive threads: cos words at cw,
// sin words at sw, Dh / 2 words a row.
template <int kDh, int kBlockThreads>
__device__ __forceinline__ void stage_tables(unsigned* cw, unsigned* sw,
                                             const float* __restrict__ cos,
                                             const float* __restrict__ sin,
                                             int rows) {
  const auto* c4 = reinterpret_cast<const float4*>(cos);
  const auto* s4 = reinterpret_cast<const float4*>(sin);
  for (int v = threadIdx.x; v < rows * kDh / 4; v += kBlockThreads) {
    const float4 c = __ldg(c4 + v), s = __ldg(s4 + v);
    *reinterpret_cast<uint2*>(cw + 2 * v) =
        make_uint2(from_floats({c.x, c.y}), from_floats({c.z, c.w}));
    *reinterpret_cast<uint2*>(sw + 2 * v) =
        make_uint2(from_floats({s.x, s.y}), from_floats({s.z, s.w}));
  }
}

// cp.async.wait_group with a pending count known only at run time (<= 3).
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  if (pending >= 3)
    cp_async_wait<3>();
  else if (pending == 2)
    cp_async_wait<2>();
  else if (pending == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// LayerNorm (if the set's norm flag) + split RoPE, in place, of two sets
// of head rows of Dh values of T in shared memory (row stride ld words):
// nrows rows at rows, then nrows2 rows at rows2, row i of either set that
// of the tables' row i. The tables are words of T too, tstride words a
// row: in shared memory from stage_tables (bf16), or the fp32 tables
// themselves in device memory (fp32, where a word is a value and no cast
// is needed). kTpr threads a row: thread q of a row's group takes the
// words [q kQ, (q + 1) kQ) of the first half of the row and their rotation
// partners Dh / 2 on, so the group holds the row once and its statistics
// are xor shuffles within it. Every thread of the block calls it.
template <typename T, int kDh, int kTpr>
__device__ __forceinline__ void ln_rope_rows(unsigned* rows, int nrows,
                                             bool norm, unsigned* rows2,
                                             int nrows2, bool norm2, int ld,
                                             const unsigned* cw,
                                             const unsigned* sw, int tstride,
                                             float eps) {
  constexpr int kEw = kWordElems<T>;
  constexpr int kHalfW = kDh / kEw / 2;  // words in half a row
  constexpr int kQ = kHalfW / kTpr;      // words a thread takes of a half
  static_assert(kHalfW % kTpr == 0, "the threads of a row split each half");
  const int q = threadIdx.x % kTpr;
  for (int r0 = 0; r0 < nrows + nrows2; r0 += blockDim.x / kTpr) {
    const int r = r0 + threadIdx.x / kTpr;
    const bool valid = r < nrows + nrows2, first = r < nrows;
    const int tr = !valid ? 0 : first ? r : r - nrows;  // the table row
    // a thread past the rows reads (and leaves) row 0 of a set that has one
    unsigned* row = (valid ? (first ? rows : rows2) : nrows ? rows : rows2) +
                    tr * ld + q * kQ;
    unsigned a[kQ], b[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      a[j] = row[j];
      b[j] = row[kHalfW + j];
    }
    // the statistics are taken either way (the group's shuffles run on
    // every lane), and applied where the row's set asks for them
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      float fa[kEw], fb[kEw];
      to_floats(a[j], fa);
      to_floats(b[j], fb);
#pragma unroll
      for (int e = 0; e < kEw; ++e) sum += fa[e] + fb[e];
    }
#pragma unroll
    for (int o = 1; o < kTpr; o <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / kDh;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      float fa[kEw], fb[kEw];
      to_floats(a[j], fa);
      to_floats(b[j], fb);
#pragma unroll
      for (int e = 0; e < kEw; ++e) {
        const float da = fa[e] - mean, db = fb[e] - mean;
        sq += da * da + db * db;
      }
    }
#pragma unroll
    for (int o = 1; o < kTpr; o <<= 1)
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    if (first ? norm : norm2) {
      const float rstd = 1.f / sqrtf(sq / kDh + eps);
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        a[j] = ln_word<T>(a[j], mean, rstd);
        b[j] = ln_word<T>(b[j], mean, rstd);
      }
    }
    const unsigned* c = cw + tr * tstride + q * kQ;
    const unsigned* s = sw + tr * tstride + q * kQ;
#pragma unroll
    for (int j = 0; j < kQ; ++j)
      rope_pair<T>(a[j], b[j], c[j], c[kHalfW + j], s[j], s[kHalfW + j]);
    if (valid) {
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        row[j] = a[j];
        row[kHalfW + j] = b[j];
      }
    }
  }
}

// ---- bf16: tensor cores (mma.sync m16n8k16) --------------------------------

constexpr int kChunkTiles = 4;  // key tiles staged at once: N <= 256 stays
                                // resident for both passes
constexpr int kRound = 128;     // tokens LayerNormed a round

template <int kDh>
struct FusedTile {
  static constexpr int kDp = (kDh + 15) / 16 * 16;  // Q K^T depth, zero-padded
  static constexpr int kLd = kDp + 8;      // shared row stride (elements)
  static constexpr int kChunks = kDh / 8;  // 16-byte chunks of a q/k/v row
  static constexpr int kKeys = kChunkTiles * kBK;
  // query rows a block, a warp for 16: 256 up to Dh 72 (at N 256 one
  // block a head, so the keys are normalised once), else 128 (a thread's
  // Q fragments and output take more registers than 512 threads leave)
  static constexpr int kBQ = kDh <= 72 ? 256 : 128;
  static constexpr int kThreads = 2 * kBQ;
  // the Q tile, the K and V chunks, then the keys' logit biases
  static constexpr size_t kSmem =
      (kBQ + 2 * kKeys) * kLd * sizeof(__nv_bfloat16) + kKeys * sizeof(float);
  static_assert(kDh % 8 == 0, "rows are copied in 16-byte chunks");
  static_assert(kKeys * kLd >= 2 * kRound * kDh && kKeys % kBQ == 0 &&
                    kBQ % kRound == 0,
                "a round's tables fit in the V area, and a Q tile is inside "
                "a chunk or apart from it, in whole rounds");
};

template <int kDh, bool kMasked>
__global__ void __launch_bounds__(FusedTile<kDh>::kThreads, 1)
fused_attention_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                           const float* __restrict__ cos,
                           const float* __restrict__ sin,
                           const float* __restrict__ mask,
                           __nv_bfloat16* __restrict__ out, int n, int h,
                           float scale_log2, float eps, int norm_q,
                           int norm_k) {
  using F = FusedTile<kDh>;
  constexpr int kLd = F::kLd, kBQ = F::kBQ, kThreads = F::kThreads;
  constexpr int kKSteps = F::kDp / 16;  // k16 steps of Q K^T
  constexpr int kNk = kBK / 8;          // n8 key tiles of S
  constexpr int kNd = kDh / 8;          // n8 column tiles of P V and O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * kLd;
  __nv_bfloat16* Vs = Ks + F::kKeys * kLd;
  float* key_bias = reinterpret_cast<float*>(Vs + F::kKeys * kLd);

  const int b = blockIdx.y / h, head = blockIdx.y % h;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // accumulator e of an m16n8 tile: row g + 8 * (e >> 1), column 2t + (e & 1)
  const int g = lane >> 2, t = lane & 3;
  const long long c = (long long)h * kDh, stride = 3 * c;
  const __nv_bfloat16* base = qkv + (long long)b * n * stride + head * kDh;
  const float* cos_b = cos + (long long)b * n * kDh;
  const float* sin_b = sin + (long long)b * n * kDh;

  // columns [kDh, kDp) of the Q rows and the K rows (consecutive shared
  // rows) take part in Q K^T as zeros; nothing else writes them
  if constexpr (F::kDp > kDh) {
    constexpr int kPad = (F::kDp - kDh) / 8;  // 16-byte chunks a row
    for (int idx = tid; idx < (kBQ + F::kKeys) * kPad; idx += kThreads) {
      const int r = idx / kPad, cc = idx - r * kPad;
      *reinterpret_cast<int4*>(Qs + r * kLd + kDh + cc * 8) =
          make_int4(0, 0, 0, 0);
    }
  }

  // rows [r0, r0 + rows) of the q, k or v columns (column offset col) into
  // a shared tile by cp.async; rows past n are zero-filled
  auto copy_rows = [&](__nv_bfloat16* dst, long long col, int r0, int rows) {
    for (int idx = tid; idx < rows * F::kChunks; idx += kThreads) {
      const int r = idx / F::kChunks, cc = idx - r * F::kChunks;
      const bool valid = r0 + r < n;
      cp_async16(dst + r * kLd + cc * 8,
                 base + (valid ? (r0 + r) * stride : 0) + col + cc * 8,
                 valid);
    }
  };

  // Stage key chunk `chunk` (and with_q, the Q tile): the keys' logit
  // biases (0 valid, -1e30 masked, -inf past n) and their k rows (and the
  // q rows) LayerNormed and rotated in place, in rounds of kRound tokens;
  // then, with_v, the chunk's V rows' copies are issued, to be waited for
  // before P V (they overlap pass 1). Returns the chunk's key tiles.
  // The raw rows of every round are copied at once, one cp.async group a
  // round (the Q tile with the first round that holds its tokens, or in
  // rounds of its own outside the chunk; the mask with the first). Each
  // round then reads its tables into the V area (coalesced, cast to bf16
  // once) while the copies land, waits for its own group, and two threads
  // a row normalise its k rows and the q rows of the same tokens, which
  // share the tables.
  auto stage = [&](int chunk, bool with_q, bool with_v) {
    const int k0 = chunk * F::kKeys;
    const int tiles = min(kChunkTiles, (n - k0 + kBK - 1) / kBK);
    const int krows = min(tiles * kBK, n - k0);  // keys within n
    const int qrows = min(kBQ, n - q0);
    const bool q_in = with_q && q0 >= k0 && q0 < k0 + krows;
    const int k_rounds = (krows + kRound - 1) / kRound;
    const int rounds =
        k_rounds + (with_q && !q_in ? (qrows + kRound - 1) / kRound : 0);
    // round r: its first token, and whether it holds k and q rows
    auto round_t0 = [&](int r) {
      return r < k_rounds ? k0 + r * kRound : q0 + (r - k_rounds) * kRound;
    };
    auto has_q = [&](int r) {
      const int t0 = round_t0(r);
      return with_q && (r >= k_rounds || q_in) && t0 >= q0 && t0 < q0 + qrows;
    };
    auto* cw = reinterpret_cast<unsigned*>(Vs);
    unsigned* sw = cw + kRound * kDh / 2;
    __syncthreads();  // every warp is done with the previous chunk
    for (int r = 0; r < rounds; ++r) {
      if (r < k_rounds) {
        const int r0 = r * kRound;  // copied up to the tile edge, zero past n
        copy_rows(Ks + r0 * kLd, c, k0 + r0, min(kRound, tiles * kBK - r0));
      }
      if (has_q(r) && (r == 0 || !has_q(r - 1)))
        copy_rows(Qs, 0, q0, kBQ);
      if (kMasked && r == 0) {
        for (int i = tid; i < tiles * kBK && k0 + i < n; i += kThreads)
          cp_async4(key_bias + i, mask + (long long)b * n + k0 + i);
      }
      cp_async_commit();
    }
    for (int r = 0; r < rounds; ++r) {
      const int t0 = round_t0(r);
      const int krows_r = r < k_rounds ? min(kRound, k0 + krows - t0) : 0;
      const int qrows_r = has_q(r) ? min(kRound, q0 + qrows - t0) : 0;
      __syncthreads();  // the previous round's table reads are done
      stage_tables<kDh, kThreads>(cw, sw, cos_b + (long long)t0 * kDh,
                                  sin_b + (long long)t0 * kDh,
                                  max(krows_r, qrows_r));
      cp_async_wait_pending(rounds - 1 - r);  // this round's rows are in
      if (r == 0) {
        for (int i = tid; i < tiles * kBK; i += kThreads)  // its own copy
          key_bias[i] = k0 + i >= n ? -CUDART_INF_F
                        : (!kMasked || key_bias[i] > 0.f) ? 0.f
                                                          : kMaskedLogit;
      }
      __syncthreads();
      ln_rope_rows<__nv_bfloat16, kDh, 2>(
          reinterpret_cast<unsigned*>(Ks + (t0 - k0) * kLd), krows_r, norm_k,
          reinterpret_cast<unsigned*>(Qs + (t0 - q0) * kLd), qrows_r, norm_q,
          kLd / 2, cw, sw, kDh / 2, eps);
    }
    __syncthreads();  // the rows are normalised, the V area free again
    if (with_v) {
      copy_rows(Vs, 2 * c, k0, tiles * kBK);
      cp_async_commit();
    }
    return tiles;
  };

  // S of key tile `tile` of the staged chunk in the log2 domain:
  // s * scale * log2(e) + bias (a masked key's sum rounds to -1e30 exactly)
  unsigned qf[1][kKSteps][4];
  auto logits = [&](float (&s)[1][kNk][4], int tile) {
    qk_mma(s, qf, Ks + tile * kBK * kLd, kLd, lane);
    const float* bias = key_bias + tile * kBK;
#pragma unroll
    for (int j = 0; j < kNk; ++j) {
      const float2 kb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[0][j][e] = fmaf(s[0][j][e], scale_log2, e & 1 ? kb.y : kb.x);
    }
  };

  const int chunks = (n + F::kKeys - 1) / F::kKeys;
  int tiles = stage(0, true, chunks == 1);
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
    ldsm_x4(qf[0][kk], Qs + (warp * 16 + (lane & 15)) * kLd + kk * 16 +
                           (lane >> 4) * 8);

  // pass 1: the row max m and the thread's part of the row sum of 2^(s - m)
  // for rows g and g + 8 of the warp's 16
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  for (int chunk = 0; chunk < chunks; ++chunk) {
    if (chunk > 0) tiles = stage(chunk, false, false);
    for (int tile = 0; tile < tiles; ++tile) {
      float s[1][kNk][4];
      logits(s, tile);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < kNk; ++j)
          mt = fmaxf(mt, fmaxf(s[0][j][2 * r], s[0][j][2 * r + 1]));
        // finite: every tile holds a key within n
        const float m_new = fmaxf(m[r], quad_max(mt));
        float e = 0.f;
#pragma unroll
        for (int j = 0; j < kNk; ++j)
          e += ex2(s[0][j][2 * r] - m_new) + ex2(s[0][j][2 * r + 1] - m_new);
        l[r] = l[r] * ex2(m[r] - m_new) + e;
        m[r] = m_new;
      }
    }
  }

  // pass 2: p = 2^(s - m) / sum, rounded to bf16, and O += P V
  const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
  float o[1][kNd][4];
#pragma unroll
  for (int d = 0; d < kNd; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[0][d][e] = 0.f;
  for (int chunk = 0; chunk < chunks; ++chunk) {
    // one chunk stays resident from pass 1, its V copies issued there
    if (chunks > 1) tiles = stage(chunk, false, true);
    cp_async_wait<0>();
    __syncthreads();  // the chunk's V rows have landed
    for (int tile = 0; tile < tiles; ++tile) {
      float s[1][kNk][4];
      logits(s, tile);
#pragma unroll
      for (int j = 0; j < kNk; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[0][j][e] = ex2(s[0][j][e] - m[e >> 1]) * inv[e >> 1];
      pv_mma(o, s, Vs + tile * kBK * kLd, kLd, lane);
    }
  }

  // O in bf16 through the warp's own rows of the Q tile, then 16-byte row
  // chunks to memory
  __nv_bfloat16* rows = Qs + warp * 16 * kLd;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int d = 0; d < kNd; ++d)
      *reinterpret_cast<unsigned*>(rows + (g + 8 * r) * kLd + d * 8 + 2 * t) =
          pack_bf16(o[0][d][2 * r], o[0][d][2 * r + 1]);
  __syncwarp();
  for (int idx = lane; idx < 16 * F::kChunks; idx += 32) {
    const int r = idx / F::kChunks, cc = idx - r * F::kChunks;
    const int row = q0 + warp * 16 + r;
    if (row < n)
      *reinterpret_cast<int4*>(out + ((long long)b * n + row) * c +
                               head * kDh + cc * 8) =
          *reinterpret_cast<const int4*>(rows + r * kLd + cc * 8);
  }
}

// ---- fp32: scalar FMAs through shared memory ------------------------------

constexpr int kFp32BQ = 64;  // query rows per block
constexpr int kFp32Threads = 256;

template <int kDh>
constexpr size_t fp32_smem_bytes() {
  return sizeof(float) *
         ((kFp32BQ + 2 * kBK) * (kDh + 1) + kFp32BQ * (kBK + 1));
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

template <int kDh, bool kMasked>
__global__ void __launch_bounds__(kFp32Threads)
fused_attention_fp32_kernel(const float* __restrict__ qkv,
                            const float* __restrict__ cos,
                            const float* __restrict__ sin,
                            const float* __restrict__ mask,
                            float* __restrict__ out, int n, int h,
                            float scale, float eps, int norm_q, int norm_k) {
  constexpr int kLd = kDh + 1;
  constexpr int kNd = (kDh + 15) / 16;  // output column groups per thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // kFp32BQ x kLd
  float* Ks = Qs + kFp32BQ * kLd;    // kBK x kLd
  float* Vs = Ks + kBK * kLd;        // kBK x kLd
  float* Ps = Vs + kBK * kLd;        // kFp32BQ x (kBK + 1)
  __shared__ float key_state[kBK];   // 1 valid, 0 masked, -1 beyond n

  const int b = blockIdx.y / h, head = blockIdx.y % h;
  const int q0 = blockIdx.x * kFp32BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long c = (long long)h * kDh, stride = 3 * c;
  const float* base = qkv + (long long)b * n * stride + head * kDh;
  const auto* cos_b = reinterpret_cast<const unsigned*>(cos) +
                      (long long)b * n * kDh;  // fp32 words as they are
  const auto* sin_b = reinterpret_cast<const unsigned*>(sin) +
                      (long long)b * n * kDh;

  for (int idx = tid; idx < kFp32BQ * kDh; idx += kFp32Threads) {
    const int r = idx / kDh, d = idx - r * kDh, row = q0 + r;
    Qs[r * kLd + d] = row < n ? base[row * stride + d] : 0.f;
  }
  __syncthreads();
  ln_rope_rows<float, kDh, 4>(reinterpret_cast<unsigned*>(Qs),
                              min(kFp32BQ, n - q0), norm_q, nullptr, 0, false,
                              kLd, cos_b + (long long)q0 * kDh,
                              sin_b + (long long)q0 * kDh, kDh, eps);

  // stage key tile k0: normalised, rotated keys (and the values if asked)
  auto load_keys = [&](int k0, bool values) {
    for (int idx = tid; idx < kBK * kDh; idx += kFp32Threads) {
      const int r = idx / kDh, d = idx - r * kDh, row = k0 + r;
      Ks[r * kLd + d] = row < n ? base[row * stride + c + d] : 0.f;
      if (values) Vs[r * kLd + d] = row < n ? base[row * stride + 2 * c + d] : 0.f;
    }
    if (tid < kBK) {
      const int row = k0 + tid;
      key_state[tid] = row >= n ? -1.f
                       : (!kMasked || mask[(long long)b * n + row] > 0.f) ? 1.f
                                                                          : 0.f;
    }
    __syncthreads();
    ln_rope_rows<float, kDh, 4>(reinterpret_cast<unsigned*>(Ks),
                                min(kBK, n - k0), norm_k, nullptr, 0, false,
                                kLd, cos_b + (long long)k0 * kDh,
                                sin_b + (long long)k0 * kDh, kDh, eps);
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

  // sweep 2: p = exp(l - m) / s, acc += p v
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
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = expf(s[i][j] - m[i]) / l[i];
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
    float* o = out + ((long long)b * n + row) * c + head * kDh;
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      const int d = tx + 16 * j;
      if (kDh % 16 == 0 || d < kDh) o[d] = acc[i][j];
    }
  }
}

// ---- launch ----------------------------------------------------------------

// Raise the kernel's dynamic shared memory limit once per process (the port
// drives one device: the attribute outlives the launch), then launch it on
// the (query tiles of `rows`, batch * heads) grid.
template <auto kKernel, typename T>
cudaError_t launch(const void* qkv, const float* cos, const float* sin,
                   const float* mask, void* out, int b, int n, int h,
                   float scale, float eps, int norm_q, int norm_k, int rows,
                   int threads, size_t smem, cudaStream_t stream) {
  static bool smem_raised = false;
  if (!smem_raised) {
    cudaError_t e = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_raised = true;
  }
  const dim3 grid((n + rows - 1) / rows, b * h);
  kKernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(qkv), cos, sin, mask, static_cast<T*>(out), n, h,
      scale, eps, norm_q, norm_k);
  return cudaGetLastError();
}

template <int kDh, bool kMasked>
cudaError_t run(const void* qkv, const float* cos, const float* sin,
                const float* mask, void* out, int b, int n, int h, float scale,
                float eps, int nq, int nk, int dtype, cudaStream_t st) {
  if (dtype == kFloat32)
    return launch<&fused_attention_fp32_kernel<kDh, kMasked>, float>(
        qkv, cos, sin, mask, out, b, n, h, scale, eps, nq, nk, kFp32BQ,
        kFp32Threads, fp32_smem_bytes<kDh>(), st);
  using F = FusedTile<kDh>;
  return launch<&fused_attention_mma_kernel<kDh, kMasked>, __nv_bfloat16>(
      qkv, cos, sin, mask, out, b, n, h, scale * kLog2e, eps, nq, nk, F::kBQ,
      F::kThreads, F::kSmem, st);
}

template <int kDh>
cudaError_t run_masked(const void* qkv, const float* cos, const float* sin,
                       const float* mask, void* out, int b, int n, int h,
                       float scale, float eps, int nq, int nk, int dtype,
                       cudaStream_t st) {
  return mask ? run<kDh, true>(qkv, cos, sin, mask, out, b, n, h, scale, eps,
                               nq, nk, dtype, st)
              : run<kDh, false>(qkv, cos, sin, mask, out, b, n, h, scale,
                                eps, nq, nk, dtype, st);
}

}  // namespace

// mask: (B, N) float32 (> 0 = valid key) or null for "every key valid".
// bf16 needs qkv, the tables and out on 16-byte boundaries; fp32 takes any.
extern "C" int fitv2_fused_attention(const void* qkv, const void* cos,
                                     const void* sin, const void* mask,
                                     void* out, int b, int n, int h, int dh,
                                     float scale, float eps, int norm_q,
                                     int norm_k, int dtype, void* stream) {
  if (dtype == kBFloat16) {
    if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out) |
         reinterpret_cast<uintptr_t>(cos) | reinterpret_cast<uintptr_t>(sin)) %
        16)
      return cudaErrorMisalignedAddress;
  } else if (dtype != kFloat32) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  auto cs = static_cast<const float*>(cos);
  auto sn = static_cast<const float*>(sin);
  auto m = static_cast<const float*>(mask);
#define FITV2_FA_CASE(D) \
  case D:                \
    return run_masked<D>(qkv, cs, sn, m, out, b, n, h, scale, eps, norm_q, norm_k, dtype, st);
  switch (dh) {
    FITV2_FA_CASE(32)
    FITV2_FA_CASE(64)
    FITV2_FA_CASE(72)
    FITV2_FA_CASE(96)
    FITV2_FA_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef FITV2_FA_CASE
}
