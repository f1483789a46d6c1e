// K7, the int8 W8A8 SwiGLU GEMM of the int8 serving path:
//   g = f32(acc_g) * scale[n] + bias[n],
//   v = f32(acc_v) * scale[H + n] + bias[H + n],
//   out[m, n] = s8(clip(rint(g * sigmoid(g) * v * osr), 127))
// replaces fitv2_tpu/ops/int8_gemm.py:_swiglu_kernel (entry point
// int8_gemm_swiglu_quant): SwiGLU fc1 + silu(g) * v + requantization to
// fc2's int8 input. (K6, the GEMM with the plain dequant epilogue, is
// int8_gemm_wgmma.cu.)
// xq: (M, K) s8 row-major; wq: fc1's (2H, K) s8 row-major, the nn.Linear
// layout, so each output column's weights are K-contiguous (the `.col` B
// operand of mma); rows [0, H) are the gate and [H, 2H) the value.
// scale/bias: f32, one per weight row (bias may be null). K must be a
// multiple of 16; M and N edges are guarded.
//
// The accumulator is exact (|acc| <= 127^2 * K, 4.96e7 at K = 3072, well
// inside s32), so the output differs from the plain version only in the f32
// epilogue; the epilogue's multiply and add are explicitly rounded
// (__fmul_rn, __fadd_rn) so they are not contracted into an FMA, and the
// requantization rounds half to even (rintf), as torch.round and jnp.round
// do. The sigmoid uses expf, not __expf.
//
// What bounds it on an H100: at the serving shape (M = 4096, K x 2H = 1152
// x 6144) the product is 58 GOP over 37 MB of operands and outputs, ~1,600
// ops per byte: above the int8 tensor cores' ridge (~590 ops/byte), so
// tensor-core throughput bounds it.
// Design: mma.sync m16n8k32 s8 (legacy warp-level MMA; wgmma is the next
// step). A block computes 128 rows x 64 output columns, i.e. a 128 x 128
// tile of fc1 whose 128 B rows are 64 gate rows and the matching 64 value
// rows, with 8 warps of 64 x 32 each (4 x 4 m16n8 tiles, 64 s32
// accumulators a thread); K is walked in 64-byte steps through shared
// memory, the next step's tiles are loaded into registers (16-byte loads)
// while the current one is multiplied. Shared rows are padded to 80 bytes
// so the fragment reads of a warp fall in distinct banks. Each warp's n8
// tiles 0-1 (gate) and 2-3 (value) hold the same output columns, so
// silu(g) * v and the requantization run on the accumulators; the (M, 2H)
// fc1 output and the (M, H) activation never reach device memory.
#include <cstdint>

#include "common.cuh"

namespace {

using namespace fitv2;

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kThreads = 256;
constexpr int kLd = kBK + 16;  // shared row stride in bytes
constexpr int kChunks = kBK / 16;  // 16-byte chunks per tile row

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Global row of B that shared row r of the tile holds, or -1 past the edge
// (n = H: 64 gate rows, then the 64 value rows).
__device__ __forceinline__ int b_row(int r, int n0, int n) {
  const int col = n0 + (r & 63);
  return col < n ? (r < 64 ? col : n + col) : -1;
}

__global__ void __launch_bounds__(kThreads)
int8_gemm_swiglu_kernel(const int8_t* __restrict__ xq,
                        const int8_t* __restrict__ wq,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        int8_t* __restrict__ out_q, int m, int n, int k,
                        float osr) {
  __shared__ __align__(16) int8_t As[kBM * kLd];
  __shared__ __align__(16) int8_t Bs[kBN * kLd];
  constexpr int kCols = kBN / 2;  // output columns per block
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;

  // each thread moves 2 16-byte chunks of A and 2 of B per K step
  int a_row[2], b_src[2], chunk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kChunks;
    chunk[i] = (idx % kChunks) * 16;
    a_row[i] = m0 + r < m ? m0 + r : -1;
    b_src[i] = b_row(r, n0, n);
  }
  int4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kc = k0 + chunk[i];
      const int4 zero = make_int4(0, 0, 0, 0);
      ra[i] = a_row[i] >= 0 && kc < k
                  ? *reinterpret_cast<const int4*>(xq + (long long)a_row[i] * k + kc)
                  : zero;
      rb[i] = b_src[i] >= 0 && kc < k
                  ? *reinterpret_cast<const int4*>(wq + (long long)b_src[i] * k + kc)
                  : zero;
    }
  };

  // shared row of B for the warp's n8 tile j
  auto bs_row = [&](int j) {
    return (j < 2 ? 0 : 64) + wn * 16 + (j & 1) * 8;
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  load(0);
  for (int k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();  // the previous step's fragment reads are finished
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid + i * kThreads) / kChunks;
      *reinterpret_cast<int4*>(As + r * kLd + chunk[i]) = ra[i];
      *reinterpret_cast<int4*>(Bs + r * kLd + chunk[i]) = rb[i];
    }
    __syncthreads();
    if (k0 + kBK < k) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = As + (wm * 64 + i * 16 + g) * kLd + kk + t * 4;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * kLd);
        af[i][2] = ld32(p + 16);
        af[i][3] = ld32(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = Bs + (bs_row(j) + g) * kLd + kk + t * 4;
        bf[j][0] = ld32(p);
        bf[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }

  // accumulator r of an m16n8 tile: row g + 8 * (r >> 1), column 2t + (r & 1)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = m0 + wm * 64 + i * 16 + g + 8 * (r >> 1);
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n0 + wn * 16 + j * 8 + 2 * t + (r & 1);
        if (col >= n) continue;
        float gt = __fmul_rn(static_cast<float>(acc[i][j][r]), scale[col]);
        float vt = __fmul_rn(static_cast<float>(acc[i][j + 2][r]),
                             scale[n + col]);
        if (bias) {
          gt = __fadd_rn(gt, bias[col]);
          vt = __fadd_rn(vt, bias[n + col]);
        }
        const float sig = 1.f / (1.f + expf(-gt));
        const float h = __fmul_rn(__fmul_rn(gt, sig), vt);
        const float q = fminf(fmaxf(rintf(__fmul_rn(h, osr)), -127.f), 127.f);
        out_q[(long long)row * n + col] = static_cast<int8_t>(q);
      }
    }
  }
}

}  // namespace

// (M, K) s8 @ fc1 (2H, K)^T s8 -> dequant, silu(g) * v, requant -> (M, H) s8.
extern "C" int fitv2_int8_gemm_swiglu_quant(const void* xq, const void* wq,
                                            const void* scale,
                                            const void* bias, void* out,
                                            int m, int h, int k,
                                            float out_scale_recip,
                                            void* stream) {
  if (k % 16) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((h + kBN / 2 - 1) / (kBN / 2), (m + kBM - 1) / kBM);
  int8_gemm_swiglu_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<int8_t*>(out), m, h, k, out_scale_recip);
  return cudaGetLastError();
}
