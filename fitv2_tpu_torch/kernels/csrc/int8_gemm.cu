// K7, the int8 W8A8 SwiGLU GEMM of the int8 serving path:
//   g = f32(acc_g) * scale[n] + bias[n],
//   v = f32(acc_v) * scale[H + n] + bias[H + n],
//   out[m, n] = s8(clip(rint(g * sigmoid(g) * v * osr), 127))
// replaces fitv2_tpu/ops/int8_gemm.py:_swiglu_kernel (entry point
// fitv2_int8_gemm_swiglu_quant, wrapper kernels/int8_gemm.py:
// int8_gemm_swiglu_quant): SwiGLU fc1 + silu(g) * v + requantization to
// fc2's int8 input. (K6, the GEMM with the plain dequant epilogue, is
// int8_gemm_wgmma.cu; both run on the ring of wgmma_ring.cuh.)
// xq: (M, K) s8 row-major; wq: fc1's (2H, K) s8 row-major, the nn.Linear
// layout, rows [0, H) the gate and [H, 2H) the value: both K-major, the
// only layout 8-bit wgmma takes. scale/bias: f32, one per weight row (bias
// may be null). Any M, H >= 1; K % 16 == 0 (TMA's 16-byte global row
// stride); operands 16-byte aligned.
//
// The accumulator is exact (|acc| <= 127^2 * K, 4.96e7 at K = 3072, well
// inside s32), so the output differs from the plain version only in the f32
// epilogue; the epilogue's multiply and add are explicitly rounded
// (__fmul_rn, __fadd_rn) so they are not contracted into an FMA, and the
// requantization rounds half to even (rintf), as torch.round and jnp.round
// do. The sigmoid uses expf, not __expf.
//
// What bounds it on an H100: at the serving shape (M = 4096, K x 2H = 1152
// x 6144) the product is 58 GOP over 24 MB of operands and the s8 output
// (12.6 MB of it), ~2,400 ops per byte: far above the int8 tensor cores'
// ridge (~590 ops/byte), so
// tensor-core throughput bounds it (29.3 us at 1,979 TOP/s), and only
// wgmma reaches that rate.
//
// Design: K6's persistent TMA + mbarrier + wgmma s8 ring, with a B tile
// that pairs the gate and the value rows of the same output columns.
// - Tile 128 x 96 outputs. A stage holds the A tile (128 rows of xq) and a
//   192-row B tile: the gate rows [n0, n0 + 96) and then the value rows
//   [H + n0, H + n0 + 96), two TMA boxes from two tensor maps of extent H
//   each (wq and wq + H K, 16-byte aligned as K % 16 == 0), so TMA
//   zero-fills the ragged H edge of both halves (one (2H, K) map would
//   fill the last gate box with value rows). 96 rows are 12 swizzle atoms
//   of 1024 bytes, so the two boxes form one K-major 192-row operand.
// - Consumers (warpgroups 0 and 1: rows 0-63 and 64-127 of the tile) issue
//   four wgmma.m64n192k32.s32.s8.s8 on each stage: accumulator n8 tile j
//   (j < 12) holds gate columns 8 j .. 8 j + 7 and tile j + 12 the value
//   columns of the same outputs, in the same thread and the same slots, so
//   dequant, silu(g) * v and the requantization run in registers and the
//   (M, 2H) fc1 output never reaches device memory.
// - Tile counts: M 4096 x H 3072 is 32 x 32 = 1,024 tiles (7.76 waves of
//   132 SMs, 97% of the last), M 2048 512 tiles (3.88 waves, 97%).
// - Epilogue: the tile's 96 gate and 96 value scale and bias values are
//   copied to shared memory (cp.async) when the tile starts, under its main
//   loop. Each consumer thread writes its s8 outputs, two neighbouring
//   columns at a time, into padded staging rows (112 bytes: a warp's 2-byte
//   writes fall in distinct banks), and the warpgroup copies its 64 x 96
//   bytes out 16 contiguous bytes a thread (per byte at a ragged or
//   unaligned edge).
// - As in K6, a tile's epilogue is not overlapped with the next tile's
//   wgmma, only with its loads.
#include <cuda.h>  // CUtensorMap and its enums (types only; not linked)

#include <cstdint>

#include "common.cuh"
#include "wgmma_ring.cuh"

namespace {

using namespace fitv2;

constexpr int kBM = 128;
constexpr int kCols = 96;        // output columns of a tile
constexpr int kBN = 2 * kCols;   // B rows of a stage (gate, then value)
constexpr int kBK = kRingBK;     // bytes = s8 elements per row of a stage
constexpr int kStages = 4;
constexpr int kConsumers = 2;                     // warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer's
constexpr int kATile = kBM * kBK, kHalfTile = kCols * kBK;
constexpr int kStageBytes = kATile + 2 * kHalfTile;
constexpr int kAcc = kBN / 2;  // s32 accumulators a consumer thread holds
constexpr int kLdOut = kCols + 16;     // staged output row, bytes
constexpr int kOutBytes = 64 * kLdOut;  // per consumer warpgroup
constexpr int kBarOffset = kStages * kStageBytes;
constexpr int kOutOffset = kBarOffset + 2 * kStages * 8;
// tiles, barriers, output staging, and the 1024-byte alignment the
// 128-byte swizzle needs
constexpr int kSmemBytes = kOutOffset + kConsumers * kOutBytes + 1024;
static_assert(kOutOffset % 16 == 0 && kOutBytes % 16 == 0 && kLdOut % 16 == 0,
              "output staging rows are read 16 bytes at a time");
static_assert(kATile % 1024 == 0 && kHalfTile % 1024 == 0,
              "stage tiles must keep the 1024-byte swizzle alignment");
static_assert(kCols % 16 == 0, "gate and value columns share a thread, and "
              "tiles start on 16-byte output columns");
static_assert(kBN == 192, "wgmma_m64n192k32 is written for kBN = 192");

// d (64 x 192 s32, warpgroup-wide) (+)= A (64 x 32 s8) * B (192 x 32 s8)^T;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n192k32(int (&d)[kAcc], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %98, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95}, %96, %97, p;\n\t}"
      : FITV2_ACC8(0), FITV2_ACC8(8), FITV2_ACC8(16), FITV2_ACC8(24),
        FITV2_ACC8(32), FITV2_ACC8(40), FITV2_ACC8(48), FITV2_ACC8(56),
        FITV2_ACC8(64), FITV2_ACC8(72), FITV2_ACC8(80), FITV2_ACC8(88)
      : "l"(da), "l"(db), "r"(accumulate));
}

// silu(g) * v requantized to s8, from the two exact accumulators
__device__ __forceinline__ int swiglu_q(int acc_g, int acc_v, float sg,
                                        float sv, float bg, float bv,
                                        bool has_bias, float osr) {
  float g = __fmul_rn(static_cast<float>(acc_g), sg);
  float v = __fmul_rn(static_cast<float>(acc_v), sv);
  if (has_bias) {
    g = __fadd_rn(g, bg);
    v = __fadd_rn(v, bv);
  }
  const float sig = 1.f / (1.f + expf(-g));
  const float h = __fmul_rn(__fmul_rn(g, sig), v);
  return static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(h, osr)), -127.f),
                                127.f));
}

__global__ void __launch_bounds__(kThreads, 1)
int8_gemm_swiglu_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap gmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        int8_t* __restrict__ out, int m, int h, int k,
                        float osr) {
  extern __shared__ uint8_t smem_raw[];
  // per consumer warpgroup: the tile's gate scale, value scale, gate bias
  // and value bias columns
  __shared__ __align__(16) float vec_s[kConsumers][4][kCols];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  uint8_t* const smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = raw + static_cast<uint32_t>(smem - smem_raw);
  // stage s: A tile at base + s * kStageBytes, the gate rows kATile bytes
  // after it and the value rows kHalfTile bytes after those; full barrier s
  // at bars + 8 s, empty barrier s at bars + 8 (kStages + s); then each
  // consumer warpgroup's output staging
  const uint32_t bars = base + kBarOffset;
  const int tiles_n = (h + kCols - 1) / kCols;
  const int tiles = tiles_n * ((m + kBM - 1) / kBM);
  const int kblocks = (k + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                            // the producer
      mbar_init(bars + 8 * (kStages + s), kConsumers * 4);  // consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer
    if (threadIdx.x == kConsumers * 128) {
      prefetch_tensormap(&xmap);
      prefetch_tensormap(&gmap);
      prefetch_tensormap(&vmap);
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kCols;
        for (int kb = 0; kb < kblocks; ++kb) {
          // a fresh barrier counts as having completed the phase before
          // its first, so the first lap does not wait
          mbar_wait(bars + 8 * (kStages + s), phase ^ 1);
          const uint32_t full = bars + 8 * s;
          const uint32_t a = base + s * kStageBytes;
          mbar_expect_tx(full, kStageBytes);
          tma_load(a, &xmap, full, kb * kBK, m0);
          tma_load(a + kATile, &gmap, full, kb * kBK, n0);
          tma_load(a + kATile + kHalfTile, &vmap, full, kb * kBK, n0);
          if (++s == kStages) s = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  int acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0;
  float* const vsg = vec_s[wg][0];
  float* const vsv = vec_s[wg][1];
  float* const vbg = vec_s[wg][2];
  float* const vbv = vec_s[wg][3];
  uint8_t* const staged = smem + kOutOffset + wg * kOutBytes;
  const bool has_bias = bias != nullptr;
  const bool aligned = h % 16 == 0;  // 16-byte global stores
  int s = 0, prev = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kCols;
    // the tile's scale and bias columns, copied under the main loop
    for (int i = threadIdx.x & 127; i < kCols && n0 + i < h; i += 128) {
      cp_async4(vsg + i, scale + n0 + i);
      cp_async4(vsv + i, scale + h + n0 + i);
      if (has_bias) {
        cp_async4(vbg + i, bias + n0 + i);
        cp_async4(vbv + i, bias + h + n0 + i);
      }
    }
    cp_async_commit();
    for (int kb = 0; kb < kblocks; ++kb) {
      mbar_wait(bars + 8 * s, phase);
      const uint32_t a = base + s * kStageBytes;
      const uint64_t da = sw128_desc(a + wg * 64 * kBK);
      const uint64_t db = sw128_desc(a + kATile);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_m64n192k32(acc, da + 2 * kk, db + 2 * kk, kb > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      fence_acc(acc);
      if (kb > 0 && lane == 0) mbar_arrive(bars + 8 * (kStages + prev));
      __syncwarp();
      prev = s;
      if (++s == kStages) s = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + prev));
    cp_async_wait<0>();
    // the warpgroup's copies of scale and bias are all in
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");

    // Epilogue: (1) each thread requantizes its outputs into the staging
    // rows, (2) the warpgroup copies the rows out, 16 bytes a thread.
    // Accumulator 4 j + r is row g + 8 (r >> 1), column 8 j + 2 t + (r & 1)
    // of the warp's 16 x 192 slice; columns c and 96 + c (tile j + 12) are
    // the gate and the value of output column c.
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const int c = j * 8 + 2 * t;
      // columns past h hold no scale: computed, never stored
      const float2 sg = *reinterpret_cast<const float2*>(vsg + c);
      const float2 sv = *reinterpret_cast<const float2*>(vsv + c);
      float2 bg = make_float2(0.f, 0.f), bv = bg;
      if (has_bias) {
        bg = *reinterpret_cast<const float2*>(vbg + c);
        bv = *reinterpret_cast<const float2*>(vbv + c);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {  // rows g and g + 8
        const int e = 4 * j + 2 * hr, ev = e + 4 * (kCols / 8);
        const int q0 = swiglu_q(acc[e], acc[ev], sg.x, sv.x, bg.x, bv.x,
                                has_bias, osr);
        const int q1 = swiglu_q(acc[e + 1], acc[ev + 1], sg.y, sv.y, bg.y,
                                bv.y, has_bias, osr);
        const int r = warp * 16 + 8 * hr + g;
        *reinterpret_cast<uint16_t*>(staged + r * kLdOut + c) =
            static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
      }
    }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    constexpr int kChunks = kCols / 16;
    for (int i = threadIdx.x & 127; i < 64 * kChunks; i += 128) {
      const int r = i / kChunks, c = i % kChunks * 16;
      const int row = m0 + wg * 64 + r, col = n0 + c;
      if (row >= m || col >= h) continue;
      const uint8_t* src = staged + r * kLdOut + c;
      int8_t* dst = out + static_cast<long long>(row) * h + col;
      if (aligned && col + 16 <= h) {
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
      } else {
        for (int e = 0; e < 16 && col + e < h; ++e)
          dst[e] = static_cast<int8_t>(src[e]);
      }
    }
    // the staging rows, scale and bias are free again
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
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
  if (m < 1 || h < 1 || k < 16 || k % 16) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const auto* w = static_cast<const int8_t*>(wq);
  CUtensorMap xmap, gmap, vmap;
  if (!encode_operand(encode, &xmap, xq, m, k, kBM) ||
      !encode_operand(encode, &gmap, w, h, k, kCols) ||
      !encode_operand(encode, &vmap, w + static_cast<long long>(h) * k, h, k,
                      kCols))
    return cudaErrorInvalidValue;
  int sms;
  const cudaError_t err =
      persistent_sms<&int8_gemm_swiglu_kernel>(kSmemBytes, &sms);
  if (err != cudaSuccess) return err;
  const int tiles = (m + kBM - 1) / kBM * ((h + kCols - 1) / kCols);
  const int grid = tiles < sms ? tiles : sms;
  int8_gemm_swiglu_kernel<<<grid, kThreads, kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      xmap, gmap, vmap, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<int8_t*>(out), m, h, k,
      out_scale_recip);
  return cudaGetLastError();
}
