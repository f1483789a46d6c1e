// K6, the int8 W8A8 GEMM with the dequant epilogue, for Hopper:
//   out[m, n] = T(f32(sum_k xq[m, k] * wq[n, k]) * scale[n] + bias[n])
// replaces fitv2_tpu/ops/int8_gemm.py:_bias_kernel (entry point
// fitv2_int8_gemm_bias, wrapper kernels/int8_gemm.py:int8_gemm_bias): qkv,
// proj and fc2 of the int8 serving path (and fc1 of the GELU Mlp).
// xq: (M, K) s8 row-major; wq: (N, K) s8 row-major, the nn.Linear layout.
// Both are K-major, the only layout 8-bit wgmma takes, so nothing is
// transposed. scale/bias: (N,) f32, bias may be null; T is f32 or bf16.
// Any M, N >= 1; K % 16 == 0 (TMA's 16-byte global row stride); operands
// 16-byte aligned.
//
// What bounds it on an H100: at the serving shapes (M = 4096 or 2048; K x N
// = 1152 x 3456, 1152 x 1152, 3072 x 1152) the products are 5.4 to 32.6
// GOP over 4 to 37 MB of operands and outputs, 700 to 2,400 ops per byte:
// above the int8 tensor cores' ridge (~590 ops/byte), so tensor-core
// throughput bounds it, and only wgmma reaches that rate.
//
// Design:
// - Tile 128 x 144 (kBM x kBN). 144 divides 1152 and 3456, so the XL
//   shapes have no ragged tile: 4096 x 1152 is 256 tiles and 2048 x 1152
//   128 tiles, 97% of two waves and of one wave on 132 SMs (a 128 x 128
//   tile gave 73% and 55%).
// - Persistent: grid = min(tiles, SMs), one block per SM; block b takes
//   tiles b, b + grid, ... The ring runs on across tiles, so the next
//   tile's loads are in flight during this tile's epilogue.
// - Loads: two 2-D TMA tensor maps, xq as (M, K) and wq as (N, K), with a
//   128-byte K box and the 128-byte swizzle. TMA zero-fills the ragged M,
//   N and K edges, so the loads carry no masks. The maps are encoded on
//   the host at every call (cuTensorMapEncodeTiled, reached through the
//   runtime's driver entry point, so the library is not linked with
//   -lcuda) and passed as __grid_constant__ parameters.
// - Ring: kStages stages of (kBM + kBN) x 128 bytes, each with a full and
//   an empty mbarrier. One thread of the third warpgroup (the producer)
//   waits for a stage to be empty, arms its full barrier with expect_tx
//   and issues the two copies. Warpgroups 0 and 1 (the consumers: rows
//   0-63 and 64-127 of the tile) wait for it to be full and issue four
//   wgmma.m64n144k32.s32.s8.s8 on it, both operands read from shared
//   memory through matrix descriptors (128-byte swizzle, SBO 1024 bytes;
//   each k32 step moves the start address 32 bytes along the swizzled
//   row). One stage's wgmma group stays in flight; each consumer warp
//   frees the stage before it.
// - Epilogue: the tile's 144 scale and bias values are copied to shared
//   memory (cp.async) when the tile starts, under its main loop. Each
//   consumer thread dequantizes its 72 s32 accumulators into padded
//   staging rows in shared memory, and the warpgroup then copies the rows
//   out 16 contiguous bytes a thread (guarded per element at a ragged or
//   unaligned edge). Straight from the accumulator layout each warp store
//   would touch 8 rows; staged, the bf16 qkv GEMM ran 1.45x faster on an
//   H100. The accumulator is exact (|acc| <= 127^2 * K, 4.96e7 at K =
//   3072), and the multiply and the add are rounded separately
//   (__fmul_rn, __fadd_rn), as the plain version's two passes are, so the
//   output equals the plain version bit for bit.
// - Not overlapped yet: a tile's epilogue with the next tile's wgmma (both
//   consumer warpgroups work on one tile). Consumers that take alternate
//   tiles ("ping-pong", 128 x 144 each, setmaxnreg) would hide it.
// The ring's barrier, copy, descriptor and tensor-map code is
// wgmma_ring.cuh, shared with K7 (int8_gemm.cu).
#include <cuda.h>  // CUtensorMap and its enums (types only; not linked)

#include <cstdint>

#include "common.cuh"
#include "wgmma_ring.cuh"

namespace {

using namespace fitv2;

constexpr int kBM = 128, kBN = 144;
constexpr int kBK = kRingBK;  // bytes = s8 elements per row of a stage
constexpr int kStages = 5;
constexpr int kConsumers = 2;                     // warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer's
constexpr int kATile = kBM * kBK, kBTile = kBN * kBK;
constexpr int kStageBytes = kATile + kBTile;
constexpr int kAcc = kBN / 2;  // s32 accumulators a consumer thread holds
// output staging: rows of kLdOut elements (8 of padding keep a warp's pair
// writes in distinct banks), 19,456 bytes per consumer warpgroup: 64 bf16
// rows, or 32 f32 rows at a time
constexpr int kLdOut = kBN + 8;
constexpr int kOutBytes = 64 * kLdOut * 2;
constexpr int kBarOffset = kStages * kStageBytes;
constexpr int kOutOffset = kBarOffset + 2 * kStages * 8;
// tiles, barriers, output staging, and the 1024-byte alignment the
// 128-byte swizzle needs
constexpr int kSmemBytes = kOutOffset + kConsumers * kOutBytes + 1024;
static_assert(kOutOffset % 16 == 0 && kOutBytes % 16 == 0,
              "output staging rows are read 16 bytes at a time");
static_assert(kATile % 1024 == 0 && kBTile % 1024 == 0,
              "stage tiles must keep the 1024-byte swizzle alignment");
static_assert(kBN == 144, "wgmma_m64n144k32 is written for kBN = 144");

// d (64 x 144 s32, warpgroup-wide) (+)= A (64 x 32 s8) * B (144 x 32 s8)^T;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n144k32(int (&d)[kAcc], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %74, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71}, %72, %73, p;\n\t}"
      : FITV2_ACC8(0), FITV2_ACC8(8), FITV2_ACC8(16), FITV2_ACC8(24),
        FITV2_ACC8(32), FITV2_ACC8(40), FITV2_ACC8(48), FITV2_ACC8(56),
        FITV2_ACC8(64)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float y0, float y1);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float y0,
                                                  float y1) {
  *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p,
                                                          float y0, float y1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y0, y1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
int8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ out,
                       int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  // scale and bias of the tile's columns, per consumer warpgroup
  __shared__ __align__(16) float vec_s[kConsumers][2][kBN];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  uint8_t* const smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = raw + static_cast<uint32_t>(smem - smem_raw);
  // stage s: A tile at base + s * kStageBytes, B tile kATile bytes after
  // it; full barrier s at bars + 8 s, empty barrier s at bars + 8 (kStages
  // + s); then each consumer warpgroup's output staging
  const uint32_t bars = base + kBarOffset;
  const int tiles_n = (n + kBN - 1) / kBN;
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
      prefetch_tensormap(&wmap);
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
        for (int kb = 0; kb < kblocks; ++kb) {
          // a fresh barrier counts as having completed the phase before
          // its first, so the first lap does not wait
          mbar_wait(bars + 8 * (kStages + s), phase ^ 1);
          const uint32_t full = bars + 8 * s;
          const uint32_t a = base + s * kStageBytes;
          mbar_expect_tx(full, kStageBytes);
          tma_load(a, &xmap, full, kb * kBK, m0);
          tma_load(a + kATile, &wmap, full, kb * kBK, n0);
          if (++s == kStages) s = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  int acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0;
  float* const vs = vec_s[wg][0];
  float* const vb = vec_s[wg][1];
  T* const staged = reinterpret_cast<T*>(smem + kOutOffset + wg * kOutBytes);
  int s = 0, prev = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
    // the tile's scale and bias columns, copied under the main loop
    for (int i = threadIdx.x & 127; i < kBN && n0 + i < n; i += 128) {
      cp_async4(vs + i, scale + n0 + i);
      if (bias) cp_async4(vb + i, bias + n0 + i);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    for (int kb = 0; kb < kblocks; ++kb) {
      mbar_wait(bars + 8 * s, phase);
      const uint32_t a = base + s * kStageBytes;
      const uint64_t da = sw128_desc(a + wg * 64 * kBK);
      const uint64_t db = sw128_desc(a + kATile);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_m64n144k32(acc, da + 2 * kk, db + 2 * kk, kb > 0 || kk > 0);
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
    asm volatile("cp.async.wait_all;" ::: "memory");
    // the warpgroup's copies of scale and bias are all in
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");

    // Epilogue, in kPasses passes of kRows rows of the warpgroup's 64: (1)
    // each thread dequantizes its accumulators into the staging rows, (2)
    // the warpgroup copies the rows out, 16 contiguous bytes a thread.
    // Accumulator 4 j + r is row g + 8 (r >> 1), column 8 j + 2 t + (r & 1)
    // of the warp's 16 x 144 slice (g = lane / 4, t = lane % 4).
    constexpr int kPasses = sizeof(T) / 2, kRows = 64 / kPasses;
    constexpr int kVec = 16 / sizeof(T), kChunks = kBN / kVec;
    const bool aligned = n * sizeof(T) % 16 == 0;  // 16-byte global stores
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int c = j * 8 + 2 * t;
        // columns past n hold no scale: computed, never stored
        const float2 sc = *reinterpret_cast<const float2*>(vs + c);
        const float2 bi = *reinterpret_cast<const float2*>(vb + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (kPasses == 2 && h != pass) continue;
          float y0 = __fmul_rn(static_cast<float>(acc[4 * j + 2 * h]), sc.x);
          float y1 =
              __fmul_rn(static_cast<float>(acc[4 * j + 2 * h + 1]), sc.y);
          if (bias) {
            y0 = __fadd_rn(y0, bi.x);
            y1 = __fadd_rn(y1, bi.y);
          }
          const int r = kPasses == 1 ? warp * 16 + 8 * h + g : warp * 8 + g;
          store_pair<T>(staged + r * kLdOut + c, y0, y1);
        }
      }
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
      for (int i = threadIdx.x & 127; i < kRows * kChunks; i += 128) {
        const int r = i / kChunks, c = i % kChunks * kVec;
        const int row = m0 + wg * 64 +
                        (kPasses == 1 ? r : r / 8 * 16 + 8 * pass + r % 8);
        const int col = n0 + c;
        if (row >= m || col >= n) continue;
        const T* src = staged + r * kLdOut + c;
        T* dst = out + static_cast<long long>(row) * n + col;
        if (aligned && col + kVec <= n) {
          *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
        } else {
          for (int e = 0; e < kVec && col + e < n; ++e) dst[e] = src[e];
        }
      }
      // the staging rows (and, after the last pass, scale and bias) are
      // free again
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    }
  }
}

template <typename T>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& wmap,
                   const float* scale, const float* bias, T* out, int m,
                   int n, int k, cudaStream_t stream) {
  int sms;
  const cudaError_t err =
      persistent_sms<&int8_gemm_wgmma_kernel<T>>(kSmemBytes, &sms);
  if (err != cudaSuccess) return err;
  const int tiles = (m + kBM - 1) / kBM * ((n + kBN - 1) / kBN);
  const int grid = tiles < sms ? tiles : sms;
  int8_gemm_wgmma_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      xmap, wmap, scale, bias, out, m, n, k);
  return cudaGetLastError();
}

}  // namespace

// (M, K) s8 @ (N, K)^T s8 -> (M, N) f32 or bf16 with the dequant epilogue.
extern "C" int fitv2_int8_gemm_bias(const void* xq, const void* wq,
                                    const void* scale, const void* bias,
                                    void* out, int m, int n, int k, int dtype,
                                    void* stream) {
  if (m < 1 || n < 1 || k < 16 || k % 16) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  CUtensorMap xmap, wmap;
  if (!encode_operand(encode, &xmap, xq, m, k, kBM) ||
      !encode_operand(encode, &wmap, wq, n, k, kBN))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto s = static_cast<const float*>(scale);
  auto b = static_cast<const float*>(bias);
  switch (dtype) {
    case kFloat32:
      return launch(xmap, wmap, s, b, static_cast<float*>(out), m, n, k, st);
    case kBFloat16:
      return launch(xmap, wmap, s, b, static_cast<__nv_bfloat16*>(out), m, n,
                    k, st);
    default:
      return cudaErrorInvalidValue;
  }
}
