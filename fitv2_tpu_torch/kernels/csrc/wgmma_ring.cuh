// The TMA + mbarrier + wgmma s8 ring shared by the two int8 GEMMs (K6,
// int8_gemm_wgmma.cu; K7, int8_gemm.cu): barrier and copy primitives, the
// wgmma matrix descriptor of a TMA tile in the 128-byte swizzle, the 2-D
// tensor maps of the s8 operands, and the persistent grid's SM count.
//
// A stage row is kRingBK = 128 bytes of K (the 128-byte swizzle's width),
// so a box of r rows is r * 128 bytes and keeps the 1024-byte swizzle
// alignment whenever r is a multiple of 8. Each wgmma k32 step moves the
// descriptor's start 32 bytes along the swizzled row.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; not linked)

#include <cstdint>

#include "common.cuh"

namespace fitv2 {

constexpr int kRingBK = 128;  // bytes = s8 elements per row of a stage

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Waits for the barrier's phase of this parity to complete. A wait that
// lasts 2^34 cycles (~9 s) traps, so a fault in the ring ends the launch
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// 2-D TMA copy of the box at (c0 = K byte, c1 = row) into shared memory;
// completes the box's bytes of the barrier's transaction count (rows and
// bytes past the map's extent arrive as zeros and count too).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// wgmma matrix descriptor of a K-major tile in the 128-byte swizzle: start
// address >> 4 (bits 0-13), leading byte offset 16 B (unused by a swizzled
// K-major operand), stride byte offset 1024 B (8 rows of 128 B) >> 4 (bits
// 32-45), layout 1 = 128-byte swizzle (bits 62-63). Adding j to it moves
// the start 16 * j bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (whose results appear only after wgmma_wait).
template <int kN>
__device__ __forceinline__ void fence_acc(int (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Eight s32 accumulators as read-write operands of a wgmma asm statement.
#define FITV2_ACC8(i)                                                 \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),         \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (null when
// the driver lacks it), reached through the runtime's driver entry point so
// that the library is not linked with -lcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// (rows, k) s8 row-major as a 2-D tensor map with (box_rows, kRingBK)
// boxes in the 128-byte swizzle; out-of-bounds elements read as 0.
inline bool encode_operand(EncodeTiled encode, CUtensorMap* map,
                           const void* ptr, int rows, int k, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {kRingBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

// The current device's SM count, the size of a persistent grid, after
// raising kKernel's dynamic shared memory limit to `smem` there (once per
// device and kernel).
template <auto kKernel>
cudaError_t persistent_sms(int smem, int* count) {
  static int sms[kMaxDevices] = {};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(kKernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    int n;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms[dev] = n;
  }
  *count = sms[dev];
  return cudaSuccess;
}

}  // namespace fitv2
