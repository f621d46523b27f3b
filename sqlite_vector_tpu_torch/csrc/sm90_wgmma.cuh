// What the warp-specialised Hopper (sm_90a) kernels share, K1's
// csrc/block_minima_wgmma.cu and K2's csrc/int4_minima_wgmma.cu: PTX
// wrappers for mbarriers, TMA tile copies, named barriers, setmaxnreg and
// the wgmma fence/commit/wait, the shared-memory descriptor of a TMA
// 128-byte-swizzled K-major operand, and the host's TMA descriptor encoding
// (the driver's cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint(ByVersion), so no link against libcuda).
// Everything is in an anonymous namespace: each source keeps its own copy.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sm90_common.cuh"

namespace {

// what a launcher returns when the driver refuses a TMA descriptor: this
// plus the CUresult
constexpr int kEncodeFailed = 10000;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait for the completion of the barrier's phase of this parity (the loop
// is PTX's, so the warp stays converged for the .aligned instructions after)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// a TMA copy of the box at (c0, c1, c2) of `map` into shared memory at dst,
// completing on the mbarrier bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, "
      "%4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// a barrier of one warpgroup that also ORs v over its 128 threads
__device__ __forceinline__ bool bar_any(int id, bool v) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\nbar.red.or.pred q, %2, 128, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(v)), "r"(id)
      : "memory");
  return r != 0;
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous MMAs that write them (float and int32 accumulators)
template <int M, int NT>
__device__ __forceinline__ void fence_acc(float (&acc)[M][NT][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[m][n][e])::"memory");
}

template <int M, int NT>
__device__ __forceinline__ void fence_acc(int (&acc)[M][NT][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(acc[m][n][e])::"memory");
}

// The wgmma shared-memory descriptor of a K-major operand as TMA's
// SWIZZLE_128B leaves it: 128-byte rows, 8-row (1,024-byte) swizzle atoms
// one after another (stride byte offset 1,024), layout type 1 (128B
// swizzle). A k-step of 32 bytes inside the atom moves the start address by
// 2 (16-byte units); the hardware applies the swizzle to the address.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3ffff) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// ---- host side -------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once
cudaError_t encode_tiled(EncodeTiled& fn) {
  static std::atomic<void*> cached{nullptr};
  void* p = cached.load(std::memory_order_acquire);
  if (p == nullptr) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached.store(p, std::memory_order_release);
  }
  fn = reinterpret_cast<EncodeTiled>(p);
  return cudaSuccess;
}


// A 3-D map {inner, rows, planes} of a contiguous [planes, rows, inner]
// tensor of elem-byte elements at ptr (16-byte aligned, inner * elem a
// multiple of 16), boxes of box_inner x box_rows x box_planes swizzled by
// 128 bytes (box_inner * elem <= 128), zero past the edges. Returns 0, a
// cudaError_t, or kEncodeFailed + the driver's CUresult.
inline int encode_map3(CUtensorMap* map, CUtensorMapDataType type, long long elem, const void* ptr,
                       long long inner, long long rows, long long planes, long long box_inner,
                       int box_rows, int box_planes = 1) {
  EncodeTiled fn;
  const cudaError_t err = encode_tiled(fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pitch = inner * elem;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(pitch), static_cast<cuuint64_t>(pitch * rows)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_rows),
                             static_cast<cuuint32_t>(box_planes)};
  const cuuint32_t elems[3] = {1, 1, 1};
  const CUresult r = fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elems,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

// whether TMA can copy rows of row_bytes bytes starting at p
inline bool tma_ready(const void* p, long long row_bytes) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && row_bytes % 16 == 0;
}

}  // namespace
