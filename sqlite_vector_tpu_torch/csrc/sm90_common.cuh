// Helpers shared by the persistent tensor-core kernels for NVIDIA Hopper
// (sm_90a), csrc/block_minima_mma.cu (K1) and csrc/int4_minima_mma.cu (K2):
// cp.async wrappers, the staging of a row tile's column chunk into a
// shared-memory ring stage, and the launch facts read once per device.
// Everything is in an anonymous namespace: each source keeps its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// stage_chunk's cp.async copies of Vec (16 or 4) bytes. The thread copies
// units tid, tid + Threads, ... of the chunk's rows in row-major order; each
// step moves on Threads / per_row rows and Threads % per_row units, so no
// copy pays for a division (with the chunk known only at run time, two
// divisions a copy cost more than the copy).
template <int Rows, int Threads, int Vec>
__device__ __forceinline__ void stage_units(unsigned char* dst, const unsigned char* base,
                                            long long row0, int N, int row_bytes, int c0,
                                            int chunk, int pitch, int tid) {
  const int per_row = chunk / Vec;
  const int dr = Threads / per_row;
  const int du = Threads % per_row;
  int r = tid / per_row;
  int u = tid % per_row;
#pragma unroll 4
  for (int i = 0; i < Rows * (chunk / Vec) / Threads; ++i) {
    const int c = c0 + u * Vec;
    const long long row = row0 + r;
    const bool in = row < N && c < row_bytes;
    const unsigned char* src = in ? base + row * row_bytes + c : base;
    const uint32_t to = smem_addr(dst + r * pitch + u * Vec);
    if constexpr (Vec == 16) {
      cp_async16(to, src, in ? 16 : 0);
    } else {
      cp_async4(to, src, in ? 4 : 0);
    }
    r += dr;
    u += du;
    if (u >= per_row) {
      u -= per_row;
      ++r;
    }
  }
}

// Stage the chunk-byte column chunk `ch` of rows [row0, row0 + Rows) of a
// row-major matrix of row_bytes-byte rows into a ring stage (row r at
// dst + r * pitch), Threads threads cooperating; bytes past the row end or
// rows >= N are zero. chunk is a multiple of 16 and Rows * chunk / 16 a
// multiple of Threads (a compile-time constant in K1, the ring's width at
// run time in K2). vec: 16 (the pointer and row pitch are 16-byte
// aligned), 4, or 1 (plain loads), as load_width picks.
template <int Rows, int Threads>
__device__ __forceinline__ void stage_chunk(unsigned char* dst, const unsigned char* base,
                                            long long row0, int N, int row_bytes, int ch,
                                            int chunk, int pitch, int vec, int tid) {
  const int c0 = ch * chunk;
  if (vec == 16) {
    stage_units<Rows, Threads, 16>(dst, base, row0, N, row_bytes, c0, chunk, pitch, tid);
  } else if (vec == 4) {
    stage_units<Rows, Threads, 4>(dst, base, row0, N, row_bytes, c0, chunk, pitch, tid);
  } else {
    for (int i = 0; i < Rows * (chunk / 4) / Threads; ++i) {
      const int p = tid + i * Threads;
      const int r = p / (chunk / 4);
      const int c = c0 + (p % (chunk / 4)) * 4;
      const long long row = row0 + r;
      uint32_t w = 0;
      if (row < N) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c + e < row_bytes) w |= static_cast<uint32_t>(base[row * row_bytes + c + e]) << (8 * e);
        }
      }
      *reinterpret_cast<uint32_t*>(dst + r * pitch + (c - c0)) = w;
    }
  }
}

// stage_chunk's vec for a matrix at `base` with row_bytes-byte rows
inline int load_width(const void* base, long long row_bytes) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(base);
  if (addr % 16 == 0 && row_bytes % 16 == 0) return 16;
  if (addr % 4 == 0 && row_bytes % 4 == 0) return 4;
  return 1;
}

// The device's SM count and opt-in shared-memory limit per block, read at
// the first launch on it and kept (packed as sms << 32 | limit).
cudaError_t device_facts(int dev, int& sms, int& smem_limit) {
  static std::atomic<long long> facts[kMaxDevices];
  long long v = facts[dev].load(std::memory_order_acquire);
  if (v == 0) {
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (err != cudaSuccess) return err;
    v = static_cast<long long>(sms) << 32 | static_cast<unsigned>(smem_limit);
    facts[dev].store(v, std::memory_order_release);
  }
  sms = static_cast<int>(v >> 32);
  smem_limit = static_cast<int>(v & 0xffffffffLL);
  return cudaSuccess;
}

// The current device, its SM count and its opt-in shared-memory limit per
// block.
cudaError_t current_device(int& dev, int& sms, int& smem_limit) {
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  return device_facts(dev, sms, smem_limit);
}

// How many blocks of a persistent kernel instance, of `threads` threads
// with `smem` bytes of dynamic shared memory, fit on one SM of device
// `dev` (whose opt-in limit current_device read). At the instance's first
// launch on a device this raises its dynamic shared limit to that limit.
// `fit` is the instance's own cache, one entry a device: 0 until that
// first launch, then smem << 32 | blocks per SM for the last size asked.
// Returns cudaErrorInvalidValue when `smem` passes the limit and
// cudaErrorInvalidConfiguration when not one block fits.
cudaError_t blocks_per_sm(const void* kernel, int threads, long long smem, int dev, int smem_limit,
                          std::atomic<long long>* fit, int& per_sm) {
  cudaError_t err;
  if (smem > smem_limit) return cudaErrorInvalidValue;
  const long long f = fit[dev].load(std::memory_order_acquire);
  if (f == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_limit);
    if (err != cudaSuccess) return err;
  }
  per_sm = static_cast<int>(f & 0xffffffffLL);
  if (f == 0 || (f >> 32) != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                        static_cast<size_t>(smem));
    if (err != cudaSuccess) return err;
    fit[dev].store(smem << 32 | static_cast<unsigned>(per_sm), std::memory_order_release);
  }
  return per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

}  // namespace
