// K1 on Hopper's warpgroup MMA: the dot-family block minima for float rows
// (f32, f16, bf16) with TMA copies, mbarrier-ordered stages and warp
// specialisation, for NVIDIA Hopper (sm_90a).
//
// Computes what csrc/block_minima.cu computes (its header states the
// contract), replacing the three TPU schedules of
// sqlite_vector_tpu/ops/pallas_scan.py (:681 _pallas_block_minima, :636
// _pallas_block_minima_manual, :587 _pallas_block_minima_stream):
//
//   out[b, g] = min over rows r in [128 g, 128 g + 128) of dist(q_b, base_r)
//
// for L2 (squared), SQUARED_L2, COSINE and DOT over float32, float16 and
// bfloat16 rows, with the same snap, NaN -> +inf, rows >= valid -> +inf,
// optional row mask and non-finite recompute as csrc/block_minima_mma.cu
// (the mma.sync body, which keeps u8/i8 codes and float rows TMA cannot
// copy, and stays launchable as the cross-check); ops/block_scan.py:k1_body
// routes between the bodies.
//
// The products:
//   - f16/bf16: wgmma m64nNk16 with both operands in shared memory, f32
//     accumulation (the product of two 16-bit floats is exact in f32);
//   - f32: wgmma m64nNk8 TF32 in the 3xTF32 split of the mma.sync body
//     (dot ~ lo.q_hi + hi.q_lo + hi.q_hi, f32 accumulation). wgmma reads an
//     f32 operand as TF32 by dropping its 13 low mantissa bits, so the rows
//     enter as the A operand from registers, split there (hi = rna(x), lo =
//     rna(x - hi)), and the queries' two planes come from shared memory,
//     laid out once a call by ops/block_scan.py:tf32_planes (q_hi = rna(q),
//     TF32-exact; q_lo = q - q_hi, which wgmma truncates).
//   Row and query norms are fmaf chains in column order over the values
//   widened to f32, chunk by chunk where the dot is (kPromote); the query
//   norms are read from the queries in global memory, the rows' from the
//   staged chunk (undoing the swizzle). A pair whose row or query norm is
//   not finite is recomputed by the fmaf chain (k1_common.cuh:
//   nonfinite_pass), as in the mma.sync body.
//
// What bounds it on an H100: 16-bit rows are bound by bytes at every batch
// up to 64 (1M x 384: 768 MB, 0.23 ms; the MMAs ~0.05 ms at 989 TFLOP/s);
// f32 by bytes at B=1 and near the TF32 rate at B=64 (3 x 49 GFLOP at 1M x
// 384 is 0.30 ms at 495 TFLOP/s against a 0.46 ms byte floor; 1M x 4,096:
// 3 x 537 GFLOP, 3.3 ms against 4.9). The mma.sync body lost to one
// torch.matmul there because its warps issued the copies, the MMAs and the
// epilogue in turn, and each warp-level TF32 MMA cost ~10 issue cycles of a
// partition. The design:
//   - one producer warpgroup (setmaxnreg down to 40 registers) and two
//     consumer warpgroups (up to 232): persistent blocks walk 256-row
//     tiles, consumer w owning rows [128 w, 128 w + 128) of each, one
//     minima group, as two m64 halves, so a group's minimum never leaves
//     its warpgroup;
//   - each consumer has its own ring of 2-4 stages; one producer thread a
//     ring keeps it full with TMA copies (a box of 128 bytes x 128 rows,
//     CU_TENSOR_MAP_SWIZZLE_128B, which lands in the layout a wgmma
//     shared-memory descriptor reads; zero-filled past d and N) completing
//     on the stage's mbarrier, and waits on the stage's empty barrier;
//   - the query tile (8/16/32/64 queries, wgmma's N) is resident in shared
//     memory, copied once a block by TMA, where its planes take at most
//     ops/block_scan.py:_WGMMA_QUERY_BYTES; otherwise (kStream) each stage
//     carries the tile's 128-byte column chunk beside the rows';
//   - the consumers can run ping-pong (pingpong): named barriers give one
//     the tensor cores for a whole row tile's MMAs while the other runs its
//     epilogue (compose, group minimum, store). ops/block_scan.py:
//     wgmma_pingpong takes it only for 16-bit rows with a resident tile of
//     64 queries, where the epilogue outweighs the MMAs; elsewhere the
//     consumers run free, which read faster on an H100 (f32 B=64 by 8% at
//     d = 384 and 33% at 4,096): a consumer waits for each chunk's MMAs
//     before the next (the A fragments of f32 live in its registers until
//     then), and the other fills that gap only when it may issue;
//   - while a chunk's MMAs run, the warpgroup sums the chunk's row norms on
//     the CUDA cores; tiles that add each chunk's products to running
//     totals (kPromote: 8 and 16 queries, 16-bit also 32, every streamed
//     tile; the tensor cores' truncating accumulation over a wide row
//     drifts past the tolerance) add them after the chunk's wait;
//   - rows past the last multiple of 256 and past valid read +inf, as do
//     masked rows.
//
// The TMA descriptors are built on the host for each launch with the
// driver's cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint(ByVersion) (no link against libcuda), and passed
// as __grid_constant__ kernel parameters.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 (as
// ops/_build.py does; no --use_fast_math).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "k1_common.cuh"
#include "sm90_common.cuh"
#include "sm90_wgmma.cuh"

namespace {

constexpr int kWgRows = kGroup;           // rows a consumer owns in a row tile: one group
constexpr int kTileRows = 2 * kWgRows;    // a block's row tile: two groups
constexpr int kThreads = 3 * 128;         // two consumer warpgroups, one producer
constexpr int kMaxStages = 4;
constexpr int kRowStage = kWgRows * kChunk;  // a group's 128-byte column chunk
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// named barriers (0 is __syncthreads): a consumer's own (1, 2), the
// ping-pong order (3, 4: consumer w waits on 3 + w)
constexpr int kBarConsumer = 1;
constexpr int kBarOrder = 3;

// planes of the query tile: f32 keeps q_hi and q_lo
template <typename T>
constexpr int kPlanes = kIsF32<T> ? 2 : 1;

// bytes of a ring stage: the group's rows chunk, then (kStream) each plane
// of the query tile's chunk
template <typename T, int QT, bool kStream>
__host__ __device__ constexpr int stage_bytes() {
  return kRowStage + (kStream ? kPlanes<T> * QT * kChunk : 0);
}

// a consumer's floats: query norms [QT], warp minima [4][QT], row norms [128]
__host__ __device__ constexpr int consumer_floats(int qt) { return qt + 4 * qt + kWgRows; }

// One wgmma m64nNk16 (16-bit operands from shared memory) or m64nNk8 (TF32
// with A in registers), D in registers: d[4 n + 2 h + e] is row g + 8 h of
// the warp's 16 rows, column 8 n + 2 t + e. scale_d = 0 starts D from zero.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void f16(float (&d)[4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.f16.f16 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void bf16(float (&d)[4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void tf32(float (&d)[4], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void f16(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void bf16(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void tf32(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void f16(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void bf16(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void f16(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void bf16(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// The wgmma of a 16-bit type T
template <typename T, int N>
__device__ __forceinline__ void wgmma16(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    Wgmma<N>::f16(d, a, b, scale_d);
  } else {
    Wgmma<N>::bf16(d, a, b, scale_d);
  }
}

template <int NT>
__device__ __forceinline__ float (&flat(float (&acc)[NT][4]))[4 * NT] {
  return reinterpret_cast<float (&)[4 * NT]>(acc);
}

// Issue the MMAs of one staged 128-byte chunk, its four 32-byte k-steps,
// into acc (each m64 half of the consumer's group against the QT queries)
// and commit them as one group. fresh: start acc from zero.
template <typename T, int NT>
__device__ __forceinline__ void chunk_mmas(float (&acc)[2][NT][4], const unsigned char* rows,
                                           const unsigned char* qchunk, bool fresh, int w, int g,
                                           int t) {
  constexpr int QT = 8 * NT;
  fence_acc(acc);
  if constexpr (kIsF32<T>) {
    const uint64_t qhi = sw128_desc(qchunk);
    const uint64_t qlo = sw128_desc(qchunk + QT * kChunk);
#pragma unroll
    for (int ks = 0; ks < kChunk / 32; ++ks) {
      // A from registers: row g (+8) of the warp's 16 rows of each half,
      // columns 8 ks + t (+4), at 16-byte unit 2 ks (+1) swizzled by row % 8
      // (= g)
      uint32_t hi[2][4], lo[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const unsigned char* r0 = rows + (m * 64 + 16 * w + g) * kChunk + 4 * t;
        const unsigned char* r1 = r0 + 8 * kChunk;
        const int u0 = ((2 * ks) ^ g) << 4;
        const int u1 = ((2 * ks + 1) ^ g) << 4;
        const float x[4] = {*reinterpret_cast<const float*>(r0 + u0),
                            *reinterpret_cast<const float*>(r1 + u0),
                            *reinterpret_cast<const float*>(r0 + u1),
                            *reinterpret_cast<const float*>(r1 + u1)};
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(x[e], hi[m][e], lo[m][e]);
      }
      wgmma_fence();
      // small terms first, as the mma.sync body
      const int first = fresh && ks == 0 ? 0 : 1;
#pragma unroll
      for (int m = 0; m < 2; ++m) Wgmma<QT>::tf32(flat(acc[m]), lo[m], qhi + 2 * ks, first);
#pragma unroll
      for (int m = 0; m < 2; ++m) Wgmma<QT>::tf32(flat(acc[m]), hi[m], qlo + 2 * ks, 1);
#pragma unroll
      for (int m = 0; m < 2; ++m) Wgmma<QT>::tf32(flat(acc[m]), hi[m], qhi + 2 * ks, 1);
    }
  } else {
    const uint64_t a = sw128_desc(rows);
    const uint64_t b = sw128_desc(qchunk);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kChunk / 32; ++ks)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        // the second m64 half starts 64 rows (8,192 bytes) on
        wgmma16<T, QT>(flat(acc[m]), a + m * (64 * kChunk >> 4) + 2 * ks, b + 2 * ks,
                       fresh && ks == 0 ? 0 : 1);
      }
  }
  wgmma_commit();
}

// The squared norm of a query row of row_bytes bytes (a multiple of 16) in
// global memory, summed as the rows' are from their staged chunks: an fmaf
// chain in column order, chunk by chunk with one rounded add a chunk where
// kPromote.
template <typename T, bool kPromote>
__device__ float query_norm(const T* q, int row_bytes) {
  const unsigned char* row = reinterpret_cast<const unsigned char*>(q);
  float s = 0.0f;
  for (int c0 = 0; c0 < row_bytes; c0 += kChunk) {
    float part = kPromote ? 0.0f : s;
    for (int v = c0; v < min(row_bytes, c0 + kChunk); v += 16) {
      part = unit_sq<T>(*reinterpret_cast<const float4*>(row + v), part);
    }
    s = kPromote ? __fadd_rn(s, part) : part;
  }
  return s;
}

// T: float, __half or __nv_bfloat16. NT: 8-query column tiles (QT = 8 NT,
// wgmma's N). kStream: the query tile rides in each ring stage beside the
// rows instead of resident in shared memory. rows_map: the base [N, d] as
// a 3-D map {d, N, 1}, boxes of 128 bytes x 128 rows; q_map: the query
// planes {d, B, planes} (f32: tf32_planes' [2, B, d]; 16-bit: the queries),
// boxes of 128 bytes x QT rows x 1. stages: ring stages a consumer (2-4).
template <typename T, int NT, bool kStream>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_minima_kernel(const __grid_constant__ CUtensorMap rows_map,
                    const __grid_constant__ CUtensorMap q_map, const T* __restrict__ queries,
                    const T* __restrict__ base, const uint8_t* __restrict__ mask,
                    float* __restrict__ out, int B, int N, int d, int valid, int metric, int nqt,
                    int stages, int pingpong) {
  constexpr int QT = 8 * NT;
  constexpr int kQBlock = QT * kChunk;  // one plane of one chunk of the query tile
  constexpr int kSB = stage_bytes<T, QT, kStream>();
  constexpr int kPer = kChunk / static_cast<int>(sizeof(T));  // columns a chunk
  // the mma.sync body's rule (block_minima_mma.cu): the tensor cores sum
  // f32 with truncation, so narrow tiles, which serve wide rows, and every
  // streamed tile add each chunk's products to running totals
  constexpr bool kPromote = kStream || NT <= 2 || (!kIsF32<T> && NT <= 4);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // TMA's 128-byte swizzle needs 1,024-byte aligned destinations
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int row_bytes = d * static_cast<int>(sizeof(T));
  const int nchunks = (row_bytes + kChunk - 1) / kChunk;
  unsigned char* ring = smem;  // [2 consumers][stages][kSB]
  unsigned char* qtile = ring + 2 * stages * kSB;  // [nchunks][planes][kQBlock] (not kStream)
  float* floats = reinterpret_cast<float*>(qtile + (kStream ? 0 : nchunks * kPlanes<T> * kQBlock));
  uint64_t* bars = reinterpret_cast<uint64_t*>(floats + 2 * consumer_floats(QT));
  // full[2][kMaxStages], empty[2][kMaxStages], the resident tile's
  auto full = [&](int w, int s) { return smem_addr(bars + w * kMaxStages + s); };
  auto empty = [&](int w, int s) { return smem_addr(bars + (2 + w) * kMaxStages + s); };
  const uint32_t qbar = smem_addr(bars + 4 * kMaxStages);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qt = blockIdx.x % nqt;
  const int slot = blockIdx.x / nqt;
  const int nslots = gridDim.x / nqt;
  const int q0 = qt * QT;
  const int groups = (N + kGroup - 1) / kGroup;
  const int ntiles = (N + kTileRows - 1) / kTileRows;
  const int my_tiles = slot < ntiles ? (ntiles - slot + nslots - 1) / nslots : 0;

  if (tid == 0) {
    for (int w = 0; w < 2; ++w)
      for (int s = 0; s < stages; ++s) {
        mbar_init(full(w, s), 1);
        mbar_init(empty(w, s), 4);  // one arrival a consumer warp
      }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- the producer warpgroup: warp 8 feeds consumer 0, warp 9 consumer 1
    regs_dec<kProducerRegs>();
    if (warp < 10 && lane == 0) {
      const int w = warp - 8;
      if (!kStream && w == 0) {
        mbar_expect_tx(qbar, nchunks * kPlanes<T> * kQBlock);
        for (int ch = 0; ch < nchunks; ++ch)
          for (int p = 0; p < kPlanes<T>; ++p)
            tma_load(smem_addr(qtile + (ch * kPlanes<T> + p) * kQBlock), &q_map, qbar, ch * kPer, q0, p);
      }
      for (int i = 0; i < my_tiles * nchunks; ++i) {
        const int s = i % stages;
        mbar_wait(empty(w, s), ((i / stages) & 1) ^ 1);
        mbar_expect_tx(full(w, s), kSB);
        const int tile = slot + (i / nchunks) * nslots;
        const int ch = i % nchunks;
        unsigned char* st = ring + (w * stages + s) * kSB;
        tma_load(smem_addr(st), &rows_map, full(w, s), ch * kPer, tile * kTileRows + w * kWgRows, 0);
        if constexpr (kStream) {
          for (int p = 0; p < kPlanes<T>; ++p)
            tma_load(smem_addr(st + kRowStage + p * kQBlock), &q_map, full(w, s), ch * kPer, q0, p);
        }
      }
    }
  } else {
    // ---- a consumer warpgroup: rows [128 wg, 128 wg + 128) of each tile
    regs_inc<kConsumerRegs>();
    const int wg = warp >> 2;
    const int w = warp & 3;  // warp of the warpgroup: rows 16 w .. of each m64 half
    const int ltid = tid & 127;
    const int g = lane >> 2;
    const int t = lane & 3;
    float* qnorm = floats + wg * consumer_floats(QT);
    float* wmin = qnorm + QT;  // [4][QT]
    float* rowsq = wmin + 4 * QT;  // [128]
    if (ltid < QT) {
      const T* qrow = queries + static_cast<long long>(q0 + ltid) * d;
      qnorm[ltid] = q0 + ltid < B ? query_norm<T, kPromote>(qrow, row_bytes) : 0.0f;
    }
    bar_sync(kBarConsumer + wg, 128);
    if (!kStream) mbar_wait(qbar, 0);
    // the lane's row for the norms, the one warp_minima reads from lane
    // m * 16 + h * 8 + g
    const int lr = lane < 16 ? 16 * w + lane : 64 + 16 * w + lane - 16;
    const float thresh = metric == kL2 ? kNearlyZeroSq : kNearlyZero;
    float acc[2][NT][4];
    float tot[2][NT][4];  // kPromote: the finished chunks' sum
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = tot[m][n][e] = 0.0f;
    if (pingpong && wg == 1 && my_tiles > 0) bar_arrive(kBarOrder, 256);  // consumer 0 goes first
    int i = 0;  // ring step
    for (int it = 0; it < my_tiles; ++it) {
      const int tile = slot + it * nslots;
      if (pingpong) bar_sync(kBarOrder + wg, 256);  // this consumer's turn on the tensor cores
      float bsq = 0.0f;
      for (int ch = 0; ch < nchunks; ++ch, ++i) {
        const int s = i % stages;
        mbar_wait(full(wg, s), (i / stages) & 1);
        const unsigned char* st = ring + (wg * stages + s) * kSB;
        const unsigned char* qchunk = kStream ? st + kRowStage : qtile + ch * kPlanes<T> * kQBlock;
        chunk_mmas<T, NT>(acc, st, qchunk, kPromote || ch == 0, w, g, t);
        // the lane's row norm while the MMAs run (kPromote: this chunk's
        // sum, then one rounded add)
        const float part = chunk_sq<T>(st + lr * kChunk, kPromote ? 0.0f : bsq, lr & 7);
        bsq = kPromote ? __fadd_rn(bsq, part) : part;
        wgmma_wait();
        fence_acc(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(wg, s));
        if constexpr (kPromote) {
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                tot[m][n][e] = ch == 0 ? acc[m][n][e] : __fadd_rn(tot[m][n][e], acc[m][n][e]);
              }
        }
      }
      // the other consumer's turn (consumer 1 owes none after its last tile)
      if (pingpong && !(wg == 1 && it == my_tiles - 1)) bar_arrive(kBarOrder + 1 - wg, 256);

      // ---- epilogue of the group: distances, group minima -----------------
      const long long grow0 = static_cast<long long>(tile) * kTileRows + wg * kWgRows;
      bar_sync(kBarConsumer + wg, 128);  // the last group's minima are read
      rowsq[lr] = bsq;
      const float(&res)[2][NT][4] = kPromote ? tot : acc;
      bool bad;
      if (metric == kDot) {
        bad = warp_minima<kDot, T, NT, 64>(res, bsq, qnorm, wmin, grow0 + 16 * w, valid, mask, q0, B,
                                           thresh, w, lane);
      } else if (metric == kCosine) {
        bad = warp_minima<kCosine, T, NT, 64>(res, bsq, qnorm, wmin, grow0 + 16 * w, valid, mask, q0,
                                              B, thresh, w, lane);
      } else {
        bad = warp_minima<kL2, T, NT, 64>(res, bsq, qnorm, wmin, grow0 + 16 * w, valid, mask, q0, B,
                                          thresh, w, lane);
      }
      if (bar_any(kBarConsumer + wg, bad)) {
        nonfinite_pass<T, kWgRows, 128, 64>(queries, base, mask, qnorm, rowsq, wmin, grow0, QT, q0, B,
                                            d, valid, metric, thresh, ltid);
        bar_sync(kBarConsumer + wg, 128);
      }
      const int group = tile * 2 + wg;
      if (ltid < QT && q0 + ltid < B && group < groups) {
        float mn = wmin[ltid];
#pragma unroll
        for (int v = 1; v < 4; ++v) mn = fminf(mn, wmin[v * QT + ltid]);
        out[static_cast<long long>(q0 + ltid) * groups + group] = mn;
      }
    }
  }
}

// ---- host side -------------------------------------------------------------

template <typename T>
constexpr CUtensorMapDataType kMapType = kIsF32<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// A 3-D map {d, rows, planes} of a contiguous [planes, rows, d] tensor of T
// at ptr (16-byte aligned, d * sizeof(T) a multiple of 16), boxes of 128
// bytes x box_rows x 1 swizzled by 128 bytes, zero past the edges. Returns
// 0, a cudaError_t, or kEncodeFailed + the driver's CUresult.
template <typename T>
int encode_map(CUtensorMap* map, const void* ptr, long long d, long long rows, long long planes,
               int box_rows) {
  return encode_map3(map, kMapType<T>, sizeof(T), ptr, d, rows, planes, kChunk / sizeof(T), box_rows);
}

template <typename T, int NT, bool kStream>
int launch_tile(const void* q, const void* qplanes, const void* base, const uint8_t* mask, float* out,
                int B, int N, int d, int valid, int metric, int pingpong, cudaStream_t stream) {
  constexpr int QT = 8 * NT;
  constexpr int kSB = stage_bytes<T, QT, kStream>();
  const long long row_bytes = static_cast<long long>(d) * sizeof(T);
  const long long nchunks = (row_bytes + kChunk - 1) / kChunk;
  const int nqt = (B + QT - 1) / QT;
  auto kernel = wgmma_minima_kernel<T, NT, kStream>;
  static std::atomic<long long> fit[kMaxDevices];
  int dev = 0, sms = 0, smem_limit = 0, per_sm = 0;
  cudaError_t err = current_device(dev, sms, smem_limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the alignment slack, the resident query tile, the consumers' floats and
  // the barriers; then as many ring stages as fit, up to 4
  const long long fixed = 1024 + (kStream ? 0 : nchunks * kPlanes<T> * QT * kChunk) +
                          2 * consumer_floats(QT) * 4 + (4 * kMaxStages + 1) * 8;
  long long stages = (smem_limit - fixed) / (2LL * kSB);
  if (stages > kMaxStages) stages = kMaxStages;
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = fixed + 2 * stages * kSB;
  err = blocks_per_sm(reinterpret_cast<const void*>(kernel), kThreads, smem, dev, smem_limit, fit, per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap rows_map, q_map;
  int rc = encode_map<T>(&rows_map, base, d, N, 1, kWgRows);
  if (rc == 0) rc = encode_map<T>(&q_map, qplanes, d, B, kPlanes<T>, QT);
  if (rc != 0) return rc;
  // blocks of one slot are adjacent (qt fastest) and walk the same row tiles
  const int ntiles = (N + kTileRows - 1) / kTileRows;
  long long nslots = (static_cast<long long>(sms) * per_sm + nqt - 1) / nqt;
  if (nslots > ntiles) nslots = ntiles;
  if (nslots < 1) nslots = 1;
  if (nslots * nqt > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(nslots * nqt), kThreads, static_cast<int>(smem), stream>>>(
      rows_map, q_map, static_cast<const T*>(q), static_cast<const T*>(base), mask, out, B, N, d,
      valid, metric, nqt, static_cast<int>(stages), pingpong);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* qplanes, const void* base, const uint8_t* mask, float* out,
           int B, int N, int d, int valid, int metric, int query_tile, int stream_queries,
           int pingpong, cudaStream_t stream) {
  if (stream_queries) {
    switch (query_tile) {
      case 8: return launch_tile<T, 1, true>(q, qplanes, base, mask, out, B, N, d, valid, metric, pingpong, stream);
      case 16: return launch_tile<T, 2, true>(q, qplanes, base, mask, out, B, N, d, valid, metric, pingpong, stream);
      case 32: return launch_tile<T, 4, true>(q, qplanes, base, mask, out, B, N, d, valid, metric, pingpong, stream);
      case 64: return launch_tile<T, 8, true>(q, qplanes, base, mask, out, B, N, d, valid, metric, pingpong, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (query_tile) {
    case 8: return launch_tile<T, 1, false>(q, qplanes, base, mask, out, B, N, d, valid, metric, pingpong, stream);
    case 16: return launch_tile<T, 2, false>(q, qplanes, base, mask, out, B, N, d, valid, metric, pingpong, stream);
    case 32: return launch_tile<T, 4, false>(q, qplanes, base, mask, out, B, N, d, valid, metric, pingpong, stream);
    case 64: return launch_tile<T, 8, false>(q, qplanes, base, mask, out, B, N, d, valid, metric, pingpong, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The arguments of svt_block_minima_mma (csrc/block_minima_mma.cu) with the
// query planes after the queries: for float32 ops/block_scan.py:tf32_planes'
// [2, B, d] (q_hi, q_lo), for float16 and bfloat16 the queries again; and
// pingpong (1: the consumers take the tensor cores a row tile at a time in
// turn). Takes the dot-family metrics over float32, float16 and bfloat16
// only, with the base and the planes 16-byte aligned and rows a multiple of
// 16 bytes (what TMA copies), and a query tile whose shared bytes fit the
// device; anything else returns cudaErrorInvalidValue without launching
// (ops/block_scan.py:k1_body routes such scans to the mma.sync body). A TMA
// descriptor the driver refuses returns 10,000 + its CUresult. Launches on
// `stream` and does not synchronise.
extern "C" int svt_block_minima_wgmma(const void* queries, const void* qplanes, const void* base,
                                      const void* mask, void* out, int B, int N, int d, int valid,
                                      int dtype, int metric, int query_tile, int stream_queries,
                                      int pingpong, void* stream) {
  if (B <= 0 || N <= 0 || d <= 0 || valid < 0 || valid > N || metric < kL2 || metric > kDot) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long elem = dtype == kF32 ? 4 : 2;
  if (!tma_ready(base, d * elem) || !tma_ready(qplanes, d * elem) || !tma_ready(queries, d * elem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int qt = query_tile;
  const int sq = stream_queries;
  switch (dtype) {
    case kF32: return launch<float>(queries, qplanes, base, m, o, B, N, d, valid, metric, qt, sq, pingpong, s);
    case kF16: return launch<__half>(queries, qplanes, base, m, o, B, N, d, valid, metric, qt, sq, pingpong, s);
    case kBF16:
      return launch<__nv_bfloat16>(queries, qplanes, base, m, o, B, N, d, valid, metric, qt, sq, pingpong, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
