// K1: fused distance + per-128-row block minima, for NVIDIA Hopper (sm_90a):
// the CUDA-core body. The dot-family metrics over float32, float16 and
// bfloat16 rows and u8/i8 codes run on tensor cores in
// csrc/block_minima_mma.cu; this body serves L1 for every dtype, the dot
// family over codes past the tensor-core body's int32 bounds, and any scan
// forced onto it (ops/block_scan.py:k1_body routes, _launch_k1 forces).
//
// Replaces the TPU kernel in sqlite_vector_tpu/ops/pallas_scan.py, all three
// of its schedules: _pallas_block_minima (_make_kernel), the manual-DMA
// _pallas_block_minima_manual (_make_manual_kernel) and the stream schedule
// _pallas_block_minima_stream (_make_manual_stream_kernel). One kernel here
// computes what they compute:
//
//   out[b, g] = min over rows r in [128 g, 128 g + 128) of dist(q_b, base_r)
//
// with the distance of _distance_block followed by the epilogue of
// _make_kernel: L2 stays squared; near-zero snap at NEARLY_ZERO^2 for L2 and
// NEARLY_ZERO otherwise; NaN -> +inf; rows >= valid -> +inf; and, when a
// row mask is given, rows whose mask byte is 0 -> +inf (a group with no live
// row reads +inf). The JAX package sends masked scans to its XLA path, whose
// masked rows read +inf before the top-k (ops/scan.py scan_topk); here the
// mask rides in the kernel, so a masked scan on the card is this kernel too.
// The exact top-k finish over these minima runs as torch ops
// (ops/block_scan.py), which masks the same rows again inside the groups it
// selects.
//
// Two kernels:
//   - l1_minima_kernel, L1 (the TPU kernel runs it on its vector unit,
//     pallas_scan.py:_distance_block). What bounds it on an H100: the bytes
//     at B=1 (1.54 GB of f32 rows at 1M x 384), the FP32 pipe at large B
//     (two instructions a pair and column: FADD, then FADD with the |x|
//     modifier; 49 G at B=64, 1M x 384, against ~33.5 T a second). The
//     design keeps the pipe busy and reads the matrix once per 64 queries:
//       - persistent blocks of 8 warps walk 256-row tiles; a warp owns 128
//         rows (4 a lane: lane, +32, +64, +96) against QW queries of the
//         block's QT = 4 QW query tile (8, 16, 32 or 64), so each value
//         read from shared memory feeds QW (row) or 4 (query) |q - b|
//         accumulations, the queries' reads broadcast to the warp;
//       - 128-byte column chunks of the row tile and of the query tile
//         stream through a 3-stage ring of cp.async copies (16-byte where
//         the pointer and row pitch allow), so loads overlap arithmetic;
//         rows are padded to 144 bytes, which keeps the 16-byte row reads
//         conflict-free;
//       - floats widen to f32 in registers and accumulate in f32 in column
//         order (|q - b| rounded once, one rounded add), as the twin does;
//         u8 codes sum |a - b| four at a time with __vsadu4 and i8 codes
//         with __vabsdiffs4 and __dp4a against 0x01010101, exact in uint32;
//       - a warp's 128 rows are one minima group, so its minima leave
//         through warp shuffles with no shared-memory reduction.
//   - block_minima_kernel, the dot family where the tensor-core body does
//     not take the scan (d past its shared budget, or integer d where an
//     int32 partial sum could overflow) and where chip_smoke.py forces it.
//     The simple, right design: grid x over 128-row groups, grid y over
//     query tiles of QT queries (N stays on x: gridDim.y is capped at
//     65535); one thread per row; each step stages a [128 x 64] base tile
//     and a [QT x 64] query tile in shared memory, then every thread runs QT
//     dot chains over its row; row norms are computed in the kernel, so no
//     norm stream is read; ||q||^2, ||b||^2 and q.b are each one fmaf chain
//     over the columns in the same order, so a self-match gives exactly 0
//     before the clamp; the group minimum is a warp shuffle plus shared
//     memory.
//
// Build (plain C interface, bound with ctypes; no --use_fast_math, which
// would change sqrtf, division and the NaN/Inf handling the epilogue needs):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libsvt_kernels.so block_minima.cu

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "sm90_common.cuh"

namespace {

constexpr int kGroup = 128;  // rows per minima group == threads per block
constexpr int kChunk = 64;   // feature columns staged per step
constexpr int kWarps = kGroup / 32;

// The reference's float constants, exactly as float32 sees them:
// NEARLY_ZERO = 8 * FLT_EPSILON = 2^-20, its square 2^-40, and the
// residual-clamp scale 16 * FLT_EPSILON = 2^-19.
constexpr float kNearlyZero = 0x1p-20f;
constexpr float kNearlyZeroSq = 0x1p-40f;
constexpr float kResidScale = 0x1p-19f;

// codes shared with ops/block_scan.py (_METRIC_CODE, _DTYPE_CODE)
enum Metric : int { kL2 = 0, kSquaredL2 = 1, kCosine = 2, kDot = 3, kL1 = 4 };
enum DType : int { kF32 = 0, kF16 = 1, kBF16 = 2, kU8 = 3, kI8 = 4 };

// Storage type -> the value type in shared memory: floats are widened to
// f32 (f32 accumulation for f16/bf16), 8-bit codes to int32.
template <typename T> struct Elem;
template <> struct Elem<float> {
  using V = float;
  __device__ static V load(const float* p) { return *p; }
};
template <> struct Elem<__half> {
  using V = float;
  __device__ static V load(const __half* p) { return __half2float(*p); }
};
template <> struct Elem<__nv_bfloat16> {
  using V = float;
  __device__ static V load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
};
template <> struct Elem<uint8_t> {
  using V = int32_t;
  __device__ static V load(const uint8_t* p) { return static_cast<int32_t>(*p); }
};
template <> struct Elem<int8_t> {
  using V = int32_t;
  __device__ static V load(const int8_t* p) { return static_cast<int32_t>(*p); }
};

// Integer sums accumulate in uint32: the wrap mod 2^32 that the int32
// contract relies on (sqlite_vector_tpu/ops/distance.py, INT_L2_EXACT_MAX_DIM)
// is then defined behaviour; signed overflow would not be.
template <typename V>
using Acc = typename std::conditional<std::is_same<V, float>::value, float, uint32_t>::type;
template <typename V>
using Vec4 = typename std::conditional<std::is_same<V, float>::value, float4, int4>::type;

__device__ __forceinline__ float mac(float acc, float a, float b) { return fmaf(a, b, acc); }
__device__ __forceinline__ uint32_t mac(uint32_t acc, int32_t a, int32_t b) {
  return acc + static_cast<uint32_t>(a) * static_cast<uint32_t>(b);
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(uint32_t v) {
  return static_cast<float>(static_cast<int32_t>(v));
}

// _distance_block's float compositions (the __*_rn intrinsics keep the
// compiler from contracting them into a differently rounded fma).
__device__ __forceinline__ float compose(float dot, float qsq, float bsq, int metric) {
  if (metric == kDot) return -dot;
  if (metric == kL2 || metric == kSquaredL2) {
    const float s = __fadd_rn(qsq, bsq);
    const float d = __fsub_rn(s, __fmul_rn(2.0f, dot));
    const float resid = __fmul_rn(kResidScale, s);
    return (d <= resid && isfinite(resid)) ? 0.0f : d;
  }
  const float denom = __fmul_rn(__fsqrt_rn(qsq), __fsqrt_rn(bsq));
  const float cosv = denom > 0.0f ? __fdiv_rn(dot, denom) : 0.0f;
  float d = __fsub_rn(1.0f, cosv);
  if (isnan(dot) || isnan(denom)) d = NAN;
  if (qsq == 0.0f || bsq == 0.0f) d = 1.0f;  // zero norm wins, applied last
  return d;
}

// ... and its integer compositions (exact int32 with wrap, then float).
__device__ __forceinline__ float compose(uint32_t dot, uint32_t qsq, uint32_t bsq, int metric) {
  if (metric == kDot) return as_float(0u - dot);
  if (metric == kL2 || metric == kSquaredL2) return as_float(qsq + bsq - 2u * dot);
  const float qf = as_float(qsq);
  const float bf = as_float(bsq);
  const float denom = __fmul_rn(__fsqrt_rn(qf), __fsqrt_rn(bf));
  const float cosv = denom > 0.0f ? __fdiv_rn(as_float(dot), denom) : 0.0f;
  return (qf == 0.0f || bf == 0.0f) ? 1.0f : __fsub_rn(1.0f, cosv);
}

template <typename T, int QT>
__global__ void __launch_bounds__(kGroup)
block_minima_kernel(const T* __restrict__ queries, const T* __restrict__ base,
                    const uint8_t* __restrict__ mask, float* __restrict__ out, int B,
                    int N, int d, int valid, int metric) {
  using V = typename Elem<T>::V;
  using A = Acc<V>;
  using V4 = Vec4<V>;

  __shared__ V tile[kGroup][kChunk + 1];  // +1: conflict-free row reads
  __shared__ __align__(16) V qtile[QT][kChunk];
  __shared__ A qnorm[QT];
  __shared__ float warp_min[kWarps][QT];

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kGroup;
  const int q0 = blockIdx.y * QT;

  A acc[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) acc[j] = A(0);
  A bsq = A(0);
  A qsq = A(0);  // thread j < QT: squared norm of query q0 + j

  for (int c0 = 0; c0 < d; c0 += kChunk) {
    // columns >= d and rows >= N stage as zeros, which no metric counts
    for (int i = tid; i < kGroup * kChunk; i += kGroup) {
      const int r = i / kChunk;
      const int c = i % kChunk;
      const long long row = row0 + r;
      const int col = c0 + c;
      tile[r][c] = (row < N && col < d) ? Elem<T>::load(base + row * d + col) : V(0);
    }
    for (int i = tid; i < QT * kChunk; i += kGroup) {
      const int j = i / kChunk;
      const int c = i % kChunk;
      const int col = c0 + c;
      qtile[j][c] = (q0 + j < B && col < d)
                        ? Elem<T>::load(queries + static_cast<long long>(q0 + j) * d + col)
                        : V(0);
    }
    __syncthreads();
    if (tid < QT) {
      for (int c = 0; c < kChunk; ++c) qsq = mac(qsq, qtile[tid][c], qtile[tid][c]);
    }
#pragma unroll 2
    for (int c = 0; c < kChunk; c += 4) {
      const V b0 = tile[tid][c];
      const V b1 = tile[tid][c + 1];
      const V b2 = tile[tid][c + 2];
      const V b3 = tile[tid][c + 3];
      bsq = mac(bsq, b0, b0);
      bsq = mac(bsq, b1, b1);
      bsq = mac(bsq, b2, b2);
      bsq = mac(bsq, b3, b3);
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        const V4 qv = *reinterpret_cast<const V4*>(&qtile[j][c]);
        acc[j] = mac(acc[j], qv.x, b0);
        acc[j] = mac(acc[j], qv.y, b1);
        acc[j] = mac(acc[j], qv.z, b2);
        acc[j] = mac(acc[j], qv.w, b3);
      }
    }
    __syncthreads();
  }

  if (tid < QT) qnorm[tid] = qsq;
  __syncthreads();

  // mask is read only below valid (<= N): a row past it is never loaded
  const bool row_ok = row0 + tid < valid && (mask == nullptr || mask[row0 + tid] != 0);
  const float thresh = metric == kL2 ? kNearlyZeroSq : kNearlyZero;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    float dist = compose(acc[j], qnorm[j], bsq, metric);
    if (fabsf(dist) <= thresh) dist = 0.0f;
    if (isnan(dist) || !row_ok) dist = INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      dist = fminf(dist, __shfl_xor_sync(0xffffffffu, dist, off));
    }
    if (lane == 0) warp_min[warp][j] = dist;
  }
  __syncthreads();
  if (tid < QT && q0 + tid < B) {
    float m = warp_min[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fminf(m, warp_min[w][tid]);
    out[static_cast<long long>(q0 + tid) * gridDim.x + blockIdx.x] = m;
  }
}

template <typename T, int QT>
int launch_tile(const void* q, const void* base, const uint8_t* mask, float* out,
                int B, int N, int d, int valid, int metric, cudaStream_t stream) {
  const dim3 grid((N + kGroup - 1) / kGroup, (B + QT - 1) / QT);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  block_minima_kernel<T, QT><<<grid, kGroup, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(base), mask, out, B, N, d, valid, metric);
  return static_cast<int>(cudaGetLastError());
}

// ---- L1 -------------------------------------------------------------------

namespace l1 {

constexpr int kTileRows = 256;            // rows per block iteration: two groups
constexpr int kWarps = 8;                 // 2 row halves x 4 query groups
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerLane = 4;           // a warp's 128 rows: lane + 32 r
constexpr int kChunk = 128;               // bytes of a row staged per ring step
constexpr int kUnits = kChunk / 16;       // 16-byte reads per chunk
constexpr int kPitch = kChunk + 16;       // padded shared row pitch, bytes
constexpr int kStages = 3;

__host__ __device__ constexpr int stage_bytes(int qt) { return (kTileRows + qt) * kPitch; }

// 16 bytes of T widened to float, in column order
template <typename T>
__device__ __forceinline__ void widen(const uint4& w, float (&v)[16 / sizeof(T)]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      v[i] = __uint_as_float(words[i]);
    } else if constexpr (std::is_same<T, __half>::value) {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&words[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    } else {  // bfloat16: the high half of an f32
      v[2 * i] = __uint_as_float(words[i] << 16);
      v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
}

// sum over 4 packed code pairs of |a - b|, added to acc (exact)
template <typename T>
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b, uint32_t acc) {
  if constexpr (std::is_same<T, uint8_t>::value) {
    return acc + __vsadu4(a, b);
  } else {
    return __dp4a(__vabsdiffs4(a, b), 0x01010101u, acc);
  }
}

// Copy the 128-byte column chunk `ch` of rows [row0, row0 + rows) of a
// row-major matrix (n rows of row_bytes bytes) into a ring stage (row r at
// dst + r * kPitch), zero past the row end and past n. Vec: 16 or 4
// (cp.async of that many bytes, as load_width allows), or 1 (plain loads).
template <int Vec>
__device__ __forceinline__ void stage(unsigned char* dst, const unsigned char* src, long long row0,
                                      int rows, long long n, int row_bytes, int ch, int tid) {
  constexpr int kPer = kChunk / (Vec == 1 ? 4 : Vec);  // copies a row
  const int c0 = ch * kChunk;
  for (int p = tid; p < rows * kPer; p += kThreads) {
    const int r = p / kPer;
    const int c = c0 + (p % kPer) * (Vec == 1 ? 4 : Vec);
    const long long row = row0 + r;
    unsigned char* to = dst + r * kPitch + (c - c0);
    if constexpr (Vec == 1) {
      uint32_t w = 0;
      if (row < n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c + e < row_bytes) w |= static_cast<uint32_t>(src[row * row_bytes + c + e]) << (8 * e);
        }
      }
      *reinterpret_cast<uint32_t*>(to) = w;
    } else {
      const bool in = row < n && c < row_bytes;
      const unsigned char* from = in ? src + row * row_bytes + c : src;
      if constexpr (Vec == 16) {
        cp_async16(smem_addr(to), from, in ? 16 : 0);
      } else {
        cp_async4(smem_addr(to), from, in ? 4 : 0);
      }
    }
  }
}

__device__ __forceinline__ void stage_vec(int vec, unsigned char* dst, const unsigned char* src,
                                          long long row0, int rows, long long n, int row_bytes,
                                          int ch, int tid) {
  if (vec == 16) {
    stage<16>(dst, src, row0, rows, n, row_bytes, ch, tid);
  } else if (vec == 4) {
    stage<4>(dst, src, row0, rows, n, row_bytes, ch, tid);
  } else {
    stage<1>(dst, src, row0, rows, n, row_bytes, ch, tid);
  }
}

// T: float, __half, __nv_bfloat16, uint8_t or int8_t. QW queries a warp
// (the block's query tile is QT = 4 QW).
template <typename T, int QW>
__global__ void __launch_bounds__(kThreads, 1)
l1_minima_kernel(const T* __restrict__ queries, const T* __restrict__ base,
                 const uint8_t* __restrict__ mask, float* __restrict__ out, int B, int N, int d,
                 int valid, int nqt, int qvec, int bvec) {
  constexpr int QT = 4 * QW;
  constexpr bool kFloat = !std::is_integral<T>::value;
  using A = typename std::conditional<kFloat, float, uint32_t>::type;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int half = warp / 4;  // which 128 rows of the tile
  const int qg = warp % 4;    // which QW queries of the query tile
  const int qt = blockIdx.x % nqt;
  const int slot = blockIdx.x / nqt;
  const int nslots = gridDim.x / nqt;
  const int q0 = qt * QT;
  const int groups = (N + kGroup - 1) / kGroup;
  const int ntiles = (N + kTileRows - 1) / kTileRows;
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const int nchunks = (row_bytes + kChunk - 1) / kChunk;
  const int my_tiles = slot < ntiles ? (ntiles - slot + nslots - 1) / nslots : 0;
  const int steps = my_tiles * nchunks;
  const unsigned char* bbytes = reinterpret_cast<const unsigned char*>(base);
  const unsigned char* qbytes = reinterpret_cast<const unsigned char*>(queries);

  auto issue = [&](int s) {
    unsigned char* dst = smem + (s % kStages) * stage_bytes(QT);
    const int tile = slot + (s / nchunks) * nslots;
    stage_vec(bvec, dst, bbytes, static_cast<long long>(tile) * kTileRows, kTileRows, N, row_bytes,
              s % nchunks, tid);
    stage_vec(qvec, dst + kTileRows * kPitch, qbytes, q0, QT, B, row_bytes, s % nchunks, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }

  A acc[kRowsPerLane][QW];
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < steps) issue(s + kStages - 1);
    cp_async_commit();

    const int ch = s % nchunks;
    if (ch == 0) {
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r)
#pragma unroll
        for (int j = 0; j < QW; ++j) acc[r][j] = A(0);
    }
    const unsigned char* st = smem + (s % kStages) * stage_bytes(QT);
    const unsigned char* rows = st + (half * 128 + lane) * kPitch;
    const unsigned char* qrows = st + (kTileRows + qg * QW) * kPitch;

#pragma unroll 2
    for (int u = 0; u < kUnits; ++u) {
      uint4 rw[kRowsPerLane];
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r) {
        rw[r] = *reinterpret_cast<const uint4*>(rows + r * 32 * kPitch + u * 16);
      }
      if constexpr (kFloat) {
        constexpr int kV = 16 / sizeof(T);
        float rv[kRowsPerLane][kV];
#pragma unroll
        for (int r = 0; r < kRowsPerLane; ++r) widen<T>(rw[r], rv[r]);
#pragma unroll
        for (int j = 0; j < QW; ++j) {
          float qv[kV];
          widen<T>(*reinterpret_cast<const uint4*>(qrows + j * kPitch + u * 16), qv);
#pragma unroll
          for (int r = 0; r < kRowsPerLane; ++r)
#pragma unroll
            for (int c = 0; c < kV; ++c) {
              acc[r][j] = __fadd_rn(acc[r][j], fabsf(__fsub_rn(qv[c], rv[r][c])));
            }
        }
      } else {
#pragma unroll
        for (int j = 0; j < QW; ++j) {
          const uint4 qw = *reinterpret_cast<const uint4*>(qrows + j * kPitch + u * 16);
#pragma unroll
          for (int r = 0; r < kRowsPerLane; ++r) {
            uint32_t a = acc[r][j];
            a = sad4<T>(qw.x, rw[r].x, a);
            a = sad4<T>(qw.y, rw[r].y, a);
            a = sad4<T>(qw.z, rw[r].z, a);
            a = sad4<T>(qw.w, rw[r].w, a);
            acc[r][j] = a;
          }
        }
      }
    }
    if (ch != nchunks - 1) continue;

    // ---- epilogue: the warp's 128 rows are one group --------------------
    const int tile = slot + (s / nchunks) * nslots;
    const int group = tile * (kTileRows / kGroup) + half;
    bool row_ok[kRowsPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerLane; ++r) {
      const long long row = static_cast<long long>(group) * kGroup + r * 32 + lane;
      // mask is read only below valid (<= N)
      row_ok[r] = row < valid && (mask == nullptr || mask[row] != 0);
    }
#pragma unroll
    for (int j = 0; j < QW; ++j) {
      float best = INFINITY;
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r) {
        float dist = as_float(acc[r][j]);
        if (fabsf(dist) <= kNearlyZero) dist = 0.0f;
        if (isnan(dist) || !row_ok[r]) dist = INFINITY;
        best = fminf(best, dist);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        best = fminf(best, __shfl_xor_sync(0xffffffffu, best, off));
      }
      const int q = q0 + qg * QW + j;
      if (lane == 0 && q < B && group < groups) out[static_cast<long long>(q) * groups + group] = best;
    }
  }
}

long long shared_bytes(int qt) { return static_cast<long long>(kStages) * stage_bytes(qt); }

template <typename T, int QW>
int launch_tile(const void* q, const void* base, const uint8_t* mask, float* out, int B, int N,
                int d, int valid, cudaStream_t stream) {
  constexpr int QT = 4 * QW;
  const int nqt = (B + QT - 1) / QT;
  auto kernel = l1_minima_kernel<T, QW>;
  static std::atomic<long long> fit[kMaxDevices];
  const long long smem = shared_bytes(QT);
  int dev = 0, sms = 0, smem_limit = 0, per_sm = 0;
  cudaError_t err = current_device(dev, sms, smem_limit);
  if (err == cudaSuccess) {
    err = blocks_per_sm(reinterpret_cast<const void*>(kernel), kThreads, smem, dev, smem_limit, fit,
                        per_sm);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // blocks of one slot are adjacent (qt fastest) and walk the same row tiles
  const int ntiles = (N + kTileRows - 1) / kTileRows;
  long long nslots = (static_cast<long long>(sms) * per_sm + nqt - 1) / nqt;
  if (nslots > ntiles) nslots = ntiles;
  if (nslots < 1) nslots = 1;
  if (nslots * nqt > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long row_bytes = static_cast<long long>(d) * sizeof(T);
  kernel<<<static_cast<unsigned>(nslots * nqt), kThreads, static_cast<int>(smem), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(base), mask, out, B, N, d, valid, nqt,
      load_width(q, row_bytes), load_width(base, row_bytes));
  return static_cast<int>(cudaGetLastError());
}

// the narrowest query tile (8, 16, 32 or 64 queries) that covers B, else 64
// (a larger batch takes several tiles)
template <typename T>
int launch(const void* q, const void* base, const uint8_t* mask, float* out, int B, int N, int d,
           int valid, cudaStream_t stream) {
  if (B <= 8) return launch_tile<T, 2>(q, base, mask, out, B, N, d, valid, stream);
  if (B <= 16) return launch_tile<T, 4>(q, base, mask, out, B, N, d, valid, stream);
  if (B <= 32) return launch_tile<T, 8>(q, base, mask, out, B, N, d, valid, stream);
  return launch_tile<T, 16>(q, base, mask, out, B, N, d, valid, stream);
}

}  // namespace l1

// L1 in l1_minima_kernel; the dot family in block_minima_kernel, whose
// query-tile width goes by batch: one query needs no tile, small batches a
// narrow one; wide tiles share each staged base tile across 16 queries
template <typename T>
int launch(const void* q, const void* base, const uint8_t* mask, float* out, int B,
           int N, int d, int valid, int metric, cudaStream_t stream) {
  if (metric == kL1) return l1::launch<T>(q, base, mask, out, B, N, d, valid, stream);
  if (B == 1) return launch_tile<T, 1>(q, base, mask, out, B, N, d, valid, metric, stream);
  if (B <= 4) return launch_tile<T, 4>(q, base, mask, out, B, N, d, valid, metric, stream);
  return launch_tile<T, 16>(q, base, mask, out, B, N, d, valid, metric, stream);
}

}  // namespace

// queries [B, d] and base [N, d], both row-major and of one dtype; mask
// null (every row live) or N bytes, 0 for a masked row (a torch.bool
// tensor); out float32 [B, ceil(N/128)]. Launches on `stream` and does not
// synchronise. Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int svt_block_minima(const void* queries, const void* base, const void* mask,
                                void* out, int B, int N, int d, int valid, int dtype,
                                int metric, void* stream) {
  if (B <= 0 || N <= 0 || d <= 0 || valid < 0 || valid > N || metric < kL2 ||
      metric > kL1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(queries, base, m, o, B, N, d, valid, metric, s);
    case kF16: return launch<__half>(queries, base, m, o, B, N, d, valid, metric, s);
    case kBF16: return launch<__nv_bfloat16>(queries, base, m, o, B, N, d, valid, metric, s);
    case kU8: return launch<uint8_t>(queries, base, m, o, B, N, d, valid, metric, s);
    case kI8: return launch<int8_t>(queries, base, m, o, B, N, d, valid, metric, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
