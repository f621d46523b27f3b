// K1: fused distance + per-128-row block minima, for NVIDIA Hopper (sm_90a):
// the CUDA-core body. The dot-family metrics over float32 rows and u8/i8
// codes run on tensor cores in csrc/block_minima_mma.cu; this body serves L1,
// float16 and bfloat16, and d past the tensor-core body's bounds
// (ops/block_scan.py:k1_body routes).
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
// What bounds it on an H100: at small query batches the scan is
// bandwidth-bound (the f32 1M x 384 matrix is 1.54 GB per pass); at large
// batches it is bound by the CUDA-core FMA rate. The design is the simple,
// right one:
//   - grid x over 128-row groups, grid y over query tiles of QT queries
//     (N stays on x: gridDim.y is capped at 65535);
//   - one thread per row; each step stages a [128 x 64] base tile and a
//     [QT x 64] query tile in shared memory (neighbouring threads load
//     neighbouring columns of a row), then every thread runs QT dot (or L1)
//     chains over its row;
//   - row norms are computed in the kernel, so no norm stream is read;
//   - ||q||^2, ||b||^2 and q.b are each one fmaf chain over the columns in
//     the same order, so a self-match gives exactly 0 before the clamp;
//   - the group minimum is a warp shuffle plus shared memory.
// Later work (ROADMAP queue 2): half floats on tensor cores, L1 with
// vectorised loads.
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

#include <type_traits>

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
__device__ __forceinline__ float abs_add(float acc, float a, float b) {
  return __fadd_rn(acc, fabsf(__fsub_rn(a, b)));
}
__device__ __forceinline__ uint32_t abs_add(uint32_t acc, int32_t a, int32_t b) {
  return acc + static_cast<uint32_t>(abs(a - b));
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

template <typename T, int QT, bool kIsL1>
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
    if (!kIsL1 && tid < QT) {
      for (int c = 0; c < kChunk; ++c) qsq = mac(qsq, qtile[tid][c], qtile[tid][c]);
    }
#pragma unroll 2
    for (int c = 0; c < kChunk; c += 4) {
      const V b0 = tile[tid][c];
      const V b1 = tile[tid][c + 1];
      const V b2 = tile[tid][c + 2];
      const V b3 = tile[tid][c + 3];
      if (!kIsL1) {
        bsq = mac(bsq, b0, b0);
        bsq = mac(bsq, b1, b1);
        bsq = mac(bsq, b2, b2);
        bsq = mac(bsq, b3, b3);
      }
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        const V4 qv = *reinterpret_cast<const V4*>(&qtile[j][c]);
        if (kIsL1) {
          acc[j] = abs_add(acc[j], qv.x, b0);
          acc[j] = abs_add(acc[j], qv.y, b1);
          acc[j] = abs_add(acc[j], qv.z, b2);
          acc[j] = abs_add(acc[j], qv.w, b3);
        } else {
          acc[j] = mac(acc[j], qv.x, b0);
          acc[j] = mac(acc[j], qv.y, b1);
          acc[j] = mac(acc[j], qv.z, b2);
          acc[j] = mac(acc[j], qv.w, b3);
        }
      }
    }
    __syncthreads();
  }

  if (!kIsL1 && tid < QT) qnorm[tid] = qsq;
  __syncthreads();

  // mask is read only below valid (<= N): a row past it is never loaded
  const bool row_ok = row0 + tid < valid && (mask == nullptr || mask[row0 + tid] != 0);
  const float thresh = metric == kL2 ? kNearlyZeroSq : kNearlyZero;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    float dist = kIsL1 ? as_float(acc[j]) : compose(acc[j], qnorm[j], bsq, metric);
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
  const T* qt = static_cast<const T*>(q);
  const T* bt = static_cast<const T*>(base);
  if (metric == kL1) {
    block_minima_kernel<T, QT, true><<<grid, kGroup, 0, stream>>>(qt, bt, mask, out, B, N, d, valid, metric);
  } else {
    block_minima_kernel<T, QT, false><<<grid, kGroup, 0, stream>>>(qt, bt, mask, out, B, N, d, valid, metric);
  }
  return static_cast<int>(cudaGetLastError());
}

// query-tile width by batch: one query needs no tile, small batches a
// narrow one; wide tiles share each staged base tile across 16 queries
template <typename T>
int launch(const void* q, const void* base, const uint8_t* mask, float* out, int B,
           int N, int d, int valid, int metric, cudaStream_t stream) {
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
