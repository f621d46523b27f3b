// K1 on tensor cores: the dot-family block minima for f32 rows and 8-bit codes,
// for NVIDIA Hopper (sm_90a).
//
// Computes what csrc/block_minima.cu computes (its header states the contract,
// replacing the three TPU schedules of sqlite_vector_tpu/ops/pallas_scan.py):
//
//   out[b, g] = min over rows r in [128 g, 128 g + 128) of dist(q_b, base_r)
//
// for L2 (squared), SQUARED_L2, COSINE and DOT over float32 rows and u8/i8
// codes, with the same snap, NaN -> +inf, rows >= valid -> +inf and optional
// row mask. L1, f16 and bf16 stay on the CUDA-core body of block_minima.cu;
// ops/block_scan.py:k1_body routes between the two.
//
// The products run where the TPU kernel runs them, on the matrix unit:
//   - u8/i8: mma.sync m16n8k32 with .u8/.s8 operands and exact int32
//     accumulation (the TPU's dot_general with preferred_element_type=int32).
//     The router sends codes here only while no partial sum can reach 2^31
//     (d <= 33,025 for u8, 131,071 for i8), so the int32 sums equal the
//     uint32-wrap sums of the CUDA-core body and the epilogue's compose()
//     gives bit-equal minima.
//   - f32: mma.sync m16n8k8 TF32 in the 3xTF32 split (hi = rna(x),
//     lo = rna(x - hi), dot ~ hi.hi' + hi.lo' + lo.hi', f32 accumulation;
//     the rounding is cvt.rna.tf32's, done with integer ops),
//     the analogue of the TPU's multi-pass bf16 product at HIGHEST. Row and
//     query norms stay one fmaf chain each in column order. A row or query
//     whose norm is not finite (Inf, NaN, or overflow) would break the split
//     (Inf - Inf, 0 * Inf), so for such a (row, query) pair the owning thread
//     recomputes the dot with the CUDA-core body's fmaf chain from global
//     memory, which keeps its Inf/NaN semantics (DOT over a +Inf row reads
//     -inf). That pass runs only for a row tile that holds such a pair.
//
// What bounds it on an H100 (1M x 384): f32 is bandwidth-bound at B=1 (1.54 GB)
// and bound by tensor-core issue at B=64 (3 x 49 GFLOP of TF32); 8-bit codes
// are bandwidth-bound (384 MB) at every batch up to 64. The design:
//   - persistent blocks of 8 warps walk 256-row tiles (two 128-row groups);
//     each warp owns 32 rows (two m16 tiles) against every query of its tile;
//   - the block's query tile (up to 64 queries, zero-padded to a multiple of
//     128 bytes a row) is loaded into shared memory once, with its norms, so
//     the matrix is read in one pass for B <= 64; larger batches take
//     several query tiles, whose blocks are adjacent in launch order and
//     walk the same row tiles at once (the base's re-reads are L2 hits);
//   - base tiles of 256 rows x 128 bytes stream through a 3-stage ring of
//     cp.async copies (16-byte when the row pitch and pointer allow, 4-byte
//     or plain byte loads otherwise, zero-filled past d and N), so the loads
//     of the next chunk or row tile overlap the MMAs of the current one;
//   - shared rows are padded to 144 bytes: fragment loads, 16-byte row reads
//     and cp.async stores are conflict-free;
//   - f32 tiles of 8 and 16 queries add each 128-byte chunk's products to
//     a running total with one rounded add (the tensor cores' truncating
//     accumulation over all of a wide row drifts past the tolerance);
//   - row norms come from the staged tile (one lane a row), the group
//     minimum from warp shuffles and shared memory;
//   - the row tile's epilogue runs while no MMA does (every warp reaches it
//     in the same ring step), so it is kept small: one unrolled copy per
//     composition (a copy holding all four, with the non-finite recompute
//     inline, took 1.7 of 2.6 ms at f32 B=64, 1M x 384, on an H100), a lean
//     path when the warp's rows and the tile's queries are all finite, and
//     for integer L2 and DOT the minimum taken over the exact int32 values.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 (as
// ops/_build.py does; no --use_fast_math).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "sm90_common.cuh"

namespace {

constexpr int kGroup = 128;          // rows per minima group
constexpr int kTileRows = 256;       // rows per block iteration: two groups
constexpr int kWarps = kTileRows / 32;  // 32 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSM = 1;
constexpr int kChunk = 128;          // bytes of a row staged per ring step
constexpr int kPitch = kChunk + 16;  // padded shared row pitch, bytes
constexpr int kStages = 3;
constexpr int kStageBytes = kTileRows * kPitch;

constexpr float kNearlyZero = 0x1p-20f;
constexpr float kNearlyZeroSq = 0x1p-40f;
constexpr float kResidScale = 0x1p-19f;

// codes shared with ops/block_scan.py (_METRIC_CODE, _DTYPE_CODE)
enum Metric : int { kL2 = 0, kSquaredL2 = 1, kCosine = 2, kDot = 3, kL1 = 4 };
enum DType : int { kF32 = 0, kF16 = 1, kBF16 = 2, kU8 = 3, kI8 = 4 };

template <typename T>
constexpr bool kIsFloat = std::is_same<T, float>::value;
template <typename T>
using Acc = typename std::conditional<kIsFloat<T>, float, uint32_t>::type;

__device__ __forceinline__ float as_float(uint32_t v) {
  return static_cast<float>(static_cast<int32_t>(v));
}

// the compositions of block_minima.cu, op for op
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
  if (qsq == 0.0f || bsq == 0.0f) d = 1.0f;
  return d;
}

__device__ __forceinline__ float compose(uint32_t dot, uint32_t qsq, uint32_t bsq, int metric) {
  if (metric == kDot) return as_float(0u - dot);
  if (metric == kL2 || metric == kSquaredL2) return as_float(qsq + bsq - 2u * dot);
  const float qf = as_float(qsq);
  const float bf = as_float(bsq);
  const float denom = __fmul_rn(__fsqrt_rn(qf), __fsqrt_rn(bf));
  const float cosv = denom > 0.0f ? __fdiv_rn(as_float(dot), denom) : 0.0f;
  return (qf == 0.0f || bf == 0.0f) ? 1.0f : __fsub_rn(1.0f, cosv);
}

// ---- PTX wrappers (cp.async ones in sm90_common.cuh) ---------------------

// cvt.rna.tf32.f32 for finite x, in two full-rate integer ops (the
// conversion unit runs at a quarter of their rate): add half a TF32 ulp to
// the magnitude's bits, drop the 13 low mantissa bits (ties away from zero)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32, for finite x (a pair whose row or query norm is
// not finite is scored by nonfinite_pass instead)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ void mma_i8(uint32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  if constexpr (std::is_same<T, uint8_t>::value) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// squared norm of 4 packed codes (exact)
template <typename T>
__device__ __forceinline__ uint32_t sq4(uint32_t w) {
  if constexpr (std::is_same<T, uint8_t>::value) {
    return __dp4a(w, w, 0u);
  } else {
    return static_cast<uint32_t>(__dp4a(static_cast<int>(w), static_cast<int>(w), 0));
  }
}

// ---- the kernel ------------------------------------------------------------

// An ordered float minimum on shared memory (v is never NaN).
__device__ __forceinline__ void smem_fmin(float* p, float v) {
  int* ip = reinterpret_cast<int*>(p);
  int old = *ip;
  while (v < __int_as_float(old)) {
    const int prev = atomicCAS(ip, old, __float_as_int(v));
    if (prev == old) break;
    old = prev;
  }
}

// The warp's part of a row tile's epilogue under composition M: distances of
// its 32 rows (base rows row0 ...) to the QT queries from the accumulators,
// snapped, NaN and dead rows -> +inf, and each query's warp minimum into
// wmin[warp][.]. A float pair whose row or query norm is not finite reads
// +inf here; the return value says the warp holds such a live pair, which
// nonfinite_pass then scores.
template <int M, typename T, int NT>
__device__ __forceinline__ bool warp_minima(const Acc<T> (&acc)[2][NT][4], Acc<T> bsq,
                                            const Acc<T>* qnorm, float* wmin, long long row0,
                                            int valid, const uint8_t* mask, int q0, int B,
                                            float thresh, int warp, int lane) {
  constexpr int QT = 8 * NT;
  const int g = lane >> 2;
  const int t = lane & 3;
  Acc<T> rsq[2][2];
  bool row_ok[2][2], row_fin[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m * 16 + h * 8 + g;
      rsq[m][h] = __shfl_sync(0xffffffffu, bsq, r);
      // mask is read only below valid (<= N)
      row_ok[m][h] = row0 + r < valid && (mask == nullptr || mask[row0 + r] != 0);
      if constexpr (kIsFloat<T>) {
        row_fin[m][h] = isfinite(rsq[m][h]);
      } else {
        row_fin[m][h] = true;
      }
    }
  if constexpr (!kIsFloat<T> && M != kCosine) {
    // integer L2 and DOT: exact int32 values, never NaN, and never within
    // the snap of 0 unless 0, so the minimum over the ints, converted once
    // (int -> float is monotone), equals the minimum of the converted
    // values bit for bit. INT_MAX marks no live row: under the router's d
    // bound no value reaches it.
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = n * 8 + 2 * t + e;
        const uint32_t qsq = qnorm[j];
        int best = INT_MAX;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t dot = acc[m][n][h * 2 + e];
            const int v = static_cast<int>(M == kDot ? 0u - dot : qsq + rsq[m][h] - 2u * dot);
            if (row_ok[m][h]) best = min(best, v);
          }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          best = min(best, __shfl_xor_sync(0xffffffffu, best, off));
        }
        if (g == 0) wmin[warp * QT + j] = best == INT_MAX ? INFINITY : static_cast<float>(best);
      }
    }
    return false;
  }
  // the common case, every row of the warp and every query of the tile
  // finite, skips the non-finite tests (a padded query is a zero row,
  // finite, and its minima are never read)
  bool clean = true;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) clean = clean && row_fin[m][h];
  if constexpr (kIsFloat<T>) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) clean = clean && isfinite(qnorm[n * 8 + 2 * t + e]);
  }
  clean = __all_sync(0xffffffffu, clean);
  bool bad = false;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = n * 8 + 2 * t + e;  // query of the tile
      const Acc<T> qsq = qnorm[j];
      bool q_fin = true;
      if constexpr (kIsFloat<T>) q_fin = isfinite(qsq);
      float best = INFINITY;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float dist = compose(acc[m][n][h * 2 + e], qsq, rsq[m][h], M);
          if (fabsf(dist) <= thresh) dist = 0.0f;
          if (clean) {
            if (isnan(dist) || !row_ok[m][h]) dist = INFINITY;
          } else {
            const bool fin = row_fin[m][h] && q_fin;
            if (isnan(dist) || !row_ok[m][h] || !fin) dist = INFINITY;
            bad |= row_ok[m][h] && !fin && q0 + j < B;
          }
          best = fminf(best, dist);
        }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        best = fminf(best, __shfl_xor_sync(0xffffffffu, best, off));
      }
      if (g == 0) wmin[warp * QT + j] = best;
    }
  }
  return bad;
}

// The float pairs of a row tile whose row or query norm is not finite: the
// dot by the CUDA-core body's fmaf chain (one chain in column order, which
// keeps its Inf/NaN semantics), composed as there, and folded into wmin.
// Runs only when warp_minima flagged such a pair.
__device__ __noinline__ void nonfinite_pass(const float* queries, const float* base,
                                            const uint8_t* mask, const float* qnorm,
                                            const float* rowsq, float* wmin, long long row0,
                                            int QT, int q0, int B, int d, int valid, int metric,
                                            float thresh, int tid) {
  for (int p = tid; p < kTileRows * QT; p += kThreads) {
    const int r = p / QT;
    const int j = p % QT;
    const long long row = row0 + r;
    if (q0 + j >= B || row >= valid || (mask != nullptr && mask[row] == 0)) continue;
    if (isfinite(rowsq[r]) && isfinite(qnorm[j])) continue;
    const float* qr = queries + static_cast<long long>(q0 + j) * d;
    const float* br = base + row * d;
    float dot = 0.0f;
    for (int c = 0; c < d; ++c) dot = fmaf(qr[c], br[c], dot);
    float dist = compose(dot, qnorm[j], rowsq[r], metric);
    if (fabsf(dist) <= thresh) dist = 0.0f;
    if (isnan(dist)) dist = INFINITY;
    smem_fmin(&wmin[(r / 32) * QT + j], dist);
  }
}

// T: float, uint8_t or int8_t. NT: 8-query column tiles per block (QT = 8 NT).
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
mma_minima_kernel(const T* __restrict__ queries, const T* __restrict__ base,
                  const uint8_t* __restrict__ mask, float* __restrict__ out, int B, int N, int d,
                  int valid, int metric, int nqt, int vec) {
  constexpr int QT = 8 * NT;
  using A = Acc<T>;
  // The tensor cores accumulate f32 with truncation, so the error of a dot
  // grows with the MMAs summed into one accumulator: at d = 3,424 a
  // self-match's L2 minimum sat 0.22 off the twin (on an H100). f32 tiles
  // of 8 and 16 queries (every d past 832 takes one) therefore start each
  // chunk's MMAs from zero and add them to a running total in one rounded
  // add; 32- and 64-query tiles hold d <= 832 and have no registers to spare.
  constexpr bool kPromote = kIsFloat<T> && NT <= 2;
  extern __shared__ __align__(16) unsigned char smem[];

  const int row_bytes = d * static_cast<int>(sizeof(T));
  const int nchunks = (row_bytes + kChunk - 1) / kChunk;
  const int qpitch = nchunks * kChunk + 16;  // bytes
  unsigned char* ring = smem;
  unsigned char* qs = ring + kStages * kStageBytes;
  A* qnorm = reinterpret_cast<A*>(qs + QT * qpitch);
  float* wmin = reinterpret_cast<float*>(qnorm + QT);  // [kWarps][QT]
  A* rowsq = reinterpret_cast<A*>(wmin + kWarps * QT);  // [kTileRows] row norms

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row / column group
  const int t = lane & 3;   // thread in group
  const int qt = blockIdx.x % nqt;
  const int slot = blockIdx.x / nqt;
  const int nslots = gridDim.x / nqt;
  const int q0 = qt * QT;
  const int groups = (N + kGroup - 1) / kGroup;
  const int ntiles = (N + kTileRows - 1) / kTileRows;

  // the query tile, once: zero past d and past B
  for (int i = tid; i < QT * nchunks * kChunk / static_cast<int>(sizeof(T)); i += kThreads) {
    const int per_row = nchunks * kChunk / static_cast<int>(sizeof(T));
    const int j = i / per_row;
    const int c = i % per_row;
    T v = T(0);
    if (q0 + j < B && c < d) v = queries[static_cast<long long>(q0 + j) * d + c];
    reinterpret_cast<T*>(qs + j * qpitch)[c] = v;
  }
  __syncthreads();
  if (tid < QT) {
    A s = A(0);
    if constexpr (kIsFloat<T>) {
      const float* qrow = reinterpret_cast<const float*>(qs + tid * qpitch);
      for (int c = 0; c < d; ++c) s = fmaf(qrow[c], qrow[c], s);
    } else {
      const uint32_t* qrow = reinterpret_cast<const uint32_t*>(qs + tid * qpitch);
      for (int w = 0; w < nchunks * kChunk / 4; ++w) s += sq4<T>(qrow[w]);
    }
    qnorm[tid] = s;
  }
  // (qnorm is read after the ring loop's first __syncthreads)

  const int my_tiles = slot < ntiles ? (ntiles - slot + nslots - 1) / nslots : 0;
  const int steps = my_tiles * nchunks;
  const unsigned char* bbytes = reinterpret_cast<const unsigned char*>(base);
  auto issue = [&](int s) {
    const int tile = slot + (s / nchunks) * nslots;
    stage_chunk<kTileRows, kThreads>(ring + (s % kStages) * kStageBytes, bbytes,
                                     static_cast<long long>(tile) * kTileRows, N, row_bytes,
                                     s % nchunks, kChunk, kPitch, vec, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }

  A acc[2][NT][4];
  A tot[2][NT][4];  // kPromote: the finished chunks' sum
  A bsq = A(0);  // lane's row: warp * 32 + lane of the tile
  const float thresh = metric == kL2 ? kNearlyZeroSq : kNearlyZero;

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < steps) issue(s + kStages - 1);
    cp_async_commit();

    const int ch = s % nchunks;
    if (ch == 0 || kPromote) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (kPromote && ch == 0) tot[m][n][e] = A(0);
            acc[m][n][e] = A(0);
          }
    }
    if (ch == 0) bsq = A(0);
    const unsigned char* stage = ring + (s % kStages) * kStageBytes;
    const unsigned char* wrows = stage + warp * 32 * kPitch;
    const unsigned char* qchunk = qs + ch * kChunk;

    // the lane's row norm, in column order
    {
      const float4* rp = reinterpret_cast<const float4*>(wrows + lane * kPitch);
#pragma unroll
      for (int v = 0; v < kChunk / 16; ++v) {
        const float4 x = rp[v];
        if constexpr (kIsFloat<T>) {
          bsq = fmaf(x.x, x.x, bsq);
          bsq = fmaf(x.y, x.y, bsq);
          bsq = fmaf(x.z, x.z, bsq);
          bsq = fmaf(x.w, x.w, bsq);
        } else {
          bsq += sq4<T>(__float_as_uint(x.x)) + sq4<T>(__float_as_uint(x.y)) +
                 sq4<T>(__float_as_uint(x.z)) + sq4<T>(__float_as_uint(x.w));
        }
      }
    }

    // k-steps of 32 bytes: 8 TF32 columns, or 32 codes
#pragma unroll
    for (int ks = 0; ks < kChunk / 32; ++ks) {
      const int w0 = ks * 8 + t;  // 32-bit word of the row within the chunk
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint32_t* r0 = reinterpret_cast<const uint32_t*>(wrows + (m * 16 + g) * kPitch);
        const uint32_t* r1 = reinterpret_cast<const uint32_t*>(wrows + (m * 16 + g + 8) * kPitch);
        a[m][0] = r0[w0];
        a[m][1] = r1[w0];
        a[m][2] = r0[w0 + 4];
        a[m][3] = r1[w0 + 4];
      }
      if constexpr (kIsFloat<T>) {
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(a[m][e]), ahi[m][e], alo[m][e]);
        uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint32_t* qr = reinterpret_cast<const uint32_t*>(qchunk + (n * 8 + g) * qpitch);
          split_tf32(__uint_as_float(qr[w0]), bhi[n][0], blo[n][0]);
          split_tf32(__uint_as_float(qr[w0 + 4]), bhi[n][1], blo[n][1]);
        }
        // the three products in three passes over the 2 x NT accumulators, so
        // no MMA waits on the one before it; small terms first
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], alo[m], bhi[n][0], bhi[n][1]);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], ahi[m], blo[n][0], blo[n][1]);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], ahi[m], bhi[n][0], bhi[n][1]);
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint32_t* qr = reinterpret_cast<const uint32_t*>(qchunk + (n * 8 + g) * qpitch);
          const uint32_t b0 = qr[w0];
          const uint32_t b1 = qr[w0 + 4];
#pragma unroll
          for (int m = 0; m < 2; ++m) mma_i8<T>(acc[m][n], a[m], b0, b1);
        }
      }
    }

    if constexpr (kPromote) {
      // the total into acc at the last chunk, where the epilogue reads it
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (ch != nchunks - 1) {
              tot[m][n][e] = __fadd_rn(tot[m][n][e], acc[m][n][e]);
            } else {
              acc[m][n][e] = __fadd_rn(tot[m][n][e], acc[m][n][e]);
            }
          }
    }
    if (ch != nchunks - 1) continue;

    // ---- epilogue of the row tile: distances, group minima ----------------
    // one specialised copy of the unrolled epilogue per composition, so the
    // loop holds only the one it runs (L2 and SQUARED_L2 compose alike)
    const int tile = slot + (s / nchunks) * nslots;
    const long long row0 = static_cast<long long>(tile) * kTileRows;
    if constexpr (kIsFloat<T>) rowsq[tid] = bsq;
    bool bad;
    if (metric == kDot) {
      bad = warp_minima<kDot, T, NT>(acc, bsq, qnorm, wmin, row0 + warp * 32, valid, mask, q0, B,
                                     thresh, warp, lane);
    } else if (metric == kCosine) {
      bad = warp_minima<kCosine, T, NT>(acc, bsq, qnorm, wmin, row0 + warp * 32, valid, mask, q0,
                                        B, thresh, warp, lane);
    } else {
      bad = warp_minima<kL2, T, NT>(acc, bsq, qnorm, wmin, row0 + warp * 32, valid, mask, q0, B,
                                    thresh, warp, lane);
    }
    if (__syncthreads_or(bad)) {
      if constexpr (kIsFloat<T>) {
        nonfinite_pass(queries, base, mask, qnorm, rowsq, wmin, row0, QT, q0, B, d, valid,
                       metric, thresh, tid);
      }
      __syncthreads();
    }
    constexpr int kGroupWarps = kGroup / 32;
    if (tid < kTileRows / kGroup * QT) {
      const int half = tid / QT;
      const int j = tid % QT;
      const int group = tile * (kTileRows / kGroup) + half;
      if (q0 + j < B && group < groups) {
        float mn = wmin[(half * kGroupWarps) * QT + j];
#pragma unroll
        for (int w = 1; w < kGroupWarps; ++w) mn = fminf(mn, wmin[(half * kGroupWarps + w) * QT + j]);
        out[static_cast<long long>(q0 + j) * groups + group] = mn;
      }
    }
  }
}

long long shared_bytes(int qt, long long qpitch) {
  return kStages * kStageBytes + qt * qpitch + qt * 4 + kWarps * qt * 4 + kTileRows * 4;
}

template <typename T, int NT>
int launch_tile(const void* q, const void* base, const uint8_t* mask, float* out, int B, int N,
                int d, int valid, int metric, cudaStream_t stream) {
  constexpr int QT = 8 * NT;
  const long long row_bytes = static_cast<long long>(d) * sizeof(T);
  const long long qpitch = (row_bytes + kChunk - 1) / kChunk * kChunk + 16;
  const int nqt = (B + QT - 1) / QT;
  auto kernel = mma_minima_kernel<T, NT>;
  static std::atomic<long long> fit[kMaxDevices];
  const long long smem = shared_bytes(QT, qpitch);
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
  const int vec = load_width(base, row_bytes);
  kernel<<<static_cast<unsigned>(nslots * nqt), kThreads, static_cast<int>(smem), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(base), mask, out, B, N, d, valid, metric,
      nqt, vec);
  return static_cast<int>(cudaGetLastError());
}

// query_tile queries per block (8, 16, 32 or 64; ops/block_scan.py:
// mma_query_tile picks it); B past one tile takes several tiles
template <typename T>
int launch(const void* q, const void* base, const uint8_t* mask, float* out, int B, int N, int d,
           int valid, int metric, int query_tile, cudaStream_t stream) {
  switch (query_tile) {
    case 8: return launch_tile<T, 1>(q, base, mask, out, B, N, d, valid, metric, stream);
    case 16: return launch_tile<T, 2>(q, base, mask, out, B, N, d, valid, metric, stream);
    case 32: return launch_tile<T, 4>(q, base, mask, out, B, N, d, valid, metric, stream);
    case 64: return launch_tile<T, 8>(q, base, mask, out, B, N, d, valid, metric, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The arguments of svt_block_minima (csrc/block_minima.cu), and query_tile.
// Takes the dot-family metrics over float32, uint8 and int8 only, u8/i8 only
// while no int32 partial sum can reach 2^31, and a query tile whose shared
// bytes fit the device; anything else returns cudaErrorInvalidValue without
// launching (ops/block_scan.py:k1_body routes such scans to
// svt_block_minima). Launches on `stream` and does not synchronise.
extern "C" int svt_block_minima_mma(const void* queries, const void* base, const void* mask,
                                    void* out, int B, int N, int d, int valid, int dtype,
                                    int metric, int query_tile, void* stream) {
  if (B <= 0 || N <= 0 || d <= 0 || valid < 0 || valid > N || metric < kL2 || metric > kDot) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(queries, base, m, o, B, N, d, valid, metric, query_tile, s);
    case kU8:
      if (d > 33025) return static_cast<int>(cudaErrorInvalidValue);
      return launch<uint8_t>(queries, base, m, o, B, N, d, valid, metric, query_tile, s);
    case kI8:
      if (d > 131071) return static_cast<int>(cudaErrorInvalidValue);
      return launch<int8_t>(queries, base, m, o, B, N, d, valid, metric, query_tile, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
