// What K1's two tensor-core bodies share, csrc/block_minima_mma.cu (mma.sync)
// and csrc/block_minima_wgmma.cu (wgmma + TMA): the metric and dtype codes,
// the compositions of csrc/block_minima.cu op for op, the TF32 split, the
// norm chains and the epilogue's per-warp minima and non-finite recompute.
// Everything is in an anonymous namespace: each source keeps its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kGroup = 128;  // rows per minima group
constexpr int kChunk = 128;  // bytes of a row staged per ring step

constexpr float kNearlyZero = 0x1p-20f;
constexpr float kNearlyZeroSq = 0x1p-40f;
constexpr float kResidScale = 0x1p-19f;

// codes shared with ops/block_scan.py (_METRIC_CODE, _DTYPE_CODE)
enum Metric : int { kL2 = 0, kSquaredL2 = 1, kCosine = 2, kDot = 3, kL1 = 4 };
enum DType : int { kF32 = 0, kF16 = 1, kBF16 = 2, kU8 = 3, kI8 = 4 };

// float rows (f32 in the 3xTF32 split, f16 and bf16 as they are) accumulate
// in f32; 8-bit codes in int32
template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;
template <typename T>
constexpr bool kIsFloat = !std::is_integral<T>::value;
template <typename T>
using Acc = typename std::conditional<kIsFloat<T>, float, uint32_t>::type;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// the two 16-bit floats of a word, widened, in column order
template <typename T>
__device__ __forceinline__ float2 widen2(uint32_t w) {
  if constexpr (std::is_same<T, __half>::value) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  } else {  // bfloat16: the high half of an f32
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
  }
}

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

// cvt.rna.tf32.f32 for finite x, in two full-rate integer ops (the
// conversion unit runs at a quarter of their rate): add half a TF32 ulp to
// the magnitude's bits, drop the 13 low mantissa bits (ties away from zero).
// ops/block_scan.py:tf32_planes rounds the queries of the wgmma body so.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32, for finite x (a pair whose row or query norm is
// not finite is scored by nonfinite_pass instead)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
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

// The sum of squares of 16 bytes of a row, continued from `part`: an fmaf
// chain in column order over the values widened to f32 for float rows, the
// exact sum for codes.
template <typename T>
__device__ __forceinline__ Acc<T> unit_sq(float4 x, Acc<T> part) {
  if constexpr (kIsF32<T>) {
    part = fmaf(x.x, x.x, part);
    part = fmaf(x.y, x.y, part);
    part = fmaf(x.z, x.z, part);
    part = fmaf(x.w, x.w, part);
  } else if constexpr (kIsFloat<T>) {
    const uint32_t w[4] = {__float_as_uint(x.x), __float_as_uint(x.y), __float_as_uint(x.z),
                           __float_as_uint(x.w)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = widen2<T>(w[i]);
      part = fmaf(f.x, f.x, part);
      part = fmaf(f.y, f.y, part);
    }
  } else {
    part += sq4<T>(__float_as_uint(x.x)) + sq4<T>(__float_as_uint(x.y)) +
            sq4<T>(__float_as_uint(x.z)) + sq4<T>(__float_as_uint(x.w));
  }
  return part;
}

// The sum of squares of one staged 128-byte chunk of a row, continued from
// `part`, its 16-byte units in column order (zeros past d leave it as it
// is). swz: the row's 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B
// stores unit v of row r at v ^ (r % 8)); 0 for an unswizzled row.
template <typename T>
__device__ __forceinline__ Acc<T> chunk_sq(const unsigned char* row, Acc<T> part, int swz = 0) {
  const float4* rp = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int v = 0; v < kChunk / 16; ++v) part = unit_sq<T>(rp[v ^ swz], part);
  return part;
}

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
// its 32 rows to the QT = 8 NT queries from the accumulators, snapped, NaN
// and dead rows -> +inf, and each query's warp minimum into wmin[warp][.].
// The accumulators hold two m16 fragments a warp (acc[m][n][h * 2 + e]:
// row g + 8 h of fragment m, query 8 n + 2 t + e); fragment m's rows start
// at base row row0 + m * MStride (16 in the mma.sync body, whose warp owns
// 32 adjacent rows; 64 in the wgmma body, whose warp owns rows 16 w.. of
// each m64 half of its group), and lane m * 16 + h * 8 + g holds that row's
// norm in bsq. A float pair whose row or query norm is not finite reads
// +inf here; the return value says the warp holds such a live pair, which
// nonfinite_pass then scores.
template <int M, typename T, int NT, int MStride>
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
      rsq[m][h] = __shfl_sync(0xffffffffu, bsq, m * 16 + h * 8 + g);
      const long long row = row0 + m * MStride + h * 8 + g;
      // mask is read only below valid (<= N)
      row_ok[m][h] = row < valid && (mask == nullptr || mask[row] != 0);
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

// The float pairs of Rows rows (base rows row0 ...) whose row or query norm
// is not finite: the dot by the CUDA-core body's fmaf chain (one chain in
// column order over the values widened to f32, which keeps its Inf/NaN
// semantics), composed as there, and folded into wmin at the warp that owns
// the row (warp_minima's MStride). Threads threads share the pairs. Runs
// only when warp_minima flagged such a pair.
template <typename T, int Rows, int Threads, int MStride>
__device__ __noinline__ void nonfinite_pass(const T* queries, const T* base,
                                            const uint8_t* mask, const float* qnorm,
                                            const float* rowsq, float* wmin, long long row0,
                                            int QT, int q0, int B, int d, int valid, int metric,
                                            float thresh, int tid) {
  for (int p = tid; p < Rows * QT; p += Threads) {
    const int r = p / QT;
    const int j = p % QT;
    const long long row = row0 + r;
    if (q0 + j >= B || row >= valid || (mask != nullptr && mask[row] == 0)) continue;
    if (isfinite(rowsq[r]) && isfinite(qnorm[j])) continue;
    const T* qr = queries + static_cast<long long>(q0 + j) * d;
    const T* br = base + row * d;
    float dot = 0.0f;
    for (int c = 0; c < d; ++c) dot = fmaf(to_f32(qr[c]), to_f32(br[c]), dot);
    float dist = compose(dot, qnorm[j], rowsq[r], metric);
    if (fabsf(dist) <= thresh) dist = 0.0f;
    if (isnan(dist)) dist = INFINITY;
    const int owner = MStride == 16 ? r / 32 : (r % 64) / 16;
    smem_fmin(&wmin[owner * QT + j], dist);
  }
}

}  // namespace
