// K2, packed-int4 surrogate block minima for NVIDIA Hopper (sm_90a): its
// contract, and what its two bodies share.
//
// The contract, that of the TPU kernel it replaces
// (sqlite_vector_tpu/ops/pallas_int4.py, both schedules):
//
//   out[b, g] = min over rows r in [128 g, 128 g + 128) of S(q_b, r)
//
// with S the monotone surrogate of _surrogate_block over the exact integer
// dot of the int8 query codes with the row's int4 codes:
//   L2, SQUARED_L2  alpha^2 csq - 2 (qscale alpha) dot
//   DOT             -(qscale alpha) dot
//   COSINE          -dot / sqrt(max(csq, 1))  (0 where csq == 0)
// in _surrogate_block's operation order (__fmul_rn/__fsub_rn, no fma
// contraction; a correctly rounded 1/sqrt), and rows >= valid, rows whose
// mask byte is 0 and NaN surrogates at +inf. The mask rides in the kernel
// (the JAX package sends masked scans to its XLA tile loop); the finish
// (ops/int4_scan.py) masks the same rows inside the groups it selects.
// ops/int4_scan.py:int4_block_minima_reference is the plain twin that
// defines the output; both bodies equal it bit for bit.
//
// Packed layout (ops/quantize4.py): row i is h = ceil(d/2) bytes; byte j
// holds code j in its low nibble and code h + j in its high nibble (odd d:
// the last high nibble is the pad code 0), each as nibble = code + 8.
//
// The bodies, csrc/int4_minima_wgmma.cu (wgmma + TMA) and
// csrc/int4_minima_mma.cu (mma.sync), share what is here: the metric codes,
// the query plane words, the magic int -> float conversion and the
// epilogue's per-warp surrogate minima. Both hold the dots in the m16n8
// accumulator layout (a wgmma m64nN accumulator gives warp w of its
// warpgroup rows 16 w + g and 16 w + g + 8 of each 8-column slice, laid out
// as mma.sync's C fragment), so one epilogue serves both. Everything is in
// an anonymous namespace: each source keeps its own copy.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;  // rows per minima group

// codes shared with ops/block_scan.py (_METRIC_CODE); L1 has no surrogate
enum Metric : int { kL2 = 0, kSquaredL2 = 1, kCosine = 2, kDot = 3 };

// Bytes p[c], ..., p[c + 3] of a query plane (byte b in bits 8b), 0 at and
// past `limit`.
__device__ __forceinline__ uint32_t plane_word(const int8_t* p, int c, int limit) {
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (c + b < limit) w |= static_cast<uint32_t>(static_cast<uint8_t>(p[c + b])) << (8 * b);
  }
  return w;
}

// 1.5 * 2^23 as a float's bits: these bits plus an int x in [-2^22, 2^22]
// are the float 1.5 * 2^23 + x exactly, so subtracting 1.5 * 2^23 gives
// float(x) in one full-rate operation (int -> float conversion runs at a
// fraction of that rate). Accumulators of tiles with kSmallDot start at
// kMagicBits - 8 sum(qc), so the MMAs leave kMagicBits + dot in them.
constexpr int kMagicBits = 0x4B400000;
constexpr float kMagic = 12582912.0f;

// The row of a warp's accumulators whose per-row inputs lane `lane` loads,
// counted from the warp's first row: warp_minima reads accumulator row g +
// 8 h of fragment m from lane m * 16 + h * 8 + g, and fragment m's rows start
// MStride rows after fragment 0's (16 in the mma.sync body, whose warp owns
// 32 adjacent rows; 64 in the wgmma body, whose warp owns rows 16 w.. of
// each m64 half of its group).
template <int MStride>
__device__ __forceinline__ int lane_row(int lane) {
  return lane < 16 ? lane : MStride + lane - 16;
}

// The warp's part of a row tile's epilogue under metric M: the surrogates of
// its 32 rows against the QT queries from the accumulators, and each query's
// minimum over the 32 rows into wmin[warp * QT + j]; a dead row or a NaN
// surrogate counts as +inf. The lane's own row (lane_row) brings alpha `a`,
// its row term `rowv` (alpha^2 csq for L2, 1/sqrt(max(csq, 1)) for COSINE),
// csq > 0 (`pos`) and whether it is live (`ok`); the accumulators
// (acc[m][n][h * 2 + e]: row g + 8 h of fragment m, query 8 n + 2 t + e) hold
// the dots (the -8 bias already off), plus kMagicBits where kSmallDot. A
// dead row's terms are made NaN, so each of its surrogates is NaN, and
// fminf, which returns the other operand of a NaN, never takes one: the
// minimum equals the minimum with NaN read as +inf, bit for bit, and +inf
// when no surrogate of the group is a number. kSmallDot: every dot is in
// [-2^22, 2^22] (d <= 4,096: |code * qc| <= 8 * 128), so the magic
// conversion is exact; otherwise the conversion rounds to nearest, as the
// twin's float32 cast of its exact dot does.
template <int M, int NT, bool kSmallDot>
__device__ __forceinline__ void warp_minima(const int (&acc)[2][NT][4], float a, float rowv,
                                            bool pos, bool ok, const float* qs, float* wmin,
                                            int warp, int lane) {
  constexpr int QT = 8 * NT;
  const int g = lane >> 2;
  const int t = lane & 3;
  if (!ok) {
    a = NAN;
    rowv = NAN;
    pos = true;
  }
  const unsigned posbits = __ballot_sync(0xffffffffu, pos);
  float vals[2 * NT];
  float ra[2][2], rv[2][2];
  bool rpos[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m * 16 + h * 8 + g;  // the lane holding accumulator row (m, h, g)
      ra[m][h] = __shfl_sync(0xffffffffu, a, r);
      rv[m][h] = __shfl_sync(0xffffffffu, rowv, r);
      rpos[m][h] = (posbits >> r) & 1u;
    }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = n * 8 + 2 * t + e;  // query of the tile
      const float q = qs[j];
      float best = INFINITY;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int v = acc[m][n][h * 2 + e];
          const float dotf = kSmallDot ? __fsub_rn(__int_as_float(v), kMagic) : static_cast<float>(v);
          float s;
          if constexpr (M == kDot) {
            s = __fmul_rn(-__fmul_rn(q, ra[m][h]), dotf);
          } else if constexpr (M == kCosine) {
            s = rpos[m][h] ? __fmul_rn(-dotf, rv[m][h]) : 0.0f;
          } else {
            s = __fsub_rn(rv[m][h], __fmul_rn(__fmul_rn(2.0f, __fmul_rn(q, ra[m][h])), dotf));
          }
          best = fminf(best, s);
        }
      vals[n * 2 + e] = best;
    }
  }
  // The minima over the 8 row groups g (lane bits 2-4) by a halving
  // butterfly: at each level a lane keeps half of its values, takes the
  // partner lane's minima of that half, and passes on the other half (V/2 +
  // V/4 + V/8 shuffles, not 3 V); a lane ends with the minima of queries
  // kbase, kbase + 1, ... of its list (n * 2 + e), all lanes writing.
  constexpr int V = 2 * NT;
  int kbase = 0;
#pragma unroll
  for (int lvl = 0; lvl < 3; ++lvl) {
    const int off = 16 >> lvl;
    const bool upper = (lane & off) != 0;
    const int c = V >> lvl;  // values held before this level
    if (c >= 2) {
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        if (i < c / 2) {
          const float mine = upper ? vals[c / 2 + i] : vals[i];
          const float other = upper ? vals[i] : vals[c / 2 + i];
          vals[i] = fminf(mine, __shfl_xor_sync(0xffffffffu, other, off));
        }
      }
      if (upper) kbase += c / 2;
    } else {
      vals[0] = fminf(vals[0], __shfl_xor_sync(0xffffffffu, vals[0], off));
    }
  }
  constexpr int kLeft = V >= 8 ? V / 8 : 1;
#pragma unroll
  for (int i = 0; i < kLeft; ++i) {
    const int k = kbase + i;
    wmin[warp * QT + (k >> 1) * 8 + 2 * t + (k & 1)] = vals[i];
  }
}

// The epilogue's per-warp part under the launch's metric: the row terms of
// the lane's own row (alpha a, csq c) as surrogate() computes them once a
// row (alpha^2 csq for L2, 1/sqrt(max(csq, 1)) correctly rounded for
// COSINE), then warp_minima.
template <int NT, bool kSmallDot>
__device__ __forceinline__ void warp_surrogate_minima(const int (&acc)[2][NT][4], int metric, float a,
                                                      int32_t c, bool ok, const float* qs,
                                                      float* wmin, int warp, int lane) {
  const float csqf = static_cast<float>(c);
  const bool pos = csqf > 0.0f;
  if (metric == kDot) {
    warp_minima<kDot, NT, kSmallDot>(acc, a, 0.0f, pos, ok, qs, wmin, warp, lane);
  } else if (metric == kCosine) {
    const float inv = __fdiv_rn(1.0f, __fsqrt_rn(fmaxf(csqf, 1.0f)));
    warp_minima<kCosine, NT, kSmallDot>(acc, a, inv, pos, ok, qs, wmin, warp, lane);
  } else {
    const float bsq = __fmul_rn(__fmul_rn(a, a), csqf);
    warp_minima<kL2, NT, kSmallDot>(acc, a, bsq, pos, ok, qs, wmin, warp, lane);
  }
}

}  // namespace
