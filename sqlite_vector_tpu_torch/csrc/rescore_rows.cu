// The float finish's rescore, for NVIDIA Hopper (sm_90a): the exact
// distances of each query to the 128 rows of every group the finish selected
// for it, read in place from the float32, float16 or bfloat16 row matrix.
//
// Replaces no TPU kernel. The JAX package's finish
// (sqlite_vector_tpu/ops/pallas_scan.py:748-800 _finish_from_minima) is XLA
// ops, and the port ran it as torch ops: the selected rows gathered into a
// [B, k * 128, d] block in slices, then read three more times (the rows'
// squares written out and summed, a batched product for the dot). At k = 100
// over 5M x 1,536 float32 rows that moved ~15 GB a batch of 32 for 2.52 GB of
// candidates. This kernel reads each candidate row once, where it lies.
//
// For query b, slot j of gidx [B, kg] (group g = gidx[b, j]) and r in
// [0, 128), out[b, j * 128 + r] is the rank-ready distance of query b to row
// g * 128 + r, as ops/block_scan.py:rescore_groups_reference gives it (the
// gathered route, ops/rerank.py:candidate_distances) up to the order of the
// float32 sums: the rows widened to float32 in registers, every product and
// sum a float32 FMA on the CUDA cores (no TF32, no 16-bit product);
//   - COSINE and DOT from the dot and both square norms, composed as K1
//     composes float rows (csrc/k1_common.cuh:compose);
//   - L2 and SQUARED_L2 as the direct sum((x - q)^2), which reads exactly 0
//     for a row equal to its query at any width, zeroed at or under
//     16 FLT_EPSILON (q_sq + c_sq) and NaN where that residual is not finite
//     (L2 stays squared);
// then the near-zero snap (at NEARLY_ZERO^2 for L2, NEARLY_ZERO otherwise),
// NaN -> +inf, and +inf for rows at or past `valid` (<= N) and rows whose
// mask byte is 0.
//
// What bounds it on an H100: the bytes. The selected groups' rows are read
// once, B * kg * 128 * d * elem bytes, and the output written once, B * kg *
// 128 * 4 (2.52 GB at B = 32, k = 100, d = 1,536 float32: 0.75 ms at 3.35
// TB/s; the 2 or 3 FP32 operations an element, ~1.9 G, take ~0.06 ms at the
// FP32 rate). The design is csrc/rescore_codes.cu's:
//   - one block of 4 warps per (query, group) pair, B * kg blocks (3,200 at
//     B = 32, k = 100), 32 rows a warp; a group's rows are one contiguous
//     span (786 KB at d = 1,536 float32);
//   - a warp reads kRowsPerStep of its rows at once, kWordsPerPass words of
//     each a lane a pass: lane l loads words l, l + 32, ... (16 bytes where
//     d * elem and both pointers allow, else 4, else the element), so
//     neighbouring lanes read neighbouring addresses and a warp has 4 KB in
//     flight (16 KB a block); rows are loaded evict-first (read once), the
//     query through the read-only cache (every warp of its pairs reads it);
//   - per-lane float32 sums, then a butterfly over the warp (every lane
//     ends with the same bits); lane r keeps row r's sums and composes it,
//     and the warp stores its 32 distances in one 128-byte write;
//   - rows that are dead (at or past valid, or masked) are not read;
//   - each warp sums its query's square norm itself from the query words of
//     its first step, so no other launch prepares it.
// A probe of the loop's shape on an H100 (tools/probe_rescore_rows.py: 5M x
// 1,536 float32, k = 100, B = 32, COSINE, in turns; bound 0.752 ms): 4 rows x
// 2 words a lane 0.7940 ms, 8 x 1 0.8117, 2 x 4 0.7943, 8 x 2 0.7941, 4 x 4
// 0.7929, 2 x 2 0.7973 chose 4 x 2: within 0.2% of the fastest, with 69-72
// registers in the float32 16-byte instances against its 117-122.
//
// Build: with the other kernels (ops/_build.py), one nvcc process a source.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "k1_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kGroup / kWarps;
constexpr int kRowsPerStep = 4;   // rows a warp reads at once ...
constexpr int kWordsPerPass = 2;  // ... words a lane of each, a pass

// the word a lane loads: 16 or 4 bytes, or one 16-bit element
template <int W>
using Word = typename std::conditional<
    W == 16, uint4, typename std::conditional<W == 4, uint32_t, uint16_t>::type>::type;

// the float values of a word of T, widened to float32, in column order
template <typename T, int W>
__device__ __forceinline__ void widen(Word<W> w, float (&f)[W / sizeof(T)]) {
  if constexpr (W == 16) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (std::is_same<T, float>::value) {
        f[i] = __uint_as_float(u[i]);
      } else {
        const float2 p = widen2<T>(u[i]);
        f[2 * i] = p.x;
        f[2 * i + 1] = p.y;
      }
    }
  } else if constexpr (W == 4) {
    if constexpr (std::is_same<T, float>::value) {
      f[0] = __uint_as_float(w);
    } else {
      const float2 p = widen2<T>(w);
      f[0] = p.x;
      f[1] = p.y;
    }
  } else if constexpr (std::is_same<T, __half>::value) {
    f[0] = __half2float(__ushort_as_half(w));
  } else {  // bfloat16: the high half of an f32
    f[0] = __uint_as_float(static_cast<uint32_t>(w) << 16);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Diff: the L2 family (acc sums (x - q)^2); otherwise acc sums x q
template <typename T, int W, bool Diff>
__global__ void __launch_bounds__(kWarps * 32)
rescore_rows_kernel(const T* __restrict__ queries, const T* __restrict__ base,
                    const int64_t* __restrict__ gidx, const uint8_t* __restrict__ mask,
                    float* __restrict__ out, int kg, int d, int valid, int metric) {
  using U = Word<W>;
  constexpr int kVals = W / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long pair = blockIdx.x;  // b * kg + j
  const int words = d / kVals;
  const U* q = reinterpret_cast<const U*>(queries + (pair / kg) * d);
  const long long row0 = gidx[pair] * kGroup + warp * kRowsPerWarp;

  float qsq = 0.0f, my_acc = 0.0f, my_sq = 0.0f;
  bool my_live = false;
#pragma unroll 1
  for (int s = 0; s < kRowsPerWarp; s += kRowsPerStep) {
    const U* rows = reinterpret_cast<const U*>(base + (row0 + s) * d);
    bool live[kRowsPerStep];
    float acc[kRowsPerStep], sq[kRowsPerStep];
#pragma unroll
    for (int u = 0; u < kRowsPerStep; ++u) {
      const long long row = row0 + s + u;
      // mask is read only below valid (<= N)
      live[u] = row < valid && (mask == nullptr || mask[row] != 0);
      acc[u] = 0.0f;
      sq[u] = 0.0f;
    }
    // every lane runs every pass (no divergence before the butterflies);
    // words past d load nothing and add 0
    for (int c0 = 0; c0 < words; c0 += 32 * kWordsPerPass) {
      U y[kWordsPerPass];
      U x[kWordsPerPass][kRowsPerStep];
#pragma unroll
      for (int v = 0; v < kWordsPerPass; ++v) {
        const int c = c0 + v * 32 + lane;
        const bool in = c < words;
        y[v] = in ? __ldg(q + c) : U{};
#pragma unroll
        for (int u = 0; u < kRowsPerStep; ++u) {
          x[v][u] = in && live[u] ? __ldcs(rows + u * words + c) : U{};
        }
      }
#pragma unroll
      for (int v = 0; v < kWordsPerPass; ++v) {
        float fy[kVals];
        widen<T, W>(y[v], fy);
        if (s == 0) {
#pragma unroll
          for (int i = 0; i < kVals; ++i) qsq = fmaf(fy[i], fy[i], qsq);
        }
#pragma unroll
        for (int u = 0; u < kRowsPerStep; ++u) {
          float fx[kVals];
          widen<T, W>(x[v][u], fx);
#pragma unroll
          for (int i = 0; i < kVals; ++i) {
            if constexpr (Diff) {
              const float t = __fsub_rn(fx[i], fy[i]);
              acc[u] = fmaf(t, t, acc[u]);
            } else {
              acc[u] = fmaf(fx[i], fy[i], acc[u]);
            }
            sq[u] = fmaf(fx[i], fx[i], sq[u]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsPerStep; ++u) {
      const float at = warp_sum(acc[u]);
      const float st = warp_sum(sq[u]);
      if (lane == s + u) {
        my_acc = at;
        my_sq = st;
        my_live = live[u];
      }
    }
  }
  qsq = warp_sum(qsq);
  float dist = INFINITY;
  if (my_live) {
    if constexpr (Diff) {
      const float resid = __fmul_rn(kResidScale, __fadd_rn(qsq, my_sq));
      dist = !isfinite(resid) ? NAN : (my_acc <= resid ? 0.0f : my_acc);
    } else {
      dist = compose(my_acc, qsq, my_sq, metric);
    }
    if (fabsf(dist) <= (metric == kL2 ? kNearlyZeroSq : kNearlyZero)) dist = 0.0f;
    if (isnan(dist)) dist = INFINITY;
  }
  out[pair * kGroup + warp * kRowsPerWarp + lane] = dist;
}

template <typename T, int W>
void launch_width(const T* q, const T* b, const int64_t* gidx, const uint8_t* mask, float* out,
                  unsigned blocks, int kg, int d, int valid, int metric, cudaStream_t stream) {
  if (metric == kL2 || metric == kSquaredL2) {
    rescore_rows_kernel<T, W, true><<<blocks, kWarps * 32, 0, stream>>>(q, b, gidx, mask, out, kg, d, valid, metric);
  } else {
    rescore_rows_kernel<T, W, false><<<blocks, kWarps * 32, 0, stream>>>(q, b, gidx, mask, out, kg, d, valid, metric);
  }
}

template <typename T>
int launch(const void* queries, const void* base, const int64_t* gidx, const uint8_t* mask,
           float* out, int B, int kg, int d, int valid, int metric, int width,
           cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(B) * kg);
  const T* q = static_cast<const T*>(queries);
  const T* b = static_cast<const T*>(base);
  if (width == 16) {
    launch_width<T, 16>(q, b, gidx, mask, out, blocks, kg, d, valid, metric, stream);
  } else if (width == 4) {
    launch_width<T, 4>(q, b, gidx, mask, out, blocks, kg, d, valid, metric, stream);
  } else if constexpr (sizeof(T) == 2) {
    if (width != 2) return static_cast<int>(cudaErrorInvalidValue);
    launch_width<T, 2>(q, b, gidx, mask, out, blocks, kg, d, valid, metric, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// queries [B, d] and base [N, d] (float32, float16 or bfloat16, contiguous),
// gidx [B, kg] int64 (each in [0, ceil(N / 128))), mask [N] bytes or null,
// out [B, kg * 128] float32; width: the bytes a lane loads (16, 4, or the
// element's 2), which divides d * elem and the alignment of both pointers
// (ops/block_scan.py:rescore_width).
extern "C" int svt_rescore_rows(const void* queries, const void* base, const void* gidx,
                                const void* mask, void* out, int B, int kg, int N, int d,
                                int valid, int dtype, int metric, int width, void* stream) {
  if (B <= 0 || kg <= 0 || N <= 0 || d <= 0 || valid < 0 || valid > N || metric < kL2 ||
      metric > kDot || static_cast<long long>(B) * kg > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* g = static_cast<const int64_t*>(gidx);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(queries, base, g, m, o, B, kg, d, valid, metric, width, s);
    case kF16: return launch<__half>(queries, base, g, m, o, B, kg, d, valid, metric, width, s);
    case kBF16: return launch<__nv_bfloat16>(queries, base, g, m, o, B, kg, d, valid, metric, width, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
