// The int8/u8 finish's rescore, for NVIDIA Hopper (sm_90a): the exact
// distances of each query to the 128 rows of every group the finish selected
// for it, read in place from the code matrix.
//
// Replaces no TPU kernel. The JAX package's finish
// (sqlite_vector_tpu/ops/pallas_scan.py:748-800 _finish_from_minima) is XLA
// ops, and the port ran it as torch ops: the selected rows gathered into a
// [B, k * 128, d] block, widened to float64 (torch has no CUDA int32 matmul),
// two batched products and some 35 element-wise ops. At k = 100 over 768-wide
// codes that took more device time a batch than K1's scan of 10M rows. This
// kernel computes the same values from the codes where they lie.
//
// For query b, slot j of gidx [B, kg] (group g = gidx[b, j]) and r in
// [0, 128), out[b, j * 128 + r] is the rank-ready distance of query b to row
// g * 128 + r, bit for bit what ops/block_scan.py:rescore_groups_reference
// gives: the dot and both square norms as exact int32 sums that wrap (summed
// in uint32, so the wrap is defined), composed as K1 composes them
// (csrc/k1_common.cuh:compose: L2 stays squared), the near-zero snap (at
// NEARLY_ZERO^2 for L2, NEARLY_ZERO otherwise), NaN -> +inf, and +inf for
// rows at or past `valid` (<= N) and rows whose mask byte is 0.
//
// What bounds it on an H100: the bytes. The codes of the selected groups are
// read once, B * kg * 128 * d bytes, and the output written once, B * kg *
// 128 * 4 (315 MB at B = 32, k = 100, d = 768: 0.094 ms at 3.35 TB/s; the
// products, 2 per code byte, are far below the int8 rate). The design keeps
// enough bytes in flight on every SM at any batch:
//   - one block of 4 warps per (query, group) pair: B * kg blocks (200 at
//     B = 2, k = 100), 32 rows a warp;
//   - a warp reads 4 of its rows at once, 64 words of each a pass: lane l
//     loads words l and l + 32 (16 bytes where d and the pointers allow,
//     else 4, else 1), so neighbouring lanes read neighbouring addresses
//     and a lane has 8 loads in flight (a 768-byte row is one pass); rows
//     are loaded evict-first (read once), the query through the read-only
//     cache (every warp of its pairs reads it);
//   - dp4a over the words, signed for i8, unsigned for u8, into per-lane
//     uint32 partial sums, then a butterfly over the warp; lane r keeps row
//     r's sums and composes it, and the warp stores its 32 distances in one
//     128-byte write;
//   - rows that are dead (at or past valid, or masked) are not read;
//   - each warp sums its query's square norm itself from the query words
//     of its first step, so no other launch prepares it.
// A probe of the loop's shape on an H100 (10M x 768 int8, k = 100, B = 32:
// 8 rows x 1 word a lane 0.1105 ms, 4 x 2 0.1070, 8 x 2 0.1073, 16 x 1
// 0.1451) chose 4 x 2: fewest registers among the fastest.
//
// Build: with the other kernels (ops/_build.py), one nvcc process a source.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "k1_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kGroup / kWarps;
constexpr int kRowsPerStep = 4;   // rows a warp reads at once ...
constexpr int kWordsPerPass = 2;  // ... two words a lane of each

// the word a lane loads: 16, 4 or 1 bytes of codes
template <typename T, int W>
using Word = typename std::conditional<
    W == 16, uint4, typename std::conditional<W == 4, uint32_t, T>::type>::type;

template <typename T>
__device__ __forceinline__ int dp4(uint32_t a, uint32_t b, int c) {
  if constexpr (std::is_same<T, uint8_t>::value) {
    return static_cast<int>(__dp4a(a, b, static_cast<unsigned>(c)));
  } else {
    return __dp4a(static_cast<int>(a), static_cast<int>(b), c);
  }
}

// the exact dot of two words of codes (at most 16 products: |sum| < 2^21),
// as uint32
template <typename T, typename U>
__device__ __forceinline__ uint32_t word_dot(U x, U y) {
  if constexpr (std::is_same<U, uint4>::value) {
    int s = dp4<T>(x.x, y.x, 0);
    s = dp4<T>(x.y, y.y, s);
    s = dp4<T>(x.z, y.z, s);
    s = dp4<T>(x.w, y.w, s);
    return static_cast<uint32_t>(s);
  } else if constexpr (std::is_same<U, uint32_t>::value) {
    return static_cast<uint32_t>(dp4<T>(x, y, 0));
  } else {
    return static_cast<uint32_t>(static_cast<int>(x) * static_cast<int>(y));
  }
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int W>
__global__ void __launch_bounds__(kWarps * 32)
rescore_groups_kernel(const T* __restrict__ queries, const T* __restrict__ base,
                      const int64_t* __restrict__ gidx, const uint8_t* __restrict__ mask,
                      float* __restrict__ out, int kg, int d, int valid, int metric) {
  using U = Word<T, W>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long pair = blockIdx.x;  // b * kg + j
  const int words = d / W;
  const U* q = reinterpret_cast<const U*>(queries + (pair / kg) * d);
  const long long row0 = gidx[pair] * kGroup + warp * kRowsPerWarp;

  uint32_t qsq = 0, my_dot = 0, my_sq = 0;
  bool my_live = false;
#pragma unroll 1
  for (int s = 0; s < kRowsPerWarp; s += kRowsPerStep) {
    const U* rows = reinterpret_cast<const U*>(base + (row0 + s) * d);
    bool live[kRowsPerStep];
    uint32_t dot[kRowsPerStep], sq[kRowsPerStep];
#pragma unroll
    for (int u = 0; u < kRowsPerStep; ++u) {
      const long long row = row0 + s + u;
      // mask is read only below valid (<= N)
      live[u] = row < valid && (mask == nullptr || mask[row] != 0);
      dot[u] = 0;
      sq[u] = 0;
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
        if (s == 0) qsq += word_dot<T>(y[v], y[v]);
#pragma unroll
        for (int u = 0; u < kRowsPerStep; ++u) {
          dot[u] += word_dot<T>(x[v][u], y[v]);
          sq[u] += word_dot<T>(x[v][u], x[v][u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsPerStep; ++u) {
      const uint32_t dt = warp_sum(dot[u]);
      const uint32_t st = warp_sum(sq[u]);
      if (lane == s + u) {
        my_dot = dt;
        my_sq = st;
        my_live = live[u];
      }
    }
  }
  qsq = warp_sum(qsq);
  float dist = INFINITY;
  if (my_live) {
    dist = compose(my_dot, qsq, my_sq, metric);
    if (fabsf(dist) <= (metric == kL2 ? kNearlyZeroSq : kNearlyZero)) dist = 0.0f;
    if (isnan(dist)) dist = INFINITY;
  }
  out[pair * kGroup + warp * kRowsPerWarp + lane] = dist;
}

template <typename T>
int launch(const void* queries, const void* base, const int64_t* gidx, const uint8_t* mask,
           float* out, int B, int kg, int d, int valid, int metric, int width,
           cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(B) * kg);
  const T* q = static_cast<const T*>(queries);
  const T* b = static_cast<const T*>(base);
  switch (width) {
    case 16:
      rescore_groups_kernel<T, 16><<<blocks, kWarps * 32, 0, stream>>>(q, b, gidx, mask, out, kg, d, valid, metric);
      break;
    case 4:
      rescore_groups_kernel<T, 4><<<blocks, kWarps * 32, 0, stream>>>(q, b, gidx, mask, out, kg, d, valid, metric);
      break;
    case 1:
      rescore_groups_kernel<T, 1><<<blocks, kWarps * 32, 0, stream>>>(q, b, gidx, mask, out, kg, d, valid, metric);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// queries [B, d] and base [N, d] (u8 or i8, contiguous), gidx [B, kg] int64
// (each in [0, ceil(N / 128))), mask [N] bytes or null, out [B, kg * 128]
// float32; width: the bytes a lane loads (16, 4 or 1), which divides d and
// the alignment of both pointers (ops/block_scan.py:rescore_width).
extern "C" int svt_rescore_groups(const void* queries, const void* base, const void* gidx,
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
    case kU8: return launch<uint8_t>(queries, base, g, m, o, B, kg, d, valid, metric, width, s);
    case kI8: return launch<int8_t>(queries, base, g, m, o, B, kg, d, valid, metric, width, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
