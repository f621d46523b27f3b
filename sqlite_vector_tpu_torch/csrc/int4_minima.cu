// K2: packed-int4 surrogate block minima, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel in sqlite_vector_tpu/ops/pallas_int4.py, both of
// its schedules: the manual-DMA _int4_block_minima_manual
// (_make_manual_kernel) and the grid _int4_block_minima (_make_kernel). One
// kernel here computes what they compute:
//
//   out[b, g] = min over rows r in [128 g, 128 g + 128) of S(q_b, r)
//
// with S the monotone surrogate of _surrogate_block over the exact integer
// dot of the int8 query codes with the row's int4 codes:
//   L2, SQUARED_L2  alpha^2 csq - 2 (qscale alpha) dot
//   DOT             -(qscale alpha) dot
//   COSINE          -dot / sqrt(max(csq, 1))  (0 where csq == 0)
// and rows >= valid, rows whose mask byte is 0 (when a row mask is given)
// or with a NaN surrogate at +inf. The JAX package sends masked int4 scans to
// its XLA tile loop (ops/quantize4.py int4_scan_topk); here the mask rides in
// the kernel. The exact top-k finish over these minima runs as torch ops
// (ops/int4_scan.py) and masks the same rows inside the groups it selects.
//
// Packed layout (ops/quantize4.py): row i is h = ceil(d/2) bytes; byte j
// holds code j in its low nibble and code h + j in its high nibble (odd d:
// the last high nibble is the pad code 0), each as nibble = code + 8.
//
// This is K2's CUDA-core body. The tensor-core body, csrc/int4_minima_mma.cu,
// computes the same minima bit for bit and serves every d whose query tile
// fits its shared memory (d <= 16,384); ops/int4_scan.py:k2_body sends wider
// rows here.
//
// What bounds it on an H100: at B=1 the bytes (192 MB of packed codes at
// 1M x 384, 0.06 ms at 3.35 TB/s); at large batches the CUDA-core integer
// dot rate (2 dp4a per 4 packed bytes per query). The design is the
// simple, right one:
//   - grid x over 128-row groups, grid y over query tiles of QT queries;
//   - each step stages a group's 128 rows x (up to) 48 packed words in
//     shared memory with coalesced 16-byte loads (1-byte loads when the
//     row width or the pointer does not allow them), at an odd
//     word stride so that the per-row reads are conflict-free; the query
//     tile's codes are staged beside them as two byte planes (lo: columns
//     [0, h), hi: columns [h, d), zero-padded), four codes per word;
//   - one thread per row: it splits each packed word into its two nibble
//     planes in registers (values 0..15, no -8 bias) and accumulates
//     __dp4a(plane, query plane) per query, reading the query planes four
//     words at a time (16-byte shared-memory broadcasts, so the loads do
//     not outnumber the dp4a); the bias comes off at the end
//     as 8 * sum(qc), as _unpack_planes/_plane_dot do. Integer sums are
//     exact, so the column order does not matter;
//   - the epilogue uses __fmul_rn/__fsub_rn in _surrogate_block's operation
//     order (no fma contraction) and a correctly rounded 1/sqrt for COSINE;
//   - rows >= valid and NaN surrogates become +inf explicitly (fminf would
//     drop a NaN silently), then the group minimum is a warp shuffle plus
//     shared memory.
//
// Build: see block_minima.cu (same flags; plain C interface, ctypes).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;               // rows per minima group == threads per block
constexpr int kChunkWords = 48;           // packed 4-byte words per row staged per step
constexpr int kStride = kChunkWords + 1;  // odd word stride: conflict-free row reads
constexpr int kWarps = kGroup / 32;

// codes shared with ops/block_scan.py (_METRIC_CODE); L1 has no surrogate
enum Metric : int { kL2 = 0, kSquaredL2 = 1, kCosine = 2, kDot = 3 };

// _surrogate_block for one (query, row) pair, in its operation order.
__device__ __forceinline__ float surrogate(int dot, float qs, float a, int32_t csq, int metric) {
  const float dotf = static_cast<float>(dot);  // round to nearest, as int32 -> f32
  const float csqf = static_cast<float>(csq);
  if (metric == kDot) return __fmul_rn(-__fmul_rn(qs, a), dotf);
  if (metric == kCosine) {
    if (!(csqf > 0.0f)) return 0.0f;
    const float inv = __fdiv_rn(1.0f, __fsqrt_rn(fmaxf(csqf, 1.0f)));
    return __fmul_rn(-dotf, inv);
  }
  const float bsq = __fmul_rn(__fmul_rn(a, a), csqf);
  const float cross = __fmul_rn(__fmul_rn(2.0f, __fmul_rn(qs, a)), dotf);
  return __fsub_rn(bsq, cross);
}

// Stage packed bytes [4 w0, 4 (w0 + cw)) of the group's `rows` rows into
// tile[r * kStride + w]. VB is the load width in bytes: 16 needs h % 16 ==
// 0 and a 16-byte-aligned base pointer; 1 takes any layout. Bytes of a
// partial last word are left as they are: the query planes are zero there.
template <int VB>
__device__ __forceinline__ void stage_rows(uint32_t* tile, const uint8_t* __restrict__ group,
                                           int rows, int h, int w0, int cw) {
  const int tid = threadIdx.x;
  if constexpr (VB == 16) {
    const int vecs = cw / 4;  // h % 16 == 0 and kChunkWords % 4 == 0
    for (int i = tid; i < rows * vecs; i += kGroup) {
      const int r = i / vecs;
      const int v = i - r * vecs;
      const uint4 x = *reinterpret_cast<const uint4*>(group + static_cast<long long>(r) * h +
                                                      4 * (w0 + 4 * v));
      uint32_t* dst = tile + r * kStride + 4 * v;
      dst[0] = x.x;
      dst[1] = x.y;
      dst[2] = x.z;
      dst[3] = x.w;
    }
  } else {
    const int nb = min(4 * cw, h - 4 * w0);  // bytes of each row in this chunk
    uint8_t* bytes = reinterpret_cast<uint8_t*>(tile);
    for (int i = tid; i < rows * nb; i += kGroup) {
      const int r = i / nb;
      const int c = i - r * nb;
      bytes[4 * r * kStride + c] = group[static_cast<long long>(r) * h + 4 * w0 + c];
    }
  }
}

template <int QT, int VB>
__global__ void __launch_bounds__(kGroup)
int4_minima_kernel(const int8_t* __restrict__ qc, const float* __restrict__ qscale,
                   const uint8_t* __restrict__ packed, const float* __restrict__ alpha,
                   const int32_t* __restrict__ csq, const uint8_t* __restrict__ mask,
                   float* __restrict__ out, int B, int N, int d, int valid, int metric) {
  __shared__ uint32_t tile[kGroup * kStride];
  __shared__ __align__(16) uint32_t qlo[QT][kChunkWords];
  __shared__ __align__(16) uint32_t qhi[QT][kChunkWords];
  __shared__ int qbias[QT];
  __shared__ float qs_tile[QT];
  __shared__ float warp_min[kWarps][QT];

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kGroup;
  const int q0 = blockIdx.y * QT;
  const int h = (d + 1) / 2;     // bytes per packed row
  const int hi_cols = d - h;     // codes held in the high nibbles
  const int words = (h + 3) / 4;
  const int rows = static_cast<int>(min(static_cast<long long>(kGroup), N - row0));
  const uint8_t* group = packed + row0 * h;

  int acc[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) acc[j] = 0;
  int qsum = 0;  // thread j < QT: sum of query q0 + j's codes

  for (int w0 = 0; w0 < words; w0 += kChunkWords) {
    const int cw = min(kChunkWords, words - w0);
    // the dot loop walks whole 4-word steps: query words in [cw, cw4) are
    // zero, so the tile words there (not staged) add nothing
    const int cw4 = (cw + 3) & ~3;
    stage_rows<VB>(tile, group, rows, h, w0, cw);
    for (int i = tid; i < QT * cw4; i += kGroup) {
      const int j = i / cw4;
      const int w = i - j * cw4;
      uint32_t lo = 0, hi = 0;
      if (q0 + j < B && w < cw) {
        const int8_t* q = qc + static_cast<long long>(q0 + j) * d;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = 4 * (w0 + w) + b;
          if (c < h) lo |= static_cast<uint32_t>(static_cast<uint8_t>(q[c])) << (8 * b);
          if (c < hi_cols) hi |= static_cast<uint32_t>(static_cast<uint8_t>(q[h + c])) << (8 * b);
        }
      }
      qlo[j][w] = lo;
      qhi[j][w] = hi;
    }
    __syncthreads();
    if (tid < QT) {
      for (int w = 0; w < cw4; ++w) {
        qsum = __dp4a(static_cast<int>(qlo[tid][w]), 0x01010101, qsum);
        qsum = __dp4a(static_cast<int>(qhi[tid][w]), 0x01010101, qsum);
      }
    }
    const uint32_t* mine = tile + tid * kStride;
    for (int w = 0; w < cw4; w += 4) {
      int lo[4], hi[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t x = mine[w + u];
        lo[u] = static_cast<int>(x & 0x0F0F0F0Fu);
        hi[u] = static_cast<int>((x >> 4) & 0x0F0F0F0Fu);
      }
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        // one 16-byte broadcast read per plane feeds four dp4a
        const int4 ql = *reinterpret_cast<const int4*>(&qlo[j][w]);
        const int4 qh = *reinterpret_cast<const int4*>(&qhi[j][w]);
        acc[j] = __dp4a(lo[0], ql.x, acc[j]);
        acc[j] = __dp4a(lo[1], ql.y, acc[j]);
        acc[j] = __dp4a(lo[2], ql.z, acc[j]);
        acc[j] = __dp4a(lo[3], ql.w, acc[j]);
        acc[j] = __dp4a(hi[0], qh.x, acc[j]);
        acc[j] = __dp4a(hi[1], qh.y, acc[j]);
        acc[j] = __dp4a(hi[2], qh.z, acc[j]);
        acc[j] = __dp4a(hi[3], qh.w, acc[j]);
      }
    }
    __syncthreads();
  }

  if (tid < QT) {
    qbias[tid] = 8 * qsum;
    qs_tile[tid] = q0 + tid < B ? qscale[q0 + tid] : 0.0f;
  }
  __syncthreads();

  const long long row = row0 + tid;
  // mask is read only below valid (<= N): a row past it is never loaded
  const bool row_ok = row < valid && (mask == nullptr || mask[row] != 0);
  const float a = row < N ? alpha[row] : 0.0f;
  const int32_t c = row < N ? csq[row] : 0;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    float s = surrogate(acc[j] - qbias[j], qs_tile[j], a, c, metric);
    if (!row_ok || isnan(s)) s = INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s = fminf(s, __shfl_xor_sync(0xffffffffu, s, off));
    }
    if (lane == 0) warp_min[warp][j] = s;
  }
  __syncthreads();
  if (tid < QT && q0 + tid < B) {
    float m = warp_min[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fminf(m, warp_min[w][tid]);
    out[static_cast<long long>(q0 + tid) * gridDim.x + blockIdx.x] = m;
  }
}

template <int QT>
int launch_tile(const int8_t* qc, const float* qscale, const uint8_t* packed,
                const float* alpha, const int32_t* csq, const uint8_t* mask, float* out,
                int B, int N, int d, int valid, int metric, cudaStream_t stream) {
  const dim3 grid((N + kGroup - 1) / kGroup, (B + QT - 1) / QT);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int h = (d + 1) / 2;
  const uintptr_t p = reinterpret_cast<uintptr_t>(packed);
  if (h % 16 == 0 && p % 16 == 0) {
    int4_minima_kernel<QT, 16><<<grid, kGroup, 0, stream>>>(qc, qscale, packed, alpha, csq, mask, out, B, N, d, valid, metric);
  } else {
    int4_minima_kernel<QT, 1><<<grid, kGroup, 0, stream>>>(qc, qscale, packed, alpha, csq, mask, out, B, N, d, valid, metric);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qc int8 [B, d], qscale float32 [B], packed uint8 [N, ceil(d/2)], alpha
// float32 [N], csq int32 [N], all row-major; mask null (every row live) or
// N bytes, 0 for a masked row (a torch.bool tensor); out float32
// [B, ceil(N/128)]. Launches on `stream` and does not synchronise. Returns
// a cudaError_t code: 0 when the launch was accepted.
extern "C" int svt_int4_block_minima(const void* qc, const void* qscale, const void* packed,
                                     const void* alpha, const void* csq, const void* mask,
                                     void* out, int B, int N, int d, int valid, int metric,
                                     void* stream) {
  if (B <= 0 || N <= 0 || d <= 0 || valid < 0 || valid > N || metric < kL2 || metric > kDot) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* q = static_cast<const int8_t*>(qc);
  const float* qs = static_cast<const float*>(qscale);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const float* al = static_cast<const float*>(alpha);
  const int32_t* cs = static_cast<const int32_t*>(csq);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 1) return launch_tile<1>(q, qs, pk, al, cs, m, o, B, N, d, valid, metric, s);
  if (B <= 4) return launch_tile<4>(q, qs, pk, al, cs, m, o, B, N, d, valid, metric, s);
  return launch_tile<16>(q, qs, pk, al, cs, m, o, B, N, d, valid, metric, s);
}
