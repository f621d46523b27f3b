// K2 on tensor cores: packed-int4 surrogate block minima, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel of sqlite_vector_tpu/ops/pallas_int4.py in both of
// its schedules, :408 _int4_block_minima_manual and :511 _int4_block_minima,
// and computes what csrc/int4_minima.cu computes, bit for bit (its header
// states the contract: per 128-row group, the minimum of _surrogate_block's
// surrogate over the exact integer dot of the int8 query codes with the
// row's int4 codes; rows >= valid, masked rows and NaN surrogates at +inf).
// ops/int4_scan.py:k2_body routes between the two: this body wherever its
// shared budget holds the query tile (d <= 16,384), int4_minima.cu past it.
//
// The plane dots run where the TPU kernel runs them (_plane_dot and its i8dot
// path), on the matrix unit: mma.sync m16n8k32 with u8 row nibbles and s8
// query codes into int32. The packed layout (byte j: code j low, code h + j
// high, each + 8) gives two A operands per 4-byte word read from shared
// memory: x & 0x0F0F0F0F holds columns [c, c + 32) and (x >> 4) & 0x0F0F0F0F
// columns [h + c, h + c + 32), against the low and the high query plane. The
// +8 comes off at the end as 8 * sum(qc), as _unpack_planes/_plane_dot do.
// No sum wraps: every partial sum is at most 15 * 128 * d < 2^26 in size for
// any d whose query tile fits shared memory (d < 24,000), so the int32
// accumulation (no .satfinite) is exact and equals the CUDA-core body's.
//
// What bounds it on an H100 (1M x 384): the bytes, at every B <= 64 (192 MB
// of packed codes and 8 MB of alpha and csq, 0.060 ms at 3.35 TB/s; the
// 2 B N d int8 operations take 0.025 ms at 1,979 TOP/s even at B = 64). The
// design reads the codes once per batch and keeps the tensor cores fed:
//   - persistent blocks of 8 warps walk 256-row tiles (two 128-row groups);
//     each warp owns 32 rows (two m16 tiles) against every query of its tile;
//   - the query tile (8, 16, 32 or 64 queries) stays in shared memory for the
//     whole launch, both planes zero-padded and stored in fragment order (one
//     16-byte load gives a lane its four B registers of a k-step), beside
//     8 * sum(qc) and qscale, so the codes are read once for B <= 64; larger
//     batches take several query tiles, whose blocks are adjacent in launch
//     order and walk the same row tiles at once (the re-reads hit L2). It is
//     loaded before the first row tiles are asked for: behind their copies
//     its loads waited microseconds;
//   - packed row tiles stream through a double-buffered ring of cp.async
//     copies, 256 rows of the widest multiple of 64 bytes of a row that fits
//     beside the query tile: whole rows where they fit (d = 384: 192 bytes,
//     one contiguous 48 KB run of the matrix a step; 64-byte column chunks,
//     a strided read, were slower at B=1), padded 16 bytes a row
//     (conflict-free fragment reads); two stages let two blocks share an SM
//     at small batches;
//   - alpha, csq and the mask byte of the next row tile are loaded into
//     registers (one row a thread) while the current one is scanned;
//   - the epilogue keeps surrogate()'s operation order (__fmul_rn/__fsub_rn,
//     no contraction, a correctly rounded 1/sqrt), computes what depends on
//     the row alone once a row (alpha^2 csq, 1/sqrt(max(csq, 1))), is one
//     copy per metric, and runs no test per (row, query) pair: the bias
//     rides in the accumulators' start, a dead row's terms are NaN (fminf
//     drops them), and the minimum over a warp's rows is a halving butterfly.
// tools/probe_k2_body.py splits a row tile's cycles into these phases.
//
// Build: see block_minima_mma.cu (same flags; plain C interface, ctypes).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "sm90_common.cuh"

namespace {

constexpr int kGroup = 128;             // rows per minima group
constexpr int kTileRows = 256;          // rows per block iteration: two groups
constexpr int kWarps = kTileRows / 32;  // 32 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kGroupWarps = kGroup / 32;
constexpr int kStages = 2;  // double buffer: two blocks fit an SM at small batches
// The ring's row chunk (packed bytes of a row per ring step) is a multiple
// of kChunkUnit, set at launch; its shared rows are padded by kPad bytes,
// which keeps the fragment reads conflict-free (a pitch of 16 mod 64 bytes).
constexpr int kChunkUnit = 64;
constexpr int kPad = 16;

// codes shared with ops/block_scan.py (_METRIC_CODE); L1 has no surrogate
enum Metric : int { kL2 = 0, kSquaredL2 = 1, kCosine = 2, kDot = 3 };

__device__ __forceinline__ void mma_u8s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// The warp's part of a row tile's epilogue under metric M: the surrogates of
// its 32 rows against the QT queries from the accumulators, and each query's
// minimum over the 32 rows into wmin[warp * QT + j]; a dead row or a NaN
// surrogate counts as +inf. The lane's own row (warp * 32 + lane of the
// tile) brings alpha `a`, its row term `rowv` (alpha^2 csq for L2,
// 1/sqrt(max(csq, 1)) for COSINE), csq > 0 (`pos`) and whether it is live
// (`ok`); the accumulators hold the dots (the -8 bias already off), plus
// kMagicBits where kSmallDot. A dead row's terms are made NaN, so each of
// its surrogates is NaN, and fminf, which returns the other operand of a
// NaN, never takes one: the minimum equals the minimum with NaN read as
// +inf, bit for bit, and +inf when no surrogate of the group is a number.
// kSmallDot: every dot is in [-2^22, 2^22] (d <= 4,096: |code * qc| <= 8 *
// 128), so the magic conversion is exact.
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
      const int r = m * 16 + h * 8 + g;  // accumulator rows of this lane
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

// NT: 8-query column tiles per block (QT = 8 NT). chunk: the ring's row
// chunk in bytes, a multiple of kChunkUnit.
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
int4_mma_minima_kernel(const int8_t* __restrict__ qc, const float* __restrict__ qscale,
                       const uint8_t* __restrict__ packed, const float* __restrict__ alpha,
                       const int32_t* __restrict__ csq, const uint8_t* __restrict__ mask,
                       float* __restrict__ out, int B, int N, int d, int valid, int metric,
                       int nqt, int chunk, int vec) {
  constexpr int QT = 8 * NT;
  // tiles of 32 and 64 queries take d <= 4,096 only (the launcher checks)
  constexpr bool kSmallDot = NT >= 4;
  extern __shared__ __align__(16) unsigned char smem[];

  const int h = (d + 1) / 2;    // bytes per packed row
  const int hi_cols = d - h;    // codes held in the high nibbles
  const int nchunks = (h + chunk - 1) / chunk;
  const int ksteps = (h + 31) / 32;  // 32-byte MMA k-steps of a row
  const int pitch = chunk + kPad;
  const int stage_bytes = kTileRows * pitch;
  unsigned char* ring = smem;
  uint4* qfrag = reinterpret_cast<uint4*>(ring + kStages * stage_bytes);  // [ksteps][NT][32]
  int* qbias = reinterpret_cast<int*>(qfrag + ksteps * NT * 32);          // [QT] 8 sum(qc)
  float* qs = reinterpret_cast<float*>(qbias + QT);                      // [QT] qscale
  float* wmin = qs + QT;                                                 // [kWarps][QT]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int qt = blockIdx.x % nqt;
  const int slot = blockIdx.x / nqt;
  const int nslots = gridDim.x / nqt;
  const int q0 = qt * QT;
  const int groups = (N + kGroup - 1) / kGroup;
  const int ntiles = (N + kTileRows - 1) / kTileRows;

  // the query tile, once, in fragment order: entry (ks, n, l) holds lane l's
  // B registers for k-step ks of column tile n, {low plane b0, b1, high
  // plane b0, b1}; zero past each plane's end and past B. Its loads go out
  // first, in batches, ahead of the row tiles' copies (behind those they
  // wait microseconds)
#pragma unroll 4
  for (int i = tid; i < ksteps * NT * 32; i += kThreads) {
    const int l = i & 31;
    const int n = (i >> 5) % NT;
    const int ks = (i >> 5) / NT;
    const int j = n * 8 + (l >> 2);
    const int c = ks * 32 + 4 * (l & 3);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + j < B) {
      const int8_t* q = qc + static_cast<long long>(q0 + j) * d;
      v.x = plane_word(q, c, h);
      v.y = plane_word(q, c + 16, h);
      v.z = plane_word(q + h, c, hi_cols);
      v.w = plane_word(q + h, c + 16, hi_cols);
    }
    qfrag[i] = v;
  }
  // then the first row tiles' copies
  const int my_tiles = slot < ntiles ? (ntiles - slot + nslots - 1) / nslots : 0;
  const int steps = my_tiles * nchunks;
  auto issue = [&](int s) {
    const int tile = slot + (s / nchunks) * nslots;
    stage_chunk<kTileRows, kThreads>(ring + (s % kStages) * stage_bytes, packed,
                                     static_cast<long long>(tile) * kTileRows, N, h, s % nchunks,
                                     chunk, pitch, vec, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }

  // 8 * sum(qc) and qscale of each query, from the query tile: query j's
  // entries are lanes 4 (j % 8) + t of column tile j / 8 in every k-step
  __syncthreads();
  if (tid < QT) {
    int sum = 0;
    for (int ks = 0; ks < ksteps; ++ks) {
#pragma unroll
      for (int t4 = 0; t4 < 4; ++t4) {
        const uint4 v = qfrag[(ks * NT + tid / 8) * 32 + (tid % 8) * 4 + t4];
        sum = __dp4a(static_cast<int>(v.x), 0x01010101, sum);
        sum = __dp4a(static_cast<int>(v.y), 0x01010101, sum);
        sum = __dp4a(static_cast<int>(v.z), 0x01010101, sum);
        sum = __dp4a(static_cast<int>(v.w), 0x01010101, sum);
      }
    }
    qbias[tid] = 8 * sum;
    qs[tid] = q0 + tid < B ? qscale[q0 + tid] : 0.0f;
  }
  // (qbias and qs are read after the ring loop's first __syncthreads)

  // the thread's row of the current row tile: alpha, csq, the mask byte
  // (read only below valid) and whether it is below valid, loaded one row
  // tile ahead and used at that tile's epilogue
  float pa = 0.0f;
  int32_t pc = 0;
  uint8_t pm = 0;
  bool pin = false;
  auto load_aux = [&](int tile) {
    const long long row = static_cast<long long>(tile) * kTileRows + tid;
    pin = row < valid;
    pm = (pin && mask != nullptr) ? mask[row] : 1;
    pa = row < N ? alpha[row] : 0.0f;
    pc = row < N ? csq[row] : 0;
  };
  if (slot < ntiles) load_aux(slot);

  int acc[2][NT][4];
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < steps) issue(s + kStages - 1);
    cp_async_commit();

    const int ch = s % nchunks;
    if (ch == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // the -8 bias of the query's column, and kMagicBits (warp_minima)
            acc[m][n][e] = (kSmallDot ? kMagicBits : 0) - qbias[n * 8 + 2 * t + (e & 1)];
          }
    }
    const unsigned char* wrows = ring + (s % kStages) * stage_bytes + warp * 32 * pitch;
    // the chunk's k-steps up to the row's end (the chunk's bytes past it
    // are zero in the ring; the query planes are zero there too)
    const int ks0 = ch * (chunk / 32);
    const int ks_end = min(ks0 + chunk / 32, ksteps);
#pragma unroll 2
    for (int ks = ks0; ks < ks_end; ++ks) {
      const int w0 = (ks - ks0) * 8 + t;  // 32-bit word of the row within the chunk
      uint32_t lo[2][4], hi[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint32_t* r0 = reinterpret_cast<const uint32_t*>(wrows + (m * 16 + g) * pitch);
        const uint32_t* r1 = reinterpret_cast<const uint32_t*>(wrows + (m * 16 + g + 8) * pitch);
        const uint32_t x[4] = {r0[w0], r1[w0], r0[w0 + 4], r1[w0 + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lo[m][e] = x[e] & 0x0F0F0F0Fu;
          hi[m][e] = (x[e] >> 4) & 0x0F0F0F0Fu;
        }
      }
      const uint4* qf = qfrag + ks * NT * 32 + lane;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint4 b = qf[n * 32];
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_u8s8(acc[m][n], lo[m], b.x, b.y);
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_u8s8(acc[m][n], hi[m], b.z, b.w);
      }
    }
    if (ch != nchunks - 1) continue;

    // ---- epilogue of the row tile: surrogates, group minima ----------------
    const int tile = slot + (s / nchunks) * nslots;
    const float csqf = static_cast<float>(pc);
    const bool ok = pin && pm != 0;
    const bool pos = csqf > 0.0f;
    if (metric == kDot) {
      warp_minima<kDot, NT, kSmallDot>(acc, pa, 0.0f, pos, ok, qs, wmin, warp, lane);
    } else if (metric == kCosine) {
      const float inv = __fdiv_rn(1.0f, __fsqrt_rn(fmaxf(csqf, 1.0f)));
      warp_minima<kCosine, NT, kSmallDot>(acc, pa, inv, pos, ok, qs, wmin, warp, lane);
    } else {
      const float bsq = __fmul_rn(__fmul_rn(pa, pa), csqf);
      warp_minima<kL2, NT, kSmallDot>(acc, pa, bsq, pos, ok, qs, wmin, warp, lane);
    }
    if (tile + nslots < ntiles) load_aux(tile + nslots);
    __syncthreads();
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

template <int NT>
int launch_tile(const int8_t* qc, const float* qscale, const uint8_t* packed, const float* alpha,
                const int32_t* csq, const uint8_t* mask, float* out, int B, int N, int d,
                int valid, int metric, cudaStream_t stream) {
  constexpr int QT = 8 * NT;
  const int h = (d + 1) / 2;
  const int nqt = (B + QT - 1) / QT;
  auto kernel = int4_mma_minima_kernel<NT>;
  static std::atomic<long long> fit[kMaxDevices];
  int dev = 0, sms = 0, smem_limit = 0, per_sm = 0;
  cudaError_t err = current_device(dev, sms, smem_limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dynamic shared bytes: the query tile's fragments (64 bytes a query and
  // k-step), biases and scales and the warps' minima, then the ring, of the
  // widest row chunk that fits beside them (whole rows where they fit, so a
  // ring step reads one contiguous run of the matrix)
  const long long fixed = static_cast<long long>((h + 31) / 32) * QT * 64 + QT * 8 + kWarps * QT * 4;
  int chunk = (h + kChunkUnit - 1) / kChunkUnit * kChunkUnit;
  while (chunk > kChunkUnit && fixed + kStages * kTileRows * (chunk + kPad) > smem_limit) {
    chunk -= kChunkUnit;
  }
  const long long smem = fixed + kStages * kTileRows * (chunk + kPad);
  err = blocks_per_sm(reinterpret_cast<const void*>(kernel), kThreads, smem, dev, smem_limit, fit,
                      per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  // blocks of one slot are adjacent (qt fastest) and walk the same row tiles
  const int ntiles = (N + kTileRows - 1) / kTileRows;
  long long nslots = (static_cast<long long>(sms) * per_sm + nqt - 1) / nqt;
  if (nslots > ntiles) nslots = ntiles;
  if (nslots < 1) nslots = 1;
  if (nslots * nqt > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(nslots * nqt), kThreads, static_cast<int>(smem), stream>>>(
      qc, qscale, packed, alpha, csq, mask, out, B, N, d, valid, metric, nqt, chunk,
      load_width(packed, h));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The arguments of svt_int4_block_minima (csrc/int4_minima.cu), and
// query_tile: queries per block, 8, 16, 32 or 64 (ops/int4_scan.py:
// k2_query_tile picks it; B past one tile takes several tiles; tiles of 32
// and 64 only for d <= 4,096). A query tile
// whose shared bytes do not fit the device returns cudaErrorInvalidValue
// without launching (ops/int4_scan.py:k2_body routes such scans to
// svt_int4_block_minima). Launches on `stream` and does not synchronise.
extern "C" int svt_int4_block_minima_mma(const void* qc, const void* qscale, const void* packed,
                                         const void* alpha, const void* csq, const void* mask,
                                         void* out, int B, int N, int d, int valid, int metric,
                                         int query_tile, void* stream) {
  if (B <= 0 || N <= 0 || d <= 0 || valid < 0 || valid > N || metric < kL2 || metric > kDot ||
      (query_tile >= 32 && d > 4096)) {
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
  switch (query_tile) {
    case 8: return launch_tile<1>(q, qs, pk, al, cs, m, o, B, N, d, valid, metric, s);
    case 16: return launch_tile<2>(q, qs, pk, al, cs, m, o, B, N, d, valid, metric, s);
    case 32: return launch_tile<4>(q, qs, pk, al, cs, m, o, B, N, d, valid, metric, s);
    case 64: return launch_tile<8>(q, qs, pk, al, cs, m, o, B, N, d, valid, metric, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
