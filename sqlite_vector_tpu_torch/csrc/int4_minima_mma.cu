// K2 on tensor cores: packed-int4 surrogate block minima, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel of sqlite_vector_tpu/ops/pallas_int4.py in both of
// its schedules, :408 _int4_block_minima_manual and :511 _int4_block_minima:
// K2's contract (csrc/k2_common.cuh's header), bit for bit what
// csrc/int4_minima_wgmma.cu computes. ops/int4_scan.py:k2_body sends here
// the scans whose packed rows TMA cannot copy, at every d < 2^21; forced,
// it takes every scan, as the cross-check. The epilogue is k2_common.cuh's,
// shared with the wgmma body.
//
// The plane dots run where the TPU kernel runs them (_plane_dot and its i8dot
// path), on the matrix unit: mma.sync m16n8k32 with u8 row nibbles and s8
// query codes into int32. The packed layout (byte j: code j low, code h + j
// high, each + 8) gives two A operands per 4-byte word read from shared
// memory: x & 0x0F0F0F0F holds columns [c, c + 32) and (x >> 4) & 0x0F0F0F0F
// columns [h + c, h + c + 32), against the low and the high query plane. The
// +8 comes off as 8 * sum(qc), riding in the accumulators' start value, as
// _unpack_planes/_plane_dot take it off. No sum wraps: after the MMAs over
// any set P of columns an accumulator holds
//   sum over c in P of (nibble_c - 8) qc_c  -  8 * sum over c not in P of qc_c,
// whose every term is at most 8 * 127 in size, so |partial| <= 1,016 d <
// 2^31 for every d < 2^21 (the launcher's limit) in any order of the MMAs:
// the int32 accumulation is exact and equals the twin's exact dot.
//
// What bounds it on an H100 (1M x 384): the bytes, at every B <= 64 (192 MB
// of packed codes and 8 MB of alpha and csq, 0.060 ms at 3.35 TB/s; the
// 2 B N d int8 operations take 0.025 ms at 1,979 TOP/s even at B = 64).
// At 500,000 x 18,432, B=1 is bound by the bytes too (4.6 GB, 1.38 ms), but
// B=64 by mma.sync's issue rate: tools/probe_k2_body.py --body mma
// --streamed read ~25 cycles per MMA of a warp in the loop (an NVIDIA H100
// 80GB HBM3 at 700 W), where the 1.2 P int8 operations would take 0.6 ms
// at wgmma's peak. The
// design reads the codes once per batch and keeps the tensor cores fed:
//   - persistent blocks of 8 warps walk 256-row tiles (two 128-row groups);
//     each warp owns 32 rows (two m16 tiles) against every query of its tile;
//   - the query tile (8, 16, 32 or 64 queries), both planes zero-padded and
//     stored in fragment order (one 16-byte load gives a lane its four B
//     registers of a k-step), either stays in shared memory for the whole
//     launch (resident: where ops/int4_scan.py:k2_streams_queries keeps it,
//     its planes within 64 KB: d <= 8,192 for 8 queries, 1,024 for 64),
//     loaded before the first row tiles are asked for (behind their copies
//     its loads waited microseconds); or (kStream, the rest) is laid out in
//     fragment order once per call by ops/int4_scan.py:
//     k2_query_planes and streamed beside the codes: each ring stage carries,
//     after its rows, the tile's 2 * QT * chunk bytes of the same k-steps,
//     one contiguous run copied with 16-byte cp.async whatever d (the high
//     plane starts at h, odd for d = 1, 2 mod 4, and qc's rows at j * d, so
//     the raw codes allow no such copy), so shared memory does not grow with
//     d, at the price of QT / 128 more bytes read (from L2) per row byte.
//     8 * sum(qc) and qscale sit beside it. The codes are read once for
//     B <= 64; larger batches take several query tiles, whose blocks are
//     adjacent in launch order and walk the same row tiles at once (the
//     re-reads hit L2);
//   - packed row tiles stream through a double-buffered ring of cp.async
//     copies, 256 rows of the widest multiple of 64 bytes of a row that fits
//     beside the query tile (streamed: with its planes in every stage):
//     whole rows where they fit (d = 384: 192 bytes,
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
// tools/probe_k2_body.py --body mma splits a row tile's cycles into these
// phases.
//
// Build: see block_minima_mma.cu (same flags; plain C interface, ctypes).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "k2_common.cuh"
#include "sm90_common.cuh"

namespace {

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

__device__ __forceinline__ void mma_u8s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NT: 8-query column tiles per block (QT = 8 NT). chunk: the ring's row
// chunk in bytes, a multiple of kChunkUnit. kStream: the query tile is
// streamed from qplanes ([nqt][ksteps][NT][32] fragment entries,
// ops/int4_scan.py:k2_query_planes) beside the rows, with qbias_in [B]
// holding 8 * sum(qc); otherwise it is built from qc, resident.
template <int NT, bool kStream>
__global__ void __launch_bounds__(kThreads, 1)
int4_mma_minima_kernel(const int8_t* __restrict__ qc, const float* __restrict__ qscale,
                       const uint4* __restrict__ qplanes, const int* __restrict__ qbias_in,
                       const uint8_t* __restrict__ packed, const float* __restrict__ alpha,
                       const int32_t* __restrict__ csq, const uint8_t* __restrict__ mask,
                       float* __restrict__ out, int B, int N, int d, int valid, int metric,
                       int nqt, int chunk, int vec) {
  constexpr int QT = 8 * NT;
  // resident tiles of 32 and 64 queries hold d <= 4,096 only (their planes
  // fill the budget past it; the launcher checks); a streamed tile may take
  // any d, so it converts exactly, not by the magic
  constexpr bool kSmallDot = !kStream && NT >= 4;
  extern __shared__ __align__(16) unsigned char smem[];

  const int h = (d + 1) / 2;    // bytes per packed row
  const int hi_cols = d - h;    // codes held in the high nibbles
  const int nchunks = (h + chunk - 1) / chunk;
  const int ksteps = (h + 31) / 32;  // 32-byte MMA k-steps of a row
  const int pitch = chunk + kPad;
  // a ring stage: the rows' chunk, then (kStream) the query tile's entries
  // of the chunk's chunk / 32 k-steps
  const int stage_bytes = kTileRows * pitch + (kStream ? chunk / 32 * NT * 32 * 16 : 0);
  unsigned char* ring = smem;
  // the resident tile (not kStream): [ksteps][NT][32]
  uint4* qfrag = reinterpret_cast<uint4*>(ring + kStages * stage_bytes);
  int* qbias = reinterpret_cast<int*>(qfrag + (kStream ? 0 : ksteps * NT * 32));  // [QT] 8 sum(qc)
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
  for (int i = tid; !kStream && i < ksteps * NT * 32; i += kThreads) {
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
    unsigned char* stage = ring + (s % kStages) * stage_bytes;
    stage_chunk<kTileRows, kThreads>(stage, packed, static_cast<long long>(tile) * kTileRows, N,
                                     h, s % nchunks, chunk, pitch, vec, tid);
    if constexpr (kStream) {
      // the tile's entries of the chunk's k-steps up to the row's end: one
      // contiguous run of qplanes
      const int ks0 = (s % nchunks) * (chunk / 32);
      const int entries = (min(ks0 + chunk / 32, ksteps) - ks0) * NT * 32;
      const uint4* src = qplanes + (static_cast<long long>(qt) * ksteps + ks0) * NT * 32;
      const uint32_t dst = smem_addr(stage + kTileRows * pitch);
      for (int i = tid; i < entries; i += kThreads) cp_async16(dst + 16 * i, src + i, 16);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }

  // 8 * sum(qc) and qscale of each query; the resident tile sums it from its
  // entries: query j's are lanes 4 (j % 8) + t of column tile j / 8 in every
  // k-step
  __syncthreads();
  if (tid < QT) {
    int sum = 0;
    for (int ks = 0; !kStream && ks < ksteps; ++ks) {
#pragma unroll
      for (int t4 = 0; t4 < 4; ++t4) {
        const uint4 v = qfrag[(ks * NT + tid / 8) * 32 + (tid % 8) * 4 + t4];
        sum = __dp4a(static_cast<int>(v.x), 0x01010101, sum);
        sum = __dp4a(static_cast<int>(v.y), 0x01010101, sum);
        sum = __dp4a(static_cast<int>(v.z), 0x01010101, sum);
        sum = __dp4a(static_cast<int>(v.w), 0x01010101, sum);
      }
    }
    qbias[tid] = kStream ? (q0 + tid < B ? qbias_in[q0 + tid] : 0) : 8 * sum;
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
    const long long row = static_cast<long long>(tile) * kTileRows + warp * 32 + lane_row<16>(lane);
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
    const unsigned char* stage = ring + (s % kStages) * stage_bytes;
    const unsigned char* wrows = stage + warp * 32 * pitch;
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
      const uint4* qf = (kStream ? reinterpret_cast<const uint4*>(stage + kTileRows * pitch) +
                                       (ks - ks0) * NT * 32
                                 : qfrag + ks * NT * 32) + lane;
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
    warp_surrogate_minima<NT, kSmallDot>(acc, metric, pa, pc, pin && pm != 0, qs, wmin, warp, lane);
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

template <int NT, bool kStream>
int launch_tile(const int8_t* qc, const float* qscale, const uint4* qplanes, const int* qbias,
                const uint8_t* packed, const float* alpha, const int32_t* csq,
                const uint8_t* mask, float* out, int B, int N, int d, int valid, int metric,
                cudaStream_t stream) {
  constexpr int QT = 8 * NT;
  const int h = (d + 1) / 2;
  const int nqt = (B + QT - 1) / QT;
  auto kernel = int4_mma_minima_kernel<NT, kStream>;
  static std::atomic<long long> fit[kMaxDevices];
  int dev = 0, sms = 0, smem_limit = 0, per_sm = 0;
  cudaError_t err = current_device(dev, sms, smem_limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dynamic shared bytes: the resident query tile's fragments (64 bytes a
  // query and k-step), biases and scales and the warps' minima, then the
  // ring, of the widest row chunk that fits beside them (whole rows where
  // they fit, so a ring step reads one contiguous run of the matrix); a
  // streamed tile rides in the ring, 2 QT bytes a stage per byte of chunk
  const long long fixed =
      (kStream ? 0LL : static_cast<long long>((h + 31) / 32) * QT * 64) + QT * 8 + kWarps * QT * 4;
  auto ring = [](long long c) { return kStages * (kTileRows * (c + kPad) + (kStream ? 2 * QT * c : 0)); };
  int chunk = (h + kChunkUnit - 1) / kChunkUnit * kChunkUnit;
  while (chunk > kChunkUnit && fixed + ring(chunk) > smem_limit) chunk -= kChunkUnit;
  const long long smem = fixed + ring(chunk);
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
      qc, qscale, qplanes, qbias, packed, alpha, csq, mask, out, B, N, d, valid, metric, nqt,
      chunk, load_width(packed, h));
  return static_cast<int>(cudaGetLastError());
}

template <bool kStream>
int launch(int query_tile, const int8_t* qc, const float* qscale, const uint4* qplanes,
           const int* qbias, const uint8_t* packed, const float* alpha, const int32_t* csq,
           const uint8_t* mask, float* out, int B, int N, int d, int valid, int metric,
           cudaStream_t s) {
  switch (query_tile) {
    case 8:
      return launch_tile<1, kStream>(qc, qscale, qplanes, qbias, packed, alpha, csq, mask, out, B,
                                     N, d, valid, metric, s);
    case 16:
      return launch_tile<2, kStream>(qc, qscale, qplanes, qbias, packed, alpha, csq, mask, out, B,
                                     N, d, valid, metric, s);
    case 32:
      return launch_tile<4, kStream>(qc, qscale, qplanes, qbias, packed, alpha, csq, mask, out, B,
                                     N, d, valid, metric, s);
    case 64:
      return launch_tile<8, kStream>(qc, qscale, qplanes, qbias, packed, alpha, csq, mask, out, B,
                                     N, d, valid, metric, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// qc int8 [B, d], qscale float32 [B], packed uint8 [N, ceil(d/2)], alpha
// float32 [N], csq int32 [N], all row-major; mask null (every row live) or
// N bytes, 0 for a masked row (a torch.bool tensor); out float32
// [B, ceil(N/128)]; and query_tile: queries per block, 8, 16, 32 or 64 (ops/int4_scan.py:
// k2_query_tile picks it; B past one tile takes several tiles); qplanes and
// qbias: null for a query tile resident in shared memory (tiles of 32 and
// 64 only for d <= 4,096), or, to stream it, the query codes in fragment
// order (int8 [ceil(B / query_tile), ceil(ceil(d/2) / 32), query_tile / 8,
// 32, 16], 16-byte aligned, ops/int4_scan.py:k2_query_planes) and 8 *
// sum(qc) of each query (int32 [B]). A resident query tile whose shared
// bytes do not fit the device returns cudaErrorInvalidValue without
// launching (ops/int4_scan.py:k2_streams_queries streams such tiles).
// Launches on `stream` and does not synchronise.
extern "C" int svt_int4_block_minima_mma(const void* qc, const void* qscale, const void* packed,
                                         const void* alpha, const void* csq, const void* mask,
                                         void* out, int B, int N, int d, int valid, int metric,
                                         int query_tile, const void* qplanes, const void* qbias,
                                         void* stream) {
  const bool streamed = qplanes != nullptr;
  if (B <= 0 || N <= 0 || d <= 0 || d >= (1 << 21) || valid < 0 || valid > N || metric < kL2 ||
      metric > kDot || (!streamed && query_tile >= 32 && d > 4096) ||
      (streamed && (qbias == nullptr || reinterpret_cast<uintptr_t>(qplanes) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* q = static_cast<const int8_t*>(qc);
  const float* qs = static_cast<const float*>(qscale);
  const uint4* qp = static_cast<const uint4*>(qplanes);
  const int* qb = static_cast<const int*>(qbias);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const float* al = static_cast<const float*>(alpha);
  const int32_t* cs = static_cast<const int32_t*>(csq);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (streamed) return launch<true>(query_tile, q, qs, qp, qb, pk, al, cs, m, o, B, N, d, valid, metric, s);
  return launch<false>(query_tile, q, qs, qp, qb, pk, al, cs, m, o, B, N, d, valid, metric, s);
}
