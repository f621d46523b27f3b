// K1 on tensor cores with mma.sync: the dot-family block minima for float
// rows (f32, f16, bf16) and 8-bit codes, for NVIDIA Hopper (sm_90a).
//
// Computes what csrc/block_minima.cu computes (its header states the contract,
// replacing the three TPU schedules of sqlite_vector_tpu/ops/pallas_scan.py):
//
//   out[b, g] = min over rows r in [128 g, 128 g + 128) of dist(q_b, base_r)
//
// for L2 (squared), SQUARED_L2, COSINE and DOT over float32, float16 and
// bfloat16 rows and u8/i8 codes, with the same snap, NaN -> +inf, rows >=
// valid -> +inf and optional row mask. L1 stays on the CUDA-core body of
// block_minima.cu, and float rows TMA can copy go to the wgmma body of
// block_minima_wgmma.cu (this body stays launchable for them, as its
// cross-check); ops/block_scan.py:k1_body routes between the three.
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
//     the analogue of the TPU's multi-pass bf16 product at HIGHEST.
//   - f16/bf16: mma.sync m16n8k16 with .f16/.bf16 operands and an f32
//     accumulator. The product of two 16-bit floats is exact in f32, so
//     this is what the TPU kernel computes (bf16 natively on its matrix
//     unit, f16 widened to f32, both accumulating in f32).
//   Row and query norms are fmaf chains in column order over the values
//   widened to f32: one chain over the row, or for the tiles that sum the
//   dot chunk by chunk (kPromote) one chain a chunk added to a running
//   total, as the dot is. A row or query whose norm is not finite (Inf,
//   NaN, or overflow: bf16 reaches 3.39e38) would break the split or the
//   tensor cores' sums (Inf - Inf, 0 * Inf, an order-dependent overflow),
//   so for such a (row, query) pair the owning thread recomputes the dot
//   with the CUDA-core body's fmaf chain from global memory, which keeps
//   its Inf/NaN semantics (DOT over a +Inf row reads -inf). That pass runs
//   only for a row tile that holds such a pair.
//
// What bounds it on an H100 (1M x 384): f32 is bandwidth-bound at B=1 (1.54 GB)
// and bound by tensor-core issue at B=64 (3 x 49 GFLOP of TF32); 16-bit rows
// (768 MB) and 8-bit codes (384 MB) are bandwidth-bound at every batch up to
// 64. At 1M x 4,096 f32 the same holds: B=1 reads 16.4 GB at 82% of the
// card's rate; at B=64 each SM partition pays ~10 cycles per extra TF32
// mma.sync as the query tile grows (tools/probe_k1_tiles.py), so the
// streamed body runs 3 x 537 GFLOP at ~126 TFLOP/s, and a deeper ring did
// not move it. The design:
//   - persistent blocks of 8 warps walk 256-row tiles (two 128-row groups);
//     each warp owns 32 rows (two m16 tiles) against every query of its tile;
//   - the block's query tile (up to 64 queries, zero-padded to a multiple of
//     128 bytes a row) is loaded into shared memory once, with its norms, so
//     the matrix is read in one pass for B <= 64; larger batches take
//     several query tiles, whose blocks are adjacent in launch order and
//     walk the same row tiles at once (the base's re-reads are L2 hits);
//   - rows too wide for that (not even 8 padded query rows fit the shared
//     budget of ops/block_scan.py: f32 past d = 3,424, 16-bit past 6,848,
//     codes past 13,696) take the streamed instances (kStream): each ring
//     stage holds the tile's 128-byte column chunk of the queries beside the
//     rows' (re-read from L2 once a row tile: QT / 256 of the rows' bytes),
//     so shared memory no longer grows with d (3 x (256 + QT) x 144 bytes);
//     the query norms are summed from the staged chunks during the block's
//     first row tile. A wide row needs the per-chunk sums below at every
//     width, so every streamed float tile keeps them, up to 64 queries: the
//     64 running totals then take a register each beside the 64
//     accumulators (f32: 255 registers, no spill, on an H100), and one pass
//     over the matrix for B <= 64 beat two or four (f32, 1M x 4,096, B=64:
//     13.8 ms at 64 queries, 17.4 at 32, 25.0 at 16;
//     tools/probe_k1_tiles.py);
//   - base tiles of 256 rows x 128 bytes stream through a 3-stage ring of
//     cp.async copies (16-byte when the row pitch and pointer allow, 4-byte
//     or plain byte loads otherwise, zero-filled past d and N), so the loads
//     of the next chunk or row tile overlap the MMAs of the current one;
//   - shared rows are padded to 144 bytes: fragment loads, 16-byte row reads
//     and cp.async stores are conflict-free;
//   - float tiles of 8 and 16 queries (16-bit ones also of 32) and every
//     streamed float tile add each 128-byte chunk's products, and its
//     norms, to running totals with one rounded add (the tensor cores'
//     truncating accumulation over all of a wide row drifts past the
//     tolerance); a minimum is then summed in the same order whatever the
//     tile, so such tiles give equal minima bit for bit;
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
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "k1_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kTileRows = 256;       // rows per block iteration: two groups
constexpr int kWarps = kTileRows / 32;  // 32 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSM = 1;
constexpr int kPitch = kChunk + 16;  // padded shared row pitch, bytes
constexpr int kStages = 3;
constexpr int kStageBytes = kTileRows * kPitch;

// ---- PTX wrappers (cp.async ones in sm90_common.cuh) ---------------------

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the 32-byte k-step of 8-bit codes (m16n8k32, int32 sums) or of 16-bit
// floats (m16n8k16, f32 sums); the fragments' words are laid out alike
template <typename T, typename C>
__device__ __forceinline__ void mma_narrow(C (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else if constexpr (std::is_same<T, uint8_t>::value) {
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

// kStream: stage the 128-byte column chunk `ch` of query rows [q0, q0 + QT)
// (rows >= B and bytes past the row zero) at dst, kPitch bytes a row, as
// stage_chunk stages the rows' (vec: load_width of the queries).
template <int QT>
__device__ __forceinline__ void stage_queries(unsigned char* dst, const unsigned char* q, int q0,
                                              int B, int row_bytes, int ch, int vec, int tid) {
  const int c0 = ch * kChunk;
  if (vec == 16 || vec == 4) {
    const int per_row = kChunk / vec;
    for (int p = tid; p < QT * per_row; p += kThreads) {
      const int r = p / per_row;
      const int c = c0 + (p % per_row) * vec;
      const bool in = q0 + r < B && c < row_bytes;
      const unsigned char* src = in ? q + static_cast<long long>(q0 + r) * row_bytes + c : q;
      const uint32_t to = smem_addr(dst + r * kPitch + (c - c0));
      if (vec == 16) {
        cp_async16(to, src, in ? 16 : 0);
      } else {
        cp_async4(to, src, in ? 4 : 0);
      }
    }
  } else {
    for (int p = tid; p < QT * (kChunk / 4); p += kThreads) {
      const int r = p / (kChunk / 4);
      const int c = c0 + (p % (kChunk / 4)) * 4;
      uint32_t w = 0;
      if (q0 + r < B) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c + e < row_bytes) {
            w |= static_cast<uint32_t>(q[static_cast<long long>(q0 + r) * row_bytes + c + e]) << (8 * e);
          }
        }
      }
      *reinterpret_cast<uint32_t*>(dst + r * kPitch + (c - c0)) = w;
    }
  }
}

// T: float, __half, __nv_bfloat16, uint8_t or int8_t. NT: 8-query column
// tiles per block (QT = 8 NT). kStream: the query tile is staged chunk by
// chunk beside the rows in each ring stage (qvec: load_width of the
// queries) instead of resident in shared memory.
template <typename T, int NT, bool kStream>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
mma_minima_kernel(const T* __restrict__ queries, const T* __restrict__ base,
                  const uint8_t* __restrict__ mask, float* __restrict__ out, int B, int N, int d,
                  int valid, int metric, int nqt, int vec, int qvec) {
  constexpr int QT = 8 * NT;
  using A = Acc<T>;
  // The tensor cores accumulate f32 with truncation, so the error of a dot
  // grows with the MMAs summed into one accumulator: at d = 3,424 a
  // self-match's L2 minimum sat 0.22 off the twin (on an H100). Float
  // tiles of 8 and 16 queries (every d past 26 chunks of 128 bytes takes
  // one: 832 f32 or 1,664 16-bit columns), and 16-bit tiles of 32, therefore
  // start each chunk's MMAs from zero and add them to a running total in
  // one rounded add; resident f32 tiles of 32 and 64 queries hold at most
  // 26 chunks, 16-bit tiles of 64 at most 13, and skip it. Such
  // tiles sum the row and query norms chunk by chunk the same way (an fmaf
  // chain in column order over each chunk, one rounded add a chunk): one
  // chain over all of a wide row sits ~sqrt(d) roundings off the dot, so a
  // self-match's L2 missed the snap and its COSINE read ~1e-5 (d = 6,848,
  // bfloat16, on an H100).
  // A streamed tile serves rows of any width, so every streamed float tile
  // keeps the sums.
  constexpr bool kPromote = kIsFloat<T> && (kStream || NT <= 2 || (!kIsF32<T> && NT <= 4));
  // a ring stage: the rows' chunk, then (kStream) the queries'
  constexpr int kSB = kStream ? (kTileRows + QT) * kPitch : kStageBytes;
  extern __shared__ __align__(16) unsigned char smem[];

  const int row_bytes = d * static_cast<int>(sizeof(T));
  const int nchunks = (row_bytes + kChunk - 1) / kChunk;
  // the query rows' pitch, bytes: the resident tile's rows, or a stage's
  const int qpitch = kStream ? kPitch : nchunks * kChunk + 16;
  unsigned char* ring = smem;
  unsigned char* qs = ring + kStages * kSB;  // the resident tile (not kStream)
  A* qnorm = reinterpret_cast<A*>(qs + (kStream ? 0 : QT * qpitch));
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
  for (int i = tid; !kStream && i < QT * nchunks * kChunk / static_cast<int>(sizeof(T)); i += kThreads) {
    const int per_row = nchunks * kChunk / static_cast<int>(sizeof(T));
    const int j = i / per_row;
    const int c = i % per_row;
    T v{};
    if (q0 + j < B && c < d) v = queries[static_cast<long long>(q0 + j) * d + c];
    reinterpret_cast<T*>(qs + j * qpitch)[c] = v;
  }
  __syncthreads();
  if (!kStream && tid < QT) {
    A s = A(0);
    if constexpr (kIsFloat<T>) {
      // in column order, chunk by chunk as the rows' norms (kPromote)
      constexpr int kPer = kChunk / static_cast<int>(sizeof(T));
      const T* qrow = reinterpret_cast<const T*>(qs + tid * qpitch);
      for (int c0 = 0; c0 < d; c0 += kPer) {
        float part = kPromote ? 0.0f : s;
        for (int c = c0; c < min(d, c0 + kPer); ++c) part = fmaf(to_f32(qrow[c]), to_f32(qrow[c]), part);
        s = kPromote ? __fadd_rn(s, part) : part;
      }
    } else {
      const uint32_t* qrow = reinterpret_cast<const uint32_t*>(qs + tid * qpitch);
      for (int w = 0; w < nchunks * kChunk / 4; ++w) s += sq4<T>(qrow[w]);
    }
    qnorm[tid] = s;
  }
  // (qnorm is read after the ring loop's first __syncthreads; kStream: summed
  // in the first row tile's steps, read after the barrier before its
  // epilogue)

  const int my_tiles = slot < ntiles ? (ntiles - slot + nslots - 1) / nslots : 0;
  const int steps = my_tiles * nchunks;
  const unsigned char* bbytes = reinterpret_cast<const unsigned char*>(base);
  auto issue = [&](int s) {
    const int tile = slot + (s / nchunks) * nslots;
    unsigned char* stage = ring + (s % kStages) * kSB;
    stage_chunk<kTileRows, kThreads>(stage, bbytes, static_cast<long long>(tile) * kTileRows, N,
                                     row_bytes, s % nchunks, kChunk, kPitch, vec, tid);
    if constexpr (kStream) {
      stage_queries<QT>(stage + kTileRows * kPitch, reinterpret_cast<const unsigned char*>(queries),
                        q0, B, row_bytes, s % nchunks, qvec, tid);
    }
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
    const unsigned char* stage = ring + (s % kStages) * kSB;
    const unsigned char* wrows = stage + warp * 32 * kPitch;
    const unsigned char* qchunk = kStream ? stage + kTileRows * kPitch : qs + ch * kChunk;

    // the lane's row norm, in column order (kPromote: this chunk's sum,
    // then one rounded add)
    {
      const A part = chunk_sq<T>(wrows + lane * kPitch, kPromote ? A(0) : bsq);
      if constexpr (kPromote) {
        bsq = __fadd_rn(bsq, part);
      } else {
        bsq = part;
      }
    }
    if constexpr (kStream) {
      // the query norms, summed as the rows' during the block's first tile
      if (s < nchunks && tid < QT) {
        const A part = chunk_sq<T>(qchunk + tid * kPitch, kPromote || ch == 0 ? A(0) : qnorm[tid]);
        if constexpr (kPromote) {
          qnorm[tid] = ch == 0 ? part : __fadd_rn(qnorm[tid], part);
        } else {
          qnorm[tid] = part;
        }
      }
    }

    // k-steps of 32 bytes: 8 TF32 columns, 16 half floats or 32 codes
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
      if constexpr (kIsF32<T>) {
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
          for (int m = 0; m < 2; ++m) mma_narrow<T>(acc[m][n], a[m], b0, b1);
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
    if constexpr (kStream) {
      if (s == nchunks - 1) __syncthreads();  // the query norms are complete
    }

    // ---- epilogue of the row tile: distances, group minima ----------------
    // one specialised copy of the unrolled epilogue per composition, so the
    // loop holds only the one it runs (L2 and SQUARED_L2 compose alike)
    const int tile = slot + (s / nchunks) * nslots;
    const long long row0 = static_cast<long long>(tile) * kTileRows;
    if constexpr (kIsFloat<T>) rowsq[tid] = bsq;
    bool bad;
    if (metric == kDot) {
      bad = warp_minima<kDot, T, NT, 16>(acc, bsq, qnorm, wmin, row0 + warp * 32, valid, mask, q0, B,
                                     thresh, warp, lane);
    } else if (metric == kCosine) {
      bad = warp_minima<kCosine, T, NT, 16>(acc, bsq, qnorm, wmin, row0 + warp * 32, valid, mask, q0,
                                        B, thresh, warp, lane);
    } else {
      bad = warp_minima<kL2, T, NT, 16>(acc, bsq, qnorm, wmin, row0 + warp * 32, valid, mask, q0, B,
                                    thresh, warp, lane);
    }
    if (__syncthreads_or(bad)) {
      if constexpr (kIsFloat<T>) {
        nonfinite_pass<T, kTileRows, kThreads, 16>(queries, base, mask, qnorm, rowsq, wmin, row0,
                                                   QT, q0, B, d, valid, metric, thresh, tid);
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

// the ring (kStream: with the queries' chunks), the resident query tile
// (not kStream), the query norms, the warp minima and the row norms
long long shared_bytes(int qt, long long qpitch, bool streamed) {
  const long long ring = kStages * (streamed ? static_cast<long long>(kTileRows + qt) * kPitch : kStageBytes);
  return ring + (streamed ? 0 : qt * qpitch) + qt * 4 + kWarps * qt * 4 + kTileRows * 4;
}

template <typename T, int NT, bool kStream>
int launch_tile(const void* q, const void* base, const uint8_t* mask, float* out, int B, int N,
                int d, int valid, int metric, cudaStream_t stream) {
  constexpr int QT = 8 * NT;
  const long long row_bytes = static_cast<long long>(d) * sizeof(T);
  const long long qpitch = (row_bytes + kChunk - 1) / kChunk * kChunk + 16;
  const int nqt = (B + QT - 1) / QT;
  auto kernel = mma_minima_kernel<T, NT, kStream>;
  static std::atomic<long long> fit[kMaxDevices];
  const long long smem = shared_bytes(QT, qpitch, kStream);
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
  const int qvec = load_width(q, row_bytes);
  kernel<<<static_cast<unsigned>(nslots * nqt), kThreads, static_cast<int>(smem), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(base), mask, out, B, N, d, valid, metric,
      nqt, vec, qvec);
  return static_cast<int>(cudaGetLastError());
}

// query_tile queries per block (8, 16, 32 or 64; ops/block_scan.py:
// mma_query_tile picks it, and mma_streams_queries whether the tile is
// streamed); B past one tile takes several tiles
template <typename T>
int launch(const void* q, const void* base, const uint8_t* mask, float* out, int B, int N, int d,
           int valid, int metric, int query_tile, int stream_queries, cudaStream_t stream) {
  if (stream_queries) {
    switch (query_tile) {
      case 8: return launch_tile<T, 1, true>(q, base, mask, out, B, N, d, valid, metric, stream);
      case 16: return launch_tile<T, 2, true>(q, base, mask, out, B, N, d, valid, metric, stream);
      case 32: return launch_tile<T, 4, true>(q, base, mask, out, B, N, d, valid, metric, stream);
      case 64: return launch_tile<T, 8, true>(q, base, mask, out, B, N, d, valid, metric, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (query_tile) {
    case 8: return launch_tile<T, 1, false>(q, base, mask, out, B, N, d, valid, metric, stream);
    case 16: return launch_tile<T, 2, false>(q, base, mask, out, B, N, d, valid, metric, stream);
    case 32: return launch_tile<T, 4, false>(q, base, mask, out, B, N, d, valid, metric, stream);
    case 64: return launch_tile<T, 8, false>(q, base, mask, out, B, N, d, valid, metric, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The arguments of svt_block_minima (csrc/block_minima.cu), query_tile and
// stream_queries (0: the query tile resident in shared memory; 1: streamed
// beside the rows, for rows of any width). Takes the dot-family metrics
// over float32, float16, bfloat16, uint8 and int8 only, u8/i8 only while no
// int32 partial sum can reach 2^31, and a query tile whose shared bytes fit
// the device; anything else returns cudaErrorInvalidValue without launching
// (ops/block_scan.py:k1_body routes L1 and such codes to svt_block_minima).
// Launches on `stream` and does not synchronise.
extern "C" int svt_block_minima_mma(const void* queries, const void* base, const void* mask,
                                    void* out, int B, int N, int d, int valid, int dtype,
                                    int metric, int query_tile, int stream_queries, void* stream) {
  if (B <= 0 || N <= 0 || d <= 0 || valid < 0 || valid > N || metric < kL2 || metric > kDot) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int qt = query_tile;
  const int sq = stream_queries;
  switch (dtype) {
    case kF32: return launch<float>(queries, base, m, o, B, N, d, valid, metric, qt, sq, s);
    case kF16: return launch<__half>(queries, base, m, o, B, N, d, valid, metric, qt, sq, s);
    case kBF16: return launch<__nv_bfloat16>(queries, base, m, o, B, N, d, valid, metric, qt, sq, s);
    case kU8:
      if (d > 33025) return static_cast<int>(cudaErrorInvalidValue);
      return launch<uint8_t>(queries, base, m, o, B, N, d, valid, metric, qt, sq, s);
    case kI8:
      if (d > 131071) return static_cast<int>(cudaErrorInvalidValue);
      return launch<int8_t>(queries, base, m, o, B, N, d, valid, metric, qt, sq, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
