// K2 on Hopper's warpgroup MMA: packed-int4 surrogate block minima with TMA
// copies, mbarrier-ordered stages and warp specialisation, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel of sqlite_vector_tpu/ops/pallas_int4.py in both of
// its schedules, :408 _int4_block_minima_manual and :511 _int4_block_minima:
// K2's contract (csrc/k2_common.cuh's header), bit for bit what
// csrc/int4_minima_mma.cu (mma.sync) computes. ops/int4_scan.py:k2_body
// sends a scan here wherever TMA takes the packed rows (ceil(d/2) a
// multiple of 16 bytes, a 16-byte aligned start); the mma.sync body keeps
// the rest, and stays launchable on these rows as the cross-check.
//
// The products: wgmma m64nNk32 .s32.u8.s8, the row nibbles as the A operand
// from registers and the query planes as B from shared memory. Each
// consumer thread reads its fragment's 4-byte words of a k-step from the
// TMA-swizzled stage and splits each as the mma.sync body does: x &
// 0x0F0F0F0F holds columns [c, c + 32) and (x >> 4) & 0x0F0F0F0F columns
// [h + c, h + c + 32), against the low and the high query plane; no unpacked
// copy is stored. The accumulators start at -8 * sum(qc) (plus kMagicBits
// where the magic conversion is exact), so the +8 of the packed nibbles
// comes off as in the mma.sync body, and its exactness argument holds
// unchanged: after any set of MMAs an accumulator's partial is at most
// 1,016 d < 2^31 in size for d < 2^21, in any order.
//
// What bounds it on an H100 (NVIDIA H100 SXM: 3.35 TB/s, 1,979 TOP/s int8):
// the bytes, at every shape the main path gives it. 1M x 384 reads 192 MB of
// packed codes and 8 MB of alpha and csq (0.060 ms) for every B <= 64,
// where the 2 B N d int8 operations take 0.025 ms even at B = 64. The
// 500,000 x 18,432 kNN-LM datastore reads 4.6 GB (1.38 ms) at every B; its
// 1.18 P int8 operations at B = 64 take 0.60 ms at the peak rate, which the
// mma.sync body missed by far (its warps issued the copies, ~25 cycles per
// warp MMA and the epilogue in turn: 2.13 ms). The design keeps the copies
// and the tensor cores busy at once:
//   - one producer warpgroup (setmaxnreg down to 40 registers) and two
//     consumer warpgroups (up to 232) a persistent block, each consumer
//     taking one 128-row group at a time as two m64 halves, so a group's
//     minimum never leaves its warpgroup;
//   - the groups are handed out at run time: each consumer's producer takes
//     the next group no consumer has taken (a global atomic counter a query
//     tile, which the launch's last producer leaves zero for the next
//     launch, so the host zeroes nothing a call). A static split left the
//     slowest consumer 18% behind the average at 1M x 384 B=1
//     (tools/probe_k2_body.py), and with it the last round: a static split
//     at 1M rows also leaves a partial round (7,813 groups over 264
//     consumers);
//   - each consumer has its own ring of 2-3 stages (3 read faster than 4
//     and 6 on an H100); one producer thread a ring keeps it full with TMA
//     copies (a box of 128 packed bytes x 128 rows,
//     CU_TENSOR_MAP_SWIZZLE_128B, zero-filled past ceil(d/2) and N)
//     completing on the stage's mbarrier, and waits on the stage's empty
//     barrier; the last chunk of a row runs only its k-steps up to
//     ceil(d/2) (d = 384: 2 of 4);
//   - the query tile (8/16/32/64 queries, wgmma's N) is copied by TMA
//     from qc itself, each row its two planes (codes [0, h) and [h, d)),
//     where d is even (a layout pass on the host, a few small ops, outlasted
//     the whole kernel at 1M x 384 B=1), else from the planes
//     ops/int4_scan.py:k2_wgmma_planes lays out; it is resident in shared
//     memory, copied once a block, where its planes take at most
//     ops/int4_scan.py:_K2_WGMMA_RESIDENT_BYTES (each consumer then sums
//     its codes for the bias), otherwise (kStream) each stage carries the
//     tile's two 128-byte plane chunks beside the rows' and the sums come
//     from the host;
//   - a resident tile's stage is handed back as soon as its MMAs are
//     issued (the rows are in registers), before they finish;
//   - the consumers run free: ping-pong (one consumer's MMAs beside the
//     other's epilogue, as K1's 16-bit tiles run) read slower at every
//     shape measured;
//   - alpha, csq and the mask byte of a group are loaded into registers
//     (one row a thread) as it starts, for its epilogue;
//   - the epilogue is k2_common.cuh:warp_minima, the mma.sync body's:
//     surrogate()'s operation order, dead rows as NaN terms that fminf
//     drops, a halving butterfly; then the group's minimum over its 4 warps.
//
// The TMA descriptors are built on the host for each launch
// (sm90_wgmma.cuh:encode_map3) and passed as __grid_constant__ parameters.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 (as
// ops/_build.py does; no --use_fast_math).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "k2_common.cuh"
#include "sm90_common.cuh"
#include "sm90_wgmma.cuh"

namespace {

constexpr int kChunk = 128;          // packed bytes of a row a ring step: one TMA box
constexpr int kThreads = 3 * 128;    // two consumer warpgroups, one producer
constexpr int kMaxStages = 3;
constexpr int kRowStage = kGroup * kChunk;  // a group's 128-byte column chunk
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// named barriers (0 is __syncthreads): a consumer's own (1, 2)
constexpr int kBarConsumer = 1;

// bytes of a ring stage: the group's rows chunk, then (kStream) the query
// tile's low and high plane chunks
template <int QT, bool kStream>
__host__ __device__ constexpr int stage_bytes() {
  return kRowStage + (kStream ? 2 * QT * kChunk : 0);
}

// One wgmma m64nNk32 .s32.u8.s8: A (u8) from registers, B (s8) through a
// shared-memory descriptor, D in registers (d[4 n + 2 h + e]: row g + 8 h of
// the warp's 16 rows, column 8 n + 2 t + e), accumulated onto (scale-d 1).
template <int N>
struct WgmmaU8S8;

template <>
struct WgmmaU8S8<8> {
  static __device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.u8.s8 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaU8S8<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaU8S8<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaU8S8<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <int NT>
__device__ __forceinline__ int (&flat(int (&acc)[NT][4]))[4 * NT] {
  return reinterpret_cast<int (&)[4 * NT]>(acc);
}

// The A fragments of the first KS 32-byte k-steps of one staged 128-byte
// chunk, for both m64 halves of the consumer's group: row g (+8) of the
// warp's 16 rows of each half, bytes 4 t and 16 + 4 t of the k-step
// (16-byte units 2 ks and 2 ks + 1, stored at unit ^ (row % 8) = unit ^ g by
// TMA's 128-byte swizzle), split into the low and the high nibbles.
template <int KS>
__device__ __forceinline__ void chunk_fragments(uint32_t (&lo)[4][2][4], uint32_t (&hi)[4][2][4],
                                                const unsigned char* rows, int w, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const unsigned char* r0 = rows + (m * 64 + 16 * w + g) * kChunk + 4 * t;
      const unsigned char* r1 = r0 + 8 * kChunk;
      const int u0 = ((2 * ks) ^ g) << 4;
      const int u1 = ((2 * ks + 1) ^ g) << 4;
      const uint32_t x[4] = {*reinterpret_cast<const uint32_t*>(r0 + u0),
                             *reinterpret_cast<const uint32_t*>(r1 + u0),
                             *reinterpret_cast<const uint32_t*>(r0 + u1),
                             *reinterpret_cast<const uint32_t*>(r1 + u1)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lo[ks][m][e] = x[e] & 0x0F0F0F0Fu;
        hi[ks][m][e] = (x[e] >> 4) & 0x0F0F0F0Fu;
      }
    }
}

// Issue the MMAs of the first KS k-steps of one chunk (each k-step: the low
// nibbles against the low plane, the high against the high plane, for each
// m64 half) into acc and commit them as one group. qlo: the chunk's low
// plane block of the query tile (QT rows of 128 bytes), the high plane's
// right after it.
template <int NT, int KS>
__device__ __forceinline__ void chunk_mmas(int (&acc)[2][NT][4], const uint32_t (&lo)[4][2][4],
                                           const uint32_t (&hi)[4][2][4], const unsigned char* qlo) {
  constexpr int QT = 8 * NT;
  const uint64_t blo = sw128_desc(qlo);
  const uint64_t bhi = sw128_desc(qlo + QT * kChunk);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int m = 0; m < 2; ++m) WgmmaU8S8<QT>::mma(flat(acc[m]), lo[ks][m], blo + 2 * ks);
#pragma unroll
    for (int m = 0; m < 2; ++m) WgmmaU8S8<QT>::mma(flat(acc[m]), hi[ks][m], bhi + 2 * ks);
  }
  wgmma_commit();
}

// One staged chunk of KS k-steps (the rest of the chunk lies past the row's
// end): its fragments, then its MMAs; a resident tile's stage is handed
// back once they are issued (the rows are in registers, the planes
// elsewhere), a streamed one's after they complete.
template <int NT, int KS, bool kStream>
__device__ __forceinline__ void chunk_step(int (&acc)[2][NT][4], uint32_t (&lo)[4][2][4],
                                           uint32_t (&hi)[4][2][4], const unsigned char* st,
                                           const unsigned char* qlo, uint32_t empty_bar, int w,
                                           int lane) {
  chunk_fragments<KS>(lo, hi, st, w, lane >> 2, lane & 3);
  chunk_mmas<NT, KS>(acc, lo, hi, qlo);
  if constexpr (!kStream) {
    // after the MMAs' issue: a branch between the fragments' loads and the
    // MMAs serialises the MMAs
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar);
  }
  wgmma_wait();
  fence_acc(acc);
  if constexpr (kStream) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar);
  }
}

// Each query's sum of codes over the resident tile (both planes, every
// chunk; the swizzle only permutes a row's 16-byte units), added into
// qsum[j] by a consumer's 128 threads (shared atomics).
template <int QT>
__device__ __forceinline__ void tile_sums(const unsigned char* qtile, int* qsum, int nchunks, int ltid) {
  for (int i = ltid; i < nchunks * 2 * QT * 8; i += 128) {
    const uint4 v = reinterpret_cast<const uint4*>(qtile)[i];  // row (i / 8) % QT of its block
    int sum = __dp4a(static_cast<int>(v.x), 0x01010101, 0);
    sum = __dp4a(static_cast<int>(v.y), 0x01010101, sum);
    sum = __dp4a(static_cast<int>(v.z), 0x01010101, sum);
    sum = __dp4a(static_cast<int>(v.w), 0x01010101, sum);
    atomicAdd(&qsum[(i >> 3) % QT], sum);
  }
}

// NT: 8-query column tiles (QT = 8 NT, wgmma's N). q_map: the query codes
// as [rows, 2 planes, pw] (plane 0 codes [0, h), plane 1 codes [h, d); qc
// itself where d is even and qc 16-byte aligned, pw = h, else
// ops/int4_scan.py:k2_wgmma_planes' copy, pw = 128 * ceil(h / 128)) as the
// 3-D map {pw, 2, rows}, boxes of 128 bytes x 1 x QT rows, zero past pw and
// the rows. kStream: the tile rides in each ring stage beside the rows,
// qsum_in holding each query's sum of codes; otherwise it is resident,
// copied once a block, and each consumer sums it. rows_map: the packed rows
// [N, h] as a 3-D map {h, N, 1}, boxes of 128 bytes x 128 rows. counters
// (zero at launch, and left zero): [0] the producers that have finished,
// [1 + qt] the next group of query tile qt that no consumer has taken.
// stages: ring stages a consumer (2-kMaxStages).
template <int NT, bool kStream>
__global__ void __launch_bounds__(kThreads, 1)
int4_wgmma_minima_kernel(const __grid_constant__ CUtensorMap rows_map,
                         const __grid_constant__ CUtensorMap q_map, const float* __restrict__ qscale,
                         const int* __restrict__ qsum_in, const float* __restrict__ alpha,
                         const int32_t* __restrict__ csq, const uint8_t* __restrict__ mask,
                         float* __restrict__ out, int* __restrict__ counters, int B, int N, int d, int valid,
                         int metric, int nqt, int stages) {
  constexpr int QT = 8 * NT;
  constexpr int kQBlock = QT * kChunk;  // one plane of one chunk of the query tile
  constexpr int kSB = stage_bytes<QT, kStream>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // TMA's 128-byte swizzle needs 1,024-byte aligned destinations
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int h = (d + 1) / 2;  // bytes per packed row
  const int nchunks = (h + kChunk - 1) / kChunk;
  const int last_ks = (h - (nchunks - 1) * kChunk + 31) / 32;  // k-steps of the last chunk
  // every dot within [-2^22, 2^22]: the magic conversion is exact
  // (k2_common.cuh:warp_minima)
  const bool small = d <= 4096;
  unsigned char* ring = smem;                       // [2 consumers][stages][kSB]
  unsigned char* qtile = ring + 2 * stages * kSB;   // [nchunks][2 planes][kQBlock] (not kStream)
  float* qs = reinterpret_cast<float*>(qtile + (kStream ? 0 : nchunks * 2 * kQBlock));  // [QT] qscale
  int* qsums = reinterpret_cast<int*>(qs + QT);     // [2 consumers][QT] sum(qc)
  float* wmins = reinterpret_cast<float*>(qsums + 2 * QT);  // [2 consumers][2][4][QT]
  int* gids = reinterpret_cast<int*>(wmins + 16 * QT);      // [2 consumers][kMaxStages]
  uint64_t* bars = reinterpret_cast<uint64_t*>(gids + 2 * kMaxStages);
  // full[2][kMaxStages], empty[2][kMaxStages], the resident tile's
  auto full = [&](int w, int s) { return smem_addr(bars + w * kMaxStages + s); };
  auto empty = [&](int w, int s) { return smem_addr(bars + (2 + w) * kMaxStages + s); };
  const uint32_t qbar = smem_addr(bars + 4 * kMaxStages);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qt = blockIdx.x % nqt;
  const int q0 = qt * QT;
  const int groups = (N + kGroup - 1) / kGroup;

  if (tid == 0) {
    for (int w = 0; w < 2; ++w)
      for (int s = 0; s < stages; ++s) {
        mbar_init(full(w, s), 1);
        mbar_init(empty(w, s), 4);  // one arrival a consumer warp
      }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 2 * QT) {
    // the streamed tile's sums from the host; the resident one's summed below
    const int j = tid % QT;
    qsums[tid] = kStream && q0 + j < B ? qsum_in[q0 + j] : 0;
    if (tid < QT) qs[j] = q0 + j < B ? qscale[q0 + j] : 0.0f;
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- the producer warpgroup: warp 8 feeds consumer 0, warp 9 consumer 1.
    // Each takes the next group of the query tile no consumer has taken
    // (consumers that run faster take more), writes its number beside the
    // stage of its first chunk, and ends its consumer's ring with -1.
    regs_dec<kProducerRegs>();
    if (warp < 10 && lane == 0) {
      const int w = warp - 8;
      if (!kStream && w == 0) {
        mbar_expect_tx(qbar, nchunks * 2 * kQBlock);
        for (int ch = 0; ch < nchunks; ++ch)
          for (int p = 0; p < 2; ++p)
            tma_load(smem_addr(qtile + (ch * 2 + p) * kQBlock), &q_map, qbar, ch * kChunk, p, q0);
      }
      for (int i = 0;;) {
        const int group = atomicAdd(counters + 1 + qt, 1);
        for (int ch = 0; ch < nchunks; ++ch, ++i) {
          const int s = i % stages;
          mbar_wait(empty(w, s), ((i / stages) & 1) ^ 1);
          if (ch == 0) gids[w * kMaxStages + s] = group < groups ? group : -1;
          if (group >= groups) {
            mbar_arrive(full(w, s));  // the end: no copy
            break;
          }
          mbar_expect_tx(full(w, s), kSB);
          unsigned char* st = ring + (w * stages + s) * kSB;
          tma_load(smem_addr(st), &rows_map, full(w, s), ch * kChunk, group * kGroup, 0);
          if constexpr (kStream) {
            for (int p = 0; p < 2; ++p)
              tma_load(smem_addr(st + kRowStage + p * kQBlock), &q_map, full(w, s), ch * kChunk, p, q0);
          }
        }
        if (group >= groups) break;
      }
      // the launch's last producer to finish leaves the counters zero for
      // the next launch on this stream (no other producer takes a group
      // after it has counted itself finished)
      __threadfence();
      if (atomicAdd(counters, 1) == 2 * static_cast<int>(gridDim.x) - 1) {
        for (int q = 0; q < nqt; ++q) counters[1 + q] = 0;
        counters[0] = 0;
      }
    }
  } else {
    // ---- a consumer warpgroup: the groups its producer takes
    regs_inc<kConsumerRegs>();
    const int wg = warp >> 2;
    const int w = warp & 3;  // warp of the warpgroup: rows 16 w .. of each m64 half
    const int ltid = tid & 127;
    const int t = lane & 3;
    int* qsum = qsums + wg * QT;
    float* wmin = wmins + wg * 8 * QT;  // [2][4][QT]
    // the lane's row of a group (warp_minima reads accumulator row (m, h, g)
    // from lane m * 16 + h * 8 + g)
    const int my_row = 16 * w + lane_row<64>(lane);
    if constexpr (!kStream) {
      mbar_wait(qbar, 0);
      tile_sums<QT>(qtile, qsum, nchunks, ltid);
    }
    bar_sync(kBarConsumer + wg, 128);  // qsum
    int acc[2][NT][4];
    uint32_t lo[4][2][4], hi[4][2][4];
    int i = 0;  // ring step
    for (int it = 0;; ++it) {
      mbar_wait(full(wg, i % stages), (i / stages) & 1);
      const int group = gids[wg * kMaxStages + i % stages];
      if (group < 0) break;
      // the lane's row's alpha, csq, mask byte (read only below valid) and
      // whether it is below valid, for the epilogue after the group's MMAs
      const long long row = static_cast<long long>(group) * kGroup + my_row;
      const bool pin = row < valid;
      const uint8_t pm = (pin && mask != nullptr) ? mask[row] : 1;
      const float pa = row < N ? alpha[row] : 0.0f;
      const int32_t pc = row < N ? csq[row] : 0;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // the -8 bias of the query's column, and kMagicBits (warp_minima)
            acc[m][n][e] = (small ? kMagicBits : 0) - 8 * qsum[n * 8 + 2 * t + (e & 1)];
          }
      for (int ch = 0; ch < nchunks; ++ch, ++i) {
        const int s = i % stages;
        if (ch > 0) mbar_wait(full(wg, s), (i / stages) & 1);
        const unsigned char* st = ring + (wg * stages + s) * kSB;
        const unsigned char* qlo = kStream ? st + kRowStage : qtile + ch * 2 * kQBlock;
        // the k-steps up to the row's end (the last chunk's may be fewer)
        switch (ch + 1 < nchunks ? 4 : last_ks) {
          case 1: chunk_step<NT, 1, kStream>(acc, lo, hi, st, qlo, empty(wg, s), w, lane); break;
          case 2: chunk_step<NT, 2, kStream>(acc, lo, hi, st, qlo, empty(wg, s), w, lane); break;
          case 3: chunk_step<NT, 3, kStream>(acc, lo, hi, st, qlo, empty(wg, s), w, lane); break;
          default: chunk_step<NT, 4, kStream>(acc, lo, hi, st, qlo, empty(wg, s), w, lane); break;
        }
      }

      // ---- epilogue of the group: surrogates, group minimum -------------------
      float* wm = wmin + (it & 1) * 4 * QT;  // two buffers: one barrier a group
      const bool ok = pin && pm != 0;
      if (small) {
        warp_surrogate_minima<NT, true>(acc, metric, pa, pc, ok, qs, wm, w, lane);
      } else {
        warp_surrogate_minima<NT, false>(acc, metric, pa, pc, ok, qs, wm, w, lane);
      }
      bar_sync(kBarConsumer + wg, 128);
      if (ltid < QT && q0 + ltid < B) {
        float mn = wm[ltid];
#pragma unroll
        for (int v = 1; v < 4; ++v) mn = fminf(mn, wm[v * QT + ltid]);
        out[static_cast<long long>(q0 + ltid) * groups + group] = mn;
      }
    }
  }
}

// ---- host side -------------------------------------------------------------

template <int NT, bool kStream>
int launch_tile(const void* queries, long long pw, const float* qscale, const int* qsum,
                const void* packed, const float* alpha, const int32_t* csq, const uint8_t* mask,
                float* out, int* counters, int B, int N, int d, int valid, int metric, cudaStream_t stream) {
  constexpr int QT = 8 * NT;
  constexpr int kSB = stage_bytes<QT, kStream>();
  const long long h = (d + 1) / 2;
  const long long nchunks = (h + kChunk - 1) / kChunk;
  const int nqt = (B + QT - 1) / QT;
  auto kernel = int4_wgmma_minima_kernel<NT, kStream>;
  static std::atomic<long long> fit[kMaxDevices];
  int dev = 0, sms = 0, smem_limit = 0, per_sm = 0;
  cudaError_t err = current_device(dev, sms, smem_limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the alignment slack, the resident query tile, the scales, sums and
  // the consumers' minima, the group numbers, the barriers; then as many
  // ring stages as fit, up to kMaxStages
  const long long fixed = 1024 + (kStream ? 0 : nchunks * 2 * QT * kChunk) + 19 * QT * 4 +
                          2 * kMaxStages * 4 + (4 * kMaxStages + 1) * 8;
  long long stages = (smem_limit - fixed) / (2LL * kSB);
  if (stages > kMaxStages) stages = kMaxStages;
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = fixed + 2 * stages * kSB;
  err = blocks_per_sm(reinterpret_cast<const void*>(kernel), kThreads, smem, dev, smem_limit, fit, per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the rows; the queries as [B, 2 planes, pw] (qc itself, pw = h = d / 2,
  // or the planes' copy; rows past B read zero, as in the copy's padding)
  CUtensorMap rows_map, q_map;
  int rc = encode_map3(&rows_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, packed, h, N, 1, kChunk, kGroup);
  if (rc == 0) rc = encode_map3(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, queries, pw, 2, B, kChunk, 1, QT);
  if (rc != 0) return rc;
  // blocks of one query tile take its groups; a tile's blocks are spread
  // over the grid (qt fastest)
  const int groups = (N + kGroup - 1) / kGroup;
  long long nslots = (static_cast<long long>(sms) * per_sm + nqt - 1) / nqt;
  if (nslots > (groups + 1) / 2) nslots = (groups + 1) / 2;
  if (nslots < 1) nslots = 1;
  if (nslots * nqt > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(nslots * nqt), kThreads, static_cast<int>(smem), stream>>>(
      rows_map, q_map, qscale, qsum, alpha, csq, mask, out, counters, B, N, d, valid, metric, nqt,
      static_cast<int>(stages));
  return static_cast<int>(cudaGetLastError());
}

template <bool kStream>
int launch(int query_tile, const void* queries, long long pw, const float* qscale, const int* qsum,
           const void* packed, const float* alpha, const int32_t* csq, const uint8_t* mask, float* out,
           int* counters, int B, int N, int d, int valid, int metric, cudaStream_t s) {
  switch (query_tile) {
    case 8:
      return launch_tile<1, kStream>(queries, pw, qscale, qsum, packed, alpha, csq, mask, out, counters, B,
                                     N, d, valid, metric, s);
    case 16:
      return launch_tile<2, kStream>(queries, pw, qscale, qsum, packed, alpha, csq, mask, out, counters, B,
                                     N, d, valid, metric, s);
    case 32:
      return launch_tile<4, kStream>(queries, pw, qscale, qsum, packed, alpha, csq, mask, out, counters, B,
                                     N, d, valid, metric, s);
    case 64:
      return launch_tile<8, kStream>(queries, pw, qscale, qsum, packed, alpha, csq, mask, out, counters, B,
                                     N, d, valid, metric, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The arguments of svt_int4_block_minima_mma (csrc/int4_minima_mma.cu) in
// its order up to query_tile (qc [B, d] int8, qscale [B] float32, packed
// [N, ceil(d/2)] uint8, alpha [N] float32, csq [N] int32, mask [N] uint8 or
// null, out [B, ceil(N/128)] float32, B, N, d, valid, metric, query_tile:
// 8, 16, 32 or 64); then planes: null to copy the query tile from qc itself
// (d even, qc 16-byte aligned: each row its two planes, codes [0, h) and
// [h, d)), else ops/int4_scan.py:k2_wgmma_planes' layout for this
// query_tile (int8 [ceil(B / query_tile) * query_tile, 2, 128 * ceil(h /
// 128)], 16-byte aligned, zero past each plane's end and past B); qsum:
// each query's sum of codes (int32 [B]) where the tile is streamed, else
// null; stream_queries: the tile rides in each ring stage beside the rows
// (else it is resident); counters: int32 [1 + ceil(B / query_tile)] or
// more, zero, the kernel's work counters, which it leaves zero (a buffer
// each stream may keep for its launches: launches on one stream run in
// turn). Takes packed
// rows TMA can copy (16-byte aligned, ceil(d/2) a multiple of 16) and d <
// 2^21; anything else, or a resident tile whose shared bytes do not fit the
// device, returns cudaErrorInvalidValue without launching
// (ops/int4_scan.py:k2_body routes such scans to the mma.sync body). A TMA
// descriptor the driver refuses returns 10,000 + its CUresult. Launches on
// `stream` and does not synchronise.
extern "C" int svt_int4_block_minima_wgmma(const void* qc, const void* qscale, const void* packed,
                                           const void* alpha, const void* csq, const void* mask,
                                           void* out, int B, int N, int d, int valid, int metric,
                                           int query_tile, const void* planes, const void* qsum,
                                           int stream_queries, void* counters, void* stream) {
  const long long h = (d + 1) / 2;
  if (B <= 0 || N <= 0 || d <= 0 || d >= (1 << 21) || valid < 0 || valid > N || metric < kL2 ||
      metric > kDot || !tma_ready(packed, h) || (stream_queries && qsum == nullptr) ||
      counters == nullptr || (planes == nullptr ? d % 2 != 0 || !tma_ready(qc, d) : !tma_ready(planes, 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the map's tensor and plane pitch
  const void* queries = planes == nullptr ? qc : planes;
  const long long pw = planes == nullptr ? h : (h + kChunk - 1) / kChunk * kChunk;
  const float* qs = static_cast<const float*>(qscale);
  const int* qm = static_cast<const int*>(qsum);
  const float* al = static_cast<const float*>(alpha);
  const int32_t* cs = static_cast<const int32_t*>(csq);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  int* nx = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stream_queries) {
    return launch<true>(query_tile, queries, pw, qs, qm, packed, al, cs, m, o, nx, B, N, d, valid, metric, s);
  }
  return launch<false>(query_tile, queries, pw, qs, qm, packed, al, cs, m, o, nx, B, N, d, valid, metric, s);
}
