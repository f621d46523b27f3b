#!/usr/bin/env python3
"""Smoke test of the PyTorch port (sqlite_vector_tpu_torch) on one CUDA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

On a machine of two or more cards, `python3 chip_smoke.py --cards` builds
the kernels and runs only phase 11's several-card part (phase_cards).

Phases, each printing its own lines:
  1. device   the card (nvidia-smi name and power limit), torch/CUDA versions
              and the TF32 flags, which are pinned off;
  2. build    compile K1's three bodies (csrc/block_minima_wgmma.cu on
              warpgroup MMA fed by TMA, csrc/block_minima_mma.cu on mma.sync,
              csrc/block_minima.cu on CUDA cores), the packed-int4 kernel
              K2's two bodies (csrc/int4_minima_wgmma.cu on warpgroup MMA
              fed by TMA, csrc/int4_minima_mma.cu on mma.sync) and the
              finish's two rescore kernels from csrc/ with nvcc,
              one process per source, and print what ptxas reported of each
              function (registers, stack, spills); no instance of a
              tensor-core body or of K1's L1 kernel may spill;
  3. kernel   K1 against its plain PyTorch twin on the card for every
              (metric x dtype) pair, in the body ops/block_scan.py:k1_body
              routes it to (the float dot family on the wgmma body where TMA
              takes the rows, else and for codes on the mma.sync body, L1 on
              K1's L1 kernel), the float dot family also on the mma.sync body
              and the 16-bit dot family also on the CUDA-core body,
              N = 100003 (ragged last group), d in {100, 384} (16-bit also
              6848, the widest row of the resident query tile),
              B in {1, 8, 33, 64, 65, 200} (query-tile edges), valid < N,
              with a NaN row, two duplicate rows and a zero row; then f32,
              f16 and bf16 rows and queries with +Inf, -Inf, values whose
              squared norms overflow, and 0 x Inf (tests/test_torch_kernel_cuda.py:
              nonfinite_case) under every metric, the float dot family also
              on the mma.sync body, the 16-bit one also on the CUDA-core
              body; then K2 against its twin
              for its four metrics, d in {95, 97, 384}, B in {1, 8, 33, 64,
              65, 200}, and d = 16,385 (the mma.sync body's query tile
              streamed; its streamed_launches printed), B in {1, 65},
              with a zero row, duplicate rows and rows scaled by 1e25
              (overflowing surrogates, one group entirely); each case also
              with the four row masks of tests/test_torch_kernel_cuda.py:
              mask_case (a random half, a group with no live row, every row
              masked, three live rows); each case in the body
              ops/int4_scan.py:k2_body routes it to (wgmma where TMA takes
              the packed rows: d = 95, 384; else mma.sync) and, where that
              is wgmma, also in the mma.sync body, the two equal bit for
              bit;
  4. main     VectorStore(device="cuda"): create dimension=384 FLOAT32 L2,
              add 1,000,000 rows, search(Q, 20) for 64 queries (half drawn
              from the base) against a plain-torch ground truth, then
              quantize() and search(Q, 20, exact=False) against the plain
              integer-domain scan of the same codes; K1's launch count over
              these searches must be above 0, every exact launch in its
              wgmma body and every quantized one in its mma.sync body;
              the quantized search's finish launches the codes' rescore
              kernel once a K1 scan, the exact search's the float one;
  5. times    K1 at the main path's shapes (f32, the int8 codes and u8 codes,
              and L2 over the rows cast to float16 and bfloat16, each at B=1
              and B=64), the routed body (floats: wgmma; codes: mma.sync),
              the mma.sync body (floats) and the CUDA-core body held against
              the twin and timed in turns (CUDA events, after warm-up) with
              the twin and the library yardstick (library_call;
              torch.matmul in 16 bits), beside its bound (k1_bound) and its
              share of it; then L1 over the f32 rows, the rows in float16
              and u8 codes on K1's L1 kernel, against the twin, its bound
              (k1_bound_cuda_core) and torch.cdist(p=1) where it takes the
              dtype; then end-to-end search at B=1 and B=64: QPS as all
              queries over the whole window of back-to-back calls, and the
              per-call latency p50, p99 and max; then exact and int8 search
              at B=1 with K1 in each body, in turns (body_latency); then
              FLOAT16 L2, FLOATB16 DOT and FLOAT32 L1 datasets of the same
              rows (phase_datasets): exact search for the 64 queries against
              the plain-torch ground truth (tie-aware), every K1 launch in
              its expected body, the same end-to-end times, and for 16-bit
              body_latency;
  6. int4     on the same rows: quantize(qtype="int4", refine=True), then
              search(Q, 20, mode="quantized") against the plain int4 tile
              loop over the same codes and search(Q, 20, mode="refine")
              against the refine rescore of that loop's candidates; K2's
              launch count over these searches must be above 0; int4 and
              refine recall@20 against exact are printed; every K2 launch
              must take its wgmma body;
  7. times    K2 at B=1 and B=64, its two bodies held against the twin,
              then timed (CUDA events): the twin apart, the routed (wgmma)
              body, the mma.sync body and the library
              yardstick (library_call_k2) in five rounds of turns (medians),
              beside its bound (k2_bound); then end-to-end int4-quantized
              and refine search at B=1 and B=64, measured as in phase 5,
              every K2 launch in its wgmma body, the query tile resident
              (streamed_launches printed, 0);
  8. mutate   on the same rows: remove 10,000 random ids (tombstones, below
              the compaction threshold); exact search at B=1 and B=64 and
              distances on 4 queries against the plain masked scan; an
              ids_filter of 100,000 random live ids in exact, approx (equal
              to exact bit for bit), int4 quantized, refine and rerank mode
              over phase 6's now stale int4 snapshot, each against its plain
              counterpart over the same mask; update 64 rows (each found at
              distance 0); compact() (results equal as id sets); then a
              fresh int8 quantize() and filtered quantized and rerank
              search, and unfiltered rerank, against their plain
              counterparts. K1's and K2's launch counts over the masked
              searches must be above 0, K2's all in its wgmma body.
              Times: remove, update and compact
              wall ms; masked exact search at B=1 and B=64 beside unmasked;
              filtered search at B=64 and the filter mask's build; rerank
              at B=1 and B=64; K1 and K2 alone masked against unmasked at
              B=64 (CUDA events, in turns); after compact, K1 alone at B=1
              in each body and exact B=1 search with each (body_latency).
  9. persist  save the compacted main dataset (shard_rows=250,000) and load
              it on the card: exact and int8 search at B=64 identical
              before and after, save/load seconds and GB/s; then
              save_stream 2,000,000 x 768 FLOAT32 rows from the seed in 8
              chunks (BASELINE.json config 5's width, its 10M rows cut to
              2M) and load that directory twice, storage="host" with
              mmap=True and storage="hbm" as the yardstick: exact search
              streamed from the memory maps at B=1 and B=64 against the
              plain-torch ground truth (tie-aware); quantize(checkpoint=)
              int8 bit-equal to the device build, then resumed with no
              chunk re-quantized; int8 and int4 search streamed through K1
              and K2 equal to after preload() and to the hbm load bit for
              bit; refine refused before preload(), equal after; rerank
              gathering rows from the memory maps; remove(1000) and exact
              search over the read-only mirror's tombstones. Every K1 and
              K2 launch of the streamed searches in its tensor-core body.
              Times: the pinned-copy ceiling, the host staging rate,
              streamed exact search at B=1 and B=64 and int8 likewise, one
              streamed pass's host -> device GB/s, the sweeps of the tile
              size (256 MiB, 512 MiB, 1 GiB) and of the staging threads (1,
              4, 8). The data lies in _smoke_data/, removed at the end.
 10. front    the SQL surface, serving, the CLI and the non-finite
              policies on phase 4's 1,000,000 x 384 FLOAT32 rows (the seed's
              generator again), written as blobs into a SQLite file in
              _smoke_data/ (removed at the end) and held against `ref`, a
              Dataset of the same rows: sqlite.connect() with no device
              (the card; the vtab must load; which loader filled the rows
              is printed, with the host walk of the native loader and of
              the sqlite3 row loop timed again), vector_init, then the
              reference's SQL verbatim:
              vector_full_scan for the 64 queries == ref.search(q, 20)
              (tie-aware, rtol 1e-5), K1 once a call on its tensor-core
              body; vector_quantize (int8), vector_quantize_preload and
              vector_quantize_scan bit-equal to ref's int8 search, and again
              from a second connection reading the shadow table; the same
              for qtype=INT4 through K2; both stream modules for one query
              (1,000,000 rows) == ref.distances(q) and (q, exact=False);
              1,000,000 x 384 float16 L2 and bfloat16 DOT rows with a NaN,
              +Inf or -Inf lane in 1% of the rows: exact search at B=1 and
              B=8 and distances at B=1 on the card == the same ops on the
              CPU (B=8 over the first 100,000 rows; rtol 1e-4); a
              BatchingSearcher (8 client threads x 64 queries x 8 rounds,
              exact and int8) == the direct search; a 10 s soak on a copy
              of the rows (a mutator adding, removing and re-quantizing,
              fallback_exact) with zero errors and device memory back
              within 1% after close(); serve() on 127.0.0.1 (16 POST
              /search == the direct search); the CLI's `search ... --json`
              in a subprocess == the SQL result. Times: the table's cold
              load, SQL vector_full_scan p50/p99 beside Dataset.search,
              vector_quantize and the shadow load, serving QPS and latency,
              HTTP p50, the policy search at B=1 and B=8.
 11. mesh     meshes on the card (parallel/): phase 4's 1,000,000 x 384
              FLOAT32 L2 rows (the seed's generator again) on a 4-shard 1-D
              mesh (4 shards on cuda:0), on a 1-shard mesh and on one
              device: exact, int4, int8 and rerank search at B=1 and B=64,
              k=20, unmasked, with a 100,000-id ids_filter and with 10,000
              tombstones, each == one device and == the 1-shard mesh (code
              scans bit-equal, exact rtol 3e-5, rerank 1e-5), int8 params
              and int4/int8 codes bit-equal to the one-device build, every
              search launching K1 or K2 once a shard on its tensor-core
              body and its merge gathering 8 * 4 * B * k bytes, refine
              refused; then inside phase 9, before its files go, the
              2,000,000 x 768 file loaded onto the 4-shard mesh with
              storage="hbm" and with storage="host", mmap=True: exact, int4
              and int8 at B=64 against phase 9's one-device load; then a
              2 x 2 (rows x dim) mesh: exact L2 at B=1 and B=64 against the
              plain-torch ground truth (tie-aware, rel_tol 1e-4), int8
              bit-equal, INT4 and host storage refused; with several cards,
              the first part and its times again on a mesh of one shard a
              card, and the rows with storage="host" streamed to every card
              at once (exact, int8, int4) against one device. Times: B=1
              p50 and B=64 QPS of the 4-shard mesh and one device in turns
              (host clock), K1 and K2 alone on one shard and on the whole
              rows, and the merge (CUDA events); the shards share one card,
              so these show the mesh's overhead, not a scaling. "launches"
              in phase 11 count the mesh datasets' own searches only.
 12. utils    utils/ on the card, over the main dataset as phase 8 left it
              (its live rows, int8 codes): timed_search with a
              StatsRecorder(capacity=256), 64 calls at B=1 and 10 at B=64,
              exact and int8, each call's ids and distances equal bit for
              bit to the same search, n_rows == len(ds), bytes_scanned
              len(ds) * 384 * 4 exact and * 1 quantized, summary()["count"]
              == the calls; its median and p99 printed beside phase 5's p50;
              on phase 11's 4-shard mesh, collective_bytes == 8 * 4 * B * k
              (40,960 at B=64) == the parallel.audit.GATHERED.merge delta;
              then quantize(qtype="int4") and a profile_trace into
              chip_smoke_trace/ beside this script (ignored by git; its
              .pt.trace.json opens in Perfetto) of 10 warm exact and 10 int4
              searches at B=64, each inside annotate("svt.search.exact") or
              annotate("svt.search.int4"): the trace must hold CUDA kernel
              events, as many K1 (mma_minima_kernel) and K2
              (int4_wgmma_minima_kernel) events as the launch counters
              counted, each launched inside its range (joined by
              correlation id) and starting after the range does; each
              range kind's device-busy share (the union of kernel, memcpy
              and memset intervals over the range's span) printed beside
              PERF.md §5's; then enable_persistent_cache(), which must be
              the directory the kernel library lies in.
 13. wide     rows past the widths whose query tile K1's tensor-core body
              keeps resident (ops/block_scan.py:mma_streams_queries):
              1,000,000 x 4,096 FLOAT32 N(0, 1) rows from SEED (the width
              of Qwen3-Embedding-8B, NV-Embed-v2 and e5-mistral-7b-instruct;
              no model loaded), added 100,000 at a time, and 64 queries,
              half from the base: exact search at B=1 and B=64 against the
              plain-torch ground truth (tie-aware), self-matches first at 0,
              K1 launched once a search, each on the wgmma body with the
              query tile streamed; K1 alone for L2, COSINE and DOT at B=1
              and B=64 against the twin, the mma.sync body and the
              CUDA-core body, timed in turns with them and torch.matmul
              beside k1_bound; K1
              against the finish (CUDA-event windows); exact search at B=1
              and B=64 (p50, and QPS) with K1 in each body, in turns
              (body_latency); int8 quantized
              and rerank search (printed only); then L2 over 200,000 x
              8,192 float16 rows (B=1, B=64) as K1 above, and u8 codes
              20,000 x 16,384 for L2, COSINE and DOT, both bodies equal to
              the twin bit for bit. Prints the peak device memory. The
              1M x 4,096 dataset goes on to phase 14.
 14. wide4    int4 where K2's wgmma body streams its query tile
              (ops/int4_scan.py:k2_wgmma_plan): phase 13's 1M x 4,096
              rows quantize(qtype="int4", refine=True), then int4-quantized
              and refine search at B=1 and B=64, k=20, against the plain
              int4 tile loop and the refine rescore of its candidates (as
              phase 6), recall@20 against phase 13's exact ids printed, K2's
              counters (zeroed before, read after) showing each launch on
              the wgmma body, streamed where the route says; K2 alone
              there and over 2 GB of codes at 8,192 and 16,384 columns: its
              two bodies bit-equal to the twin, timed in turns (CUDA
              events) with the mma.sync body,
              torch._int_mm on the unpacked codes (B=64) and, where a
              resident tile fits, the wgmma body's resident and streamed
              tile side by side, beside k2_bound; then a kNN-LM
              datastore shard keyed by Nemotron-4-340B's final hidden
              states: 500,000 x 18,432 FLOATB16 L2 N(0, 1) rows drawn on the
              card (18.4 GB), 64 queries, half from the base, exact search
              (self-matches first, each at exactly 0), the same int4
              and refine checks, every K2 launch streamed, the mma.sync
              body forced once and bit-equal, K2 alone as above and beside
              the finish (CUDA-event windows). Prints the peak device
              memory.
 15. rescore  (run after phase 3, before phase 4 makes its rows) the
              int8/u8 finish's rescore kernel (csrc/rescore_codes.cu) at
              the benchmark's shape: 10,000,000 x 768 int8 codes drawn on
              the card, COSINE, k=100, the groups K1's minima select for
              B in {1, 32, 64} queries (half copies of base rows): the
              kernel bit-equal to its twin (the gathered float64 path it
              replaced), also under L2, SQUARED_L2 and DOT with valid < N
              and a row mask at B=32, and over 1,000,000 x 768 u8 codes;
              then timed in turns with the twin (CUDA events) beside its
              bound (rescore_bound), and the whole finish on its route
              (one rescore launch) against the gathered route, equal and
              timed in turns;
 16. rescore_rows  (run after phase 15) the float finish's rescore kernel
              (csrc/rescore_rows.cu) at the float cell's shape: 5,000,000 x
              1,536 float32 rows drawn on the card (30.72 GB), COSINE,
              k=100, the groups K1's minima select for B in {1, 32, 64}
              queries (half copies of base rows): the kernel against its
              twin (the gathered float32 path it replaced; +inf at the same
              places, values within rtol 1e-5), also under L2, SQUARED_L2
              and DOT with valid < N and a row mask at B=32, and over
              1,000,000 x 1,536 float16 and bfloat16 rows; then timed in
              turns with the twin beside its bound (rescore_rows_bound), and
              the whole finish on its route (one rescore launch) against
              the gathered route, close and timed in turns.

Each phase ends with a line of its seconds. Then one JSON line of kernel results, one entry a kernel body (each with
its bound, the side that bounds it and the library yardstick; the three
float entries also the mma.sync body's ms as "mma_sync_ms"): K1's wgmma
body for f32 rows (main-path numbers f32 B=64; launches from phase 4's exact
search), K1's mma.sync body over the int8 codes (INT8 codes B=64; launches
from phase 4's quantized search), K1's wgmma body for 16-bit rows (L2 f16
B=64; launches from phase 5's FLOAT16 and FLOATB16 searches), K1's wgmma
body with the query tile streamed (f32 d=4096 B=64; launches from phase
13's two searches), K1's L1 kernel (L1 f32 B=64; launches from the FLOAT32 L1
search), K2's wgmma body (B=64), K2 past the resident query tile
(int4_block_minima_wide: bf16 d=18432 B=64; launches from phase 14's eight
searches), both K2 entries with the mma.sync body's ms as "mma_sync_ms",
the rescore kernel (int8 B=32; launches from phase 4's quantized search,
phase 15's under "timing_launches"), the float rescore kernel (f32 B=32;
launches from phase 4's exact search, phase 16's under "timing_launches");
the rest under "by_shape"; "sql_launches" counts phase 10's
launches on the SQL path, "mesh_launches" phase 11's, "trace_launches" the
kernel events in phase 12's trace; phase 10's times under
"frontends", phase 11's under "mesh"), the card
line again, and last the result line. Any failure raises, so the script exits non-zero and prints no
result; so does a machine without CUDA.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
N_MAIN = 1_000_000
DIM_MAIN = 384
K = 20
B_MAIN = 64
# phase 9's host-storage dataset: BASELINE.json config 5's width (768) with
# its 10,000,000 rows cut to 2,000,000 (a 6.1 GB file), written in chunks
N_HOST = 2_000_000
DIM_HOST = 768
CHUNK_HOST = 250_000
# streamed tile sizes (bytes) and staging thread counts of phase 9's sweeps
TILE_SWEEP = (256 << 20, 512 << 20, 1 << 30)
THREAD_SWEEP = (1, 4, 8)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call over `iters` calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns, iters: int, rounds: int = 1) -> list[float]:
    """Mean ms per call of each fn, measured in turns (f1..fn, then fn..f1,
    `rounds` times) after a warm-up of each: the median over the 2 x rounds
    passes (with one round, the mean of the two)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    passes = []
    for _ in range(rounds):
        passes.append([cuda_ms(fn, iters) for fn in fns])
        passes.append([cuda_ms(fn, iters) for fn in reversed(fns)][::-1])
    return [float(np.median([p[i] for p in passes])) for i in range(len(fns))]


# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W):
# HBM bytes per second, and operations per second by operand type on the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"tf32": 495e12, "int8": 1979e12, "fp16": 989e12}


def bound(nbytes: float, ops: float, peak: str) -> tuple[float, str]:
    """The least ms the card could take: the larger of the bytes over the
    HBM rate and the operations over the type's peak, and which of the two
    it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(b: int, n: int, d: int, elem: int, masked: bool = False) -> tuple[float, str]:
    """K1's bound for the dot-family metrics: queries and rows read once
    (plus a mask byte a row), the [B, ceil(N/128)] float32 minima written
    once; 2 B N d products, each three TF32 products for 4-byte rows (the
    3xTF32 split, the cheapest float32-accurate product on the card: 67
    TFLOP/s of float32 outside the tensor cores is slower), one 16-bit
    product for 2-byte rows (exact in f32) and one int8 product for 1-byte
    codes."""
    nbytes = (b + n) * d * elem + b * -(-n // 128) * 4 + (n if masked else 0)
    if elem == 4:
        return bound(nbytes, 3 * 2.0 * b * n * d, "tf32")
    return bound(nbytes, 2.0 * b * n * d, "fp16" if elem == 2 else "int8")


# The CUDA cores' instruction rates (NVIDIA H100 SXM: 132 SMs at 1.98 GHz,
# 128 FP32 and 64 INT32 lanes an SM): 67 TFLOP/s counts an FMA as two
# operations, so FP32 instructions issue at 33.5 T a second, INT32 ones at
# half that.
FP32_INSTR_PER_S = 33.5e12
INT_INSTR_PER_S = 16.75e12


def k1_bound_cuda_core(b: int, n: int, d: int, elem: int, signed: bool = False) -> tuple[float, str]:
    """K1's L1 bound (csrc/block_minima.cu:l1_minima_kernel; the tensor
    cores have no L1 form): the same bytes as k1_bound; for float rows two
    FP32 instructions a pair and column (FADD, then FADD with the |x|
    modifier) at FP32_INSTR_PER_S; for codes the instructions the body
    compiles to per 4 pairs (tools/k1_sass.py): u8 one (VABSDIFF4.U8.ACC,
    the add folded in), i8 two (VABSDIFF4 after a sign flip, then IDP.4A
    against 0x01010101), at INT_INSTR_PER_S (VABSDIFF4's issue rate is not
    published; the INT32 pipe's is taken)."""
    nbytes = (b + n) * d * elem + b * -(-n // 128) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if elem == 1:
        t_ops = (2.0 if signed else 1.0) * (b * n * d / 4) / INT_INSTR_PER_S * 1e3
    else:
        t_ops = 2.0 * b * n * d / FP32_INSTR_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_bound(b: int, n: int, d: int, masked: bool = False) -> tuple[float, str]:
    """K2's bound: packed codes (d/2 bytes a row), alpha and csq (4 bytes
    each a row), int8 query codes and their scales read once, the minima
    written once; 2 B N d int8 operations."""
    nbytes = n * (-(-d // 2) + 8) + b * (d + 4) + b * -(-n // 128) * 4 + (n if masked else 0)
    return bound(nbytes, 2.0 * b * n * d, "int8")


def rescore_bound(b: int, kg: int, d: int) -> tuple[float, str]:
    """The rescore kernel's bound (csrc/rescore_codes.cu) for b queries of
    kg groups each over d-wide codes: the query codes, the int64 group
    indices and the selected groups' codes (b kg 128 d bytes) read once,
    the float32 distances written once (b kg 128 4), over the HBM rate;
    against two dp4a a 4-byte word of codes (the dot and the row's square
    norm) on the INT32 pipe at INT_INSTR_PER_S."""
    cand = b * kg * 128
    t_bytes = (b * d + b * kg * 8 + cand * (d + 4)) / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * (cand * d / 4) / INT_INSTR_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rescore_rows_bound(b: int, kg: int, d: int, elem: int) -> tuple[float, str]:
    """The float rescore kernel's bound (csrc/rescore_rows.cu) for b
    queries of kg groups each over d-wide rows of elem bytes an element:
    the queries, the int64 group indices and the selected groups' rows (b
    kg 128 d elem bytes) read once, the float32 distances written once (b
    kg 128 4), over the HBM rate; against two FP32 FMAs an element (the
    dot family's dot and the row's square; L2 adds a subtraction) at
    FP32_INSTR_PER_S."""
    cand = b * kg * 128
    t_bytes = (b * d * elem + b * kg * 8 + cand * (d * elem + 4)) / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * cand * d / FP32_INSTR_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call_k2(qc: torch.Tensor, codes8: torch.Tensor):
    """One PyTorch call computing K2's products on the same inputs, timed as
    a yardstick and used nowhere in the port: torch._int_mm of the int8
    query codes with the codes unpacked once to int8 [N, d] (twice the
    packed bytes; no surrogate, no minima), where it takes the shape (more
    than 16 queries, d and N multiples of 8); None otherwise (B=1)."""
    if qc.shape[0] > 16 and qc.shape[1] % 8 == 0 and codes8.shape[0] % 8 == 0:
        return lambda: torch._int_mm(qc, codes8.T)
    return None


def library_call(q: torch.Tensor, base: torch.Tensor):
    """One PyTorch call computing K1's products on the same inputs, timed as
    a yardstick and used nowhere in the port: torch.matmul with TF32 off
    for float32, torch._int_mm for int8 where it takes the shape (more than
    16 queries, d and N multiples of 8); None otherwise (u8, i8 at B=1)."""
    if base.dtype is torch.float32:
        return lambda: torch.matmul(q, base.T)
    if base.dtype is torch.int8 and q.shape[0] > 16 and q.shape[1] % 8 == 0 and base.shape[0] % 8 == 0:
        return lambda: torch._int_mm(q, base.T)
    return None


def cdist_call(q: torch.Tensor, base: torch.Tensor):
    """One PyTorch call computing K1's L1 distances on the same inputs,
    timed as a yardstick and used nowhere in the port: torch.cdist(p=1),
    where it takes the dtype (it refuses integer codes); None otherwise."""
    if not base.dtype.is_floating_point:
        return None
    try:
        torch.cdist(q[:1], base[:2], p=1)
    except RuntimeError:
        return None
    return lambda: torch.cdist(q, base, p=1)


def make_rows(gen: torch.Generator, n: int, d: int, dtype: torch.dtype) -> torch.Tensor:
    dev = "cuda"
    if dtype is torch.uint8:
        return torch.randint(0, 256, (n, d), generator=gen, device=dev, dtype=torch.int32).to(dtype)
    if dtype is torch.int8:
        return torch.randint(-128, 128, (n, d), generator=gen, device=dev, dtype=torch.int32).to(dtype)
    return torch.randn((n, d), generator=gen, device=dev).to(dtype)


def compare_minima(
    q: torch.Tensor, base: torch.Tensor, metric, valid: int, label: str, mask=None, body=None
) -> float:
    """K1, in the body k1_body routes to (or `body`), against its twin on
    the same CUDA tensors: +inf and -inf positions equal, integer minima
    equal, float minima within 1e-5 of the magnitude each accumulates
    (tests/test_torch_kernel_cuda.py: minima_tolerance: the bodies differ
    from the twin's cuBLAS product by summation order, and the tensor-core
    body by the 3xTF32 split, whose dropped lo.lo' term is 2^-22 of each
    product). Returns max |kernel - twin| over the finite float minima (0
    for integers)."""
    from sqlite_vector_tpu_torch.ops.block_scan import (
        _launch_k1,
        block_minima,
        block_minima_reference,
    )

    if body is None:
        got = block_minima(q, base, metric, valid, mask)
    else:
        got = _launch_k1(q, base, metric, valid, mask, body)
    ref = block_minima_reference(q, base, metric, valid, mask)
    minima_tolerance = load_tests_module("test_torch_kernel_cuda").minima_tolerance
    torch.cuda.synchronize()
    check(got.shape == ref.shape, f"{label}: shape {got.shape} != {ref.shape}")
    check(torch.equal(torch.isposinf(got), torch.isposinf(ref)), f"{label}: +inf positions differ")
    check(torch.equal(torch.isneginf(got), torch.isneginf(ref)), f"{label}: -inf positions differ")
    check(not bool(torch.isnan(got).any()), f"{label}: NaN minima")
    if not base.dtype.is_floating_point:
        check(torch.equal(got, ref), f"{label}: integer minima differ")
        return 0.0
    fin = torch.isfinite(ref)
    err = (got.double() - ref.double()).abs()[fin]
    tol = minima_tolerance(q, base, metric, valid, ref)[fin]
    worst = float(err.max()) if err.numel() else 0.0
    check(bool((err <= tol).all()), f"{label}: max |kernel - twin| {worst} over tolerance")
    return worst


def check_nonfinite(n: int, masks=None) -> float:
    """K1 against its twin on tests/test_torch_kernel_cuda.py:nonfinite_case
    in float32, float16 and bfloat16 (bf16 keeps the overflowing norms, f16
    turns those rows into +-Inf) under every metric, unmasked and with each
    of `masks`, and for the 16-bit dot family also forced onto the CUDA-core
    body; DOT over group 30 reads -inf for query 2. Returns max |kernel -
    twin| over the finite minima."""
    from sqlite_vector_tpu_torch.ops.block_scan import block_minima
    from sqlite_vector_tpu_torch.types import DistanceMetric

    valid = n - 40
    worst = 0.0
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        q, base = load_tests_module("test_torch_kernel_cuda").nonfinite_case(n, "cuda", seed=SEED, dtype=dtype)
        for metric in DistanceMetric:
            for kind, mask in [("none", None), *(masks or {}).items()]:
                label = f"non-finite {dtype} {metric.value}/mask={kind}"
                worst = max(worst, compare_minima(q, base, metric, valid, label, mask))
            if dtype is not torch.float32 and metric is not DistanceMetric.L1:
                label = f"non-finite {dtype} {metric.value}, CUDA-core body"
                worst = max(worst, compare_minima(q, base, metric, valid, label, body="simt"))
            if metric is not DistanceMetric.L1:
                label = f"non-finite {dtype} {metric.value}, mma.sync body"
                worst = max(worst, compare_minima(q, base, metric, valid, label, body="mma"))
        dot = block_minima(q, base, DistanceMetric.DOT, valid)
        check(float(dot[2, 30]) == float("-inf"), f"{dtype}: DOT over a +Inf column does not read -inf")
        check(float(dot[6, 31]) == float("-inf"), f"{dtype}: DOT of -Inf against -Inf does not read -inf")
    return worst


def phase_kernel(card: str) -> tuple[float, float, float]:
    """K1 vs twin for all 25 (metric x dtype) pairs, unmasked and with each
    row mask, then the non-finite f32 case; returns the largest |kernel -
    twin| over finite float minima, unmasked, masked and non-finite (whose
    minima reach 1e37)."""
    from sqlite_vector_tpu_torch.types import DistanceMetric

    cuda_tests = load_tests_module("test_torch_kernel_cuda")
    n, valid = 100_003, 100_003 - 77
    masks = {kind: cuda_tests.mask_case(kind, n, "cuda", seed=SEED) for kind in cuda_tests.MASK_KINDS}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = masked_worst = 0.0
    cases = 0
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.float16, torch.bfloat16, torch.uint8, torch.int8):
        half = dtype in (torch.float16, torch.bfloat16)
        # 6,848: the widest 16-bit row of the resident query tile
        for d in (100, 384, 6848) if half else (100, 384):
            base = make_rows(gen, n, d, dtype)
            if dtype.is_floating_point:
                base[5] = torch.nan  # NaN row
            base[70_000] = base[10]  # duplicate rows
            base[200] = 0  # zero row
            for b in (1, 8, 33, 64, 65, 200):
                q = make_rows(gen, b, d, dtype)
                q[0] = base[10]  # a self-match
                for metric in DistanceMetric:
                    label = f"{metric.value}/{dtype}/d={d}/B={b}"
                    worst = max(worst, compare_minima(q, base, metric, valid, label))
                    if dtype.is_floating_point and metric is not DistanceMetric.L1:  # the other bodies
                        worst = max(worst, compare_minima(q, base, metric, valid, f"{label}/mma", body="mma"))
                        if half:
                            worst = max(worst, compare_minima(q, base, metric, valid, f"{label}/simt",
                                                              body="simt"))
                    for kind, mask in masks.items():
                        masked_worst = max(masked_worst, compare_minima(
                            q, base, metric, valid, f"{label}/mask={kind}", mask
                        ))
                cases += 1
            del base
    nonfinite_worst = check_nonfinite(n, masks)
    print(
        f"[kernel] K1 == twin on all 25 metric x dtype pairs ({cases} dtype/d/B "
        f"cases, d in 100, 384 and for 16-bit 6848, B in 1, 8, 33, 64, 65, 200, x 5 "
        f"metrics, routed (floats at TMA-legal widths on the wgmma body), the float dot family "
        f"also on the mma.sync body, the 16-bit one also on the CUDA-core body, N={n}, "
        f"valid={valid}; ints "
        f"equal, floats within 1e-5 of the accumulated magnitude); max |kernel - twin| "
        f"= {worst!r}; masked ({len(masks)} row masks each: {', '.join(masks)}): max "
        f"|kernel - twin| = {masked_worst!r}, +inf groups equal; non-finite f32, f16 and "
        f"bf16 rows and queries (+Inf, -Inf, overflowing norms, 0 x Inf) under every metric, unmasked "
        f"and masked: +-inf positions equal, max |kernel - twin| = {nonfinite_worst!r}; "
        f"in {time.perf_counter() - t0:.1f} s | {card}",
        flush=True,
    )
    return worst, masked_worst, nonfinite_worst


@functools.cache
def load_tests_module(name: str, folder: str = "tests"):
    """The repo's tests/<name>.py (or <folder>/<name>.py), loaded by path:
    an installed package named `tests` or `tools` may shadow the repo's
    directory."""
    spec = importlib.util.spec_from_file_location(
        f"svt_{name}", Path(__file__).resolve().parent / folder / f"{name}.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def compare_int4_minima(args, metric, valid: int, label: str, mask=None) -> float:
    """K2, in the body k2_body routes to and forced onto the mma.sync body
    where the route takes the wgmma body (the wgmma body takes only rows TMA
    copies; the mma.sync body takes every scan), against its twin on the
    same CUDA tensors: +inf positions equal and finite minima EQUAL
    (tolerance 0): both take the exact integer dot and then the same float32
    epilogue, each op rounded once in the same order (__fmul_rn/__fsub_rn
    and a correctly rounded 1/sqrt in the kernel, one torch op per step in
    the twin); the bodies equal bit for bit. Returns max |kernel - twin|
    over the finite minima."""
    from sqlite_vector_tpu_torch.ops.block_scan import tma_ready
    from sqlite_vector_tpu_torch.ops.int4_scan import (
        _launch_k2,
        int4_block_minima,
        int4_block_minima_reference,
        k2_body,
    )

    routed = k2_body(args[0].shape[1], tma_ready(args[2]))
    got = {routed: int4_block_minima(*args, metric, valid, mask)}
    if "mma" not in got:
        got["mma"] = _launch_k2(*args, metric, valid, mask, "mma")
    ref = int4_block_minima_reference(*args, metric, valid, mask)
    torch.cuda.synchronize()
    fin = torch.isfinite(ref)
    worst = 0.0
    for body, minima in got.items():
        where = f"{label} ({body} body)"
        check(minima.shape == ref.shape, f"{where}: shape {minima.shape} != {ref.shape}")
        check(not bool(torch.isnan(minima).any()), f"{where}: NaN minima")
        check(torch.equal(torch.isinf(minima), torch.isinf(ref)), f"{where}: inf positions differ")
        err = float((minima[fin] - ref[fin]).abs().max()) if bool(fin.any()) else 0.0
        check(torch.equal(minima[fin], ref[fin]), f"{where}: max |kernel - twin| {err}")
        worst = max(worst, err)
    for body, minima in got.items():
        check(torch.equal(minima.view(torch.int32), got["mma"].view(torch.int32)),
              f"{label}: the {body} and mma.sync bodies differ in some bit")
    return worst


def phase_kernel_int4(card: str) -> tuple[float, float]:
    """K2 (both bodies where both take the codes) vs twin for its 4 metrics x d
    in {95, 97, 384} x B in {1, 8, 33, 64, 65, 200}, and d = 16,385 (the
    mma.sync body's query tile streamed) x B in {1, 65}, unmasked and with
    each row mask; returns the largest |kernel - twin| over finite minima,
    unmasked and masked."""
    from sqlite_vector_tpu_torch.ops.int4_scan import int4_block_minima, k2_body, k2_streams_queries
    from sqlite_vector_tpu_torch.types import DistanceMetric

    # the card tests' edge cases: zero row, duplicates, 1e25-scaled rows
    cuda_tests = load_tests_module("test_torch_kernel_cuda")
    int4_case = cuda_tests.int4_case
    n, valid = 100_003, 100_003 - 77
    masks = {kind: cuda_tests.mask_case(kind, n, "cuda", seed=SEED + 1) for kind in cuda_tests.MASK_KINDS}
    metrics = [m for m in DistanceMetric if m is not DistanceMetric.L1]
    worst = masked_worst = 0.0
    t0 = time.perf_counter()
    batches = (1, 8, 33, 64, 65, 200)
    int4_block_minima.streamed_launches = 0
    for d, bs in ((95, batches), (97, batches), (384, batches), (16385, (1, 65))):
        want_body = "wgmma" if d in (95, 384) else "mma"
        check(k2_body(d) == want_body, f"K2 at d={d} routes to its {k2_body(d)} body, not {want_body}")
        for b in bs:
            args, _ = int4_case(n, d, b, "cuda", seed=SEED + 2 + d + b)
            for metric in metrics:
                label = f"K2 {metric.value}/d={d}/B={b}"
                worst = max(worst, compare_int4_minima(args, metric, valid, label))
                for kind, mask in masks.items():
                    masked_worst = max(masked_worst, compare_int4_minima(
                        args, metric, valid, f"{label}/mask={kind}", mask
                    ))
                if b > 1 and metric is DistanceMetric.L2:
                    # group 1 against the scaled query: NaN or +inf throughout
                    m = int4_block_minima(*args, metric, valid)
                    check(float(m[-1, 1]) == float("inf"), f"{label}: overflowing group not +inf")
            del args
    want = sum(4 * (1 + len(masks)) + (b > 1) for b in (1, 65) if k2_streams_queries(16385, b))
    check(int4_block_minima.streamed_launches == want,
          f"K2 at d=16385 streamed {int4_block_minima.streamed_launches} launches, not {want}")
    print(
        f"[kernel] K2 == twin for {len(metrics)} metrics x d in (95, 97, 384) x B in "
        f"{batches} and d=16385 x B in (1, 65) (N={n}, valid={valid}, zero/duplicate/1e25-scaled "
        f"rows; +inf positions equal, finite minima equal), the routed body (wgmma at d=95 and "
        f"384, mma.sync at 97 and 16385) and, where that is wgmma, the mma.sync body, equal bit "
        f"for bit; max |kernel - twin| = "
        f"{worst!r}; masked ({len(masks)} row masks each): max |kernel - twin| = "
        f"{masked_worst!r}; streamed_launches {int4_block_minima.streamed_launches} (all at "
        f"d=16385); in {time.perf_counter() - t0:.1f} s | {card}",
        flush=True,
    )
    return worst, masked_worst


N_RESCORE = 10_000_000
DIM_RESCORE = 768
K_RESCORE = 100
B_RESCORE = 32


def random_codes(gen: torch.Generator, n: int, d: int, dtype: torch.dtype) -> torch.Tensor:
    """n x d uniform u8 or i8 codes drawn on the card a million rows at a
    time (make_rows draws all of them as int32 at once)."""
    lo, hi = (0, 256) if dtype is torch.uint8 else (-128, 128)
    out = torch.empty((n, d), dtype=dtype, device="cuda")
    for s in range(0, n, 1_000_000):
        e = min(s + 1_000_000, n)
        out[s:e] = torch.randint(lo, hi, (e - s, d), generator=gen, device="cuda", dtype=torch.int32)
    return out


def phase_rescore(card: str) -> dict:
    """Phase 15: the rescore kernel against its twin and timed, at the
    benchmark's shape (the module docstring says what). Returns, by label,
    the kernel's and the twin's ms with the bound, the finish's on each
    route, the kernel's launches here under "timing_launches" and the
    largest |kernel - twin| over the finite distances under
    "max_abs_err"."""
    from sqlite_vector_tpu_torch.ops import block_scan as bs
    from sqlite_vector_tpu_torch.types import DistanceMetric

    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    n, d, k = N_RESCORE, DIM_RESCORE, K_RESCORE
    codes = random_codes(gen, n, d, torch.int8)
    mask = torch.rand(n, generator=gen, device="cuda") < 0.5
    cos = DistanceMetric.COSINE
    out = {"max_abs_err": 0.0}
    launches = bs.rescore_groups.launches

    def queries(base: torch.Tensor, b: int) -> torch.Tensor:
        q = random_codes(gen, b, d, base.dtype)
        near = b // 2
        q[:near] = base[torch.randint(0, base.shape[0], (near,), generator=gen, device="cuda")]
        return q

    def same(label: str, q, base, gidx, valid, metric, row_mask=None) -> None:
        got = bs.rescore_groups(q, base, gidx, valid, metric, row_mask)
        want = bs.rescore_groups_reference(q, base, gidx, valid, metric, row_mask)
        finite = torch.isfinite(want)
        check(torch.equal(finite, torch.isfinite(got)), f"rescore {label}: +inf positions differ")
        err = float((got[finite] - want[finite]).abs().max()) if bool(finite.any()) else 0.0
        out["max_abs_err"] = max(out["max_abs_err"], err)
        check(torch.equal(got, want), f"rescore {label}: kernel != twin (max |diff| {err!r})")

    for b in (1, B_RESCORE, 64):
        q = queries(codes, b)
        minima = bs.block_minima(q, codes, cos, n)
        gidx = bs.select_groups(minima, k)
        kg = gidx.shape[1]
        label = f"int8 B={b}"
        same(f"{label} COSINE", q, codes, gidx, n, cos)
        if b == B_RESCORE:
            for metric in (DistanceMetric.L2, DistanceMetric.SQUARED_L2, DistanceMetric.DOT, cos):
                same(f"{label} {metric.value} valid<N masked", q, codes, gidx, n - 1000, metric, mask)

        def gathered():
            return bs.finish_groups(minima, k, lambda s, e, g, pos: bs.rescore_groups_reference(q[s:e], codes, g, n, cos))

        def routed():
            return bs.finish_groups(minima, k, lambda s, e, g, pos: bs.rescore_groups(q[s:e], codes, g, n, cos))

        before = bs.rescore_groups.launches
        bs._finish_from_minima(minima, q, codes, n, cos, k)
        check(bs.rescore_groups.launches == before + 1, f"rescore {label}: the finish did not launch the kernel once")
        got, want = routed(), gathered()
        check(all(torch.equal(g, w) for g, w in zip(got, want)), f"rescore {label}: the finish's routes differ")
        iters = 20 if b == 1 else 10
        ms = in_turns([lambda: bs.rescore_groups_reference(q, codes, gidx, n, cos),
                       lambda: bs.rescore_groups(q, codes, gidx, n, cos)], iters)
        fin = in_turns([gathered, routed], iters)
        lim, by = rescore_bound(b, kg, d)
        out[label] = {"ms": ms[1], "plain_ms": ms[0], "bound_ms": lim, "bound_by": by,
                      "finish_ms": fin[1], "gathered_finish_ms": fin[0], "library_ms": None}
        print(
            f"[times] rescore {n}x{d} {label} COSINE k={k} (kernel == twin): kernel {ms[1]!r} ms, "
            f"bound {lim!r} ms ({by}), {100 * lim / ms[1]:.1f}% of bound; twin (the gathered float64 "
            f"path it replaced) {ms[0]!r} ms; finish on its route {fin[1]!r} ms, gathered {fin[0]!r} ms "
            f"| {card}",
            flush=True,
        )
    del codes, mask
    u8 = random_codes(gen, 1_000_000, d, torch.uint8)
    q = queries(u8, B_RESCORE)
    gidx = bs.select_groups(bs.block_minima(q, u8, cos, u8.shape[0]), k)
    for metric in (DistanceMetric.L2, DistanceMetric.SQUARED_L2, DistanceMetric.DOT, cos):
        same(f"u8 B={B_RESCORE} {metric.value}", q, u8, gidx, u8.shape[0], metric)
    del u8
    out["timing_launches"] = bs.rescore_groups.launches - launches
    return out


N_RESCORE_ROWS = 5_000_000
DIM_RESCORE_ROWS = 1536


def phase_rescore_rows(card: str) -> dict:
    """Phase 16: the float rescore kernel against its twin and timed, at
    the float cell's shape (the module docstring says what). Returns, by
    label, the kernel's and the twin's ms with the bound, the finish's on
    each route, the kernel's launches here under "timing_launches" and the
    largest |kernel - twin| over the finite distances under
    "max_abs_err"."""
    from sqlite_vector_tpu_torch.ops import block_scan as bs
    from sqlite_vector_tpu_torch.types import DistanceMetric

    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    n, d, k = N_RESCORE_ROWS, DIM_RESCORE_ROWS, K_RESCORE
    rows = torch.empty((n, d), dtype=torch.float32, device="cuda")
    for s in range(0, n, 500_000):
        rows[s : s + 500_000] = torch.randn((min(500_000, n - s), d), generator=gen, device="cuda")
    mask = torch.rand(n, generator=gen, device="cuda") < 0.5
    cos = DistanceMetric.COSINE
    out = {"max_abs_err": 0.0}
    launches = bs.rescore_groups.launches

    def queries(base: torch.Tensor, b: int) -> torch.Tensor:
        q = torch.randn((b, base.shape[1]), generator=gen, device="cuda").to(base.dtype)
        near = b // 2
        q[:near] = base[torch.randint(0, base.shape[0], (near,), generator=gen, device="cuda")]
        return q

    def close(label: str, q, base, gidx, valid, metric, row_mask=None) -> None:
        # float32 sums in another order than the twin's: the card tests'
        # tolerance (tests/test_torch_kernel_cuda.py:assert_float_rescore_close)
        got = bs.rescore_groups(q, base, gidx, valid, metric, row_mask)
        want = bs.rescore_groups_reference(q, base, gidx, valid, metric, row_mask)
        finite = torch.isfinite(want)
        check(torch.equal(torch.isposinf(want), torch.isposinf(got)), f"rescore {label}: +inf positions differ")
        err = float((got[finite] - want[finite]).abs().max()) if bool(finite.any()) else 0.0
        out["max_abs_err"] = max(out["max_abs_err"], err)
        atol = 1e-5 if metric is cos else 1e-3
        check(torch.allclose(got[finite], want[finite], rtol=1e-5, atol=atol),
              f"rescore {label}: kernel != twin (max |diff| {err!r})")

    for b in (1, B_RESCORE, 64):
        q = queries(rows, b)
        minima = bs.block_minima(q, rows, cos, n)
        gidx = bs.select_groups(minima, k)
        kg = gidx.shape[1]
        label = f"f32 B={b}"
        close(f"{label} COSINE", q, rows, gidx, n, cos)
        if b == B_RESCORE:
            for metric in (DistanceMetric.L2, DistanceMetric.SQUARED_L2, DistanceMetric.DOT, cos):
                close(f"{label} {metric.value} valid<N masked", q, rows, gidx, n - 1000, metric, mask)

        def gathered():
            return bs.finish_groups(minima, k, lambda s, e, g, pos: bs.rescore_groups_reference(q[s:e], rows, g, n, cos))

        def routed():
            return bs.finish_groups(minima, k, lambda s, e, g, pos: bs.rescore_groups(q[s:e], rows, g, n, cos))

        before = bs.rescore_groups.launches
        bs._finish_from_minima(minima, q, rows, n, cos, k)
        check(bs.rescore_groups.launches == before + 1, f"rescore {label}: the finish did not launch the kernel once")
        (gv, gi), (wv, wi) = routed(), gathered()
        check(torch.equal(torch.isposinf(gv), torch.isposinf(wv))
              and torch.allclose(gv[torch.isfinite(wv)], wv[torch.isfinite(wv)], rtol=1e-5, atol=1e-5),
              f"rescore {label}: the finish's routes differ in value")
        iters = 20 if b == 1 else 5
        ms = in_turns([lambda: bs.rescore_groups_reference(q, rows, gidx, n, cos),
                       lambda: bs.rescore_groups(q, rows, gidx, n, cos)], iters)
        fin = in_turns([gathered, routed], iters)
        lim, by = rescore_rows_bound(b, kg, d, 4)
        out[label] = {"ms": ms[1], "plain_ms": ms[0], "bound_ms": lim, "bound_by": by,
                      "finish_ms": fin[1], "gathered_finish_ms": fin[0], "library_ms": None}
        print(
            f"[times] rescore {n}x{d} {label} COSINE k={k} (kernel ~ twin): kernel {ms[1]!r} ms, "
            f"bound {lim!r} ms ({by}), {100 * lim / ms[1]:.1f}% of bound; twin (the gathered float32 "
            f"path it replaced) {ms[0]!r} ms; finish on its route {fin[1]!r} ms, gathered {fin[0]!r} ms "
            f"| {card}",
            flush=True,
        )
    del rows, mask
    for dtype in (torch.float16, torch.bfloat16):
        half = torch.randn((1_000_000, d), generator=gen, device="cuda").to(dtype)
        q = queries(half, B_RESCORE)
        gidx = bs.select_groups(bs.block_minima(q, half, cos, half.shape[0]), k)
        for metric in (DistanceMetric.L2, DistanceMetric.SQUARED_L2, DistanceMetric.DOT, cos):
            close(f"{dtype} B={B_RESCORE} {metric.value}", q, half, gidx, half.shape[0], metric)
        del half
    out["timing_launches"] = bs.rescore_groups.launches - launches
    return out


def phase_main(card: str):
    import sqlite_vector_tpu_torch as svt
    from sqlite_vector_tpu_torch.ops import rerank
    from sqlite_vector_tpu_torch.ops.block_scan import block_minima, rescore_groups
    from sqlite_vector_tpu_torch.ops.distance import pairwise_distance
    from sqlite_vector_tpu_torch.ops.quantize import quantize_device
    from sqlite_vector_tpu_torch.ops.scan import scan_topk

    parity = load_tests_module("parity")  # the repo's tie-aware top-k check
    REL_TOL_BY_TYPE, assert_topk_parity = parity.REL_TOL_BY_TYPE, parity.assert_topk_parity

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    store = svt.VectorStore(device="cuda")
    ds = store.create("main", "dimension=384,type=FLOAT32,distance=L2")
    chunk = 100_000
    for _ in range(N_MAIN // chunk):
        ds.add(rng.standard_normal((chunk, DIM_MAIN), dtype=np.float32))
    torch.cuda.synchronize()
    check(len(ds) == N_MAIN, f"dataset holds {len(ds)} rows")
    ids_all = ds.ids
    picks = rng.choice(N_MAIN, B_MAIN // 2, replace=False)
    Q = np.concatenate(
        [ds.get(ids_all[picks]), rng.standard_normal((B_MAIN - B_MAIN // 2, DIM_MAIN), dtype=np.float32)]
    )
    t_add = time.perf_counter() - t0
    print(
        f"[main] added {len(ds)} x {DIM_MAIN} FLOAT32 rows in {t_add:.1f} s "
        f"(host data generation included); device bytes {ds.memory_bytes()} | {card}",
        flush=True,
    )

    # -- exact -----------------------------------------------------------
    zero_counts()
    ids_e, d_e = ds.search(Q, K)
    launches = {"wgmma": block_minima.launches}
    check(launches["wgmma"] > 0, "exact search did not launch K1")
    check(block_minima.body_launches == {"wgmma": launches["wgmma"], "mma": 0, "simt": 0},
          f"exact search left K1's wgmma body: {block_minima.body_launches}")
    # each K1 scan's finish rescores with the float rescore kernel in one
    # query chunk: the [B, K*128] distances are within the finish's bound
    check(B_MAIN * K * 128 <= rerank.RESCORE_CHUNK_ELEMS, "the main finish needs query chunks")
    launches["rescore_rows"] = rescore_groups.launches
    check(launches["rescore_rows"] == launches["wgmma"],
          f"exact search launched the rescore kernel {launches['rescore_rows']} times, K1 {launches['wgmma']}")
    vecs = ds._vectors[: len(ds)]
    Qd = torch.from_numpy(Q).cuda()
    oracle = pairwise_distance(Qd, vecs, svt.DistanceMetric.L2).cpu().numpy()
    for i in range(B_MAIN):
        assert_topk_parity(
            *top_rows(ids_all, oracle[i]), ids_e[i], d_e[i], K,
            rel_tol=REL_TOL_BY_TYPE["FLOAT32"], label=f"exact q{i}",
        )
    for i, p in enumerate(picks):
        check(ids_e[i, 0] == ids_all[p] and d_e[i, 0] == 0.0, f"q{i}: self-match not first at 0")
    print(
        f"[main] exact search(Q[{B_MAIN}], {K}): ids match the plain-torch ground "
        f"truth (tie-aware, rel_tol {REL_TOL_BY_TYPE['FLOAT32']}), {len(picks)}/"
        f"{len(picks)} self-matches first at 0.0, K1 launches {launches['wgmma']}, all on its wgmma "
        f"body; rescore kernel launches {launches['rescore_rows']} | {card}",
        flush=True,
    )

    # -- quantized -------------------------------------------------------
    t0 = time.perf_counter()
    ds.quantize()
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    qt, scale, offset = ds.quant_params
    zero_counts()
    ids_q, d_q = ds.search(Q, K, exact=False)
    launches["mma"] = block_minima.launches
    check(launches["mma"] > 0, "quantized search did not launch K1")
    check(block_minima.body_launches == {"wgmma": 0, "mma": launches["mma"], "simt": 0},
          f"quantized search left K1's mma.sync body: {block_minima.body_launches}")
    # and the quantized search's with the codes' rescore kernel
    launches["rescore"] = rescore_groups.launches
    check(launches["rescore"] == launches["mma"],
          f"quantized search launched the rescore kernel {launches['rescore']} times, K1 {launches['mma']}")
    codes = ds._quant.codes
    qq = quantize_device(Qd, scale, offset, qt)
    gv, gi = scan_topk(qq, codes, svt.DistanceMetric.L2, K)
    gi = gi.cpu().numpy()
    want_ids = np.where(gi >= 0, ids_all[np.clip(gi, 0, None)], -1)
    check(np.array_equal(ids_q, want_ids), "quantized ids differ from the plain integer-domain scan")
    check(np.array_equal(d_q, gv.cpu().numpy()), "quantized distances differ from the plain scan")
    recall = float(np.mean([len(set(ids_q[i]) & set(ids_e[i])) / K for i in range(B_MAIN)]))
    print(
        f"[main] quantize() -> {qt.value} scale={float(scale)!r} offset={float(offset)!r} "
        f"in {t_quant:.2f} s; search(Q[{B_MAIN}], {K}, exact=False) ids and distances "
        f"equal to the plain integer-domain scan of the same codes; recall@{K} vs exact = "
        f"{recall!r}; K1 launches {launches['mma']}, all on its mma.sync body; rescore kernel "
        f"launches {launches['rescore']} | {card}",
        flush=True,
    )
    return ds, Q, ids_e, launches


# K1's times at the main path's shapes as PERF.md §6 records them (ms, on
# an NVIDIA H100 80GB HBM3 at 700.00 W), printed beside phase 5's
PERF6_K1_MS = {
    "f32 B=1": 0.5212168, "f32 B=64": 0.7365184, "INT8 codes B=1": 0.1503424,
    "INT8 codes B=64": 0.2157312, "u8 B=1": 0.1520720, "u8 B=64": 0.2123024,
    "L2 f16 B=1": 0.2591296, "L2 f16 B=64": 0.2954480, "L2 bf16 B=1": 0.2576496,
    "L2 bf16 B=64": 0.2948592,
}


def phase_times(card: str, ds, Q) -> dict:
    """K1 at the main path's shapes (f32, the int8 codes and u8 codes, each
    at B=1 and B=B_MAIN), every body that takes the shape held against the
    twin, then timed in turns with the twin, the other bodies and the
    library yardstick, beside its bound; then end-to-end search. Returns, by
    label, the kernel's (routed), the twin's, the mma.sync body's (floats),
    the CUDA-core body's and the library's ms with the bound, and the
    largest |kernel - twin| seen here under "max_abs_err"."""
    from sqlite_vector_tpu_torch.ops.block_scan import (
        _launch_k1,
        block_minima,
        block_minima_reference,
        k1_body,
    )
    from sqlite_vector_tpu_torch.ops.quantize import quantize_device
    from sqlite_vector_tpu_torch.types import DistanceMetric

    L2 = DistanceMetric.L2
    vecs = ds._vectors[: len(ds)]
    Qd = torch.from_numpy(Q).cuda()
    n = vecs.shape[0]
    shape = f"{n}x{DIM_MAIN}"
    qt, scale, offset = ds.quant_params
    codes_q = quantize_device(Qd, scale, offset, qt)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    u8_base = make_rows(gen, n, DIM_MAIN, torch.uint8)
    u8_q = make_rows(gen, B_MAIN, DIM_MAIN, torch.uint8)
    out = {"max_abs_err": 0.0}
    for label, q, base in (
        ("f32 B=1", Qd[:1].contiguous(), vecs),
        (f"f32 B={B_MAIN}", Qd, vecs),
        (f"{qt.value} codes B=1", codes_q[:1].contiguous(), ds._quant.codes),
        (f"{qt.value} codes B={B_MAIN}", codes_q, ds._quant.codes),
        ("u8 B=1", u8_q[:1].contiguous(), u8_base),
        (f"u8 B={B_MAIN}", u8_q, u8_base),
    ):
        b = q.shape[0]
        routed = k1_body(base.dtype, L2, DIM_MAIN)
        check(routed == ("wgmma" if base.dtype is torch.float32 else "mma"),
              f"{label} routes to K1's {routed} body")
        out["max_abs_err"] = max(out["max_abs_err"], compare_minima(q, base, L2, n, f"main-path {label}"))
        compare_minima(q, base, L2, n, f"main-path {label}, CUDA-core body", body="simt")
        fns = [
            lambda: block_minima_reference(q, base, L2, n),
            lambda: block_minima(q, base, L2, n),
            lambda: _launch_k1(q, base, L2, n, None, "simt"),
        ]
        if routed == "wgmma":
            compare_minima(q, base, L2, n, f"main-path {label}, mma.sync body", body="mma")
            fns.append(lambda: _launch_k1(q, base, L2, n, None, "mma"))
        lib = library_call(q, base)
        ms = in_turns(fns + ([lib] if lib else []), 20 if b == 1 else 10)
        mma_ms = ms[3] if routed == "wgmma" else None
        lib_ms = ms[-1] if lib else None
        lim, by = k1_bound(b, n, DIM_MAIN, base.element_size())
        out[label] = {"ms": ms[1], "plain_ms": ms[0], "mma_sync_ms": mma_ms, "simt_ms": ms[2],
                      "library_ms": lib_ms, "bound_ms": lim, "bound_by": by}
        print(
            f"[times] K1 {shape} {label} L2 (every body == twin; {routed} body): kernel {ms[1]!r} ms, "
            f"bound {lim!r} ms ({by}), {100 * lim / ms[1]:.1f}% of bound; mma.sync body "
            f"{'(routed)' if mma_ms is None else repr(mma_ms) + ' ms'}; CUDA-core body {ms[2]!r} ms; "
            f"twin {ms[0]!r} ms; library {'none' if not lib else repr(lib_ms) + ' ms'}; PERF.md §6: "
            f"{PERF6_K1_MS.get(label)} ms | {card}",
            flush=True,
        )

    # 16-bit rows (the f32 rows cast) on the wgmma body and forced onto
    # the mma.sync and CUDA-core bodies, in turns, beside torch.matmul in
    # 16 bits
    for name, dt in (("f16", torch.float16), ("bf16", torch.bfloat16)):
        base = vecs.to(dt)
        check(k1_body(dt, L2, DIM_MAIN) == "wgmma", f"L2 {name} does not route to the wgmma body")
        for b in (1, B_MAIN):
            q = Qd[:b].to(dt)
            label = f"L2 {name} B={b}"
            out["max_abs_err"] = max(out["max_abs_err"], compare_minima(q, base, L2, n, f"main-path {label}"))
            compare_minima(q, base, L2, n, f"main-path {label}, mma.sync body", body="mma")
            compare_minima(q, base, L2, n, f"main-path {label}, CUDA-core body", body="simt")
            ms = in_turns(
                [lambda: block_minima_reference(q, base, L2, n), lambda: block_minima(q, base, L2, n),
                 lambda: _launch_k1(q, base, L2, n, None, "simt"), lambda: _launch_k1(q, base, L2, n, None, "mma"),
                 lambda: torch.matmul(q, base.T)],
                20 if b == 1 else 10,
            )
            lim, by = k1_bound(b, n, DIM_MAIN, 2)
            out[label] = {"ms": ms[1], "plain_ms": ms[0], "mma_sync_ms": ms[3], "simt_ms": ms[2],
                          "library_ms": ms[4], "bound_ms": lim, "bound_by": by}
            print(
                f"[times] K1 {shape} {label} (every body == twin; wgmma body): kernel {ms[1]!r} ms, "
                f"bound {lim!r} ms ({by}), {100 * lim / ms[1]:.1f}% of bound; mma.sync body {ms[3]!r} ms "
                f"({ms[3] / ms[1]:.2f}x); CUDA-core body {ms[2]!r} ms ({ms[2] / ms[1]:.2f}x); twin "
                f"{ms[0]!r} ms; library torch.matmul in {name} {ms[4]!r} ms; PERF.md §6: "
                f"{PERF6_K1_MS[label]} ms | {card}",
                flush=True,
            )
        del base

    # L1 on its CUDA-core body (the only body: the tensor cores have no L1
    # form) over the f32 rows, the same rows in float16, and u8 codes
    L1 = DistanceMetric.L1
    for name, q_all, base in (("f32", Qd, vecs), ("f16", Qd.half(), vecs.half()), ("u8", u8_q, u8_base)):
        check(k1_body(base.dtype, L1, DIM_MAIN) == "simt", f"L1 {name} does not route to the CUDA-core body")
        for b in (1, B_MAIN):
            q = q_all[:b].contiguous()
            label = f"L1 {name} B={b}"
            out["max_abs_err"] = max(out["max_abs_err"], compare_minima(q, base, L1, n, f"main-path {label}"))
            lib = cdist_call(q, base)
            ms = in_turns(
                [lambda: block_minima_reference(q, base, L1, n), lambda: block_minima(q, base, L1, n)]
                + ([lib] if lib else []),
                20 if b == 1 else 3,
            )
            lim, by = k1_bound_cuda_core(b, n, DIM_MAIN, base.element_size(), base.dtype is torch.int8)
            out[label] = {"ms": ms[1], "plain_ms": ms[0], "simt_ms": ms[1],
                          "library_ms": ms[2] if lib else None, "bound_ms": lim, "bound_by": by}
            print(
                f"[times] K1 {shape} {label} (CUDA-core body == twin): kernel {ms[1]!r} ms, bound "
                f"{lim!r} ms ({by}), {100 * lim / ms[1]:.1f}% of bound; twin {ms[0]!r} ms; library "
                f"torch.cdist(p=1) {'none' if not lib else repr(ms[2]) + ' ms'} | {card}",
                flush=True,
            )
        del base
    del u8_base

    # end-to-end p50 by mode and B, beside which phase 12 prints timed_search's
    out["search_p50"] = {
        mode: search_times(card, ds, Q, mode, shape, ((1, 500), (B_MAIN, 200)))
        for mode in ("exact", "quantized")
    }
    body_latency(card, ds, Q, shape)
    return out


def body_latency(
    card: str, ds, Q, shape: str, modes=("exact", "quantized"), label: str = "",
    rounds: int = 10, calls: int = 100, b: int = 1,
) -> None:
    """Search at B=b in each of `modes` with K1 in its routed (tensor-core:
    wgmma for float rows, mma.sync for codes) body and forced onto the
    CUDA-core body, in one process on the same
    data: p50 call latency of `calls` back-to-back calls per round (and
    for b > 1 the QPS it gives, b / p50), the two bodies in turns (ABBA),
    `rounds` rounds each."""
    from sqlite_vector_tpu_torch.ops import block_scan

    routed = block_scan.k1_body
    for mode in modes:
        p50 = {"routed": [], "simt": []}
        for r in range(rounds):
            for body in ("routed", "simt") if r % 2 == 0 else ("simt", "routed"):
                block_scan.k1_body = routed if body == "routed" else (lambda *_: "simt")
                try:
                    for _ in range(3):
                        ds.search(Q[:b], K, mode=mode)
                    walls = []
                    for _ in range(calls):
                        t0 = time.perf_counter()
                        ds.search(Q[:b], K, mode=mode)
                        walls.append(time.perf_counter() - t0)
                finally:
                    block_scan.k1_body = routed
                p50[body].append(float(np.median(walls)) * 1e3)
        wins = sum(x < y for x, y in zip(p50["routed"], p50["simt"]))
        mid = {body: float(np.median(v)) for body, v in p50.items()}
        qps = f" (QPS {b * 1e3 / mid['routed']!r} / {b * 1e3 / mid['simt']!r})" if b > 1 else ""
        print(
            f"[times] search {mode}{label} {shape} k={K} B={b}, K1 body in turns ({rounds} rounds of "
            f"{calls} calls): p50 per round, tensor-core body {p50['routed']!r} ms, CUDA-core body "
            f"{p50['simt']!r} ms; medians {mid['routed']!r} / {mid['simt']!r} ms{qps}; tensor-core "
            f"body faster in {wins}/{rounds} rounds | {card}",
            flush=True,
        )


def phase_datasets(card: str, ds, Q) -> dict:
    """End-to-end exact search over datasets of the main rows in other
    types and metrics: FLOAT16 L2 and FLOATB16 DOT (the rows cast, all
    finite: K1's wgmma body) and FLOAT32 L1 (its CUDA-core L1
    body), each against the plain-torch ground truth (tie-aware); then B=1
    and B=64 search times and, for the 16-bit ones, B=1 latency with K1 in
    each body. Returns, by dataset, the K1 launches of its checked search,
    every one in the expected body."""
    import sqlite_vector_tpu_torch as svt
    from sqlite_vector_tpu_torch.ops.block_scan import block_minima
    from sqlite_vector_tpu_torch.ops.distance import pairwise_distance
    from sqlite_vector_tpu_torch.types import DistanceMetric

    parity = load_tests_module("parity")
    rows = ds._vectors[: len(ds)].cpu().numpy()
    shape = f"{len(rows)}x{DIM_MAIN}"
    launches = {}
    for vtype, metric, body in (("FLOAT16", "L2", "wgmma"), ("FLOATB16", "DOT", "wgmma"), ("FLOAT32", "L1", "simt")):
        label = f"{vtype} {metric}"
        t0 = time.perf_counter()
        other = svt.VectorStore(device="cuda").create(
            label, f"dimension={DIM_MAIN},type={vtype},distance={metric}"
        )
        for s in range(0, len(rows), 100_000):
            other.add(rows[s : s + 100_000])
        torch.cuda.synchronize()
        t_add = time.perf_counter() - t0
        zero_counts()
        got_ids, got_d = other.search(Q, K)
        launches[label] = block_minima.launches
        check(block_minima.launches > 0, f"{label} search did not launch K1")
        check(block_minima.body_launches[body] == block_minima.launches,
              f"{label} search left K1's {body} body: {block_minima.body_launches}")
        qc, _ = other._coerce_queries(Q)
        qd = torch.from_numpy(np.ascontiguousarray(qc)).cuda().to(other._vectors.dtype)
        oracle = pairwise_distance(qd, other._vectors[: len(other)], DistanceMetric(metric)).cpu().numpy()
        ids_all = other.ids
        for i in range(B_MAIN):
            parity.assert_topk_parity(
                *top_rows(ids_all, oracle[i]), got_ids[i], got_d[i], K,
                rel_tol=parity.REL_TOL_BY_TYPE[vtype], label=f"{label} q{i}",
            )
        print(
            f"[datasets] {shape} {label}: added in {t_add:.1f} s; search(Q[{B_MAIN}], {K}) ids "
            f"match the plain-torch ground truth (tie-aware, rel_tol "
            f"{parity.REL_TOL_BY_TYPE[vtype]}), K1 launches {block_minima.launches}, all in its "
            f"{body} body | {card}",
            flush=True,
        )
        search_times(card, other, Q, "exact", shape, ((1, 500), (B_MAIN, 200)), label=f"exact {label}")
        if body == "wgmma":
            body_latency(card, other, Q, shape, modes=("exact",), label=f" {label}")
        del other
        torch.cuda.empty_cache()
    return launches


def search_times(card: str, ds, Q, mode: str, shape: str, plan, label: str = "") -> dict:
    """End-to-end search: for each (B, calls) in plan, QPS as all queries
    over the whole window of back-to-back calls, and the per-call latency
    p50, p99 and max (host clock; search returns host arrays, so each call
    is synchronous). Returns the p50 ms by B."""
    p50s = {}
    for b, reps in plan:
        qs = Q[:b]
        for _ in range(3):  # warm-up
            ds.search(qs, K, mode=mode)
        walls = []
        t_window = time.perf_counter()
        for _ in range(reps):
            t0 = time.perf_counter()
            ds.search(qs, K, mode=mode)
            walls.append(time.perf_counter() - t0)
        window = time.perf_counter() - t_window
        p50, p99 = (float(np.percentile(walls, p)) * 1e3 for p in (50, 99))
        p50s[b] = p50
        print(
            f"[times] search {label or mode} {shape} k={K} B={b}: QPS {b * reps / window!r} "
            f"({b * reps} queries in {reps} back-to-back calls, {window * 1e3!r} ms "
            f"window); call latency p50 {p50!r} ms, p99 {p99!r} ms, max "
            f"{max(walls) * 1e3!r} ms | {card}",
            flush=True,
        )
    return p50s


def same_topk(label: str, ids, vals, want_ids, want_vals) -> None:
    """Equal distances, and equal ids up to the order among equal
    distances (the earliest row wins ties on both sides, so in practice
    the ids are equal too)."""
    check(np.array_equal(vals, want_vals), f"{label}: distances differ from the plain path")
    for i in range(ids.shape[0]):
        for v in np.unique(vals[i]):
            at = vals[i] == v
            check(
                sorted(ids[i][at]) == sorted(want_ids[i][at]),
                f"{label} q{i}: ids at distance {v} differ from the plain path",
            )


def phase_int4(card: str, ds, Q, ids_e) -> int:
    """int4 quantize + mode="quantized" and mode="refine" on the main rows,
    each held against its plain counterpart on the same codes; returns K2's
    launch count over the two searches."""
    from sqlite_vector_tpu_torch.ops.block_scan import block_minima
    from sqlite_vector_tpu_torch.ops.int4_scan import int4_block_minima
    from sqlite_vector_tpu_torch.ops.quantize4 import int4_scan_topk_plain
    from sqlite_vector_tpu_torch.ops.refine import refine_candidates
    from sqlite_vector_tpu_torch.types import DistanceMetric

    L2 = DistanceMetric.L2
    t0 = time.perf_counter()
    ds.quantize(qtype="int4", refine=True)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    quant = ds._quant
    ids_all = quant.ids
    n = quant.count
    Qd = torch.from_numpy(Q).cuda()

    zero_counts()
    ids_q, d_q = ds.search(Q, K, mode="quantized")
    ids_r, d_r = ds.search(Q, K, mode="refine")
    launches = int4_block_minima.launches
    check(launches > 0, "int4 quantized/refine search did not launch K2")
    check(int4_block_minima.body_launches == {"wgmma": launches, "mma": 0},
          f"int4 searches left K2's wgmma body: {int4_block_minima.body_launches}")
    check(block_minima.launches == 0, "int4 searches launched K1")

    # quantized: the plain tile loop over the same codes
    pv, pi = int4_scan_topk_plain(
        Qd, quant.codes, quant.row_scale, quant.sq_norms, L2, K, dim=DIM_MAIN, valid_count=n
    )
    pi = pi.cpu().numpy()
    same_topk("int4 quantized", ids_q, d_q, np.where(pi >= 0, ids_all[pi], -1), pv.cpu().numpy())

    # refine: the same rescore over the plain tile loop's candidates
    _, cand = int4_scan_topk_plain(
        Qd, quant.codes, quant.row_scale, quant.sq_norms, L2, 4 * K, dim=DIM_MAIN, valid_count=n
    )
    rv, ri = refine_candidates(Qd, cand, quant.codes8, quant.scale8, quant.offset8, L2, K)
    ri = ri.cpu().numpy()
    same_topk("refine", ids_r, d_r, np.where(ri >= 0, ids_all[ri], -1), rv.cpu().numpy())

    def recall(ids):
        return float(np.mean([len(set(ids[i]) & set(ids_e[i])) / K for i in range(B_MAIN)]))

    print(
        f"[int4] quantize(qtype='int4', refine=True) in {t_quant:.2f} s (packed "
        f"{quant.codes.numel()} B, sidecar {quant.qtype8.value} scale8={float(quant.scale8)!r}); "
        f"search(Q[{B_MAIN}], {K}, mode='quantized') == the plain int4 tile loop over the "
        f"same codes (distances equal, ids tie-aware); mode='refine' == the refine rescore "
        f"of the plain loop's candidates; recall@{K} vs exact: int4 {recall(ids_q)!r}, "
        f"refine {recall(ids_r)!r}; K2 launches {launches}, all in its wgmma body, "
        f"K1 launches 0 | {card}",
        flush=True,
    )
    return launches


def phase_int4_times(card: str, ds, Q) -> dict:
    """K2 at B=1 and B=B_MAIN, its two bodies held against the twin, then
    timed in turns with the twin, the mma.sync body and the library
    yardstick, beside its bound; then end-to-end int4-quantized and refine
    search, every K2 launch in its wgmma body. Returns, by label, the
    kernel's, the twin's, the mma.sync body's and the library's ms with the
    bound, and the largest |kernel - twin| under "max_abs_err"."""
    from sqlite_vector_tpu_torch.ops.int4_scan import (
        _launch_k2,
        int4_block_minima,
        int4_block_minima_reference,
    )
    from sqlite_vector_tpu_torch.ops.quantize4 import quantize_query_int8, unpack4
    from sqlite_vector_tpu_torch.types import DistanceMetric

    L2 = DistanceMetric.L2
    quant = ds._quant
    n = quant.count
    shape = f"{n}x{DIM_MAIN}"
    Qd = torch.from_numpy(Q).cuda()
    codes8 = unpack4(quant.codes, DIM_MAIN)  # the yardstick's int8 codes, made once
    out = {"max_abs_err": 0.0}
    for b, iters in ((1, 20), (B_MAIN, 10)):
        qc, qs, _ = quantize_query_int8(Qd[:b])
        args = (qc, qs, quant.codes, quant.row_scale, quant.sq_norms)
        out["max_abs_err"] = max(out["max_abs_err"], compare_int4_minima(args, L2, n, f"main-path K2 B={b}"))
        # the twin apart: its seconds of memory traffic just before a body
        # skewed that body's time; the bodies and the yardstick over five
        # rounds in turns (their times spread by up to 8% between passes)
        (plain_ms,) = in_turns([lambda: int4_block_minima_reference(*args, L2, n)], iters)
        fns = [lambda: int4_block_minima(*args, L2, n), lambda: _launch_k2(*args, L2, n, None, "mma")]
        lib = library_call_k2(qc, codes8)
        ms = in_turns(fns + ([lib] if lib else []), iters, rounds=5)
        lim, by = k2_bound(b, n, DIM_MAIN)
        label = f"B={b}"
        out[label] = {"ms": ms[0], "plain_ms": plain_ms, "mma_sync_ms": ms[1],
                      "library_ms": ms[2] if lib else None, "bound_ms": lim, "bound_by": by}
        print(
            f"[times] K2 {shape} f32 queries {label} L2 (the two bodies == twin; wgmma body): kernel "
            f"{ms[0]!r} ms ({quant.codes.numel() / (ms[0] * 1e-3) / 1e9:.0f} GB/s of packed "
            f"codes), bound {lim!r} ms ({by}), {100 * lim / ms[0]:.1f}% of bound; mma.sync body "
            f"{ms[1]!r} ms; twin {plain_ms!r} ms; library "
            f"(torch._int_mm) {'none' if not lib else repr(ms[2]) + ' ms'} (medians of 10 passes "
            f"in turns) | {card}",
            flush=True,
        )
    del codes8
    zero_counts()
    for mode, label in (("quantized", "int4 quantized"), ("refine", "refine expand=4")):
        search_times(card, ds, Q, mode, shape, ((1, 200), (B_MAIN, 100)), label)
    used = int4_block_minima.body_launches
    check(used["wgmma"] > 0 and used["mma"] == 0,
          f"timed int4 searches left K2's wgmma body: {used}")
    check(int4_block_minima.streamed_launches == 0, "K2 streamed its query tile at d=384")
    print(f"[times] the timed int4 searches' K2 launches: {used}, streamed_launches "
          f"{int4_block_minima.streamed_launches} (the query tile resident at d={DIM_MAIN}) | {card}",
          flush=True)
    return out


def close_topk(label: str, ids, vals, want_ids, want_vals, rtol: float) -> None:
    """Values within rtol (float32 sums in another order), and wherever the
    ids differ the two values are a near-tie within that tolerance."""
    check(ids.shape == want_ids.shape, f"{label}: shape {ids.shape} != {want_ids.shape}")
    check(np.array_equal(np.isinf(vals), np.isinf(want_vals)), f"{label}: unfilled slots differ")
    fin = np.isfinite(want_vals)
    check(
        np.allclose(vals[fin], want_vals[fin], rtol=rtol, atol=1e-5),
        f"{label}: distances differ from the plain path beyond rtol {rtol}",
    )
    for i in range(ids.shape[0]):
        if not fin[i].any():
            continue
        kth = want_vals[i][fin[i]].max()
        sure = set(want_ids[i][want_vals[i] < kth - rtol * max(1.0, abs(kth))].tolist())
        check(sure <= set(ids[i].tolist()), f"{label} q{i}: a clear winner of the plain path is missing")


def to_ids(pos: torch.Tensor, id_map: np.ndarray) -> np.ndarray:
    pos = pos.cpu().numpy()
    return np.where(pos >= 0, id_map[np.clip(pos, 0, None)], -1)


def phase_mutate(card: str, ds, Q) -> dict:
    """remove, masked and filtered search in every mode against the plain
    counterparts, update, compact, distances; prints the times and returns
    the kernels' launches over the masked searches and their masked times
    at B=B_MAIN."""
    from sqlite_vector_tpu_torch.ops.block_scan import _launch_k1, block_minima
    from sqlite_vector_tpu_torch.ops.distance import pairwise_distance
    from sqlite_vector_tpu_torch.ops.int4_scan import int4_block_minima
    from sqlite_vector_tpu_torch.ops.quantize import quantize_device
    from sqlite_vector_tpu_torch.ops.quantize4 import int4_scan_topk_plain, quantize_query_int8
    from sqlite_vector_tpu_torch.ops.refine import refine_candidates
    from sqlite_vector_tpu_torch.ops.rerank import (
        candidate_distances,
        rescore_live_rows,
        rescore_topk,
    )
    from sqlite_vector_tpu_torch.ops.scan import scan_topk
    from sqlite_vector_tpu_torch.types import DistanceMetric

    L2, F32_TOL = DistanceMetric.L2, 3e-5
    rng = np.random.default_rng(SEED + 8)
    Qd = torch.from_numpy(Q).cuda()
    shape = f"{N_MAIN}x{DIM_MAIN}"
    out = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    zero_counts()
    # -- remove: tombstones below the 250,000-row threshold ------------------
    gone = rng.choice(ds.ids, 10_000, replace=False)
    removed, t_remove = timed(lambda: ds.remove(gone))
    check(removed == 10_000 and ds.tombstones == 10_000, "remove did not tombstone 10,000 rows")
    check(len(ds) == N_MAIN - 10_000, f"len {len(ds)} after remove")
    count = ds._count
    vecs = ds._vectors[:count]
    rows_ids = ds._ids[:count]
    live = ds._live_mask_dev()

    # -- masked exact at B=1 and B=B_MAIN, against the plain masked scan --
    for b in (1, B_MAIN):
        ids_e, d_e = ds.search(Q[:b], K)
        check(not np.isin(ids_e, gone).any(), f"exact B={b}: a removed id came back")
        pv, pi = scan_topk(Qd[:b], vecs, L2, K, row_mask=live)
        close_topk(f"masked exact B={b}", ids_e, d_e, to_ids(pi, rows_ids), pv.cpu().numpy(), F32_TOL)
    d4 = ds.distances(Q[:4])
    check(d4.shape == (4, len(ds)), f"distances shape {d4.shape}")
    want = pairwise_distance(Qd[:4], vecs, L2)[:, live].cpu().numpy()
    check(np.allclose(d4, want, rtol=1e-6, atol=0), "distances differ from the plain distances of the live rows")

    # -- ids_filter of 100,000 live ids -------------------------------------
    flt = rng.choice(ds.ids, 100_000, replace=False)
    quant = ds._quant  # phase 6's int4 + refine snapshot, stale now
    snap_mask = torch.from_numpy(np.isin(quant.ids, flt)).cuda()
    live_mask = torch.from_numpy(np.isin(rows_ids, flt)).cuda() & live
    ids_f, d_f = ds.search(Q, K, ids_filter=flt)
    check(np.isin(ids_f[ids_f >= 0], flt).all(), "filtered exact returned an id outside the filter")
    pv, pi = scan_topk(Qd, vecs, L2, K, row_mask=live_mask)
    close_topk("filtered exact", ids_f, d_f, to_ids(pi, rows_ids), pv.cpu().numpy(), F32_TOL)
    ids_a, d_a = ds.search(Q, K, mode="approx", ids_filter=flt)
    check(np.array_equal(ids_a, ids_f) and np.array_equal(d_a, d_f), "approx != exact")
    qargs = (quant.codes, quant.row_scale, quant.sq_norms)
    ids_q, d_q = ds.search(Q, K, mode="quantized", ids_filter=flt)
    pv, pi = int4_scan_topk_plain(Qd, *qargs, L2, K, dim=DIM_MAIN, valid_count=quant.count, row_mask=snap_mask)
    same_topk("filtered int4 quantized", ids_q, d_q, to_ids(pi, quant.ids), pv.cpu().numpy())
    ids_r, d_r = ds.search(Q, K, mode="refine", ids_filter=flt)
    _, cand = int4_scan_topk_plain(
        Qd, *qargs, L2, 4 * K, dim=DIM_MAIN, valid_count=quant.count, row_mask=snap_mask
    )
    rv, ri = refine_candidates(Qd, cand, quant.codes8, quant.scale8, quant.offset8, L2, K)
    same_topk("filtered refine", ids_r, d_r, to_ids(ri, quant.ids), rv.cpu().numpy())

    def plain_remap(stage1_pos: torch.Tensor):
        """The rerank id-remap route by hand: snapshot positions -> ids ->
        live positions, then the same rescore of the live rows."""
        cand_ids = to_ids(stage1_pos, quant.ids)
        pos_of = ds._id_to_pos()
        pos = np.array([[pos_of.get(int(i), -1) for i in row] for row in cand_ids], np.int64)
        v, i = rescore_live_rows(Qd, ds._vectors, torch.from_numpy(pos).cuda(), L2, K)
        return to_ids(i, ds._ids), v.cpu().numpy()

    ids_rr, d_rr = ds.search(Q, K, mode="rerank", ids_filter=flt)
    check(not np.isin(ids_rr, gone).any(), "rerank returned a removed id")
    _, cand = int4_scan_topk_plain(
        Qd, *qargs, L2, 4 * K, dim=DIM_MAIN, valid_count=quant.count, row_mask=snap_mask
    )
    same_topk("filtered rerank (int4 stage 1, id remap)", ids_rr, d_rr, *plain_remap(cand))
    masked = {"K1": block_minima.launches, "K2": int4_block_minima.launches}
    check(int4_block_minima.body_launches == {"wgmma": masked["K2"], "mma": 0},
          f"masked int4 searches left K2's wgmma body: {int4_block_minima.body_launches}")
    print(
        f"[mutate] remove(10000) of {N_MAIN} rows: {ds.tombstones} tombstones; masked exact "
        f"B=1 and B={B_MAIN} == the plain masked scan (rtol {F32_TOL}), no removed id back; "
        f"distances(Q[:4]) shape {d4.shape} == the plain distances of the live rows; "
        f"ids_filter of 100000 live ids: exact == plain, approx == exact bit for bit, int4 "
        f"quantized, refine and rerank (stale int4 snapshot) == their plain counterparts "
        f"over the same masks; K1 launches {masked['K1']}, K2 launches {masked['K2']} | {card}",
        flush=True,
    )

    # -- times with the tombstones in place --------------------------------
    search_times(card, ds, Q, "exact", shape, ((1, 200), (B_MAIN, 100)), "exact, 10000 tombstones")
    filtered = ds._search_mask("exact", ds._quant, flt)
    masks_ms = []
    for _ in range(20):
        _, ms = timed(lambda: ds._search_mask("exact", ds._quant, flt))
        masks_ms.append(ms)
    reps = 50
    _, window = timed(lambda: [ds.search(Q, K, ids_filter=flt) for _ in range(reps)])
    mask_ms = float(np.median(masks_ms))
    print(
        f"[times] search exact filtered (100000 of {len(ds)} live ids) {shape} k={K} "
        f"B={B_MAIN}: QPS {B_MAIN * reps / (window * 1e-3)!r} ({reps} back-to-back calls, "
        f"{window / reps!r} ms a call) | {card}",
        flush=True,
    )
    print(
        f"[times] filter mask build (torch.isin of {count} ids against 100000, device, "
        f"the tombstone mask combined): median {mask_ms!r} ms of 20, "
        f"{100 * mask_ms / (window / reps):.1f}% of a filtered B={B_MAIN} search | {card}",
        flush=True,
    )
    qc, qs, _ = quantize_query_int8(Qd)
    k1_plain, k1_ms = in_turns(
        [lambda: block_minima(Qd, vecs, L2, count), lambda: block_minima(Qd, vecs, L2, count, filtered)],
        10,
    )
    k2_plain, k2_ms = in_turns(
        [lambda: int4_block_minima(qc, qs, *qargs, L2, quant.count),
         lambda: int4_block_minima(qc, qs, *qargs, L2, quant.count, snap_mask)],
        10,
    )
    out["K1"], out["K2"] = (k1_ms, k1_plain), (k2_ms, k2_plain)
    for name, (m_ms, u_ms), nbytes in (
        ("K1", out["K1"], vecs.numel() * 4), ("K2", out["K2"], quant.codes.numel())
    ):
        print(
            f"[times] {name} alone {shape} B={B_MAIN} L2: masked {m_ms!r} ms, unmasked "
            f"{u_ms!r} ms ({nbytes / (m_ms * 1e-3) / 1e9:.0f} GB/s masked) | {card}",
            flush=True,
        )

    # -- update 64 rows, compact ---------------------------------------------
    upd = rng.choice(ds.ids, B_MAIN, replace=False)
    fresh = rng.standard_normal((B_MAIN, DIM_MAIN), dtype=np.float32)
    ds._id_pos_cache = None  # time the live id map's rebuild on its own
    _, t_id_map = timed(ds._id_to_pos)
    n_upd, t_update = timed(lambda: ds.update(upd, fresh))
    ids_u, d_u = ds.search(fresh, 1)
    check(n_upd == B_MAIN and np.array_equal(ids_u[:, 0], upd), "update: a new vector does not find its id")
    check(bool((d_u[:, 0] == 0).all()), "update: a new vector is not at distance 0")
    before = ds.search(Q, K)
    dropped, t_compact = timed(ds.compact)
    after = ds.search(Q, K)
    check(dropped == 10_000 and ds.tombstones == 0 and len(ds) == N_MAIN - 10_000, "compact")
    for i in range(B_MAIN):
        check(set(before[0][i]) == set(after[0][i]), f"q{i}: results changed across compaction")
    print(
        f"[mutate] update({B_MAIN}) each new vector found at distance 0; compact() dropped "
        f"{dropped} rows, search results equal as id sets before and after | {card}",
        flush=True,
    )
    print(
        f"[times] remove(10000) {t_remove!r} ms; update({B_MAIN}) {t_update!r} ms (out of "
        f"place: a copy of the {ds._vectors.numel() * 4 / 1e9:.2f} GB matrix, with the live "
        f"id map warm; rebuilt cold, as after a remove, it took {t_id_map!r} ms); compact() "
        f"{t_compact!r} ms (device gather of {len(ds)} rows) | {card}",
        flush=True,
    )
    search_times(card, ds, Q, "exact", f"{len(ds)}x{DIM_MAIN}", ((1, 200), (B_MAIN, 100)),
                 "exact, unmasked after compact")
    vecs = ds._vectors[: ds._count]
    q1 = Qd[:1]
    k1_tc, k1_simt = in_turns(
        [lambda: block_minima(q1, vecs, L2, len(ds)), lambda: _launch_k1(q1, vecs, L2, len(ds), None, "simt")],
        20,
    )
    print(
        f"[times] K1 alone {len(ds)}x{DIM_MAIN} B=1 L2 after compact: tensor-core body "
        f"{k1_tc!r} ms, CUDA-core body {k1_simt!r} ms | {card}",
        flush=True,
    )
    body_latency(card, ds, Q, f"{len(ds)}x{DIM_MAIN}", ("exact",), " after compact")

    # -- fresh int8 codes: filtered quantized and rerank, unfiltered rerank --
    ds.quantize()
    quant = ds._quant
    before = (block_minima.launches, int4_block_minima.launches)
    qq = quantize_device(Qd, quant.scale, quant.offset, quant.qtype)
    snap_mask = torch.from_numpy(np.isin(quant.ids, flt)).cuda()
    ids_q, d_q = ds.search(Q, K, mode="quantized", ids_filter=flt)
    pv, pi = scan_topk(qq, quant.codes, L2, K, row_mask=snap_mask)
    check(np.array_equal(ids_q, to_ids(pi, quant.ids)) and np.array_equal(d_q, pv.cpu().numpy()),
          "filtered int8 quantized != the plain masked scan of the same codes")
    ids_rr, d_rr = ds.search(Q, K, mode="rerank", ids_filter=flt)
    _, cand = scan_topk(qq, quant.codes, L2, 4 * K, row_mask=snap_mask)
    same_topk("filtered rerank (int8 stage 1, id remap)", ids_rr, d_rr, *plain_remap(cand))
    masked["K1"] += block_minima.launches - before[0]
    masked["K2"] += int4_block_minima.launches - before[1]
    check(masked["K1"] > 0 and masked["K2"] > 0, f"masked searches launched {masked}")
    ids_rf, d_rf = ds.search(Q, K, mode="rerank")
    check(ds.last_rerank_decomposition["translate_s"] == 0.0, "unfiltered fresh rerank not fused")
    _, cand = scan_topk(qq, quant.codes, L2, 4 * K)
    vecs = ds._vectors[: ds._count]
    rv, ri = rescore_topk(
        cand, K, L2, vecs.shape[0], DIM_MAIN,
        lambda s, e, rows: candidate_distances(Qd[s:e], vecs[rows], L2),
    )
    same_topk("rerank (fused)", ids_rf, d_rf, to_ids(ri, ds._ids), rv.cpu().numpy())
    print(
        f"[mutate] fresh int8 quantize(): filtered quantized ids and distances == the plain "
        f"masked scan; filtered rerank (id remap) and unfiltered rerank (fused) == their "
        f"plain counterparts; masked-search launches K1 {masked['K1']}, K2 {masked['K2']} "
        f"| {card}",
        flush=True,
    )
    search_times(card, ds, Q, "rerank", f"{len(ds)}x{DIM_MAIN}", ((1, 200), (B_MAIN, 100)),
                 "rerank expand=4 (fused)")
    out["masked_launches"] = masked
    return out


def top_rows(ids_all: np.ndarray, oracle_row: np.ndarray, keep: int = 400):
    """The `keep` rows of smallest oracle distance (ids and distances): a
    top-k parity check reads no further, and the id map stays small."""
    part = np.argpartition(oracle_row, keep)[:keep]
    return ids_all[part], oracle_row[part]


def counts():
    from sqlite_vector_tpu_torch.ops.block_scan import block_minima
    from sqlite_vector_tpu_torch.ops.int4_scan import int4_block_minima

    # (launches, launches on a tensor-core body)
    k1, k2 = block_minima.body_launches, int4_block_minima.body_launches
    return {"K1": (block_minima.launches, k1["wgmma"] + k1["mma"]),
            "K2": (int4_block_minima.launches, k2["wgmma"] + k2["mma"])}


def zero_counts() -> None:
    from sqlite_vector_tpu_torch.ops.block_scan import block_minima, rescore_groups
    from sqlite_vector_tpu_torch.ops.int4_scan import int4_block_minima

    for fn in (block_minima, int4_block_minima):
        fn.launches = 0
        fn.body_launches = {body: 0 for body in fn.body_launches}
        fn.streamed_launches = 0
    rescore_groups.launches = 0


def phase_persist(card: str, ds, Q) -> dict:
    """Phase 9: save/load round trip of the main dataset, then a host-storage
    dataset at BASELINE.json config 5's width, streamed through K1 and K2.
    Everything it writes lies in _smoke_data/ beside this script, removed
    at the end. Returns the streamed searches' launches of each kernel."""
    root = Path(__file__).resolve().parent / "_smoke_data"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir()
    try:
        persist_roundtrip(card, ds, Q, root)
        return host_storage(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def persist_roundtrip(card: str, ds, Q, root: Path) -> None:
    import sqlite_vector_tpu_torch as svt

    want = [ds.search(Q, K), ds.search(Q, K, exact=False)]
    nbytes = ds._count * DIM_MAIN * 4
    d = str(root / "main")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds.save(d, shard_rows=250_000)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = svt.Dataset.load(d, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    got = [back.search(Q, K), back.search(Q, K, exact=False)]
    for mode, (g, w) in zip(("exact", "int8 quantized"), zip(got, want)):
        check(np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1]),
              f"{mode} search after save/load differs from before")
    print(
        f"[persist] save({ds._count} x {DIM_MAIN} FLOAT32 + int8 codes, shard_rows=250000) "
        f"{t_save!r} s ({nbytes / t_save / 1e9:.2f} GB/s of rows); load(storage='hbm') {t_load!r} s "
        f"({nbytes / t_load / 1e9:.2f} GB/s); exact and int8 search at B={B_MAIN} after the "
        f"load: ids and values identical to before the save | {card}",
        flush=True,
    )


def host_storage(card: str, root: Path) -> dict:
    import sqlite_vector_tpu_torch as svt
    import sqlite_vector_tpu_torch.dataset as dsmod
    from sqlite_vector_tpu_torch.ops import streaming
    from sqlite_vector_tpu_torch.ops.distance import pairwise_distance
    from sqlite_vector_tpu_torch.types import DistanceMetric

    parity = load_tests_module("parity")
    L2 = DistanceMetric.L2
    rng = np.random.default_rng(SEED + 9)
    picks = np.sort(rng.choice(N_HOST, B_MAIN // 2, replace=False))
    held = {}

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)

    def chunks():
        # made on the card from the seed (numpy's generator took ~20 s)
        for s in range(0, N_HOST, CHUNK_HOST):
            c = torch.randn((CHUNK_HOST, DIM_HOST), generator=gen, device="cuda").cpu().numpy()
            for p in picks[(picks >= s) & (picks < s + CHUNK_HOST)]:
                held[int(p)] = c[p - s].copy()
            yield c

    d = str(root / "host")
    nbytes = N_HOST * DIM_HOST * 4
    t0 = time.perf_counter()
    n = svt.Dataset.save_stream(d, chunks(), options=f"dimension={DIM_HOST},type=FLOAT32,distance=L2")
    t_stream = time.perf_counter() - t0
    check(n == N_HOST, f"save_stream wrote {n} rows")
    Qh = np.concatenate([np.stack([held[int(p)] for p in picks]),
                         rng.standard_normal((B_MAIN - len(picks), DIM_HOST), dtype=np.float32)])
    t0 = time.perf_counter()
    host = svt.Dataset.load(d, device="cuda", storage="host", mmap=True)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    hbm = svt.Dataset.load(d, device="cuda")
    torch.cuda.synchronize()
    t_hbm = time.perf_counter() - t0
    shape = f"{N_HOST}x{DIM_HOST}"
    print(
        f"[host] {shape} FLOAT32 L2 (BASELINE.json config 5's width; rows cut from its "
        f"10,000,000 to {N_HOST:,}, a {nbytes / 1e9:.2f} GB file, to fit the smoke's time): "
        f"save_stream of {N_HOST // CHUNK_HOST} chunks of {CHUNK_HOST} rows {t_stream!r} s (data "
        f"generation included); load(storage='host', mmap=True) {t_host!r} s "
        f"({type(host._host_vectors).__name__} of {N_HOST // CHUNK_HOST} memory maps, device bytes "
        f"{host.memory_bytes()}); load(storage='hbm') {t_hbm!r} s ({nbytes / t_hbm / 1e9:.2f} GB/s) | {card}",
        flush=True,
    )
    streamed = {"K1": [0, 0], "K2": [0, 0]}

    def stream(fn):
        """fn() on the host dataset, its kernel launches tallied."""
        c0 = counts()
        r = fn()
        for name, (launches, mma) in counts().items():
            streamed[name][0] += launches - c0[name][0]
            streamed[name][1] += mma - c0[name][1]
        return r

    # -- exact: streamed against the device-storage load -----------------
    Qd = torch.from_numpy(Qh).cuda()
    ids_all = hbm.ids
    oracle = pairwise_distance(Qd, hbm._vectors[:N_HOST], L2).cpu().numpy()
    worst = 0.0
    for b in (1, B_MAIN):
        ids_h, d_h = stream(lambda: host.search(Qh[:b], K))
        ids_m, d_m = hbm.search(Qh[:b], K)
        for i in range(b):
            parity.assert_topk_parity(
                *top_rows(ids_all, oracle[i]), ids_h[i], d_h[i], K,
                rel_tol=parity.REL_TOL_BY_TYPE["FLOAT32"], label=f"streamed exact B={b} q{i}",
            )
        worst = max(worst, float(np.abs(d_h - d_m).max()))
    for i, p in enumerate(picks):
        check(ids_h[i, 0] == p + 1 and d_h[i, 0] == 0.0, f"streamed q{i}: self-match not first at 0")
    print(
        f"[host] exact search streamed from host (B=1 and B={B_MAIN}, k={K}): ids match the "
        f"plain-torch ground truth (tie-aware, rel_tol {parity.REL_TOL_BY_TYPE['FLOAT32']}), "
        f"{len(picks)}/{len(picks)} self-matches first at 0.0; max |streamed - device-storage| "
        f"value {worst!r} | {card}",
        flush=True,
    )

    # -- int8: checkpointed host build, resume, streamed and preloaded ---
    t0 = time.perf_counter()
    host.quantize(checkpoint=str(root / "ck8"))
    t_build = time.perf_counter() - t0
    hbm.quantize()
    check(host.quant_params == hbm.quant_params, "host and device int8 params differ")
    check(np.array_equal(host._quant.codes, hbm._quant.codes.cpu().numpy()),
          "host int8 codes differ from the device build's")
    real, calls = dsmod.quantize_device, [0]

    def counting(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    dsmod.quantize_device = counting
    try:
        t0 = time.perf_counter()
        host.quantize(checkpoint=str(root / "ck8"))
        t_resume = time.perf_counter() - t0
    finally:
        dsmod.quantize_device = real
    check(calls[0] == 0, f"the second build re-quantized {calls[0]} chunks instead of resuming")
    want8 = [stream(lambda: host.search(Qh[:b], K, exact=False)) for b in (1, B_MAIN)]
    print(
        f"[host] quantize(checkpoint=) int8 over the memory maps {t_build!r} s, codes and params "
        f"bit-equal to the device build of the hbm load; again with the same checkpoint: "
        f"resumed, 0 chunks re-quantized, {t_resume!r} s | {card}",
        flush=True,
    )
    times = stream_times(card, host, Qh, shape, nbytes, stream, streaming)
    search_times(card, host, Qh, "quantized", shape, ((1, 20), (B_MAIN, 10)), "int8 quantized, streamed from host")
    host.preload()
    for b, w in zip((1, B_MAIN), want8):
        for g, x, m in zip(host.search(Qh[:b], K, exact=False), w, hbm.search(Qh[:b], K, exact=False)):
            check(np.array_equal(g, x) and np.array_equal(g, m),
                  f"int8 B={b}: streamed, preloaded and device-storage results differ")

    # -- int4 + refine: host build, streamed through K2, then preloaded ---
    t0 = time.perf_counter()
    host.quantize(qtype="int4", refine=True, checkpoint=str(root / "ck4"))
    t_build4 = time.perf_counter() - t0
    hbm.quantize(qtype="int4", refine=True)
    want4 = [stream(lambda: host.search(Qh[:b], K, mode="quantized")) for b in (1, B_MAIN)]
    try:
        host.search(Qh[:1], K, mode="refine")
        raise RuntimeError("chip_smoke check failed: refine ran on host-resident codes")
    except svt.VectorStateError:
        pass
    host.preload()
    for b, w in zip((1, B_MAIN), want4):
        for g, x, m in zip(host.search(Qh[:b], K, mode="quantized"), w, hbm.search(Qh[:b], K, mode="quantized")):
            check(np.array_equal(g, x) and np.array_equal(g, m),
                  f"int4 B={b}: streamed, preloaded and device-storage results differ")
    same_topk("refine (host after preload)", *host.search(Qh, K, mode="refine"), *hbm.search(Qh, K, mode="refine"))
    same_topk("rerank (host rows gathered)", *host.search(Qh, K, mode="rerank"), *hbm.search(Qh, K, mode="rerank"))
    gathered = host.last_rerank_decomposition
    print(
        f"[host] quantize(qtype='int4', refine=True, checkpoint=) {t_build4!r} s; int4 search "
        f"streamed through K2 (B=1, B={B_MAIN}) == after preload() == the device-storage load, "
        f"bit for bit; refine raised VectorStateError before preload() and equals the device "
        f"storage after it; rerank (int4 stage 1, {gathered['gathered_rows']} rows gathered from "
        f"the memory maps in {gathered['host_gather_s'] * 1e3:.1f} ms) equals the device "
        f"storage's | {card}",
        flush=True,
    )

    mesh_launches = mesh_wide(card, d, hbm, Qh)

    # -- tombstones on the read-only mirror -------------------------------
    gone = rng.choice(N_HOST, 1000, replace=False) + 1
    for x in (host, hbm):
        check(x.remove(gone) == 1000, "remove(1000)")
    check(host.tombstones == 1000 and not host._host_writable(), "host tombstones")
    ids_h, d_h = stream(lambda: host.search(Qh, K))
    ids_m, d_m = hbm.search(Qh, K)
    check(not np.isin(ids_h, gone).any(), "streamed exact returned a removed id")
    close_topk("streamed exact with 1000 tombstones", ids_h, d_h, ids_m, d_m, 3e-5)
    for name, (launches, mma) in streamed.items():
        check(launches > 0 and mma == launches, f"streamed searches: {name} launches {launches}, {mma} mma")
    print(
        f"[host] remove(1000) leaves {host.tombstones} tombstones on the read-only memory maps; "
        f"streamed exact B={B_MAIN} == the device storage's (rtol 3e-5), no removed id back; "
        f"streamed searches launched K1 {streamed['K1'][0]} times, K2 {streamed['K2'][0]} "
        f"times, all in their tensor-core bodies | {card}",
        flush=True,
    )
    return {"K1": streamed["K1"][0], "K2": streamed["K2"][0], "mesh": mesh_launches, **times}


def stream_times(card: str, host, Qh, shape: str, nbytes: int, stream, streaming) -> dict:
    """The pinned-copy ceiling, the host staging rate, streamed exact search
    at B=1 and B=64, the achieved host -> device rate of one streamed pass,
    and the tile-size sweep."""
    gb = 1 << 30
    src = torch.empty(gb, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(gb, dtype=torch.uint8, device="cuda")
    ceiling = gb / (cuda_ms(lambda: dst.copy_(src, non_blocking=True), 1) * 1e-3)  # warm-up
    ceiling = gb / (cuda_ms(lambda: dst.copy_(src, non_blocking=True), 5) * 1e-3)
    tile_rows = streaming.default_tile_rows([host._host_vectors])
    buf = torch.empty((tile_rows, DIM_HOST), dtype=torch.float32, pin_memory=True).numpy()
    rates = []
    for s in (0, tile_rows, 2 * tile_rows):
        t0 = time.perf_counter()
        streaming._read_rows(host._host_vectors, s, buf)
        rates.append(buf.nbytes / (time.perf_counter() - t0))
    del src, dst, buf
    print(
        f"[times] pinned host -> device copy of 1 GiB (copy_ non_blocking, CUDA events, 5 copies): "
        f"{ceiling / 1e9!r} GB/s; host staging (np.copyto from the memory maps into a pinned tile "
        f"of {tile_rows} rows): {[r / 1e9 for r in rates]!r} GB/s | {card}",
        flush=True,
    )
    stream(lambda: search_times(card, host, Qh, "exact", shape, ((1, 10), (B_MAIN, 5)), "exact, streamed from host"))
    passes = []
    for _ in range(3):
        t0 = time.perf_counter()
        stream(lambda: host.search(Qh, K))
        passes.append(time.perf_counter() - t0)
    one = float(np.median(passes))
    print(
        f"[times] one streamed exact pass at B={B_MAIN}: median {one!r} s of 3, {nbytes / one / 1e9!r} "
        f"GB/s host -> device, {one / (nbytes / ceiling):.2f}x the pinned-copy time of the "
        f"{nbytes / 1e9:.2f} GB ({streaming.DEFAULT_TILE_BYTES >> 20} MiB tiles) | {card}",
        flush=True,
    )
    def sweep(name: str, values) -> dict:
        """Median of 3 streamed exact B=64 passes with streaming.<name> set
        to each value (after a warm-up pass)."""
        out, default = {}, getattr(streaming, name)
        try:
            for v in values:
                setattr(streaming, name, v)
                stream(lambda: host.search(Qh, K))
                walls = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    stream(lambda: host.search(Qh, K))
                    walls.append(time.perf_counter() - t0)
                out[v] = float(np.median(walls))
        finally:
            setattr(streaming, name, default)
        return out

    tiles = {t >> 20: s for t, s in sweep("DEFAULT_TILE_BYTES", TILE_SWEEP).items()}
    threads = sweep("STAGING_THREADS", THREAD_SWEEP)
    for name, got in (("tile MiB", tiles), (f"staging threads ({streaming.DEFAULT_TILE_BYTES >> 20} MiB tiles)", threads)):
        print(
            f"[times] sweep of {name}, streamed exact B={B_MAIN} pass, median of 3 (s): {got!r}; "
            f"GB/s {({k: nbytes / s / 1e9 for k, s in got.items()})!r} | {card}",
            flush=True,
        )
    return {"pinned_gbps": ceiling / 1e9, "stream_pass_s": one, "tile_sweep_s": tiles,
            "thread_sweep_s": threads}


def phase_frontends(card: str, Q) -> dict:
    """Phase 10: the SQL surface, serving, the CLI and the non-finite
    policies, at the main path's width. The 1,000,000 x 384 FLOAT32 rows of
    phase 4 (the seed's generator again) go into a SQLite file in
    _smoke_data/ (removed at the end); `ref` is a Dataset of the same rows
    (the main dataset as phase 4 built it, before phase 8's mutations).
    Returns K1's and K2's launches on the SQL path, by body."""
    root = Path(__file__).resolve().parent / "_smoke_data"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir()
    try:
        return frontends(card, Q, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


MESH_SHARDS = 4
# phase 11's ids_filter and tombstones
MESH_FILTER = 100_000
MESH_REMOVE = 10_000


def walls_in_turns(fns, reps: int) -> list[list[float]]:
    """Host-clock seconds of each fn's calls, `reps` rounds of turns (fn
    order reversed every other round) after one warm-up call of each; every
    call ends on the host (search returns host arrays)."""
    for fn in fns:
        fn()
    walls = [[] for _ in fns]
    for r in range(reps):
        for i in (range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))):
            t0 = time.perf_counter()
            fns[i]()
            walls[i].append(time.perf_counter() - t0)
    return walls


def mesh_search(label: str, ds, one, others, q, mode: str, flt, kernel: str, shards: int, k_merge: int) -> dict:
    """One search on the mesh dataset `ds`: K1 or K2 launched once per
    shard, each in its tensor-core body (counted as phases 5 and 7 count),
    the merge gathering 8 * D * B * k bytes; the result equal to the
    one-device dataset's (and to each of `others`, meshes of other shapes):
    bit-equal for the code scans, within the float32 tolerance for exact,
    rtol 1e-5 for rerank (one device rescores fresh codes on its fused
    route). Returns the launches of this search alone, by kernel."""
    from sqlite_vector_tpu_torch.parallel import GATHERED, collective_bytes_per_query

    c0 = counts()
    GATHERED.reset()
    got = ds.search(q, K, mode=mode, ids_filter=flt)
    merged = GATHERED.merge
    c1 = counts()
    launched = {name: c1[name][0] - c0[name][0] for name in c1}
    mma = c1[kernel][1] - c0[kernel][1]
    check(launched[kernel] == shards and mma == shards,
          f"{label}: {kernel} launched {launched[kernel]} times ({mma} on tensor cores), not once a shard")
    check(merged == collective_bytes_per_query(shards, q.shape[0], k_merge),
          f"{label}: the merge gathered {merged} bytes")
    for other, name in [(one, "one device")] + others:
        want = other.search(q, K, mode=mode, ids_filter=flt)
        if mode in ("quantized",):
            same_topk(f"{label} vs {name}", *got, *want)
        else:
            close_topk(f"{label} vs {name}", *got, *want, 3e-5 if mode == "exact" else 1e-5)
    return launched


def mesh_parity(card: str, rows: np.ndarray, Q, devices: list, label: str) -> dict:
    """Phase 11 part 1 on a 1-D mesh over `devices`: exact, int4, int8 and
    rerank search at B=1 and B=64, unmasked, with an ids_filter of 100,000
    ids and with 10,000 tombstones, against the one-device dataset and a
    1-shard mesh over the same rows; codes and params bit-equal to the
    one-device build; refine refused. Returns the K1 and K2 launches of the
    mesh's own searches (not those of the datasets it is compared with)
    and the datasets."""
    import sqlite_vector_tpu_torch as svt
    from sqlite_vector_tpu_torch.parallel import make_mesh

    opts = f"dimension={DIM_MAIN},type=FLOAT32,distance=L2"
    shards = len(devices)
    t0 = time.perf_counter()
    one = svt.Dataset.from_arrays("one", rows, options=opts, device="cuda")
    mesh = svt.Dataset.from_arrays("mesh", rows, options=opts, mesh=make_mesh(devices=devices))
    solo = svt.Dataset.from_arrays("mesh1", rows, options=opts, mesh=make_mesh(devices=devices[:1]))
    torch.cuda.synchronize()
    check(mesh._vectors.n_shards == shards and solo._vectors.n_shards == 1, "mesh layouts")
    print(
        f"[mesh] {label}: {N_MAIN} x {DIM_MAIN} FLOAT32 L2 rows (phase 4's) on a {shards}-shard mesh "
        f"over {sorted({str(d) for d in devices})} ({mesh._vectors.shard_rows} rows a shard, "
        f"{mesh.memory_bytes()} device bytes), a 1-shard mesh and one device, built in "
        f"{time.perf_counter() - t0:.1f} s | {card}",
        flush=True,
    )
    rng = np.random.default_rng(SEED + 11)
    flt = rng.choice(N_MAIN, MESH_FILTER, replace=False) + 1
    others = [(solo, "1-shard mesh")]
    own = {"K1": 0, "K2": 0}
    n_search = 0

    def run(tag: str, modes, filters=(None, flt)):
        nonlocal n_search
        for mode, kernel, k_merge in modes:
            for f in filters:
                for b in (1, B_MAIN):
                    name = f"{label} {mode} {tag}{' filtered' if f is not None else ''} B={b}"
                    launched = mesh_search(name, mesh, one, others, Q[:b], mode, f, kernel, shards, k_merge)
                    for n in own:
                        own[n] += launched[n]
                    n_search += 1

    exact = ("exact", "K1", K)
    run("", [exact])
    # int4: codes bit-equal, then searched; tombstones over the stale snapshot
    for ds in (one, mesh, solo):
        ds.quantize(qtype="int4")
    for a, b in ((mesh._quant.codes, one._quant.codes), (mesh._quant.row_scale, one._quant.row_scale),
                 (mesh._quant.sq_norms, one._quant.sq_norms)):
        check(torch.equal(a.read(0, N_MAIN), b.cpu()), "int4 codes, alpha or csq differ from one device's")
    run("", [("quantized", "K2", K)])
    gone = rng.choice(N_MAIN, MESH_REMOVE, replace=False) + 1
    for ds in (one, mesh, solo):
        check(ds.remove(gone) == MESH_REMOVE and ds.tombstones == MESH_REMOVE, "remove")
    run("with tombstones", [exact, ("quantized", "K2", K)], (None,))
    # int8 (quantize compacts the tombstones away), rerank, then tombstones
    for ds in (one, mesh, solo):
        ds.quantize()
    check(mesh.quant_params == one.quant_params == solo.quant_params, "int8 params differ from one device's")
    check(torch.equal(mesh._quant.codes.read(0, len(one)), one._quant.codes.cpu()), "int8 codes differ")
    rerank = ("rerank", "K1", K * 4)
    run("", [("quantized", "K1", K), rerank])
    gone = rng.choice(one.ids, MESH_REMOVE, replace=False)
    for ds in (one, mesh, solo):
        check(ds.remove(gone) == MESH_REMOVE, "remove")
    run("with tombstones", [exact, ("quantized", "K1", K), rerank], (None,))
    for ds, name in ((mesh, "mesh"), (solo, "1-shard mesh")):
        try:
            ds.quantize(qtype="int4", refine=True)
            raise RuntimeError(f"chip_smoke check failed: refine ran on the {name}")
        except svt.VectorConfigError:
            pass
    print(
        f"[mesh] {label}: {n_search} searches (exact, int4, int8, rerank; B=1 and B={B_MAIN}, k={K}; "
        f"unmasked, a {MESH_FILTER:,}-id ids_filter, {MESH_REMOVE:,} tombstones) each == one device "
        f"and == a 1-shard mesh (codes bit-equal, exact within rtol 3e-5, rerank 1e-5); int8 params "
        f"and int4/int8 codes bit-equal to the one-device build; every search launched K1 or K2 "
        f"once a shard on its tensor-core body and merged 8*{shards}*B*k bytes (the mesh's own "
        f"searches launched K1 {own['K1']}, K2 {own['K2']} times); refine refused | {card}",
        flush=True,
    )
    return {**own, "one": one, "mesh": mesh, "solo": solo}


def mesh_times(card: str, one, mesh, Q) -> dict:
    """Phase 11's times on a mesh against one device: B=1 p50 and B=64
    QPS in turns (host clock), K1 and K2 alone on the first shard and on
    the whole rows (CUDA events), and the merge onto the first device."""
    from sqlite_vector_tpu_torch.ops.block_scan import block_minima
    from sqlite_vector_tpu_torch.ops.int4_scan import int4_block_minima
    from sqlite_vector_tpu_torch.ops.quantize4 import quantize4_device, quantize_query_int8
    from sqlite_vector_tpu_torch.ops.scan import fused_scan_topk
    from sqlite_vector_tpu_torch.parallel.ops import merge_candidates
    from sqlite_vector_tpu_torch.types import DistanceMetric

    L2 = DistanceMetric.L2
    out = {}
    note = ("the shards share one card, so these times show the mesh's overhead, not a scaling"
            if len({str(d) for d in mesh._mesh.devices.reshape(-1)}) == 1 else "one shard a card")
    for mode in ("exact", "quantized"):
        for b, reps in ((1, 60), (B_MAIN, 12)):
            walls = walls_in_turns([lambda ds=ds: ds.search(Q[:b], K, mode=mode) for ds in (one, mesh)], reps)
            one_s, mesh_s = (float(np.median(w)) for w in walls)
            key = f"{mode} ({one._quant.qtype.value if mode == 'quantized' else 'f32'}) B={b}"
            out[key] = {"one_device_ms": one_s * 1e3, "mesh_ms": mesh_s * 1e3,
                        "one_device_qps": b / one_s, "mesh_qps": b / mesh_s}
            print(
                f"[times] mesh search {key} k={K}, {reps} calls each in turns (host clock): "
                f"p50 one device {one_s * 1e3!r} ms ({b / one_s!r} QPS), {mesh._vectors.n_shards}-shard "
                f"mesh {mesh_s * 1e3!r} ms ({b / mesh_s!r} QPS), {mesh_s / one_s:.2f}x; {note} | {card}",
                flush=True,
            )
    qd = torch.from_numpy(Q).cuda()
    vecs = mesh._vectors
    shard, sr = vecs.part(0), vecs.shard_rows
    whole = one._vectors[: len(one)]
    k1_shard, k1_whole = in_turns([lambda: block_minima(qd.to(shard.device), shard, L2, sr),
                                   lambda: block_minima(qd, whole, L2, len(one))], 10)
    # K2 over int4 codes of the same rows (quantize4_device), a shard and the whole
    qc, qs, _ = quantize_query_int8(qd)
    p4_shard, p4_whole = quantize4_device(shard), quantize4_device(whole)
    qc_s, qs_s = qc.to(shard.device), qs.to(shard.device)
    k2_shard, k2_whole = in_turns([lambda: int4_block_minima(qc_s, qs_s, *p4_shard, L2, sr),
                                   lambda: int4_block_minima(qc, qs, *p4_whole, L2, len(one))], 10)
    del p4_shard, p4_whole
    parts = []
    for i, part in enumerate(vecs.parts()):
        v, p = fused_scan_topk(qd.to(part.device), part, L2, K)
        parts.append((v, torch.where(p >= 0, p + i * sr, -1).to(torch.int32)))
    merge_ms = cuda_ms(lambda: merge_candidates(parts, K, qd.device), 50)
    print(
        f"[times] K1 (f32 L2, B={B_MAIN}, tensor-core body) alone on one shard of {sr} rows "
        f"{k1_shard!r} ms, on the {len(one)} rows of one device {k1_whole!r} ms; K2 (int4 "
        f"codes of the same rows) {k2_shard!r} ms a shard, {k2_whole!r} ms on one device "
        f"(CUDA events, in turns); the merge of {len(parts)} x [{B_MAIN}, {K}] candidates "
        f"{merge_ms!r} ms | {card}",
        flush=True,
    )
    out.update(k1_shard_ms=k1_shard, k1_one_device_ms=k1_whole, k2_shard_ms=k2_shard,
               k2_one_device_ms=k2_whole, merge_ms=merge_ms)
    return out


def mesh_2d(card: str, rows: np.ndarray, Q) -> None:
    """Phase 11 part 3: a 2 x 2 (rows x dim) mesh on the card over the main
    rows: exact L2 at B=1 and B=64 against the plain-torch ground truth
    (tie-aware, rel_tol 1e-4: float32 partial sums added across the dim
    shards) and the one-device values; int8 params, codes and values
    bit-equal to one device's; INT4 and host storage refused."""
    import sqlite_vector_tpu_torch as svt
    from sqlite_vector_tpu_torch.ops.distance import pairwise_distance
    from sqlite_vector_tpu_torch.parallel import make_mesh_2d
    from sqlite_vector_tpu_torch.types import DistanceMetric

    parity = load_tests_module("parity")
    opts = f"dimension={DIM_MAIN},type=FLOAT32,distance=L2"
    mesh = make_mesh_2d(2, 2, devices=["cuda:0"] * 4)
    one = svt.Dataset.from_arrays("one", rows, options=opts, device="cuda")
    t0 = time.perf_counter()
    ds = svt.Dataset.from_arrays("m22", rows, options=opts, mesh=mesh)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    ids_all = one.ids
    qd = torch.from_numpy(Q).cuda()
    oracle = pairwise_distance(qd, one._vectors[: len(one)], DistanceMetric.L2).cpu().numpy()
    walls = {}
    for b in (1, B_MAIN):
        t0 = time.perf_counter()
        got_ids, got_d = ds.search(Q[:b], K)
        walls[b] = time.perf_counter() - t0
        want_ids, want_d = one.search(Q[:b], K)
        check(np.allclose(got_d, want_d, rtol=1e-4, atol=1e-5), f"2x2 exact B={b}: values differ from one device's")
        for i in range(b):
            parity.assert_topk_parity(*top_rows(ids_all, oracle[i]), got_ids[i], got_d[i], K,
                                      rel_tol=1e-4, label=f"2x2 exact B={b} q{i}")
    one.quantize()
    ds.quantize()
    check(ds.quant_params == one.quant_params, "2x2 int8 params differ from one device's")
    check(torch.equal(ds._quant.codes.read(0, len(one)), one._quant.codes.cpu()), "2x2 int8 codes differ")
    for b in (1, B_MAIN):
        same_topk(f"2x2 int8 B={b}", *ds.search(Q[:b], K, exact=False), *one.search(Q[:b], K, exact=False))
    for what, fn in (("qtype=INT4", lambda: ds.quantize(qtype="int4")),
                     ("storage='host'", lambda: svt.Dataset("h", svt.parse_options(opts), mesh=mesh, storage="host"))):
        try:
            fn()
            raise RuntimeError(f"chip_smoke check failed: {what} ran on the 2 x 2 mesh")
        except svt.VectorConfigError:
            pass
    print(
        f"[mesh] 2 x 2 (rows x dim) mesh on the card: built in {t_build:.1f} s; exact L2 B=1 "
        f"({walls[1] * 1e3:.1f} ms) and B={B_MAIN} ({walls[B_MAIN] * 1e3:.1f} ms, first calls) match the "
        f"plain-torch ground truth (tie-aware, rel_tol 1e-4) and one device's values (rtol 1e-4); int8 "
        f"params, codes and results bit-equal to one device's; INT4 and host storage refused | {card}",
        flush=True,
    )


def main_rows() -> tuple[np.ndarray, np.ndarray]:
    """Phase 4's rows and queries, drawn again from its seed chunk by chunk."""
    rng = np.random.default_rng(SEED)
    chunk = min(100_000, N_MAIN)
    rows = np.concatenate([rng.standard_normal((chunk, DIM_MAIN), dtype=np.float32) for _ in range(N_MAIN // chunk)])
    picks = rng.choice(N_MAIN, B_MAIN // 2, replace=False)
    Q = np.concatenate([rows[picks], rng.standard_normal((B_MAIN - B_MAIN // 2, DIM_MAIN), dtype=np.float32)])
    return rows, Q


def phase_mesh(card: str, Q) -> dict:
    """Phase 11: the mesh on the card (parts 1 and 3; part 2 runs inside
    phase 9, on its files): a 4-shard 1-D mesh over the main rows against
    one device (every mode, mask and batch), its times, a 2 x 2 mesh, and
    where there are several cards phase_cards. Returns the 4-shard mesh's
    K1 and K2 launches, its times and the 4-shard mesh dataset (phase 12
reads its merge bytes)."""
    rows, _ = main_rows()
    zero_counts()
    res = mesh_parity(card, rows, Q, ["cuda:0"] * MESH_SHARDS, f"{MESH_SHARDS} shards on cuda:0")
    counted = counts()
    check(counted["K1"][0] > 0 and counted["K2"][0] > 0, "the mesh searches launched no K1 or no K2")
    mesh_ds = res.pop("mesh")
    times = mesh_times(card, res.pop("one"), mesh_ds, Q)
    res.pop("solo")
    torch.cuda.empty_cache()
    mesh_2d(card, rows, Q)
    if torch.cuda.device_count() > 1:
        phase_cards(card, rows, Q)
    else:
        print(f"[mesh] a mesh over several cards: not run (torch.cuda.device_count() == "
              f"{torch.cuda.device_count()}) | {card}", flush=True)
    return {"K1": res["K1"], "K2": res["K2"], "times": times, "dataset": mesh_ds}


def phase_cards(card: str, rows: np.ndarray, Q) -> None:
    """Phase 11 on a machine of several cards: part 1 on a mesh of one
    shard a card and its times, then the same rows with storage="host"
    streamed to every card at once (one pipeline a card), exact, int8 and
    int4 at B=1 and B=64, streamed and then preloaded, against one device;
    every search launching K1 or K2 once a shard and tile."""
    import sqlite_vector_tpu_torch as svt
    from sqlite_vector_tpu_torch.parallel import make_mesh

    devs = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    res = mesh_parity(card, rows, Q, devs, f"{len(devs)} shards, one a card")
    mesh_times(card, res["one"], res["mesh"], Q)
    del res
    torch.cuda.empty_cache()
    opts = f"dimension={DIM_MAIN},type=FLOAT32,distance=L2"
    host = svt.Dataset.from_arrays("h", rows, options=opts, mesh=make_mesh(devices=devs), storage="host")
    ref = svt.Dataset.from_arrays("r", rows, options=opts, device="cuda")
    own = {"K1": 0, "K2": 0}
    for qtype in (None, "int8", "int4"):
        mode, kernel = ("exact", "K1") if qtype is None else ("quantized", "K2" if qtype == "int4" else "K1")
        if qtype:
            host.quantize(qtype=qtype)
            ref.quantize(qtype=qtype)
        for b in (1, B_MAIN):
            label = f"host storage on {len(devs)} cards, {qtype or 'exact'} B={b}"
            t0 = time.perf_counter()
            got, n = mesh_counted(label, host, mode, kernel, Q[:b])
            wall = time.perf_counter() - t0
            own[kernel] += n
            want = ref.search(Q[:b], K, mode=mode)
            if qtype is None:
                close_topk(label, *got, *want, 3e-5)
            else:
                same_topk(label, *got, *want)
            print(f"[mesh] {label} == one device, {kernel} {n} launches; first call {wall * 1e3:.1f} ms | {card}",
                  flush=True)
        if qtype:
            host.preload()
            label = f"host storage on {len(devs)} cards, {qtype} preloaded"
            got, n = mesh_counted(label, host, mode, kernel, Q)
            own[kernel] += n
            same_topk(label, *got, *ref.search(Q, K, mode=mode))
    print(f"[mesh] host storage streamed to {len(devs)} cards at once: exact, int8 and int4 (streamed and "
          f"preloaded) == one device; its searches launched K1 {own['K1']}, K2 {own['K2']} times | {card}",
          flush=True)
    del host, ref
    torch.cuda.empty_cache()


def mesh_scan_launches(ds, mode: str) -> int:
    """The K1 or K2 launches one search of the 1-D mesh dataset `ds` makes:
    one a shard where the scanned rows lie on the devices, one a shard and
    tile where they stream from host memory (ops/streaming.py's runs)."""
    from sqlite_vector_tpu_torch.ops import streaming
    from sqlite_vector_tpu_torch.parallel import RowShards

    quant = ds._quant if mode == "quantized" else None
    if quant is None:
        arrays, n = ([ds._host_vectors], ds._count) if ds._storage == "host" else (None, 0)
    elif isinstance(quant.codes, (torch.Tensor, RowShards)):
        arrays, n = None, 0
    else:
        int4 = quant.qtype.value == "INT4"
        arrays, n = ([quant.codes, quant.row_scale, quant.sq_norms] if int4 else [quant.codes]), quant.count
    if arrays is None:
        return ds._mesh.size
    runs, tile = streaming._runs(n, streaming.default_tile_rows(arrays), torch.device("cuda"), ds._mesh)
    return sum(-(-cnt // min(tile, cnt)) for _, _, cnt in runs if cnt)


def mesh_counted(label: str, ds, mode: str, kernel: str, q) -> tuple:
    """ds.search(q, K, mode=mode) on a 1-D mesh dataset, checked to launch
    `kernel` as often as mesh_scan_launches says, each launch in its
    tensor-core body. Returns the (ids, values) and those launches."""
    want = mesh_scan_launches(ds, mode)
    c0 = counts()
    got = ds.search(q, K, mode=mode)
    c1 = counts()
    n, mma = (c1[kernel][i] - c0[kernel][i] for i in (0, 1))
    check(n == mma == want, f"{label}: {kernel} launched {n} times ({mma} on tensor cores), not {want}")
    return got, n


def mesh_wide(card: str, d: str, hbm, Qh) -> dict:
    """Phase 11 part 2, on phase 9's files: its 2,000,000 x 768 rows (BASELINE.json
    config 5's width, its 10,000,000 rows cut to 2,000,000 for the smoke's
    time) loaded onto the 4-shard mesh with storage="hbm" and with
    storage="host", mmap=True (each shard's rows streamed to its device),
    searched exact, int4 and int8 at B=64 against phase 9's one-device
    hbm load `hbm`. Returns the K1 and K2 launches of the mesh datasets'
    searches (each checked by mesh_counted), not those of `hbm`."""
    import sqlite_vector_tpu_torch as svt
    from sqlite_vector_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=["cuda:0"] * MESH_SHARDS)
    t0 = time.perf_counter()
    m_hbm = svt.Dataset.load(d, mesh=mesh)
    torch.cuda.synchronize()
    t_hbm = time.perf_counter() - t0
    m_host = svt.Dataset.load(d, mesh=mesh, storage="host", mmap=True)
    launched = {"K1": 0, "K2": 0}
    want = hbm.search(Qh, K)
    walls = {}
    for ds, name in ((m_hbm, "hbm"), (m_host, "host")):
        t0 = time.perf_counter()
        got, n = mesh_counted(f"768-wide mesh {name} exact", ds, "exact", "K1", Qh)
        walls[name] = time.perf_counter() - t0
        launched["K1"] += n
        close_topk(f"768-wide mesh {name} exact", *got, *want, 3e-5)
    built = {}
    for qtype, kernel in (("int4", "K2"), ("int8", "K1")):
        if qtype == "int8":
            hbm.quantize()
        want = hbm.search(Qh, K, mode="quantized")  # phase 9 left hbm's int4 build in place
        for ds, name in ((m_hbm, "hbm"), (m_host, "host")):
            t0 = time.perf_counter()
            ds.quantize(qtype=qtype)
            built[f"{name} {qtype}"] = time.perf_counter() - t0
            got, n = mesh_counted(f"768-wide mesh {name} {qtype}", ds, "quantized", kernel, Qh)
            launched[kernel] += n
            same_topk(f"768-wide mesh {name} {qtype}", *got, *want)
        m_host.preload()
        got, n = mesh_counted(f"768-wide mesh host {qtype} preloaded", m_host, "quantized", kernel, Qh)
        launched[kernel] += n
        same_topk(f"768-wide mesh host {qtype} preloaded", *got, *want)
    print(
        f"[mesh] 768 wide (phase 9's {N_HOST:,} x {DIM_HOST} file, rows cut from BASELINE.json config 5's "
        f"10,000,000): load onto {MESH_SHARDS} shards on cuda:0 storage='hbm' {t_hbm:.1f} s and "
        f"storage='host', mmap=True; exact B={B_MAIN} == one device (rtol 3e-5; first call hbm "
        f"{walls['hbm'] * 1e3:.1f} ms, host streamed {walls['host'] * 1e3:.1f} ms), int4 and int8 "
        f"(streamed, preloaded, hbm) bit-equal to one device; quantize s {built!r}; K1 launches "
        f"{launched['K1']}, K2 {launched['K2']}, all on tensor cores | {card}",
        flush=True,
    )
    del m_hbm, m_host
    torch.cuda.empty_cache()
    return launched


def p50_p99(walls) -> tuple[float, float]:
    return tuple(float(np.percentile(walls, p)) * 1e3 for p in (50, 99))


def frontends(card: str, Q, root: Path) -> dict:
    import sqlite3

    import sqlite_vector_tpu_torch as svt
    import sqlite_vector_tpu_torch.sqlite as psql
    from sqlite_vector_tpu_torch import native

    opts = f"dimension={DIM_MAIN},type=FLOAT32,distance=L2"
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)  # phase 4's rows, chunk by chunk
    rows = np.concatenate([rng.standard_normal((100_000, DIM_MAIN), dtype=np.float32) for _ in range(N_MAIN // 100_000)])
    ref = svt.Dataset.from_arrays("ref", rows, options=opts, device="cuda")
    path = str(root / "frontends.db")
    raw = sqlite3.connect(path)
    raw.execute("CREATE TABLE docs (id INTEGER PRIMARY KEY, embedding BLOB)")
    raw.executemany("INSERT INTO docs (embedding) VALUES (?)", ((r.tobytes(),) for r in rows))
    raw.commit()
    raw.close()
    nbytes = rows.nbytes
    print(f"[sql] wrote {N_MAIN} x {DIM_MAIN} FLOAT32 rows as blobs into {Path(path).name} "
          f"({os.path.getsize(path) / 1e9:.2f} GB, one transaction) in {time.perf_counter() - t0:.1f} s "
          f"(host data generation included) | {card}", flush=True)

    # -- the native host modules, built from csrc/ with g++ and gcc --------
    t0 = time.perf_counter()
    loader_built, vtab = native.available(), native.vtab_extension_path()
    print(f"[build] csrc/svt_native.cpp {'built' if loader_built else 'not built (no Python headers?)'}, "
          f"csrc/svt_vtab.c {'built' if vtab else 'NOT built'} against csrc/third_party/ into "
          f"{native.build_dir()} in {time.perf_counter() - t0:.1f} s "
          f"| {card}", flush=True)

    # -- the connection: the card by default, the real virtual tables -------
    conn = psql.connect(path)
    check(conn.device.type == "cuda", f"connect() placed the datasets on {conn.device}")
    check(conn.vtab_loaded, "the vtab extension did not load: the reference's SQL cannot run verbatim")
    conn.execute(f"SELECT vector_init('docs', 'embedding', '{opts}')")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = conn._refresh(conn._lookup("docs", "embedding", "chip_smoke"))
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    check(len(ds) == N_MAIN, f"the connection loaded {len(ds)} rows")
    loader = conn.last_loader
    ctx = conn._lookup("docs", "embedding", "chip_smoke")
    t0 = time.perf_counter()
    conn._load_rows(ctx, min_pk=None)
    t_rows = time.perf_counter() - t0
    # the other route for the same rows: inside an open transaction the
    # native loader (which reads the committed file) is skipped
    conn.execute("BEGIN")
    t0 = time.perf_counter()
    conn._load_rows(ctx, min_pk=None)
    t_rows_py = time.perf_counter() - t0
    check(conn.last_loader == "python", f"the load inside a transaction took the {conn.last_loader} loader")
    conn.rollback()
    print(f"[sql] connect(): vtab loaded; cold load of the table by the {loader} loader "
          f"(csrc/svt_native.cpp when 'native', the sqlite3 row loop when 'python'): {t_load!r} s, "
          f"{nbytes / t_load / 1e9:.2f} GB/s of rows onto the card; the host walk alone, again (page cache "
          f"warm): {loader} loader {t_rows!r} s, sqlite3 row loop {t_rows_py!r} s | {card}", flush=True)
    out = {"t_load_s": t_load, "t_rows_s": t_rows, "t_rows_python_s": t_rows_py, "loader": loader}
    sql_counts = {"K1": [0, 0], "K2": [0, 0]}

    def counted(fn):
        """Run fn with every launch count set to 0 just before it; add what
        it launched, read just after, to sql_counts."""
        zero_counts()
        r = fn()
        for name, (launches, mma) in counts().items():
            sql_counts[name][0] += launches
            sql_counts[name][1] += mma
        return r

    def sql_scans(sql: str, k: int = K):
        """The 64 queries through `sql`, one call each: rows and walls."""
        got, walls = [], []
        for q in Q:
            t = time.perf_counter()
            got.append(conn_now.execute(sql, (q.tobytes(), k)).fetchall())
            walls.append(time.perf_counter() - t)
        return got, walls

    # -- vector_full_scan against Dataset.search ---------------------------
    full_sql = "SELECT id, distance FROM vector_full_scan('docs', 'embedding', ?, ?)"
    conn_now = conn
    for q in Q[:3]:  # warm-up, uncounted
        conn.execute(full_sql, (q.tobytes(), K)).fetchall()
    got, sql_walls = counted(lambda: sql_scans(full_sql))
    k1 = counts()["K1"][0]
    check(k1 == len(Q) and counts()["K1"][1] == k1 and counts()["K2"][0] == 0,
          f"64 vector_full_scan calls launched K1 {k1} times (tensor-core body each time expected)")
    ref_walls, want = [], []
    for q in Q[:3]:
        ref.search(q, K)
    for q in Q:
        t = time.perf_counter()
        want.append(ref.search(q, K))
        ref_walls.append(time.perf_counter() - t)
    for i, (g, (wi, wd)) in enumerate(zip(got, want)):
        close_topk(f"SQL vector_full_scan q{i}", np.array([[r[0] for r in g]]), np.array([[r[1] for r in g]], np.float32),
                   wi[None], wd[None], 1e-5)
    sql_p50, sql_p99 = p50_p99(sql_walls)
    print(f"[sql] SELECT id, distance FROM vector_full_scan('docs', 'embedding', ?, 20) for the {len(Q)} queries "
          f"== Dataset.search(q, 20) (tie-aware, rtol 1e-5); K1 launched once a call, tensor-core body | {card}",
          flush=True)
    print(f"[times] SQL vector_full_scan B=1 k={K}: p50 {sql_p50!r} ms, p99 {sql_p99!r} ms over {len(Q)} calls; "
          f"Dataset.search B=1 p50 {p50_p99(ref_walls)[0]!r} ms in the same run | {card}", flush=True)
    out.update(sql_full_p50_ms=sql_p50, sql_full_p99_ms=sql_p99, search_p50_ms=p50_p99(ref_walls)[0])

    # -- int8: vector_quantize, preload, own and cross connection ----------
    quant_sql = "SELECT id, distance FROM vector_quantize_scan('docs', 'embedding', ?, ?)"
    t0 = time.perf_counter()
    conn.execute("SELECT vector_quantize('docs', 'embedding')").fetchall()
    torch.cuda.synchronize()
    t_q8 = time.perf_counter() - t0
    conn.execute("SELECT vector_quantize_preload('docs', 'embedding')").fetchall()
    t0 = time.perf_counter()
    ref.quantize()
    torch.cuda.synchronize()
    t_build8 = time.perf_counter() - t0
    want8 = [ref.search(q, K, exact=False) for q in Q]

    def same_rows(label, got_rows, want_rows):
        for i, (g, (wi, wd)) in enumerate(zip(got_rows, want_rows)):
            check([r[0] for r in g] == wi.tolist() and [r[1] for r in g] == wd.astype(np.float64).tolist(),
                  f"{label} q{i}: not bit-equal to the Dataset's quantized search")

    got8, _ = counted(lambda: sql_scans(quant_sql))
    same_rows("SQL int8 vector_quantize_scan", got8, want8)
    conn2 = psql.connect(path)
    conn2.execute(f"SELECT vector_init('docs', 'embedding', '{opts}')")
    t0 = time.perf_counter()
    conn2.execute("SELECT vector_quantize_preload('docs', 'embedding')").fetchall()
    torch.cuda.synchronize()
    t_shadow8 = time.perf_counter() - t0
    conn_now = conn2
    got8x, _ = counted(lambda: sql_scans(quant_sql))
    same_rows("SQL int8 vector_quantize_scan, second connection", got8x, want8)
    check(conn2._contexts[("docs", "embedding")].dataset is None, "the second connection loaded the rows")
    check(sql_counts["K1"] == [3 * len(Q), 3 * len(Q)], f"SQL scans launched K1 {sql_counts['K1']}")
    print(f"[sql] vector_quantize (int8) + preload, then vector_quantize_scan: bit-equal to Dataset.search(q, 20, "
          f"exact=False); a second connection scans the codes read from the shadow table, bit-equal too; K1 "
          f"launches on the SQL path so far {sql_counts['K1'][0]}, all tensor-core | {card}", flush=True)

    # -- int4: own connection and cross connection, through K2 -------------
    conn_now = conn
    t0 = time.perf_counter()
    conn.execute("SELECT vector_quantize('docs', 'embedding', 'qtype=INT4')").fetchall()
    torch.cuda.synchronize()
    t_q4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref.quantize(qtype="int4")
    torch.cuda.synchronize()
    t_build4 = time.perf_counter() - t0
    want4 = [ref.search(q, K, mode="quantized") for q in Q]
    got4, _ = counted(lambda: sql_scans(quant_sql))
    same_rows("SQL int4 vector_quantize_scan", got4, want4)
    conn_now = conn2
    t0 = time.perf_counter()
    got4x, _ = counted(lambda: sql_scans(quant_sql))
    t_shadow4 = time.perf_counter() - t0
    same_rows("SQL int4 vector_quantize_scan, second connection", got4x, want4)
    check(sql_counts["K2"] == [2 * len(Q), 2 * len(Q)], f"SQL int4 scans launched K2 {sql_counts['K2']}")
    print(f"[sql] vector_quantize(..., 'qtype=INT4') and vector_quantize_scan, own and second connection: "
          f"bit-equal to the Dataset's int4 quantized search; K2 launches {sql_counts['K2'][0]}, all tensor-core "
          f"| {card}", flush=True)
    print(f"[times] vector_quantize wall (device build + shadow write): int8 {t_q8!r} s, int4 {t_q4!r} s; the "
          f"device build alone (Dataset.quantize of ref): int8 {t_build8!r} s, int4 {t_build4!r} s; second "
          f"connection's shadow load: int8 {t_shadow8!r} s (preload), int4 {t_shadow4!r} s (reload + {len(Q)} "
          f"scans) | {card}", flush=True)
    out.update(quantize8_s=t_q8, quantize4_s=t_q4, build8_s=t_build8, build4_s=t_build4, shadow_load8_s=t_shadow8)

    # -- the stream modules: every row -----------------------------------------
    q = Q[0]
    t0 = time.perf_counter()
    srows = conn.execute("SELECT id, distance FROM vector_full_scan_stream('docs', 'embedding', ?)",
                         (q.tobytes(),)).fetchall()
    t_stream = time.perf_counter() - t0
    check(len(srows) == N_MAIN, f"vector_full_scan_stream returned {len(srows)} rows")
    ids = np.array([r[0] for r in srows])
    d = np.array([r[1] for r in srows])
    check(np.array_equal(ids, ref.ids), "stream ids are not the rows' ids in order")
    check(np.allclose(d, ref.distances(q), rtol=1e-5, atol=1e-5), "vector_full_scan_stream != Dataset.distances(q)")
    qrows = conn.execute("SELECT id, distance FROM vector_quantize_scan_stream('docs', 'embedding', ?)",
                         (q.tobytes(),)).fetchall()
    check(len(qrows) == N_MAIN and [r[0] for r in qrows] == ref.ids.tolist(), "quantize stream ids")
    check(np.array_equal(np.array([r[1] for r in qrows], np.float32), ref.distances(q, exact=False)),
          "vector_quantize_scan_stream != Dataset.distances(q, exact=False)")
    print(f"[sql] vector_full_scan_stream and vector_quantize_scan_stream (int4) for one query: {N_MAIN} rows "
          f"each, == Dataset.distances(q) (rtol 1e-5) and Dataset.distances(q, exact=False) (bit-equal); full "
          f"stream {t_stream!r} s through SQLite | {card}", flush=True)

    out.update(nonfinite(card))
    out.update(serving(card, ref, rows, Q, path))
    # -- the CLI, as a subprocess ---------------------------------------------
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "sqlite_vector_tpu_torch", "search", path, "docs", "embedding",
         json.dumps(Q[0].tolist()), "-k", str(K), "--json", "--options", opts],
        capture_output=True, text=True, timeout=300, cwd=Path(__file__).resolve().parent,
    )
    t_cli = time.perf_counter() - t0
    check(cli.returncode == 0, f"the CLI failed: {cli.stderr[-2000:]}")
    check(json.loads(cli.stdout)["ids"] == [r[0] for r in got[0]], "the CLI's ids differ from the SQL results")
    print(f"[cli] python -m sqlite_vector_tpu_torch search <db> docs embedding <q> -k {K} --json: ids == the SQL "
          f"vector_full_scan's, in {t_cli!r} s (a new process: start, table load, kernel library load) | {card}",
          flush=True)
    conn.close()
    conn2.close()
    out["sql_launches"] = {name: {"launches": v[0], "mma": v[1]} for name, v in sql_counts.items()}
    return out


def nonfinite(card: str) -> dict:
    """1M x 384 float16 L2 and bfloat16 DOT rows with a NaN, +Inf or -Inf
    lane in 1% of the rows: exact search at B=1 and B=8 and distances at
    B=1 on the card, under the reference's non-finite policies, against the
    same ops on a CPU copy (B=1: all rows; B=8: the first 100,000)."""
    import sqlite_vector_tpu_torch as svt

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    x = torch.randn((N_MAIN, DIM_MAIN), generator=gen, device="cuda")
    bad = torch.randperm(N_MAIN, generator=gen, device="cuda")[: N_MAIN // 100]
    lane = torch.randint(0, DIM_MAIN, (len(bad),), generator=gen, device="cuda")
    x[bad, lane] = torch.tensor([float("nan"), float("inf"), float("-inf")], device="cuda").repeat(len(bad) // 3 + 1)[: len(bad)]
    qrow = int(bad[0])  # a row with a NaN lane: a non-finite query, and its own best match
    out, n8 = {}, 100_000
    for vtype, metric, dt in (("FLOAT16", "L2", torch.float16), ("FLOATB16", "DOT", torch.bfloat16)):
        vals = x.to(dt).float().cpu().numpy()  # the rows' exact values (bf16 as float32)
        q = np.concatenate([vals[qrow : qrow + 1], np.random.default_rng(SEED + 10).standard_normal((7, DIM_MAIN), dtype=np.float32)])
        opts = f"dimension={DIM_MAIN},type={vtype},distance={metric}"
        card_ds, cpu_ds = (svt.VectorStore(device=dv).create("nf", opts) for dv in ("cuda", "cpu"))
        card8, cpu8 = (svt.VectorStore(device=dv).create("nf8", opts) for dv in ("cuda", "cpu"))
        for ds_, rows_ in ((card_ds, vals), (cpu_ds, vals), (card8, vals[:n8]), (cpu8, vals[:n8])):
            ds_.add(rows_)
            check(ds_._has_nonfinite, "the non-finite flag is not set")
        label = f"{vtype} {metric}"
        got1, want1 = card_ds.search(q[:1], K), cpu_ds.search(q[:1], K)
        got8, want8 = card8.search(q, K), cpu8.search(q, K)
        for b, (g, w) in ((1, (got1, want1)), (8, (got8, want8))):
            close_topk(f"non-finite {label} B={b}", *g, *w, 1e-4)
            # -inf ties (DOT's infinite products) go to the earliest row on both sides
            at_inf = np.isinf(w[1])
            check(np.array_equal(g[0][at_inf], w[0][at_inf]), f"non-finite {label} B={b}: ids at -inf differ")
        if metric == "L2":
            check(got1[0][0, 0] == qrow + 1 and got1[1][0, 0] == 0.0, f"{label}: the NaN-lane row is not its own match at 0")
        dg, dw = card_ds.distances(q[0]), cpu_ds.distances(q[0])
        check(np.array_equal(np.isnan(dg), np.isnan(dw)) and np.array_equal(np.isinf(dg), np.isinf(dw)),
              f"{label}: distances' NaN/Inf positions differ between the card and the CPU")
        fin = np.isfinite(dw)
        check(np.allclose(dg[fin], dw[fin], rtol=1e-4, atol=1e-4), f"{label}: distances differ beyond rtol 1e-4")
        times = {}
        for b in (1, 8):
            walls = []
            for _ in range(5):
                t = time.perf_counter()
                card_ds.search(q[:b], K)
                walls.append(time.perf_counter() - t)
            times[b] = float(np.median(walls)) * 1e3
        out[f"nonfinite_{vtype}_ms"] = times
        print(f"[nonfinite] {N_MAIN} x {DIM_MAIN} {vtype} {metric}, a NaN/+Inf/-Inf lane in {len(bad)} rows: exact "
              f"search B=1 (all rows) and B=8 (first {n8} rows) on the card == the CPU (ids tie-aware, rtol 1e-4: "
              f"float32 lane sums in another order); distances B=1 equal, NaN/Inf positions identical; policy "
              f"search on the card median of 5: B=1 {times[1]!r} ms, B=8 {times[8]!r} ms | {card}", flush=True)
        del card_ds, cpu_ds, card8, cpu8
    return out


def serving(card: str, ref, rows, Q, path: str) -> dict:
    """BatchingSearcher on `ref` (exact and int8; every result against the
    direct search), a 10 s soak on a copy of the rows with a mutator and
    fallback_exact (zero errors, device memory back), then serve() on
    localhost."""
    import gc
    import urllib.request

    import sqlite_vector_tpu_torch as svt

    ref.quantize()
    direct = {mode: [ref.search(q, K, mode=mode) for q in Q] for mode in ("exact", "quantized")}
    out = {}
    for mode in ("exact", "quantized"):
        searcher = svt.BatchingSearcher(ref, max_batch=B_MAIN)
        got, lat, errors = {}, [], []

        def client(t):
            try:
                for r in range(8):
                    for i in range(t, len(Q), 8):
                        t0 = time.perf_counter()
                        got[r, i] = searcher.search(Q[i], K, mode=mode)
                        lat.append(time.perf_counter() - t0)
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        window = time.perf_counter() - t0
        searcher.close()
        check(not errors, f"serving {mode}: {errors[:3]}")
        check(len(got) == 8 * len(Q), f"serving {mode}: {len(got)} results")
        for (r, i), (gi, gd) in got.items():
            wi, wd = direct[mode][i]
            if mode == "quantized":
                check(np.array_equal(gi, wi) and np.array_equal(gd, wd), f"served int8 q{i} != the direct search")
            else:
                close_topk(f"served exact q{i}", gi[None], gd[None], wi[None], wd[None], 1e-5)
        p50, p99 = p50_p99(lat)
        out[f"serving_{mode}"] = {"qps": len(lat) / window, "p50_ms": p50, "p99_ms": p99}
        print(f"[serve] BatchingSearcher(max_batch={B_MAIN}), 8 client threads x {len(Q)} queries x 8 rounds, "
              f"{mode}: every result == the direct search ({'bit for bit' if mode == 'quantized' else 'ids, rtol 1e-5'}"
              f"); QPS {len(lat) / window!r}, per request p50 {p50!r} ms, p99 {p99!r} ms | {card}", flush=True)

    # -- the soak, on its own copy of the rows ----------------------------------
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    soak = svt.Dataset.from_arrays("soak", rows, options=f"dimension={DIM_MAIN},type=FLOAT32,distance=L2",
                                   device="cuda")
    soak.quantize()
    searcher = svt.BatchingSearcher(soak, max_batch=B_MAIN, fallback_exact=True)
    stop = threading.Event()
    errors, served, mutations = [], [0], [0]

    def mutator():
        mrng = np.random.default_rng(SEED + 11)
        i = 0
        try:
            while not stop.is_set():
                soak.add(mrng.standard_normal((1000, DIM_MAIN), dtype=np.float32))
                soak.remove(mrng.choice(soak.ids, size=500, replace=False))
                if i % 4 == 3:
                    soak.drop_quantization()
                    soak.quantize()
                elif i % 2:
                    soak.quantize()
                i += 1
            mutations[0] = i
        except Exception as e:
            errors.append(("mutator", e))

    def client(seed):
        crng = np.random.default_rng(seed)
        j = 0
        try:
            while not stop.is_set():
                ids, dist = searcher.search(crng.standard_normal(DIM_MAIN, dtype=np.float32), K,
                                            mode=("exact", "quantized")[j % 2])
                j += 1
                check(np.all(np.diff(dist) >= 0) and np.all(np.isfinite(dist)) and len(set(ids)) == len(ids),
                      "a soak result is unsorted, non-finite or repeats an id")
                served[0] += 1
        except Exception as e:
            errors.append((f"client-{seed}", e))

    threads = [threading.Thread(target=mutator)] + [threading.Thread(target=client, args=(s,)) for s in range(8)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(10.0)
    stop.set()
    for t in threads:
        t.join()
    soak_s = time.perf_counter() - t0
    searcher.close()
    check(not errors, f"soak errors: {errors[:3]}")
    del soak, searcher
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    check(abs(after - before) <= 0.01 * before, f"device memory {before} -> {after} bytes across the soak")
    print(f"[serve] soak {soak_s:.1f} s on a copy of the {N_MAIN} rows: 8 clients (exact and int8, fallback_exact) "
          f"served {served[0]} requests beside {mutations[0]} mutator rounds (add 1000, remove 500, quantize / drop + "
          f"quantize), 0 errors; torch.cuda.memory_allocated() {before} -> {after} bytes after close() and del "
          f"({100 * (after - before) / before:+.3f}%) | {card}", flush=True)

    # -- serve(): HTTP on localhost ---------------------------------------------
    server = svt.serve(ref, "127.0.0.1", 0, max_batch=B_MAIN)
    try:
        port = server.server_address[1]
        walls = []
        for i in range(16):
            body = json.dumps({"vector": Q[i].tolist(), "k": K}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{port}/search", data=body,
                                         headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=60) as r:
                resp = json.loads(r.read())
            walls.append(time.perf_counter() - t0)
            wi, wd = direct["exact"][i]
            close_topk(f"HTTP q{i}", np.array([resp["ids"]]), np.array([resp["distances"]], np.float32),
                       wi[None], wd[None], 1e-5)
    finally:
        server.close()
    out["http_p50_ms"] = p50_p99(walls)[0]
    print(f"[serve] serve() on 127.0.0.1, 16 POST /search: each == the direct search (ids, rtol 1e-5); HTTP p50 "
          f"{out['http_p50_ms']!r} ms | {card}", flush=True)
    return out


# phase 12: each traced search's annotate() name -> its mode, its scan
# kernel and PERF.md §5's device-busy share for it at B=64
# (tools/profile_torch_search.py), printed beside phase 12's
TRACED = {"svt.search.exact": ("exact", "K1", 47.6), "svt.search.int4": ("quantized", "K2", 25.1)}
# the substrings of each scan kernel's device name in the trace: K1's
# tensor-core bodies (mma_minima_kernel, wgmma_minima_kernel) hold the
# first and not the second, K2's (int4_wgmma_minima_kernel,
# int4_mma_minima_kernel) both
TRACE_KERNELS = {"K1": ("mma_minima_kernel", "int4_"), "K2": ("mma_minima_kernel", "int4_")}


def kernel_of(name: str) -> str | None:
    for kernel, (sub, int4) in TRACE_KERNELS.items():
        if sub in name and (int4 in name) == (kernel == "K2"):
            return kernel
    return None


def read_trace(log_dir: Path) -> dict:
    """The trace profile_trace wrote into log_dir: each annotate() range
    (its CPU span) with the device events it launched (kernels, copies,
    memsets), an event joined to the range that holds its launch (the
    CUDA runtime call of the same correlation id), or, unlinked, to the
    range that holds its device start. Returns {"ranges": [...],
    "outside": device events of no range, "unlinked": count}."""
    files = sorted(log_dir.glob("*.pt.trace.json"))
    check(len(files) == 1, f"profile_trace wrote {len(files)} trace files into {log_dir}")
    events = [e for e in json.loads(files[0].read_text())["traceEvents"] if e.get("ph") == "X"]
    ranges = sorted(
        ({"name": e["name"], "start": float(e["ts"]), "cpu_end": float(e["ts"]) + float(e["dur"]), "device": []}
         for e in events if e.get("cat") in ("user_annotation", "cpu_op") and e["name"] in TRACED),
        key=lambda r: r["start"],
    )
    launch_ts = {  # correlation id -> the launching call's start
        e["args"]["correlation"]: float(e["ts"])
        for e in events
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})
    }
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    check(any(e["cat"] == "kernel" for e in device),
          "the trace holds no CUDA kernel event (CUPTI recorded no device activity)")
    outside, unlinked = [], 0
    for e in device:
        at = launch_ts.get(e.get("args", {}).get("correlation"))
        if at is None:
            unlinked += 1
            at = float(e["ts"])
        home = next((r for r in ranges if r["start"] <= at <= r["cpu_end"]), None)
        (home["device"] if home else outside).append(e)
    return {"ranges": ranges, "outside": outside, "unlinked": unlinked, "file": files[0]}


def busy_share(r: dict) -> tuple[float, float]:
    """(device-busy us, wall us) of a range: the union of its device
    intervals (tools/profile_torch_search.py:busy_us) over its span, from
    its CPU start to the later of its CPU end and its last device event's
    end."""
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in r["device"]]
    busy = load_tests_module("profile_torch_search", "tools").busy_us(spans)
    return busy, max([r["cpu_end"]] + [b for _, b in spans]) - r["start"]


def phase_utils(card: str, ds, Q, mesh_ds, p50: dict) -> dict:
    """Phase 12: utils/ on the card. timed_search with a StatsRecorder on
    the main dataset (exact and int8, B=1 and B=64, every call equal bit
    for bit to the same search, the stats' rows and bytes as stated); the
    4-shard mesh's merge bytes against parallel.audit.GATHERED; a
    profile_trace of annotated exact and int4 searches, whose trace must
    hold K1's and K2's kernel events in the launch counters' numbers, each
    inside its range, with each range's device-busy share; the build cache.
    Returns the kernels' events in the trace."""
    from sqlite_vector_tpu_torch.ops._build import library_path
    from sqlite_vector_tpu_torch.parallel import GATHERED, collective_bytes_per_query
    from sqlite_vector_tpu_torch.utils import StatsRecorder, annotate, profile_trace, timed_search
    from sqlite_vector_tpu_torch.utils.compile_cache import build_root, enable_persistent_cache

    n = len(ds)
    qt = ds.quant_params[0].value
    check(qt == "INT8", f"phase 12 expects phase 8's int8 codes, found {qt}")
    # -- timed_search and StatsRecorder ----------------------------------
    for exact, mode in ((True, "exact"), (False, "quantized")):
        for b, calls in ((1, B_MAIN), (B_MAIN, 10)):
            for _ in range(3):  # warm-up, unrecorded
                ds.search(Q[:b], K, exact=exact)
            ds.stats_recorder = rec = StatsRecorder(capacity=256)
            plain = []  # the host clock around each comparison search
            for i in range(calls):
                q = Q[i : i + 1] if b == 1 else Q
                ids, dist, stats = timed_search(ds, q, K, exact=exact)
                t0 = time.perf_counter()
                want_ids, want_dist = ds.search(q, K, exact=exact)
                plain.append(time.perf_counter() - t0)
                check(np.array_equal(ids, want_ids) and np.array_equal(dist, want_dist),
                      f"timed_search {mode} B={b} call {i}: result differs from search's")
                check(stats.n_rows == n and stats.n_queries == b and stats.k == K and stats.exact == exact,
                      f"timed_search {mode} B={b}: stats {stats}")
                check(stats.bytes_scanned == n * DIM_MAIN * (4 if exact else 1),
                      f"timed_search {mode} B={b}: bytes_scanned {stats.bytes_scanned}")
                check(stats.collective_bytes == 0, "one device reported merge bytes")
            summ = rec.summary()
            check(summ["count"] == min(calls, 256) and summ["total_queries"] == calls * b,
                  f"StatsRecorder summary {summ}")
            gbs = n * DIM_MAIN * (4 if exact else 1) / (summ["median_ms"] / 1e3) / 1e9
            print(
                f"[utils] timed_search {mode}{' (' + qt + ')' if not exact else ''} {n}x{DIM_MAIN} k={K} "
                f"B={b}: {calls} calls each == search bit for bit; StatsRecorder(256) count "
                f"{summ['count']}, median {summ['median_ms']!r} ms, p99 {summ['p99_ms']!r} ms, "
                f"{gbs!r} GB/s at the median; the comparison searches' median "
                f"{float(np.median(plain)) * 1e3!r} ms (interleaved); phase 5's p50 {p50[mode][b]!r} "
                f"ms ({N_MAIN} rows before phase 8); {threading.active_count()} Python threads | {card}",
                flush=True,
            )
    ds.stats_recorder = None
    # -- the mesh's merge bytes --------------------------------------------
    shards = mesh_ds._vectors.n_shards
    for b in (1, B_MAIN):
        GATHERED.reset()
        _, _, stats = timed_search(mesh_ds, Q[:b], K)
        want = collective_bytes_per_query(shards, b, K)
        check(stats.collective_bytes == want == 8 * shards * b * K == GATHERED.merge == GATHERED.total,
              f"mesh B={b}: collective_bytes {stats.collective_bytes}, GATHERED {GATHERED.merge}, want {want}")
        print(f"[utils] timed_search on the {shards}-shard mesh B={b} k={K}: collective_bytes "
              f"{stats.collective_bytes} == 8*{shards}*{b}*{K} == the GATHERED.merge delta | {card}", flush=True)
    check(collective_bytes_per_query(shards, B_MAIN, K) == 40_960, "merge bytes at B=64, k=20, 4 shards")
    # -- profile_trace ------------------------------------------------------
    ds.quantize(qtype="int4")
    for mode, _, _ in TRACED.values():
        for _ in range(3):  # warm-up, outside the trace
            ds.search(Q, K, mode=mode)
    torch.cuda.synchronize()
    log_dir = Path(__file__).resolve().parent / "chip_smoke_trace"
    shutil.rmtree(log_dir, ignore_errors=True)
    zero_counts()
    launched = {}
    with profile_trace(str(log_dir)):
        for name, (mode, _, _) in TRACED.items():
            c0 = counts()
            for _ in range(10):
                with annotate(name):
                    ds.search(Q, K, mode=mode)
            c1 = counts()
            launched[name] = {kn: (c1[kn][0] - c0[kn][0], c1[kn][1] - c0[kn][1]) for kn in c1}
    tr = read_trace(log_dir)
    check(len(tr["ranges"]) == 20, f"the trace holds {len(tr['ranges'])} annotate ranges, not 20")
    in_trace = {"K1": 0, "K2": 0}
    for kn in TRACE_KERNELS:
        stray = [e["name"] for e in tr["outside"] if kernel_of(e["name"]) == kn]
        check(not stray, f"{len(stray)} {kn} kernel events outside every annotate range")
    for name, (mode, kn, pr5_busy) in TRACED.items():
        rs = [r for r in tr["ranges"] if r["name"] == name]
        own = sum(kernel_of(e["name"]) == kn for r in rs for e in r["device"])
        other = sum(kernel_of(e["name"]) not in (None, kn) for r in rs for e in r["device"])
        total, mma = launched[name][kn]
        check(own == total == mma > 0, f"{name}: {own} {kn} kernel events in the trace, the counter {total} ({mma} mma)")
        check(other == sum(launched[name][o][0] for o in launched[name] if o != kn),
              f"{name}: {other} events of the other kernel")
        # a scan kernel must start after its range does; any other device
        # event that reads earlier shows the trace's device-to-host clock
        # offset, printed
        lead = [(e["name"], float(e["ts"]) - r["start"]) for r in rs for e in r["device"]]
        early = {}  # name -> (events, the earliest start's lead, us)
        for n, t in lead:
            if t < 0:
                c, m = early.get(n[:40], (0, 0.0))
                early[n[:40]] = (c + 1, min(m, t))
        check(not [n for n, t in lead if t < 0 and kernel_of(n)],
              f"{name}: scan kernel events start before their range: {early}")
        in_trace[kn] += own
        busy, wall = (sum(x) for x in zip(*(busy_share(r) for r in rs)))
        ops = sum(len(r["device"]) for r in rs) / len(rs)
        print(
            f"[utils] profile_trace {name} ({mode} B={B_MAIN} k={K}, {len(rs)} searches): {own} "
            f"{kn} kernel events == its launch counter, each inside its range; device busy "
            f"{busy / len(rs) / 1e3!r} of {wall / len(rs) / 1e3!r} ms a search ({100 * busy / wall:.1f}%; "
            f"PERF.md §5: {pr5_busy}%), {ops:.0f} device ops a search; first device event "
            f"{min(t for _, t in lead)!r} us after its range's start; device events starting before "
            f"their range (name: (events, earliest us)): {early} | {card}",
            flush=True,
        )
    print(f"[utils] trace {tr['file'].relative_to(Path(__file__).resolve().parent)}: "
          f"{sum(len(r['device']) for r in tr['ranges'])} device events in the ranges, "
          f"{len(tr['outside'])} outside, {tr['unlinked']} without a linked launch | {card}", flush=True)
    # -- the build cache -------------------------------------------------------
    cache = enable_persistent_cache()
    check(library_path().parent == build_root() and (cache is None or build_root() == Path(cache)),
          f"the kernel library {library_path()} is not in the build cache {cache}")
    print(f"[utils] enable_persistent_cache() -> {cache}; the kernel library {library_path().name} "
          f"lies there | {card}", flush=True)
    return in_trace


# phase 13's wide rows: 1,000,000 x 4,096 FLOAT32 (the 4,096 columns of
# Qwen3-Embedding-8B, NV-Embed-v2 and e5-mistral-7b-instruct; no model is
# loaded), drawn in chunks of WIDE_CHUNK rows, each in WIDE_THREADS pieces;
# then 16-bit rows past 6,848 columns and u8 codes past 13,696
N_WIDE, DIM_WIDE = 1_000_000, 4096
WIDE_CHUNK, WIDE_THREADS = 100_000, 8
N_WIDE16, DIM_WIDE16 = 200_000, 8192
N_WIDE8, DIM_WIDE8 = 20_000, 16384


def wide_dataset(card: str):
    """Phase 13's dataset: N_WIDE x DIM_WIDE N(0, 1) float32 rows from
    SEED, added WIDE_CHUNK rows at a time; piece j of chunk i comes from
    child i * WIDE_THREADS + j of SEED's SeedSequence (drawn on
    WIDE_THREADS threads), the queries from the last child: 32 rows of the
    base and 32 new ones. Returns the dataset, the queries and the picked
    rows' positions."""
    from concurrent.futures import ThreadPoolExecutor

    import sqlite_vector_tpu_torch as svt

    n_chunks = N_WIDE // WIDE_CHUNK
    seeds = np.random.SeedSequence(SEED).spawn(n_chunks * WIDE_THREADS + 1)
    piece = WIDE_CHUNK // WIDE_THREADS
    t0 = time.perf_counter()
    ds = svt.VectorStore(device="cuda").create("wide", f"dimension={DIM_WIDE},type=FLOAT32,distance=L2")
    buf = np.empty((WIDE_CHUNK, DIM_WIDE), np.float32)

    def draw(job):
        j, seed = job
        np.random.default_rng(seed).standard_normal(out=buf[j * piece : (j + 1) * piece], dtype=np.float32)

    with ThreadPoolExecutor(WIDE_THREADS) as ex:
        for c in range(n_chunks):
            list(ex.map(draw, enumerate(seeds[c * WIDE_THREADS : (c + 1) * WIDE_THREADS])))
            ds.add(buf)
    torch.cuda.synchronize()
    check(len(ds) == N_WIDE, f"the wide dataset holds {len(ds)} rows")
    rng = np.random.default_rng(seeds[-1])
    picks = rng.choice(N_WIDE, B_MAIN // 2, replace=False)
    Q = np.concatenate(
        [ds.get(ds.ids[picks]), rng.standard_normal((B_MAIN - B_MAIN // 2, DIM_WIDE), dtype=np.float32)]
    )
    print(
        f"[wide] added {len(ds)} x {DIM_WIDE} FLOAT32 rows ({ds.memory_bytes()} device bytes) in "
        f"{time.perf_counter() - t0:.1f} s (host data generation included) | {card}",
        flush=True,
    )
    return ds, Q, picks


def wide_kernel(card: str, label: str, q, base, metric, iters: int, out: dict) -> None:
    """K1 on the wgmma body, its query tile streamed, against its twin, the
    mma.sync body and the CUDA-core body (compare_minima), then timed in
    turns with them and torch.matmul of the same product, beside k1_bound;
    into out[label]."""
    from sqlite_vector_tpu_torch.ops.block_scan import _launch_k1, block_minima, block_minima_reference

    n = base.shape[0]
    out["max_abs_err"] = max(out["max_abs_err"], compare_minima(q, base, metric, n, label))
    compare_minima(q, base, metric, n, f"{label}, mma.sync body", body="mma")
    compare_minima(q, base, metric, n, f"{label}, CUDA-core body", body="simt")
    ms = in_turns(
        [lambda: block_minima_reference(q, base, metric, n), lambda: block_minima(q, base, metric, n),
         lambda: _launch_k1(q, base, metric, n, None, "simt"), lambda: _launch_k1(q, base, metric, n, None, "mma"),
         lambda: torch.matmul(q, base.T)],
        iters,
    )
    lim, by = k1_bound(q.shape[0], n, base.shape[1], base.element_size())
    out[label] = {"ms": ms[1], "plain_ms": ms[0], "mma_sync_ms": ms[3], "simt_ms": ms[2],
                  "library_ms": ms[4], "bound_ms": lim, "bound_by": by}
    what = label if label.startswith(metric.value) else f"{metric.value} {label}"
    print(
        f"[times] K1 {n}x{base.shape[1]} {what} (wgmma, mma.sync and CUDA-core bodies == twin, query "
        f"tiles streamed): kernel {ms[1]!r} ms, bound {lim!r} ms ({by}), {100 * lim / ms[1]:.1f}% of "
        f"bound; mma.sync body {ms[3]!r} ms ({ms[3] / ms[1]:.2f}x); CUDA-core body {ms[2]!r} ms "
        f"({ms[2] / ms[1]:.2f}x); twin {ms[0]!r} ms; library torch.matmul {ms[4]!r} ms | {card}",
        flush=True,
    )


def phase_wide(card: str) -> dict:
    """Phase 13: the exact path at DIM_WIDE columns, where K1's wgmma body
    streams its query tile (ops/block_scan.py:wgmma_plan).
    Returns the launches of its checked searches, the largest |kernel -
    twin| and, by shape, the kernel's times beside its bound."""
    from sqlite_vector_tpu_torch.ops.block_scan import (
        _finish_from_minima,
        _launch_k1,
        block_minima,
        k1_body,
        mma_streams_queries,
        wgmma_plan,
    )
    from sqlite_vector_tpu_torch.ops.distance import pairwise_distance
    from sqlite_vector_tpu_torch.types import DistanceMetric

    parity = load_tests_module("parity")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    L2 = DistanceMetric.L2
    ds, Q, picks = wide_dataset(card)
    shape = f"{N_WIDE}x{DIM_WIDE}"
    vecs = ds._vectors[: len(ds)]
    Qd = torch.from_numpy(Q).cuda()
    check(k1_body(torch.float32, L2, DIM_WIDE) == "wgmma" and wgmma_plan(torch.float32, DIM_WIDE, 1)[1],
          "f32 at the wide rows does not take the wgmma body's streamed tile")

    # -- the main path at this width: exact search at B=1 and B=64 ----------
    zero_counts()
    ids1, d1 = ds.search(Q[:1], K)
    ids64, d64 = ds.search(Q, K)
    launches = block_minima.launches
    check(launches == 2 and block_minima.body_launches == {"wgmma": 2, "mma": 0, "simt": 0}
          and block_minima.streamed_launches == 2,
          f"the wide searches launched K1 {launches} times, {block_minima.body_launches}, "
          f"{block_minima.streamed_launches} streamed, not 2 on the wgmma body's streamed tile")
    oracle = pairwise_distance(Qd, vecs, L2).cpu().numpy()
    ids_all = ds.ids
    rel = parity.REL_TOL_BY_TYPE["FLOAT32"]
    for label, got_ids, got_d in (("B=1", ids1, d1), (f"B={B_MAIN}", ids64, d64)):
        for i in range(got_ids.shape[0]):
            parity.assert_topk_parity(*top_rows(ids_all, oracle[i]), got_ids[i], got_d[i], K,
                                      rel_tol=rel, label=f"wide exact {label} q{i}")
    for i, p in enumerate(picks):
        check(ids64[i, 0] == ids_all[p] and d64[i, 0] == 0.0, f"wide q{i}: self-match not first at 0")
    del oracle
    print(
        f"[wide] exact search(Q[1], {K}) and search(Q[{B_MAIN}], {K}) over {shape}: ids match the "
        f"plain-torch ground truth (tie-aware, rel_tol {rel}), {len(picks)}/{len(picks)} self-matches "
        f"first at 0.0; K1 launches {launches}, all on the wgmma body with the query tile "
        f"streamed (tiles {wgmma_plan(torch.float32, DIM_WIDE, 1)[0]} and "
        f"{wgmma_plan(torch.float32, DIM_WIDE, B_MAIN)[0]}) | {card}",
        flush=True,
    )

    # -- K1 alone: the streamed wgmma body against the twin, the mma.sync and
    # CUDA-core bodies and torch.matmul, beside its bound ------------------
    out = {"max_abs_err": 0.0}
    for metric in (L2, DistanceMetric.COSINE, DistanceMetric.DOT):
        for b in (1, B_MAIN):
            name = "f32" if metric is L2 else f"{metric.value} f32"
            wide_kernel(card, f"{name} d={DIM_WIDE} B={b}", Qd[:b].contiguous(), vecs, metric,
                        10 if b == 1 else 5, out)
    # K1 against the finish (select k groups, gather and rescore their rows,
    # top-k) at this width; the finish's window holds its ~80 launches, so
    # at B=1 the host's launch rate, not the device, sets it
    # (tools/profile_torch_search.py --dim 4096 splits the device time)
    for b in (1, B_MAIN):
        q = Qd[:b].contiguous()
        minima = block_minima(q, vecs, L2, len(ds))
        k1_ms, fin_ms = in_turns(
            [lambda: block_minima(q, vecs, L2, len(ds)),
             lambda: _finish_from_minima(minima, q, vecs, len(ds), L2, K)], 5,
        )
        print(
            f"[times] exact {shape} B={b} (CUDA-event windows, in turns): K1 {k1_ms!r} ms, the "
            f"finish {fin_ms!r} ms, launch gaps included ({100 * fin_ms / (k1_ms + fin_ms):.1f}% of the "
            f"two; its gather moves {b * K * 128 * DIM_WIDE * 4} bytes) | {card}",
            flush=True,
        )
    for b, calls in ((1, 30), (B_MAIN, 10)):
        body_latency(card, ds, Q, shape, modes=("exact",), rounds=4, calls=calls, b=b)
    # optional, printed only: the int8 searches at this width (K1 over codes
    # on the resident tile: 4,096 one-byte columns fit)
    ds.quantize()
    for mode in ("quantized", "rerank"):
        search_times(card, ds, Q, mode, shape, ((1, 20), (B_MAIN, 10)), label=f"{mode} int8")
    del vecs
    # the dataset, its queries and their exact ids go on to phase 14
    out["dataset"] = (ds, Q, ids64)

    # -- 16-bit rows past 6,848 columns and u8 codes past 13,696 -------------
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    base = make_rows(gen, N_WIDE16, DIM_WIDE16, torch.float16)
    q16 = make_rows(gen, B_MAIN, DIM_WIDE16, torch.float16)
    q16[0] = base[10]  # a self-match
    check(k1_body(torch.float16, L2, DIM_WIDE16) == "wgmma" and wgmma_plan(torch.float16, DIM_WIDE16, 1)[1],
          "f16 d=8192 does not take the wgmma body's streamed tile")
    for b in (1, B_MAIN):
        wide_kernel(card, f"L2 f16 d={DIM_WIDE16} B={b}", q16[:b].contiguous(), base, L2, 10, out)
    del base, q16
    base = make_rows(gen, N_WIDE8, DIM_WIDE8, torch.uint8)
    q8 = make_rows(gen, B_MAIN, DIM_WIDE8, torch.uint8)
    q8[0] = base[10]
    check(k1_body(torch.uint8, L2, DIM_WIDE8) == "mma" and mma_streams_queries(torch.uint8, DIM_WIDE8),
          "u8 d=16384 does not take the streamed tensor-core body")
    for metric in (L2, DistanceMetric.COSINE, DistanceMetric.DOT):
        for b in (1, B_MAIN):
            q = q8[:b].contiguous()
            label = f"wide u8 d={DIM_WIDE8} B={b} {metric.value}"
            compare_minima(q, base, metric, N_WIDE8, label)
            got = block_minima(q, base, metric, N_WIDE8)
            simt = _launch_k1(q, base, metric, N_WIDE8, None, "simt")
            check(torch.equal(got, simt), f"{label}: the two bodies differ")
    del base, q8
    print(
        f"[wide] u8 {N_WIDE8}x{DIM_WIDE8} (past 13,696 columns, streamed) L2, COSINE, DOT at B=1 and "
        f"B={B_MAIN}: tensor-core body == twin == CUDA-core body bit for bit; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes (torch.cuda.max_memory_allocated) | {card}",
        flush=True,
    )
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out


# phase 14's configuration: a kNN-LM datastore shard (Khandelwal et al.,
# ICLR 2020, arXiv:1911.00172 section 3) keyed by Nemotron-4-340B's final
# hidden states (18,432 wide, arXiv:2406.11704 Table 1), FLOATB16 L2,
# 500,000 N(0, 1) rows from SEED drawn on the card WIDE4_CHUNK rows at a
# time; and K2 alone over codes of K2_WIDE_SHAPES (d, rows), 2 GB of packed
# codes each, beside phase 13's 4,096 and the datastore's 18,432
N_WIDE4, DIM_WIDE4, WIDE4_CHUNK = 500_000, 18432, 25_000
K2_WIDE_SHAPES = ((8192, 500_000), (16384, 250_000))


def int4_searches(card: str, ds, Q, ids_e, dim: int, label: str) -> int:
    """int4-quantized and refine Dataset.search at B=1 and B=B_MAIN, k=K,
    each held against its plain counterpart on the same codes (as phase 6:
    the plain int4 tile loop, and the refine rescore of its candidates),
    recall@K against the exact ids `ids_e` printed, and K2's launch
    counters (set to 0 just before the four searches, read just after):
    each on the wgmma body, streamed where k2_wgmma_plan says. Returns the
    launches."""
    from sqlite_vector_tpu_torch.ops.block_scan import block_minima
    from sqlite_vector_tpu_torch.ops.int4_scan import int4_block_minima, k2_wgmma_plan
    from sqlite_vector_tpu_torch.ops.quantize4 import int4_scan_topk_plain
    from sqlite_vector_tpu_torch.ops.refine import refine_candidates
    from sqlite_vector_tpu_torch.types import DistanceMetric

    L2 = DistanceMetric.L2
    quant = ds._quant
    n = quant.count
    zero_counts()
    got = {(mode, b): ds.search(Q[:b], K, mode=mode) for b in (1, B_MAIN) for mode in ("quantized", "refine")}
    launches, used, streamed = (int4_block_minima.launches, dict(int4_block_minima.body_launches),
                                int4_block_minima.streamed_launches)
    want_streamed = 2 * sum(k2_wgmma_plan(dim, b)[1] for b in (1, B_MAIN))
    check(launches == 4 and used == {"wgmma": 4, "mma": 0} and streamed == want_streamed
          and block_minima.launches == 0,
          f"{label}: K2 launches {launches} {used}, {streamed} streamed (want 4 on the wgmma "
          f"body, {want_streamed} streamed), K1 {block_minima.launches}")
    ids_all = quant.ids
    recalls = {}
    for b in (1, B_MAIN):
        Qd = torch.from_numpy(Q[:b]).cuda()
        pv, pi = int4_scan_topk_plain(Qd, quant.codes, quant.row_scale, quant.sq_norms, L2, K, dim=dim,
                                      valid_count=n)
        pi = pi.cpu().numpy()
        same_topk(f"{label} int4 B={b}", *got[("quantized", b)], np.where(pi >= 0, ids_all[pi], -1),
                  pv.cpu().numpy())
        _, cand = int4_scan_topk_plain(Qd, quant.codes, quant.row_scale, quant.sq_norms, L2, 4 * K,
                                       dim=dim, valid_count=n)
        rv, ri = refine_candidates(Qd, cand, quant.codes8, quant.scale8, quant.offset8, L2, K)
        ri = ri.cpu().numpy()
        same_topk(f"{label} refine B={b}", *got[("refine", b)], np.where(ri >= 0, ids_all[ri], -1),
                  rv.cpu().numpy())
        for mode in ("quantized", "refine"):
            ids = got[(mode, b)][0]
            recalls[(mode, b)] = float(np.mean([len(set(ids[i]) & set(ids_e[i])) / K for i in range(b)]))

    def tile(b):
        t, streamed = k2_wgmma_plan(dim, b)
        return f"{t} {'streamed' if streamed else 'resident'}"

    print(
        f"[wide4] {label}: search(Q[b], {K}, mode='quantized') == the plain int4 tile loop and "
        f"mode='refine' == the refine rescore of its candidates at B=1 and B={B_MAIN} (distances "
        f"equal, ids tie-aware); recall@{K} vs exact: "
        + ", ".join(f"{m} B={b} {r!r}" for (m, b), r in recalls.items())
        + f"; K2 launches {launches} {used}, streamed_launches {streamed} (query tile B=1 "
        f"{tile(1)}, B={B_MAIN} {tile(B_MAIN)}) | {card}",
        flush=True,
    )
    return launches


def wide_k2(card: str, label: str, Q, packed, alpha, csq, dim: int, out: dict) -> None:
    """K2 alone at B=1 and B=B_MAIN over these codes: the routed (wgmma)
    body and the mma.sync body against the twin (compare_int4_minima:
    bit-equal), then timed in turns (CUDA events; the twin apart) with the
    mma.sync body, torch._int_mm on
    the codes unpacked once to int8 where it takes the shape, and, where a
    resident query tile fits, the wgmma body's resident and streamed tile
    side by side; beside k2_bound. Into out[label B=b]."""
    from sqlite_vector_tpu_torch.ops.int4_scan import (
        _launch_k2,
        int4_block_minima,
        int4_block_minima_reference,
        k2_wgmma_plan,
    )
    from sqlite_vector_tpu_torch.ops.quantize4 import quantize_query_int8, unpack4
    from sqlite_vector_tpu_torch.types import DistanceMetric

    L2 = DistanceMetric.L2
    n = packed.shape[0]
    codes8 = torch.empty((n, dim), dtype=torch.int8, device="cuda")
    for s in range(0, n, 50_000):  # no whole-matrix temporaries beside it
        codes8[s : s + 50_000] = unpack4(packed[s : s + 50_000], dim)
    for b in (1, B_MAIN):
        qc, qs, _ = quantize_query_int8(torch.from_numpy(Q[:b]).cuda())
        args = (qc, qs, packed, alpha, csq)
        key = f"{label} B={b}"
        out["max_abs_err"] = max(out["max_abs_err"], compare_int4_minima(args, L2, n, f"wide K2 {key}"))
        (plain_ms,) = in_turns([lambda: int4_block_minima_reference(*args, L2, n)], 3)
        fns = {"kernel": lambda: int4_block_minima(*args, L2, n),
               "mma": lambda: _launch_k2(*args, L2, n, None, "mma")}
        lib = library_call_k2(qc, codes8)
        if lib:
            fns["library"] = lib
        resident = k2_wgmma_plan(dim, b, False)[0]
        if resident:
            fns["resident"] = lambda: _launch_k2(*args, L2, n, None, "wgmma", False)
            fns["streamed"] = lambda: _launch_k2(*args, L2, n, None, "wgmma", True)
        ms = dict(zip(fns, in_turns(list(fns.values()), 10 if b == 1 else 5, rounds=2)))
        lim, by = k2_bound(b, n, dim)
        tile, streamed = k2_wgmma_plan(dim, b)
        routed = f"{tile} {'streamed' if streamed else 'resident'}"
        out[key] = {"ms": ms["kernel"], "plain_ms": plain_ms, "mma_sync_ms": ms["mma"],
                    "library_ms": ms.get("library"), "bound_ms": lim, "bound_by": by,
                    "query_tile": routed}
        side = ""
        if resident:
            out[key].update(resident_ms=ms["resident"], streamed_ms=ms["streamed"])
            side = (f"; wgmma resident tile {resident} (x{-(-b // resident)}) {ms['resident']!r} ms "
                    f"against streamed tile {k2_wgmma_plan(dim, b, True)[0]} {ms['streamed']!r} ms")
        print(
            f"[times] K2 {n}x{dim} {key} L2 (the two bodies == twin; routed: the wgmma body, query "
            f"tile {routed}): kernel {ms['kernel']!r} ms, bound {lim!r} ms ({by}), "
            f"{100 * lim / ms['kernel']:.1f}% of bound; mma.sync body {ms['mma']!r} ms "
            f"({ms['mma'] / ms['kernel']:.2f}x); twin {plain_ms!r} ms; library (torch._int_mm) "
            f"{'none' if not lib else repr(ms['library']) + ' ms'}{side} | {card}",
            flush=True,
        )
    del codes8


def random_int4_codes(gen: torch.Generator, n: int, dim: int):
    """int4 codes of n N(0, 1) rows drawn on the card, quantized 50,000 rows
    at a time (quantize4_device)."""
    from sqlite_vector_tpu_torch.ops.quantize4 import packed_width, quantize4_device

    packed = torch.empty((n, packed_width(dim)), dtype=torch.uint8, device="cuda")
    alpha = torch.empty(n, device="cuda")
    csq = torch.empty(n, dtype=torch.int32, device="cuda")
    for s in range(0, n, 50_000):
        e = min(n, s + 50_000)
        packed[s:e], alpha[s:e], csq[s:e] = quantize4_device(
            torch.randn((e - s, dim), generator=gen, device="cuda"))
    return packed, alpha, csq


def datastore(card: str):
    """Phase 14's N_WIDE4 x DIM_WIDE4 FLOATB16 L2 dataset: N(0, 1) rows
    drawn on the card from SEED + 14, WIDE4_CHUNK rows at a time, rounded
    to bfloat16 there and added in the host form the SQL loader adds
    (bfloat16 bits, Dataset._add_host_rows); 64 queries, 32 rows of the
    base and 32 new bfloat16 values. Returns the dataset, the queries
    (float32) and the picked rows' positions."""
    import sqlite_vector_tpu_torch as svt

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    ds = svt.VectorStore(device="cuda").create(
        "datastore", f"dimension={DIM_WIDE4},type=FLOATB16,distance=L2")
    for _ in range(N_WIDE4 // WIDE4_CHUNK):
        rows = torch.randn((WIDE4_CHUNK, DIM_WIDE4), generator=gen, device="cuda").to(torch.bfloat16)
        ds._add_host_rows(rows.view(torch.int16).cpu().numpy().view(np.uint16), None)
        del rows
    torch.cuda.synchronize()
    check(len(ds) == N_WIDE4, f"the datastore holds {len(ds)} rows")
    picks = torch.randperm(N_WIDE4, generator=gen, device="cuda")[: B_MAIN // 2]
    new = torch.randn((B_MAIN - B_MAIN // 2, DIM_WIDE4), generator=gen, device="cuda").to(torch.bfloat16)
    Q = torch.cat([ds._vectors[picks], new]).float().cpu().numpy()
    print(
        f"[wide4] added {len(ds)} x {DIM_WIDE4} FLOATB16 rows ({ds.memory_bytes()} device bytes) in "
        f"{time.perf_counter() - t0:.1f} s (drawn on the card); peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes | {card}",
        flush=True,
    )
    return ds, Q, picks.cpu().numpy()


def phase_wide_int4(card: str, wide: dict) -> dict:
    """Phase 14: int4 and refine where K2's wgmma body streams its query
    tile (ops/int4_scan.py:k2_wgmma_plan). Phase 13's 1,000,000
    x 4,096 f32 dataset (popped from phase 13's result `wide`, so that it
    is freed here: the dataset, its queries and their exact ids), then the kNN-LM datastore shard (datastore()): each
    quantize(qtype="int4", refine=True) and searched by int4_searches, K2
    alone over its codes (wide_k2; on the datastore also beside the
    finish), and K2 alone over codes at 8,192 and 16,384 columns. Returns the launches of the checked searches, the
    largest |kernel - twin| and, by shape, K2's times beside its bound."""
    from sqlite_vector_tpu_torch.ops.int4_scan import _finish_int4, _launch_k2, int4_block_minima
    from sqlite_vector_tpu_torch.ops.quantize4 import quantize_query_int8, sanitize_queries
    from sqlite_vector_tpu_torch.types import DistanceMetric

    L2 = DistanceMetric.L2
    out = {"max_abs_err": 0.0, "launches": 0}
    # -- phase 13's 1M x 4,096 f32 rows --------------------------------------
    ds, Q, ids_e = wide.pop("dataset")
    t0 = time.perf_counter()
    ds.quantize(qtype="int4", refine=True)
    torch.cuda.synchronize()
    print(f"[wide4] quantize(qtype='int4', refine=True) of {len(ds)} x {DIM_WIDE} FLOAT32 rows in "
          f"{time.perf_counter() - t0:.2f} s | {card}", flush=True)
    out["launches"] += int4_searches(card, ds, Q, ids_e, DIM_WIDE, f"{N_WIDE}x{DIM_WIDE} f32")
    quant = ds._quant
    wide_k2(card, f"d={DIM_WIDE}", Q, quant.codes, quant.row_scale, quant.sq_norms, DIM_WIDE, out)
    del ds, quant
    torch.cuda.empty_cache()

    # -- K2 alone over codes at 8,192 and 16,384 columns ----------------------
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    for dim, n in K2_WIDE_SHAPES:
        codes = random_int4_codes(gen, n, dim)
        q = torch.randn((B_MAIN, dim), generator=gen, device="cuda").cpu().numpy()
        wide_k2(card, f"d={dim}", q, *codes, dim, out)
        del codes
        torch.cuda.empty_cache()

    # -- the datastore: 500,000 x 18,432 FLOATB16 ------------------------------
    torch.cuda.reset_peak_memory_stats()
    ds, Q, picks = datastore(card)
    t0 = time.perf_counter()
    ids_e, d_e = ds.search(Q, K)  # exact, for recall (K1, its query tile streamed)
    t_exact = time.perf_counter() - t0
    check(all(ids_e[i, 0] == ds.ids[p] for i, p in enumerate(picks)),
          "datastore: a self-match is not first in exact search")
    # each self-match at exactly 0: the exact finish rescores L2 as the
    # direct sum((x - q)^2) (its float32 decomposition left 0.265-0.280 here)
    self_d = d_e[: len(picks), 0]
    check(bool((self_d == 0).all()), f"datastore: exact self-matches at L2 {self_d.tolist()}, not all 0")
    t0 = time.perf_counter()
    ds.quantize(qtype="int4", refine=True)
    torch.cuda.synchronize()
    print(f"[wide4] datastore: exact search(Q[{B_MAIN}], {K}) in {t_exact:.2f} s, {len(picks)} "
          f"self-matches first, at L2 {float(self_d.min())!r}-{float(self_d.max())!r} "
          f"({int((self_d == 0).sum())} at 0; the next row at {float(d_e[: len(picks), 1].min())!r} "
          f"or more); quantize(qtype='int4', refine=True) in {time.perf_counter() - t0:.2f} s; peak "
          f"device memory so far {torch.cuda.max_memory_allocated()} bytes | {card}",
          flush=True)
    out["launches"] += int4_searches(card, ds, Q, ids_e, DIM_WIDE4, f"{N_WIDE4}x{DIM_WIDE4} bf16")
    print(f"[wide4] datastore: peak device memory after the int4 searches and their plain "
          f"counterparts {torch.cuda.max_memory_allocated()} bytes | {card}", flush=True)
    quant = ds._quant
    # the mma.sync body forced once more, at B=B_MAIN: bit-equal
    qc, qs, _ = quantize_query_int8(torch.from_numpy(Q).cuda())
    args = (qc, qs, quant.codes, quant.row_scale, quant.sq_norms)
    wgmma = _launch_k2(*args, L2, quant.count, None, "wgmma")
    mma = _launch_k2(*args, L2, quant.count, None, "mma")
    torch.cuda.synchronize()
    check(torch.equal(wgmma.view(torch.int32), mma.view(torch.int32)),
          "datastore: the streamed wgmma and the streamed mma.sync body differ")
    del wgmma, mma, args
    wide_k2(card, f"bf16 d={DIM_WIDE4}", Q, quant.codes, quant.row_scale, quant.sq_norms, DIM_WIDE4, out)
    # K2 against the finish (select k groups, gather, unpack and rescore
    # their packed rows in float64 past d = 16,513, top-k), as phase 13
    # times K1 against its finish
    for b in (1, B_MAIN):
        qd = torch.from_numpy(Q[:b]).cuda()
        codes, qf = quantize_query_int8(qd), sanitize_queries(qd)
        k2_args = (codes[0], codes[1], quant.codes, quant.row_scale, quant.sq_norms, L2, quant.count)
        minima = int4_block_minima(*k2_args)
        k2_ms, fin_ms = in_turns(
            [lambda: int4_block_minima(*k2_args),
             lambda: _finish_int4(minima, codes, qf, quant.codes, quant.row_scale, quant.sq_norms, L2,
                                  K, DIM_WIDE4, quant.count, None)], 5,
        )
        out[f"bf16 d={DIM_WIDE4} B={b}"]["finish_ms"] = fin_ms
        print(
            f"[times] int4 {N_WIDE4}x{DIM_WIDE4} B={b} (CUDA-event windows, in turns): K2 {k2_ms!r} ms "
            f"(with the streamed tile's layout), the finish {fin_ms!r} ms, launch gaps included "
            f"({100 * fin_ms / (k2_ms + fin_ms):.1f}% of the two; it gathers {b * K * 128} packed rows, "
            f"{b * K * 128 * quant.codes.shape[1]} bytes) | {card}",
            flush=True,
        )
    print(f"[wide4] datastore peak device memory {torch.cuda.max_memory_allocated()} bytes "
          f"(torch.cuda.max_memory_allocated, the library call's unpacked int8 codes included) | {card}",
          flush=True)
    del ds, quant
    torch.cuda.empty_cache()
    return out


def main_cards(card: str) -> int:
    """--cards: phase 11's several-card part alone, then the result line."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"chip_smoke --cards: needs two or more CUDA cards, found {n}", file=sys.stderr)
        return 1
    rows, Q = main_rows()
    phase_cards(card, rows, Q)
    return result_lines()


def result_lines() -> int:
    """The card line, then the result line last."""
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def phase(fn, *args):
    """fn(*args), then a line with its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase] {fn.__name__} in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 1
    cards = sys.argv[1:] == ["--cards"]
    if sys.argv[1:] and not cards:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}; takes none, or --cards", file=sys.stderr)
        return 2
    from sqlite_vector_tpu_torch.ops._build import library_path, load_library, ptxas_report

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(
        f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}",
        flush=True,
    )
    t0 = time.perf_counter()
    load_library()
    print(
        f"[build] K1 (three bodies), K2 (two) and the two rescore kernels built from csrc/ and loaded in "
        f"{time.perf_counter() - t0:.1f} s "
        f"-> {library_path().name}",
        flush=True,
    )
    for name, said in ptxas_report().items():
        print(f"[build] ptxas {name}: {said}", flush=True)
        if any(k in name for k in ("mma_minima_kernel", "l1_minima_kernel", "rescore_groups_kernel",
                                   "rescore_rows_kernel")):
            # K1's and K2's tensor-core bodies (wgmma_minima_kernel too),
            # K1's L1 body and the rescore kernels
            check(" 0 bytes spill stores" in f" {said}", f"{name} spills: {said}")
    if cards:
        return main_cards(card)
    max_err, masked_err, nonfinite_err = phase(phase_kernel, card)
    k2_err, k2_masked_err = phase(phase_kernel_int4, card)
    rescore = phase(phase_rescore, card)
    rescore_rows = phase(phase_rescore_rows, card)
    ds, Q, ids_e, launches = phase(phase_main, card)
    k1 = phase(phase_times, card, ds, Q)  # reads the int8 state
    other_launches = phase(phase_datasets, card, ds, Q)
    k2_launches = phase(phase_int4, card, ds, Q, ids_e)
    k2 = phase(phase_int4_times, card, ds, Q)
    masked = phase(phase_mutate, card, ds, Q)["masked_launches"]
    host = phase(phase_persist, card, ds, Q)
    fe = phase(phase_frontends, card, Q)
    mesh = phase(phase_mesh, card, Q)
    traced = phase(phase_utils, card, ds, Q, mesh.pop("dataset"), k1.pop("search_p50"))
    del ds
    wide_k1 = phase(phase_wide, card)
    wide_k2 = phase(phase_wide_int4, card, wide_k1)  # takes its "dataset"
    k1["max_abs_err"] = max(k1["max_abs_err"], wide_k1.pop("max_abs_err"))
    wide_launches = wide_k1.pop("launches")
    k1.update(wide_k1)
    k2_main = k2[f"B={B_MAIN}"]
    k2_wide = wide_k2[f"bf16 d={DIM_WIDE4} B={B_MAIN}"]

    def k1_entry(name: str, source: str, shape: str, n_launches: int, family) -> dict:
        # one body (or type family) of K1: its times at `shape` (for float
        # rows the mma.sync body's beside them), and those of every shape
        # `family` takes under by_shape
        main = k1[shape]
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": "sqlite_vector_tpu/ops/pallas_scan.py:681",
            "launches": n_launches,
            "max_abs_err": max(max_err, k1["max_abs_err"]),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            **({"mma_sync_ms": main["mma_sync_ms"]} if main.get("mma_sync_ms") is not None else {}),
            "main_shape": shape,
            "by_shape": {k: v for k, v in k1.items() if k != "max_abs_err" and family(k)},
        }

    mma_src = "sqlite_vector_tpu_torch/csrc/block_minima_mma.cu"
    wgmma_src = "sqlite_vector_tpu_torch/csrc/block_minima_wgmma.cu"
    print(json.dumps({"kernels": [
        {
            **k1_entry("block_minima", wgmma_src, f"f32 B={B_MAIN}", launches["wgmma"],
                       lambda k: k.startswith("f32") and " d=" not in k),
            "masked_launches": masked["K1"],
            "streamed_launches": host["K1"],
            "sql_launches": fe["sql_launches"]["K1"]["launches"],
            "mesh_launches": mesh["K1"] + host["mesh"]["K1"],
            "trace_launches": traced["K1"],
            "masked_max_abs_err": masked_err,
            "nonfinite_max_abs_err": nonfinite_err,
        },
        k1_entry("block_minima_codes", mma_src, next(k for k in k1 if k.endswith(f"codes B={B_MAIN}")),
                 launches["mma"],
                 lambda k: "codes" in k or k.startswith("u8")),
        k1_entry("block_minima_16bit", wgmma_src, f"L2 f16 B={B_MAIN}",
                 other_launches["FLOAT16 L2"] + other_launches["FLOATB16 DOT"],
                 lambda k: k.startswith(("L2 f16", "L2 bf16")) and " d=" not in k),
        k1_entry("block_minima_wide", wgmma_src, f"f32 d={DIM_WIDE} B={B_MAIN}", wide_launches,
                 lambda k: " d=" in k),
        k1_entry("block_minima_l1", "sqlite_vector_tpu_torch/csrc/block_minima.cu", f"L1 f32 B={B_MAIN}",
                 other_launches["FLOAT32 L1"], lambda k: k.startswith("L1")),
        {
            "name": "int4_block_minima",
            "route": "cuda",
            "source": "sqlite_vector_tpu_torch/csrc/int4_minima_wgmma.cu",
            "replaces": "sqlite_vector_tpu/ops/pallas_int4.py:408",
            "launches": k2_launches,
            "max_abs_err": max(k2_err, k2["max_abs_err"]),
            "ms": k2_main["ms"],
            "plain_ms": k2_main["plain_ms"],
            "bound_ms": k2_main["bound_ms"],
            "bound_by": k2_main["bound_by"],
            "library_ms": k2_main["library_ms"],
            "mma_sync_ms": k2_main["mma_sync_ms"],
            "mma_sync_body": "sqlite_vector_tpu_torch/csrc/int4_minima_mma.cu",
            "masked_launches": masked["K2"],
            "streamed_launches": host["K2"],
            "sql_launches": fe["sql_launches"]["K2"]["launches"],
            "mesh_launches": mesh["K2"] + host["mesh"]["K2"],
            "trace_launches": traced["K2"],
            "masked_max_abs_err": k2_masked_err,
            "by_shape": {k: v for k, v in k2.items() if k != "max_abs_err"},
        },
        {
            # K2 past the resident query tile: the tile streamed beside the
            # codes; launches from phase 14's eight checked searches
            "name": "int4_block_minima_wide",
            "route": "cuda",
            "source": "sqlite_vector_tpu_torch/csrc/int4_minima_wgmma.cu",
            "replaces": "sqlite_vector_tpu/ops/pallas_int4.py:408",
            "launches": wide_k2["launches"],
            "max_abs_err": wide_k2["max_abs_err"],
            "ms": k2_wide["ms"],
            "plain_ms": k2_wide["plain_ms"],
            "bound_ms": k2_wide["bound_ms"],
            "bound_by": k2_wide["bound_by"],
            "library_ms": k2_wide["library_ms"],
            "mma_sync_ms": k2_wide["mma_sync_ms"],
            "mma_sync_body": "sqlite_vector_tpu_torch/csrc/int4_minima_mma.cu",
            "main_shape": f"bf16 d={DIM_WIDE4} B={B_MAIN}",
            "by_shape": {k: v for k, v in wide_k2.items() if k not in ("max_abs_err", "launches")},
        },
        {
            "name": "rescore_groups",
            "route": "cuda",
            "source": "sqlite_vector_tpu_torch/csrc/rescore_codes.cu",
            "replaces": None,
            "launches": launches["rescore"],
            "timing_launches": rescore.pop("timing_launches"),
            "max_abs_err": rescore.pop("max_abs_err"),
            **rescore[f"int8 B={B_RESCORE}"],
            "main_shape": f"int8 B={B_RESCORE}",
            "by_shape": rescore,
        },
        {
            "name": "rescore_rows",
            "route": "cuda",
            "source": "sqlite_vector_tpu_torch/csrc/rescore_rows.cu",
            "replaces": None,
            "launches": launches["rescore_rows"],
            "timing_launches": rescore_rows.pop("timing_launches"),
            "max_abs_err": rescore_rows.pop("max_abs_err"),
            **rescore_rows[f"f32 B={B_RESCORE}"],
            "main_shape": f"f32 B={B_RESCORE}",
            "by_shape": rescore_rows,
        },
    ], "host_storage": {k: host[k] for k in ("pinned_gbps", "stream_pass_s", "tile_sweep_s", "thread_sweep_s")},
        "frontends": {k: v for k, v in fe.items() if k != "sql_launches"},
        "mesh": mesh["times"]}))
    return result_lines()


if __name__ == "__main__":
    sys.exit(main())
