#!/usr/bin/env python3
"""Smoke test of the PyTorch port (sqlite_vector_tpu_torch) on one CUDA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device   the card (nvidia-smi name and power limit), torch/CUDA versions
              and the TF32 flags, which are pinned off;
  2. build    compile K1's two bodies (csrc/block_minima_mma.cu on tensor
              cores, csrc/block_minima.cu on CUDA cores) and the packed-int4
              kernel K2's two bodies (csrc/int4_minima_mma.cu on tensor
              cores, csrc/int4_minima.cu on CUDA cores) from csrc/ with nvcc,
              one process per source, and print what ptxas reported of each
              function (registers, stack, spills); no instance of either
              tensor-core body may spill;
  3. kernel   K1 against its plain PyTorch twin on the card for every
              (metric x dtype) pair, in the body ops/block_scan.py:k1_body
              routes it to, N = 100003 (ragged last group), d in {100, 384},
              B in {1, 8, 33, 64, 65, 200} (query-tile edges), valid < N,
              with a NaN row, two duplicate rows and a zero row; then f32
              rows and queries with +Inf, -Inf, values whose squared norms
              overflow, and 0 x Inf (tests/test_torch_kernel_cuda.py:
              nonfinite_case) under
              every metric; then K2 against its twin
              for its four metrics, d in {95, 384}, B in {1, 8, 33, 64, 65,
              200}, with a zero row, duplicate rows and rows scaled by 1e25
              (overflowing surrogates, one group entirely); each case also
              with the four row masks of tests/test_torch_kernel_cuda.py:
              mask_case (a random half, a group with no live row, every row
              masked, three live rows); each case in the body
              ops/int4_scan.py:k2_body routes it to and in the CUDA-core
              body, the two equal bit for bit;
  4. main     VectorStore(device="cuda"): create dimension=384 FLOAT32 L2,
              add 1,000,000 rows, search(Q, 20) for 64 queries (half drawn
              from the base) against a plain-torch ground truth, then
              quantize() and search(Q, 20, exact=False) against the plain
              integer-domain scan of the same codes; K1's launch count over
              these searches must be above 0, every launch in its
              tensor-core body;
  5. times    K1 at the main path's shapes (f32, the int8 codes and u8 codes,
              each at B=1 and B=64), both bodies held against the twin and
              timed in turns (CUDA events, after warm-up) with the twin, the
              CUDA-core body and the library yardstick (library_call), beside
              its bound (k1_bound) and its share of it; then the CUDA-core
              body where it is K1's only body (L1 over the f32 rows, L2
              over the rows cast to float16 and bfloat16, B=1 and B=64)
              against the twin, its bound (k1_bound_cuda_core) and the
              library (torch.cdist(p=1), torch.matmul in 16 bits); then end-to-end
              search at B=1 and B=64: QPS as all queries over the whole
              window of back-to-back calls, and the per-call latency p50,
              p99 and max; then exact and int8 search at B=1 with K1 in
              each body, in turns (body_latency);
  6. int4     on the same rows: quantize(qtype="int4", refine=True), then
              search(Q, 20, mode="quantized") against the plain int4 tile
              loop over the same codes and search(Q, 20, mode="refine")
              against the refine rescore of that loop's candidates; K2's
              launch count over these searches must be above 0; int4 and
              refine recall@20 against exact are printed; every K2 launch
              must take its tensor-core body;
  7. times    K2 at B=1 and B=64, both bodies held against the twin, then
              timed (CUDA events): the twin apart, the routed body, the
              CUDA-core body and the library yardstick (library_call_k2) in
              five rounds of turns (medians), beside its bound (k2_bound);
              then end-to-end int4-quantized and refine search at B=1 and
              B=64, measured as in phase 5, every K2 launch in its
              tensor-core body;
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
              searches must be above 0, K2's all in its tensor-core body.
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

Then one JSON line of kernel results (each with its bound, the side that
bounds it and the library yardstick; K1's main-path numbers are f32 B=64,
K2's B=64, the rest under "by_shape"; "sql_launches" counts phase 10's
launches on the SQL path; phase 10's times under "frontends"), the card
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
PEAK_OPS_PER_S = {"tf32": 495e12, "int8": 1979e12, "fp16": 989e12, "fp32": 67e12}


def bound(nbytes: float, ops: float, peak: str) -> tuple[float, str]:
    """The least ms the card could take: the larger of the bytes over the
    HBM rate and the operations over the type's peak, and which of the two
    it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(b: int, n: int, d: int, elem: int, masked: bool = False) -> tuple[float, str]:
    """K1's bound: queries and rows read once (plus a mask byte a row), the
    [B, ceil(N/128)] float32 minima written once; 2 B N d products, each
    three TF32 products for 4-byte rows (the 3xTF32 split, the cheapest
    float32-accurate product on the card: 67 TFLOP/s of float32 outside
    the tensor cores is slower) and one int8 product for 1-byte codes."""
    nbytes = (b + n) * d * elem + b * -(-n // 128) * 4 + (n if masked else 0)
    if elem == 4:
        return bound(nbytes, 3 * 2.0 * b * n * d, "tf32")
    return bound(nbytes, 2.0 * b * n * d, "int8")


def k1_bound_cuda_core(b: int, n: int, d: int, elem: int, metric) -> tuple[float, str]:
    """K1's bound where only its CUDA-core body serves: the same bytes as
    k1_bound; for L1 2 B N d operations (a subtract and an add a pair, the
    absolute value a sign bit) at the float32 rate outside the tensor
    cores, which have no L1 form; for float16/bfloat16 rows the 2 B N d
    products at the 16-bit tensor-core peak, the least the card could take."""
    nbytes = (b + n) * d * elem + b * -(-n // 128) * 4
    return bound(nbytes, 2.0 * b * n * d, "fp32" if metric.value == "L1" else "fp16")


def k2_bound(b: int, n: int, d: int, masked: bool = False) -> tuple[float, str]:
    """K2's bound: packed codes (d/2 bytes a row), alpha and csq (4 bytes
    each a row), int8 query codes and their scales read once, the minima
    written once; 2 B N d int8 operations."""
    nbytes = n * (-(-d // 2) + 8) + b * (d + 4) + b * -(-n // 128) * 4 + (n if masked else 0)
    return bound(nbytes, 2.0 * b * n * d, "int8")


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
    under every metric, unmasked
    and with each of `masks`; DOT over group 30 reads -inf for query 2.
    Returns max |kernel - twin| over the finite minima."""
    from sqlite_vector_tpu_torch.ops.block_scan import block_minima
    from sqlite_vector_tpu_torch.types import DistanceMetric

    q, base = load_tests_module("test_torch_kernel_cuda").nonfinite_case(n, "cuda", seed=SEED)
    valid = n - 40
    worst = 0.0
    for metric in DistanceMetric:
        for kind, mask in [("none", None), *(masks or {}).items()]:
            label = f"non-finite f32 {metric.value}/mask={kind}"
            worst = max(worst, compare_minima(q, base, metric, valid, label, mask))
    dot = block_minima(q, base, DistanceMetric.DOT, valid)
    check(float(dot[2, 30]) == float("-inf"), "DOT over a +Inf column does not read -inf")
    check(float(dot[6, 31]) == float("-inf"), "DOT of -Inf against -Inf does not read -inf")
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
        for d in (100, 384):
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
                    for kind, mask in masks.items():
                        masked_worst = max(masked_worst, compare_minima(
                            q, base, metric, valid, f"{label}/mask={kind}", mask
                        ))
                cases += 1
            del base
    nonfinite_worst = check_nonfinite(n, masks)
    print(
        f"[kernel] K1 == twin on all 25 metric x dtype pairs ({cases} dtype/d/B "
        f"cases, B in 1, 8, 33, 64, 65, 200, x 5 metrics, N={n}, valid={valid}; ints "
        f"equal, floats within 1e-5 of the accumulated magnitude); max |kernel - twin| "
        f"= {worst!r}; masked ({len(masks)} row masks each: {', '.join(masks)}): max "
        f"|kernel - twin| = {masked_worst!r}, +inf groups equal; non-finite f32 rows "
        f"and queries (+Inf, -Inf, overflowing norms, 0 x Inf) under every metric, unmasked "
        f"and masked: +-inf positions equal, max |kernel - twin| = {nonfinite_worst!r}; "
        f"in {time.perf_counter() - t0:.1f} s | {card}",
        flush=True,
    )
    return worst, masked_worst, nonfinite_worst


@functools.cache
def load_tests_module(name: str):
    """The repo's tests/<name>.py, loaded once, by path: an installed
    package named `tests` may shadow the repo's tests/ directory."""
    spec = importlib.util.spec_from_file_location(
        f"svt_{name}", Path(__file__).resolve().parent / "tests" / f"{name}.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def compare_int4_minima(args, metric, valid: int, label: str, mask=None) -> float:
    """K2, in the body k2_body routes to and (where that is the tensor-core
    body) forced onto the CUDA-core body, against its twin on the same CUDA
    tensors: +inf positions equal and finite minima EQUAL (tolerance 0):
    both take the exact integer dot and then the same float32 epilogue,
    each op rounded once in the same order (__fmul_rn/__fsub_rn and a
    correctly rounded 1/sqrt in the kernel, one torch op per step in the
    twin); the two bodies equal bit for bit. Returns max |kernel - twin|
    over the finite minima."""
    from sqlite_vector_tpu_torch.ops.int4_scan import (
        _launch_k2,
        int4_block_minima,
        int4_block_minima_reference,
        k2_body,
    )

    got = {k2_body(args[0].shape[1]): int4_block_minima(*args, metric, valid, mask)}
    if "mma" in got:
        got["simt"] = _launch_k2(*args, metric, valid, mask, "simt")
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
    if len(got) == 2:
        check(torch.equal(got["mma"].view(torch.int32), got["simt"].view(torch.int32)),
              f"{label}: the two bodies differ in some bit")
    return worst


def phase_kernel_int4(card: str) -> tuple[float, float]:
    """K2 (both bodies) vs twin for its 4 metrics x d in {95, 384} x B in
    {1, 8, 33, 64, 65, 200}, unmasked and with each row mask; returns the
    largest |kernel - twin| over finite minima, unmasked and masked."""
    from sqlite_vector_tpu_torch.ops.int4_scan import int4_block_minima, k2_body
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
    for d in (95, 384):
        check(k2_body(d) == "mma", f"K2 at d={d} routes to its {k2_body(d)} body")
        for b in batches:
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
    print(
        f"[kernel] K2 == twin for {len(metrics)} metrics x d in (95, 384) x B in "
        f"{batches} (N={n}, valid={valid}, zero/duplicate/1e25-scaled rows; "
        f"+inf positions equal, finite minima equal), the tensor-core body (routed) "
        f"and the CUDA-core body each, equal bit for bit; max |kernel - twin| = "
        f"{worst!r}; masked ({len(masks)} row masks each): max |kernel - twin| = "
        f"{masked_worst!r}; in {time.perf_counter() - t0:.1f} s | {card}",
        flush=True,
    )
    return worst, masked_worst


def phase_main(card: str):
    import sqlite_vector_tpu_torch as svt
    from sqlite_vector_tpu_torch.ops.block_scan import block_minima
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
    block_minima.launches = 0
    block_minima.body_launches = {"mma": 0, "simt": 0}
    ids_e, d_e = ds.search(Q, K)
    launches = block_minima.launches
    check(launches > 0, "exact search did not launch K1")
    check(block_minima.body_launches["mma"] == launches, "exact search left K1's tensor-core body")
    vecs = ds._vectors[: len(ds)]
    Qd = torch.from_numpy(Q).cuda()
    oracle = pairwise_distance(Qd, vecs, svt.DistanceMetric.L2).cpu().numpy()
    for i in range(B_MAIN):
        assert_topk_parity(
            ids_all, oracle[i], ids_e[i], d_e[i], K,
            rel_tol=REL_TOL_BY_TYPE["FLOAT32"], label=f"exact q{i}",
        )
    for i, p in enumerate(picks):
        check(ids_e[i, 0] == ids_all[p] and d_e[i, 0] == 0.0, f"q{i}: self-match not first at 0")
    print(
        f"[main] exact search(Q[{B_MAIN}], {K}): ids match the plain-torch ground "
        f"truth (tie-aware, rel_tol {REL_TOL_BY_TYPE['FLOAT32']}), {len(picks)}/"
        f"{len(picks)} self-matches first at 0.0, K1 launches {launches} | {card}",
        flush=True,
    )

    # -- quantized -------------------------------------------------------
    t0 = time.perf_counter()
    ds.quantize()
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    qt, scale, offset = ds.quant_params
    before = block_minima.launches
    ids_q, d_q = ds.search(Q, K, exact=False)
    check(block_minima.launches > before, "quantized search did not launch K1")
    check(block_minima.body_launches == {"mma": block_minima.launches, "simt": 0},
          "quantized search left K1's tensor-core body")
    launches = block_minima.launches
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
        f"{recall!r}; K1 launches (exact + quantized) {launches} | {card}",
        flush=True,
    )
    return ds, Q, ids_e, launches


def phase_times(card: str, ds, Q) -> dict:
    """K1 at the main path's shapes (f32, the int8 codes and u8 codes, each
    at B=1 and B=B_MAIN), both bodies held against the twin, then timed in
    turns with the twin, the CUDA-core body and the library yardstick,
    beside its bound; then end-to-end search. Returns, by label, the
    kernel's, the twin's, the CUDA-core body's and the library's ms with the
    bound, and the largest |kernel - twin| seen here under "max_abs_err"."""
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
        out["max_abs_err"] = max(out["max_abs_err"], compare_minima(q, base, L2, n, f"main-path {label}"))
        compare_minima(q, base, L2, n, f"main-path {label}, CUDA-core body", body="simt")
        fns = [
            lambda: block_minima_reference(q, base, L2, n),
            lambda: block_minima(q, base, L2, n),
            lambda: _launch_k1(q, base, L2, n, None, "simt"),
        ]
        lib = library_call(q, base)
        ms = in_turns(fns + ([lib] if lib else []), 20 if b == 1 else 10)
        lim, by = k1_bound(b, n, DIM_MAIN, base.element_size())
        out[label] = {"ms": ms[1], "plain_ms": ms[0], "simt_ms": ms[2],
                      "library_ms": ms[3] if lib else None, "bound_ms": lim, "bound_by": by}
        print(
            f"[times] K1 {shape} {label} L2 (both bodies == twin; {k1_body(base.dtype, L2, DIM_MAIN)} "
            f"body): kernel {ms[1]!r} ms, bound {lim!r} ms ({by}), {100 * lim / ms[1]:.1f}% "
            f"of bound; CUDA-core body {ms[2]!r} ms; twin {ms[0]!r} ms; library "
            f"{'none' if not lib else repr(ms[3]) + ' ms'} | {card}",
            flush=True,
        )
    del u8_base

    # K1's CUDA-core body where it is the only body: L1 over the f32 rows,
    # L2 over the same rows cast to float16 and bfloat16
    L1 = DistanceMetric.L1
    cuda_core = [("L1 f32", L1, Qd, vecs, lambda q, base: lambda: torch.cdist(q, base, p=1))]
    for name, dt in (("f16", torch.float16), ("bf16", torch.bfloat16)):
        cuda_core.append((f"L2 {name}", L2, Qd.to(dt), vecs.to(dt), lambda q, base: lambda: torch.matmul(q, base.T)))
    for name, metric, q_all, base, library in cuda_core:
        check(k1_body(base.dtype, metric, DIM_MAIN) == "simt", f"{name} does not route to the CUDA-core body")
        for b in (1, B_MAIN):
            q = q_all[:b].contiguous()
            label = f"{name} B={b}"
            out["max_abs_err"] = max(out["max_abs_err"], compare_minima(q, base, metric, n, f"main-path {label}"))
            ms = in_turns(
                [lambda: block_minima_reference(q, base, metric, n), lambda: block_minima(q, base, metric, n),
                 library(q, base)],
                20 if b == 1 else 5,
            )
            lim, by = k1_bound_cuda_core(b, n, DIM_MAIN, base.element_size(), metric)
            out[label] = {"ms": ms[1], "plain_ms": ms[0], "simt_ms": ms[1], "library_ms": ms[2],
                          "bound_ms": lim, "bound_by": by}
            lib_name = "torch.cdist(p=1)" if metric is L1 else f"torch.matmul in {name.split()[1]}"
            print(
                f"[times] K1 {shape} {label} {metric.value} (CUDA-core body == twin): kernel "
                f"{ms[1]!r} ms, bound {lim!r} ms ({by}), {100 * lim / ms[1]:.1f}% of bound; twin "
                f"{ms[0]!r} ms; library {lib_name} {ms[2]!r} ms | {card}",
                flush=True,
            )
    del cuda_core

    for mode in ("exact", "quantized"):
        search_times(card, ds, Q, mode, shape, ((1, 500), (B_MAIN, 200)))
    body_latency(card, ds, Q, shape)
    return out


def body_latency(
    card: str, ds, Q, shape: str, modes=("exact", "quantized"), label: str = "",
    rounds: int = 10, calls: int = 100,
) -> None:
    """Search at B=1 in each of `modes` with K1 in its routed (tensor-core)
    body and forced onto the CUDA-core body, in one process on the same
    data: p50 call latency of `calls` back-to-back calls per round, the two
    bodies in turns (ABBA), `rounds` rounds each."""
    from sqlite_vector_tpu_torch.ops import block_scan

    routed = block_scan.k1_body
    for mode in modes:
        p50 = {"mma": [], "simt": []}
        for r in range(rounds):
            for body in ("mma", "simt") if r % 2 == 0 else ("simt", "mma"):
                block_scan.k1_body = routed if body == "mma" else (lambda *_: "simt")
                try:
                    for _ in range(3):
                        ds.search(Q[:1], K, mode=mode)
                    walls = []
                    for _ in range(calls):
                        t0 = time.perf_counter()
                        ds.search(Q[:1], K, mode=mode)
                        walls.append(time.perf_counter() - t0)
                finally:
                    block_scan.k1_body = routed
                p50[body].append(float(np.median(walls)) * 1e3)
        wins = sum(a < b for a, b in zip(p50["mma"], p50["simt"]))
        print(
            f"[times] search {mode}{label} {shape} k={K} B=1, K1 body in turns ({rounds} rounds of "
            f"{calls} calls): p50 per round, tensor-core body {p50['mma']!r} ms, CUDA-core body "
            f"{p50['simt']!r} ms; medians {float(np.median(p50['mma']))!r} / "
            f"{float(np.median(p50['simt']))!r} ms; tensor-core body faster in {wins}/{rounds} "
            f"rounds | {card}",
            flush=True,
        )


def search_times(card: str, ds, Q, mode: str, shape: str, plan, label: str = "") -> None:
    """End-to-end search: for each (B, calls) in plan, QPS as all queries
    over the whole window of back-to-back calls, and the per-call latency
    p50, p99 and max (host clock; search returns host arrays, so each call
    is synchronous)."""
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
        print(
            f"[times] search {label or mode} {shape} k={K} B={b}: QPS {b * reps / window!r} "
            f"({b * reps} queries in {reps} back-to-back calls, {window * 1e3!r} ms "
            f"window); call latency p50 {p50!r} ms, p99 {p99!r} ms, max "
            f"{max(walls) * 1e3!r} ms | {card}",
            flush=True,
        )


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

    block_minima.launches = 0
    int4_block_minima.launches = 0
    int4_block_minima.body_launches = {"mma": 0, "simt": 0}
    ids_q, d_q = ds.search(Q, K, mode="quantized")
    ids_r, d_r = ds.search(Q, K, mode="refine")
    launches = int4_block_minima.launches
    check(launches > 0, "int4 quantized/refine search did not launch K2")
    check(int4_block_minima.body_launches == {"mma": launches, "simt": 0},
          f"int4 searches left K2's tensor-core body: {int4_block_minima.body_launches}")
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
        f"refine {recall(ids_r)!r}; K2 launches {launches}, all in its tensor-core body, "
        f"K1 launches 0 | {card}",
        flush=True,
    )
    return launches


def phase_int4_times(card: str, ds, Q) -> dict:
    """K2 at B=1 and B=B_MAIN, both bodies held against the twin, then
    timed in turns with the twin, the CUDA-core body and the library
    yardstick, beside its bound; then end-to-end int4-quantized and refine
    search, every K2 launch in its tensor-core body. Returns, by label, the
    kernel's, the twin's, the CUDA-core body's and the library's ms with
    the bound, and the largest |kernel - twin| under "max_abs_err"."""
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
        fns = [lambda: int4_block_minima(*args, L2, n), lambda: _launch_k2(*args, L2, n, None, "simt")]
        lib = library_call_k2(qc, codes8)
        ms = in_turns(fns + ([lib] if lib else []), iters, rounds=5)
        lim, by = k2_bound(b, n, DIM_MAIN)
        label = f"B={b}"
        out[label] = {"ms": ms[0], "plain_ms": plain_ms, "simt_ms": ms[1],
                      "library_ms": ms[2] if lib else None, "bound_ms": lim, "bound_by": by}
        print(
            f"[times] K2 {shape} f32 queries {label} L2 (both bodies == twin; mma body): kernel "
            f"{ms[0]!r} ms ({quant.codes.numel() / (ms[0] * 1e-3) / 1e9:.0f} GB/s of packed "
            f"codes), bound {lim!r} ms ({by}), {100 * lim / ms[0]:.1f}% of bound; CUDA-core body "
            f"{ms[1]!r} ms; twin {plain_ms!r} ms; library (torch._int_mm) "
            f"{'none' if not lib else repr(ms[2]) + ' ms'} (medians of 10 passes in turns) | {card}",
            flush=True,
        )
    del codes8
    int4_block_minima.body_launches = {"mma": 0, "simt": 0}
    for mode, label in (("quantized", "int4 quantized"), ("refine", "refine expand=4")):
        search_times(card, ds, Q, mode, shape, ((1, 200), (B_MAIN, 100)), label)
    used = int4_block_minima.body_launches
    check(used["mma"] > 0 and used["simt"] == 0, f"timed int4 searches left K2's tensor-core body: {used}")
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

    block_minima.launches = 0
    int4_block_minima.launches = 0
    int4_block_minima.body_launches = {"mma": 0, "simt": 0}
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
    check(int4_block_minima.body_launches == {"mma": masked["K2"], "simt": 0},
          f"masked int4 searches left K2's tensor-core body: {int4_block_minima.body_launches}")
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
    k1_mma, k1_simt = in_turns(
        [lambda: block_minima(q1, vecs, L2, len(ds)), lambda: _launch_k1(q1, vecs, L2, len(ds), None, "simt")],
        20,
    )
    print(
        f"[times] K1 alone {len(ds)}x{DIM_MAIN} B=1 L2 after compact: tensor-core body "
        f"{k1_mma!r} ms, CUDA-core body {k1_simt!r} ms | {card}",
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

    return {"K1": (block_minima.launches, block_minima.body_launches["mma"]),
            "K2": (int4_block_minima.launches, int4_block_minima.body_launches["mma"])}


def zero_counts() -> None:
    from sqlite_vector_tpu_torch.ops.block_scan import block_minima
    from sqlite_vector_tpu_torch.ops.int4_scan import int4_block_minima

    for fn in (block_minima, int4_block_minima):
        fn.launches = 0
        fn.body_launches = {"mma": 0, "simt": 0}


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
    return {"K1": streamed["K1"][0], "K2": streamed["K2"][0], **times}


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
          f"{native.build_dir().relative_to(Path(__file__).resolve().parent)} in {time.perf_counter() - t0:.1f} s "
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
    import threading
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 1
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
        f"[build] K1 and K2 (two bodies each) built from csrc/ and loaded in {time.perf_counter() - t0:.1f} s "
        f"-> {library_path().name}",
        flush=True,
    )
    for name, said in ptxas_report().items():
        print(f"[build] ptxas {name}: {said}", flush=True)
        if "mma_minima_kernel" in name:  # K1's and K2's tensor-core bodies
            check(" 0 bytes spill stores" in f" {said}", f"{name} spills: {said}")
    max_err, masked_err, nonfinite_err = phase_kernel(card)
    k2_err, k2_masked_err = phase_kernel_int4(card)
    ds, Q, ids_e, launches = phase_main(card)
    k1 = phase_times(card, ds, Q)  # reads the int8 state
    k2_launches = phase_int4(card, ds, Q, ids_e)
    k2 = phase_int4_times(card, ds, Q)
    masked = phase_mutate(card, ds, Q)["masked_launches"]
    host = phase_persist(card, ds, Q)
    fe = phase_frontends(card, Q)
    k1_main = k1[f"f32 B={B_MAIN}"]
    k2_main = k2[f"B={B_MAIN}"]
    print(json.dumps({"kernels": [
        {
            "name": "block_minima",
            "route": "cuda",
            "source": "sqlite_vector_tpu_torch/csrc/block_minima_mma.cu",
            "replaces": "sqlite_vector_tpu/ops/pallas_scan.py:681",
            "launches": launches,
            "max_abs_err": max(max_err, k1["max_abs_err"]),
            "ms": k1_main["ms"],
            "plain_ms": k1_main["plain_ms"],
            "bound_ms": k1_main["bound_ms"],
            "bound_by": k1_main["bound_by"],
            "library_ms": k1_main["library_ms"],
            "masked_launches": masked["K1"],
            "streamed_launches": host["K1"],
            "sql_launches": fe["sql_launches"]["K1"]["launches"],
            "masked_max_abs_err": masked_err,
            "nonfinite_max_abs_err": nonfinite_err,
            "cuda_core_body": "sqlite_vector_tpu_torch/csrc/block_minima.cu",
            "by_shape": {k: v for k, v in k1.items() if k != "max_abs_err"},
        },
        {
            "name": "int4_block_minima",
            "route": "cuda",
            "source": "sqlite_vector_tpu_torch/csrc/int4_minima_mma.cu",
            "replaces": "sqlite_vector_tpu/ops/pallas_int4.py:408",
            "launches": k2_launches,
            "max_abs_err": max(k2_err, k2["max_abs_err"]),
            "ms": k2_main["ms"],
            "plain_ms": k2_main["plain_ms"],
            "bound_ms": k2_main["bound_ms"],
            "bound_by": k2_main["bound_by"],
            "library_ms": k2_main["library_ms"],
            "masked_launches": masked["K2"],
            "streamed_launches": host["K2"],
            "sql_launches": fe["sql_launches"]["K2"]["launches"],
            "masked_max_abs_err": k2_masked_err,
            "cuda_core_body": "sqlite_vector_tpu_torch/csrc/int4_minima.cu",
            "by_shape": {k: v for k, v in k2.items() if k != "max_abs_err"},
        },
    ], "host_storage": {k: host[k] for k in ("pinned_gbps", "stream_pass_s", "tile_sweep_s", "thread_sweep_s")},
        "frontends": {k: v for k, v in fe.items() if k != "sql_launches"}}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
