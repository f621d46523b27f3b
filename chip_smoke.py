#!/usr/bin/env python3
"""Smoke test of the PyTorch port (sqlite_vector_tpu_torch) on one CUDA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device   the card (nvidia-smi name and power limit), torch/CUDA versions
              and the TF32 flags, which are pinned off;
  2. build    compile the block-minima kernel (K1) and the packed-int4 kernel
              (K2) from csrc/ with nvcc, one process per source;
  3. kernel   K1 against its plain PyTorch twin on the card for every
              (metric x dtype) pair, N = 100003 (ragged last group),
              d in {100, 384}, B in {1, 8, 33}, valid < N, with a NaN row,
              two duplicate rows and a zero row; then K2 against its twin
              for its four metrics, d in {95, 384}, B in {1, 8, 33}, with a
              zero row, duplicate rows and rows scaled by 1e25 (overflowing
              surrogates, one group entirely);
  4. main     VectorStore(device="cuda"): create dimension=384 FLOAT32 L2,
              add 1,000,000 rows, search(Q, 20) for 64 queries (half drawn
              from the base) against a plain-torch ground truth, then
              quantize() and search(Q, 20, exact=False) against the plain
              integer-domain scan of the same codes; K1's launch count over
              these searches must be above 0;
  5. times    K1 at the main path's shapes (f32 B=1 and B=64, the int8 codes,
              u8 codes), held against the twin and timed against it (CUDA
              events, after warm-up, in turns); then end-to-end search at
              B=1 and B=64: QPS as all queries over the whole window of
              back-to-back calls, and the per-call latency p50, p99 and max;
  6. int4     on the same rows: quantize(qtype="int4", refine=True), then
              search(Q, 20, mode="quantized") against the plain int4 tile
              loop over the same codes and search(Q, 20, mode="refine")
              against the refine rescore of that loop's candidates; K2's
              launch count over these searches must be above 0; int4 and
              refine recall@20 against exact are printed;
  7. times    K2 alone against its twin at B=1 and B=64 (CUDA events, in
              turns), then end-to-end int4-quantized and refine search at
              B=1 and B=64, measured as in phase 5.

Then one JSON line of kernel results, the card line again, and last the
result line. Any failure raises, so the script exits non-zero and prints no
result; so does a machine without CUDA.
"""

from __future__ import annotations

import importlib.util
import json
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


def in_turns(plain, kernel, iters: int) -> tuple[float, float]:
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain after a
    warm-up of each."""
    for fn in (plain, kernel):
        fn()
    torch.cuda.synchronize()
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def make_rows(gen: torch.Generator, n: int, d: int, dtype: torch.dtype) -> torch.Tensor:
    dev = "cuda"
    if dtype is torch.uint8:
        return torch.randint(0, 256, (n, d), generator=gen, device=dev, dtype=torch.int32).to(dtype)
    if dtype is torch.int8:
        return torch.randint(-128, 128, (n, d), generator=gen, device=dev, dtype=torch.int32).to(dtype)
    return torch.randn((n, d), generator=gen, device=dev).to(dtype)


def compare_minima(q: torch.Tensor, base: torch.Tensor, metric, valid: int, label: str) -> float:
    """K1 against its twin on the same CUDA tensors: +inf positions equal,
    integer minima equal, float minima within 1e-5 of the magnitude of the
    accumulated terms (both widen to f32 and accumulate in f32, so they
    differ by summation order only). Returns max |kernel - twin| over the
    finite float minima (0 for integers)."""
    from sqlite_vector_tpu_torch.ops.block_scan import (
        block_minima,
        block_minima_reference,
    )
    from sqlite_vector_tpu_torch.types import DistanceMetric

    got = block_minima(q, base, metric, valid)
    ref = block_minima_reference(q, base, metric, valid)
    torch.cuda.synchronize()
    check(got.shape == ref.shape, f"{label}: shape {got.shape} != {ref.shape}")
    check(torch.equal(torch.isinf(got), torch.isinf(ref)), f"{label}: +inf positions differ")
    check(not bool(torch.isnan(got).any()), f"{label}: NaN minima")
    if not base.dtype.is_floating_point:
        check(torch.equal(got, ref), f"{label}: integer minima differ")
        return 0.0
    fin = torch.isfinite(ref)
    err = (got[fin] - ref[fin]).abs()
    if metric is DistanceMetric.COSINE:
        mag = 1.0
    elif metric is DistanceMetric.L1:
        mag = ref[fin].abs() + 1.0
    else:  # |q.b| and the norms are bounded by ||q||^2 + ||b||^2
        qf, bf = q.float(), base[:valid].float()
        bf = bf[torch.isfinite(bf).all(-1)]
        mag = float((qf * qf).sum(-1).max() + (bf * bf).sum(-1).max())
    worst = float(err.max()) if err.numel() else 0.0
    check(bool((err <= 1e-5 * mag).all()), f"{label}: max |kernel - twin| {worst} over tolerance")
    return worst


def phase_kernel(card: str) -> float:
    """K1 vs twin for all 25 (metric x dtype) pairs; returns the largest
    |kernel - twin| over finite float minima."""
    from sqlite_vector_tpu_torch.types import DistanceMetric

    n, valid = 100_003, 100_003 - 77
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    cases = 0
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.float16, torch.bfloat16, torch.uint8, torch.int8):
        for d in (100, 384):
            base = make_rows(gen, n, d, dtype)
            if dtype.is_floating_point:
                base[5] = torch.nan  # NaN row
            base[70_000] = base[10]  # duplicate rows
            base[200] = 0  # zero row
            for b in (1, 8, 33):
                q = make_rows(gen, b, d, dtype)
                q[0] = base[10]  # a self-match
                for metric in DistanceMetric:
                    label = f"{metric.value}/{dtype}/d={d}/B={b}"
                    worst = max(worst, compare_minima(q, base, metric, valid, label))
                cases += 1
            del base
    print(
        f"[kernel] K1 == twin on all 25 metric x dtype pairs ({cases} dtype/d/B "
        f"cases x 5 metrics, N={n}, valid={valid}; ints equal, floats within "
        f"1e-5 of the accumulated magnitude); max |kernel - twin| = {worst!r} "
        f"in {time.perf_counter() - t0:.1f} s | {card}",
        flush=True,
    )
    return worst


def load_tests_module(name: str):
    """The repo's tests/<name>.py, loaded by path: an installed package
    named `tests` may shadow the repo's tests/ directory."""
    spec = importlib.util.spec_from_file_location(
        f"svt_{name}", Path(__file__).resolve().parent / "tests" / f"{name}.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def compare_int4_minima(args, metric, valid: int, label: str) -> float:
    """K2 against its twin on the same CUDA tensors: +inf positions equal
    and finite minima EQUAL (tolerance 0): both take the exact integer dot
    and then the same float32 epilogue, each op rounded once in the same
    order (__fmul_rn/__fsub_rn and a correctly rounded 1/sqrt in the
    kernel, one torch op per step in the twin). Returns max |kernel - twin|
    over the finite minima."""
    from sqlite_vector_tpu_torch.ops.int4_scan import (
        int4_block_minima,
        int4_block_minima_reference,
    )

    got = int4_block_minima(*args, metric, valid)
    ref = int4_block_minima_reference(*args, metric, valid)
    torch.cuda.synchronize()
    check(got.shape == ref.shape, f"{label}: shape {got.shape} != {ref.shape}")
    check(not bool(torch.isnan(got).any()), f"{label}: NaN minima")
    check(torch.equal(torch.isinf(got), torch.isinf(ref)), f"{label}: inf positions differ")
    fin = torch.isfinite(ref)
    worst = float((got[fin] - ref[fin]).abs().max()) if bool(fin.any()) else 0.0
    check(torch.equal(got[fin], ref[fin]), f"{label}: max |kernel - twin| {worst}")
    return worst


def phase_kernel_int4(card: str) -> float:
    """K2 vs twin for its 4 metrics x d in {95, 384} x B in {1, 8, 33};
    returns the largest |kernel - twin| over finite minima."""
    from sqlite_vector_tpu_torch.ops.int4_scan import int4_block_minima
    from sqlite_vector_tpu_torch.types import DistanceMetric

    # the card tests' edge cases: zero row, duplicates, 1e25-scaled rows
    int4_case = load_tests_module("test_torch_kernel_cuda").int4_case
    n, valid = 100_003, 100_003 - 77
    metrics = [m for m in DistanceMetric if m is not DistanceMetric.L1]
    worst = 0.0
    t0 = time.perf_counter()
    for d in (95, 384):
        for b in (1, 8, 33):
            args, _ = int4_case(n, d, b, "cuda", seed=SEED + 2 + d + b)
            for metric in metrics:
                label = f"K2 {metric.value}/d={d}/B={b}"
                worst = max(worst, compare_int4_minima(args, metric, valid, label))
                if b > 1 and metric is DistanceMetric.L2:
                    # group 1 against the scaled query: NaN or +inf throughout
                    m = int4_block_minima(*args, metric, valid)
                    check(float(m[-1, 1]) == float("inf"), f"{label}: overflowing group not +inf")
            del args
    print(
        f"[kernel] K2 == twin for {len(metrics)} metrics x d in (95, 384) x B in "
        f"(1, 8, 33) (N={n}, valid={valid}, zero/duplicate/1e25-scaled rows; "
        f"+inf positions equal, finite minima equal); max |kernel - twin| = "
        f"{worst!r} in {time.perf_counter() - t0:.1f} s | {card}",
        flush=True,
    )
    return worst


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
    ids_e, d_e = ds.search(Q, K)
    launches = block_minima.launches
    check(launches > 0, "exact search did not launch K1")
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


def phase_times(card: str, ds, Q) -> tuple[float, float, float]:
    """K1 at the main path's own shapes, held against its twin and timed
    against it; then end-to-end search. Returns (kernel ms, twin ms) at
    f32 B=B_MAIN and the largest |kernel - twin| seen here."""
    from sqlite_vector_tpu_torch.ops.block_scan import (
        block_minima,
        block_minima_reference,
    )
    from sqlite_vector_tpu_torch.ops.quantize import quantize_device
    from sqlite_vector_tpu_torch.types import DistanceMetric

    L2 = DistanceMetric.L2
    vecs = ds._vectors[: len(ds)]
    Qd = torch.from_numpy(Q).cuda()
    n = vecs.shape[0]
    shape = f"{n}x{DIM_MAIN}"
    qt, scale, offset = ds.quant_params
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = 0.0
    main_ms = None
    for label, q, base, iters in (
        ("f32 B=1", Qd[:1].contiguous(), vecs, 20),
        (f"f32 B={B_MAIN}", Qd, vecs, 10),
        (f"{qt.value} codes B={B_MAIN}", quantize_device(Qd, scale, offset, qt), ds._quant.codes, 10),
        (f"u8 B={B_MAIN}", make_rows(gen, B_MAIN, DIM_MAIN, torch.uint8),
         make_rows(gen, n, DIM_MAIN, torch.uint8), 10),
    ):
        worst = max(worst, compare_minima(q, base, L2, n, f"main-path {label}"))
        k_ms, p_ms = in_turns(
            lambda: block_minima_reference(q, base, L2, n),
            lambda: block_minima(q, base, L2, n),
            iters,
        )
        if base is vecs and q.shape[0] == B_MAIN:
            main_ms = (k_ms, p_ms)
        gbs = base.numel() * base.element_size() / (k_ms * 1e-3) / 1e9
        print(
            f"[times] K1 {shape} {label} L2 (== twin): kernel {k_ms!r} ms "
            f"({gbs:.0f} GB/s of matrix), twin {p_ms!r} ms | {card}",
            flush=True,
        )

    for mode in ("exact", "quantized"):
        search_times(card, ds, Q, mode, shape, ((1, 500), (B_MAIN, 200)))
    return main_ms[0], main_ms[1], worst


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
    ids_q, d_q = ds.search(Q, K, mode="quantized")
    ids_r, d_r = ds.search(Q, K, mode="refine")
    launches = int4_block_minima.launches
    check(launches > 0, "int4 quantized/refine search did not launch K2")
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
        f"refine {recall(ids_r)!r}; K2 launches {launches}, K1 launches 0 | {card}",
        flush=True,
    )
    return launches


def phase_int4_times(card: str, ds, Q) -> tuple[float, float]:
    """K2 alone against its twin at B=1 and B=B_MAIN, then end-to-end
    int4-quantized and refine search. Returns (kernel ms, twin ms) at
    B=B_MAIN."""
    from sqlite_vector_tpu_torch.ops.int4_scan import (
        int4_block_minima,
        int4_block_minima_reference,
    )
    from sqlite_vector_tpu_torch.ops.quantize4 import quantize_query_int8
    from sqlite_vector_tpu_torch.types import DistanceMetric

    L2 = DistanceMetric.L2
    quant = ds._quant
    n = quant.count
    shape = f"{n}x{DIM_MAIN}"
    Qd = torch.from_numpy(Q).cuda()
    out = None
    for b, iters in ((1, 20), (B_MAIN, 10)):
        qc, qs, _ = quantize_query_int8(Qd[:b])
        args = (qc, qs, quant.codes, quant.row_scale, quant.sq_norms)
        compare_int4_minima(args, L2, n, f"main-path K2 B={b}")
        k_ms, p_ms = in_turns(
            lambda: int4_block_minima_reference(*args, L2, n),
            lambda: int4_block_minima(*args, L2, n),
            iters,
        )
        gbs = quant.codes.numel() / (k_ms * 1e-3) / 1e9
        print(
            f"[times] K2 {shape} f32 queries B={b} L2 (== twin): kernel {k_ms!r} ms "
            f"({gbs:.0f} GB/s of packed codes), twin {p_ms!r} ms | {card}",
            flush=True,
        )
    for mode, label in (("quantized", "int4 quantized"), ("refine", "refine expand=4")):
        search_times(card, ds, Q, mode, shape, ((1, 200), (B_MAIN, 100)), label)
    return k_ms, p_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 1
    from sqlite_vector_tpu_torch.ops._build import library_path, load_library

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
        f"[build] K1 and K2 built from csrc/ and loaded in {time.perf_counter() - t0:.1f} s "
        f"-> {library_path().name}",
        flush=True,
    )
    max_err = phase_kernel(card)
    k2_err = phase_kernel_int4(card)
    ds, Q, ids_e, launches = phase_main(card)
    k_ms, p_ms, main_err = phase_times(card, ds, Q)  # reads the int8 state
    k2_launches = phase_int4(card, ds, Q, ids_e)
    k2_ms, k2_plain_ms = phase_int4_times(card, ds, Q)
    print(json.dumps({"kernels": [
        {
            "name": "block_minima",
            "route": "cuda",
            "source": "sqlite_vector_tpu_torch/csrc/block_minima.cu",
            "replaces": "sqlite_vector_tpu/ops/pallas_scan.py:681",
            "launches": launches,
            "max_abs_err": max(max_err, main_err),
            "ms": k_ms,
            "plain_ms": p_ms,
        },
        {
            "name": "int4_block_minima",
            "route": "cuda",
            "source": "sqlite_vector_tpu_torch/csrc/int4_minima.cu",
            "replaces": "sqlite_vector_tpu/ops/pallas_int4.py:408",
            "launches": k2_launches,
            "max_abs_err": k2_err,
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
        },
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
