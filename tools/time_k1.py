#!/usr/bin/env python3
"""Time K1 (ops/block_scan.py:block_minima, routed as the checkout routes
it, and for float L2 rows each body the checkout has forced), and K2
(ops/int4_scan.py:int4_block_minima, L2 over the rows' int4 codes, routed
and each body the checkout has forced) in two or more checkouts of this repository on one CUDA card, in turns (A B B A
per round), at the main path's size: 1,000,000 x 384 rows from N(0, 1)
(seed 0) and 64 queries, cast for the 16-bit and u8 shapes (u8: the rows
scaled by 32 and offset by 128, clamped); and the exact finish that
follows K1 (ops/block_scan.py:_finish_from_minima, k=20, f32 L2 at B=1 and
64: select 20 groups, gather and rescore their rows, top-k).

    python3 tools/time_k1.py CHECKOUT_A CHECKOUT_B [--rounds 2] [--out FILE]

Each turn is a fresh process that imports sqlite_vector_tpu_torch from
that checkout (its kernels built from its own sources) and reports the mean
ms per launch over CUDA-event windows after a warm-up. Prints the card
line, every turn's times and, per checkout and shape, the median over its
turns; --out writes them as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

# (metric, dtype, B)
SHAPES = [
    ("L1", "float32", 1), ("L1", "float32", 64), ("L1", "float16", 64), ("L1", "uint8", 1),
    ("L1", "uint8", 64), ("L2", "float16", 1), ("L2", "float16", 64), ("L2", "bfloat16", 1),
    ("L2", "bfloat16", 64), ("L2", "float32", 1), ("L2", "float32", 64), ("L2", "uint8", 1),
    ("L2", "uint8", 64),
]


# (metric, dtype, B) timed in each body the checkout has
FORCED = [("L2", "float32", 1), ("L2", "float32", 64), ("L2", "float16", 64)]


def worker() -> None:
    import torch

    from sqlite_vector_tpu_torch.ops.block_scan import _finish_from_minima, _launch_k1, block_minima
    from sqlite_vector_tpu_torch.ops.int4_scan import _launch_k2, int4_block_minima
    from sqlite_vector_tpu_torch.ops.quantize4 import quantize4_device, quantize_query_int8
    from sqlite_vector_tpu_torch.types import DistanceMetric

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = torch.randn((1_000_000, 384), generator=gen, device="cuda")
    queries = torch.randn((64, 384), generator=gen, device="cuda")
    out = {}
    for metric, dtype, b in SHAPES:
        dt = getattr(torch, dtype)
        if dt is torch.uint8:
            base = (rows * 32 + 128).clamp(0, 255).to(dt)
            q = (queries[:b] * 32 + 128).clamp(0, 255).to(dt)
        else:
            base, q = rows.to(dt), queries[:b].to(dt).contiguous()
        m = DistanceMetric(metric)
        out[f"{metric} {dtype} B={b}"] = window_ms(
            lambda: block_minima(q, base, m, base.shape[0]), 20 if b == 1 else 10)
        if (metric, dtype, b) in FORCED:
            for body in block_minima.body_launches:
                out[f"{metric} {dtype} B={b} [{body}]"] = window_ms(
                    lambda: _launch_k1(q, base, m, base.shape[0], None, body), 20 if b == 1 else 10)
        del base
    for b in (1, 64):
        q = queries[:b].contiguous()
        minima = block_minima(q, rows, DistanceMetric.L2, rows.shape[0])
        out[f"finish L2 float32 B={b}"] = window_ms(
            lambda: _finish_from_minima(minima, q, rows, rows.shape[0], DistanceMetric.L2, 20),
            20 if b == 1 else 10)
    packed, alpha, csq = quantize4_device(rows)
    for b in (1, 64):
        qc, qs, _ = quantize_query_int8(queries[:b])

        def k2():
            return int4_block_minima(qc, qs, packed, alpha, csq, DistanceMetric.L2, packed.shape[0])

        out[f"K2 L2 int4 B={b}"] = window_ms(k2, 20 if b == 1 else 10)
        for body in int4_block_minima.body_launches:
            out[f"K2 L2 int4 B={b} [{body}]"] = window_ms(
                lambda: _launch_k2(qc, qs, packed, alpha, csq, DistanceMetric.L2, packed.shape[0], None,
                                   body), 20 if b == 1 else 10)
    print(json.dumps(out))


def window_ms(fn, iters: int) -> float:
    """Mean ms per call over one CUDA-event window, after three warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker()
        return 0
    if len(args.checkouts) < 2:
        ap.error("give two or more checkouts")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    me = str(Path(__file__).resolve())
    turns = {c: [] for c in args.checkouts}
    for _ in range(args.rounds):
        for order in (args.checkouts, args.checkouts[::-1]):
            for c in order:
                root = str(Path(c).resolve())
                env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
                res = subprocess.run(
                    [sys.executable, me, "--worker"], cwd=root, env=env,
                    capture_output=True, text=True, timeout=1200,
                )
                if res.returncode != 0:
                    print(res.stdout + res.stderr, file=sys.stderr)
                    return 1
                times = json.loads(res.stdout.strip().splitlines()[-1])
                turns[c].append(times)
                print(f"{c}: {json.dumps(times)}", flush=True)
    medians = {
        c: {k: statistics.median(t[k] for t in ts) for k in ts[0]} for c, ts in turns.items()
    }
    shapes = list(dict.fromkeys(k for c in args.checkouts for k in medians[c]))
    for shape in shapes:
        print(f"{shape}: " + ", ".join(
            f"{c} {medians[c][shape]!r} ms" if shape in medians[c] else f"{c} -" for c in args.checkouts))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "turns": turns, "medians": medians}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
