#!/usr/bin/env python3
"""Where a search's time goes, for the PyTorch port on one CUDA GPU.

Builds the configuration chip_smoke.py drives (N x 384 FLOAT32, L2, rows
from N(0, 1) with --seed, 64 queries of which half are drawn from the
base), and profiles --reps searches each of exact and int8-quantized mode,
then after quantize(qtype="int4", refine=True) of int4-quantized and refine
mode, then of exact mode with 1% of the rows removed (tombstones, masked
inside K1) and with an ids_filter of 10% of the live ids on top, at B=1 and
B=64, k=20, with torch.profiler after a warm-up. For each
it prints one line: device busy time per search (the union of the device's
kernel, copy and memset intervals) against the profiled wall time per
search, the device operations per search, the scan kernel's device time
per search (K1, the block-minima kernel, or K2, the packed-int4 kernel),
and the three next largest device operations.
The profiler inflates wall times; chip_smoke.py reports unprofiled ones.

    python3 tools/profile_torch_search.py [--n 1000000] [--reps 10] [--dim 384] [--exact-only]

--dim sets the row width (384 by default); --exact-only profiles the
exact searches alone (no quantize, tombstones or filter).

Run from the repository root, on a machine with a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

K = 20
B_MAX = 64


def device_ops(prof) -> list:
    """The profile's device-side events (kernels, copies, memsets)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda]


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals: the device's busy
    time, microseconds, over its events' intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


# the scan kernel of each mode: (label, substring of its device name)
K1 = ("K1", "mma_minima_kernel")  # the tensor-core body, which serves these searches
K2 = ("K2", "int4_mma_minima_kernel")  # the tensor-core body, likewise


def profile_search(
    ds, q: np.ndarray, mode: str, kernel: tuple[str, str], reps: int, ids_filter=None
) -> str:
    from torch.profiler import ProfilerActivity, profile

    label, kname = kernel
    for _ in range(3):
        ds.search(q, K, mode=mode, ids_filter=ids_filter)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            # returns host arrays: synchronous
            ds.search(q, K, mode=mode, ids_filter=ids_filter)
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    ops = device_ops(prof)
    if not ops:
        raise RuntimeError("the profiler recorded no device operations")
    busy_ms = busy_us((e.time_range.start, e.time_range.end) for e in ops) / 1e3 / reps
    per_name = collections.Counter()
    for e in ops:
        per_name[e.name] += e.time_range.elapsed_us() / 1e3 / reps
    kernel_ms = sum(t for name, t in per_name.items() if kname in name)
    if kernel_ms == 0:
        raise RuntimeError(f"the profiled searches launched no {kname}")
    rest = [
        f"{name[:60]} {t!r} ms"
        for name, t in per_name.most_common()
        if kname not in name
    ][:3]
    return (
        f"device busy {busy_ms!r} of {wall_ms!r} ms profiled wall "
        f"({100 * busy_ms / wall_ms:.1f}%), {len(ops) / reps:.0f} device ops, "
        f"{label} {kernel_ms!r} ms; next: " + "; ".join(rest)
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="rows in the dataset")
    ap.add_argument("--reps", type=int, default=10, help="profiled searches per line")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dim", type=int, default=384, help="row width")
    ap.add_argument("--exact-only", action="store_true", help="profile exact search alone")
    args = ap.parse_args()
    dim = args.dim
    if not torch.cuda.is_available():
        print("profile_torch_search: no CUDA device", file=sys.stderr)
        return 1
    import sqlite_vector_tpu_torch as svt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(args.seed)
    ds = svt.VectorStore(device="cuda").create("profile", f"dimension={dim},type=FLOAT32,distance=L2")
    chunk = 100_000
    for s in range(0, args.n, chunk):
        ds.add(rng.standard_normal((min(chunk, args.n - s), dim), dtype=np.float32))
    picks = rng.choice(args.n, B_MAX // 2, replace=False)
    q = np.concatenate(
        [ds.get(ds.ids[picks]), rng.standard_normal((B_MAX - B_MAX // 2, dim), dtype=np.float32)]
    )

    def report(label: str, mode: str, kernel: tuple[str, str], ids_filter=None) -> None:
        for b in (1, B_MAX):
            line = profile_search(ds, q[:b], mode, kernel, args.reps, ids_filter)
            print(f"[profile] {label} {args.n}x{dim} k={K} B={b}: {line} | {card}", flush=True)

    if args.exact_only:
        report("exact", "exact", K1)
        return 0
    ds.quantize()
    report("exact", "exact", K1)
    report("int8 quantized", "quantized", K1)
    ds.quantize(qtype="int4", refine=True)
    report("int4 quantized", "quantized", K2)
    report("refine expand=4", "refine", K2)
    ds.remove(rng.choice(ds.ids, args.n // 100, replace=False))  # below the compaction threshold
    report("exact, 1% tombstones", "exact", K1)
    flt = rng.choice(ds.ids, len(ds) // 10, replace=False)
    report("exact, 1% tombstones + 10% ids_filter", "exact", K1, flt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
