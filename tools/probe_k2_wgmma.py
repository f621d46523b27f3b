#!/usr/bin/env python3
"""Check and time K2's wgmma body (csrc/int4_minima_wgmma.cu) on one CUDA
card, forcing each of its plans: the query tile resident or streamed, and
the two consumer warpgroups in ping-pong or free-running.

    python3 tools/probe_k2_wgmma.py [--check] [--time] [--n 1000000]
                                    [--d 384] [--rounds 3] [--wide]

--check: packed int4 codes of tests/test_torch_kernel_cuda.py:int4_case
(a zero row, duplicate rows, rows scaled by 1e25) at d = 64, 383, 384,
768 (5,003 rows, valid 4,990) and 4,096, 8,192, 16,384, 18,432 (1,503
rows, valid 1,490), B in 1, 7, 8, 9, 33, 64, 65 and 130, the four metrics,
unmasked and with a random half of the rows masked: each plan (the
resident tile where one fits, and the streamed one) against the plain twin
(tolerance 0) and against the mma.sync body bit for bit. Prints each
failure and exits 1 if any.

--time: at N x d int4 codes of N(0, 1) rows (seed 0), L2 at B = 1 and 64:
each plan of the wgmma body, the mma.sync body and torch._int_mm of the unpacked codes (B = 64), in turns (CUDA events, the
median over 2 x rounds passes: each call's host work included, where it
outlasts the device's), beside chip_smoke.py:k2_bound; then each one's
device time under torch.profiler: the K2 kernel's own (the sum of its
launches' durations over the calls) and every kernel of the call (the
query planes' layout included). --wide adds d = 4,096 (1M rows), 8,192
(500,000) and 16,384 (250,000). Prints the card line first and what ptxas
reported of the body's instances.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
TILES = (8, 16, 32, 64)


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plans(d: int, b: int) -> list[tuple[int, bool]]:
    """The resident tile the body takes forced resident (where one fits the
    shared budget), and the streamed tile that covers min(b, 64)."""
    from sqlite_vector_tpu_torch.ops.int4_scan import k2_wgmma_plan

    resident = k2_wgmma_plan(d, b, False)
    return ([resident] if resident[0] else []) + [k2_wgmma_plan(d, b, True)]


@contextlib.contextmanager
def forced(plan):
    """The wgmma body takes `plan`."""
    from sqlite_vector_tpu_torch.ops import int4_scan

    saved = int4_scan.k2_wgmma_plan
    int4_scan.k2_wgmma_plan = lambda *_: plan
    try:
        yield
    finally:
        int4_scan.k2_wgmma_plan = saved


def check() -> int:
    from sqlite_vector_tpu_torch.ops.int4_scan import _launch_k2, int4_block_minima_reference

    cuda_tests = load("svt_cuda_tests", ROOT / "tests" / "test_torch_kernel_cuda.py")
    failed = 0
    for d in (64, 383, 384, 768, 4096, 8192, 16384, 18432):
        n = 5003 if d <= 768 else 1503
        valid = n - 13
        mask = cuda_tests.mask_case("half", n, "cuda", seed=d)
        for b in (1, 7, 8, 9, 33, 64, 65, 130):
            tensors, _ = cuda_tests.int4_case(n, d, b, "cuda", seed=d + b)
            for metric in cuda_tests.K2_METRICS:
                for m in (None, mask):
                    want = int4_block_minima_reference(*tensors, metric, valid, m)
                    mma = _launch_k2(*tensors, metric, valid, m, "mma")
                    for plan in plans(d, b):
                        with forced(plan):
                            got = _launch_k2(*tensors, metric, valid, m, "wgmma")
                        torch.cuda.synchronize()
                        fin = torch.isfinite(want)
                        ok = (not bool(torch.isnan(got).any())
                              and torch.equal(torch.isinf(got), torch.isinf(want))
                              and torch.equal(got[fin], want[fin])
                              and torch.equal(got.view(torch.int32), mma.view(torch.int32)))
                        if not ok:
                            failed += 1
                            diff = int((got.view(torch.int32) != mma.view(torch.int32)).sum())
                            err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
                            print(f"FAIL d={d} B={b} tile={plan[0]} streamed={plan[1]} "
                                  f"{metric.value} mask={m is not None}: {diff} words differ from "
                                  f"mma.sync, max |got - twin| {err!r}", flush=True)
        print(f"[check] d={d} done, {failed} failures so far", flush=True)
    print(f"[check] {failed} failures", flush=True)
    return 1 if failed else 0


def device_ms(fn, iters: int) -> tuple[float, float]:
    """(the K2 kernel's device ms a call, every kernel's device ms a call)
    over `iters` calls of fn under torch.profiler, after one warm call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    k2 = total = 0.0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.device_time if hasattr(ev, "device_time") else ev.cuda_time
        total += us
        if "minima_kernel" in ev.name:
            k2 += us
    return k2 / iters / 1e3, total / iters / 1e3


def time_shape(smoke, n: int, d: int, rounds: int) -> None:
    from sqlite_vector_tpu_torch.ops.int4_scan import _launch_k2, k2_wgmma_plan
    from sqlite_vector_tpu_torch.ops.quantize4 import quantize_query_int8, unpack4
    from sqlite_vector_tpu_torch.types import DistanceMetric

    L2 = DistanceMetric.L2
    gen = torch.Generator(device="cuda").manual_seed(0)
    packed, alpha, csq = smoke.random_int4_codes(gen, n, d)
    codes8 = torch.empty((n, d), dtype=torch.int8, device="cuda")
    for s in range(0, n, 50_000):
        codes8[s : s + 50_000] = unpack4(packed[s : s + 50_000], d)
    queries = torch.randn((64, d), generator=gen, device="cuda")
    for b in (1, 64):
        qc, qs, _ = quantize_query_int8(queries[:b])
        args = (qc, qs, packed, alpha, csq)
        names, fns = [], []
        for plan in plans(d, b):
            def run(plan=plan):
                with forced(plan):
                    _launch_k2(*args, L2, n, None, "wgmma")
            routed = " (routed)" if plan == k2_wgmma_plan(d, b) else ""
            names.append(f"wgmma tile={plan[0]}{'s' if plan[1] else 'r'}{routed}")
            fns.append(run)
        names.append("mma.sync")
        fns.append(lambda: _launch_k2(*args, L2, n, None, "mma"))
        lib = smoke.library_call_k2(qc, codes8)
        if lib:
            names.append("torch._int_mm")
            fns.append(lib)
        times = smoke.in_turns(fns, 20 if b == 1 else 10, rounds)
        bound, side = smoke.k2_bound(b, n, d)
        print(f"[time] K2 {n} x {d} B={b} bound {bound!r} ms ({side}), CUDA events: "
              + "; ".join(f"{k} {t!r}" for k, t in zip(names, times)), flush=True)
        dev = [device_ms(fn, 20) for fn in fns]
        print(f"[time] K2 {n} x {d} B={b} device ms (profiler; the kernel / all kernels of a call): "
              + "; ".join(f"{k} {a!r} / {t!r}" for k, (a, t) in zip(names, dev)), flush=True)
    del packed, alpha, csq, codes8
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=384)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k2_wgmma: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from sqlite_vector_tpu_torch.ops._build import _report_path, library_path, load_library, ptxas_report

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    load_library()
    for name, said in ptxas_report().items():
        if "int4_wgmma_minima_kernel" in name:
            print(f"ptxas {name}: {said}", flush=True)
    for line in _report_path(library_path()).read_text().splitlines():
        if "arning" in line or "serializ" in line:
            print(f"ptxas: {line}", flush=True)
    rc = check() if args.check else 0
    if args.time and rc == 0:
        smoke = load("svt_chip_smoke", ROOT / "chip_smoke.py")
        shapes = [(args.n, args.d)]
        if args.wide:
            shapes += [(1_000_000, 4096), (500_000, 8192), (250_000, 16384)]
        for n, d in shapes:
            time_shape(smoke, n, d, args.rounds)
    return rc


if __name__ == "__main__":
    sys.exit(main())
