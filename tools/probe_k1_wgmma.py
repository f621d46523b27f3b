#!/usr/bin/env python3
"""Check and time K1's wgmma body (csrc/block_minima_wgmma.cu) on one CUDA
card, forcing each of its plans: the query tile resident or streamed, and
the two consumer warpgroups in ping-pong or free-running.

    python3 tools/probe_k1_wgmma.py [--check] [--time] [--n 1000000]
                                    [--d 384] [--rounds 3] [--b 1 64]
                                    [--dtype float32 float16 bfloat16]

--check: over 20,003 rows (valid 19,926; a NaN row, a zero row, a
self-match) of float32, float16 and bfloat16 at d = 384 and at a streamed
width (f32 4,096, 16-bit 8,192), B in 1, 8, 9, 33, 64, 65 and 200, every
dot-family metric, unmasked and with a random half of the rows masked,
each plan (plans: the resident tile and the streamed one) under both
schedules against the plain twin
(tests/test_torch_kernel_cuda.py:minima_tolerance), then the
non-finite rows and queries of nonfinite_case in each dtype. Prints each
failure and exits 1 if any.

--time: at N x d rows from N(0, 1) (seed 0) of each --dtype, L2 at each
--b (1 and 64 unless given): each
plan of the wgmma body, the mma.sync body and torch.matmul of the same
product, in turns (CUDA events, the median over 2 x rounds passes), beside
chip_smoke.py:k1_bound. Prints the card line first and what ptxas reported
of the body's instances.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
DTYPES = (torch.float32, torch.float16, torch.bfloat16)
DTYPE_NAMES = [str(dt).split(".")[1] for dt in DTYPES]


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plans(dt, d: int, b: int) -> list[tuple[int, bool]]:
    """The resident tile that covers min(b, 64) (or, where none does, the
    widest resident tile, several a call), and the narrowest streamed tile
    that covers it."""
    from sqlite_vector_tpu_torch.ops import block_scan

    want = min(b, 64)
    resident = block_scan._wgmma_resident_tiles(dt, d)
    out = [(next((t for t in resident if t >= want), resident[-1]), False)] if resident else []
    return out + [(next(t for t in (8, 16, 32, 64) if t >= want), True)]


def forced(plan, pingpong):
    """A context that makes the wgmma body take `plan` and `pingpong`."""
    from sqlite_vector_tpu_torch.ops import block_scan

    class _Forced:
        def __enter__(self):
            self.saved = block_scan.wgmma_plan, block_scan.wgmma_pingpong
            block_scan.wgmma_plan = lambda *_: plan
            block_scan.wgmma_pingpong = lambda *_: pingpong

        def __exit__(self, *exc):
            block_scan.wgmma_plan, block_scan.wgmma_pingpong = self.saved

    return _Forced()


def check() -> int:
    from sqlite_vector_tpu_torch.ops.block_scan import _launch_k1, block_minima_reference

    cuda_tests = load("svt_cuda_tests", ROOT / "tests" / "test_torch_kernel_cuda.py")
    failed = 0
    n, valid = 20_003, 20_003 - 77
    mask = cuda_tests.mask_case("half", n, "cuda", seed=1)

    def one(q, base, metric, label, m=None, v=valid):
        nonlocal failed
        got = _launch_k1(q, base, metric, v, m, "wgmma")
        want = block_minima_reference(q, base, metric, v, m)
        torch.cuda.synchronize()
        ok = torch.equal(torch.isposinf(got), torch.isposinf(want)) and torch.equal(
            torch.isneginf(got), torch.isneginf(want)) and not bool(torch.isnan(got).any())
        fin = torch.isfinite(want)
        err = (got.double() - want.double()).abs()[fin]
        tol = cuda_tests.minima_tolerance(q, base, metric, v, want)[fin]
        ok = ok and bool((err <= tol).all())
        if not ok:
            failed += 1
            worst = float((err / tol.clamp(min=1e-30)).max()) if err.numel() else 0.0
            print(f"FAIL {label}: worst err/tol {worst!r}, +inf equal "
                  f"{torch.equal(torch.isposinf(got), torch.isposinf(want))}", flush=True)

    for dt in DTYPES:
        for d in (384, 4096 if dt is torch.float32 else 8192):
            for b in (1, 8, 9, 33, 64, 65, 200):
                q, base = cuda_tests.case(dt, n, d, b, "cuda", seed=d + b)
                for plan in plans(dt, d, b):
                    for pingpong in (True, False):
                        with forced(plan, pingpong):
                            for metric in cuda_tests.DOT_FAMILY:
                                for m in (None, mask):
                                    label = (f"{dt} d={d} B={b} tile={plan[0]} streamed={plan[1]} "
                                             f"pingpong={pingpong} {metric.value} mask={m is not None}")
                                    one(q, base, metric, label, m)
            print(f"[check] {dt} d={d} done, {failed} failures so far", flush=True)
        q, base = cuda_tests.nonfinite_case(7001, "cuda", seed=0, dtype=dt)
        for metric in cuda_tests.DOT_FAMILY:
            one(q, base, metric, f"non-finite {dt} {metric.value}", v=6961)
    print(f"[check] {failed} failures", flush=True)
    return 1 if failed else 0


def time_shapes(n: int, d: int, rounds: int, bs: list[int], dtypes: list[torch.dtype]) -> None:
    from sqlite_vector_tpu_torch.ops.block_scan import _launch_k1, tma_ready
    from sqlite_vector_tpu_torch.types import DistanceMetric

    smoke = load("svt_chip_smoke", ROOT / "chip_smoke.py")
    L2 = DistanceMetric.L2
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = torch.randn((n, d), generator=gen, device="cuda")
    queries = torch.randn((max(bs), d), generator=gen, device="cuda")
    for dt in dtypes:
        base = rows.to(dt)
        for b in bs:
            q = queries[:b].to(dt).contiguous()
            assert tma_ready(q) and tma_ready(base)
            names, fns = [], []
            for plan in plans(dt, d, b):
                for pingpong in (True, False):
                    def run(plan=plan, pingpong=pingpong):
                        with forced(plan, pingpong):
                            _launch_k1(q, base, L2, n, None, "wgmma")
                    names.append(f"wgmma tile={plan[0]}{'s' if plan[1] else 'r'} pp={int(pingpong)}")
                    fns.append(run)
            names += ["mma.sync", "torch.matmul"]
            fns += [lambda: _launch_k1(q, base, L2, n, None, "mma"), lambda: torch.matmul(q, base.T)]
            times = smoke.in_turns(fns, 20 if b == 1 else 10, rounds)
            bound, side = smoke.k1_bound(b, n, d, base.element_size())
            print(f"[time] {dt} {n} x {d} B={b} bound {bound!r} ms ({side}): "
                  + "; ".join(f"{k} {t!r}" for k, t in zip(names, times)), flush=True)
        del base


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=384)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--b", type=int, nargs="+", default=[1, 64])
    ap.add_argument("--dtype", nargs="+", default=DTYPE_NAMES, choices=DTYPE_NAMES)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k1_wgmma: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from sqlite_vector_tpu_torch.ops._build import _report_path, library_path, load_library, ptxas_report

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    load_library()
    for name, said in ptxas_report().items():
        if "wgmma_minima_kernel" in name:
            print(f"ptxas {name}: {said}", flush=True)
    for line in _report_path(library_path()).read_text().splitlines():
        if "block_minima_wgmma" in line or "setmaxnreg" in line or "wgmma" in line.lower() and "arning" in line:
            print(f"ptxas: {line}", flush=True)
    rc = check() if args.check else 0
    if args.time and rc == 0:
        time_shapes(args.n, args.d, args.rounds, args.b, [getattr(torch, t) for t in args.dtype])
    return rc


if __name__ == "__main__":
    sys.exit(main())
