#!/usr/bin/env python3
"""Probe the loop shape of the float rescore kernel (csrc/rescore_rows.cu)
on one CUDA card: each (rows a step, words a pass) builds its own copy of
the source, the two constants replaced, into a library of its own, and
runs at N x d float32 rows from N(0, 1) (seed 0), k = 100, COSINE, B
queries (half copies of base rows) over the groups K1's minima select.

    python3 tools/probe_rescore_rows.py [--n 5000000] [--d 1536] [--b 32]
                                        [--shapes 4x2 8x1 2x4 8x2 4x4 2x2]
                                        [--rounds 3]

Every shape sums each lane's words in the same order, so every shape's
output must equal the package's build bit for bit. Prints the card line,
what ptxas reported of each shape's instances, then each shape's ms (CUDA
events in turns, the median over 2 x rounds passes) beside
chip_smoke.py:rescore_rows_bound. Exits 1 if a shape differs.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from sqlite_vector_tpu_torch.ops import _build  # noqa: E402
from sqlite_vector_tpu_torch.ops import block_scan as bs  # noqa: E402
from sqlite_vector_tpu_torch.types import DistanceMetric  # noqa: E402


def load_smoke():
    spec = importlib.util.spec_from_file_location("svt_chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_shapes(shapes: list[tuple[int, int]]) -> dict[tuple[int, int], ctypes.CDLL]:
    """One library a shape, from rescore_rows.cu with kRowsPerStep and
    kWordsPerPass replaced, built in parallel beside the package's build."""
    src = (_build.CSRC / "rescore_rows.cu").read_text()
    out_dir = _build.library_path().parent / "probe_rescore_rows"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    for r, v in shapes:
        text = re.sub(r"kRowsPerStep = \d+;", f"kRowsPerStep = {r};", src)
        text = re.sub(r"kWordsPerPass = \d+;", f"kWordsPerPass = {v};", text)
        cu = out_dir / f"rescore_rows_{r}x{v}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        libs[(r, v)] = so
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared", "-o", str(so), str(cu)])
    reports = _build._nvcc_all(cmds)
    loaded = {}
    for (shape, so), report in zip(libs.items(), reports):
        for line in report.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[ptxas] {shape[0]}x{shape[1]}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.svt_rescore_rows.argtypes = list(_build._SIGNATURES["svt_rescore_rows"])
        lib.svt_rescore_rows.restype = ctypes.c_int
        loaded[shape] = lib
    return loaded


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=5_000_000)
    ap.add_argument("--d", type=int, default=1536)
    ap.add_argument("--b", type=int, default=32)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--shapes", nargs="+", default=["4x2", "8x1", "2x4", "8x2", "4x4", "2x2"])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_rescore_rows: no CUDA device", file=sys.stderr)
        return 1
    smoke = load_smoke()
    card = smoke.card_line()
    print(f"[card] {card}", flush=True)
    shapes = [tuple(int(x) for x in s.split("x")) for s in args.shapes]
    libs = build_shapes(shapes)

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, d, b, k = args.n, args.d, args.b, args.k
    rows = torch.empty((n, d), dtype=torch.float32, device="cuda")
    for s in range(0, n, 500_000):
        rows[s : s + 500_000] = torch.randn((min(500_000, n - s), d), generator=gen, device="cuda")
    q = torch.randn((b, d), generator=gen, device="cuda")
    q[: b // 2] = rows[torch.randint(0, n, (b // 2,), generator=gen, device="cuda")]
    cos = DistanceMetric.COSINE
    gidx = bs.select_groups(bs.block_minima(q, rows, cos, n), k)
    kg = gidx.shape[1]
    want = bs.rescore_groups(q, rows, gidx, n, cos)
    width = bs.rescore_width(q, rows)
    stream = torch.cuda.current_stream().cuda_stream

    def run(lib):
        out = torch.empty((b, kg * bs.BLOCK), dtype=torch.float32, device="cuda")

        def call():
            rc = lib.svt_rescore_rows(q.data_ptr(), rows.data_ptr(), gidx.data_ptr(), None, out.data_ptr(),
                                      b, kg, n, d, n, bs._DTYPE_CODE[rows.dtype], bs._METRIC_CODE[cos],
                                      width, stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: error {rc}")
            return out

        return call

    calls = {shape: run(lib) for shape, lib in libs.items()}
    bad = 0
    for shape, call in calls.items():
        if not torch.equal(call(), want):
            print(f"[check] {shape[0]}x{shape[1]}: differs from the package's build", flush=True)
            bad += 1
    names = list(calls)
    ms = smoke.in_turns([calls[s] for s in names] + [lambda: bs.rescore_groups(q, rows, gidx, n, cos)],
                        10, args.rounds)
    lim, by = smoke.rescore_rows_bound(b, kg, d, rows.element_size())
    for shape, t in zip(names + ["package"], ms):
        label = shape if isinstance(shape, str) else f"{shape[0]} rows x {shape[1]} words"
        print(f"[time] rescore_rows {n}x{d} f32 B={b} k={k} COSINE width {width}: {label} {t!r} ms, "
              f"bound {lim!r} ms ({by}), {100 * lim / t:.1f}% of bound | {card}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
