#!/usr/bin/env python3
"""Time K1's tensor-core body (csrc/block_minima_mma.cu) at each query tile
on one CUDA card, calling the library's svt_block_minima_mma directly, at
N x d rows from N(0, 1) (seed 0) of one dtype, L2:

    python3 tools/probe_k1_tiles.py [--n 1000000] [--d 4096] [--dtype float32]
                                    [--b 1 64] [--rounds 3]

For each B, every tile the build has for that width (8, 16, 32, 64; the
query tile resident in shared memory while 8 padded query rows fit
ops/block_scan.py's budget, else streamed) runs in turns with
torch.matmul of the same product (CUDA events, the median over 2 x
rounds passes). Prints the card line, what ptxas reported of the body's
instances, each tile's ms beside k1_bound (chip_smoke.py), which tile
ops/block_scan.py:mma_query_tile routes to, and whether every tile's
minima equal the routed tile's bit for bit (float tiles that sum chunk by
chunk compute each minimum in the same order whatever the tile).
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=4096)
    ap.add_argument("--dtype", default="float32", choices=["float32", "float16", "bfloat16"])
    ap.add_argument("--b", type=int, nargs="+", default=[1, 64])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k1_tiles: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from sqlite_vector_tpu_torch.ops._build import load_library, ptxas_report
    from sqlite_vector_tpu_torch.ops.block_scan import (
        _DTYPE_CODE,
        _METRIC_CODE,
        mma_query_tile,
        mma_streams_queries,
    )
    from sqlite_vector_tpu_torch.types import DistanceMetric

    spec = importlib.util.spec_from_file_location("svt_chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    lib = load_library()
    for name, said in ptxas_report().items():
        if "mma_minima_kernel" in name and "int4" not in name:
            print(f"ptxas {name}: {said}", flush=True)
    dt = getattr(torch, args.dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    base = torch.randn((args.n, args.d), generator=gen, device="cuda").to(dt)
    queries = torch.randn((max(args.b), args.d), generator=gen, device="cuda").to(dt)
    streamed = int(mma_streams_queries(dt, args.d))
    for b in args.b:
        q = queries[:b].contiguous()
        groups = -(-args.n // 128)
        outs = {}

        def launcher(tile, out):
            def run():
                rc = lib.svt_block_minima_mma(
                    q.data_ptr(), base.data_ptr(), None, out.data_ptr(), b, args.n, args.d, args.n,
                    _DTYPE_CODE[dt], _METRIC_CODE[DistanceMetric.L2], tile, streamed,
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"tile {tile}: cudaError {rc}")
            return run

        fns = {}
        for tile in (8, 16, 32, 64):
            out = torch.empty((b, groups), device="cuda")
            try:
                launcher(tile, out)()
            except RuntimeError as e:
                print(f"B={b} tile {tile}: not launched ({e})", flush=True)
                continue
            outs[tile], fns[tile] = out, launcher(tile, out)
        ms = smoke.in_turns([*fns.values(), lambda: torch.matmul(q, base.T)], 10 if b == 1 else 5,
                            rounds=args.rounds)
        torch.cuda.synchronize()
        routed = mma_query_tile(dt, args.d, b)
        same = {t: bool(torch.equal(o, outs[routed])) for t, o in outs.items()} if routed in outs else {}
        lim, by = smoke.k1_bound(b, args.n, args.d, base.element_size())
        print(
            f"{args.n}x{args.d} {args.dtype} L2 B={b} ({'streamed' if streamed else 'resident'} query tile): "
            + ", ".join(f"tile {t} {m!r} ms" for t, m in zip(fns, ms))
            + f"; torch.matmul {ms[-1]!r} ms; bound {lim!r} ms ({by}); routed tile {routed}; "
            f"minima equal to the routed tile's: {same} | {card}",
            flush=True,
        )
        del outs
    return 0


if __name__ == "__main__":
    sys.exit(main())
