#!/usr/bin/env python3
"""Time K2's tensor-core body (csrc/int4_minima_mma.cu) with its query tile
resident in shared memory against the same body with the tile streamed
beside the codes, on one CUDA card, over a grid of widths and batches:

    python3 tools/probe_k2_routes.py [--d 2048 4096 8192 12288 16384]
                                     [--b 1 8 16 32 64] [--bytes 2e9] [--rounds 2]

At each d, random packed int4 codes of about --bytes bytes (N = bytes /
ceil(d/2) rows; random alpha and csq: the times do not depend on the
values) are made on the card; for each B the routed call, the resident
tile (the narrowest resident tile that covers B, else the widest: several
tiles over the same codes) and the streamed tile (the narrowest of 8, 16,
32, 64 that covers B) run L2 in turns (CUDA events, the median over 2 x
rounds passes; chip_smoke.py:in_turns), each minima bit-equal to the
plain twin's (ops/int4_scan.py:int4_block_minima_reference). Prints the card line, each time beside k2_bound
(chip_smoke.py), and which of the two ops/int4_scan.py:k2_streams_queries
picks. This is the reading the route rests on.
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
    ap.add_argument("--d", type=int, nargs="+", default=[2048, 4096, 8192, 12288, 16384])
    ap.add_argument("--b", type=int, nargs="+", default=[1, 8, 16, 32, 64])
    ap.add_argument("--bytes", type=float, default=2e9, help="packed code bytes at each d")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k2_routes: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from sqlite_vector_tpu_torch.ops.int4_scan import _launch_k2, int4_block_minima_reference
    from sqlite_vector_tpu_torch.ops.int4_scan import k2_query_tile, k2_streams_queries
    from sqlite_vector_tpu_torch.types import DistanceMetric

    spec = importlib.util.spec_from_file_location("svt_chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    card = smoke.card_line()
    print(card, flush=True)
    L2 = DistanceMetric.L2
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d in args.d:
        h = -(-d // 2)
        n = int(args.bytes) // h
        packed = torch.empty((n, h), dtype=torch.uint8, device="cuda")
        for s in range(0, n, 1 << 16):  # no int32 copy of the whole matrix
            e = min(n, s + (1 << 16))
            packed[s:e] = torch.randint(0, 256, (e - s, h), generator=gen, device="cuda",
                                        dtype=torch.int32).to(torch.uint8)
        alpha = torch.rand(n, generator=gen, device="cuda") + 0.5
        csq = torch.randint(1, 64 * d, (n,), generator=gen, device="cuda", dtype=torch.int32)
        for b in args.b:
            qc = torch.randint(-127, 128, (b, d), generator=gen, device="cuda", dtype=torch.int32)
            args_k2 = (qc.to(torch.int8), torch.rand(b, generator=gen, device="cuda"), packed, alpha,
                       csq, L2, n, None)
            want = int4_block_minima_reference(*args_k2[:-1])
            fns, labels = [], []
            for streamed in (False, True):
                tile = k2_query_tile(d, b, streamed)
                if not tile:
                    continue
                got = _launch_k2(*args_k2, "mma", streamed)
                torch.cuda.synchronize()
                if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                    raise RuntimeError(f"d={d} B={b} streamed={streamed}: minima differ from the twin")
                fns.append(lambda s=streamed: _launch_k2(*args_k2, "mma", s))
                labels.append(f"{'streamed' if streamed else 'resident'} tile {tile} "
                              f"x{-(-b // tile)}")
            ms = smoke.in_turns(fns, 20 if b == 1 else 10, rounds=args.rounds)
            lim, by = smoke.k2_bound(b, n, d)
            print(
                f"K2 {n}x{d} L2 B={b}: " + ", ".join(f"{lab} {m!r} ms" for lab, m in zip(labels, ms))
                + f"; bound {lim!r} ms ({by}); routed: "
                f"{'streamed' if k2_streams_queries(d, b) else 'resident'} | {card}",
                flush=True,
            )
        del packed, alpha, csq
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
