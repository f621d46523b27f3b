"""Recall measurement (the reference's QUANTIZATION.md:43-77 methodology).

Port of sqlite_vector_tpu/tools/recall.py. The reference documents recall
as a SQL recipe joining vector_full_scan against vector_quantize_scan and
counting overlapping rowids; this runs the same comparison on a Dataset:

    from sqlite_vector_tpu_torch.tools.recall import measure_recall
    report = measure_recall(dataset, queries, k=20)

and as a command over synthetic or .npy data, on the card unless --cpu:

    python -m sqlite_vector_tpu_torch.tools.recall --n 100000 --dim 384 --k 20
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any

import numpy as np

from sqlite_vector_tpu_torch.dataset import Dataset


@dataclasses.dataclass
class RecallReport:
    k: int
    n_queries: int
    match_count: int
    total_count: int

    @property
    def recall(self) -> float:
        return self.match_count / self.total_count if self.total_count else 1.0

    def __str__(self) -> str:
        return (
            f"recall@{self.k}: {self.recall:.4f} "
            f"({self.match_count}/{self.total_count} over "
            f"{self.n_queries} queries)"
        )


def measure_recall(dataset: Dataset, queries: np.ndarray, k: int = 20) -> RecallReport:
    """Exact-vs-quantized neighbor overlap, the reference's recall metric:
    |exact ∩ quantized| / |exact|, summed over the queries."""
    queries = np.atleast_2d(np.asarray(queries))
    exact_ids, _ = dataset.search(queries, k)
    approx_ids, _ = dataset.search(queries, k, exact=False)
    match = total = 0
    for e_row, a_row in zip(exact_ids, approx_ids):
        e = set(int(i) for i in e_row if i >= 0)
        a = set(int(i) for i in a_row if i >= 0)
        match += len(e & a)
        total += len(e)
    return RecallReport(k=k, n_queries=len(queries), match_count=match, total_count=total)


def main(argv: list[str] | None = None, *, device: Any = None) -> None:
    from sqlite_vector_tpu_torch import VectorStore
    from sqlite_vector_tpu_torch.types import QuantType

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--dim", type=int, default=384)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--queries", type=int, default=64)
    p.add_argument("--metric", default="L2")
    p.add_argument("--qtype", default="AUTO", choices=["AUTO", "INT8", "UINT8"])
    p.add_argument("--data", help=".npy file with [N, dim] vectors (else synthetic)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    if args.data:
        data = np.load(args.data).astype(np.float32)
        args.n, args.dim = data.shape
    else:
        # clustered synthetic data: more realistic than iid gaussian
        centers = rng.standard_normal((32, args.dim)).astype(np.float32) * 2
        assign = rng.integers(0, 32, args.n)
        data = centers[assign] + rng.standard_normal((args.n, args.dim)).astype(np.float32)

    store = VectorStore(device="cpu" if args.cpu else device)
    ds = store.create("recall", f"dimension={args.dim},type=FLOAT32,distance={args.metric}")
    ds.add(data)
    ds.quantize(qtype=QuantType.AUTO if args.qtype == "AUTO" else QuantType.from_name(args.qtype))
    queries = data[rng.integers(0, args.n, args.queries)]
    print(measure_recall(ds, queries, args.k))
    print(f"quant params: {ds.quant_params}")


if __name__ == "__main__":
    main()
