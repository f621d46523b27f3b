"""Exact rescoring of per-query candidates (plain PyTorch).

Port of candidate_distances from sqlite_vector_tpu/ops/rerank.py. The
block-scan finish (ops/block_scan.py) rescores its gathered rows with it,
and the refine rescore (ops/refine.py) its dequantized int8 candidates for
the metrics other than L2; the two-stage rerank mode that also uses it is
not ported yet.
"""

from __future__ import annotations

import torch

from sqlite_vector_tpu_torch.ops.distance import (
    compose_float,
    compose_int,
    int_sq_norms,
    is_int,
    wrap_int32,
)
from sqlite_vector_tpu_torch.types import DistanceMetric


def candidate_distances(
    q: torch.Tensor, cand: torch.Tensor, metric: DistanceMetric
) -> torch.Tensor:
    """Exact float32 distances between q [B, d] and per-query candidates
    [B, C, d].

    Integer inputs use exact integer arithmetic with int32 wrap semantics
    (the quantized-domain distances); float L2 applies the residual clamp
    of the scan paths. L2 is returned SQUARED: callers sqrt after their
    final top-k (monotonic). No near-zero snap is applied here.
    """
    sq_metric = (
        DistanceMetric.SQUARED_L2 if metric is DistanceMetric.L2 else metric
    )
    if metric is DistanceMetric.L1:
        acc = torch.int64 if is_int(cand) else torch.float32
        cube = q.to(acc)[:, None, :] - cand.to(acc)
        return cube.abs().sum(-1).float()
    if is_int(cand):
        # float64 products and sums of 8-bit codes are exact (< 2^53)
        b, c, d = cand.shape
        cd = cand.double()
        dot = wrap_int32(torch.bmm(cd, q.double()[:, :, None])[..., 0].long())
        if metric is DistanceMetric.DOT:
            return compose_int(metric, dot, None, None)
        # row norms as [1, d] x [d, 1] products: no squared copy of cd
        c_sq = torch.bmm(cd.view(b * c, 1, d), cd.view(b * c, d, 1)).view(b, c)
        return compose_int(
            sq_metric, dot, int_sq_norms(q)[:, None], wrap_int32(c_sq.long())
        )
    qf = q.float()
    cf = cand.float()
    dot = torch.bmm(cf, qf[:, :, None])[..., 0]  # [B, C]
    q_sq = (qf * qf).sum(-1, keepdim=True)  # [B, 1]
    c_sq = (cf * cf).sum(-1)  # [B, C]
    return compose_float(sq_metric, dot, q_sq, c_sq, snap=False)
