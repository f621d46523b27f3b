"""Exact rescoring of per-query candidates, and the two-stage rerank mode
(plain PyTorch around K1).

Port of sqlite_vector_tpu/ops/rerank.py. candidate_distances rescores the
block-scan finish's gathered rows (ops/block_scan.py), the refine rescore's
dequantized int8 candidates (ops/refine.py) and rerank's full-precision
candidates. rerank_topk is mode="rerank"'s fused route: stage 1 scans the
int8 codes for the top k*expand candidates (K1 on CUDA tensors), stage 2
gathers those rows of the full-precision matrix and rescores them exactly.
rescore_live_rows is its id-remap route's stage 2, which the Dataset runs
when the codes are stale, a mask is set or the codes are int4.
"""

from __future__ import annotations

from typing import Callable

import torch

from sqlite_vector_tpu_torch.ops.distance import (
    NEARLY_ZERO,
    compose_float,
    compose_int,
    int_sq_norms,
    is_int,
    sqrt_rn,
    wrap_int32,
)
from sqlite_vector_tpu_torch.ops.topk import topk_ascending
from sqlite_vector_tpu_torch.types import DistanceMetric

# bound on a gathered [queries, candidates, d] block (elements)
RESCORE_CHUNK_ELEMS = 1 << 26


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


def _snap(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d.abs() <= NEARLY_ZERO, 0.0, d)


def _chunked(
    b: int, per_query: int, chunk_elems: int, fn: Callable[[int, int], torch.Tensor]
) -> torch.Tensor:
    """fn(s, e) over query chunks whose gathered [e - s, per_query] block
    stays within chunk_elems elements, concatenated."""
    bq = max(1, chunk_elems // max(per_query, 1))
    return torch.cat([fn(s, min(s + bq, b)) for s in range(0, b, bq)])


def rescore_topk(
    cand: torch.Tensor,
    k: int,
    metric: DistanceMetric,
    n_rows: int,
    dim: int,
    distances: Callable[[int, int, torch.Tensor], torch.Tensor],
    chunk_elems: int = RESCORE_CHUNK_ELEMS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 of rerank and refine: rescore candidate positions cand
    [B, C] (-1 padded, C >= k) and take the top-k. distances(s, e, rows)
    returns the raw [e - s, C] distances of queries s:e to rows [e - s, C]
    (clamped into [0, n_rows); L2 squared). Candidates go in ascending row
    order for tie parity with the scan paths (the earliest row wins equal
    distances); near-zero values snap to 0 before ranking, NaN is +inf.
    Returns (distances [B, k] float32, positions [B, k] int64), ascending,
    +inf / -1 padding."""
    cand = torch.sort(cand, dim=-1).values  # -1 padding sorts first, masked below
    safe = cand.clamp(0, n_rows - 1)
    d = _chunked(
        cand.shape[0], cand.shape[1] * dim, chunk_elems,
        lambda s, e: distances(s, e, safe[s:e]),
    )
    d = _snap(d)
    d = torch.where(torch.isnan(d) | (cand < 0), torch.inf, d)
    vals, pos = topk_ascending(d, k)
    idx = torch.gather(cand, 1, pos)
    if metric is DistanceMetric.L2:
        vals = sqrt_rn(vals)
    vals = _snap(vals)
    return vals, torch.where(torch.isposinf(vals), -1, idx)


def rerank_topk(
    queries_f: torch.Tensor,
    base_f: torch.Tensor,
    queries_q: torch.Tensor,
    codes: torch.Tensor,
    metric: DistanceMetric,
    k: int,
    *,
    expand: int = 4,
    valid_count: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage-1 int8 scan (top k*expand, K1) + stage-2 exact rescoring of the
    full-precision rows (top k). base_f and codes are positionally aligned.

    Returns (distances [B, k] float32, exact-metric values; positions
    [B, k] int64) ascending; unfilled slots +inf / -1."""
    from sqlite_vector_tpu_torch.ops.scan import fused_scan_topk

    ke = max(k * expand, k)
    _, cand = fused_scan_topk(queries_q, codes, metric, ke, valid_count=valid_count)
    return rescore_topk(
        cand, k, metric, base_f.shape[0], base_f.shape[1],
        lambda s, e, rows: candidate_distances(queries_f[s:e], base_f[rows], metric),
    )


def direct_distances(
    q: torch.Tensor, rows: torch.Tensor, metric: DistanceMetric
) -> torch.Tensor:
    """float32 distances of q [B, d] to per-query rows [B, C, d] by direct
    sums, the JAX package's host rescore formulas (oracle.distance at
    FLOAT32): sum((q - x)^2), sum|q - x|, -sum(q x), and 1 - q.x / (|q| |x|)
    with a zero norm at 1.0. Sums run in another order than numpy's."""
    qb = q[:, None, :]
    if metric in (DistanceMetric.L2, DistanceMetric.SQUARED_L2):
        diff = qb - rows
        s = (diff * diff).sum(-1)
        return sqrt_rn(s) if metric is DistanceMetric.L2 else s
    if metric is DistanceMetric.L1:
        return (qb - rows).abs().sum(-1)
    dot = (qb * rows).sum(-1)
    if metric is DistanceMetric.DOT:
        return -dot
    nx = (q * q).sum(-1)[:, None]
    ny = (rows * rows).sum(-1)
    out = 1.0 - dot / (sqrt_rn(nx) * sqrt_rn(ny))
    return torch.where((nx == 0) | (ny == 0), 1.0, out)


def rescore_live_rows(
    queries_f: torch.Tensor,
    vecs: torch.Tensor,
    pos: torch.Tensor,
    metric: DistanceMetric,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 of rerank's id-remap route: rescore rows pos [B, C] of the
    live matrix (-1 where a stage-1 candidate has no live row), given in
    stage-1 rank order, with direct_distances in float32, snap near-zero
    values, admit finite distances only and keep the k best in a stable
    order (equal distances keep their stage-1 rank). Returns (distances
    [B, k] float32, positions [B, k] int64), +inf / -1 padding."""
    safe = pos.clamp(0, vecs.shape[0] - 1)
    qf = queries_f.float()
    d = _chunked(
        pos.shape[0], pos.shape[1] * vecs.shape[1], RESCORE_CHUNK_ELEMS,
        lambda s, e: direct_distances(qf[s:e], vecs[safe[s:e]].float(), metric),
    )
    d = _snap(d)
    d = torch.where(torch.isfinite(d) & (pos >= 0), d, torch.inf)
    vals, order = topk_ascending(d, k)
    idx = torch.gather(pos, 1, order.clamp(min=0))
    return vals, torch.where(torch.isposinf(vals), -1, idx)
