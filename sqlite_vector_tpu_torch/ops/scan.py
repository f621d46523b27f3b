"""Exact/quantized top-k scans (plain PyTorch + the block-minima route).

Port of sqlite_vector_tpu/ops/scan.py. Three entry points:
  - scan_topk:       the plain reference formulation, one [B, N] distance
                     matrix and a stable top-k;
  - fused_scan_topk: the router the Dataset calls;
  - scan_distances:  the full distance matrix (Dataset.distances, the
                     *_stream virtual tables' analogue).

Positions are row indices into `base`; the Dataset maps them to int64 row
ids on the host. A row mask ([N] torch.bool, False = excluded: ids_filter,
removed rows) is taken by both top-k scans; on CUDA tensors the router's
masked scan runs inside K1 (ops/block_scan.py), as the unmasked one does.

policy_vtype (a VectorType, or None) routes a scan through the non-finite
policies of ops/nonfinite.py instead, as the JAX package's _tile_distance
does: K1's body implements the plain math, so a policy scan never takes it.
"""

from __future__ import annotations

import torch

from sqlite_vector_tpu_torch.ops.block_scan import block_scan_topk, check_row_mask
from sqlite_vector_tpu_torch.ops.distance import pairwise_distance
from sqlite_vector_tpu_torch.ops.nonfinite import policy_pairwise, policy_tile_rows
from sqlite_vector_tpu_torch.ops.topk import merge_topk, topk_ascending
from sqlite_vector_tpu_torch.types import DistanceMetric, VectorType


def scan_topk(
    queries: torch.Tensor,
    base: torch.Tensor,
    metric: DistanceMetric,
    k: int,
    *,
    valid_count: int | None = None,
    row_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain top-k scan.

    queries: [B, d]; base: [N, d] (rows >= valid_count are padding and are
    masked to +inf, as are rows where row_mask is False). Returns
    (distances [B, k] float32, positions [B, k] int64) sorted ascending;
    unfilled slots hold +inf / -1.
    """
    n = base.shape[0]
    check_row_mask(row_mask, n, base.device, "scan_topk")
    valid = n if valid_count is None else int(valid_count)
    vals, idx = _masked_topk(pairwise_distance(queries, base, metric), 0, valid, row_mask, k)
    return vals, torch.where(torch.isposinf(vals), -1, idx)


def _masked_topk(dist, start: int, valid: int, row_mask, k: int):
    """Top-k of distances [B, rows] of the rows start..start+rows: NaN ->
    +inf (the reference's strict `<` slot loop never selects a NaN), rows
    >= valid and rows where row_mask is False at +inf."""
    dist = torch.where(torch.isnan(dist), torch.inf, dist)
    rows = torch.arange(start, start + dist.shape[1], device=dist.device)
    keep = rows < valid
    if row_mask is not None:
        keep &= row_mask[start : start + dist.shape[1]]
    return topk_ascending(torch.where(keep[None, :], dist, torch.inf), k)


def policy_scan_topk(
    queries: torch.Tensor,
    base: torch.Tensor,
    metric: DistanceMetric,
    k: int,
    policy_vtype: VectorType,
    *,
    valid_count: int | None = None,
    row_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """scan_topk over the policy distances (ops.nonfinite.policy_pairwise),
    one row tile at a time with a running top-k, so no [B, N] matrix
    exists (the JAX scan_topk's tiled branch). Same contract."""
    n = base.shape[0]
    check_row_mask(row_mask, n, base.device, "policy_scan_topk")
    valid = n if valid_count is None else int(valid_count)
    b = queries.shape[0]
    vals = torch.full((b, k), torch.inf, device=base.device)
    idx = torch.full((b, k), -1, dtype=torch.int64, device=base.device)
    step = policy_tile_rows(b, queries.shape[1])
    for s in range(0, min(n, valid), step):
        d = policy_pairwise(queries, base[s : s + step], metric, policy_vtype)
        v, i = _masked_topk(d, s, valid, row_mask, min(k, d.shape[1]))
        vals, idx = merge_topk(vals, idx, v, i + s, k)
    return vals, torch.where(torch.isposinf(vals), -1, idx)


def fused_scan_topk(
    queries: torch.Tensor,
    base: torch.Tensor,
    metric: DistanceMetric,
    k: int,
    *,
    valid_count: int | None = None,
    row_mask: torch.Tensor | None = None,
    policy_vtype: VectorType | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k scan router (the single code path replacing the reference's
    25-kernel dispatch table, src/distance-cpu.c:756-792).

    Routing rule: a scan with a policy_vtype goes to policy_scan_topk;
    every other call, masked or not, to the block-minima scan
    (ops.block_scan.block_scan_topk), which launches the hand-written CUDA
    kernel on CUDA tensors and runs the kernel's plain twin on CPU tensors.
    Same contract as scan_topk.
    """
    if policy_vtype is not None:
        return policy_scan_topk(
            queries, base, metric, k, policy_vtype, valid_count=valid_count, row_mask=row_mask
        )
    return block_scan_topk(
        queries, base, metric, k, valid_count=valid_count, row_mask=row_mask
    )


def scan_distances(
    queries: torch.Tensor,
    base: torch.Tensor,
    metric: DistanceMetric,
    *,
    policy_vtype: VectorType | None = None,
) -> torch.Tensor:
    """Full distance matrix [B, N] float32, raw values (NaN stays NaN).

    The JAX package computes it with XLA outside any Pallas kernel, so its
    port is plain torch ops. For the reference's values over non-finite
    inputs the caller passes policy_vtype (Dataset.distances resolves it
    through needs_raw_policy): the plain decomposition turns f32 L2 rows
    holding Inf into NaN where the reference's direct kernel emits +Inf."""
    if policy_vtype is not None:
        return policy_pairwise(queries, base, metric, policy_vtype)
    return pairwise_distance(queries, base, metric)
