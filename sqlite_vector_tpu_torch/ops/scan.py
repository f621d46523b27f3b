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
"""

from __future__ import annotations

import torch

from sqlite_vector_tpu_torch.ops.block_scan import block_scan_topk, check_row_mask
from sqlite_vector_tpu_torch.ops.distance import pairwise_distance
from sqlite_vector_tpu_torch.ops.topk import topk_ascending
from sqlite_vector_tpu_torch.types import DistanceMetric


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
    dist = pairwise_distance(queries, base, metric)
    # NaN -> +inf: the reference's strict `<` slot loop never selects a NaN
    dist = torch.where(torch.isnan(dist), torch.inf, dist)
    rows = torch.arange(n, device=base.device)
    keep = rows < valid
    if row_mask is not None:
        keep &= row_mask
    dist = torch.where(keep[None, :], dist, torch.inf)
    vals, idx = topk_ascending(dist, k)
    return vals, torch.where(torch.isposinf(vals), -1, idx)


def fused_scan_topk(
    queries: torch.Tensor,
    base: torch.Tensor,
    metric: DistanceMetric,
    k: int,
    *,
    valid_count: int | None = None,
    row_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k scan router (the single code path replacing the reference's
    25-kernel dispatch table, src/distance-cpu.c:756-792).

    Routing rule: every call, masked or not, goes to the block-minima scan
    (ops.block_scan.block_scan_topk), which launches the hand-written CUDA
    kernel on CUDA tensors and runs the kernel's plain twin on CPU tensors.
    Same contract as scan_topk.
    """
    return block_scan_topk(
        queries, base, metric, k, valid_count=valid_count, row_mask=row_mask
    )


def scan_distances(
    queries: torch.Tensor, base: torch.Tensor, metric: DistanceMetric
) -> torch.Tensor:
    """Full distance matrix [B, N] float32, raw values (NaN stays NaN).

    The JAX package computes it with XLA outside any Pallas kernel, so its
    port is plain torch ops. Reference-parity values over non-finite rows
    need the non-finite policy kernels (not ported); Dataset.distances
    refuses those inputs."""
    return pairwise_distance(queries, base, metric)
