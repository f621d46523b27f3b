"""Sharded scans over a mesh: per-shard top-k, then one merge.

Port of sqlite_vector_tpu/parallel/ops.py. One process drives every
shard: the per-shard scans are launched on each shard's device back to
back (K1 through ops.scan.fused_scan_topk, K2 through
ops.quantize4.int4_scan_topk on CUDA tensors), with nothing between them
that waits for a device, so the devices run at once; then the merge

    gather:  each shard's [B, k] float32 values and int32 GLOBAL positions
             onto the mesh's first device (the JAX package's all_gather),
    select:  one stable ascending sort of the [B, D * k] candidates.

Candidates are gathered device-major, which is global row order, and the
sort is stable, so the earliest row wins ties exactly as in one scan. A
shard's valid rows are clip(valid - start, 0, shard_rows); a position -1
stays -1, and a +inf value maps to -1.

A 2-D (rows x dim) mesh splits each row shard into column blocks: each
block's partial components (ops.distance.partial_components) are summed on
its row group's first device, composed there (integer partials stay exact,
float L1 is snapped, cached full-dim norms are used), and the row groups'
candidates merge as above. The policies compose the same way
(ops.nonfinite.policy_pairwise_sharded). These are plain torch ops, as the
JAX package computes them with XLA outside any Pallas kernel.

The bytes each call gathers are counted in parallel.audit.GATHERED.
"""

from __future__ import annotations

import torch

from sqlite_vector_tpu_torch.ops.distance import (
    _snap,
    compose_float,
    compose_int,
    is_int,
    partial_components,
    wrap_int32,
)
from sqlite_vector_tpu_torch.ops.nonfinite import policy_pairwise_sharded
from sqlite_vector_tpu_torch.ops.quantize4 import int4_scan_distances, int4_scan_topk
from sqlite_vector_tpu_torch.ops.scan import fused_scan_topk, scan_distances
from sqlite_vector_tpu_torch.ops.topk import topk_ascending
from sqlite_vector_tpu_torch.parallel.audit import GATHERED
from sqlite_vector_tpu_torch.parallel.mesh import DIM_AXIS, ROWS_AXIS, Mesh
from sqlite_vector_tpu_torch.parallel.shards import RowShards, split_rows
from sqlite_vector_tpu_torch.types import DistanceMetric, VectorType


def row_devices(mesh: Mesh, axis: str = ROWS_AXIS) -> list[torch.device]:
    """The device of each row shard: the mesh's devices along `axis`, the
    first of each group along a 2-D mesh's other axis."""
    grid = mesh.devices
    if grid.ndim == 1:
        return list(grid)
    return list(grid[:, 0]) if mesh.axis_names.index(axis) == 0 else list(grid[0, :])


def replicate(x: torch.Tensor, devices) -> dict[torch.device, torch.Tensor]:
    """x on each of `devices` (one copy a device, however many shards it
    holds)."""
    out = {}
    for d in devices:
        if d not in out:
            out[d] = x if x.device == d else x.to(d, non_blocking=True)
    return out


def shard_valid(valid: int, i: int, shard_rows: int) -> int:
    """Shard i's valid rows (sqlite_vector_tpu/parallel/ops.py:85-88)."""
    return min(max(valid - i * shard_rows, 0), shard_rows)


def merge_candidates(
    parts: list[tuple[torch.Tensor, torch.Tensor]], k: int, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """The top-k of the shards' candidates: parts[i] = (values [B, k]
    float32, global positions [B, k] int32) of shard i, in shard order.
    Returns (values [B, k], positions [B, k] int64) on `device`."""
    vals = torch.cat([v.to(device, non_blocking=True) for v, _ in parts], dim=1)
    idx = torch.cat([g.to(device, non_blocking=True) for _, g in parts], dim=1)
    GATHERED.merge += vals.numel() * 4 + idx.numel() * 4
    mvals, pos = topk_ascending(vals, k)
    mids = torch.gather(idx, 1, pos.clamp(min=0)).long()
    return mvals, torch.where(torch.isposinf(mvals) | (pos < 0), -1, mids)


def _global(idx: torch.Tensor, start: int) -> torch.Tensor:
    """Shard positions as int32 global positions; -1 stays -1."""
    return torch.where(idx >= 0, idx + start, -1).to(torch.int32)


def _on_mesh(base, mesh: Mesh, axis: str, who: str, what: str = "base rows") -> RowShards:
    """A RowShards as it is; a tensor split over the mesh's row shards
    (its rows must be a multiple of the shard count, as in the JAX
    package)."""
    if isinstance(base, RowShards):
        return base
    n = base.shape[0]
    d = mesh.shape[axis]
    if n % d != 0:
        raise ValueError(
            f"{who}: {what} ({n}) must be a multiple of the mesh size ({d}); pad before sharding"
        )
    return RowShards.from_tensor(base, [[dev] for dev in row_devices(mesh, axis)])


def _row_parts(x, shard_rows: int, devices) -> list:
    """A per-row array (mask, alpha, csq, norms) as shards: a RowShards'
    parts, or a tensor split; None stays None."""
    if x is None:
        return [None] * len(devices)
    if isinstance(x, RowShards):
        return x.parts()
    return split_rows(x, shard_rows, devices, fill=False if x.dtype == torch.bool else 0)


def sharded_scan_topk(
    queries: torch.Tensor,
    base,
    metric: DistanceMetric,
    k: int,
    mesh: Mesh,
    *,
    valid_count: int | None = None,
    row_mask=None,
    axis: str = ROWS_AXIS,
    policy_vtype: VectorType | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a row-sharded base (a RowShards, or a [N, d] tensor with
    N a multiple of the mesh size): every shard through
    ops.scan.fused_scan_topk, then merge_candidates. row_mask: [N] bool
    (a tensor, cut or padded with False, or a RowShards). Returns (distances
    [B, k], global positions [B, k] int64) on the first shard's device,
    ascending, +inf / -1 past the candidates."""
    base = _on_mesh(base, mesh, axis, "sharded_scan_topk")
    devices = [b[0].device for b in base.blocks]
    sr = base.shard_rows
    valid = base.shape[0] if valid_count is None else int(valid_count)
    masks = _row_parts(row_mask, sr, devices)
    qs = replicate(queries, devices)
    parts = []
    for i, b in enumerate(base.parts()):
        vals, idx = fused_scan_topk(
            qs[b.device], b, metric, k, valid_count=shard_valid(valid, i, sr),
            row_mask=masks[i], policy_vtype=policy_vtype,
        )
        parts.append((vals, _global(idx, i * sr)))
    return merge_candidates(parts, k, devices[0])


def sharded_int4_scan_topk(
    queries: torch.Tensor,
    packed,
    alpha,
    csq,
    metric: DistanceMetric,
    k: int,
    mesh: Mesh,
    *,
    dim: int,
    valid_count: int | None = None,
    row_mask=None,
    axis: str = ROWS_AXIS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The int4 top-k (ops.quantize4.int4_scan_topk: K2 on CUDA) over
    row-sharded packed codes [N, ceil(dim/2)] with their per-row alpha and
    csq, then the same merge: the packed codes never leave their shard."""
    packed = _on_mesh(packed, mesh, axis, "sharded_int4_scan_topk", "code rows")
    devices = [b[0].device for b in packed.blocks]
    sr = packed.shard_rows
    valid = packed.shape[0] if valid_count is None else int(valid_count)
    alphas, csqs = _row_parts(alpha, sr, devices), _row_parts(csq, sr, devices)
    masks = _row_parts(row_mask, sr, devices)
    qs = replicate(queries.float(), devices)
    parts = []
    for i, pk in enumerate(packed.parts()):
        vals, idx = int4_scan_topk(
            qs[pk.device], pk, alphas[i], csqs[i], metric, k, dim=dim,
            valid_count=shard_valid(valid, i, sr), row_mask=masks[i],
        )
        parts.append((vals, _global(idx, i * sr)))
    return merge_candidates(parts, k, devices[0])


def sharded_scan_distances(
    queries: torch.Tensor,
    base,
    metric: DistanceMetric,
    mesh: Mesh,
    *,
    axis: str = ROWS_AXIS,
    policy_vtype: VectorType | None = None,
) -> list[torch.Tensor]:
    """The full distance matrix, column-sharded: one [B, shard_rows]
    float32 tensor a shard, on its device (ops.scan.scan_distances); the
    caller joins them (join_columns)."""
    base = _on_mesh(base, mesh, axis, "sharded_scan_distances")
    qs = replicate(queries, [b[0].device for b in base.blocks])
    return [scan_distances(qs[b.device], b, metric, policy_vtype=policy_vtype) for b in base.parts()]


def sharded_int4_scan_distances(
    queries: torch.Tensor, packed: RowShards, alpha: RowShards, csq: RowShards,
    metric: DistanceMetric, *, dim: int,
) -> list[torch.Tensor]:
    """The full int4 distance matrix, column-sharded like
    sharded_scan_distances (ops.quantize4.int4_scan_distances a shard)."""
    qs = replicate(queries.float(), [b[0].device for b in packed.blocks])
    return [
        int4_scan_distances(qs[pk.device], pk, al, cs, metric, dim=dim)
        for pk, al, cs in zip(packed.parts(), alpha.parts(), csq.parts())
    ]


def join_columns(parts: list[torch.Tensor], n: int | None = None) -> torch.Tensor:
    """Column shards [B, rows_i] joined on the CPU, cut to n columns."""
    out = torch.cat([p.cpu() for p in parts], dim=1)
    return out if n is None else out[:, :n]


# ---------------------------------------------------------------------------
# 2-D mesh: rows x dim
# ---------------------------------------------------------------------------


def _check_2d(base, mesh: Mesh, rows_axis: str, dim_axis: str, who: str) -> RowShards:
    r, c = mesh.shape[rows_axis], mesh.shape[dim_axis]
    if isinstance(base, RowShards):
        return base
    n, dim = base.shape
    if n % r != 0 or dim % c != 0:
        raise ValueError(
            f"{who}: base [{n}, {dim}] must divide evenly by the mesh ({r} x {c}); pad before sharding"
        )
    grid = mesh.devices if mesh.axis_names.index(rows_axis) == 0 else mesh.devices.T
    return RowShards.from_tensor(base, [list(row) for row in grid])


def _query_blocks(queries: torch.Tensor, shard: list[torch.Tensor]) -> list[torch.Tensor]:
    """Queries zero-padded to a row shard's columns and cut into its
    column blocks, each on its block's device."""
    cols = sum(int(b.shape[1]) for b in shard)
    if queries.shape[1] < cols:
        queries = torch.cat([queries, queries.new_zeros((queries.shape[0], cols - queries.shape[1]))], dim=1)
    out, at = [], 0
    for b in shard:
        w = int(b.shape[1])
        out.append(queries[:, at : at + w].to(b.device, non_blocking=True))
        at += w
    return out


def full_dim_sq_norms(base: RowShards) -> RowShards:
    """Full-dim row squared norms of a 2-D mesh's matrix, one [shard_rows]
    tensor a row group on its first device: the sums of the column
    blocks' partial norms in block order (what a scan without the cache
    computes), int32-wrapped for integer rows."""
    out = []
    for shard in base.blocks:
        dev = shard[0].device
        total = None
        for b in shard:
            if is_int(b):
                part = (b.long() * b.long()).sum(-1)
            else:
                part = (b.float() * b.float()).sum(-1)
            part = part.to(dev)
            total = part if total is None else total + part
        out.append([wrap_int32(total) if is_int(shard[0]) else total])
    return RowShards(out)


def _group_distances(
    qb: list[torch.Tensor],
    shard: list[torch.Tensor],
    rows: int,
    metric: DistanceMetric,
    b_sq: torch.Tensor | None,
    policy_vtype: VectorType | None,
) -> torch.Tensor:
    """[B, rows] distances of one row group (its first `rows` rows) on its
    first device: the blocks' partial components summed, then composed
    (sqlite_vector_tpu/parallel/ops.py:_compose_2d)."""
    dev = shard[0].device
    blocks = [b[:rows] for b in shard]
    if policy_vtype is not None:
        return policy_pairwise_sharded(qb, blocks, metric, policy_vtype, dev)
    main = q_sq = pb_sq = None
    for q, b in zip(qb, blocks):
        m, qs, bs = partial_components(q, b, metric, with_b_sq=b_sq is None)
        m = m.to(dev, non_blocking=True)
        main = m if main is None else main + m
        if qs is not None:
            qs = qs.to(dev, non_blocking=True)
            q_sq = qs if q_sq is None else q_sq + qs
        if bs is not None:
            bs = bs.to(dev, non_blocking=True)
            pb_sq = bs if pb_sq is None else pb_sq + bs
    if b_sq is None:
        b_sq = pb_sq
    else:
        b_sq = b_sq[:rows]
    if metric is DistanceMetric.L1:
        return main.float() if is_int(shard[0]) else _snap(main)
    if is_int(shard[0]):
        main = wrap_int32(main)
        if q_sq is None:
            return compose_int(metric, main, None, None)
        return compose_int(metric, main, wrap_int32(q_sq)[:, None], wrap_int32(b_sq.long())[None, :])
    if q_sq is None:
        return compose_float(metric, main, None, None)
    return compose_float(metric, main, q_sq[:, None], b_sq.float()[None, :])


def sharded_scan_topk_2d(
    queries: torch.Tensor,
    base,
    metric: DistanceMetric,
    k: int,
    mesh: Mesh,
    *,
    valid_count: int | None = None,
    row_mask=None,
    base_sq_norms=None,
    rows_axis: str = ROWS_AXIS,
    dim_axis: str = DIM_AXIS,
    policy_vtype: VectorType | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k on a 2-D (rows x dim) mesh: base is a RowShards of R x C
    blocks (or a [N, dpad] tensor dividing evenly by the mesh); queries
    [B, d] whole (zero-padded and cut per block here). Each row group
    scores its valid rows only; base_sq_norms (full_dim_sq_norms) spares
    the per-scan base-norm pass. Returns (distances [B, k], positions
    [B, k] int64) on the first row group's device."""
    base = _check_2d(base, mesh, rows_axis, dim_axis, "sharded_scan_topk_2d")
    sr = base.shard_rows
    valid = base.shape[0] if valid_count is None else int(valid_count)
    devices = [shard[0].device for shard in base.blocks]
    masks = _row_parts(row_mask, sr, devices)
    norms = _row_parts(base_sq_norms, sr, devices)
    parts = []
    for i, shard in enumerate(base.blocks):
        lv = shard_valid(valid, i, sr)
        dist = _group_distances(_query_blocks(queries, shard), shard, lv, metric, norms[i], policy_vtype)
        dist = torch.where(torch.isnan(dist), torch.inf, dist)
        if masks[i] is not None:
            dist = torch.where(masks[i][:lv][None, :], dist, torch.inf)
        vals, idx = topk_ascending(dist, k)  # pads to k with +inf / -1
        parts.append((vals, torch.where(torch.isposinf(vals), -1, idx + i * sr).to(torch.int32)))
    GATHERED.dim_sum += 4 * queries.shape[0] * -(-valid // base.n_shards)
    return merge_candidates(parts, k, devices[0])


def sharded_scan_distances_2d(
    queries: torch.Tensor,
    base,
    metric: DistanceMetric,
    mesh: Mesh,
    *,
    base_sq_norms=None,
    rows_axis: str = ROWS_AXIS,
    dim_axis: str = DIM_AXIS,
    policy_vtype: VectorType | None = None,
) -> list[torch.Tensor]:
    """The full distance matrix on a 2-D mesh, column-sharded over the row
    groups ([B, shard_rows] each on its group's first device); raw values
    (NaN stays NaN), the policies under policy_vtype."""
    base = _check_2d(base, mesh, rows_axis, dim_axis, "sharded_scan_distances_2d")
    norms = _row_parts(base_sq_norms, base.shard_rows, [s[0].device for s in base.blocks])
    return [
        _group_distances(_query_blocks(queries, shard), shard, base.shard_rows, metric, norms[i], policy_vtype)
        for i, shard in enumerate(base.blocks)
    ]
