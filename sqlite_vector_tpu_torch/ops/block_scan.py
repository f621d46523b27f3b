"""Fused block-minima scan + exact finish (K1 and its plain twin).

Counterpart of sqlite_vector_tpu/ops/pallas_scan.py. Stage 1 makes one
pass over the matrix and keeps only per-128-row distance minima [B, N/128];
the [B, N] distance matrix never exists. Stage 2 (torch ops) selects the k
best groups (exact: if a true top-k row's group were not selected, k groups
would each hold a row smaller than it), gathers their k*128 rows, rescores
them exactly and takes the final top-k, ties going to the earliest row.

Stage 1 has two implementations of one contract:
  - block_minima_reference: plain PyTorch, the definition of the output;
  - the CUDA kernel K1, hand-written for Hopper, in two bodies:
    csrc/block_minima_mma.cu (tensor cores: integer MMA for u8/i8 codes,
    3xTF32 for float32; the dot-family metrics) and csrc/block_minima.cu
    (CUDA cores: L1, float16, bfloat16, and d past the MMA body's bounds).
    k1_body says which body a call takes.
`block_minima` picks by where the tensors live: the twin for CPU tensors,
the kernel for CUDA tensors (it raises rather than fall back).

Row masks (ids_filter, removed rows) ride in stage 1: a masked row reads
+inf in the minima, so a group with no live row reads +inf, and the finish
scores masked rows +inf again inside the groups it selects (a group's
minimum can come from a live row beside masked ones). The selection stays
exact: a live top-k row's group has a finite minimum no larger than the
row, so it is among the k selected unless k groups each hold a live row
that beats it.
"""

from __future__ import annotations

import torch

from sqlite_vector_tpu_torch.ops.distance import (
    NEARLY_ZERO,
    pairwise_distance,
    sqrt_rn,
)
from sqlite_vector_tpu_torch.ops.rerank import candidate_distances
from sqlite_vector_tpu_torch.ops.topk import topk_ascending
from sqlite_vector_tpu_torch.types import DistanceMetric

# rows per minima group
BLOCK = 128

# the kernel's enum codes (Metric, DType in both csrc/block_minima*.cu)
_METRIC_CODE = {
    DistanceMetric.L2: 0,
    DistanceMetric.SQUARED_L2: 1,
    DistanceMetric.COSINE: 2,
    DistanceMetric.DOT: 3,
    DistanceMetric.L1: 4,
}
_DTYPE_CODE = {
    torch.float32: 0,
    torch.float16: 1,
    torch.bfloat16: 2,
    torch.uint8: 3,
    torch.int8: 4,
}

# The MMA body (csrc/block_minima_mma.cu) keeps a tile of 8, 16, 32 or 64
# queries in shared memory, each row padded to a multiple of 128 bytes plus
# 16, beside its 110,592-byte ring of row tiles; the query tile may take this
# many bytes (the kernel takes the tile width from mma_query_tile).
_MMA_QUERY_BYTES = 110592
_MMA_QUERY_TILES = (8, 16, 32, 64)
# Integer codes take the MMA body only while no int32 partial sum can reach
# 2^31 (d * 255^2 and d * 128^2 < 2^31): there its exact int32 sums equal the
# CUDA-core body's uint32-wrap sums.
_MMA_MAX_DIM = {torch.float32: None, torch.uint8: 33025, torch.int8: 131071}
_MMA_METRICS = (
    DistanceMetric.L2,
    DistanceMetric.SQUARED_L2,
    DistanceMetric.COSINE,
    DistanceMetric.DOT,
)

# bound on the twin's [B, rows] distance intermediates (elements)
_TWIN_CHUNK_ELEMS = 1 << 26
# bound on the finish's gathered candidate rows (elements); the rescore's
# widened temporaries are a small multiple of it (ops/rerank.py)
_FINISH_CHUNK_ELEMS = 1 << 26


def _snap_threshold(metric: DistanceMetric) -> float:
    # L2 rides in the SQUARED domain until the finish's sqrt, so it snaps at
    # NEARLY_ZERO^2; snapping squared values at NEARLY_ZERO would zero true
    # distances up to ~9.8e-4
    return NEARLY_ZERO * NEARLY_ZERO if metric is DistanceMetric.L2 else NEARLY_ZERO


def _rank_ready(d: torch.Tensor, metric: DistanceMetric) -> torch.Tensor:
    """Near-zero snap BEFORE ranking (a raw 4e-7 must tie with a true 0.0,
    earliest row winning), then NaN -> +inf (NaN rows are never selected,
    like the reference's strict `<` slot replacement)."""
    d = torch.where(d.abs() <= _snap_threshold(metric), 0.0, d)
    return torch.where(torch.isnan(d), torch.inf, d)


def block_minima_reference(
    queries: torch.Tensor,
    base: torch.Tensor,
    metric: DistanceMetric,
    valid: int,
    row_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain-PyTorch twin of the kernel: float32 [B, ceil(N/128)] minima of
    the rank-ready distances, rows >= valid and rows where row_mask ([N]
    bool) is False at +inf. L2 stays squared."""
    b, n = queries.shape[0], base.shape[0]
    groups = -(-n // BLOCK)
    sq_metric = (
        DistanceMetric.SQUARED_L2 if metric is DistanceMetric.L2 else metric
    )
    dist = torch.full(
        (b, groups * BLOCK), torch.inf, dtype=torch.float32, device=base.device
    )
    rows = max(BLOCK, _TWIN_CHUNK_ELEMS // max(b, 1))
    for s in range(0, valid, rows):
        e = min(s + rows, valid)
        d = pairwise_distance(queries, base[s:e], sq_metric, snap=False)
        dist[:, s:e] = _rank_ready(d, metric)
    if row_mask is not None:
        dist[:, :n] = torch.where(row_mask, dist[:, :n], torch.inf)
    return dist.view(b, groups, BLOCK).amin(-1)


def mma_query_tile(dtype: torch.dtype, d: int, b: int) -> int:
    """Queries per block of K1's MMA body: the narrowest of 8, 16, 32 and 64
    that covers b among the tiles whose padded query rows fit the shared
    budget, else the widest that fits (a larger batch takes several tiles);
    0 when not even 8 rows fit."""
    row_bytes = d * dtype.itemsize
    pitch = -(-row_bytes // 128) * 128 + 16
    fitting = [t for t in _MMA_QUERY_TILES if t * pitch <= _MMA_QUERY_BYTES]
    return next((t for t in fitting if t >= b), fitting[-1] if fitting else 0)


def k1_body(dtype: torch.dtype, metric: DistanceMetric, d: int) -> str:
    """Which body of K1 serves a scan: "mma" (tensor cores) for the
    dot-family metrics over float32 rows and u8/i8 codes while a tile of
    8 padded query rows fits the shared budget and, for codes, no int32
    partial sum can overflow; "simt" (CUDA cores) otherwise. The batch
    does not route: the MMA body serves every B."""
    if metric not in _MMA_METRICS or dtype not in _MMA_MAX_DIM:
        return "simt"
    bound = _MMA_MAX_DIM[dtype]
    if bound is not None and d > bound:
        return "simt"
    return "mma" if mma_query_tile(dtype, d, 1) else "simt"


def check_row_mask(row_mask: torch.Tensor | None, n: int, device: torch.device, who: str) -> None:
    """A row mask is None or an [n] torch.bool tensor on the scan's device."""
    if row_mask is None:
        return
    if row_mask.dtype != torch.bool or row_mask.shape != (n,):
        raise ValueError(f"{who}: row_mask must be a torch.bool tensor of shape ({n},)")
    if row_mask.device != device:
        raise ValueError(f"{who}: row_mask on {row_mask.device}, the scan on {device}")


def _check(queries: torch.Tensor, base: torch.Tensor, valid: int) -> None:
    if queries.dim() != 2 or base.dim() != 2:
        raise ValueError("block_minima: queries and base must be 2-D")
    if queries.shape[1] != base.shape[1]:
        raise ValueError(
            f"block_minima: query dim {queries.shape[1]} != base dim "
            f"{base.shape[1]}"
        )
    if queries.dtype != base.dtype or base.dtype not in _DTYPE_CODE:
        raise ValueError(
            "block_minima: queries and base must share one of float32, "
            f"float16, bfloat16, uint8, int8 (got {queries.dtype}, "
            f"{base.dtype})"
        )
    if queries.device != base.device:
        raise ValueError("block_minima: queries and base on different devices")
    if not (0 <= valid <= base.shape[0]):
        raise ValueError(f"block_minima: valid={valid} outside [0, N]")


def block_minima(
    queries: torch.Tensor,
    base: torch.Tensor,
    metric: DistanceMetric,
    valid: int,
    row_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-128-row distance minima [B, ceil(N/128)] float32; rows where
    row_mask ([N] bool, optional) is False read +inf.

    CPU tensors run block_minima_reference; CUDA tensors launch the K1
    kernel in the body k1_body picks and count the launch in
    `block_minima.launches` and by body in `block_minima.body_launches`.
    """
    _check(queries, base, valid)
    dev = base.device
    check_row_mask(row_mask, base.shape[0], dev, "block_minima")
    if dev.type == "cpu":
        return block_minima_reference(queries, base, metric, valid, row_mask)
    return _launch_k1(queries, base, metric, valid, row_mask, k1_body(base.dtype, metric, base.shape[1]))


def _launch_k1(
    queries: torch.Tensor,
    base: torch.Tensor,
    metric: DistanceMetric,
    valid: int,
    row_mask: torch.Tensor | None,
    body: str,
) -> torch.Tensor:
    """K1 in `body` ("mma" or "simt") on checked CUDA tensors. block_minima
    passes k1_body's choice; chip_smoke.py forces "simt" to hold and time
    the CUDA-core body beside the tensor-core one. Raises where the MMA body
    does not take the scan."""
    dev = base.device
    if dev.type != "cuda":
        raise ValueError(f"block_minima: unsupported device {dev}")
    if not (queries.is_contiguous() and base.is_contiguous()):
        raise ValueError("block_minima: the kernel needs contiguous tensors")
    if row_mask is not None and not row_mask.is_contiguous():
        raise ValueError("block_minima: the kernel needs a contiguous row_mask")
    b, d = queries.shape
    n = base.shape[0]
    if n >= 2**31 or b >= 2**31:
        raise ValueError("block_minima: B and N must fit int32")
    if body == "mma" and k1_body(base.dtype, metric, d) != "mma":
        raise ValueError("block_minima: the MMA body does not take this scan")
    out = torch.empty((b, -(-n // BLOCK)), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    from sqlite_vector_tpu_torch.ops._build import load_library

    lib = load_library()
    args = [
        queries.data_ptr(),
        base.data_ptr(),
        None if row_mask is None else row_mask.data_ptr(),
        out.data_ptr(),
        b,
        n,
        d,
        valid,
        _DTYPE_CODE[base.dtype],
        _METRIC_CODE[metric],
    ]
    if body == "mma":
        launch = lib.svt_block_minima_mma
        args.append(mma_query_tile(base.dtype, d, b))
    else:
        launch = lib.svt_block_minima
    with torch.cuda.device(dev):
        rc = launch(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block_minima kernel launch failed: cudaError {rc}")
    block_minima.launches += 1
    block_minima.body_launches[body] += 1
    return out


block_minima.launches = 0
block_minima.body_launches = {"mma": 0, "simt": 0}


def finish_groups(
    minima: torch.Tensor,
    n: int,
    valid: int,
    k: int,
    dim: int,
    rescore,
    row_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The finish over block minima [B, G]: select the k best groups per
    query (ties to the earlier group), rescore their k*128 rows, take the
    final top-k (ties to the earlier row). rescore(s, e, rows) returns the
    rank-ready [e - s, C] distances of queries s:e to rows [e - s, C]
    (positions clamped into [0, n)). Returns (values, positions) [B, k],
    +inf / -1 past the candidates, at rows >= valid and at rows where
    row_mask ([n] bool, optional) is False.

    The rescore runs in chunks of queries, and each query chunk's
    candidates in slices, so that no gathered [queries, candidates, dim]
    block exceeds _FINISH_CHUNK_ELEMS elements whatever B and k are."""
    b = minima.shape[0]
    kg = min(k, minima.shape[1])
    dev = minima.device
    if kg == 0:
        return (
            torch.full((b, k), torch.inf, device=dev),
            torch.full((b, k), -1, dtype=torch.int64, device=dev),
        )
    # stable: among equal minima the earlier group is taken; then ascending
    # group order so candidates stay in global row order for tie parity
    gidx = torch.sort(minima, dim=-1, stable=True).indices[:, :kg]
    gidx = torch.sort(gidx, dim=-1).values
    n_cand = kg * BLOCK
    # queries per chunk bound the [bq, n_cand] distances and a one-group
    # slice; candidates per slice then fill the rest of the bound
    bq = max(1, min(b, _FINISH_CHUNK_ELEMS // n_cand, _FINISH_CHUNK_ELEMS // (BLOCK * dim)))
    cs = max(1, _FINISH_CHUNK_ELEMS // (bq * dim))
    lane = torch.arange(BLOCK, device=dev)
    vals, idx = [], []
    for s in range(0, b, bq):
        e = min(s + bq, b)
        pos = (gidx[s:e, :, None] * BLOCK + lane).reshape(e - s, n_cand)
        d = torch.cat(
            [rescore(s, e, pos[:, c : c + cs].clamp(0, n - 1)) for c in range(0, n_cand, cs)],
            dim=1,
        )
        keep = (pos < valid) & (pos < n)
        if row_mask is not None:
            keep &= row_mask[pos.clamp(0, n - 1)]
        d = torch.where(keep, d, torch.inf)
        v, cpos = topk_ascending(d, k)  # padded with +inf / -1 past n_cand
        vals.append(v)
        idx.append(torch.where(cpos >= 0, torch.gather(pos, 1, cpos.clamp(min=0)), -1))
    return torch.cat(vals), torch.cat(idx)


def _finish_from_minima(
    minima: torch.Tensor,
    queries: torch.Tensor,
    base: torch.Tensor,
    valid: int,
    metric: DistanceMetric,
    k: int,
    row_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k from block minima: select k groups, rescore k*128 rows
    exactly (finish_groups), then L2's sqrt and the near-zero snap."""
    vals, idx = finish_groups(
        minima, base.shape[0], valid, k, base.shape[1],
        lambda s, e, rows: _rank_ready(
            candidate_distances(queries[s:e], base[rows], metric), metric
        ),
        row_mask,
    )
    if metric is DistanceMetric.L2:
        vals = sqrt_rn(vals)
    vals = torch.where(vals.abs() <= NEARLY_ZERO, 0.0, vals)
    return vals, torch.where(torch.isposinf(vals), -1, idx)


def block_scan_topk(
    queries: torch.Tensor,
    base: torch.Tensor,
    metric: DistanceMetric,
    k: int,
    *,
    valid_count: int | None = None,
    row_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k scan via block minima + exact finish. Same contract as
    ops.scan.scan_topk: (distances [B, k] float32, positions [B, k] int64)
    ascending; unfilled slots +inf / -1; rows where row_mask ([N] bool) is
    False are never returned."""
    valid = base.shape[0] if valid_count is None else int(valid_count)
    minima = block_minima(queries, base, metric, valid, row_mask)
    return _finish_from_minima(minima, queries, base, valid, metric, k, row_mask)
