"""Fused block-minima scan + exact finish (K1, the rescore kernel and
their plain twins).

Counterpart of sqlite_vector_tpu/ops/pallas_scan.py. Stage 1 makes one
pass over the matrix and keeps only per-128-row distance minima [B, N/128];
the [B, N] distance matrix never exists. Stage 2 selects the k best groups
(exact: if a true top-k row's group were not selected, k groups would each
hold a row smaller than it), rescores their k*128 rows exactly and takes
the final top-k, ties going to the earliest row. The rescore under the
dot-family metrics is a hand-written kernel that reads the selected groups
in place (rescore_groups, with rescore_groups_reference its twin):
csrc/rescore_codes.cu for u8/i8 codes, csrc/rescore_rows.cu for float32,
float16 and bfloat16 rows. L1 rows are gathered and rescored as the twin
does (rescore_gathered). Selection and top-k are torch ops.

Stage 1 has two implementations of one contract:
  - block_minima_reference: plain PyTorch, the definition of the output;
  - the CUDA kernel K1, hand-written for Hopper, in three bodies:
    csrc/block_minima_wgmma.cu (warpgroup MMA fed by TMA: the dot-family
    metrics over float32 (3xTF32), float16 and bfloat16 rows TMA can copy),
    csrc/block_minima_mma.cu (mma.sync: u8/i8 codes with integer MMA, and
    float rows the wgmma body does not take) and csrc/block_minima.cu (CUDA
    cores: L1 for every dtype, and codes past the int32 bound).
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

from sqlite_vector_tpu_torch.ops.distance import NEARLY_ZERO, pairwise_distance
from sqlite_vector_tpu_torch.ops.rerank import (
    candidate_distances,
    chunks,
    finish_tail,
    gathered_distances,
)
from sqlite_vector_tpu_torch.ops.topk import topk_ascending
from sqlite_vector_tpu_torch.types import DistanceMetric
from sqlite_vector_tpu_torch.utils.profiling import annotate

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
# Past that budget the body streams the query tile instead: each 128-byte
# column chunk of the queries rides beside the rows' in the ring, so every
# tile fits at any d.
# Integer codes take the MMA body only while no int32 partial sum can reach
# 2^31 (d * 255^2 and d * 128^2 < 2^31): there its exact int32 sums equal the
# CUDA-core body's uint32-wrap sums. Float rows have no such bound.
_MMA_MAX_DIM = {
    torch.float32: None,
    torch.float16: None,
    torch.bfloat16: None,
    torch.uint8: 33025,
    torch.int8: 131071,
}
# The wgmma body (csrc/block_minima_wgmma.cu) keeps the query tile's planes
# (float32: q_hi and q_lo, tf32_planes; 16-bit: the queries), each row
# padded to a multiple of 128 bytes, resident in shared memory beside its
# two rings of 16 KB stages while they take at most this many bytes (the
# rings then keep 3 stages each); past it the tile is streamed beside the
# rows (wgmma_plan).
_WGMMA_QUERY_BYTES = 98304
_MMA_METRICS = (
    DistanceMetric.L2,
    DistanceMetric.SQUARED_L2,
    DistanceMetric.COSINE,
    DistanceMetric.DOT,
)

# bound on the twin's [B, rows] distance intermediates (elements)
_TWIN_CHUNK_ELEMS = 1 << 26


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


def _resident_tiles(dtype: torch.dtype, d: int) -> list[int]:
    pitch = -(-d * dtype.itemsize // 128) * 128 + 16
    return [t for t in _MMA_QUERY_TILES if t * pitch <= _MMA_QUERY_BYTES]


def mma_streams_queries(dtype: torch.dtype, d: int) -> bool:
    """Whether K1's MMA body streams its query tile beside the rows: when
    not even 8 padded query rows fit the shared budget (d past 3,424 for
    float32, 6,848 for 16-bit floats, 13,696 for codes)."""
    return not _resident_tiles(dtype, d)


def mma_query_tile(dtype: torch.dtype, d: int, b: int) -> int:
    """Queries per block of K1's MMA body: the narrowest of 8, 16, 32 and 64
    that covers b, else the widest (a larger batch takes several tiles),
    among the tiles whose padded query rows fit the shared budget or, where
    not even 8 do, among all four, streamed (mma_streams_queries)."""
    tiles = _resident_tiles(dtype, d) or _MMA_QUERY_TILES
    return next((t for t in tiles if t >= b), tiles[-1])


def _wgmma_resident_tiles(dtype: torch.dtype, d: int) -> list[int]:
    planes = 2 if dtype is torch.float32 else 1
    chunked = -(-d * dtype.itemsize // 128) * 128
    return [t for t in _MMA_QUERY_TILES if t * chunked * planes <= _WGMMA_QUERY_BYTES]


def wgmma_plan(dtype: torch.dtype, d: int, b: int) -> tuple[int, bool]:
    """(query tile, streamed) of K1's wgmma body for b queries: the
    narrowest tile of 8, 16, 32 and 64 that covers min(b, 64) among those
    whose planes fit _WGMMA_QUERY_BYTES, resident; where none does, the
    narrowest that covers it, streamed beside the rows (a larger batch takes
    several tiles)."""
    want = min(b, _MMA_QUERY_TILES[-1])
    for t in _wgmma_resident_tiles(dtype, d):
        if t >= want:
            return t, False
    return next(t for t in _MMA_QUERY_TILES if t >= want), True


def wgmma_pingpong(dtype: torch.dtype, tile: int, streamed: bool) -> bool:
    """Whether the wgmma body's two consumer warpgroups take the tensor
    cores one row tile at a time in turn (ping-pong: one's epilogue beside
    the other's MMAs) rather than each when its data is in: only for
    16-bit rows with a resident tile of 64 queries, where the epilogue
    outweighs the MMAs. Elsewhere free-running read faster on an H100
    (tools/probe_k1_wgmma.py, PERF.md: float32 B=64 at 1M x 384 by 8%, at
    1M x 4,096 by 33%): each consumer waits for a chunk's MMAs before the
    next, and the other fills that gap only when it may issue."""
    return dtype is not torch.float32 and tile == 64 and not streamed


def tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA can copy the rows of a contiguous 2-D tensor: a 16-byte
    aligned start and a row pitch that is a multiple of 16 bytes."""
    return t.data_ptr() % 16 == 0 and t.shape[-1] * t.element_size() % 16 == 0


def k1_body(dtype: torch.dtype, metric: DistanceMetric, d: int, aligned: bool = True) -> str:
    """Which body of K1 serves a scan: for the dot-family metrics, "wgmma"
    (warpgroup MMA fed by TMA) over float32, float16 and bfloat16 rows
    whose pitch TMA takes (d * itemsize a multiple of 16, and `aligned`:
    the queries and rows start 16-byte aligned, tma_ready), "mma"
    (mma.sync) over other float rows at every d and over u8/i8 codes while
    no int32 partial sum can overflow (_MMA_MAX_DIM: d <= 33,025 for u8,
    131,071 for i8); "simt" (CUDA cores) otherwise, L1 always. The batch
    does not route: every body serves every B."""
    if metric not in _MMA_METRICS or dtype not in _MMA_MAX_DIM:
        return "simt"
    bound = _MMA_MAX_DIM[dtype]
    if bound is not None and d > bound:
        return "simt"
    if dtype.is_floating_point and aligned and d * dtype.itemsize % 16 == 0:
        return "wgmma"
    return "mma"


def tf32_planes(q: torch.Tensor) -> torch.Tensor:
    """The wgmma body's float32 query planes, [2, B, d]: q_hi = q rounded
    to TF32 as cvt.rna does (to nearest, ties away from zero; the 13 low
    mantissa bits zero, so the tensor cores read it exactly) and q_lo =
    q - q_hi, exact, so q_hi + q_lo == q for finite q (the tensor cores
    read q_lo truncated to TF32). The rounding is the kernel's to_tf32
    (csrc/k1_common.cuh) on the bits."""
    planes = torch.empty((2, *q.shape), dtype=torch.float32, device=q.device)
    hi = planes[0].view(torch.int32)
    torch.add(q.view(torch.int32), 0x1000, out=hi)
    hi.bitwise_and_(-0x2000)
    torch.sub(q, planes[0], out=planes[1])
    return planes


# the bodies that take a scan k1_body routes to a body (the CUDA-core body
# takes every scan)
_K1_TAKES = {"wgmma": ("wgmma", "mma", "simt"), "mma": ("mma", "simt")}


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
    `block_minima.launches`, by body in `block_minima.body_launches` and,
    where a tensor-core body streams its query tile, in
    `block_minima.streamed_launches`. Its span is `ops.scan` (range
    `svt.ops.scan:<B>`).
    """
    _check(queries, base, valid)
    b = queries.shape[0]
    with annotate("ops.scan", tag=b, B=b):
        dev = base.device
        check_row_mask(row_mask, base.shape[0], dev, "block_minima")
        if dev.type == "cpu":
            return block_minima_reference(queries, base, metric, valid, row_mask)
        aligned = tma_ready(queries) and tma_ready(base)
        return _launch_k1(queries, base, metric, valid, row_mask, k1_body(base.dtype, metric, base.shape[1], aligned))


def _launch_k1(
    queries: torch.Tensor,
    base: torch.Tensor,
    metric: DistanceMetric,
    valid: int,
    row_mask: torch.Tensor | None,
    body: str,
) -> torch.Tensor:
    """K1 in `body` ("wgmma", "mma" or "simt") on checked CUDA tensors.
    block_minima passes k1_body's choice; chip_smoke.py and the card tests
    force the other bodies to hold and time them beside it ("mma" takes
    every scan "wgmma" does, and "simt" every scan). Raises where the body
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
    route = k1_body(base.dtype, metric, d, tma_ready(queries) and tma_ready(base))
    if body not in _K1_TAKES.get(route, ("simt",)):
        raise ValueError(f"block_minima: the {body} body does not take this scan")
    out = torch.empty((b, -(-n // BLOCK)), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    from sqlite_vector_tpu_torch.ops._build import load_library

    lib = load_library()
    tail = [
        None if row_mask is None else row_mask.data_ptr(),
        out.data_ptr(),
        b,
        n,
        d,
        valid,
        _DTYPE_CODE[base.dtype],
        _METRIC_CODE[metric],
    ]
    planes = None
    if body == "wgmma":
        tile, streamed = wgmma_plan(base.dtype, d, b)
        planes = tf32_planes(queries) if base.dtype is torch.float32 else queries
        launch = lib.svt_block_minima_wgmma
        args = [queries.data_ptr(), planes.data_ptr(), base.data_ptr(), *tail, tile, int(streamed),
                int(wgmma_pingpong(base.dtype, tile, streamed))]
    elif body == "mma":
        streamed = mma_streams_queries(base.dtype, d)
        launch = lib.svt_block_minima_mma
        args = [queries.data_ptr(), base.data_ptr(), *tail, mma_query_tile(base.dtype, d, b), int(streamed)]
    else:
        streamed = False
        launch = lib.svt_block_minima
        args = [queries.data_ptr(), base.data_ptr(), *tail]
    with torch.cuda.device(dev):
        rc = launch(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block_minima kernel launch failed: error {rc}")
    block_minima.launches += 1
    block_minima.body_launches[body] += 1
    block_minima.streamed_launches += streamed
    return out


block_minima.launches = 0
block_minima.body_launches = {"wgmma": 0, "mma": 0, "simt": 0}
block_minima.streamed_launches = 0


def select_groups(minima: torch.Tensor, k: int) -> torch.Tensor:
    """The finish's selection over block minima [B, G]: the min(k, G) best
    groups of each query (ties to the earlier group), [B, kg] int64 in
    ascending group order, so that candidates stay in global row order
    for tie parity."""
    kg = min(k, minima.shape[1])
    gidx = torch.sort(minima, dim=-1, stable=True).indices[:, :kg]
    return torch.sort(gidx, dim=-1).values


def group_rows(gidx: torch.Tensor) -> torch.Tensor:
    """The rows of groups gidx [B, kg]: [B, kg*128] int64, column j*128 + r
    holding gidx[., j]*128 + r (unclamped)."""
    lane = torch.arange(BLOCK, device=gidx.device)
    return (gidx[:, :, None] * BLOCK + lane).reshape(gidx.shape[0], -1)


def finish_groups(minima: torch.Tensor, k: int, score) -> tuple[torch.Tensor, torch.Tensor]:
    """The finish over block minima [B, G]: select the k best groups per
    query (select_groups), score their k*128 rows, take the final top-k
    (ties to the earlier row). score(s, e, gidx, pos) returns the
    rank-ready [e - s, kg*128] distances of queries s:e to the rows pos
    (group_rows) of their groups gidx [e - s, kg], +inf at rows the finish
    must not return. Returns (values, positions) [B, k], +inf / -1 past
    the candidates and where score reads +inf.

    The queries go to score in chunks that keep the [queries, kg*128]
    distances within rerank.RESCORE_CHUNK_ELEMS elements whatever B and k
    are (rerank.chunks); a gathering score slices them further
    (rescore_gathered)."""
    b = minima.shape[0]
    kg = min(k, minima.shape[1])
    dev = minima.device
    if kg == 0:
        return (
            torch.full((b, k), torch.inf, device=dev),
            torch.full((b, k), -1, dtype=torch.int64, device=dev),
        )
    gidx = select_groups(minima, k)
    vals, idx = [], []
    for s, e in chunks(b, kg * BLOCK):
        pos = group_rows(gidx[s:e])
        v, cpos = topk_ascending(score(s, e, gidx[s:e], pos), k)  # padded with +inf / -1 past kg*128
        vals.append(v)
        idx.append(torch.where(cpos >= 0, torch.gather(pos, 1, cpos.clamp(min=0)), -1))
    return torch.cat(vals), torch.cat(idx)


def rescore_gathered(pos, n: int, valid: int, dim: int, distances, row_mask=None) -> torch.Tensor:
    """The finish's rescore by gathering, over candidate rows pos [B, C]
    (>= 0) of an [n, dim] matrix: distances(s, e, rows) returns the
    rank-ready distances of queries s:e to rows [e - s, c], in the slices
    rerank.gathered_distances makes; rows >= valid and where row_mask ([n]
    bool, optional) is False read +inf. The rescore kernels' twin is it
    over candidate_distances, the int4 finish over the int4 composition."""
    d = gathered_distances(pos, n, dim, distances)
    keep = pos < valid
    if row_mask is not None:
        keep &= row_mask[pos.clamp(0, n - 1)]
    return torch.where(keep, d, torch.inf)


def _candidates(queries: torch.Tensor, base: torch.Tensor, metric: DistanceMetric):
    """rescore_gathered's distances over base's rows: candidate_distances, rank-ready."""
    return lambda s, e, rows: _rank_ready(candidate_distances(queries[s:e], base[rows], metric), metric)


def rescore_takes(dtype: torch.dtype, metric: DistanceMetric) -> bool:
    """Whether a finish rescores with rescore_groups: u8/i8 codes and
    float32, float16 and bfloat16 rows under the dot-family metrics (L1
    rows and int4 gather)."""
    return dtype in _DTYPE_CODE and metric in _MMA_METRICS


def rescore_width(queries: torch.Tensor, base: torch.Tensor) -> int:
    """The bytes a lane of the rescore kernel loads at once: 16, else 4,
    else the element's size, the widest that divides a row's bytes and
    both tensors' start."""
    elem = base.element_size()
    row = base.shape[1] * elem
    return next(
        w for w in (16, 4, elem)
        if row % w == 0 and queries.data_ptr() % w == 0 and base.data_ptr() % w == 0
    )


def rescore_groups_reference(
    queries: torch.Tensor,
    base: torch.Tensor,
    gidx: torch.Tensor,
    valid: int,
    metric: DistanceMetric,
    row_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain-PyTorch twin of the rescore kernels: rescore_gathered over the
    groups' rows (group_rows) with _candidates, so candidate_distances
    (exact int32-wrapped integer distances of codes in float64 products;
    float rows widened to float32, L2 as the direct sum) made rank-ready,
    dead rows at +inf. The finish's L1 route is the same scorer over the
    positions finish_groups passes."""
    n, dim = base.shape
    return rescore_gathered(group_rows(gidx), n, valid, dim, _candidates(queries, base, metric), row_mask)


def rescore_groups(
    queries: torch.Tensor,
    base: torch.Tensor,
    gidx: torch.Tensor,
    valid: int,
    metric: DistanceMetric,
    row_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rank-ready float32 distances [B, kg*128] of queries [B, d] to the
    rows of their groups gidx [B, kg] (int64 in [0, ceil(N/128)); column
    j*128 + r holds row gidx[b, j]*128 + r) of base [N, d] (u8 or i8
    codes, or float32, float16 or bfloat16 rows; the queries' type), under
    a dot-family metric (L2 squared). Rows >= valid, past N and where
    row_mask ([N] bool, optional) is False read +inf.

    CPU tensors run rescore_groups_reference; CUDA tensors launch the
    rescore kernel (csrc/rescore_codes.cu for codes, csrc/rescore_rows.cu
    for float rows) and count the launch in `rescore_groups.launches`. Its
    span is `ops.rescore` (range `svt.ops.rescore:<B>`)."""
    if queries.dim() != 2 or base.dim() != 2 or gidx.dim() != 2:
        raise ValueError("rescore_groups: queries, base and gidx must be 2-D")
    if queries.dtype != base.dtype or not rescore_takes(base.dtype, metric):
        raise ValueError(
            "rescore_groups: queries and base must share uint8, int8, float32, float16 or "
            f"bfloat16 under L2, SQUARED_L2, COSINE or DOT (got {queries.dtype}, {base.dtype}, {metric})"
        )
    if queries.shape[1] != base.shape[1] or gidx.shape[0] != queries.shape[0]:
        raise ValueError("rescore_groups: queries [B, d], base [N, d] and gidx [B, kg] disagree")
    if gidx.dtype != torch.int64:
        raise ValueError("rescore_groups: gidx must be int64")
    if not (queries.device == base.device == gidx.device):
        raise ValueError("rescore_groups: queries, base and gidx on different devices")
    n = base.shape[0]
    if not (0 <= valid <= n):
        raise ValueError(f"rescore_groups: valid={valid} outside [0, N]")
    check_row_mask(row_mask, n, base.device, "rescore_groups")
    b = queries.shape[0]
    with annotate("ops.rescore", tag=b, B=b):
        if base.device.type == "cpu":
            return rescore_groups_reference(queries, base, gidx, valid, metric, row_mask)
        return _launch_rescore(queries, base, gidx, valid, metric, row_mask)


def _launch_rescore(
    queries: torch.Tensor,
    base: torch.Tensor,
    gidx: torch.Tensor,
    valid: int,
    metric: DistanceMetric,
    row_mask: torch.Tensor | None,
) -> torch.Tensor:
    dev = base.device
    tensors = (queries, base, gidx) if row_mask is None else (queries, base, gidx, row_mask)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rescore_groups: the kernel needs contiguous tensors")
    if dev.type != "cuda":
        raise ValueError(f"rescore_groups: unsupported device {dev}")
    (b, d), n, kg = queries.shape, base.shape[0], gidx.shape[1]
    if n >= 2**31 or b * kg >= 2**31:
        raise ValueError("rescore_groups: N and B * kg must fit int32")
    out = torch.empty((b, kg * BLOCK), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    from sqlite_vector_tpu_torch.ops._build import load_library

    lib = load_library()
    launch = lib.svt_rescore_rows if base.dtype.is_floating_point else lib.svt_rescore_groups
    with torch.cuda.device(dev):
        rc = launch(
            queries.data_ptr(), base.data_ptr(), gidx.data_ptr(),
            None if row_mask is None else row_mask.data_ptr(), out.data_ptr(),
            b, kg, n, d, valid, _DTYPE_CODE[base.dtype], _METRIC_CODE[metric],
            rescore_width(queries, base), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"rescore_groups kernel launch failed: error {rc}")
    rescore_groups.launches += 1
    return out


rescore_groups.launches = 0


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
    exactly (finish_groups: rows under the dot family with rescore_groups,
    L1 rows gathered, as the kernels' twin does), then finish_tail: L2's
    sqrt and the near-zero snap."""
    if rescore_takes(base.dtype, metric):
        def score(s, e, gidx, pos):
            return rescore_groups(queries[s:e], base, gidx, valid, metric, row_mask)
    else:
        n, dim = base.shape

        def score(s, e, gidx, pos):
            return rescore_gathered(pos, n, valid, dim, _candidates(queries[s:e], base, metric), row_mask)

    return finish_tail(*finish_groups(minima, k, score), metric)


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
    False are never returned. The finish's span is `ops.finish`."""
    valid = base.shape[0] if valid_count is None else int(valid_count)
    minima = block_minima(queries, base, metric, valid, row_mask)
    with annotate("ops.finish"):
        return _finish_from_minima(minima, queries, base, valid, metric, k, row_mask)
