"""Packed-int4 block-minima scan + exact finish (K2 and its plain twin).

Counterpart of sqlite_vector_tpu/ops/pallas_int4.py, shaped like
ops/block_scan.py. Stage 1 makes one pass over the packed codes and keeps,
per query and per 128-row group, the minimum of a MONOTONE SURROGATE of the
int4 distance (per-query constants dropped, which preserves each query's
ranking of rows):

  L2, SQUARED_L2   alpha^2 * csq - 2 * qscale * alpha * dot
  DOT              -(qscale * alpha) * dot
  COSINE           -dot / sqrt(csq)   (0 for a zero row)

where dot is the exact integer dot of the int8 query codes with the row's
int4 codes. Rows >= valid, rows a row mask excludes and NaN surrogates
(inf - inf when alpha^2 * csq overflows) are +inf. Stage 2 (torch ops) selects the k best groups, gathers
their k*128 packed rows, rescores them with the exact int4 composition
(ops.quantize4.int4_distances) and takes the final top-k, through K1's
finish (ops.block_scan.finish_groups and rescore_gathered).

Stage 1 has two implementations of one contract (csrc/k2_common.cuh's
header states it):
  - int4_block_minima_reference: plain PyTorch, the definition of the output;
  - the CUDA kernel K2, hand-written for Hopper, in two bodies that agree
    bit for bit: csrc/int4_minima_wgmma.cu (warpgroup MMA fed by TMA, a
    producer warp and two consumer warpgroups, wherever TMA takes the
    packed rows: ceil(d/2) a multiple of 16 bytes and a 16-byte aligned
    start; its plan from k2_wgmma_plan) and csrc/int4_minima_mma.cu
    (mma.sync over the nibble planes, every d < 2^21; the rows TMA cannot
    copy; its query tile resident in shared memory or streamed beside the
    codes, as k2_streams_queries says). k2_body says which body a call
    takes; the mma.sync body runs where the route takes wgmma only where a
    caller forces it as the cross-check (_launch_k2).
`int4_block_minima` picks by where the tensors live: the twin for CPU
tensors, the kernel for CUDA tensors (it raises rather than fall back).
L1 has no surrogate of this form and is rejected (it runs the plain tile
loop, ops.quantize4.int4_scan_topk_plain).
"""

from __future__ import annotations

import torch

from sqlite_vector_tpu_torch.ops.block_scan import (
    BLOCK,
    _METRIC_CODE,
    check_row_mask,
    finish_groups,
    rescore_gathered,
    tma_ready,
)
from sqlite_vector_tpu_torch.ops.distance import sqrt_rn
from sqlite_vector_tpu_torch.ops.quantize4 import (
    dot_dtype,
    int4_distances,
    packed_width,
    quantize_query_int8,
    sanitize_queries,
    unpack4,
)
from sqlite_vector_tpu_torch.ops.rerank import finish_tail
from sqlite_vector_tpu_torch.types import DistanceMetric
from sqlite_vector_tpu_torch.utils.profiling import annotate

# bound on the twin's unpacked [rows, d] codes and [B, rows] dots (elements)
_TWIN_CHUNK_ELEMS = 1 << 25

# The tensor-core body (csrc/int4_minima_mma.cu) can keep a tile of 8, 16,
# 32 or 64 queries in shared memory beside its 81,920-byte ring of packed
# row tiles: per query both code planes, each padded to a multiple of 128
# codes (64 packed bytes), so 128 bytes per 64 packed bytes of a row. A
# resident query tile may take this many bytes (the kernel takes the tile
# from k2_query_tile); it admits d <= 2,048 / 4,096 / 8,192 / 16,384 for
# tiles of 64 / 32 / 16 / 8 queries. Or it streams the tile
# (k2_streams_queries): each ring stage carries the tile's planes of the
# stage's columns beside the codes (k2_query_planes), so every tile fits at
# any d.
_K2_QUERY_BYTES = 131072
_K2_QUERY_TILES = (8, 16, 32, 64)
# The route keeps a tile resident only while its planes take at most this
# many bytes: past it the streamed tile was faster at every width and batch
# measured, up to it the resident one (2 GB of codes, d = 2,048-16,384, B =
# 1-64: tools/probe_k2_routes.py on an NVIDIA H100 80GB HBM3 at 700 W,
# PERF.md section 6): the resident tile's planes leave the ring its
# narrowest row chunks, and several tiles re-run the MMAs' A side.
_K2_RESIDENT_BYTES = 65536
# The wgmma body (csrc/int4_minima_wgmma.cu) keeps the query tile's two
# planes, each query's padded to a multiple of 128 codes (128 bytes a
# plane and TMA box), resident in shared memory beside its two rings of
# 16 KB stages while they take at most this many bytes; past it the tile is
# streamed beside the rows (k2_wgmma_plan). Forced resident, a tile may
# take up to _K2_QUERY_BYTES (the rings then keep 2-3 stages a consumer).
_K2_WGMMA_RESIDENT_BYTES = 98304


def _surrogate(
    dotf: torch.Tensor,
    qscale: torch.Tensor,
    alpha: torch.Tensor,
    csq: torch.Tensor,
    metric: DistanceMetric,
) -> torch.Tensor:
    """The JAX package's _surrogate_block, op for op: dotf [B, T] float32
    exact integer dots, qscale [B], alpha and csq [T]."""
    qs = qscale[:, None]
    a = alpha[None, :]
    csqf = csq.float()[None, :]
    if metric is DistanceMetric.DOT:
        return -(qs * a) * dotf
    if metric is DistanceMetric.COSINE:
        # csq >= 1 when nonzero (integer codes): the clamp only shields the
        # masked zero rows. 1 / sqrt, each correctly rounded (the kernel
        # computes the same, not an approximate rsqrt)
        root = sqrt_rn(torch.clamp(csqf, min=1.0))
        inv = torch.where(csqf > 0.0, torch.ones_like(root) / root, 0.0)
        return torch.where(csqf > 0.0, -dotf * inv, 0.0)
    return a * a * csqf - 2.0 * (qs * a) * dotf


def int4_block_minima_reference(
    qc: torch.Tensor,
    qscale: torch.Tensor,
    packed: torch.Tensor,
    alpha: torch.Tensor,
    csq: torch.Tensor,
    metric: DistanceMetric,
    valid: int,
    row_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain-PyTorch twin of K2: float32 [B, ceil(N/128)] per-group minima
    of the surrogate; rows >= valid, rows where row_mask ([N] bool) is False
    and NaN surrogates are +inf."""
    b, dim = qc.shape
    n = packed.shape[0]
    groups = -(-n // BLOCK)
    acc = dot_dtype(dim)
    s_all = torch.full(
        (b, groups * BLOCK), torch.inf, dtype=torch.float32, device=packed.device
    )
    qcf = qc.to(acc)
    rows = max(BLOCK, _TWIN_CHUNK_ELEMS // max(b, dim, 1))
    for s in range(0, valid, rows):
        e = min(s + rows, valid)
        dot = qcf @ unpack4(packed[s:e], dim).to(acc).T
        sv = _surrogate(dot.float(), qscale, alpha[s:e], csq[s:e], metric)
        s_all[:, s:e] = torch.where(torch.isnan(sv), torch.inf, sv)
    if row_mask is not None:
        s_all[:, :n] = torch.where(row_mask, s_all[:, :n], torch.inf)
    return s_all.view(b, groups, BLOCK).amin(-1)


def _plane_bytes(d: int) -> int:
    """Shared bytes of one query's two code planes in a resident tile."""
    return 128 * -(-packed_width(d) // 64)


def _resident_tiles(d: int) -> list[int]:
    return [t for t in _K2_QUERY_TILES if t * _plane_bytes(d) <= _K2_QUERY_BYTES]


def k2_streams_queries(d: int, b: int) -> bool:
    """Whether K2's tensor-core body streams its query tile beside the
    codes: where the tile the batch takes (the narrowest of 8, 16, 32 and
    64 that covers b, else 64) would hold more than _K2_RESIDENT_BYTES of
    planes resident: every B past d = 8,192 (16,384 for the shared budget
    alone), B > 8 past 4,096, B > 16 past 2,048, B > 32 past 1,024."""
    tile = next((t for t in _K2_QUERY_TILES if t >= b), _K2_QUERY_TILES[-1])
    return tile * _plane_bytes(d) > _K2_RESIDENT_BYTES


def k2_query_tile(d: int, b: int, streamed: bool | None = None) -> int:
    """Queries per block of K2's tensor-core body: the narrowest of 8, 16,
    32 and 64 that covers b, else the widest (a larger batch takes several
    tiles), among the tiles whose query planes fit the shared budget or,
    where the tile is streamed (k2_streams_queries, or `streamed` when
    given), among all four; 0 for a resident tile where none fits."""
    if streamed is None:
        streamed = k2_streams_queries(d, b)
    tiles = list(_K2_QUERY_TILES) if streamed else _resident_tiles(d)
    return next((t for t in tiles if t >= b), tiles[-1] if tiles else 0)


def k2_body(d: int, aligned: bool = True) -> str:
    """Which body of K2 serves a scan of d-column codes: "wgmma" (warpgroup
    MMA fed by TMA) where TMA takes the packed rows, their ceil(d/2) bytes a
    multiple of 16 and (`aligned`) the tensor's start 16-byte aligned
    (block_scan.tma_ready); "mma" (mma.sync) otherwise, at every d the
    launchers take (d < 2^21). The mma.sync body runs where the route takes
    wgmma only where a caller forces it (_launch_k2): the cross-check. Every
    metric K2 takes runs in both bodies, and the batch does not route."""
    return "wgmma" if aligned and packed_width(d) % 16 == 0 else "mma"


def _wgmma_plane_bytes(d: int) -> int:
    """Shared bytes of one query's two planes in the wgmma body's resident
    tile: each plane padded to a multiple of 128 codes."""
    return 2 * 128 * -(-packed_width(d) // 128)


def k2_wgmma_plan(d: int, b: int, streamed: bool | None = None) -> tuple[int, bool]:
    """(query tile, streamed) of K2's wgmma body for b queries: the
    narrowest tile of 8, 16, 32 and 64 that covers min(b, 64), resident
    while its planes fit _K2_WGMMA_RESIDENT_BYTES, else streamed beside the
    rows (a larger batch takes several tiles). `streamed` forces the
    choice: True, that tile streamed; False, the narrowest resident tile
    that covers min(b, 64) among those within _K2_QUERY_BYTES, else the
    widest of them, and tile 0 where none is."""
    want = min(b, _K2_QUERY_TILES[-1])
    cover = next(t for t in _K2_QUERY_TILES if t >= want)
    if streamed:
        return cover, True
    if streamed is None:
        return cover, cover * _wgmma_plane_bytes(d) > _K2_WGMMA_RESIDENT_BYTES
    resident = [t for t in _K2_QUERY_TILES if t * _wgmma_plane_bytes(d) <= _K2_QUERY_BYTES]
    return next((t for t in resident if t >= want), resident[-1] if resident else 0), False


def k2_wgmma_planes(qc: torch.Tensor, tile: int) -> torch.Tensor:
    """The query planes of K2's wgmma body where its TMA cannot copy them
    from qc itself (an odd d, or qc off a 16-byte boundary), laid out once a
    call (as block_scan.tf32_planes lays out K1's): int8 [ceil(B / tile) *
    tile, 2, hc], hc = ceil(h / 128) * 128 with h = ceil(d / 2), each
    query's plane 0 codes [0, h) (the low nibbles' columns) and plane 1
    codes [h, d) (the high nibbles'), each zero past its end, and zero rows
    past B. For an even d, qc's rows are this layout with hc = h."""
    b, d = qc.shape
    h = packed_width(d)
    planes = torch.zeros(
        (-(-b // tile) * tile, 2, 128 * -(-h // 128)), dtype=torch.int8, device=qc.device
    )
    planes[:b, 0, :h] = qc[:, :h]
    planes[:b, 1, : d - h] = qc[:, h:]
    return planes


def k2_query_planes(qc: torch.Tensor, tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The streamed query tiles of K2's tensor-core body, laid out once a
    call in the kernel's fragment order (as the JAX kernel's _permute_query
    lays out its queries): int8 [ceil(B / tile), ceil(h / 32), tile / 8,
    32, 16] with h = ceil(d / 2). Entry (i, ks, n, l), l = 4 g + t, holds
    lane l's four B registers of k-step ks of column tile n of query tile
    i: bytes [32 ks + 4 t, + 4) and [32 ks + 16 + 4 t, + 4) of query
    tile * i + 8 n + g's low plane (codes [0, h)), then the same of its high
    plane (codes [h, d)); zero past each plane's end and past B. So a ring
    stage's k-steps are one contiguous 16-byte-aligned run whatever d.
    Also 8 * sum(qc) of each query, int32 [B] (the -8 bias of the nibbles)."""
    b, d = qc.shape
    h = packed_width(d)
    ks = -(-h // 32)
    nqt = -(-b // tile)
    planes = torch.zeros((nqt * tile, 2, ks * 32), dtype=torch.int8, device=qc.device)
    planes[:b, 0, :h] = qc[:, :h]
    planes[:b, 1, : d - h] = qc[:, h:]
    # query i * tile + 8 n + g, plane, k-step, half, t, byte ->
    # i, k-step, n, g, t, plane, half, byte
    frag = planes.view(nqt, tile // 8, 8, 2, ks, 2, 4, 4).permute(0, 4, 1, 2, 6, 3, 5, 7)
    return frag.reshape(nqt, ks, tile // 8, 32, 16), 8 * qc.sum(1, dtype=torch.int32)


# The wgmma body's work counters, one zeroed int32 buffer per (device,
# stream): the kernel hands out each query tile's groups from them and
# leaves them zero, and launches on one stream run in turn.
_WORK_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _work_counters(dev: torch.device, stream: int, tiles: int) -> torch.Tensor:
    """A zeroed int32 buffer of at least 1 + tiles counters for a launch of
    K2's wgmma body on `stream` of `dev`, kept for the stream's next one."""
    key = (dev.index, stream)
    buf = _WORK_COUNTERS.get(key)
    if buf is None or buf.numel() < 1 + tiles:
        # a replaced buffer goes back to the allocator on this stream, after
        # the launches queued on it
        buf = torch.zeros(max(64, 1 + tiles), dtype=torch.int32, device=dev)
        _WORK_COUNTERS[key] = buf
    return buf


def _check(qc, qscale, packed, alpha, csq, metric, valid) -> None:
    if qc.dim() != 2 or packed.dim() != 2:
        raise ValueError("int4_block_minima: qc and packed must be 2-D")
    b, dim = qc.shape
    n = packed.shape[0]
    if packed.shape[1] != packed_width(dim):
        raise ValueError(
            f"int4_block_minima: packed width {packed.shape[1]} != "
            f"ceil({dim}/2)"
        )
    if qc.dtype != torch.int8 or packed.dtype != torch.uint8:
        raise ValueError("int4_block_minima: qc must be int8, packed uint8")
    if qscale.dtype != torch.float32 or qscale.shape != (b,):
        raise ValueError("int4_block_minima: qscale must be float32 [B]")
    if alpha.dtype != torch.float32 or alpha.shape != (n,):
        raise ValueError("int4_block_minima: alpha must be float32 [N]")
    if csq.dtype != torch.int32 or csq.shape != (n,):
        raise ValueError("int4_block_minima: csq must be int32 [N]")
    if len({t.device for t in (qc, qscale, packed, alpha, csq)}) != 1:
        raise ValueError("int4_block_minima: tensors on different devices")
    if metric not in _METRIC_CODE or metric is DistanceMetric.L1:
        raise ValueError(f"int4_block_minima: no surrogate for {metric}")
    if not (0 <= valid <= n):
        raise ValueError(f"int4_block_minima: valid={valid} outside [0, N]")


def int4_block_minima(
    qc: torch.Tensor,
    qscale: torch.Tensor,
    packed: torch.Tensor,
    alpha: torch.Tensor,
    csq: torch.Tensor,
    metric: DistanceMetric,
    valid: int,
    row_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-128-row surrogate minima [B, ceil(N/128)] float32; rows where
    row_mask ([N] bool, optional) is False read +inf.

    qc [B, d] int8 and qscale [B] float32 from quantize_query_int8; packed
    [N, ceil(d/2)] uint8, alpha [N] float32, csq [N] int32 from
    quantize4_device. CPU tensors run int4_block_minima_reference; CUDA
    tensors launch the K2 kernel in the body k2_body picks and count the
    launch in `int4_block_minima.launches`, by body in
    `int4_block_minima.body_launches` and, where a tensor-core body
    streams its query tile, in `int4_block_minima.streamed_launches`. Its
    span is `ops.scan` (range `svt.ops.scan:<B>`).
    """
    _check(qc, qscale, packed, alpha, csq, metric, valid)
    b = qc.shape[0]
    with annotate("ops.scan", tag=b, B=b):
        dev = packed.device
        check_row_mask(row_mask, packed.shape[0], dev, "int4_block_minima")
        if dev.type == "cpu":
            return int4_block_minima_reference(
                qc, qscale, packed, alpha, csq, metric, valid, row_mask
            )
        body = k2_body(qc.shape[1], tma_ready(packed))
        return _launch_k2(qc, qscale, packed, alpha, csq, metric, valid, row_mask, body)


def _launch_k2(
    qc: torch.Tensor,
    qscale: torch.Tensor,
    packed: torch.Tensor,
    alpha: torch.Tensor,
    csq: torch.Tensor,
    metric: DistanceMetric,
    valid: int,
    row_mask: torch.Tensor | None,
    body: str,
    streamed: bool | None = None,
) -> torch.Tensor:
    """K2 in `body` ("wgmma" or "mma") on checked CUDA tensors.
    int4_block_minima passes k2_body's choice; chip_smoke.py and the card
    tests force the other body to hold and time it beside it ("mma" takes
    every scan, "wgmma" only rows TMA can copy), and `streamed` (default
    k2_wgmma_plan's or k2_streams_queries' choice) to time the resident and
    the streamed query tile side by side. Raises for another body, where
    the body does not take the scan or a resident tile does not fit."""
    if body not in ("wgmma", "mma"):
        raise ValueError(f"int4_block_minima: no {body!r} body (K2 has wgmma and mma)")
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"int4_block_minima: unsupported device {dev}")
    tensors = (qc, qscale, packed, alpha, csq) + (() if row_mask is None else (row_mask,))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("int4_block_minima: the kernel needs contiguous tensors")
    b, dim = qc.shape
    n = packed.shape[0]
    if n >= 2**31 or b >= 2**31 or dim >= 2**21:
        raise ValueError("int4_block_minima: B, N must fit int32 and d < 2^21")
    if body == "wgmma":
        if k2_body(dim, tma_ready(packed)) != "wgmma":
            raise ValueError("int4_block_minima: the wgmma body does not take these rows (TMA cannot copy them)")
        tile, streamed = k2_wgmma_plan(dim, b, streamed)
    else:
        streamed = k2_streams_queries(dim, b) if streamed is None else streamed
        tile = k2_query_tile(dim, b, streamed)
    if not tile:
        raise ValueError("int4_block_minima: no resident query tile fits these rows")
    out = torch.empty((b, -(-n // BLOCK)), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    from sqlite_vector_tpu_torch.ops._build import load_library

    lib = load_library()
    args = [
        qc.data_ptr(),
        qscale.data_ptr(),
        packed.data_ptr(),
        alpha.data_ptr(),
        csq.data_ptr(),
        None if row_mask is None else row_mask.data_ptr(),
        out.data_ptr(),
        b,
        n,
        dim,
        valid,
        _METRIC_CODE[metric],
    ]
    with torch.cuda.device(dev):
        if body == "wgmma":
            launch = lib.svt_int4_block_minima_wgmma
            # made on the current stream, which the launch queues on: their
            # memory is not reused before the kernel ran. TMA copies the
            # query tile from qc itself where d is even; a resident tile's
            # sums the kernel takes itself
            planes = None if dim % 2 == 0 and tma_ready(qc) else k2_wgmma_planes(qc, tile)
            sums = qc.sum(1, dtype=torch.int32) if streamed else None
            stream = torch.cuda.current_stream(dev).cuda_stream
            args += [tile, None if planes is None else planes.data_ptr(),
                     None if sums is None else sums.data_ptr(), int(streamed),
                     _work_counters(dev, stream, -(-b // tile)).data_ptr()]
        else:
            launch = lib.svt_int4_block_minima_mma
            args.append(tile)
            if streamed:
                # made on the current stream, which the launch queues on:
                # their memory is not reused before the kernel ran
                planes, bias = k2_query_planes(qc, tile)
                args += [planes.data_ptr(), bias.data_ptr()]
            else:
                args += [None, None]
        rc = launch(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int4_block_minima kernel launch failed: cudaError {rc}")
    int4_block_minima.launches += 1
    int4_block_minima.body_launches[body] += 1
    int4_block_minima.streamed_launches += streamed
    return out


int4_block_minima.launches = 0
int4_block_minima.body_launches = {"wgmma": 0, "mma": 0}
int4_block_minima.streamed_launches = 0


def int4_block_scan_topk(
    queries: torch.Tensor,
    packed: torch.Tensor,
    alpha: torch.Tensor,
    csq: torch.Tensor,
    metric: DistanceMetric,
    k: int,
    *,
    dim: int,
    valid_count: int | None = None,
    row_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """int4 top-k via K2's surrogate minima + exact finish. Same contract as
    ops.quantize4.int4_scan_topk (float32 queries [B, d]; rows where
    row_mask ([N] bool) is False are never returned). The finish is
    K1's group selection and chunked finish (block_scan.finish_groups),
    rescoring the gathered packed rows with the int4 composition (NaN ->
    +inf, block_scan.rescore_gathered); the query codes are made once for
    both stages."""
    valid = packed.shape[0] if valid_count is None else int(valid_count)
    codes = quantize_query_int8(queries)
    minima = int4_block_minima(*codes[:2], packed, alpha, csq, metric, valid, row_mask)
    with annotate("ops.finish"):
        return _finish_int4(minima, codes, sanitize_queries(queries), packed, alpha, csq, metric, k,
                            dim, valid, row_mask)


def _finish_int4(
    minima: torch.Tensor,
    codes: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    qf: torch.Tensor,
    packed: torch.Tensor,
    alpha: torch.Tensor,
    csq: torch.Tensor,
    metric: DistanceMetric,
    k: int,
    dim: int,
    valid: int,
    row_mask: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 of int4_block_scan_topk over K2's minima: `codes` is
    quantize_query_int8's (qc, qscale, qsq), qf the sanitized float32
    queries. chip_smoke.py times it beside K2."""
    qc, qscale, qsq = codes

    def score(s: int, e: int, gidx: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        def distances(a: int, b: int, rows: torch.Tensor) -> torch.Tensor:
            q = slice(s + a, s + b)
            d = int4_distances(
                qc[q], qscale[q], qsq[q], qf[q],
                unpack4(packed[rows], dim), alpha[rows], csq[rows], metric,
            )
            return torch.where(torch.isnan(d), torch.inf, d)

        return rescore_gathered(pos, packed.shape[0], valid, dim, distances, row_mask)

    return finish_tail(*finish_groups(minima, k, score))
