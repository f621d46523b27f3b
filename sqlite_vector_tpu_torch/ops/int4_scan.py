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
finish (ops.block_scan.finish_groups).

Stage 1 has two implementations of one contract:
  - int4_block_minima_reference: plain PyTorch, the definition of the output;
  - the CUDA kernel K2, hand-written for Hopper, in two bodies that agree bit
    for bit: csrc/int4_minima_mma.cu (int8 tensor cores over the nibble
    planes) and csrc/int4_minima.cu (CUDA cores: __dp4a, for rows too wide
    for the tensor-core body's shared budget). k2_body says which body a
    call takes.
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
from sqlite_vector_tpu_torch.types import DistanceMetric

# bound on the twin's unpacked [rows, d] codes and [B, rows] dots (elements)
_TWIN_CHUNK_ELEMS = 1 << 25

# The tensor-core body (csrc/int4_minima_mma.cu) keeps a tile of 8, 16, 32
# or 64 queries in shared memory beside its 81,920-byte ring of packed row
# tiles: per query both code planes, each padded to a multiple of 128 codes
# (64 packed bytes), so 128 bytes per 64 packed bytes of a row. The query
# tile may take this many bytes (the kernel takes the tile from
# k2_query_tile); it admits d <= 2,048 / 4,096 / 8,192 / 16,384 for tiles of
# 64 / 32 / 16 / 8 queries.
_K2_QUERY_BYTES = 131072
_K2_QUERY_TILES = (8, 16, 32, 64)


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


def k2_query_tile(d: int, b: int) -> int:
    """Queries per block of K2's tensor-core body: the narrowest of 8, 16,
    32 and 64 that covers b among the tiles whose query planes fit the
    shared budget, else the widest that fits (a larger batch takes several
    tiles); 0 when not even 8 queries fit."""
    per_query = 128 * -(-packed_width(d) // 64)
    fitting = [t for t in _K2_QUERY_TILES if t * per_query <= _K2_QUERY_BYTES]
    return next((t for t in fitting if t >= b), fitting[-1] if fitting else 0)


def k2_body(d: int) -> str:
    """Which body of K2 serves a scan of d-column codes: "mma" (tensor
    cores) while a tile of 8 queries fits the shared budget, "simt" (CUDA
    cores) past it. Every metric K2 takes runs in both bodies, and the
    batch does not route: the tensor-core body serves every B."""
    return "mma" if k2_query_tile(d, 1) else "simt"


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
    launch in `int4_block_minima.launches` and by body in
    `int4_block_minima.body_launches`.
    """
    _check(qc, qscale, packed, alpha, csq, metric, valid)
    dev = packed.device
    check_row_mask(row_mask, packed.shape[0], dev, "int4_block_minima")
    if dev.type == "cpu":
        return int4_block_minima_reference(
            qc, qscale, packed, alpha, csq, metric, valid, row_mask
        )
    return _launch_k2(qc, qscale, packed, alpha, csq, metric, valid, row_mask, k2_body(qc.shape[1]))


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
) -> torch.Tensor:
    """K2 in `body` ("mma" or "simt") on checked CUDA tensors.
    int4_block_minima passes k2_body's choice; chip_smoke.py forces "simt"
    to hold and time the CUDA-core body beside the tensor-core one. Raises
    where the tensor-core body does not take the scan."""
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
    if body == "mma" and k2_body(dim) != "mma":
        raise ValueError("int4_block_minima: the tensor-core body does not take this scan")
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
    if body == "mma":
        launch = lib.svt_int4_block_minima_mma
        args.append(k2_query_tile(dim, b))
    else:
        launch = lib.svt_int4_block_minima
    with torch.cuda.device(dev):
        rc = launch(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int4_block_minima kernel launch failed: cudaError {rc}")
    int4_block_minima.launches += 1
    int4_block_minima.body_launches[body] += 1
    return out


int4_block_minima.launches = 0
int4_block_minima.body_launches = {"mma": 0, "simt": 0}


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
    +inf); the query codes are made once for both stages."""
    valid = packed.shape[0] if valid_count is None else int(valid_count)
    qc, qscale, qsq = quantize_query_int8(queries)
    qf = sanitize_queries(queries)
    minima = int4_block_minima(qc, qscale, packed, alpha, csq, metric, valid, row_mask)

    def rescore(s: int, e: int, rows: torch.Tensor) -> torch.Tensor:
        d = int4_distances(
            qc[s:e], qscale[s:e], qsq[s:e], qf[s:e],
            unpack4(packed[rows], dim), alpha[rows], csq[rows], metric,
        )
        return torch.where(torch.isnan(d), torch.inf, d)

    vals, idx = finish_groups(minima, packed.shape[0], valid, k, dim, rescore, row_mask)
    return vals, torch.where(torch.isposinf(vals), -1, idx)
