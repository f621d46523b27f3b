"""Packed int4 quantization + the plain int4 scan (PyTorch).

Port of sqlite_vector_tpu/ops/quantize4.py. The spec is the same, and codes
and scales are bit-equal to it:

  finite_absmax_i = max over FINITE elements of |x_i| (0 if none)
  alpha_i         = finite_absmax_i / 7                  (f32)
  s_i             = 7 / finite_absmax_i  if > 0 else 0   (f32)
  c_ij            = q_round_s4(x_ij * s_i):  half-away-from-zero, truncate,
                    clamp to [-7, 7]; NaN -> 0, +Inf -> 7, -Inf -> -7
  packing         h = ceil(dim / 2); nibble(c) = c + 8;
                  packed[i, j] = nibble(c[i, j]) | (nibble(c[i, h + j]) << 4)
                  (odd dim: the last byte's high nibble is 8 == code 0)

Distances are approximate values in the original (dequantized) domain.
The query is quantized per row to symmetric int8 (quantize_query_int8), and
the cross term is an exact integer dot of the query codes with the int4
codes.

The numpy spec below is copied verbatim from the JAX module (importing it
would import jax). The device build and the scans are torch ops. The scan
router, int4_scan_topk, sends the four matmul metrics to the K2 block-minima
scan (ops/int4_scan.py), masked or not, and L1 to the plain tile loop, as the
JAX package does (no kernel exists for L1 in either package).
"""

from __future__ import annotations

import numpy as np
import torch

from sqlite_vector_tpu_torch.ops.block_scan import check_row_mask
from sqlite_vector_tpu_torch.ops.distance import l1_distance, sqrt_rn
from sqlite_vector_tpu_torch.ops.topk import merge_topk, topk_ascending
from sqlite_vector_tpu_torch.types import DistanceMetric

INT4_LEVELS = 7  # symmetric code range [-7, 7]
_FLT_MIN = float(np.finfo(np.float32).tiny)  # smallest normal float32

# rows per chunk of the device build: bounds its float32 temporaries
_QUANT_CHUNK_ELEMS = 1 << 26
# rows per tile of the plain scan: neither the unpacked [tile, dim] codes
# nor the [B, tile] distances exceed this many elements
_TILE_ELEMS = 1 << 25


def packed_width(dim: int) -> int:
    """Bytes per row of packed codes."""
    return (dim + 1) // 2


# ---------------------------------------------------------------------------
# numpy reference / host build (the oracle for the device path)
# ---------------------------------------------------------------------------


def q_round_s4_np(s: np.ndarray) -> np.ndarray:
    """q_round for the 4-bit symmetric range: half-away-from-zero, truncate,
    clamp [-7, 7]; NaN -> 0, +Inf -> 7, -Inf -> -7 (the int8 q_round family's
    semantics, src/sqlite-vector.c:495-515, at the narrower range)."""
    s = np.asarray(s, dtype=np.float32)
    nonfinite = ~np.isfinite(s)
    r = s + np.float32(0.5) * (np.float32(1.0) - np.float32(2.0) * (s < 0))
    r = np.where(np.isnan(r), np.float32(0.0), r)
    out = np.clip(np.trunc(r), -INT4_LEVELS, INT4_LEVELS)
    nf = np.where(
        s > 0, np.int8(INT4_LEVELS), np.where(s < 0, np.int8(-INT4_LEVELS), 0)
    )
    return np.where(nonfinite, nf, out.astype(np.int8)).astype(np.int8)


def _row_scales_np(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(alpha [N], s [N]) per-row scales from finite absmax (f32 math)."""
    xf = np.asarray(x, dtype=np.float32)
    mag = np.where(np.isfinite(xf), np.abs(xf), np.float32(0.0))
    absmax = mag.max(axis=1) if xf.shape[1] else np.zeros(len(xf), np.float32)
    absmax = absmax.astype(np.float32)
    with np.errstate(divide="ignore"):
        s = np.where(
            absmax > 0, np.float32(INT4_LEVELS) / absmax, np.float32(0.0)
        ).astype(np.float32)
    alpha = (absmax / np.float32(INT4_LEVELS)).astype(np.float32)
    return alpha, s


def pack4_np(codes: np.ndarray) -> np.ndarray:
    """[N, dim] int8 codes in [-7, 7] -> [N, ceil(dim/2)] packed uint8."""
    n, dim = codes.shape
    h = packed_width(dim)
    nib = (codes.astype(np.int16) + 8).astype(np.uint8)
    lo = np.full((n, h), 8, np.uint8)
    hi = np.full((n, h), 8, np.uint8)
    lo[:, :] = nib[:, :h] if h else lo
    hi[:, : dim - h] = nib[:, h:]
    return (lo | (hi << 4)).astype(np.uint8)


def unpack4_np(packed: np.ndarray, dim: int) -> np.ndarray:
    """Inverse of pack4_np: [N, P] uint8 -> [N, dim] int8 codes."""
    h = packed_width(dim)
    lo = (packed & np.uint8(0x0F)).astype(np.int8) - np.int8(8)
    hi = (packed >> 4).astype(np.int8) - np.int8(8)
    return np.concatenate([lo[:, :h], hi[:, : dim - h]], axis=1)


def quantize4_np(
    x: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantize rows to packed int4: (packed [N, P] u8, alpha [N] f32,
    csq [N] int32 = sum of squared codes)."""
    xf = np.asarray(x, dtype=np.float32)
    alpha, s = _row_scales_np(xf)
    with np.errstate(invalid="ignore", over="ignore"):
        codes = q_round_s4_np(xf * s[:, None])
    csq = np.einsum(
        "nd,nd->n", codes.astype(np.int32), codes.astype(np.int32)
    ).astype(np.int32)
    return pack4_np(codes), alpha, csq


def dequantize4_np(
    packed: np.ndarray, alpha: np.ndarray, dim: int
) -> np.ndarray:
    codes = unpack4_np(packed, dim)
    return codes.astype(np.float32) * np.asarray(alpha, np.float32)[:, None]


# ---------------------------------------------------------------------------
# device build
# ---------------------------------------------------------------------------


def unpack4(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """[*, P] uint8 -> [*, dim] int8 codes (column-split layout)."""
    h = packed_width(dim)
    lo = (packed & 0x0F).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.cat([lo[..., :h], hi[..., : dim - h]], dim=-1)


def _absmax(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return torch.where(torch.isfinite(xf), xf.abs(), 0.0).amax(1)


def _encode(x: torch.Tensor, s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(packed, csq) from rows and their per-row scales, multiplication
    only: the scales are divided host-side in numpy (quantize4_device)."""
    xf = x.float()
    dim = xf.shape[1]
    h = packed_width(dim)
    v = xf * s[:, None]
    r = v + 0.5 * (1.0 - 2.0 * (v < 0).float())
    codes = torch.clamp(torch.trunc(r), -INT4_LEVELS, INT4_LEVELS)
    nf = torch.where(
        v > 0, float(INT4_LEVELS), torch.where(v < 0, float(-INT4_LEVELS), 0.0)
    )
    codes = torch.where(torch.isfinite(v), codes, nf).to(torch.int8)
    ci = codes.int()
    csq = (ci * ci).sum(-1, dtype=torch.int32)
    nib = (codes + 8).to(torch.uint8)
    if 2 * h != dim:  # odd dim: the pad nibble 8 (code 0)
        nib = torch.cat([nib, nib.new_full((nib.shape[0], 1), 8)], dim=1)
    return nib[:, :h] | (nib[:, h:] << 4), csq


def quantize4_device(
    x: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device quantize: (packed [N, P] u8, alpha [N] f32, csq [N] i32).

    The per-row absmax reduces on the device; the [N] scale division runs
    host-side in numpy, with the numpy spec's expression, as the JAX
    package's does, so codes and scales are bit-identical to quantize4_np
    on every device. The encode walks row chunks of at most
    _QUANT_CHUNK_ELEMS elements."""
    n, dim = x.shape
    rows = max(1, _QUANT_CHUNK_ELEMS // max(dim, 1))
    chunks = range(0, n, rows)
    absmax = np.zeros((0,), np.float32)
    if n:
        absmax = torch.cat([_absmax(x[s : s + rows]) for s in chunks]).cpu().numpy()
    with np.errstate(divide="ignore"):
        s = np.where(
            absmax > 0, np.float32(INT4_LEVELS) / absmax, np.float32(0.0)
        ).astype(np.float32)
    alpha = (absmax / np.float32(INT4_LEVELS)).astype(np.float32)
    sd = torch.from_numpy(s).to(x.device)
    packed = torch.empty((n, packed_width(dim)), dtype=torch.uint8, device=x.device)
    csq = torch.empty((n,), dtype=torch.int32, device=x.device)
    for s0 in chunks:
        packed[s0 : s0 + rows], csq[s0 : s0 + rows] = _encode(
            x[s0 : s0 + rows], sd[s0 : s0 + rows]
        )
    return packed, torch.from_numpy(alpha).to(x.device), csq


def sanitize_queries(q: torch.Tensor) -> torch.Tensor:
    """float32 queries with non-finite elements zeroed (the int4 path's
    documented query rule)."""
    qf = q.float()
    return torch.where(torch.isfinite(qf), qf, 0.0)


def quantize_query_int8(
    q: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-query symmetric int8 codes for the cross-term dot.

    Returns (qc [B, d] int8, qscale [B] f32, qsq [B] f32 = ||q||^2 of the
    sanitized query). Non-finite query elements are zeroed first."""
    qf = sanitize_queries(q)
    absmax = qf.abs().amax(1)
    # a tensor numerator: `scalar / tensor` is reciprocal-then-multiply in
    # torch, which is not the correctly rounded quotient JAX computes
    s = torch.where(absmax > 0, torch.full_like(absmax, 127.0) / absmax, 0.0)
    v = qf * s[:, None]
    r = v + 0.5 * (1.0 - 2.0 * (v < 0).float())
    qc = torch.clamp(torch.trunc(r), -127, 127)
    # denormal absmax (< ~3.7e-37) overflows s to +inf: v becomes inf at
    # the absmax element and 0*inf = NaN elsewhere; saturate like _encode
    # does instead of casting NaN to int8
    nf = torch.where(v > 0, 127.0, torch.where(v < 0, -127.0, 0.0))
    qc = torch.where(torch.isfinite(v), qc, nf).to(torch.int8)
    # tensor / tensor: torch divides a CUDA tensor by a Python scalar as a
    # multiply by its reciprocal, which can differ in the last bit
    qscale = absmax / torch.full_like(absmax, 127.0)
    # the JAX package runs with denormals flushed to zero (XLA on CPU and
    # TPU), so a denormal qscale (absmax < 127 * FLT_MIN) reads 0 there
    qscale = torch.where(qscale < _FLT_MIN, 0.0, qscale)
    qsq = (qf * qf).sum(-1)
    return qc, qscale, qsq


# ---------------------------------------------------------------------------
# int4 distances and the plain tile loop
# ---------------------------------------------------------------------------


def dot_dtype(dim: int) -> torch.dtype:
    """Float type in which integer dots of int8 query codes with int4 codes
    are exact: every product is an integer of magnitude <= 127 * 8 and every
    partial sum <= 127 * 8 * dim, exact in float32 below 2^24 whatever the
    summation order (dim <= 16,513); float64 above. (torch has no CUDA
    int32 matmul.)"""
    return torch.float32 if 127 * 8 * dim < 2**24 else torch.float64


def int4_distances(
    qc: torch.Tensor,  # [B, d] int8 query codes
    qscale: torch.Tensor,  # [B] f32
    qsq: torch.Tensor,  # [B] f32 (||q||^2 of the sanitized query)
    qf: torch.Tensor,  # [B, d] sanitized f32 queries (L1 only)
    codes: torch.Tensor,  # [T, d] int8, or [B, C, d] per-query candidates
    alpha: torch.Tensor,  # [T] or [B, C] f32
    csq: torch.Tensor,  # [T] or [B, C] int32
    metric: DistanceMetric,
) -> torch.Tensor:
    """[B, T] (or [B, C]) int4 distances: the composition of the JAX
    package's _int4_tile_distance on unpacked codes, op for op. L1 takes
    shared [T, d] rows only (it never reaches the K2 finish)."""
    if metric is DistanceMetric.L1:
        # no matmul decomposition: dequantize and reduce element-wise
        return l1_distance(qf, codes.float() * alpha[:, None])
    acc = dot_dtype(codes.shape[-1])
    if codes.dim() == 2:  # rows shared by every query: broadcast as [1, T]
        dot = qc.to(acc) @ codes.to(acc).T
        alpha, csq = alpha[None, :], csq[None, :]
    else:
        dot = torch.bmm(codes.to(acc), qc.to(acc)[:, :, None])[..., 0]
    dotf = dot.float()  # exact integers, rounded like int32 -> f32

    if metric is DistanceMetric.COSINE:
        # both scales cancel inside cos(); integer norms are exact
        qi = qc.int()
        qcsq = (qi * qi).sum(-1).float()[:, None]
        csqf = csq.float()
        denom = sqrt_rn(qcsq) * sqrt_rn(csqf)
        safe = torch.where(denom > 0.0, denom, 1.0)
        cos = torch.where(denom > 0.0, dotf / safe, 0.0)
        return torch.where((qcsq == 0.0) | (csqf == 0.0), 1.0, 1.0 - cos)

    cross = (qscale[:, None] * alpha) * dotf
    if metric is DistanceMetric.DOT:
        return -cross
    # L2 / SQUARED_L2: ||q||^2 - 2 a.b + ||b~||^2 with b~ = alpha * codes
    bsq = (alpha * alpha) * csq.float()
    d = qsq[:, None] + bsq - 2.0 * cross
    d = torch.clamp(d, min=0.0)  # quantization noise; NaN stays NaN
    if metric is DistanceMetric.L2:
        d = sqrt_rn(d)
    return d


def int4_scan_topk_plain(
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
    """The plain tile loop (the JAX package's _int4_scan_topk_impl): per
    row tile, unpack, score every row, take the tile's top-k and merge it
    into the running top-k (the earlier tile wins ties). Rows >= valid_count
    and rows where row_mask ([N] bool) is False score +inf."""
    check_row_mask(row_mask, packed.shape[0], packed.device, "int4_scan_topk")
    qc, qscale, qsq = quantize_query_int8(queries)
    qf = sanitize_queries(queries)
    b, n = queries.shape[0], packed.shape[0]
    valid = n if valid_count is None else int(valid_count)
    dev = packed.device
    tile = max(1, _TILE_ELEMS // max(dim, b, 1))
    vals = torch.full((b, k), torch.inf, device=dev)
    idx = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for s in range(0, n, tile):
        e = min(s + tile, n)
        codes = unpack4(packed[s:e], dim)
        d = int4_distances(qc, qscale, qsq, qf, codes, alpha[s:e], csq[s:e], metric)
        d = torch.where(torch.isnan(d), torch.inf, d)
        keep = torch.arange(s, e, device=dev) < valid
        if row_mask is not None:
            keep &= row_mask[s:e]
        d = torch.where(keep[None, :], d, torch.inf)
        tv, ti = topk_ascending(d, min(k, e - s))
        vals, idx = merge_topk(vals, idx, tv, ti + s, k)
    return vals, torch.where(torch.isposinf(vals), -1, idx)


def int4_scan_topk(
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
    """Fused int4 top-k scan: (distances [B, k] f32 approximate
    original-domain, positions [B, k] int64), ascending, +inf/-1 padding;
    rows where row_mask ([N] bool) is False are never returned.

    Routing: L1 has no matmul form and runs the plain tile loop; every
    other metric runs the K2 block-minima scan + exact finish
    (ops.int4_scan.int4_block_scan_topk), masked or not, which launches the
    CUDA kernel on CUDA tensors and its plain twin on CPU tensors."""
    if metric is DistanceMetric.L1:
        return int4_scan_topk_plain(
            queries, packed, alpha, csq, metric, k, dim=dim,
            valid_count=valid_count, row_mask=row_mask,
        )
    from sqlite_vector_tpu_torch.ops.int4_scan import int4_block_scan_topk

    return int4_block_scan_topk(
        queries, packed, alpha, csq, metric, k, dim=dim,
        valid_count=valid_count, row_mask=row_mask,
    )


def int4_scan_distances(
    queries: torch.Tensor,
    packed: torch.Tensor,
    alpha: torch.Tensor,
    csq: torch.Tensor,
    metric: DistanceMetric,
    *,
    dim: int,
) -> torch.Tensor:
    """Full [B, N] approximate original-domain distance matrix (the
    *_stream virtual tables' int4 analogue), row tile by row tile so the
    unpacked codes stay bounded."""
    qc, qscale, qsq = quantize_query_int8(queries)
    qf = sanitize_queries(queries)
    b, n = queries.shape[0], packed.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=packed.device)
    tile = max(1, _TILE_ELEMS // max(dim, b, 1))
    for s in range(0, n, tile):
        e = min(s + tile, n)
        out[:, s:e] = int4_distances(
            qc, qscale, qsq, qf, unpack4(packed[s:e], dim), alpha[s:e], csq[s:e], metric
        )
    return out
