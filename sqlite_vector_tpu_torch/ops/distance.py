"""Batched distance computation (plain PyTorch).

Port of sqlite_vector_tpu/ops/distance.py. The same formulations:

  float path (f32, f16, bf16 widened to f32):
    L2/SQUARED_L2: ||q||^2 + ||b||^2 - 2 q.b, the cross term one matmul;
    COSINE:        1 - q.b / (||q|| ||b||), zero-norm rows -> 1.0;
    DOT:           -(q.b);
    L1:            element-wise |q-b| reduction.

  integer path (u8/i8): exact integer arithmetic with int32 wrap semantics.
    Torch has no CUDA int32 matmul, so dots run in float64, which is exact
    here because |dot| <= 255^2 * dim < 2^53; the results are then wrapped
    to int32 exactly as the reference's int32 accumulation wraps.

The f32 matmuls run in true float32 as long as TF32 stays off
(torch.backends.cuda.matmul.allow_tf32, False by default); the reference
uses Precision.HIGHEST for the same reason.
"""

from __future__ import annotations

import torch

from sqlite_vector_tpu_torch.types import DistanceMetric

FLT_EPSILON = 1.1920929e-07
NEARLY_ZERO = 8.0 * FLT_EPSILON

# Integer-composition overflow bound, the same contract as the reference
# package: qsq + csq can exceed int32 for dim > 16512 with u8 codes, but the
# composition is taken mod 2^32, which is exact whenever the FINAL value
# fits int32, i.e. ||q-b||^2 <= dim * 255^2 < 2^31, dim <= 33026.
INT_L2_EXACT_MAX_DIM = 33026

# L1 evaluates an element-wise [B, rows, d] cube; rows are chunked so that
# no chunk holds more than this many elements.
_L1_CUBE_ELEMS = 1 << 26


def _snap(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d.abs() <= NEARLY_ZERO, torch.zeros_like(d), d)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (torch's CPU float32 sqrt is not; the
    float64 sqrt rounded once to float32 is, on every device)."""
    return torch.sqrt(x.double()).float()


def is_int(x: torch.Tensor) -> bool:
    return not x.dtype.is_floating_point


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Exact integers (int64) -> the int32 value that wrapping int32
    arithmetic gives, held in int64."""
    return torch.remainder(x + 2**31, 2**32) - 2**31


def int_dot(q: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact [B, N] integer dot of q [B, d] and b [N, d], int32-wrapped."""
    return wrap_int32((q.double() @ b.double().T).long())


def int_sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Exact row squared norms of integer rows, int32-wrapped."""
    xl = x.long()
    return wrap_int32((xl * xl).sum(-1))


def l1_distance(q: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, N] sum |q - b| in the accumulation type of the inputs (callers
    pass float32 or int64), chunked over rows to bound the cube."""
    n = b.shape[0]
    out = torch.empty((q.shape[0], n), dtype=q.dtype, device=q.device)
    rows = max(1, _L1_CUBE_ELEMS // max(1, q.shape[0] * q.shape[1]))
    for s in range(0, n, rows):
        cube = q[:, None, :] - b[None, s : s + rows, :]
        out[:, s : s + rows] = cube.abs().sum(-1)
    return out


def pairwise_distance(
    queries: torch.Tensor,
    base: torch.Tensor,
    metric: DistanceMetric,
    *,
    snap: bool = True,
) -> torch.Tensor:
    """Compute the [B, N] float32 distance matrix between queries [B, d]
    and base [N, d]."""
    if is_int(queries) or is_int(base):
        return _pairwise_int(queries, base, metric)
    return _pairwise_float(queries, base, metric, snap)


def _pairwise_float(
    q: torch.Tensor, b: torch.Tensor, metric: DistanceMetric, snap: bool
) -> torch.Tensor:
    qf = q.float()
    bf = b.float()
    if metric is DistanceMetric.L1:
        d = l1_distance(qf, bf)
        return _snap(d) if snap else d
    dot = qf @ bf.T  # [B, N]
    if metric is DistanceMetric.DOT:
        return _snap(-dot) if snap else -dot
    q_sq = (qf * qf).sum(-1)
    b_sq = (bf * bf).sum(-1)
    return compose_float(metric, dot, q_sq[:, None], b_sq[None, :], snap=snap)


def compose_float(
    metric: DistanceMetric,
    dot: torch.Tensor,
    q_sq: torch.Tensor,
    b_sq: torch.Tensor,
    *,
    snap: bool = True,
) -> torch.Tensor:
    """Float distances from the dim-separable components. q_sq and b_sq
    broadcast against dot ([B, 1] and [1, N] for a [B, N] matrix, [B, 1]
    and [B, C] for per-query candidates)."""
    if metric is DistanceMetric.DOT:
        d = -dot
        return _snap(d) if snap else d
    if metric in (DistanceMetric.L2, DistanceMetric.SQUARED_L2):
        d = q_sq + b_sq - 2.0 * dot
        # the decomposition carries a residual of O(eps * (|q|^2+|b|^2))
        # that the direct sum((a-b)^2) does not: clamp it so self-distances
        # are exactly 0. Only when the residual is finite: an Inf element
        # must stay +Inf, not be zeroed.
        resid = FLT_EPSILON * 16.0 * (q_sq + b_sq)
        d = torch.where((d <= resid) & torch.isfinite(resid), 0.0, d)
        if metric is DistanceMetric.L2:
            d = sqrt_rn(d)
        return _snap(d) if snap else d
    # COSINE
    denom = sqrt_rn(q_sq) * sqrt_rn(b_sq)
    pos = denom > 0.0
    cos = torch.where(pos, dot / torch.where(pos, denom, 1.0), 0.0)
    d = 1.0 - cos
    # NaN inputs yield NaN like the plain C kernels ...
    d = torch.where(torch.isnan(dot) | torch.isnan(denom), torch.nan, d)
    # ... and zero-norm -> 1.0 is applied LAST (the reference's precedence:
    # a zero-norm side beats a NaN on the other side)
    d = torch.where((q_sq == 0.0) | (b_sq == 0.0), 1.0, d)
    return _snap(d) if snap else d


def _pairwise_int(
    q: torch.Tensor, b: torch.Tensor, metric: DistanceMetric
) -> torch.Tensor:
    """Exact integer-domain distances for u8/i8 codes, in float32."""
    if metric is DistanceMetric.L1:
        return l1_distance(q.long(), b.long()).float()
    dot = int_dot(q, b)
    if metric is DistanceMetric.DOT:
        return compose_int(metric, dot, None, None)
    return compose_int(
        metric, dot, int_sq_norms(q)[:, None], int_sq_norms(b)[None, :]
    )


def compose_int(
    metric: DistanceMetric,
    dot: torch.Tensor,
    q_sq: torch.Tensor | None,
    b_sq: torch.Tensor | None,
) -> torch.Tensor:
    """Integer-domain distances from int32-valued components (held in
    int64); q_sq and b_sq broadcast against dot as in compose_float."""
    if metric is DistanceMetric.DOT:
        return wrap_int32(-dot).float()
    if metric in (DistanceMetric.L2, DistanceMetric.SQUARED_L2):
        # intermediates may exceed int32 for u8 past dim 16512; the
        # composition is exact mod 2^32 (INT_L2_EXACT_MAX_DIM)
        df = wrap_int32(q_sq + b_sq - 2 * dot).float()
        return sqrt_rn(df) if metric is DistanceMetric.L2 else df
    # COSINE in the integer domain
    denom = sqrt_rn(q_sq.float()) * sqrt_rn(b_sq.float())
    pos = denom > 0.0
    cos = torch.where(pos, dot.float() / torch.where(pos, denom, 1.0), 0.0)
    return torch.where((q_sq == 0) | (b_sq == 0), 1.0, 1.0 - cos)
