"""Non-finite input policies (NaN lane skip, Inf mismatch, LASSQ), plain
PyTorch.

Port of sqlite_vector_tpu/ops/nonfinite.py. The reference's float16 and
bfloat16 kernels do not let a NaN element poison a row:
  - f16/bf16 L2 and SQUARED_L2 use LASSQ: NaN difference lanes add 0,
    matched same-sign Inf lanes add 0, any unmatched Inf lane makes the
    distance +Inf (src/distance-cpu.c:164-197, 318-356);
  - f16/bf16 DOT, L1 and COSINE skip lanes where either side is NaN; an
    infinite product short-circuits DOT to -Inf of its sign; COSINE is 1.0
    on any Inf lane or a non-finite denominator (src/distance-cpu.c:
    358-468);
  - f32 is plain float math. Its top-k needs no policy (a NaN or +Inf
    distance is never selected), but its raw L2/SQUARED_L2 values do: the
    matmul decomposition reads NaN where the reference's direct sum of
    squares reads +Inf (needs_raw_policy).

This is element-wise code on [B, rows, d] cubes (the JAX package runs it
through XLA, outside any Pallas kernel), so the port is torch ops on the
card and on the CPU alike. It is a cold path: datasets flag non-finite
content at ingest, and only a flagged dataset or a non-finite query routes
here. The sharded variant (policy_pairwise_sharded) waits for the port of
parallel/ (ROADMAP.md queue 1, item 8).
"""

from __future__ import annotations

import torch

from sqlite_vector_tpu_torch.ops.distance import _snap, sqrt_rn
from sqlite_vector_tpu_torch.types import DistanceMetric, VectorType

_LASSQ_METRICS = (DistanceMetric.L2, DistanceMetric.SQUARED_L2)

# Rows per evaluated tile: the JAX package's POLICY_ROW_TILE (its
# ops/scan.py L1_ROW_TILE), so a [1, 1M, 384] cube is never whole in
# memory. The port also caps a tile's cube at POLICY_CUBE_ELEMS elements,
# which only large batches reach (B = 8 at d = 384 stays at 32,768 rows).
POLICY_ROW_TILE = 32768
POLICY_CUBE_ELEMS = 1 << 27


def needs_policy(vtype: VectorType, metric: DistanceMetric) -> bool:
    """True when this (dtype, metric) has lane-skip semantics that the
    plain path cannot reproduce: float16 and bfloat16 under every metric
    (bfloat16 pinned to the f16 family, as the reference's x86 SIMD
    kernels behave)."""
    return vtype in (VectorType.F16, VectorType.BF16)


def needs_raw_policy(vtype: VectorType, metric: DistanceMetric) -> bool:
    """needs_policy, plus f32 L2/SQUARED_L2, where only the raw distance
    VALUE diverges: the decomposition turns an Inf row into qsq + inf -
    2*(+-inf) = NaN, where the reference's direct sum((a-b)^2) emits +Inf
    (src/distance-cpu.c:39-74). Dataset.distances routes these here."""
    if needs_policy(vtype, metric):
        return True
    return vtype is VectorType.F32 and metric in _LASSQ_METRICS


def policy_tile_rows(b: int, d: int) -> int:
    """Rows per tile of a policy evaluation for B queries of width d."""
    return max(1, min(POLICY_ROW_TILE, POLICY_CUBE_ELEMS // max(b * d, 1)))


def policy_pairwise(
    q: torch.Tensor,
    tile: torch.Tensor,
    metric: DistanceMetric,
    vtype: VectorType,
) -> torch.Tensor:
    """[B, N] float32 distances of q [B, d] to rows [N, d] under the
    reference's non-finite policies, evaluated policy_tile_rows rows at a
    time, with the reference's near-zero snap on every output (NaN and
    +-Inf pass through it)."""
    n = tile.shape[0]
    out = torch.empty((q.shape[0], n), dtype=torch.float32, device=tile.device)
    step = policy_tile_rows(q.shape[0], q.shape[1])
    for s in range(0, n, step):
        out[:, s : s + step] = _policy_impl(q, tile[s : s + step], metric, vtype)
    return _snap(out)


def _policy_impl(
    q: torch.Tensor,
    tile: torch.Tensor,
    metric: DistanceMetric,
    vtype: VectorType,
) -> torch.Tensor:
    x = q.float()[:, None, :]
    y = tile.float()[None, :, :]

    if vtype is VectorType.F32 and metric in _LASSQ_METRICS:
        # plain math, not LASSQ (src/distance-cpu.c:39-74): NaN propagates,
        # an unmatched Inf lane gives +Inf, matched Infs give inf-inf = NaN
        d = x - y
        s = (d * d).sum(-1)
        return sqrt_rn(s) if metric is DistanceMetric.L2 else s

    if metric in _LASSQ_METRICS:
        # LASSQ: NaN difference lanes and matched same-sign Inf lanes -> 0,
        # any unmatched Inf lane -> +Inf
        d = x - y
        matched = torch.isinf(x) & torch.isinf(y) & (torch.sign(x) == torch.sign(y))
        any_inf = ((torch.isinf(x) | torch.isinf(y)) & ~matched).any(-1)
        d = torch.where(torch.isnan(d) | matched, 0.0, d)
        s = torch.where(any_inf, torch.inf, (d * d).sum(-1))
        return sqrt_rn(s) if metric is DistanceMetric.L2 else s

    # the f16 lane-skip family (oracle.py `_distance_float`, F16 branch)
    lane_ok = ~(torch.isnan(x) | torch.isnan(y))

    if metric is DistanceMetric.L1:
        d = torch.where(lane_ok, (x - y).abs(), 0.0)
        matched = torch.isinf(x) & torch.isinf(y) & (torch.sign(x) == torch.sign(y))
        any_inf = ((torch.isinf(x) | torch.isinf(y)) & ~matched & lane_ok).any(-1)
        return torch.where(any_inf, torch.inf, d.sum(-1))

    if metric is DistanceMetric.DOT:
        p = torch.where(lane_ok, x * y, 0.0)
        inf_p = torch.isinf(p)
        s = torch.where(inf_p, 0.0, p).sum(-1)
        # the C kernel short-circuits on the FIRST infinite product and
        # returns -Inf of its sign (:414-421); argmax takes the first lane
        any_inf = inf_p.any(-1)
        first = inf_p.to(torch.uint8).argmax(-1, keepdim=True)
        sign = torch.sign(torch.gather(p, -1, first)[..., 0])
        return torch.where(any_inf, -sign * torch.inf, -s)

    # COSINE (:431-468): NaN lanes skipped, any Inf lane or a non-finite
    # denominator -> 1.0; the cosine clamped to [-1, 1]
    any_inf = ((torch.isinf(x) | torch.isinf(y)) & lane_ok).any(-1)
    xm = torch.where(lane_ok, x, 0.0)
    ym = torch.where(lane_ok, y, 0.0)
    dot = (xm * ym).sum(-1)
    denom = sqrt_rn((xm * xm).sum(-1)) * sqrt_rn((ym * ym).sum(-1))
    safe = torch.where(denom > 0.0, denom, 1.0)
    cos = (dot / safe).clamp(-1.0, 1.0)
    bad = ~(denom > 0.0) | ~torch.isfinite(denom) | ~torch.isfinite(dot) | any_inf
    return torch.where(bad, 1.0, 1.0 - cos)
