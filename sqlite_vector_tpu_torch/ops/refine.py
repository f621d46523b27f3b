"""Device-side two-stage search: int4 prefilter + int8-sidecar refine.

Port of sqlite_vector_tpu/ops/refine.py. The int4 scan (K2 on CUDA
tensors) hands its top-(k*expand) candidate positions to a rescore of the
SAME rows' int8 codes, dequantized as c / scale8 + offset8 against the
original float32 query; no host round trip and no full-precision matrix.
Distances are original-domain at int8 fidelity; positions index the
quantize-time snapshot.
"""

from __future__ import annotations

import numpy as np
import torch

from sqlite_vector_tpu_torch.ops.distance import NEARLY_ZERO, sqrt_rn
from sqlite_vector_tpu_torch.ops.quantize4 import int4_scan_topk
from sqlite_vector_tpu_torch.ops.rerank import candidate_distances
from sqlite_vector_tpu_torch.ops.topk import topk_ascending
from sqlite_vector_tpu_torch.types import DistanceMetric

# bound on the gathered [queries, k*expand, d] candidate block (elements)
_RESCORE_CHUNK_ELEMS = 1 << 26


def _snap(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d.abs() <= NEARLY_ZERO, 0.0, d)


def refine_candidates(
    queries_f: torch.Tensor,
    cand: torch.Tensor,
    codes8: torch.Tensor,
    scale8: float | np.float32,
    offset8: float | np.float32,
    metric: DistanceMetric,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 2: rescore candidate positions cand [B, ke] (-1 padded, ke >= k)
    against the dequantized int8 rows and take the top-k. Returns
    (distances [B, k] float32, positions [B, k] int64), ascending,
    +inf / -1 padding."""
    # ascending row order for tie parity with the scan paths (the earliest
    # row wins equal distances); the -1 padding sorts first, masked below
    cand = torch.sort(cand, dim=-1).values
    safe = cand.clamp(0, codes8.shape[0] - 1)
    dev = codes8.device
    # device tensors, so each op is an IEEE float32 divide / add
    sc = torch.tensor(np.float32(scale8), device=dev)
    off = torch.tensor(np.float32(offset8), device=dev)
    qf = queries_f.float()
    b, ke = cand.shape
    bq = max(1, _RESCORE_CHUNK_ELEMS // max(ke * codes8.shape[1], 1))
    parts = []
    for s in range(0, b, bq):
        xhat = codes8[safe[s : s + bq]].float() / sc + off  # [bq, ke, d]
        q = qf[s : s + bq]
        if metric in (DistanceMetric.L2, DistanceMetric.SQUARED_L2):
            # the direct (q - xhat)^2 sum: no cancellation error near zero
            diff = q[:, None, :] - xhat
            parts.append((diff * diff).sum(-1))
        else:
            parts.append(candidate_distances(q, xhat, metric))
    d = _snap(torch.cat(parts))
    d = torch.where(torch.isnan(d), torch.inf, d)
    d = torch.where(cand >= 0, d, torch.inf)
    vals, pos = topk_ascending(d, k)
    idx = torch.gather(cand, 1, pos)
    if metric is DistanceMetric.L2:
        vals = sqrt_rn(vals)
    vals = _snap(vals)
    return vals, torch.where(torch.isposinf(vals), -1, idx)


def int4_refine_topk(
    queries_f: torch.Tensor,
    packed: torch.Tensor,
    alpha: torch.Tensor,
    csq: torch.Tensor,
    codes8: torch.Tensor,
    scale8: float | np.float32,
    offset8: float | np.float32,
    metric: DistanceMetric,
    k: int,
    *,
    dim: int,
    expand: int = 4,
    valid_count: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """int4-prefilter + int8-refine top-k.

    codes8 rows are positionally aligned with the packed int4 rows (both
    built from one row snapshot by Dataset.quantize(refine=True)). Stage 1
    is ops.quantize4.int4_scan_topk at k*expand; stage 2 refine_candidates.
    Same return contract as refine_candidates."""
    ke = max(k * expand, k)
    _, cand = int4_scan_topk(
        queries_f, packed, alpha, csq, metric, ke, dim=dim, valid_count=valid_count
    )
    return refine_candidates(queries_f, cand, codes8, scale8, offset8, metric, k)
