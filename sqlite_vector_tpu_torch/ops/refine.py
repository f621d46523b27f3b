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

from sqlite_vector_tpu_torch.ops.quantize4 import int4_scan_topk
from sqlite_vector_tpu_torch.ops.rerank import candidate_distances, rescore_topk
from sqlite_vector_tpu_torch.types import DistanceMetric
from sqlite_vector_tpu_torch.utils.profiling import count


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
    against the dequantized int8 rows and take the top-k
    (ops.rerank.rescore_topk). Returns (distances [B, k] float32, positions
    [B, k] int64), ascending, +inf / -1 padding."""
    dev = codes8.device
    # device tensors, so each op is an IEEE float32 divide / add
    sc = torch.tensor(np.float32(scale8), device=dev)
    off = torch.tensor(np.float32(offset8), device=dev)
    count("h2d_bytes", 8)
    qf = queries_f.float()

    def distances(s: int, e: int, rows: torch.Tensor) -> torch.Tensor:
        xhat = codes8[rows].float() / sc + off  # [e - s, ke, d]
        q = qf[s:e]
        if metric in (DistanceMetric.L2, DistanceMetric.SQUARED_L2):
            # the direct (q - xhat)^2 sum: no cancellation error near zero
            diff = q[:, None, :] - xhat
            return (diff * diff).sum(-1)
        return candidate_distances(q, xhat, metric)

    return rescore_topk(cand, k, metric, codes8.shape[0], codes8.shape[1], distances)


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
    row_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """int4-prefilter + int8-refine top-k.

    codes8 rows are positionally aligned with the packed int4 rows (both
    built from one row snapshot by Dataset.quantize(refine=True)). Stage 1
    is ops.quantize4.int4_scan_topk at k*expand, masked by row_mask ([N]
    bool, optional: the mask applies to stage 1 only, as in the JAX
    package); stage 2 refine_candidates. Same return contract as
    refine_candidates."""
    ke = max(k * expand, k)
    _, cand = int4_scan_topk(
        queries_f, packed, alpha, csq, metric, ke, dim=dim,
        valid_count=valid_count, row_mask=row_mask,
    )
    return refine_candidates(queries_f, cand, codes8, scale8, offset8, metric, k)
