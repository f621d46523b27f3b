"""Top-k selection and merge (plain PyTorch).

Port of sqlite_vector_tpu/ops/topk.py. Tie behavior is the contract: the
reference keeps the first-scanned row among equal distances, and the JAX
package gets that from lax.top_k's lower-index preference. torch.topk
promises no order among ties, so selection here is a stable ascending
sort: equal distances keep their index order and the earliest row wins.
"""

from __future__ import annotations

import torch


def _pad_k(
    vals: torch.Tensor, idx: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    kk = vals.shape[-1]
    if kk >= k:
        return vals, idx
    shape = (*vals.shape[:-1], k - kk)
    vals = torch.cat([vals, vals.new_full(shape, torch.inf)], dim=-1)
    idx = torch.cat([idx, idx.new_full(shape, -1)], dim=-1)
    return vals, idx


def topk_ascending(
    distances: torch.Tensor, k: int, ids: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (values, indices) of the k smallest distances, ascending.

    distances: [..., N]; ids (optional): [N] row ids to gather instead of
    positional indices. If k > N the result is padded with +inf / -1.
    """
    kk = min(k, distances.shape[-1])
    vals, idx = torch.sort(distances, dim=-1, stable=True)
    vals, idx = vals[..., :kk], idx[..., :kk]
    if ids is not None:
        idx = ids[idx]
    return _pad_k(vals, idx, k)


def merge_topk(
    vals_a: torch.Tensor,
    ids_a: torch.Tensor,
    vals_b: torch.Tensor,
    ids_b: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two candidate sets [..., ka] and [..., kb] into the k best.

    `a` is the running (earlier-scanned) set and wins ties.
    """
    vals = torch.cat([vals_a, vals_b], dim=-1)
    ids = torch.cat([ids_a, ids_b], dim=-1)
    kk = min(k, vals.shape[-1])
    out, pos = torch.sort(vals, dim=-1, stable=True)
    return out[..., :kk], torch.gather(ids, -1, pos[..., :kk])
