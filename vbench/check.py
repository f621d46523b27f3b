"""How `correct` is decided: the answers the window's requests received,
judged against the configuration's plain reference once the window has
closed.

Every answer is checked for its form (k distinct row ids in range, finite
distances in ascending order); a request that raised or came back malformed
counts in `bad_answers`. A sample of the answers drawn from the seed is
then judged by what it says: the reference draws the rows again from the
seed, chunk by chunk on the device, and computes every distance of each
sampled query in float64. Two numbers are compared with the limits the
configuration states (`check` in its file):

  dist_err  the widest gap between a distance the program reported and the
            reference's distance of the same query to the same row;
  rank_gap  the widest gap, rank by rank, between the reference's distances
            of the rows the program returned (sorted) and the reference's
            own top k: 0 for the true top k, whatever the order of ties.
"""

from __future__ import annotations

import numpy as np
import torch

from vbench import data

SAMPLE = 256  # answers judged a run


def well_formed(answer, k: int, n: int) -> bool:
    if answer is None:
        return False
    ids, dist = answer
    ids, dist = np.asarray(ids), np.asarray(dist)
    return (
        ids.shape == (k,) and dist.shape == (k,)
        and bool(((ids >= 1) & (ids <= n)).all())
        and len(np.unique(ids)) == k
        and bool(np.isfinite(dist).all())
        and bool((np.diff(dist) >= 0).all())
    )


def scan(ref, seed: int, cfg: dict, device, queries: np.ndarray, k: int, reported: np.ndarray | None = None):
    """One pass of `ref` over every row: its top k (distances [S, k]
    float64 ascending, 0-based positions [S, k]) for each query, and its
    distances to the `reported` positions [S, k] where given."""
    n, d = cfg["rows"], cfg["dim"]
    device = torch.device(device)
    ref.fit(data.row_chunks(seed, n, d, device))
    qe = ref.queries(torch.as_tensor(queries, device=device))
    s = queries.shape[0]
    best = torch.full((s, k), torch.inf, dtype=torch.float64, device=device)
    pos = torch.full((s, k), -1, dtype=torch.int64, device=device)
    rep = None if reported is None else torch.as_tensor(reported, device=device)
    at = torch.full((s, k), torch.nan, dtype=torch.float64, device=device)
    for start, rows in data.row_chunks(seed, n, d, device):
        dist = ref.distances(qe, rows)
        m = dist.shape[1]
        allv = torch.cat([best, dist], 1)
        allp = torch.cat([pos, torch.arange(start, start + m, device=device).expand(s, m)], 1)
        best, j = torch.topk(allv, k, dim=1, largest=False, sorted=True)
        pos = allp.gather(1, j)
        if rep is not None:
            rel = rep - start
            inside = (rel >= 0) & (rel < m)
            at = torch.where(inside, dist.gather(1, rel.clamp(0, m - 1)), at)
        del dist, allv, allp
    return best, pos, at


def judge(answers: list, ref, seed: int, cfg: dict, device) -> dict:
    """The numbers compared, each {"value", "limit"}, for the window's
    answers: [(pool index, query, answer or None)], in submit order."""
    k, n = cfg["k"], cfg["rows"]
    ok = [well_formed(a, k, n) for _, _, a in answers]
    good = [i for i, g in enumerate(ok) if g]
    out = {"bad_answers": {"value": len(ok) - len(good), "limit": 0}}
    if not good:
        return out
    pick = [good[i] for i in data.sample(seed, len(good), SAMPLE)]
    q = np.stack([answers[i][1] for i in pick]).astype(np.float32)
    ids = np.stack([np.asarray(answers[i][2][0], np.int64) for i in pick])
    dist = np.stack([np.asarray(answers[i][2][1], np.float32) for i in pick]).astype(np.float64)
    best, _, at = scan(ref, seed, cfg, device, q, k, ids - 1)
    best, at = best.cpu().numpy(), at.cpu().numpy()
    limits = cfg["check"]
    out["dist_err"] = {"value": float(np.abs(dist - at).max()), "limit": limits["dist_err"]}
    out["rank_gap"] = {"value": float((np.sort(at, 1) - best).max()), "limit": limits["rank_gap"]}
    return out


def correct(numbers: dict) -> bool:
    return len(numbers) == 3 and all(v["value"] <= v["limit"] for v in numbers.values())


def control_answers(ctrl, seed: int, cfg: dict, device, queries: np.ndarray) -> list:
    """The control's answers to `queries`: its top k, ids 1-based and
    distances in float32, as the program reports them."""
    best, pos, _ = scan(ctrl, seed, cfg, device, queries, cfg["k"])
    best, pos = best.float().cpu().numpy(), pos.cpu().numpy()
    return [(i, queries[i], (pos[i] + 1, best[i])) for i in range(len(queries))]
