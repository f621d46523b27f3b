"""Statistics of a window and of a traced slice."""

from __future__ import annotations

import numpy as np


def percentile(values, p: float) -> float:
    """The p-th percentile of every value (numpy's linear interpolation
    between closest ranks). A failed request's +inf stands as 1e300, so
    that a percentile among failures reads huge rather than NaN."""
    v = np.asarray(values, np.float64)
    return float(np.percentile(np.where(np.isinf(v), 1e300, v), p))


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals: the device's busy
    time, microseconds, over its events' intervals (copied from
    tools/profile_torch_search.py)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(spans) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]
