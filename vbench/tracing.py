"""The traced slice of a `--trace 1` run and its reduction to numbers.

The harness wraps the dataset's `search` (range `vbench.search:<B>`) and
`ops.block_scan.block_minima` (range `vbench.scan:<B>`) in
`record_function` ranges. torch.profiler records CPU ops and ranges only on
the thread that started it, so the profiler is started and stopped inside
the search wrapper, on the thread that makes the searches (the
BatchingSearcher's dispatcher, or the serial client). CUPTI records the
device's kernels, copies and memsets, and the runtime calls that launched
them, from every thread.

A device op belongs to a range when the runtime call that launched it
(same correlation id) ran inside the range on the range's thread: device
timestamps are never compared with host ranges.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import threading
import time
from dataclasses import dataclass, field

from vbench.stats import busy_us, merged

SEARCH = "vbench.search:"
SCAN = "vbench.scan:"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Tracer:
    """Profiles `seconds` of searches after `start_at` (perf_counter), on
    the thread that makes them; `settle` seconds after the profiler starts
    are traced but left out of the slice."""

    def __init__(self, start_at: float, seconds: float, settle: float, cuda: bool):
        self.start_at, self.seconds, self.settle, self.cuda = start_at, seconds, settle, cuda
        self.done = threading.Event()
        self.prof = None
        self._stop_at = None

    def poll(self) -> None:
        """Called at the start of every search, on its thread."""
        if self.done.is_set():
            return
        now = time.perf_counter()
        if self.prof is None and now >= self.start_at:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self._stop_at = time.perf_counter() + self.settle + self.seconds
        elif self.prof is not None and now >= self._stop_at:
            self.prof.__exit__(None, None, None)
            self.done.set()

    def events(self) -> dict:
        """The trace as Chrome's JSON, read back from a temporary file."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)
        finally:
            os.unlink(path)


@dataclass
class Summary:
    n_calls: int = 0
    slice_s: float = 0.0
    busy_s: float = 0.0
    scan_batches: list = field(default_factory=list)  # B of each scan range
    device_ops: int = 0  # device ops launched inside the slice's calls
    search_device_s: float = 0.0  # their summed durations
    scan_device_s: float = 0.0  # those launched inside scan ranges
    h2d_bytes: float = 0.0
    top_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def _label(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]+", "_", name).strip("_")[:96]


class _Ranges:
    """One thread's ranges of one kind, sorted, for stabbing queries."""

    def __init__(self, ranges):
        self.r = sorted(ranges)
        self.starts = [s for s, _, _ in self.r]

    def find(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        # ranges of one kind on one thread do not overlap, so only the last
        # range starting at or before t can hold it
        if i >= 0 and t <= self.r[i][1]:
            return i
        return None


def summarize(trace: dict, settle_us: float = 0.0) -> Summary:
    """Reduce a Chrome trace of the slice to the numbers the per-layer
    metrics read: calls are the search ranges that start `settle_us` after
    the first one; the slice runs from the first such call's start to the
    last one's end."""
    ev = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X" and "ts" in e]
    out = Summary()
    search = [e for e in ev if e.get("cat") == "user_annotation" and e["name"].startswith(SEARCH)]
    if not search:
        return out
    t_first = min(e["ts"] for e in search) + settle_us
    search = [e for e in search if e["ts"] >= t_first]
    if not search:
        return out
    lo = min(e["ts"] for e in search)
    hi = max(e["ts"] + e["dur"] for e in search)
    out.n_calls = len(search)
    out.slice_s = (hi - lo) * 1e-6

    by_tid: dict = {}
    for i, e in enumerate(search):
        by_tid.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"], i))
    calls = {tid: _Ranges(r) for tid, r in by_tid.items()}
    scans: dict = {}
    for e in ev:
        if (e.get("cat") == "user_annotation" and e["name"].startswith(SCAN)
                and e["tid"] in calls and calls[e["tid"]].find(e["ts"]) is not None):
            b = int(e["name"][len(SCAN):])
            scans.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"], b))
            out.scan_batches.append(b)
    scan_ranges = {tid: _Ranges(r) for tid, r in scans.items()}

    # launches inside a counted call -> whether inside a scan range too, by
    # correlation id
    owner: dict = {}
    for e in ev:
        if e.get("cat") not in _LAUNCH_CATS or e["tid"] not in calls:
            continue
        corr = e.get("args", {}).get("correlation")
        if corr is None or calls[e["tid"]].find(e["ts"]) is None:
            continue
        sr = scan_ranges.get(e["tid"])
        owner[corr] = sr is not None and sr.find(e["ts"]) is not None

    device = [e for e in ev if e.get("cat") in _DEVICE_CATS]
    spans, per_name = [], {}
    for e in device:
        s, t = e["ts"], e["ts"] + e["dur"]
        if t > lo and s < hi:
            spans.append((max(s, lo), min(t, hi)))
            per_name[e["name"]] = per_name.get(e["name"], 0.0) + e["dur"] * 1e-6
        inside = owner.get(e.get("args", {}).get("correlation"))
        if inside is None:
            continue
        out.device_ops += 1
        out.search_device_s += e["dur"] * 1e-6
        if inside:
            out.scan_device_s += e["dur"] * 1e-6
        if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]:
            out.h2d_bytes += float(e.get("args", {}).get("bytes", 0))
    out.busy_s = busy_us(spans) * 1e-6
    out.top_ops = sorted(([_label(n), s] for n, s in per_name.items()), key=lambda x: -x[1])[:10]
    out.idle_gaps = _idle_gaps(ev, merged(spans), lo, hi, set(calls))
    return out


def _idle_gaps(ev, busy, lo, hi, tids) -> list:
    """Seconds the device sat idle in the slice, by what the searching
    thread was doing then: the innermost host event (op, runtime call or
    range) covering each stretch of each gap."""
    host = sorted(
        (e["ts"], e["ts"] + e["dur"], e["name"])
        for e in ev if e.get("cat") in _HOST_CATS and e["tid"] in tids
    )
    starts = [h[0] for h in host]
    longest = max((h[1] - h[0] for h in host), default=0.0)
    gaps, prev = [], lo
    for s, e in busy + [(hi, hi)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    by: dict = {}
    for a, b in gaps:
        i0 = bisect.bisect_left(starts, a - longest)
        i1 = bisect.bisect_left(starts, b)
        cand = [h for h in host[i0:i1] if h[1] > a]
        cuts = sorted({a, b} | {t for h in cand for t in h[:2] if a < t < b})
        for x, y in zip(cuts, cuts[1:]):
            mid = (x + y) / 2
            cover = [h for h in cand if h[0] <= mid < h[1]]
            if cover:
                name = max(cover, key=lambda h: h[0])[2]
                label = "host:python_inside_the_search" if name.startswith(SEARCH) else (
                    "host:python_inside_the_scan" if name.startswith(SCAN) else name)
            else:
                label = "host:between_searches"
            by[label] = by.get(label, 0.0) + (y - x) * 1e-6
    return sorted(([_label(n), s] for n, s in by.items()), key=lambda x: -x[1])[:10]
