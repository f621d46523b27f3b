"""Per-query instrumentation and torch.profiler integration.

Port of sqlite_vector_tpu/utils/profiling.py. `QueryStats`, `StatsRecorder`
and `timed_search` are the JAX package's, field for field; `profile_trace`
runs torch.profiler (CPU, plus CUDA when a card is present) and writes a
Chrome/Perfetto-readable trace (`*.pt.trace.json`) into its directory,
where the JAX package writes a TensorBoard trace with jax.profiler;
`annotate` is torch.profiler.record_function. Kernels launched through the
ctypes library (ops/_build.py) are CUPTI activity like any other: they
appear in the trace under their kernel names, on the device's stream,
linked to their launch by correlation id.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Iterator


@dataclasses.dataclass
class QueryStats:
    """Timing breakdown for one search call."""

    wall_s: float
    n_rows: int
    n_queries: int
    k: int
    exact: bool
    bytes_scanned: int
    # bytes of the candidate merge on a mesh (0 on one device): every row
    # shard's [B, k] float32 values and int32 positions gathered onto the
    # first device, 8 * shards * B * k (parallel.audit counts each merge in
    # GATHERED). On 2-D (rows x dim) meshes the per-scan sum of partial
    # components adds 4 * B * ceil(N / rows_shards) bytes — see timed_search.
    collective_bytes: int = 0

    @property
    def qps(self) -> float:
        return self.n_queries / self.wall_s if self.wall_s else float("inf")

    @property
    def gb_per_s(self) -> float:
        return self.bytes_scanned / self.wall_s / 1e9 if self.wall_s else 0.0

    def __str__(self) -> str:
        return (
            f"{self.n_queries}q x {self.n_rows} rows k={self.k} "
            f"{'exact' if self.exact else 'quantized'}: "
            f"{self.wall_s * 1000:.2f} ms ({self.qps:.1f} QPS, "
            f"{self.gb_per_s:.1f} GB/s)"
        )


# one profile_trace at a time per process, as jax.profiler.start_trace
_trace_lock = threading.Lock()
_trace_active = False


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of the region into `log_dir` (open it
    in Perfetto or chrome://tracing). The trace is written when the region
    ends, also when it raises. A second profile_trace while one is active
    raises RuntimeError."""
    global _trace_active
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    with _trace_lock:
        if _trace_active:
            raise RuntimeError(
                "Profile has already been started. Only one profile may be run at a time."
            )
        _trace_active = True
    try:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir)))
        prof.start()
        try:
            yield
        finally:
            prof.stop()  # runs the handler: the trace file is written here
    finally:
        with _trace_lock:
            _trace_active = False


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside an active profiler trace."""
    import torch.profiler

    with torch.profiler.record_function(name):
        yield


class StatsRecorder:
    """Optional ring buffer of recent QueryStats (attach as Dataset.stats_recorder)."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._entries: list[QueryStats] = []

    def add(self, stats: QueryStats) -> None:
        self._entries.append(stats)
        if len(self._entries) > self.capacity:
            self._entries.pop(0)

    @property
    def entries(self) -> list[QueryStats]:
        return list(self._entries)

    def summary(self) -> dict[str, Any]:
        if not self._entries:
            return {}
        import numpy as np

        walls = np.array([e.wall_s for e in self._entries])
        return {
            "count": len(self._entries),
            "median_ms": float(np.median(walls) * 1000),
            "p99_ms": float(np.percentile(walls, 99) * 1000),
            "total_queries": int(sum(e.n_queries for e in self._entries)),
        }


def timed_search(dataset, queries, k: int, *, exact: bool = True):
    """Run dataset.search with a QueryStats result attached (host clock:
    search returns host arrays, so the device has finished when it stops).

    Returns (ids, distances, stats)."""
    import numpy as np

    q = np.atleast_2d(np.asarray(queries))
    t0 = time.perf_counter()
    ids, dist = dataset.search(queries, k, exact=exact)
    wall = time.perf_counter() - t0
    # quantized scans count one byte an element, int4 codes too (as JAX)
    itemsize = 1 if not exact else dataset.dtype.itemsize
    coll = 0
    if getattr(dataset, "_mesh", None) is not None:
        from sqlite_vector_tpu_torch.parallel.audit import collective_bytes_per_query

        # Dataset._mesh_size is the ROWS-axis extent (the total device
        # count on a 1-D mesh): the merge gathers one candidate set a row
        # shard, and the dim-axis sum's block is [B, N / rows_shards]
        rows_shards = dataset._mesh_size
        coll = collective_bytes_per_query(rows_shards, q.shape[0], k)
        if getattr(dataset, "_mesh_2d", False):
            # 2-D meshes also sum the [B, N / rows_shards] float32 partial
            # block over the dim axis per scan (parallel.audit's dim_sum)
            coll += 4 * q.shape[0] * (-(-len(dataset) // rows_shards))
    stats = QueryStats(
        wall_s=wall,
        n_rows=len(dataset),
        n_queries=q.shape[0],
        k=k,
        exact=exact,
        bytes_scanned=len(dataset) * dataset.dimension * itemsize,
        collective_bytes=coll,
    )
    if getattr(dataset, "stats_recorder", None) is not None:
        dataset.stats_recorder.add(stats)
    return ids, dist, stats
