"""Per-query instrumentation, the port's own spans and counters, and
torch.profiler integration.

Port of sqlite_vector_tpu/utils/profiling.py. `QueryStats`, `StatsRecorder`
and `timed_search` are the JAX package's, field for field; `profile_trace`
runs torch.profiler (CPU, plus CUDA when a card is present) and writes a
Chrome/Perfetto-readable trace (`*.pt.trace.json`) into its directory,
where the JAX package writes a TensorBoard trace with jax.profiler.
Kernels launched through the ctypes library (ops/_build.py) are CUPTI
activity like any other: they appear in the trace under their kernel
names, on the device's stream, linked to their launch by correlation id.

`annotate(name, **attrs)` is the port's span. The serving, api and ops
layers open one around each stage of their work (PERF.md section 3 names
them). It does nothing unless recording is on (`start_recording()` ..
`stop_recording()`, or `with recording() as rec:`) or a torch profiler is
active. Recording keeps each span in memory (`Recording.spans`): its name,
start and end on `time.perf_counter_ns()`, its id and its parent's (the
innermost span open on its thread), its thread, its batch (a `batch`
attribute, else its parent's) and its attributes; `count(name, n)` adds to
`Recording.counters` and to the counts of the innermost open span of its
thread (a span's counts hold its children's). Under an active profiler the
span is also a profiler range named `svt.<name>` (`:<tag>` appended
where given; torch's RecordFunction, opened without releasing the
interpreter lock), so the spans land in the trace beside the kernels they
launch, on the profiler's clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Any, Iterator, NamedTuple

import torch.profiler
from torch.autograd import profiler as _autograd_profiler


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


class Span(NamedTuple):
    """One recorded span (times from time.perf_counter_ns)."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None  # the span open around it on its thread
    thread: int  # threading.get_ident()
    batch: int | None  # a `batch` attribute, else its parent's
    attrs: dict
    counts: dict | None  # count() on its thread while it was open

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class Recording:
    """What was recorded between start_recording() and stop_recording():
    `spans` in the order they ended, `counters` summed."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self._lock = threading.Lock()  # counters are added from every thread
        self._local = threading.local()  # each thread's stack of open spans

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]


_clock = time.perf_counter_ns
_ids = itertools.count(1)
_new_span = tuple.__new__  # Span(...) without its Python-level __new__: a third of the cost
_active: Recording | None = None
_active_lock = threading.Lock()


def start_recording() -> Recording:
    """Keep every span and counter from now on, until stop_recording().
    One recording at a time: a second start raises RuntimeError."""
    global _active
    with _active_lock:
        if _active is not None:
            raise RuntimeError("a recording is already on")
        _active = Recording()
        return _active


def stop_recording() -> Recording:
    """Stop recording; returns what was recorded. Spans still open end
    unrecorded."""
    global _active
    with _active_lock:
        rec, _active = _active, None
    if rec is None:
        raise RuntimeError("no recording is on")
    return rec


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """start_recording() .. stop_recording() around a region; yields the
    Recording, complete once the region ends."""
    rec = start_recording()
    try:
        yield rec
    finally:
        if _active is rec:
            stop_recording()


def is_recording() -> bool:
    return _active is not None


def stamp() -> int | None:
    """perf_counter_ns() while recording, else None (and no clock read)."""
    return _clock() if _active is not None else None


def count(name: str, n: int = 1) -> None:
    """Add n to a counter while recording; a no-op otherwise."""
    rec = _active
    if rec is None:
        return
    with rec._lock:
        rec.counters[name] = rec.counters.get(name, 0) + n
    stack = getattr(rec._local, "stack", None)
    if stack:
        top = stack[-1]
        if top.counts is None:
            top.counts = {}
        top.counts[name] = top.counts.get(name, 0) + n


def add_span(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Record a span measured elsewhere (a request's wait in a queue,
    stamped where it was queued), with no parent; a no-op when not
    recording."""
    rec = _active
    if rec is not None:
        rec.spans.append(
            Span(name, start_ns, end_ns, next(_ids), None, threading.get_ident(),
                 attrs.get("batch"), attrs, None)
        )


def _open_range(label: str):
    """A profiler range that keeps the interpreter lock.
    torch.profiler.record_function enters and exits through dispatcher
    ops, each of which releases the lock: under load (a dispatcher beside
    64 client threads) every span would then hand the lock to another
    thread and wait to get it back, up to the 5 ms switch interval.
    _RecordFunctionFast records the same range in C++ without releasing
    it (Chrome trace category `cpu_op`, where record_function's is
    `user_annotation`)."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    return fast(label) if fast is not None else torch.profiler.record_function(label)


class _Off:
    """The span while neither recording nor profiling: one shared object
    that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "tag", "attrs", "rec", "range", "id", "parent", "batch", "counts", "start", "end")

    def __init__(self, name: str, tag: Any, attrs: dict, rec: Recording | None):
        self.name, self.tag, self.attrs, self.rec = name, tag, attrs, rec
        self.range = None
        self.counts = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            label = self.name if self.name.startswith("svt.") else "svt." + self.name
            if self.tag is not None:
                label = f"{label}:{self.tag}"
            self.range = _open_range(label)
            self.range.__enter__()
        rec = self.rec
        if rec is not None:
            stack = getattr(rec._local, "stack", None)
            if stack is None:
                stack = rec._local.stack = []
            up = stack[-1] if stack else None
            self.id = next(_ids)
            self.parent = up.id if up is not None else None
            self.batch = self.attrs.get("batch", up.batch if up is not None else None)
            stack.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = end = _clock()
        rec = self.rec
        if rec is not None:
            stack = rec._local.stack
            stack.pop()
            if self.counts and stack:
                up = stack[-1]
                if up.counts is None:
                    up.counts = {}
                for k, v in self.counts.items():
                    up.counts[k] = up.counts.get(k, 0) + v
            if rec is _active:
                rec.spans.append(_new_span(Span, (
                    self.name, self.start, end, self.id, self.parent, threading.get_ident(),
                    self.batch, self.attrs, self.counts,
                )))
        if self.range is not None:
            self.range.__exit__(None, None, None)
        return False

    def set(self, **attrs) -> None:
        """Attributes known only once the span is open (a batch's size)."""
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        """Its duration on the clock, once it has ended."""
        return (self.end - self.start) / 1e9


def annotate(name: str, /, *, tag: Any = None, **attrs):
    """The port's span: a context manager over one stage of work (the
    module docstring says what it records). With neither recording nor a
    profiler on it reads two flags and returns a shared no-op."""
    rec = _active
    if rec is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, tag, attrs, rec)


def timed(name: str, /, **attrs) -> _Span:
    """annotate()'s span, built also with recording and profiling off, so
    that it always reads its clock: `seconds` is its duration once it has
    ended (a stage whose time the program reports itself,
    Dataset.last_rerank_decomposition)."""
    return _Span(name, None, attrs, _active)


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
