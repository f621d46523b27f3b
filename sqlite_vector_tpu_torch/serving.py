"""Serving layer: concurrent query coalescing and an HTTP endpoint.

Port of sqlite_vector_tpu/serving.py. The reference serves one query per
virtual-table scan on the caller's thread (src/sqlite-vector.c:1723-1817);
on the card a B=64 scan reads the matrix once, as B=1 does, so the
coalescer gathers concurrent queries into one search.

`BatchingSearcher`: callers submit queries from any thread and get
futures; a dispatcher thread drains the queue, runs one Dataset.search per
(k, mode) group and hands out the per-query results. The JAX package pads
each batch to a bucket size so that XLA compiles few shapes; the kernels
here take any batch, so the live batch is dispatched as it is. Either way
a query gets the neighbors it gets alone, integer-domain values bit for
bit and float values within the rounding of the batch's product shape.
The dispatcher issues its work on the dataset's device, on the stream that
was current there in the thread that built the searcher: work that thread
queued before (an add()'s row writes on a side stream of its own, say) is
ordered before every search, as it would be for a search made on that
thread.

`serve()` exposes a Dataset or a VectorStore over JSON/HTTP (stdlib only).
"""

from __future__ import annotations

import contextlib
import json
import queue
import threading
from concurrent.futures import Future
from typing import Any

import numpy as np
import torch

from sqlite_vector_tpu_torch.dataset import Dataset, VectorStore
from sqlite_vector_tpu_torch.errors import VectorStateError

# the batch sizes the JAX package pads to; here the cap on max_batch and
# the batches `python -m sqlite_vector_tpu_torch warm` visits
_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


class BatchingSearcher:
    """Thread-safe query coalescer over one Dataset.

    submit() may be called from any number of threads; queries queued within
    `max_wait_ms` of each other (up to `max_batch`) share one search.
    """

    def __init__(
        self,
        dataset: Dataset,
        *,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        fallback_exact: bool = False,
    ):
        """fallback_exact: when a quantized or rerank group fails because
        the quantization is momentarily absent (a drop_quantization +
        quantize window; the reference errors the same way while its shadow
        table is missing), re-run that group as an exact scan instead of
        handing VectorStateError to every waiter. Off by default (error
        parity)."""
        self.dataset = dataset
        self.max_batch = min(max_batch, _BUCKETS[-1])
        self.max_wait_s = max_wait_ms / 1000.0
        self.fallback_exact = fallback_exact
        dev = dataset.device
        self._stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        self._queue: queue.Queue = queue.Queue()
        self._closed = False
        # serializes submit()'s closed-check-then-enqueue against close():
        # otherwise a racing submit could enqueue after close()'s drain and
        # block its caller on Future.result() forever
        self._lifecycle_lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, query: Any, k: int, *, exact: bool = True, mode: str | None = None) -> Future:
        """Enqueue one query; resolves to (ids [k], distances [k]).

        mode overrides `exact` with the Dataset.search mode set (exact |
        quantized | rerank | refine | approx); queries coalesce only with
        peers of the same (k, mode)."""
        if mode is None:
            mode = "exact" if exact else "quantized"
        q, _ = self.dataset._coerce_queries(query)
        if q.shape[0] != 1:
            raise ValueError(
                "submit() takes a single query; for batches call "
                "Dataset.search(queries, k) directly"
            )
        fut: Future = Future()
        with self._lifecycle_lock:
            if self._closed:
                raise RuntimeError("BatchingSearcher is closed")
            self._queue.put((q[0], k, mode, fut))
        return fut

    def search(self, query: Any, k: int, *, exact: bool = True, mode: str | None = None):
        """Blocking convenience wrapper around submit()."""
        return self.submit(query, k, exact=exact, mode=mode).result()

    def close(self) -> None:
        with self._lifecycle_lock:
            self._closed = True
            self._queue.put(None)
        self._thread.join(timeout=5)
        # a submit() that won the race enqueued before the sentinel: fail
        # the leftover futures instead of leaving their callers blocked
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            fut = item[-1]
            # claim, then set: a racing fut.cancel() would otherwise make
            # set_exception raise InvalidStateError
            if fut.set_running_or_notify_cancel():
                fut.set_exception(RuntimeError("BatchingSearcher is closed"))
        if self._thread.is_alive():
            # the dispatcher outlived the join (a long search) and the drain
            # may have taken its sentinel: re-arm it, so the thread exits
            # and drops its Dataset reference when the search ends
            self._queue.put(None)

    # -- dispatcher -----------------------------------------------------------

    def _run(self) -> None:
        with torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext():
            while True:
                item = self._queue.get()
                if item is None:
                    return
                batch = [item]
                # coalesce: wait up to max_wait_s for more queries
                deadline = None
                while len(batch) < self.max_batch:
                    try:
                        nxt = self._queue.get(timeout=self.max_wait_s if deadline is None else deadline)
                    except queue.Empty:
                        break
                    if nxt is None:
                        self._dispatch(batch)
                        return
                    batch.append(nxt)
                    deadline = 0.0  # drain whatever is already queued
                self._dispatch(batch)

    def _dispatch(self, batch: list) -> None:
        # group by (k, mode): different k values and modes need separate scans
        groups: dict[tuple[int, str], list] = {}
        for q, k, mode, fut in batch:
            groups.setdefault((k, mode), []).append((q, fut))
        for (k, mode), items in groups.items():
            # claim every future FIRST: after set_running_or_notify_cancel
            # returns True a racing cancel() is a no-op, so set_result and
            # set_exception below never raise mid-loop (which would drop
            # batch-mates' results and could kill this thread); futures
            # already cancelled by their callers drop out here
            live = [(q, fut) for q, fut in items if fut.set_running_or_notify_cancel()]
            if not live:
                continue
            try:
                qs = np.stack([q for q, _ in live])
                try:
                    ids, dist = self.dataset.search(qs, k, mode=mode)
                except VectorStateError:
                    if not (self.fallback_exact and mode in ("quantized", "rerank")):
                        raise
                    # requantization window: serve exact results instead
                    ids, dist = self.dataset.search(qs, k, mode="exact")
                for i, (_, fut) in enumerate(live):
                    keep = ids[i] >= 0
                    fut.set_result((ids[i][keep], dist[i][keep]))
            except Exception as e:  # to every waiter of the group
                for _, fut in live:
                    if not fut.done():
                        fut.set_exception(e)


def _dataset_stats(ds: Dataset) -> dict:
    return {
        "count": len(ds),
        "dimension": ds.dimension,
        "dtype": ds.dtype.value,
        "metric": ds.metric.value,
        "quantized": ds.is_quantized,
        "memory_bytes": ds.memory_bytes(),
    }


def serve(
    source,
    host: str = "127.0.0.1",
    port: int = 8377,
    *,
    max_batch: int = 64,
    max_wait_ms: float = 2.0,
    fallback_exact: bool = False,
    max_request_bytes: int = 32 * 1024 * 1024,
):
    """Serve a Dataset, or a whole VectorStore, over JSON/HTTP.

    A VectorStore routes requests by dataset name, each dataset with its
    own lazily created BatchingSearcher. Returns the started HTTPServer;
    stop it with server.close(). A request body over max_request_bytes gets
    413 without being read.

    POST /search   {"vector": [...], "k": 10, "exact": true,
                    "mode": "exact|quantized|rerank|refine|approx" (optional),
                    "dataset": "name" (stores; optional when only one)}
                   -> {"ids": [...], "distances": [...]}
    POST /add      {"vectors": [[...], ...], "dataset": ...} -> {"ids": [...]}
    GET  /stats    -> the dataset's stats, or {"datasets": {name: stats}}
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    store = source if isinstance(source, VectorStore) else None
    single = None if store is not None else source
    searchers: dict[int, BatchingSearcher] = {}
    searchers_lock = threading.Lock()

    def resolve(req: dict) -> Dataset:
        if store is None:
            return single
        name = req.get("dataset")
        if name is None:
            names = store.names()
            if len(names) == 1:
                return store.get(names[0])
            raise ValueError(f"'dataset' is required (store serves {sorted(names)})")
        return store.get(name)

    def searcher_for(ds: Dataset) -> BatchingSearcher:
        stale = []
        with searchers_lock:
            s = searchers.get(id(ds))
            if s is None:
                if store is not None:
                    # evict the coalescers of datasets dropped from the
                    # store: each holds a thread and a strong reference to
                    # its dataset (and so its device memory)
                    active = set()
                    for n in store.names():
                        try:
                            active.add(id(store.get(n)))
                        except VectorStateError:
                            pass
                    for key in [k for k in searchers if k not in active]:
                        stale.append(searchers.pop(key))
                s = BatchingSearcher(
                    ds, max_batch=max_batch, max_wait_ms=max_wait_ms,
                    fallback_exact=fallback_exact,
                )
                searchers[id(ds)] = s
        # close() joins a dispatcher: outside the lock
        for old in stale:
            old.close()
        return s

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            try:
                if self.path == "/stats":
                    if store is not None:
                        stats = {}
                        for n in store.names():
                            try:
                                stats[n] = _dataset_stats(store.get(n))
                            except VectorStateError:
                                continue  # dropped between names() and get()
                        self._reply(200, {"datasets": stats})
                    else:
                        self._reply(200, _dataset_stats(single))
                else:
                    self._reply(404, {"error": "unknown path"})
            except Exception as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        def do_POST(self):
            try:
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    n = -1
                if n < 0:
                    # rfile.read(-1) would block until the peer's EOF
                    self.close_connection = True
                    self._reply(400, {"error": "invalid Content-Length"})
                    return
                if n > max_request_bytes:
                    # refuse before reading the body; close the connection
                    # (the unread body would desync keep-alive parsing)
                    self.close_connection = True
                    self._reply(
                        413,
                        {"error": f"request body {n} bytes exceeds the "
                         f"{max_request_bytes}-byte limit"},
                    )
                    return
                req = json.loads(self.rfile.read(n) or b"{}")
                ds = resolve(req)
                if self.path == "/search":
                    vec = np.asarray(req["vector"], np.float32)
                    ids, dist = searcher_for(ds).search(
                        vec, int(req.get("k", 10)),
                        exact=bool(req.get("exact", True)), mode=req.get("mode"),
                    )
                    self._reply(200, {"ids": ids.tolist(), "distances": [float(d) for d in dist]})
                elif self.path == "/add":
                    ids = ds.add(np.asarray(req["vectors"], np.float32))
                    self._reply(200, {"ids": ids.tolist()})
                else:
                    self._reply(404, {"error": "unknown path"})
            except Exception as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

    server = ThreadingHTTPServer((host, port), Handler)

    def _close_searchers():
        with searchers_lock:
            for s in searchers.values():
                s.close()

    def _close():
        _close_searchers()
        server.shutdown()
        server.server_close()  # release the listening socket

    class _SearcherHandle:
        # server.searcher.close() closes every coalescer
        def close(self_inner):
            _close_searchers()

    server.close = _close
    server.searcher = _SearcherHandle()
    server._searchers = searchers  # introspection (tests)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
