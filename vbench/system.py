"""The system under test, sqlite_vector_tpu_torch, set up as a
configuration's file describes it, and the calls a traffic mix drives.

The rows are drawn on the device chunk by chunk (data.row_chunks), copied
to the host through one pinned buffer (Dataset.add takes host arrays) and
added with ids 1..N; a quantized configuration then quantizes on the
device and preloads. From the program the harness takes its entry points
and, in a traced run, wraps two of them in ranges (`probe`).
"""

from __future__ import annotations

import functools
import time
from pathlib import Path

import numpy as np
import torch

from vbench import data
from vbench.spec import CHECKOUT
from vbench.tracing import SCAN, SEARCH


def load_program():
    """The port, imported from this checkout and nowhere else."""
    import sqlite_vector_tpu_torch as svt

    if CHECKOUT not in Path(svt.__file__).resolve().parents:
        raise ImportError(f"sqlite_vector_tpu_torch came from {svt.__file__}, outside the checkout")
    return svt


class System:
    def __init__(self, svt, cfg: dict, traffic: dict, seed: int, device):
        self.svt, self.cfg, self.traffic, self.seed = svt, cfg, traffic, seed
        self.device = torch.device(device)
        self.ds = None
        self.searcher = None
        self.calls: list = []  # (start, end, B) of each search, in a traced run
        self._restore = None

    def build(self, parts: dict) -> np.ndarray:
        """The dataset and the query pool; the seconds of each part of
        set-up go into `parts`."""
        cfg, tr = self.cfg, self.traffic
        n, d = cfg["rows"], cfg["dim"]
        t = time.perf_counter()
        opts = self.svt.parse_options(f"dimension={d},type={cfg['type']},distance={cfg['metric']}")
        self.ds = self.svt.Dataset(cfg["name"], opts, device=self.device, storage=cfg.get("storage", "hbm"))
        plan = data.QueryPlan(self.seed, n, d, tr["pool"], tr["near_share"], tr["near_noise"], self.device)
        cuda = self.device.type == "cuda"
        host = torch.empty((min(data.ROW_CHUNK, n), d), dtype=torch.float32, pin_memory=cuda)
        parts["dataset_s"] = time.perf_counter() - t
        parts["draw_s"] = parts["add_s"] = 0.0
        t = time.perf_counter()
        for start, rows in data.row_chunks(self.seed, n, d, self.device):
            m = rows.shape[0]
            plan.take(start, rows)
            host[:m].copy_(rows)
            del rows
            t1 = time.perf_counter()
            parts["draw_s"] += t1 - t
            self.ds.add(host[:m].numpy(), np.arange(start + 1, start + m + 1, dtype=np.int64))
            t = time.perf_counter()
            parts["add_s"] += t - t1
        del host
        pool = plan.queries()
        parts["draw_s"] += time.perf_counter() - t
        quant = cfg.get("quantize")
        if quant:
            t = time.perf_counter()
            self.ds.quantize(qtype=quant["qtype"], refine=bool(quant.get("refine", False)))
            _sync(self.device)
            parts["quantize_s"] = time.perf_counter() - t
            if cfg.get("preload"):
                t = time.perf_counter()
                self.ds.preload()
                _sync(self.device)
                parts["preload_s"] = time.perf_counter() - t
        return pool

    def first_search(self, query: np.ndarray) -> None:
        """One search, which loads the kernels (or, in a new checkout,
        builds them)."""
        self.ds.search(query, self.cfg["k"], mode=self.cfg["mode"])

    def entry(self):
        """The mix's entry point, call(query) -> (ids, distances): the
        dataset's search, or a BatchingSearcher's submit and the wait for
        its Future."""
        k, mode, tr = self.cfg["k"], self.cfg["mode"], self.traffic
        if tr["entry"] == "search":
            ds = self.ds
            return lambda q: ds.search(q, k, mode=mode)
        if tr["entry"] == "batching":
            self.searcher = self.svt.BatchingSearcher(
                self.ds, max_batch=tr["max_batch"], max_wait_ms=tr["max_wait_ms"]
            )
            sub = self.searcher.submit
            return lambda q: sub(q, k, mode=mode).result()
        raise ValueError(f"unknown entry {tr['entry']!r}")

    def probe(self, tracer) -> None:
        """Wrap the dataset's search (range `vbench.search:<B>`, its host
        span kept in self.calls, the tracer polled on the search's thread)
        and the scan's block minima (range `vbench.scan:<B>`)."""
        from torch.profiler import record_function

        import sqlite_vector_tpu_torch.ops.block_scan as block_scan

        inner, calls = self.ds.search, self.calls

        def search(queries, k, **kw):
            tracer.poll()
            b = 1 if np.ndim(queries) == 1 else len(queries)
            t0 = time.perf_counter()
            with record_function(f"{SEARCH}{b}"):
                out = inner(queries, k, **kw)
            calls.append((t0, time.perf_counter(), b))
            return out

        minima = block_scan.block_minima

        @functools.wraps(minima)
        def block_minima(queries, *a, **kw):
            with record_function(f"{SCAN}{queries.shape[0]}"):
                return minima(queries, *a, **kw)

        self.ds.search = search
        block_scan.block_minima = block_minima
        self._restore = (block_scan, minima)

    def close(self) -> None:
        """Stop serving and free the program's state."""
        if self.searcher is not None:
            self.searcher.close()
            self.searcher = None
        if self._restore is not None:
            mod, fn = self._restore
            mod.block_minima = fn
            self._restore = None
        self.ds = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
