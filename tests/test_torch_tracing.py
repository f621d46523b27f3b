"""The port's own spans and counters (sqlite_vector_tpu_torch.utils.profiling):
off, a search and a BatchingSearcher round trip read no clock for tracing,
build no span and open no profiler range; recording, the spans of a search
and of a batch, their nesting, parents and batch ids, the serving counters
and the host-to-device byte counter; under profile_trace, the same spans
as `svt.*` ranges. CPU only: the spans are host code on every device."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

import sqlite_vector_tpu_torch as svt
from sqlite_vector_tpu_torch.utils import profile_trace, profiling
from sqlite_vector_tpu_torch.utils.timing import trace

D = 24
SEARCH_CHILDREN = ["search.prepare", "search.mask", "search.query", "search.scan", "search.d2h", "search.ids"]
SCAN_CHILDREN = ["ops.scan", "ops.finish"]


def _dataset(qtype=None, refine=False, n=1000, metric="COSINE"):
    ds = svt.VectorStore(device="cpu").create("t", f"dimension={D},type=FLOAT32,distance={metric}")
    ds.add(np.random.default_rng(0).standard_normal((n, D)).astype(np.float32))
    if qtype:
        ds.quantize(qtype=qtype, refine=refine)
    return ds


def _queries(b, seed=1):
    return np.random.default_rng(seed).standard_normal((b, D)).astype(np.float32)


def _tree(spans):
    """{span id: span} and {parent id: [child names in start order]}."""
    by_id = {s.id: s for s in spans}
    kids: dict = {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        kids.setdefault(s.parent, []).append(s.name)
    return by_id, kids


def _one(rec, name):
    got = rec.named(name)
    assert len(got) == 1, [s.name for s in rec.spans]
    return got[0]


@pytest.fixture(autouse=True)
def _no_recording_left_on():
    yield
    if profiling.is_recording():
        profiling.stop_recording()
        raise AssertionError("a test left a recording on")


def test_off_reads_no_clock_builds_no_span_and_opens_no_range(monkeypatch):
    """With neither recording nor a profiler on, a search in each route and
    a BatchingSearcher round trip never read the spans' clock, never build
    a span and never look up record_function: each is patched to raise.
    Rerank's stages read the clock for last_rerank_decomposition, so its
    search runs before the clock and the span are patched: it still opens
    no range and keeps nothing."""
    ds = _dataset("int8")
    q = _queries(3)
    want = {m: ds.search(q, 5, mode=m) for m in ("exact", "quantized", "rerank")}

    def refuse(*a, **kw):
        raise AssertionError("tracing work with recording and profiling off")

    monkeypatch.setattr(profiling, "_open_range", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    got = ds.search(q, 5, mode="rerank")
    np.testing.assert_array_equal(got[0], want["rerank"][0])
    assert ds.last_rerank_decomposition["stage1_s"] > 0
    monkeypatch.setattr(profiling, "_clock", refuse)
    monkeypatch.setattr(profiling, "_Span", refuse)
    assert not profiling.is_recording() and profiling.stamp() is None
    profiling.count("h2d_bytes", 5)  # a no-op
    del want["rerank"]
    for m, (ids, dist) in want.items():
        got = ds.search(q, 5, mode=m)
        np.testing.assert_array_equal(got[0], ids)
        np.testing.assert_array_equal(got[1], dist)
    searcher = svt.BatchingSearcher(ds, max_wait_ms=5)
    try:
        futs = [searcher.submit(q[i], 5, mode="quantized") for i in range(3)]
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=30)[0], want["quantized"][0][i])
    finally:
        searcher.close()
    with trace("svt.off", enabled=True):  # timing.trace is the same span
        pass


@pytest.mark.parametrize("mode, qtype", [
    ("exact", None), ("quantized", "int8"), ("quantized", "int4"), ("refine", "int4"),
])
def test_a_search_records_its_stages_nested(mode, qtype):
    """One search, recorded: the `search` span holds its stages in order
    with no other child, the route's scan holds K1's or K2's `ops.scan`
    (its B attribute the batch) and the finish, the int8 finish the
    rescore's `ops.rescore`, as the float finish does (each with B the
    batch); every span is on the caller's thread, inside its parent's
    interval, with no batch id."""
    ds = _dataset(qtype, refine=mode == "refine")
    q = _queries(3)
    with profiling.recording() as rec:
        ds.search(q, 5, mode=mode)
    by_id, kids = _tree(rec.spans)
    top = _one(rec, "search")
    assert top.parent is None and top.attrs == {"k": 5, "mode": mode, "B": 3}
    assert kids[top.id] == SEARCH_CHILDREN
    scan = _one(rec, "search.scan")
    inner = kids[scan.id]
    # refine: its int4 prefilter's scan and finish (the int8 rescore is
    # the scan span's own time)
    assert inner == SCAN_CHILDREN
    assert _one(rec, "ops.scan").attrs == {"B": 3}
    rescore = {"int8": ["ops.rescore"], None: ["ops.rescore"]}.get(qtype, [])
    assert [s.name for s in rec.spans if s.parent == _one(rec, "ops.finish").id] == rescore
    if rescore:
        assert _one(rec, rescore[0]).attrs == {"B": 3}
    me = threading.get_ident()
    for s in rec.spans:
        assert s.thread == me and s.batch is None and s.start_ns <= s.end_ns
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
    assert {s.name for s in rec.spans} == {"search", *SEARCH_CHILDREN, *SCAN_CHILDREN, *rescore}


def test_the_l1_float_finish_records_its_gather_nested():
    """An exact L1 search over float rows keeps the gathered finish, which
    records no span of its own: `ops.finish` is a leaf, a child of
    `search.scan` inside its interval, on the caller's thread."""
    ds = _dataset(metric="L1")
    with profiling.recording() as rec:
        ds.search(_queries(3), 5, mode="exact")
    finish = _one(rec, "ops.finish")
    assert [s.name for s in rec.spans if s.parent == finish.id] == []
    scan = _one(rec, "search.scan")
    assert finish.parent == scan.id and finish.thread == threading.get_ident()
    assert scan.start_ns <= finish.start_ns and finish.end_ns <= scan.end_ns
    assert rec.named("ops.rescore") == []


@pytest.mark.parametrize("route", ["fused", "remap"])
def test_rerank_records_its_stages(route):
    """Rerank's stages are child spans of `search`: stage1 alone on the
    fused route; stage1 (the code scan's own query and scan spans inside
    it), translate, gather and rescore on the id-remap route.
    last_rerank_decomposition keeps its keys, recording or not, and its
    seconds are the stages' spans."""
    ds = _dataset("int8", metric="L2")
    q = _queries(2)
    ids_filter = ds.ids[: len(ds) // 2] if route == "remap" else None
    ds.search(q, 5, mode="rerank", ids_filter=ids_filter)
    keys = ds.last_rerank_decomposition.keys()
    with profiling.recording() as rec:
        ds.search(q, 5, mode="rerank", ids_filter=ids_filter)
    assert ds.last_rerank_decomposition.keys() == keys
    _, kids = _tree(rec.spans)
    stages = ["search.rerank.stage1"]
    if route == "remap":
        stages += ["search.rerank.translate", "search.rerank.gather", "search.rerank.rescore"]
    assert kids[_one(rec, "search").id] == ["search.prepare", "search.mask", "search.query", *stages,
                                            "search.d2h", "search.ids"]
    stage1 = _one(rec, "search.rerank.stage1")
    assert kids[stage1.id] == (["search.query", "search.scan"] if route == "remap" else SCAN_CHILDREN)
    got = ds.last_rerank_decomposition

    def seconds(span):  # as the span computes them
        return (span.end_ns - span.start_ns) / 1e9

    assert got["stage1_s"] == seconds(stage1)
    if route == "remap":
        assert got["translate_s"] > 0
        for key, name in (("translate_s", "translate"), ("rescore_s", "rescore")):
            assert got[key] == seconds(_one(rec, f"search.rerank.{name}"))
        assert got["host_gather_s"] == 0.0  # the rows are on the device


def test_a_batch_records_collect_search_deliver_and_each_wait():
    """One batch through the BatchingSearcher: `serve.collect` (its child
    `serve.empty`, its size the batch's), `serve.search` (the search's
    spans under it), `serve.deliver`, one `serve.queued` per request, all
    with the batch's id; each wait ends at the cut, before the search."""
    ds = _dataset("int8")
    q = _queries(4)
    # recording before the dispatcher starts: a span opened before the
    # recording (its first wait) would not be kept
    with profiling.recording() as rec:
        searcher = svt.BatchingSearcher(ds, max_wait_ms=200)
        try:
            futs = [searcher.submit(q[i], 5, mode="quantized") for i in range(4)]
            for f in futs:
                f.result(timeout=30)
        finally:
            searcher.close()
    by_id, kids = _tree(rec.spans)
    searches = rec.named("serve.search")
    assert len(searches) == len(rec.named("search")) >= 1
    for ss in searches:
        bid = ss.batch
        collect = [s for s in rec.named("serve.collect") if s.batch == bid]
        deliver = [s for s in rec.named("serve.deliver") if s.batch == bid]
        assert len(collect) == len(deliver) == 1
        collect, deliver = collect[0], deliver[0]
        assert kids[collect.id] == ["serve.empty"]
        assert collect.end_ns <= ss.start_ns and ss.end_ns <= deliver.start_ns
        assert kids[ss.id] == ["search"]
        inner = by_id[[s.id for s in rec.named("search") if s.parent == ss.id][0]]
        assert inner.batch == bid and inner.attrs["B"] == collect.attrs["size"]
        for s in rec.spans:  # the search's own spans carry the batch id
            if s.parent is not None and by_id.get(s.parent) is not None and s.name.startswith(("search.", "ops.")):
                assert s.batch == by_id[s.parent].batch
        waits = [s for s in rec.named("serve.queued") if s.batch == bid]
        assert len(waits) == collect.attrs["size"]
        for w in waits:
            assert w.end_ns <= ss.start_ns and w.start_ns <= w.end_ns and w.parent is None
    assert sum(len([w for w in rec.named("serve.queued") if w.batch == s.batch]) for s in searches) == 4
    assert rec.counters["serve.queries"] == 4 and rec.counters["serve.batches"] == len(searches)


def test_a_mixed_batch_delivers_each_group_after_its_own_search():
    """A batch of two (k, mode) groups: each group's `serve.deliver` comes
    right after its own `serve.search`, before the next group's search,
    all four with the batch's id; a group whose search raises gets the
    error, and the dispatcher goes on to the next group and batch."""
    ds = _dataset("int8")
    q = _queries(4)
    with profiling.recording() as rec:
        searcher = svt.BatchingSearcher(ds, max_wait_ms=200)
        try:
            futs = [searcher.submit(q[0], 5, mode="quantized"), searcher.submit(q[1], 3, mode="quantized"),
                    searcher.submit(q[2], 5, mode="quantized"), searcher.submit(q[3], 3, mode="quantized")]
            for f in futs:
                f.result(timeout=30)
            bad = searcher.submit(q[0], 5, mode="refine")  # int8 codes: refine raises
            with pytest.raises(svt.VectorStateError):
                bad.result(timeout=30)
            assert len(searcher.submit(q[1], 4, mode="quantized").result(timeout=30)[0]) == 4
        finally:
            searcher.close()
    first = min(s.batch for s in rec.named("serve.search"))
    order = sorted((s for s in rec.spans if s.name in ("serve.search", "serve.deliver") and s.batch == first),
                   key=lambda s: s.start_ns)
    assert [s.name for s in order] == ["serve.search", "serve.deliver"] * 2
    assert all(a.end_ns <= b.start_ns for a, b in zip(order, order[1:]))
    assert sorted(s.attrs["B"] for s in rec.named("search") if s.batch == first) == [2, 2]


def test_serving_counters_match_requests_and_searches_from_many_threads(monkeypatch):
    """Eight threads submit 25 queries each: `serve.queries` equals the
    queries submitted and `serve.batches` the Dataset.search calls made
    (counted by a spy), and the queued spans number the queries."""
    ds = _dataset("int8", n=500)
    q = _queries(16)
    calls = []
    real = ds.search

    def spy(qs, k, **kw):
        calls.append(len(qs))
        return real(qs, k, **kw)

    monkeypatch.setattr(ds, "search", spy)
    searcher = svt.BatchingSearcher(ds, max_batch=8, max_wait_ms=1)
    errors = []

    def client(c):
        try:
            for i in range(25):
                searcher.submit(q[(c + i) % 16], 3, mode="quantized").result(timeout=30)
        except Exception as e:  # reported below
            errors.append(e)

    with profiling.recording() as rec:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        searcher.close()
    assert not errors and not any(t.is_alive() for t in threads)
    assert rec.counters["serve.queries"] == sum(calls) == 200
    assert rec.counters["serve.batches"] == len(calls) == len(rec.named("serve.search"))
    assert len(rec.named("serve.queued")) == 200
    assert max(calls) <= 8


def test_h2d_bytes_counts_the_query_the_scalars_and_the_filter():
    """A B=3 float32 d=24 int8 search uploads its queries and the two
    4-byte quantization scalars; with an ids_filter, 8 bytes an id more,
    and the first filtered search also the snapshot's ids, once. The
    search span's counts hold its children's."""
    ds = _dataset("int8")
    q = _queries(3)
    n = len(ds)
    flt = ds.ids[::7]
    base = 3 * D * 4 + 8
    with profiling.recording() as rec:
        ds.search(q, 5, mode="quantized")
        ds.search(q, 5, mode="quantized", ids_filter=flt)
        ds.search(q, 5, mode="quantized", ids_filter=flt)
    got = [s.counts["h2d_bytes"] for s in rec.named("search")]
    assert got == [base, base + 8 * len(flt) + 8 * n, base + 8 * len(flt)]
    assert rec.counters["h2d_bytes"] == sum(got)
    assert [s.counts["h2d_bytes"] for s in rec.named("search.query")] == [base] * 3


def test_recording_is_one_at_a_time_and_keeps_nothing_after_it_stops():
    rec = profiling.start_recording()
    with pytest.raises(RuntimeError, match="already on"):
        profiling.start_recording()
    span = profiling.annotate("left.open")
    span.__enter__()
    assert profiling.stop_recording() is rec
    with pytest.raises(RuntimeError, match="no recording"):
        profiling.stop_recording()
    span.__exit__(None, None, None)  # ends after the stop: not kept
    profiling.count("x")
    assert rec.spans == [] and rec.counters == {}
    with trace("svt.timed", enabled=True):
        pass
    with profiling.recording() as again:
        with trace("svt.timed", enabled=True):
            profiling.count("x", 2)
    assert [(s.name, s.counts) for s in again.spans] == [("svt.timed", {"x": 2})]
    assert again.counters == {"x": 2}


def test_profile_trace_holds_the_spans_as_svt_ranges(tmp_path):
    """Under profile_trace, recording at once: every recorded span of two
    searches is a `svt.<name>` range (the scan's `svt.ops.scan:<B>`, the
    int8 and float rescores' `svt.ops.rescore:<B>`; the L1 float finish's
    `svt.ops.finish` holds no range), with the same counts, each range
    inside the range of its span's parent."""
    ds = _dataset("int8")
    l1 = _dataset(metric="L1")
    with profile_trace(str(tmp_path)):
        with profiling.recording() as rec:
            ds.search(_queries(3), 5, mode="quantized")
            ds.search(_queries(1, seed=2), 5)
            l1.search(_queries(1, seed=2), 5)

    def label(s):
        return f"svt.{s.name}" + (f":{s.attrs['B']}" if s.name in ("ops.scan", "ops.rescore") else "")

    by_id = {s.id: s for s in rec.spans}
    want = sorted((label(s), label(by_id[s.parent]) if s.parent else None) for s in rec.spans)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    ranges = [e for e in json.loads(files[0].read_text())["traceEvents"]
              if e.get("ph") == "X" and e["name"].startswith("svt.")]
    got = []
    for r in ranges:
        outer = [o for o in ranges if o is not r and o["tid"] == r["tid"]
                 and o["ts"] <= r["ts"] and r["ts"] + r["dur"] <= o["ts"] + o["dur"]]
        parent = max(outer, key=lambda o: o["ts"])["name"] if outer else None
        got.append((r["name"], parent))
    assert sorted(got) == want
    assert ("svt.ops.scan:3", "svt.search.scan") in got and ("svt.ops.scan:1", "svt.search.scan") in got
    assert ("svt.ops.rescore:1", "svt.ops.finish") in got
    # three finishes, and only the two rescores inside them: the L1 one is a leaf
    assert [p for _, p in got].count("svt.search.scan") == 6
    assert sorted(n for n, p in got if p == "svt.ops.finish") == ["svt.ops.rescore:1", "svt.ops.rescore:3"]


def test_a_span_under_a_profiler_keeps_the_interpreter_lock():
    """Under a profiler a span opens and closes its range without
    releasing the interpreter lock: with a busy thread beside it and a
    half-second switch interval, twenty spans take far less than one
    interval (each release would wait one out to get the lock back)."""
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            pass

    old = sys.getswitchinterval()
    spinner = threading.Thread(target=spin)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            sys.setswitchinterval(0.5)
            spinner.start()
            t0 = time.perf_counter()
            for i in range(20):
                with profiling.annotate("held", tag=i):
                    pass
            took = time.perf_counter() - t0
            stop.set()
    finally:
        sys.setswitchinterval(old)
        stop.set()
        spinner.join(timeout=10)
    assert not spinner.is_alive()
    assert took < 0.5, f"20 spans took {took:.2f} s: the ranges release the interpreter lock"
