"""The port's serving layer (sqlite_vector_tpu_torch/serving.py) against the
JAX package's on the same rows, both on the CPU: query coalescing, the
cancellation-safe claiming of futures, fallback_exact, the close race, a
short mutator soak, and serve() over HTTP on localhost.

Results through the coalescer must equal the dataset's own search of the
same query: the same ids, integer-domain (int8) values bit for bit, float
values within rtol 1e-6 (the exact rescore's product may round in another
order at another batch size); and the JAX package's (ids equal, values
within rtol 1e-5).
"""

import http.client
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import sqlite_vector_tpu as jax_svt
import sqlite_vector_tpu_torch as svt
from sqlite_vector_tpu.serving import BatchingSearcher as JaxBatchingSearcher
from sqlite_vector_tpu_torch.serving import BatchingSearcher, _dataset_stats, serve

OPTS = "dimension=32,type=FLOAT32,distance=L2"


@pytest.fixture
def rows(rng):
    return rng.standard_normal((500, 32)).astype(np.float32)


@pytest.fixture
def ds(rows):
    d = svt.VectorStore(device="cpu").create("srv", OPTS)
    d.add(rows)
    return d


def post(port, path, payload, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("mode", ["exact", "quantized", "rerank"])
def test_coalesced_results_equal_direct_search_and_jax(mode, rows):
    """40 threads through each package's coalescer: every port result
    equals the port dataset's direct search of that query, and the JAX
    coalescer's result."""
    pds = svt.VectorStore(device="cpu").create("a", OPTS)
    jds = jax_svt.VectorStore().create("a", OPTS)
    pds.add(rows)
    jds.add(rows)
    if mode != "exact":
        pds.quantize()
        jds.quantize()
    queries = np.concatenate([rows[:20], np.random.default_rng(3).standard_normal((20, 32)).astype(np.float32)])
    got, errors = {}, []
    for name, searcher in (("port", BatchingSearcher(pds, max_batch=16, max_wait_ms=5)),
                           ("jax", JaxBatchingSearcher(jds, max_batch=16, max_wait_ms=5))):
        def worker(i, s=searcher, name=name):
            try:
                got[name, i] = s.search(queries[i], 5, mode=mode)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(queries))]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            searcher.close()
    assert not errors
    for i, q in enumerate(queries):
        pid, pv = got["port", i]
        did, dv = pds.search(q, 5, mode=mode)
        np.testing.assert_array_equal(pid, did)
        if mode == "quantized":
            np.testing.assert_array_equal(pv, dv)
        else:
            np.testing.assert_allclose(pv, dv, rtol=1e-6, atol=1e-6)
        jid, jv = got["jax", i]
        np.testing.assert_array_equal(pid, jid)
        np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=1e-5)
        if i < 20 and mode == "exact":
            assert pid[0] == i + 1 and pv[0] == 0.0


def test_dispatch_runs_the_live_batch_unpadded(ds, rows, monkeypatch):
    """The dispatcher searches the live queries as they are: no zero rows
    padded to a bucket size."""
    seen = []
    real = ds.search

    def spy(qs, k, **kw):
        seen.append(np.asarray(qs).shape[0])
        return real(qs, k, **kw)

    monkeypatch.setattr(ds, "search", spy)
    searcher = BatchingSearcher(ds, max_batch=8, max_wait_ms=1)
    try:
        futs = [Future() for _ in range(3)]
        searcher._dispatch([(rows[i], 4, "exact", f) for i, f in enumerate(futs)])
        assert seen == [3]
        for i, f in enumerate(futs):
            assert f.result(timeout=10)[0][0] == i + 1
    finally:
        searcher.close()


def test_mixed_k_and_modes_group_apart(ds, rows):
    ds.quantize()
    searcher = BatchingSearcher(ds, max_wait_ms=5)
    try:
        f1 = searcher.submit(rows[0], 3)
        f2 = searcher.submit(rows[1], 7)
        f3 = searcher.submit(rows[2], 3, exact=False)
        assert len(f1.result(timeout=30)[0]) == 3 and len(f2.result(timeout=30)[0]) == 7
        np.testing.assert_array_equal(f3.result(timeout=30)[0], ds.search(rows[2], 3, exact=False)[0])
        with pytest.raises(ValueError, match="single query"):
            searcher.submit(rows[:2], 3)
    finally:
        searcher.close()


def test_submit_close_race_never_hangs(ds, rows):
    """submit() racing close(): each accepted future resolves, and after
    close every submit raises."""
    for _ in range(10):
        searcher = BatchingSearcher(ds, max_wait_ms=0.5)
        futures = []
        barrier = threading.Barrier(2)

        def submitter():
            barrier.wait()
            for i in range(50):
                try:
                    futures.append(searcher.submit(rows[i % 10], 2))
                except RuntimeError:
                    break

        t = threading.Thread(target=submitter)
        t.start()
        barrier.wait()
        searcher.close()
        t.join(timeout=10)
        assert not t.is_alive()
        for f in futures:
            try:
                f.result(timeout=10)
            except RuntimeError:
                pass
            assert f.done()
    with pytest.raises(RuntimeError, match="closed"):
        searcher.submit(rows[0], 2)


def test_cancelled_future_does_not_poison_batch(ds, rows, monkeypatch):
    """A future cancelled before the dispatch drops out; a cancel landing
    during the search is refused (the future was claimed), and batch-mates
    get their results."""
    searcher = BatchingSearcher(ds, max_batch=8, max_wait_ms=1)
    try:
        f_cancelled, f_live = Future(), Future()
        assert f_cancelled.cancel()
        searcher._dispatch([(rows[3], 3, "exact", f_cancelled), (rows[5], 3, "exact", f_live)])
        assert f_cancelled.cancelled()
        assert int(f_live.result(timeout=10)[0][0]) == 6

        f_racer, f_mate = Future(), Future()
        real = searcher.dataset.search

        def search_and_cancel(*a, **kw):
            assert not f_racer.cancel()  # claimed: the cancel is refused
            return real(*a, **kw)

        monkeypatch.setattr(searcher.dataset, "search", search_and_cancel)
        searcher._dispatch([(rows[7], 3, "exact", f_racer), (rows[9], 3, "exact", f_mate)])
        assert int(f_racer.result(timeout=10)[0][0]) == 8
        assert int(f_mate.result(timeout=10)[0][0]) == 10
    finally:
        searcher.close()


def test_fallback_exact_during_requant_window(ds, rows):
    strict = BatchingSearcher(ds, max_wait_ms=1)
    try:
        with pytest.raises(svt.VectorStateError):
            strict.search(rows[0], 3, mode="quantized")
    finally:
        strict.close()
    lenient = BatchingSearcher(ds, max_wait_ms=1, fallback_exact=True)
    try:
        ids, dist = lenient.search(rows[0], 3, mode="quantized")
        assert ids[0] == 1 and dist[0] == 0.0  # the exact scan's result
        assert lenient.search(rows[1], 3, mode="rerank")[0][0] == 2
    finally:
        lenient.close()


def test_dispatcher_runs_on_the_creating_threads_stream(ds):
    """On the CPU there is no stream to carry; on CUDA the searcher keeps
    the stream current where it was built (covered on the card by
    chip_smoke.py phase 10)."""
    s = BatchingSearcher(ds)
    try:
        assert s._stream is None
    finally:
        s.close()


def test_soak_mutator_with_fallback(rng):
    """Clients search through the coalescer in exact and int8 modes while a
    mutator adds, removes and re-quantizes (drop included) with
    fallback_exact: no client error, sorted finite results, and a fresh
    quantize afterwards agrees with the exact scan."""
    ds = svt.VectorStore(device="cpu").create("soak", OPTS)
    ds.add(rng.standard_normal((2000, 32)).astype(np.float32))
    ds.quantize()
    searcher = BatchingSearcher(ds, max_batch=16, max_wait_ms=1, fallback_exact=True)
    stop = threading.Event()
    errors, served = [], [0]

    def mutator():
        mrng = np.random.default_rng(1)
        i = 0
        try:
            while not stop.is_set():
                ds.add(mrng.standard_normal((50, 32)).astype(np.float32))
                ds.remove(mrng.choice(ds.ids, size=25, replace=False))
                if i % 5 == 4:
                    ds.drop_quantization()
                    ds.quantize()
                elif i % 2:
                    ds.quantize()
                i += 1
        except Exception as e:  # pragma: no cover
            errors.append(("mutator", e))

    def client(seed):
        crng = np.random.default_rng(seed)
        j = 0
        try:
            while not stop.is_set():
                ids, dist = searcher.search(
                    crng.standard_normal(32).astype(np.float32), 5,
                    mode=("exact", "quantized")[j % 2],
                )
                j += 1
                assert np.all(np.diff(dist) >= 0) and np.all(np.isfinite(dist))
                assert len(np.unique(ids)) == len(ids)
                served[0] += 1
        except Exception as e:  # pragma: no cover
            errors.append((f"client-{seed}", e))

    threads = [threading.Thread(target=mutator)] + [threading.Thread(target=client, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    time.sleep(2.0)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    searcher.close()
    assert not errors, errors[:3]
    assert served[0] > 20
    ds.quantize()
    probe = ds.get(ds.ids[:1])[0]
    ids, dist = ds.search(probe, 1)
    assert dist[0] == 0.0 and ids[0] == ds.ids[0]


def test_http_server_matches_direct_search(ds, rows):
    server = serve(ds, port=0)
    try:
        port = server.server_address[1]
        for i in (5, 77, 400):
            out = post(port, "/search", {"vector": rows[i].tolist(), "k": 4})
            want = ds.search(rows[i], 4)
            assert out["ids"] == want[0].tolist()
            np.testing.assert_allclose(out["distances"], want[1], rtol=1e-6, atol=1e-6)
        ds.quantize()
        out = post(port, "/search", {"vector": rows[9].tolist(), "k": 3, "exact": False})
        assert out["ids"] == ds.search(rows[9], 3, exact=False)[0].tolist()
        assert len(post(port, "/add", {"vectors": [rows[0].tolist()]})["ids"]) == 1
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=10) as r:
            stats = json.loads(r.read())
        assert stats == json.loads(json.dumps(_dataset_stats(ds))) and stats["count"] == 501
        with pytest.raises(urllib.error.HTTPError) as e:
            post(port, "/nowhere", {})
        assert e.value.code == 404
    finally:
        server.close()


def test_http_rejects_bad_and_oversized_bodies(ds, rows):
    server = serve(ds, port=0, max_request_bytes=1024)
    try:
        port = server.server_address[1]
        for bad in ("-1", "nonsense"):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            c.putrequest("POST", "/search")
            c.putheader("Content-Length", bad)
            c.endheaders()
            assert c.getresponse().status == 400
            c.close()
        with pytest.raises(urllib.error.HTTPError) as e:
            post(port, "/search", {"vector": [0.0] * 500, "k": 1})
        assert e.value.code == 413
        assert post(port, "/search", {"vector": rows[0].tolist(), "k": 1})["ids"] == [1]
    finally:
        server.close()


def test_http_store_routing_and_eviction(rng):
    """serve(VectorStore) routes by name, answers 400 without one when it
    serves several, and evicts the coalescers of dropped datasets."""
    store = svt.VectorStore(device="cpu")
    a = store.create("alpha", "dimension=8,type=FLOAT32,distance=L2")
    b = store.create("beta", "dimension=4,type=FLOAT32,distance=L2")
    av = rng.standard_normal((50, 8)).astype(np.float32)
    bv = rng.standard_normal((30, 4)).astype(np.float32)
    aids, bids = a.add(av), b.add(bv)
    server = serve(store, port=0, max_wait_ms=1)
    try:
        port = server.server_address[1]
        assert post(port, "/search", {"dataset": "alpha", "vector": av[7].tolist(), "k": 2})["ids"][0] == aids[7]
        assert post(port, "/search", {"dataset": "beta", "vector": bv[3].tolist(), "k": 2})["ids"][0] == bids[3]
        with pytest.raises(urllib.error.HTTPError) as e:
            post(port, "/search", {"vector": av[0].tolist(), "k": 1})
        assert e.value.code == 400
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=10) as r:
            assert set(json.loads(r.read())["datasets"]) == {"alpha", "beta"}
        store.drop("alpha")
        store.drop("beta")
        for cycle in range(3):
            ds = store.create(f"c{cycle}", "dimension=8,type=FLOAT32,distance=L2")
            ds.add(av)
            assert post(port, "/search", {"dataset": f"c{cycle}", "vector": av[0].tolist(), "k": 1})["distances"][0] == 0.0
            store.drop(f"c{cycle}")
        assert len(server._searchers) == 1
    finally:
        server.close()


def test_serving_exports_and_default_device(monkeypatch):
    assert svt.BatchingSearcher is BatchingSearcher and svt.serve is serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(svt.VectorConfigError, match="CUDA"):
        serve(svt.VectorStore(), port=0)
