"""The harness's arithmetic: window rates and percentiles, the frozen
bound, the interval union, the spread."""

import gc
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

import run
from vbench import roofline, stats
from vbench.load import Clients, Window


def _window(sent, done, failed=()):
    w = Window(seconds=10.0, sent=np.asarray(sent, float), done=np.asarray(done, float))
    w.answers = [(0, None, None if i in failed else ((), ())) for i in range(len(sent))]
    return w


def _answer_after(delay):
    def call(q):
        time.sleep(delay)
        return (np.array([1]), np.array([0.0]))
    return call


def _run(gen, seconds):
    gen.start()
    time.sleep(0.2)
    now = time.perf_counter()
    gen.close_at, gen.open_at = now + seconds, now
    time.sleep(seconds)
    gen.stop()
    return gen.window()


def test_closed_loop_rate_counts_every_answer_inside_the_window():
    pool = np.zeros((8, 4), np.float32)
    w = _run(Clients(_answer_after(0.01), pool, 2), 0.5)
    # two clients at ~10 ms a request: ~100 answers in half a second
    assert 60 <= w.completions <= 101
    assert abs(w.attempted - w.completions) <= 2
    assert (w.sent >= 0).all() and (w.sent < 0.5).all() and (w.done > w.sent).all()


def test_each_client_keeps_one_request_in_flight_and_each_is_counted():
    pool = np.zeros((8, 4), np.float32)
    in_flight, most, by_thread = [0], [0], {}
    lock = threading.Lock()

    def call(q):
        me = threading.get_ident()
        with lock:
            in_flight[0] += 1
            most[0] = max(most[0], in_flight[0])
            by_thread[me] = by_thread.get(me, 0) + 1
            assert by_thread[me] == 1
        time.sleep(0.02)
        with lock:
            in_flight[0] -= 1
            by_thread[me] -= 1
        return (np.array([1]), np.array([0.0]))

    w = _run(Clients(call, pool, 16), 1.0)
    # sixteen clients of one request each, at least 20 ms a request: at
    # most ~800 answers a second, each counted once
    assert most[0] <= 16
    assert 200 <= w.completions <= 810
    assert abs(w.attempted - w.completions) <= 16
    assert all(a is not None for _, _, a in w.answers)
    assert (w.latencies() >= 0.02).all()


def test_collector_log_counts_the_runs_of_each_generation_before_the_close():
    log = run.CollectorLog()
    t = time.perf_counter()
    log.runs = [(0, t, 0.001), (2, t, 0.25), (2, t + 0.1, 0.05), (2, t + 9.0, 0.4)]
    assert log.summary(t + 1.0) == {"gen0": [1, 1.0, 1.0], "gen1": [0, 0.0, 0.0], "gen2": [2, 250.0, 300.0]}
    gc.callbacks.append(log)
    try:
        gc.collect()
    finally:
        gc.callbacks.remove(log)
    assert log.runs[-1][0] == 2 and log.runs[-1][2] >= 0


@pytest.mark.parametrize(
    "b, n, elem, ms",
    [
        (64, 1_000_000, 4, 0.9176707),  # cohere1m.concurrent: 3.07 GB of f32 rows
        (1, 1_000_000, 4, 0.9170252),  # cohere1m.serial
        (64, 10_000_000, 1, 2.2985221),  # cohere10m-int8.concurrent: 7.68 GB of codes
        (1, 10_000_000, 1, 2.2926308),  # cohere10m-int8.serial
    ],
)
def test_frozen_bound_at_the_four_cells_shapes(b, n, elem, ms):
    # bytes: queries and rows once, [B, ceil(N / 128)] float32 minima once
    nbytes = (b + n) * 768 * elem + b * -(-n // 128) * 4
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(ms, rel=1e-6)
    got, which = roofline.k1_bound(b, n, 768, elem)
    assert which == "bytes"
    assert got == pytest.approx(ms, rel=1e-6)


def test_bound_turns_to_operations_at_wide_batches():
    # 3xTF32 at B = 1,024 over 1M x 768 f32 rows: 4.7e15 operations outrun the bytes
    ms, side = roofline.k1_bound(1024, 1_000_000, 768, 4)
    assert side == "operations"
    assert ms == pytest.approx(3 * 2 * 1024 * 1e6 * 768 / 495e12 * 1e3)


def test_scan_elem_follows_what_the_search_scans():
    assert roofline.scan_elem({"mode": "exact", "type": "FLOAT32"}) == 4
    assert roofline.scan_elem({"mode": "quantized", "type": "FLOAT32", "quantize": {"qtype": "int8"}}) == 1


def test_interval_union():
    spans = [(0, 2), (1, 3), (5, 6), (6, 7), (10, 10)]
    assert stats.busy_us(spans) == 5
    assert stats.merged(spans) == [(0, 3), (5, 7), (10, 10)]
    assert stats.busy_us([]) == 0
