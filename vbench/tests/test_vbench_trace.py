"""The reduction of a traced slice: device ops belong to a search or a
scan range by the correlation id of the launch that made them, never by
their device timestamps; the busy share is the union of their intervals;
idle time goes to what the searching thread was doing."""

import pytest

from vbench import tracing


def ev(cat, name, ts, dur, tid=1, corr=None, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        args["correlation"] = corr
    if args:
        e["args"] = args
    return e


def trace():
    return {"traceEvents": [
        # a call before the settle point: left out
        ev("user_annotation", "vbench.search:64", 0, 50),
        ev("cuda_runtime", "cudaLaunchKernel", 10, 2, corr=1),
        ev("kernel", "early", 20, 10, tid=7, corr=1),
        # call 1: an upload, the scan (its kernel's device time reads before
        # the range began: a clock skew that correlation ids ignore), a finish
        ev("user_annotation", "vbench.search:64", 100, 100),
        ev("cuda_runtime", "cudaMemcpyAsync", 105, 5, corr=2),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 106, 4, tid=7, corr=2, bytes=196608),
        ev("user_annotation", "vbench.scan:64", 120, 20),
        ev("cpu_op", "aten::empty", 121, 3),
        ev("cuda_driver", "cuLaunchKernelEx", 125, 2, corr=3),
        ev("kernel", "wgmma_minima_kernel", 118, 30, tid=7, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 150, 2, corr=4),
        ev("kernel", "sort", 152, 20, tid=7, corr=4),
        # call 2: one finish kernel
        ev("user_annotation", "vbench.search:32", 300, 50),
        ev("cuda_runtime", "cudaLaunchKernel", 310, 2, corr=5),
        ev("kernel", "sort", 312, 10, tid=7, corr=5),
        # a launch from another thread, not a search's
        ev("cuda_runtime", "cudaLaunchKernel", 320, 2, tid=2, corr=6),
        ev("kernel", "other", 330, 5, tid=7, corr=6),
    ]}


def test_summary_attributes_by_correlation():
    s = tracing.summarize(trace(), settle_us=60)
    assert s.n_calls == 2 and s.scan_batches == [64]
    assert s.slice_s == pytest.approx(250e-6)
    assert s.device_ops == 4  # memcpy, scan kernel, two sorts; not "other", not "early"
    assert s.search_device_s == pytest.approx((4 + 30 + 20 + 10) * 1e-6)
    assert s.scan_device_s == pytest.approx(30e-6)
    assert s.h2d_bytes == 196608
    # busy: [106, 110] + [118, 148] + [152, 172] + [312, 322] + [330, 335]
    assert s.busy_s == pytest.approx((4 + 30 + 20 + 10 + 5) * 1e-6)
    names = dict(s.top_ops)
    assert names["wgmma_minima_kernel"] == pytest.approx(30e-6)
    assert names["sort"] == pytest.approx(30e-6)
    assert "early" not in names


def test_idle_gaps_go_to_what_the_search_thread_was_doing():
    s = tracing.summarize(trace(), settle_us=60)
    gaps = dict(s.idle_gaps)
    assert sum(gaps.values()) == pytest.approx(s.slice_s - s.busy_s)
    # between the calls (200 -> 300) nothing ran on the searching thread
    assert gaps["host:between_searches"] == pytest.approx(100e-6)
    assert gaps["host:python_inside_the_search"] > 0
    assert gaps["cudaMemcpyAsync"] == pytest.approx(1e-6)  # 105 -> 106


def test_an_empty_trace_reads_nothing():
    s = tracing.summarize({"traceEvents": []})
    assert s.n_calls == 0 and s.busy_s == 0
