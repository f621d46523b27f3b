"""The finish's frozen bound: `ops.finish_roofline` reads the finish's
byte floor over the device time outside the scan ranges."""

from types import SimpleNamespace

import pytest

from vbench import spec
from vbench.tracing import Summary


def _finish_run(batches, search_s, scan_s, n=5_000_000, d=1536, k=100):
    trace = Summary(n_calls=len(batches), scan_batches=list(batches), device_ops=10 * len(batches),
                    search_device_s=search_s, scan_device_s=scan_s)
    cfg = {"rows": n, "dim": d, "k": k, "mode": "exact", "type": "FLOAT32"}
    return SimpleNamespace(trace=trace, config=cfg)


def test_finish_roofline_is_its_frozen_floor_over_the_time_outside_the_scan():
    read = spec.metric_reader("ops.finish_roofline")
    g = 39_063  # groups of 128 rows in 5M

    def floor_s(b, elem=4):
        # minima read, queries read, k * 128 candidate rows a query read
        # and their distances written, once each
        cand = b * 100 * 128
        return (b * g * 4 + b * 1536 * elem + cand * 1536 * elem + cand * 4) / 3.35e12

    assert floor_s(32) * 1e3 == pytest.approx(0.7532589, rel=1e-6)  # B = 32: 2.52 GB
    # the time outside the scan equal to the floor: exactly 100%
    assert read(_finish_run([32], 0.010 + floor_s(32), 0.010)) == pytest.approx(100.0, rel=1e-12)
    # two scans, four times their floor outside the scans: 25%
    both = floor_s(32) + floor_s(1)
    assert read(_finish_run([32, 1], 0.02 + 4 * both, 0.02)) == pytest.approx(25.0)
    # codes: an element a byte
    run = _finish_run([1], 1.0 + 1e-3, 1.0)
    run.config.update(mode="quantized", quantize={"qtype": "int8"})
    assert read(run) == pytest.approx(100 * floor_s(1, elem=1) / 1e-3)


def test_finish_roofline_reads_nothing_without_a_scan_or_time_outside_it():
    read = spec.metric_reader("ops.finish_roofline")
    assert read(_finish_run([], 0.01, 0.0)) is None
    assert read(_finish_run([32], 0.01, 0.01)) is None
    run = _finish_run([32], 0.01, 0.0)
    run.trace = None
    assert read(run) is None
