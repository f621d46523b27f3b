"""p50_ms: the median latency of every request sent in the window."""

from vbench.stats import percentile


def read(run):
    return percentile(run.window.latencies(), 50) * 1e3 if run.window.attempted else None
