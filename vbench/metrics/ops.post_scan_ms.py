"""ops.post_scan_ms: device ms a search call spends outside the scan's
range (query preparation, the finish's selection, gather, rescore and
top-k, the copies back), the mean over the slice's calls."""


def read(run):
    t = run.trace
    if t is None or not t.n_calls or not t.device_ops:
        return None
    return (t.search_device_s - t.scan_device_s) / t.n_calls * 1e3
