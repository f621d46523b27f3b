"""ops.finish_roofline: the exact finish's share of its roofline. The
floor of the finish after a scan of B queries over N rows of d elements,
G = ceil(N / 128) groups, kg = min(k, G) groups kept a query: the [B, G]
float32 minima read once, the B queries read once, the B * kg * 128
candidate rows read once and their float32 distances written once, over
the HBM rate (bytes of an element as the scan reads them,
vbench/roofline.py:scan_elem). The count is frozen here: it holds whatever
implements the finish. Summed over the slice's scans, over the device time
of the ops launched inside its calls but outside the scan's ranges (which
holds, beside the finish, the query's upload and the results' copy back).
Nothing is reported where the slice holds no scan."""

from vbench.roofline import GROUP, HBM_BYTES_PER_S, scan_elem


def finish_bytes(b: int, n: int, d: int, k: int, elem: int) -> int:
    g = -(-n // GROUP)
    cand = b * min(k, g) * GROUP
    return b * g * 4 + b * d * elem + cand * d * elem + cand * 4


def read(run):
    t = run.trace
    if t is None or not t.scan_batches:
        return None
    outside_s = t.search_device_s - t.scan_device_s
    if outside_s <= 0:
        return None
    cfg = run.config
    n, d, k, elem = cfg["rows"], cfg["dim"], cfg["k"], scan_elem(cfg)
    floor_s = sum(finish_bytes(b, n, d, k, elem) for b in t.scan_batches) / HBM_BYTES_PER_S
    return 100.0 * floor_s / outside_s
