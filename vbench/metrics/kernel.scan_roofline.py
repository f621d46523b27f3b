"""kernel.scan_roofline: the scan's share of its roofline. The frozen
bound (vbench/roofline.py:k1_bound) at the cell's shapes, summed over the
slice's scans, over the device time of the ops launched inside the scan's
ranges. Nothing is reported where the slice holds no scan."""

from vbench.roofline import k1_bound, scan_elem


def read(run):
    t = run.trace
    if t is None or not t.scan_batches or t.scan_device_s <= 0:
        return None
    n, d, elem = run.config["rows"], run.config["dim"], scan_elem(run.config)
    floor_ms = sum(k1_bound(b, n, d, elem)[0] for b in t.scan_batches)
    return 100.0 * floor_ms / (t.scan_device_s * 1e3)
