"""device.idle: the share of the slice in which no operation ran on the
device, from the union of its kernel, copy and memset intervals."""


def read(run):
    t = run.trace
    if t is None or t.slice_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.slice_s)
