"""ops.device_ops: device operations (kernels, copies, memsets) a search
call launches, over the slice's calls."""


def read(run):
    t = run.trace
    return t.device_ops / t.n_calls if t is not None and t.n_calls and t.device_ops else None
