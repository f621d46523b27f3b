"""search.h2d_mb: host-to-device bytes a search call copies, MB (10^6),
from the profiler's memcpy events launched inside the slice's calls."""


def read(run):
    t = run.trace
    return t.h2d_bytes / t.n_calls / 1e6 if t is not None and t.n_calls else None
