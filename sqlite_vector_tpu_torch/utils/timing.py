"""Timing / observability helpers.

Port of sqlite_vector_tpu/utils/timing.py: `Timer` and `format_bytes` are
copied unchanged; `trace` is the port's span (utils.profiling.annotate:
a `record_function` range under an active profiler, kept while recording)
where the JAX package uses jax.profiler.TraceAnnotation.
"""

from __future__ import annotations

import contextlib
import time

from sqlite_vector_tpu_torch.utils.profiling import annotate


class Timer:
    """Wall-clock timer (host clock; the port's searches return host arrays,
    so the device has finished when a timed search returns)."""

    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False


def trace(name: str, enabled: bool = False):
    """Optional span around a region (utils.profiling.annotate)."""
    if not enabled:
        return contextlib.nullcontext()
    return annotate(name)


def format_bytes(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    raise AssertionError("unreachable")  # the TB case returns in the loop
