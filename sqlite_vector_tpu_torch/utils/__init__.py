"""Utilities: timing, profiling hooks, the build cache.

Port of sqlite_vector_tpu/utils/, with the same exports."""

from sqlite_vector_tpu_torch.utils.timing import Timer, format_bytes
from sqlite_vector_tpu_torch.utils.profiling import (
    QueryStats,
    StatsRecorder,
    annotate,
    profile_trace,
    timed_search,
)

__all__ = [
    "Timer",
    "format_bytes",
    "QueryStats",
    "StatsRecorder",
    "annotate",
    "profile_trace",
    "timed_search",
]
