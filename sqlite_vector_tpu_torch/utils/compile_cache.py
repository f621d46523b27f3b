"""Where the port's compiled artifacts go: its persistent build cache.

Port of sqlite_vector_tpu/utils/compile_cache.py. The JAX package caches
XLA executables; the port compiles no XLA. Its compiled artifacts are the
CUDA kernel library that nvcc builds at first use (ops/_build.py) and the
two native host libraries that g++/gcc build (native/). Both are named
after a hash of their sources and flags, so a cache directory holds one
build per source version and an unchanged source is never rebuilt.

Controls (read at each call, as the JAX package reads them):
  (unset)                   the package's own _build/ directory (ignored
                            by git)
  SVT_COMPILE_CACHE=<dir>   the builds go under <dir>
  SVT_COMPILE_CACHE=0|off|false|none|disable
                            no persistent cache: the builds go to a fresh
                            temporary directory of this process (one for
                            all its threads), removed when it exits

Importing the package builds nothing and creates no directory; the build
directory is resolved when a build or a load looks for its file.

Not ported: the JAX package's deference to a cache the user configured
(jax_compilation_cache_dir / JAX_COMPILATION_CACHE_DIR) and its exclusion
of the CPU backend from the implicit default. Both are about XLA's cache;
nothing here compiles on or for the CPU backend's XLA.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import threading
from pathlib import Path

_DEFAULT_DIR = Path(__file__).resolve().parent.parent / "_build"
_OFF = ("0", "off", "false", "none", "disable")

_lock = threading.Lock()
_scratch: Path | None = None


def ensure_persistent_cache() -> str | None:
    """Idempotent (the JAX package calls its twin at first engine use; the
    port's cache needs no setting up). Returns the cache dir in use (or
    None)."""
    return enable_persistent_cache()


def enable_persistent_cache() -> str | None:
    """The directory the builds persist in, or None when SVT_COMPILE_CACHE
    turns the cache off. Creates nothing."""
    raw = os.environ.get("SVT_COMPILE_CACHE", "")
    if raw.strip().lower() in _OFF:
        return None
    return raw or str(_DEFAULT_DIR)


def build_root() -> Path:
    """Where a build writes and a load looks now: the persistent cache, or
    with the cache off this process's temporary directory (made at its
    first use, removed at exit)."""
    global _scratch
    cache = enable_persistent_cache()
    if cache is not None:
        return Path(cache)
    with _lock:
        if _scratch is None:
            _scratch = Path(tempfile.mkdtemp(prefix="svt-build-"))
            atexit.register(shutil.rmtree, _scratch, True)
        return _scratch
