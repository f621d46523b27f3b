"""Native host runtime of the port: the shared C sources, built at first use.

Port of sqlite_vector_tpu/native/__init__.py, over the same two sources,
unchanged:
  - csrc/svt_native.cpp, a CPython extension (`_svt_native`): the JSON
    vector parser and the bulk (rowid, blob) loader that walks a SQLite
    table through the C API;
  - csrc/svt_vtab.c, a loadable SQLite extension registering the four
    table-valued scan modules (vector_full_scan and the rest), whose
    xFilter calls back into the connection's svt_scan_blob function.

Both build with the host compiler (g++, gcc) into
sqlite_vector_tpu_torch/_build/native-<hash>/, a directory named after a
hash of the sources, the headers and the flags, so an edited source is
rebuilt and an unchanged one reused. The vtab builds against the SQLite
headers vendored in csrc/third_party/ (public domain), so it needs no
system header. Its file stays svtvtab.so: SQLite derives the entry point
sqlite3_svtvtab_init from the file name.

The extension module is loaded by path and kept out of sys.modules: the
JAX package's loader imports its own build as the top-level module
`_svt_native`, and a process holding both packages (the parity tests)
must get each package's own build.

Every caller has a pure-Python fallback: a failed build (no compiler, no
Python headers) returns None here. This is host code; the device and the
kernels are not involved.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_REPO = _PKG.parent
NATIVE_SRC = _REPO / "csrc" / "svt_native.cpp"
VTAB_SRC = _REPO / "csrc" / "svt_vtab.c"
THIRD_PARTY = _PKG / "csrc" / "third_party"
BUILD_DIR = _PKG / "_build"

_NATIVE_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_VTAB_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_native = None
_native_checked = False
_vtab_checked = False
_vtab_path: str | None = None


def build_dir() -> Path:
    """The directory of the current sources' builds (built or not)."""
    h = hashlib.sha256(" ".join(_NATIVE_FLAGS + _VTAB_FLAGS).encode())
    h.update(sysconfig.get_paths()["include"].encode())
    for src in (NATIVE_SRC, VTAB_SRC, *sorted(THIRD_PARTY.glob("*.h"))):
        h.update(src.name.encode())
        if src.exists():
            h.update(src.read_bytes())
    return BUILD_DIR / f"native-{h.hexdigest()[:16]}"


def _compile(cmd: list[str], out: Path) -> bool:
    """Run a compiler command that writes a temp file, then move it to
    `out` (atomic: a concurrent process never loads half a file)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run([*cmd, "-o", str(tmp)], check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def vtab_extension_path() -> str | None:
    """Build (once) and return the path of the loadable SQLite extension
    (csrc/svt_vtab.c), or None when it cannot be built: callers then fall
    back to the json_each shims."""
    global _vtab_checked, _vtab_path
    with _lock:
        if not _vtab_checked:
            _vtab_checked = True
            out = build_dir() / "svtvtab.so"
            if out.exists() or (
                VTAB_SRC.exists()
                and _compile(["gcc", *_VTAB_FLAGS, f"-I{THIRD_PARTY}", str(VTAB_SRC)], out)
            ):
                _vtab_path = str(out)
        return _vtab_path


def _load():
    """The built `_svt_native` module, or None."""
    global _native, _native_checked
    with _lock:
        if _native_checked:
            return _native
        _native_checked = True
        out = build_dir() / "_svt_native.so"
        include = sysconfig.get_paths()["include"]
        if not out.exists() and not (
            NATIVE_SRC.exists()
            and _compile(["g++", *_NATIVE_FLAGS, f"-I{include}", str(NATIVE_SRC), "-ldl"], out)
        ):
            return None
        # by path, under the module name its init function carries; a module
        # of that name in sys.modules (the JAX package's build) is put back
        prior = sys.modules.get("_svt_native")
        try:
            loader = importlib.machinery.ExtensionFileLoader("_svt_native", str(out))
            spec = importlib.util.spec_from_file_location("_svt_native", str(out), loader=loader)
            module = importlib.util.module_from_spec(spec)
            loader.exec_module(module)
            _native = module
        except ImportError:
            _native = None
        finally:
            if prior is None:
                sys.modules.pop("_svt_native", None)
            else:
                sys.modules["_svt_native"] = prior
        return _native


def available() -> bool:
    return _load() is not None


def parse_json_vector(json_text: str, vtype, dimension: int = 0):
    """Native vector_from_json. Returns the typed numpy vector, or None to
    signal 'use the pure-Python parser'. Raises VectorCodecError on
    malformed input (the Python parser's messages)."""
    native = _load()
    if native is None:
        return None
    from sqlite_vector_tpu_torch.errors import VectorCodecError
    from sqlite_vector_tpu_torch.types import VectorType

    check = 1 if vtype is VectorType.U8 else 2 if vtype is VectorType.I8 else 0
    try:
        buf = native.parse_json_f64(json_text, check)
    except ValueError as e:
        raise VectorCodecError(str(e)) from None
    arr64 = np.frombuffer(buf, dtype="<f8")
    if dimension > 0 and dimension != arr64.size:
        raise VectorCodecError(
            f"Invalid JSON vector dimension: expected {dimension} but found "
            f"{arr64.size}."
        )
    if vtype in (VectorType.U8, VectorType.I8):
        return arr64.astype(vtype.np_dtype)  # C truncation toward zero
    return arr64.astype(np.float32).astype(vtype.np_dtype)


def load_blobs(db_path: str, query: str, expected_bytes: int):
    """Native bulk (rowid, blob) loader. Returns (ids int64 [N], data bytes,
    count) or None to signal 'use the Python sqlite3 row loop'."""
    native = _load()
    if native is None:
        return None
    from sqlite_vector_tpu_torch.errors import VectorCodecError

    try:
        ids_bytes, data, count = native.load_blobs(db_path, query, expected_bytes)
    except ValueError as e:
        raise VectorCodecError(str(e)) from None
    except OSError:
        return None
    ids = np.frombuffer(ids_bytes, dtype="<i8")
    return ids, data, count
