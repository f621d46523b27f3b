"""Build and load the package's CUDA kernels at first use.

Each `csrc/*.cu` source compiles with its own nvcc process, all started
together, and the objects link into one shared library with a plain C
interface, bound with ctypes (no PyTorch headers, so a build takes
seconds). The library lands in the build cache (utils/compile_cache.py:
`sqlite_vector_tpu_torch/_build/`, ignored by git, unless
SVT_COMPILE_CACHE says otherwise) under a name hashed from the sources,
the headers they share (`csrc/*.cuh`) and the flags, so an edited source
is rebuilt and an unchanged one is reused. Beside it lies what ptxas
reported for each kernel (`-Xptxas -v`: registers, stack, spills), which
`ptxas_report` reads.

Nothing here runs at import: the CPU tests import every module on machines
with neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from sqlite_vector_tpu_torch.utils.compile_cache import build_root

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"

# sm_90a keeps wgmma/setmaxnreg available to later kernels. No
# --use_fast_math: it changes sqrtf, division and NaN/Inf handling.
# -Xptxas -v only reports (each kernel's registers, stack and spills).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# every exported launcher: name -> argtypes (each returns a cudaError_t)
_SIGNATURES = {
    # queries, base, mask (or None), out, B, N, d, valid, dtype, metric, stream
    "svt_block_minima": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # the same arguments, the query tile and whether it is streamed (K1's
    # tensor-core body)
    "svt_block_minima_mma": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # queries, the query planes (tf32_planes for float32, else the queries),
    # then the tensor-core body's arguments and pingpong (K1's wgmma body)
    "svt_block_minima_wgmma": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # qc, qscale, packed, alpha, csq, mask (or None), out, B, N, d, valid,
    # metric, the query tile, the streamed tile's planes and biases (or None
    # twice: resident), stream (K2's mma.sync body)
    "svt_int4_block_minima_mma": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    # the same arguments up to the query tile, the query planes
    # (k2_wgmma_planes, or None: qc itself), each query's sum of codes (or
    # None: the tile resident), whether the tile is streamed, the zeroed
    # work counters, stream (K2's wgmma body)
    "svt_int4_block_minima_wgmma": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P),
    # queries, base, gidx, mask (or None), out, B, kg, N, d, valid, dtype,
    # metric, the bytes a lane loads, stream (the int8/u8 finish's rescore)
    "svt_rescore_groups": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # the same arguments (the float finish's rescore)
    "svt_rescore_rows": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of sqlite_vector_tpu_torch are built from source at first use"
    )


def library_path() -> Path:
    """Where the library for the current sources and headers lives (built
    or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_root() / f"libsvt_kernels_{h.hexdigest()[:16]}.so"


def _nvcc_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands all at once, wait for every one, then raise with
    the output of every one that failed; returns each command's output."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    outs, failed = [], []
    for cmd, p, (out, err) in [(c, p, p.communicate()) for c, p in zip(cmds, procs)]:
        if p.returncode != 0:
            failed.append(f"nvcc failed with exit code {p.returncode}:\n{' '.join(cmd)}\n{out}{err}")
        outs.append(out + err)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.name}.{os.getpid()}"
    tmp = out.with_name(f"{tag}.tmp")
    nvcc = _nvcc()
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [str(out.parent / f"{tag}.{src.stem}.o") for src in srcs]
    try:
        reports = _nvcc_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)] for s, o in zip(srcs, objs)])
        _nvcc_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs]])
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
    _report_path(out).write_text("".join(reports))
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def _report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def ptxas_report() -> dict[str, str]:
    """What ptxas said of each function of the built library (kernels and
    non-inlined device functions): mangled name -> its "Used ... registers"
    and "... spill ..." lines, joined."""
    report: dict[str, str] = {}
    name = None
    for line in _report_path(library_path()).read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            report.setdefault(name, "")
        elif "Function properties for" in line:
            name = line.rsplit(" ", 1)[-1]
            report.setdefault(name, "")
        elif name and ("Used" in line or "spill" in line):
            report[name] = "; ".join(p for p in (report[name], line.split(":", 1)[-1].strip()) if p)
    return report


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every launcher's
    argtypes declared (pointers and the stream as c_void_p)."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
