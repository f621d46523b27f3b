"""Version and backend introspection (the port's vector_version() /
vector_backend(), reference: src/sqlite-vector.c:2545-2553)."""

from __future__ import annotations

import torch

__version__ = "0.4.0"


def version() -> str:
    """Return the framework version string (reference: vector_version())."""
    return __version__


def backend() -> str:
    """Return the active compute backend name (reference: vector_backend()).

    Values:
      - ``"cuda/kernel"`` — a CUDA device is present; scans on CUDA tensors
                            run the hand-written block-minima kernel
                            (ops.block_scan).
      - ``"cpu/torch"``   — no CUDA device; scans run the kernel's plain
                            PyTorch twin on CPU tensors.
    """
    return "cuda/kernel" if torch.cuda.is_available() else "cpu/torch"
