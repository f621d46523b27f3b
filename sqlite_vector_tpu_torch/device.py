"""Device resolution: the port runs on the device it is given, never a
silent substitute.

`None` means the first CUDA device. A CUDA request on a machine without a
usable GPU raises instead of falling back to the CPU, so a run that was
meant for the card can never report CPU numbers. Tests pass
`device="cpu"` explicitly.

It also holds the host <-> device conversions of rows, bfloat16's
included (kept on the host as raw uint16 bits).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from sqlite_vector_tpu_torch.errors import VectorConfigError
from sqlite_vector_tpu_torch.utils.profiling import count


def resolve_device(device: Any = None) -> torch.device:
    """Return the torch.device to place a dataset on (default: "cuda")."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise VectorConfigError(
            "No CUDA device is available: VectorStore() defaults to the GPU "
            "and never falls back to the CPU. Pass device='cpu' to run on "
            "the CPU explicitly."
        )
    if dev.type not in ("cuda", "cpu"):
        raise VectorConfigError(
            f"Unsupported device '{dev}': expected 'cuda' or 'cpu'."
        )
    return dev


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """bfloat16 values as their raw uint16 bits, the port's host form of
    bfloat16 rows (numpy has no bfloat16 of its own). A bfloat16 array
    (ml_dtypes) is reinterpreted; any other is rounded to nearest even,
    by ml_dtypes where it is installed (the JAX package's rounding, also
    from float64) and else by torch from float32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    try:
        import ml_dtypes
    except ImportError:
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    return a.astype(ml_dtypes.bfloat16).view(np.uint16)


def bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """The exact float32 values of bfloat16 bits (uint16)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def bits_to_device(bits: np.ndarray, device: Any) -> torch.Tensor:
    """A bfloat16 tensor on `device` from uint16 bits: the bits travel as
    int16 and are reinterpreted there, so no numpy bfloat16 is needed."""
    return from_numpy(np.asarray(bits).view(np.int16), device).view(torch.bfloat16)


def from_numpy(arr: np.ndarray, device: Any = "cpu") -> torch.Tensor:
    """A copy of a numpy array as a tensor on `device`, dtype kept (the
    tensor never aliases the caller's array). torch cannot read numpy's
    bfloat16 (ml_dtypes), so bfloat16 travels as its exact float32 values
    and is narrowed back on the device. The bytes copied count under
    `h2d_bytes` while recording (utils.profiling), whatever the device."""
    if arr.dtype.name == "bfloat16":
        f32 = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
        count("h2d_bytes", f32.nbytes)
        return f32.to(device).to(torch.bfloat16)
    count("h2d_bytes", arr.nbytes)
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # torch.from_numpy wants a writable buffer
        arr = arr.copy()
    return torch.from_numpy(arr).to(device, copy=True)
