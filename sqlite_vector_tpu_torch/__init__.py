"""sqlite_vector_tpu_torch — the PyTorch + CUDA port of sqlite_vector_tpu.

Same contract as the JAX package beside it (which stays the reference):
the Dataset/VectorStore API, its option strings, enums and errors, on one
device: every search mode, int8 and int4 quantization, host storage,
persistence, the non-finite policies, the SQLite surface (sqlite.py),
serving (BatchingSearcher, serve) and the CLI (python -m
sqlite_vector_tpu_torch). Scans on CUDA tensors run the hand-written
kernels K1 (csrc/block_minima_mma.cu, csrc/block_minima.cu) and K2
(csrc/int4_minima_mma.cu, csrc/int4_minima.cu), built with nvcc at first
use; on CPU tensors they run the kernels' plain PyTorch twins.

This package imports torch and numpy, never jax.
"""

from sqlite_vector_tpu_torch.types import (
    DistanceMetric,
    QuantType,
    VectorOptions,
    VectorType,
    parse_options,
)
from sqlite_vector_tpu_torch.errors import (
    VectorCodecError,
    VectorConfigError,
    VectorError,
    VectorStateError,
)
from sqlite_vector_tpu_torch.dataset import Dataset, VectorStore
from sqlite_vector_tpu_torch.serving import BatchingSearcher, serve
from sqlite_vector_tpu_torch.version import __version__, backend, version

__all__ = [
    "VectorType",
    "DistanceMetric",
    "QuantType",
    "VectorOptions",
    "parse_options",
    "VectorError",
    "VectorConfigError",
    "VectorCodecError",
    "VectorStateError",
    "Dataset",
    "VectorStore",
    "BatchingSearcher",
    "serve",
    "__version__",
    "version",
    "backend",
]
