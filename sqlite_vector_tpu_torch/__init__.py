"""sqlite_vector_tpu_torch — the PyTorch + CUDA port of sqlite_vector_tpu.

Same contract as the JAX package beside it (which stays the reference):
the Dataset/VectorStore API, its option strings, enums and errors. This
slice ports the main path on one device: create, add, exact search, int8
quantize and quantized search. Scans on CUDA tensors run a hand-written
block-minima kernel (K1: csrc/block_minima_mma.cu on tensor cores and
csrc/block_minima.cu on CUDA cores, built with nvcc at first use); on CPU
tensors they run the kernel's plain PyTorch twin.

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
    "__version__",
    "version",
    "backend",
]
