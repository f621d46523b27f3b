"""sqlite_vector_tpu_torch — the PyTorch + CUDA port of sqlite_vector_tpu.

Same contract as the JAX package beside it (which stays the reference):
the Dataset/VectorStore API, its option strings, enums and errors, on one
device or over a mesh of them (parallel/: row-sharded and rows x dim
datasets, one process driving every device): every search mode, int8 and
int4 quantization, host storage, persistence, the non-finite policies,
the SQLite surface (sqlite.py), serving (BatchingSearcher, serve) and the
CLI (python -m sqlite_vector_tpu_torch), and utils/ (QueryStats,
timed_search, torch.profiler traces, the build cache). Scans on CUDA
tensors run the hand-written kernels K1 (csrc/block_minima_wgmma.cu,
csrc/block_minima_mma.cu, csrc/block_minima.cu), K2
(csrc/int4_minima_wgmma.cu, csrc/int4_minima_mma.cu) and the finish's
rescores (csrc/rescore_codes.cu, csrc/rescore_rows.cu), built with nvcc at
first use; on CPU tensors they run the kernels' plain PyTorch twins.

This package imports torch and numpy, never jax.
"""

# the kernel build cache is resolved when a build looks for its file (see
# utils.compile_cache), never at import: importing builds nothing
from sqlite_vector_tpu_torch.utils.compile_cache import enable_persistent_cache

from sqlite_vector_tpu_torch.types import (
    DEFAULT_MAX_MEMORY,
    DistanceMetric,
    QuantType,
    VectorOptions,
    VectorType,
    human_to_number,
    parse_options,
)
from sqlite_vector_tpu_torch.errors import (
    VectorCodecError,
    VectorConfigError,
    VectorError,
    VectorStateError,
)
from sqlite_vector_tpu_torch.codec import (
    array_to_blob,
    blob_to_array,
    vector_as_blob,
    vector_from_json,
)
from sqlite_vector_tpu_torch.dataset import Dataset, VectorStore
from sqlite_vector_tpu_torch.parallel import make_mesh
from sqlite_vector_tpu_torch.serving import BatchingSearcher, serve
from sqlite_vector_tpu_torch.version import __version__, backend, version

__all__ = [
    "VectorType",
    "DistanceMetric",
    "QuantType",
    "VectorOptions",
    "parse_options",
    "human_to_number",
    "DEFAULT_MAX_MEMORY",
    "VectorError",
    "VectorConfigError",
    "VectorCodecError",
    "VectorStateError",
    "vector_from_json",
    "vector_as_blob",
    "blob_to_array",
    "array_to_blob",
    "Dataset",
    "VectorStore",
    "make_mesh",
    "BatchingSearcher",
    "serve",
    "__version__",
    "version",
    "backend",
    "enable_persistent_cache",
]
