"""Build a port Dataset from another engine's dataset state.

The state is plain numpy, so this module needs nothing but numpy and the
port: a caller holding a sqlite_vector_tpu (JAX) dataset extracts its
arrays with np.asarray and hands them over, and both engines then search
the SAME rows, and the SAME int8 or int4 codes, which is how the parity
tests compare them.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from sqlite_vector_tpu_torch.dataset import Dataset
from sqlite_vector_tpu_torch.types import QuantType, VectorOptions


def dataset_from_state(
    arrays: Mapping[str, Any],
    options: str | VectorOptions | None,
    device: Any = None,
    *,
    name: str = "interop",
) -> Dataset:
    """Dataset from state arrays.

    arrays:
      "vectors"  [count, dim] rows in the dataset dtype (required);
      "ids"      [count] int64 row ids (required);
      "codes"    [count, dim] uint8/int8 quantized codes (optional), with
      "qtype"    the resolved QuantType or its value ("UINT8" / "INT8"),
      "scale", "offset" the quantization params;
    or, for an int4 quantization (optional, instead of "codes"):
      "packed"   [count, ceil(dim/2)] uint8 packed int4 codes, with
      "alpha"    [count] float32 per-row scales and
      "csq"      [count] int32 code square-sums, and optionally the refine
      sidecar "codes8" [count, dim], "qtype8", "scale8", "offset8".
    """
    vectors = np.asarray(arrays["vectors"])
    ds = Dataset.from_arrays(
        name, vectors, np.asarray(arrays["ids"], np.int64), options=options,
        device=device,
    )
    if arrays.get("codes") is not None:
        ds._install_quant(
            np.asarray(arrays["codes"]),
            _qtype(arrays["qtype"]),
            float(arrays["scale"]),
            float(arrays["offset"]),
        )
    elif arrays.get("packed") is not None:
        sidecar = None
        if arrays.get("codes8") is not None:
            sidecar = (
                np.asarray(arrays["codes8"]),
                _qtype(arrays["qtype8"]),
                float(arrays["scale8"]),
                float(arrays["offset8"]),
            )
        ds._install_quant4(
            np.asarray(arrays["packed"]),
            np.asarray(arrays["alpha"]),
            np.asarray(arrays["csq"]),
            sidecar,
        )
    return ds


def _qtype(q: Any) -> QuantType:
    return QuantType(getattr(q, "value", q))
