"""Build a port Dataset from another engine's dataset state.

The state is plain numpy, so this module needs nothing but numpy and the
port: a caller holding a sqlite_vector_tpu (JAX) dataset extracts its
arrays with np.asarray and hands them over, and both engines then search
the SAME rows, and the SAME int8 codes, which is how the parity tests
compare them.
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
      "scale", "offset" the quantization params.
    """
    vectors = np.asarray(arrays["vectors"])
    ds = Dataset.from_arrays(
        name, vectors, np.asarray(arrays["ids"], np.int64), options=options,
        device=device,
    )
    if arrays.get("codes") is not None:
        qtype = QuantType(getattr(arrays["qtype"], "value", arrays["qtype"]))
        ds._install_quant(
            np.asarray(arrays["codes"]),
            qtype,
            float(arrays["scale"]),
            float(arrays["offset"]),
        )
    return ds
