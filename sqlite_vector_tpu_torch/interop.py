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
    mesh: Any = None,
) -> Dataset:
    """Dataset from state arrays.

    arrays:
      "vectors"  [count, dim] rows in the dataset dtype (required);
      "ids"      [count] int64 row ids (required);
      "dead"     [count] bool tombstones (optional): rows removed but not
                 compacted, masked out of every scan of the live rows;
      "codes"    [qcount, dim] uint8/int8 quantized codes (optional), with
      "qtype"    the resolved QuantType or its value ("UINT8" / "INT8"),
      "scale", "offset" the quantization params;
    or, for an int4 quantization (optional, instead of "codes"):
      "packed"   [qcount, ceil(dim/2)] uint8 packed int4 codes, with
      "alpha"    [qcount] float32 per-row scales and
      "csq"      [qcount] int32 code square-sums, and optionally the refine
      sidecar "codes8" [qcount, dim], "qtype8", "scale8", "offset8";
    and for either quantization:
      "quant_ids" [qcount] int64 row ids of the quantize-time snapshot
                 (optional; default: the rows' ids, qcount = count);
      "stale"    True when rows changed after the codes were built.

    A JAX dataset `jds` hands its state over as np.asarray of jds._vectors,
    jds._ids and jds._dead cut to jds._count, and of the jds._quant arrays
    cut to jds._quant.count, with jds._quant.ids and jds._quant.stale.
    (A JAX mesh dataset's arrays are sharded jax.Arrays: np.asarray gathers
    them.) With `mesh` (parallel.make_mesh) the rows and codes are laid out
    over it as Dataset(mesh=) lays them, so a JAX mesh dataset's state
    carries onto a port mesh dataset.
    """
    vectors = np.asarray(arrays["vectors"])
    ids = np.asarray(arrays["ids"], np.int64)
    dead = arrays.get("dead")
    if dead is None:
        ds = Dataset.from_arrays(name, vectors, ids, options=options, device=device, mesh=mesh)
    else:
        ds = Dataset.from_arrays(name, vectors[:0], ids[:0], options=options, device=device, mesh=mesh)
        ds._adopt_rows(vectors, ids, np.asarray(dead, bool))
    snapshot = {"ids": arrays.get("quant_ids"), "stale": bool(arrays.get("stale", False))}
    if arrays.get("codes") is not None:
        ds._install_quant(
            np.asarray(arrays["codes"]),
            _qtype(arrays["qtype"]),
            float(arrays["scale"]),
            float(arrays["offset"]),
            **snapshot,
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
            **snapshot,
        )
    return ds


def _qtype(q: Any) -> QuantType:
    return QuantType(getattr(q, "value", q))
