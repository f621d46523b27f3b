"""Rows past the widths whose query tile K1's mma.sync body keeps resident
in shared memory (float32 d > 3,424, 16-bit d > 6,848, codes d > 13,696):
such scans take a tensor-core body with its query tile streamed (the wgmma
body where TMA takes the rows, ops/block_scan.py:wgmma_plan; else the
mma.sync body's, mma_streams_queries) where they used to take the
CUDA-core body. On the
CPU both bodies are the twin, so this holds the port's Dataset.search at
those widths against the JAX package's on the same seeded rows, in exact
and int8 quantized mode, through tests/test_torch_mutations.py:
compare_mode (exact: the tie-aware top-k check against the JAX oracle and
distances within REL_TOL_BY_TYPE, f32 sums in another order; quantized:
ids and snapped distances equal), and pins the route the card takes.
"""

import numpy as np
import pytest
import torch

from sqlite_vector_tpu_torch.ops import block_scan
from sqlite_vector_tpu_torch.types import DistanceMetric
from tests.test_torch_mutations import Pair, compare_mode
from tests.test_torch_persistence import rows_of

# one column past each resident edge, and the 4,096 columns of today's
# widest public embedding models
WIDE = [("FLOAT32", 3425), ("FLOAT32", 4096), ("FLOAT16", 6849), ("FLOATB16", 6849),
        ("UINT8", 13697), ("INT8", 13697)]
TORCH_DTYPE = {"FLOAT32": torch.float32, "FLOAT16": torch.float16, "FLOATB16": torch.bfloat16,
               "UINT8": torch.uint8, "INT8": torch.int8}
# the widest rows whose query tile stays resident
RESIDENT_EDGE = {"FLOAT32": 3424, "FLOAT16": 6848, "FLOATB16": 6848, "UINT8": 13696, "INT8": 13696}


@pytest.mark.parametrize("metric", ["L2", "SQUARED_L2", "COSINE", "DOT"])
@pytest.mark.parametrize("vtype, dim", WIDE, ids=str)
def test_wide_rows_search_matches_jax(vtype, dim, metric):
    rng = np.random.default_rng(dim + len(metric))
    base = rows_of(vtype, rng, (300, dim))
    base[150] = base[20]  # a tie
    pair = Pair(f"dimension={dim},type={vtype},distance={metric}")
    pair.do("add", base)
    q = np.concatenate([base[[20, 201]], rows_of(vtype, rng, (2, dim))])
    compare_mode(pair.j, pair.p, q, "exact")
    pair.do("quantize")
    compare_mode(pair.j, pair.p, q, "quantized")
    # on the card, every scan of these searches takes a tensor-core body,
    # its query tile streamed: the wgmma body where TMA takes the rows'
    # pitch (f32 at 4,096), the mma.sync body otherwise
    dt = TORCH_DTYPE[vtype]
    body = block_scan.k1_body(dt, DistanceMetric(metric), dim)
    if body == "wgmma":
        assert dt.is_floating_point and dim * dt.itemsize % 16 == 0
        assert block_scan.wgmma_plan(dt, dim, len(q))[1]
    else:
        assert body == "mma" and block_scan.mma_streams_queries(dt, dim)
    assert not block_scan.mma_streams_queries(dt, RESIDENT_EDGE[vtype])
