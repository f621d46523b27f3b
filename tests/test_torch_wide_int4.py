"""Packed-int4 quantization and search past d = 16,384, where K2's
tensor-core body streams its query tile beside the codes (ops/int4_scan.py:
k2_streams_queries); these widths used to take its CUDA-core body. On the
CPU both bodies are the twin, so this holds the port against the JAX
package on the same seeded rows: quantize(qtype="int4", refine=True) codes,
row scales and code norms bit-equal (and the int8 sidecar), and
int4-quantized and refine search through tests/test_torch_mutations.py:
compare_mode (ids tie-aware; int4 values within assert_int4_values_close,
refine within rtol 1e-5: float32 rescores in another order), unfiltered,
with an ids_filter, and over tombstones after remove(). d = 16,433 and
16,434 put the high plane's first code at an odd packed byte (h = 8,217),
where the raw query codes allow no aligned copy (the kernel takes
k2_query_planes' layout instead)."""

import numpy as np
import pytest

from sqlite_vector_tpu_torch.ops import int4_scan
from tests.test_torch_mutations import Pair, compare_mode
from tests.test_torch_persistence import rows_of

N = 300


def assert_same_int4_state(pair):
    """The int4 codes, their scales and norms, and the int8 sidecar of both
    datasets, bit for bit."""
    p, j = pair.p._quant, pair.j._quant
    n = p.count
    assert n == j.count
    for name in ("codes", "row_scale", "sq_norms", "codes8"):
        np.testing.assert_array_equal(
            getattr(p, name).numpy(), np.asarray(getattr(j, name))[:n], err_msg=name
        )
    assert (p.scale8, p.offset8) == (j.scale8, j.offset8)


@pytest.mark.parametrize("metric", ["L2", "COSINE", "DOT"])
@pytest.mark.parametrize("vtype", ["FLOAT32", "FLOATB16"])
@pytest.mark.parametrize("dim", [16433, 16434])
def test_wide_int4_quantize_and_search_match_jax(dim, vtype, metric):
    rng = np.random.default_rng(dim + len(vtype) + len(metric))
    base = rows_of(vtype, rng, (N, dim))
    base[150] = base[20]  # a tie
    pair = Pair(f"dimension={dim},type={vtype},distance={metric}")
    ids = pair.do("add", base)
    pair.do("quantize", qtype="int4", refine=True)
    assert_same_int4_state(pair)
    q = np.concatenate([base[[20, 201]], rows_of(vtype, rng, (2, dim))])
    flt = ids[rng.permutation(N)[: N // 3]]
    for mode in ("quantized", "refine"):
        compare_mode(pair.j, pair.p, q, mode)
        compare_mode(pair.j, pair.p, q, mode, ids_filter=flt)
    # tombstones: the quantize-time snapshot scanned with a row mask
    pair.do("remove", ids[[20, 45, 201, 299]])
    for mode in ("quantized", "refine"):
        compare_mode(pair.j, pair.p, q, mode)
    # on the card these scans take the tensor-core body, the query tile
    # streamed, at every batch
    for b in (1, 4, 64):
        assert int4_scan.k2_body(dim) == "mma" and int4_scan.k2_streams_queries(dim, b)
