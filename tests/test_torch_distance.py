"""PyTorch port parity: sqlite_vector_tpu_torch.ops.distance against the
JAX package's ops.distance on the same numpy inputs (both on the CPU)."""

import ml_dtypes
import numpy as np
import pytest

from sqlite_vector_tpu.ops import distance as jax_distance
from sqlite_vector_tpu.ops.rerank import candidate_distances as jax_candidates
from sqlite_vector_tpu.types import DistanceMetric as JaxMetric
from sqlite_vector_tpu_torch.device import from_numpy
from sqlite_vector_tpu_torch.ops import distance as port_distance
from sqlite_vector_tpu_torch.ops.rerank import candidate_distances
from sqlite_vector_tpu_torch.types import DistanceMetric
from tests.parity import REL_TOL_BY_TYPE

DTYPES = {
    "FLOAT32": np.float32,
    "FLOAT16": np.float16,
    "FLOATB16": ml_dtypes.bfloat16,
    "UINT8": np.uint8,
    "INT8": np.int8,
}
METRICS = [m.value for m in DistanceMetric]


def rows(rng, dtype, shape):
    if dtype in (np.uint8, np.int8):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max + 1, shape).astype(dtype)
    return rng.standard_normal(shape).astype(np.float32).astype(dtype)


def assert_matches(got, want, vtype):
    """Integers: bit-equal (exact integer components; sqrt and divide are
    correctly rounded on both sides). f32: summation order only (rtol/atol
    1e-5). f16/bf16: tests/parity.py's bound for the type."""
    if vtype in ("UINT8", "INT8"):
        np.testing.assert_array_equal(got, want)
        return
    tol = 1e-5 if vtype == "FLOAT32" else REL_TOL_BY_TYPE[vtype]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("vtype", list(DTYPES))
@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_distance_matches_jax(vtype, metric):
    rng = np.random.default_rng(METRICS.index(metric) * 10 + list(DTYPES).index(vtype))
    q = rows(rng, DTYPES[vtype], (4, 64))
    b = rows(rng, DTYPES[vtype], (300, 64))
    b[7] = q[0]  # self-match: exact 0 through the residual clamp
    b[11] = 0  # zero-norm row: cosine 1.0
    q[3] = 0  # zero-norm query
    want = np.asarray(jax_distance.pairwise_distance(q, b, JaxMetric(metric)))
    got = port_distance.pairwise_distance(
        from_numpy(q), from_numpy(b), DistanceMetric(metric)
    ).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert_matches(got, want, vtype)


@pytest.mark.parametrize("metric", ["L2", "SQUARED_L2", "COSINE"])
def test_float_nan_row_matches_jax(metric):
    rng = np.random.default_rng(3)
    q = rows(rng, np.float32, (2, 32))
    b = rows(rng, np.float32, (50, 32))
    b[4, 3] = np.nan
    q[1] = 0  # zero-norm query against the NaN row: cosine 1.0 wins
    want = np.asarray(jax_distance.pairwise_distance(q, b, JaxMetric(metric)))
    got = port_distance.pairwise_distance(
        from_numpy(q), from_numpy(b), DistanceMetric(metric)
    ).numpy()
    assert_matches(got, want, "FLOAT32")


def test_int_l2_exact_through_intermediate_wrap():
    """u8 at dim 20000: qsq + csq (~2.6e9) exceeds int32, but the mod-2^32
    composition stays exact while the final value fits int32
    (INT_L2_EXACT_MAX_DIM) — the JAX package's contract, kept by the port's
    scan distances and its candidate rescorer."""
    dim = 20000
    rng = np.random.default_rng(7)
    q = rng.integers(0, 256, (2, dim)).astype(np.uint8)
    b = rng.integers(0, 256, (3, dim)).astype(np.uint8)
    q[0, :] = 255  # adversarial: max qsq
    b[0, :] = 0
    b[0, 1::2] = 255  # disjoint support: small dot
    want = ((q.astype(np.int64)[:, None, :] - b.astype(np.int64)[None]) ** 2).sum(-1)
    assert want.max() < 2**31 and dim <= port_distance.INT_L2_EXACT_MAX_DIM
    for metric in ("SQUARED_L2", "L2"):
        got = port_distance.pairwise_distance(
            from_numpy(q), from_numpy(b), DistanceMetric(metric)
        ).numpy()
        jax_got = np.asarray(jax_distance.pairwise_distance(q, b, JaxMetric(metric)))
        np.testing.assert_array_equal(got, jax_got)
    np.testing.assert_array_equal(
        port_distance.pairwise_distance(
            from_numpy(q), from_numpy(b), DistanceMetric.SQUARED_L2
        ).numpy(),
        want.astype(np.float32),
    )
    cand = np.ascontiguousarray(np.broadcast_to(b, (2, 3, dim)))
    got2 = candidate_distances(
        from_numpy(q), from_numpy(cand), DistanceMetric.SQUARED_L2
    ).numpy()
    np.testing.assert_array_equal(got2, want.astype(np.float32))


@pytest.mark.parametrize("vtype", ["FLOAT32", "FLOATB16", "UINT8", "INT8"])
@pytest.mark.parametrize("metric", METRICS)
def test_candidate_distances_matches_jax(vtype, metric):
    rng = np.random.default_rng(11 + METRICS.index(metric))
    q = rows(rng, DTYPES[vtype], (3, 48))
    cand = rows(rng, DTYPES[vtype], (3, 40, 48))
    cand[0, 5] = q[0]
    cand[1, 9] = 0
    want = np.asarray(jax_candidates(q, cand, JaxMetric(metric)))
    got = candidate_distances(
        from_numpy(q), from_numpy(cand), DistanceMetric(metric)
    ).numpy()
    assert_matches(got, want, vtype)
