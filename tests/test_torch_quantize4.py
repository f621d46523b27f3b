"""PyTorch port parity for packed int4 quantization and the plain int4 scan.

The port's ops/quantize4.py against sqlite_vector_tpu/ops/quantize4.py on
the same numpy inputs: codes, scales and query codes bit-equal; the int4
distance composition and the plain tile loop against the JAX functions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqlite_vector_tpu.ops import quantize4 as jq4
from sqlite_vector_tpu.types import DistanceMetric as JaxMetric
from sqlite_vector_tpu_torch.device import from_numpy
from sqlite_vector_tpu_torch.ops import quantize4 as q4
from sqlite_vector_tpu_torch.types import DistanceMetric
from tests.parity import assert_topk_parity

METRICS = [m.value for m in DistanceMetric]


def assert_int4_values_close(got, want, q, metric):
    """int4 top-k values of the port against the JAX package's jitted paths.

    Inside jit XLA turns absmax / 127 into a multiply by 1/127, so the JAX
    qscale can sit an ulp off the spec value the port computes: the cross
    term 2 * qscale * alpha * dot moves by ~1e-7 of its size, which for the
    L2 family is up to ||q||^2 + ||x~||^2 (about 2 ||q||^2 near the
    winners). So: SQUARED_L2 within 1e-6 * ||q||^2, L2 within the square
    root of that, DOT within rtol 1e-6; COSINE (qscale cancels) and L1
    (float32 sums in another order) within rtol 1e-5."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    qsq = (np.where(np.isfinite(q), q, 0).astype(np.float64) ** 2).sum(1)[:, None]
    atol = {
        "SQUARED_L2": 1e-6 * qsq,
        "L2": np.sqrt(1e-6 * qsq),
        "DOT": 1e-6 * np.abs(want),
    }.get(metric, 1e-5 * np.abs(want)) + 1e-6
    err = np.abs(got - want)
    bad = fin & (err > np.broadcast_to(atol, err.shape))
    assert not bad.any(), (metric, got[bad], want[bad])


def rows_with_edges(rng, n, dim):
    """Gaussian rows with a zero row, a duplicate, a NaN row element, +-Inf
    elements, a row with no finite element and a large-magnitude row."""
    x = rng.standard_normal((n, dim)).astype(np.float32)
    x[3] = 0.0
    x[n - 2] = x[10]
    x[5, 0] = np.nan
    x[6, dim - 1] = np.inf
    x[7, 0] = -np.inf
    x[8] = np.nan
    x[9] *= 1e25
    return x


@pytest.mark.parametrize("dim", [1, 7, 16, 95, 384])
def test_device_codes_bit_equal_numpy_spec_and_jax(dim):
    x = rows_with_edges(np.random.default_rng(dim), 300, dim)
    packed, alpha, csq = q4.quantize4_device(from_numpy(x))
    want = jq4.quantize4_np(x)
    jax_dev = [np.asarray(a) for a in jq4.quantize4_device(jnp.asarray(x))]
    for got, w, j in zip((packed, alpha, csq), want, jax_dev):
        assert got.numpy().dtype == w.dtype
        np.testing.assert_array_equal(got.numpy(), w)
        np.testing.assert_array_equal(got.numpy(), j)
    # the copied numpy spec is the JAX package's, function for function
    np.testing.assert_array_equal(q4.quantize4_np(x)[0], want[0])
    assert q4.packed_width(dim) == jq4.packed_width(dim)


def test_device_build_walks_row_chunks(monkeypatch):
    x = rows_with_edges(np.random.default_rng(1), 500, 40)
    whole = q4.quantize4_device(from_numpy(x))
    monkeypatch.setattr(q4, "_QUANT_CHUNK_ELEMS", 40 * 64)  # 8 chunks
    chunked = q4.quantize4_device(from_numpy(x))
    assert all(torch.equal(a, b) for a, b in zip(whole, chunked))


@pytest.mark.parametrize("dim", [4, 9, 384])
def test_unpack_matches_numpy(dim):
    codes = np.random.default_rng(dim).integers(-7, 8, (11, dim)).astype(np.int8)
    packed = q4.pack4_np(codes)
    np.testing.assert_array_equal(q4.unpack4(from_numpy(packed), dim).numpy(), codes)
    np.testing.assert_array_equal(q4.unpack4_np(packed, dim), jq4.unpack4_np(packed, dim))


def test_query_codes_bit_equal_jax_including_denormal_absmax():
    """qc and qscale bit-equal to the JAX function called op by op (its
    spec: a true division by 127). qsq is a float32 sum whose order differs
    between XLA and torch: rtol 1e-6 (a few ulp over 384 terms)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((40, 384)).astype(np.float32) * 3
    q[1, 5] = np.nan  # non-finite elements are zeroed first
    q[2, 7] = -np.inf
    q[3] = 0.0  # zero query: qc 0, qscale 0
    q[4] = 0.0
    q[4, 0], q[4, 1] = 2e-38, -2e-38  # 127 / absmax overflows to +inf
    qc, qs, qq = q4.quantize_query_int8(from_numpy(q))
    jqc, jqs, jqq = (np.asarray(a) for a in jq4.quantize_query_int8(jnp.asarray(q)))
    np.testing.assert_array_equal(qc.numpy(), jqc)
    np.testing.assert_array_equal(qs.numpy(), jqs)
    np.testing.assert_allclose(qq.numpy(), jqq, rtol=1e-6)
    assert qc[4, 0] == 127 and qc[4, 1] == -127 and not qc[4, 2:].any()
    assert not qc[3].any() and qs[3] == 0


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dim", [16, 95])
def test_int4_distances_match_jax_tile_distance(metric, dim):
    """Same query codes and qsq in both: the composition is op for op the
    same, so everything but L1 is bit-equal; L1 sums |q - x~| over d in
    another order (rtol 1e-5)."""
    rng = np.random.default_rng(METRICS.index(metric))
    x = rows_with_edges(rng, 260, dim)
    q = rng.standard_normal((3, dim)).astype(np.float32)
    packed, alpha, csq = jq4.quantize4_np(x)
    jqc, jqs, jqq = jq4.quantize_query_int8(jnp.asarray(q))
    want = np.asarray(
        jq4._int4_tile_distance(
            jqc, jqs, jqq, jnp.asarray(q), jnp.asarray(packed), jnp.asarray(alpha),
            jnp.asarray(csq), JaxMetric(metric), dim,
        )
    )
    got = q4.int4_distances(
        from_numpy(np.asarray(jqc)), from_numpy(np.asarray(jqs)),
        from_numpy(np.asarray(jqq)), from_numpy(q),
        q4.unpack4(from_numpy(packed), dim), from_numpy(alpha), from_numpy(csq),
        DistanceMetric(metric),
    ).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if metric == "L1":
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def test_dot_dtype_is_exact_float32_below_the_bound():
    assert q4.dot_dtype(384) is torch.float32
    assert q4.dot_dtype(16_513) is torch.float32
    assert q4.dot_dtype(16_514) is torch.float64
    # the worst-case dot at the bound is exact in float32
    d = 16_513
    qc = torch.full((1, d), -127.0)
    codes = torch.full((1, d), -8.0)
    assert float((qc @ codes.T)[0, 0]) == 127 * 8 * d


@pytest.mark.parametrize("metric", METRICS)
def test_plain_tile_loop_matches_jax(monkeypatch, metric):
    """int4_scan_topk_plain (several row tiles here) against the JAX tile
    loop _int4_scan_topk_impl: ids tie-aware against the JAX distances,
    values under assert_int4_values_close."""
    rng = np.random.default_rng(20 + METRICS.index(metric))
    n, dim, k, valid = 900, 48, 10, 870
    x = rows_with_edges(rng, n, dim)
    q = np.concatenate([x[[10, 400]], rng.standard_normal((2, dim)).astype(np.float32)])
    packed, alpha, csq = jq4.quantize4_np(x)
    jm = JaxMetric(metric)
    jv, ji = jq4._int4_scan_topk_impl(
        jnp.asarray(q), jnp.asarray(packed), jnp.asarray(alpha), jnp.asarray(csq),
        jnp.int32(valid), jnp.zeros((0,), bool),
        metric=jm, k=k, dim=dim, row_tile=jq4.INT4_ROW_TILE, has_mask=False,
    )
    monkeypatch.setattr(q4, "_TILE_ELEMS", 256 * dim)  # 256-row tiles
    gv, gi = q4.int4_scan_topk_plain(
        from_numpy(q), from_numpy(packed), from_numpy(alpha), from_numpy(csq),
        DistanceMetric(metric), k, dim=dim, valid_count=valid,
    )
    oracle = np.asarray(
        jq4.int4_scan_distances(
            jnp.asarray(q), jnp.asarray(packed), jnp.asarray(alpha),
            jnp.asarray(csq), jm, dim=dim,
        )
    ).astype(np.float64)
    oracle[:, valid:] = np.inf
    for i in range(q.shape[0]):
        assert_topk_parity(
            np.arange(n), oracle[i], gi[i].numpy(), gv[i].numpy(), k,
            rel_tol=1e-5, label=f"{metric}[{i}]",
        )
    assert_int4_values_close(gv.numpy(), np.asarray(jv), q, metric)
    assert int(gi.max()) < valid


def test_plain_tile_loop_pads_past_valid_rows():
    x = np.random.default_rng(5).standard_normal((40, 8)).astype(np.float32)
    packed, alpha, csq = jq4.quantize4_np(x)
    v, i = q4.int4_scan_topk_plain(
        from_numpy(x[:1]), from_numpy(packed), from_numpy(alpha), from_numpy(csq),
        DistanceMetric.L1, 12, dim=8, valid_count=9,
    )
    assert sorted(i[0, :9].tolist()) == list(range(9))
    assert (i[0, 9:] == -1).all() and torch.isinf(v[0, 9:]).all()
