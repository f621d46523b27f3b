"""PyTorch port parity for the search surface: ids_filter in all five
modes, rerank on its two routes, approx, distances (exact, int8, int4) and
the quantization lifecycle (is_quantized, quantize_memory, preload,
drop_quantization), against the JAX package on the same seeded rows, both
on the CPU. Each test mirrors the JAX test it names and then compares the
two packages with tests/test_torch_mutations.py:compare_mode, whose
docstring states the tolerance of each mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqlite_vector_tpu as jax_svt
import sqlite_vector_tpu_torch as svt
from sqlite_vector_tpu import oracle
from sqlite_vector_tpu.ops import quantize4 as jq4
from sqlite_vector_tpu.ops.rerank import rerank_topk as jax_rerank_topk
from sqlite_vector_tpu.types import DistanceMetric as JaxMetric
from sqlite_vector_tpu.types import VectorType as JaxVectorType
from sqlite_vector_tpu_torch.device import from_numpy
from sqlite_vector_tpu_torch.ops import quantize4 as q4
from sqlite_vector_tpu_torch.ops.rerank import rerank_topk
from sqlite_vector_tpu_torch.ops.scan import scan_topk
from sqlite_vector_tpu_torch.types import DistanceMetric
from tests.parity import expected_int4_distances
from tests.test_torch_mutations import Pair, compare_mode
from tests.test_torch_quantize4 import assert_int4_values_close

FILTER_MODES = [
    ("exact", None), ("approx", None), ("quantized", "int8"), ("quantized", "int4"),
    ("rerank", "int8"), ("rerank", "int4"), ("refine", "int4"),
]


@pytest.mark.parametrize("mode, qtype", FILTER_MODES, ids=lambda v: str(v))
def test_ids_filter_in_every_mode(mode, qtype):
    """JAX test_ids_filter_search, test_refine.py::test_refine_ids_filter and
    test_quantize4.py::test_dataset_int4_ids_filter_and_staleness: a
    filtered-out row never comes back, a small allowlist restricts the
    results, and both packages agree; then after a remove and an add the
    filter still indexes the right space in each mode."""
    rng = np.random.default_rng(len(mode) + (qtype == "int4"))
    base = rng.standard_normal((300, 16)).astype(np.float32)
    pair = Pair("dimension=16,type=FLOAT32,distance=L2")
    ids = pair.do("add", base)
    if qtype:
        pair.do("quantize", qtype=qtype, refine=mode == "refine")
    q = base[10]
    allowed = ids[ids != ids[10]]
    got, dist = pair.p.search(q, 3, mode=mode, ids_filter=allowed)
    assert ids[10] not in got and dist[0] > 0
    got, _ = pair.p.search(q, 10, mode=mode, ids_filter=ids[:4])
    assert set(got.tolist()) <= set(ids[:4].tolist()) and len(got) == 4
    got, _ = pair.p.search(base[55], 3, mode=mode, ids_filter=ids[50:60])
    assert got[0] == ids[55] and np.isin(got, ids[50:60]).all()
    got, _ = pair.p.search(q, 5, mode=mode, ids_filter=[])
    assert len(got) == 0
    qs = np.concatenate([base[[10, 200]], rng.standard_normal((2, 16)).astype(np.float32)])
    for flt in (allowed, ids[:4], ids[::3], np.asarray([ids[7]])):
        compare_mode(pair.j, pair.p, qs, mode, ids_filter=flt)
    pair.do("remove", ids[100:130])
    pair.do("add", base[:20] + 0.5)
    assert pair.p.quant_stale == bool(qtype)
    compare_mode(pair.j, pair.p, qs, mode, ids_filter=ids[90:220])


@pytest.mark.parametrize("route", ["fused", "remap"])
def test_rerank_mode_exact_distances(route):
    """JAX test_rerank_mode_exact_distances on both routes: fresh int8
    codes take the fused device route, stale ones (rows added after
    quantize) the id-remap route. Distances are true float L2 values
    (oracle within 1e-4), the top-10 overlaps the exact one in >= 9, and
    both packages agree. The filter applies; without codes it raises."""
    rng = np.random.default_rng(21)
    base = rng.standard_normal((2000, 24)).astype(np.float32)
    pair = Pair("dimension=24,type=FLOAT32")
    ids = pair.do("add", base)
    pair.do("quantize")
    if route == "remap":
        pair.do("add", base[:3] + 3.0)
        assert pair.p.quant_stale
    q = rng.standard_normal((3, 24)).astype(np.float32)
    got_ids, got_vals = pair.p.search(q, 10, mode="rerank", expand=4)
    dec = pair.p.last_rerank_decomposition
    assert (dec["translate_s"] > 0) == (route == "remap") and dec["batch"] == 3
    ref = oracle.distance(q, base, JaxMetric.L2, JaxVectorType.F32)
    for bi in range(3):
        oidx = np.argsort(ref[bi], kind="stable")[:10]
        assert len(set(got_ids[bi].tolist()) & set(ids[oidx].tolist())) >= 9
        np.testing.assert_allclose(
            got_vals[bi], np.sort(oracle.snap_zero(ref[bi][np.searchsorted(ids, got_ids[bi])])),
            rtol=1e-4, atol=1e-4,
        )
    compare_mode(pair.j, pair.p, q, "rerank")
    compare_mode(pair.j, pair.p, q, "rerank", ids_filter=ids[:50])
    got_ids, _ = pair.p.search(q[0], 5, mode="rerank", ids_filter=ids[:50])
    assert set(got_ids.tolist()) <= set(ids[:50].tolist())
    for mode in ("rerank", "quantized"):
        compare_mode(pair.j, pair.p, q, mode, k=3)
    pair.do("drop_quantization")
    pair.raises("VectorStateError", "search", q[0], 5, mode="rerank")


@pytest.mark.parametrize("metric", ["L2", "SQUARED_L2", "COSINE", "DOT", "L1"])
def test_rerank_topk_matches_jax(metric):
    """ops.rerank.rerank_topk (K1's twin for stage 1 here) against the JAX
    function on the same rows and codes: ids equal up to ties, values
    within rtol 1e-5 (float32 rescore sums in another order)."""
    rng = np.random.default_rng(22)
    base = rng.standard_normal((900, 20)).astype(np.float32)
    base[899] = base[5]
    q = np.concatenate([base[[5, 400]], rng.standard_normal((2, 20)).astype(np.float32)])
    qt, scale, offset = oracle.compute_quant_params(base, jax_svt.QuantType.I8)
    codes = oracle.quantize(base, scale, offset, qt)
    qq = oracle.quantize(q, scale, offset, qt)
    jv, ji = jax_rerank_topk(q, base, qq, codes, JaxMetric(metric), 7, expand=3)
    gv, gi = rerank_topk(
        from_numpy(q), from_numpy(base), from_numpy(qq), from_numpy(codes),
        DistanceMetric(metric), 7, expand=3,
    )
    gv, gi, jv, ji = gv.numpy(), gi.numpy(), np.asarray(jv), np.asarray(ji)
    np.testing.assert_allclose(gv, jv, rtol=1e-5, atol=1e-5)
    swapped = gi != ji
    np.testing.assert_allclose(gv[swapped], jv[swapped], rtol=1e-5, atol=1e-5)
    if metric in ("L2", "SQUARED_L2"):
        assert gi[0, 0] == 5 and gv[0, 0] == 0.0  # the earlier duplicate wins


def test_rerank_near_zero_tie_parity():
    """JAX test_rerank_near_zero_tie_parity: rerank_topk snaps near-zero
    distances before its top-k and ranks ties by row, as scan_topk does;
    and equals the JAX rerank_topk."""
    q = np.float32([[1.0, 0.0]])
    base = np.float32([[-4e-7, 0.0], [-2e-7, 0.0]])
    want_d, want_i = scan_topk(from_numpy(q), from_numpy(base), DistanceMetric.DOT, 2)
    qt, scale, offset = oracle.compute_quant_params(base, jax_svt.QuantType.I8)
    codes = oracle.quantize(base, scale, offset, qt)
    qq = oracle.quantize(q, scale, offset, qt)
    got_d, got_i = rerank_topk(
        from_numpy(q), from_numpy(base), from_numpy(qq), from_numpy(codes), DistanceMetric.DOT, 2
    )
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    jd, ji = jax_rerank_topk(q, base, qq, codes, JaxMetric.DOT, 2)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(jd))


def test_approx_mode():
    """JAX test_approx_mode: self first at 0, and approx equals exact bit
    for bit (both run the exact scan, as JAX does off the TPU); the JAX
    approx results agree."""
    rng = np.random.default_rng(23)
    base = rng.standard_normal((5000, 32)).astype(np.float32)
    pair = Pair("dimension=32,type=FLOAT32")
    ids = pair.do("add", base)
    q = base[123]
    got, dist = pair.do("search", q, 10, mode="approx", recall_target=0.95)
    assert got[0] == ids[123] and dist[0] == 0.0
    exact = pair.p.search(q, 10)
    np.testing.assert_array_equal(got, exact[0])
    np.testing.assert_array_equal(dist, exact[1])


def test_approx_mode_with_mask():
    """JAX test_approx_mode_with_mask: tombstones and ids_filter."""
    rng = np.random.default_rng(24)
    base = rng.standard_normal((4000, 16)).astype(np.float32)
    pair = Pair("dimension=16,type=FLOAT32")
    ids = pair.do("add", base)
    pair.do("remove", ids[100:200])
    got, _ = pair.do("search", base[150], 5, mode="approx")
    assert ids[150] not in got
    got, dist = pair.do("search", base[50], 5, mode="approx", ids_filter=ids[:60])
    assert got[0] == ids[50] and dist[0] == 0.0 and np.isin(got, ids[:60]).all()
    q = base[[50, 150, 3000]]
    for flt in (None, ids[:60], ids[::7]):
        a = pair.p.search(q, 9, mode="approx", ids_filter=flt)
        e = pair.p.search(q, 9, ids_filter=flt)
        np.testing.assert_array_equal(a[0], e[0])
        np.testing.assert_array_equal(a[1], e[1])
        compare_mode(pair.j, pair.p, q, "approx", ids_filter=flt)


def test_approx_ids_filter():
    """JAX test_approx_ids_filter: the filter is in live-row space before
    and after quantize + remove."""
    rng = np.random.default_rng(25)
    base = rng.standard_normal((200, 16)).astype(np.float32)
    pair = Pair("dimension=16,type=FLOAT32")
    ids = pair.do("add", base)
    allowed = ids[50:100]
    got, _ = pair.do("search", base[10], 5, mode="approx", ids_filter=allowed)
    assert set(got.tolist()) <= set(allowed.tolist())
    pair.do("quantize")
    pair.do("remove", ids[:10])
    got, _ = pair.do("search", base[60], 5, mode="approx", ids_filter=allowed)
    assert got[0] == ids[60]


def test_recall_target_is_validated_as_in_jax():
    """recall_target in (0, 1] is accepted; outside it both packages raise
    (the JAX package through XLA's approx_min_k, the port up front)."""
    rng = np.random.default_rng(26)
    pair = Pair("dimension=8,type=FLOAT32")
    pair.do("add", rng.standard_normal((50, 8)).astype(np.float32))
    q = np.ones(8, np.float32)
    for rt in (0.5, 1.0, 1e-3):
        pair.do("search", q, 3, mode="approx", recall_target=rt)
    for rt in (0.0, -1.0, 1.5):
        with pytest.raises(Exception):
            pair.j.search(q, 3, mode="approx", recall_target=rt)
        with pytest.raises(svt.VectorConfigError, match="recall_target"):
            pair.p.search(q, 3, mode="approx", recall_target=rt)


@pytest.mark.parametrize("metric", ["L2", "COSINE", "DOT", "L1"])
def test_distances_stream(metric):
    """JAX test_distances_stream: [N] for one query, the self-row at 0 (L2);
    exact distances within 3e-5 of JAX's, tombstoned columns dropped;
    int8 (exact=False) integer-domain values equal, over the quantize-time
    snapshot even after rows change."""
    rng = np.random.default_rng(27)
    base = rng.standard_normal((30, 12)).astype(np.float32)
    pair = Pair(f"dimension=12,type=FLOAT32,distance={metric}")
    ids = pair.do("add", base)
    d = pair.p.distances(base[0])
    assert d.shape == (30,)
    if metric == "L2":
        assert d[0] == 0.0
    q = base[[0, 7]] + 0.25
    np.testing.assert_allclose(pair.p.distances(q), pair.j.distances(q), rtol=3e-5, atol=1e-5)
    pair.do("quantize")
    pair.do("remove", ids[3:9])
    pair.do("add", base[:2] * 2)
    got = pair.p.distances(q)
    assert got.shape == (2, 26)
    np.testing.assert_allclose(got, pair.j.distances(q), rtol=3e-5, atol=1e-5)
    got = pair.do("distances", q, exact=False)  # equal, integer domain
    assert got.shape == (2, 30)


@pytest.mark.parametrize("metric", ["L2", "SQUARED_L2", "COSINE", "DOT", "L1"])
def test_dataset_int4_distances_stream(metric):
    """JAX test_quantize4.py::test_dataset_int4_distances_stream: the
    self-row wins, values within 1e-4 of the numpy recomputation of the
    int4 spec (tests/parity.py) and within the int4 tolerances of JAX's."""
    rng = np.random.default_rng(28)
    data = rng.standard_normal((120, 48)).astype(np.float32)
    pair = Pair(f"dimension=48,type=FLOAT32,distance={metric}")
    pair.do("add", data)
    pair.do("quantize", qtype="int4")
    d = pair.p.distances(data[3], exact=False)
    assert d.shape == (120,)
    if metric in ("L2", "SQUARED_L2", "COSINE"):
        assert d[3] == d.min()
    quant = pair.p._quant
    want = expected_int4_distances(
        data[3:4], quant.codes.numpy(), quant.row_scale.numpy(), quant.sq_norms.numpy(),
        JaxMetric(metric), 48,
    )[0]
    np.testing.assert_allclose(d, want, rtol=1e-4, atol=1e-5)
    q = data[[3, 50]]
    assert_int4_values_close(pair.p.distances(q, exact=False), pair.j.distances(q, exact=False), q, metric)


@pytest.mark.parametrize("metric", ["L2", "COSINE", "DOT", "L1"])
def test_int4_scan_distances_matches_jax(metric):
    """ops.quantize4.int4_scan_distances against the JAX function, across
    row tiles (a small tile bound splits the 300 rows)."""
    rng = np.random.default_rng(29)
    x = rng.standard_normal((300, 24)).astype(np.float32)
    q = rng.standard_normal((3, 24)).astype(np.float32)
    packed, alpha, csq = jq4.quantize4_np(x)
    want = np.asarray(jq4.int4_scan_distances(
        jnp.asarray(q), jnp.asarray(packed), jnp.asarray(alpha), jnp.asarray(csq),
        JaxMetric(metric), dim=24,
    ))
    args = (from_numpy(q), from_numpy(packed), from_numpy(alpha), from_numpy(csq), DistanceMetric(metric))
    whole = q4.int4_scan_distances(*args, dim=24).numpy()
    assert_int4_values_close(whole, want, q, metric)
    old = q4._TILE_ELEMS
    try:
        q4._TILE_ELEMS = 24 * 100
        np.testing.assert_array_equal(q4.int4_scan_distances(*args, dim=24).numpy(), whole)
    finally:
        q4._TILE_ELEMS = old


def test_quantization_lifecycle_matches_jax():
    """JAX test_quantize.py (test_quantize_memory_formula,
    test_drop_quantization), test_quantize4.py::
    test_dataset_int4_quantize_memory_and_lifecycle and test_refine.py::
    test_refine_quantize_memory_counts_sidecar: is_quantized,
    quantize_memory, preload and drop_quantization, same values and
    errors."""
    rng = np.random.default_rng(30)
    for dim in (24, 49, 20):
        pair = Pair(f"dimension={dim},type=FLOAT32")
        pair.do("add", rng.standard_normal((10 * dim, dim)).astype(np.float32))
        assert not pair.p.is_quantized
        pair.raises("VectorStateError", "quantize_memory")
        pair.raises("VectorStateError", "preload")
        for kwargs in ({}, {"qtype": "int4"}, {"qtype": "int4", "refine": True}, {"qtype": "uint8"}):
            pair.do("quantize", **kwargs)
            assert pair.p.is_quantized and pair.j.is_quantized
            assert pair.do("quantize_memory") == pair.j.quantize_memory()
            pair.do("preload")
        assert pair.p.quantize_memory() == 10 * dim * (8 + dim)
        pair.do("quantize", qtype="int4", refine=True)
        assert pair.p.quantize_memory() == 10 * dim * (16 + q4.packed_width(dim)) + 10 * dim * dim
        pair.do("drop_quantization")
        pair.do("drop_quantization")  # a silent no-op
        assert not pair.p.is_quantized
        pair.raises("VectorStateError", "search", np.zeros(dim, np.float32), 3, exact=False)


def test_search_filter_mask_is_np_isin():
    """The device filter mask (torch.isin against a cached device copy of
    the ids) is np.isin's mask, in live and snapshot space, and the id copy
    is reused while the id array is."""
    rng = np.random.default_rng(31)
    ds = svt.VectorStore(device="cpu").create("d", "dimension=4")
    ids = ds.add(rng.standard_normal((500, 4)).astype(np.float32))
    ds.quantize()
    flt = rng.choice(ids, 60, replace=False)
    for mode in ("exact", "quantized"):
        m = ds._search_mask(mode, ds._quant, flt)
        np.testing.assert_array_equal(m.numpy(), np.isin(ids, flt))
    cached = ds._ids_on_device(ds._ids)
    assert ds._ids_on_device(ds._ids) is cached
    ds.remove(ids[:5])
    m = ds._search_mask("exact", ds._quant, flt)
    np.testing.assert_array_equal(m.numpy(), np.isin(ids, flt) & (np.arange(500) >= 5))
    assert ds._search_mask("quantized", ds._quant, None) is None  # snapshot: unfiltered
