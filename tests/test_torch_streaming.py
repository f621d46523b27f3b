"""Host -> device streaming scans (ops/streaming.py) and host-storage
datasets of the port, against the JAX package on the same inputs (both on
the CPU, where each tile is scanned by the kernels' plain twins).

Many small tiles (tile_rows 97, k larger than a tile) exercise the tile
merge. Tolerances: integer-domain (int8) and int4 results are bit-equal to
the unstreamed scan of the same codes (per-row values do not depend on the
tile); float32 values are within REL_TOL_BY_TYPE of the JAX package's (sums
in another order), ids tie-aware (tests/parity.py)."""

import numpy as np
import pytest
import torch

import sqlite_vector_tpu as jax_svt
import sqlite_vector_tpu_torch as svt
from sqlite_vector_tpu import oracle
from sqlite_vector_tpu.ops.streaming import streaming_scan_distances as jax_stream_distances
from sqlite_vector_tpu.ops.streaming import streaming_scan_topk as jax_stream_topk
from sqlite_vector_tpu.types import DistanceMetric as JaxMetric
from sqlite_vector_tpu.types import VectorType as JaxVectorType
from sqlite_vector_tpu_torch.device import bf16_bits, from_numpy
from sqlite_vector_tpu_torch.hostarray import ShardedRows
from sqlite_vector_tpu_torch.ops import streaming
from sqlite_vector_tpu_torch.ops.quantize4 import int4_scan_distances, int4_scan_topk, quantize4_np
from sqlite_vector_tpu_torch.ops.scan import fused_scan_topk, scan_distances
from sqlite_vector_tpu_torch.ops.streaming import (
    int4_streaming_scan_distances,
    int4_streaming_scan_topk,
    streaming_scan_distances,
    streaming_scan_topk,
)
from sqlite_vector_tpu_torch.types import DistanceMetric, QuantType
from tests.parity import REL_TOL_BY_TYPE, assert_topk_parity
from tests.test_torch_mutations import compare_mode

METRICS = ["L2", "SQUARED_L2", "COSINE", "DOT", "L1"]
TILE = 97  # rows per tile: 31 tiles over 3,000 rows


def _oracle_topk(base, queries, metric, k):
    d = oracle.distance(queries, base, JaxMetric(metric), JaxVectorType.F32)
    idx = np.argsort(d, axis=-1, kind="stable")[:, :k]
    return idx, np.take_along_axis(d, idx, axis=-1), d


@pytest.mark.parametrize("metric", METRICS)
def test_streaming_topk_matches_jax(metric, rng):
    n, dim, b, k = 3000, 48, 3, 12
    base = rng.standard_normal((n, dim)).astype(np.float32)
    base[2500] = base[40]  # a tie across tiles: the earlier row wins
    q = rng.standard_normal((b, dim)).astype(np.float32)
    q[0] = base[40]
    vals, idx = streaming_scan_topk(from_numpy(q), base, DistanceMetric(metric), k, tile_rows=TILE)
    jv, ji = jax_stream_topk(q, base, JaxMetric(metric), k, tile_rows=700)
    _, _, d = _oracle_topk(base, q, metric, k)
    for i in range(b):
        assert_topk_parity(np.arange(n), d[i], idx[i].numpy(), vals[i].numpy(), k,
                           rel_tol=REL_TOL_BY_TYPE["FLOAT32"], label=f"q{i}")
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=2e-5, atol=2e-5)
    if metric in ("L2", "SQUARED_L2", "L1"):
        assert idx[0, 0] == 40 and idx[0, 1] == 2500 and vals[0, 0] == 0.0
        assert np.asarray(ji)[0, 0] == 40


def test_streaming_k_exceeds_tile(rng):
    n, dim, k = 1000, 16, 300
    base = rng.standard_normal((n, dim)).astype(np.float32)
    q = rng.standard_normal((1, dim)).astype(np.float32)
    vals, idx = streaming_scan_topk(from_numpy(q), base, DistanceMetric.L2, k, tile_rows=TILE)
    oidx, ovals, _ = _oracle_topk(base, q, "L2", k)
    np.testing.assert_array_equal(idx.numpy()[0], oidx[0])
    np.testing.assert_allclose(vals.numpy()[0], ovals[0], rtol=1e-5, atol=1e-5)
    # k past the row count: +inf / -1 padding, as the JAX package
    vals, idx = streaming_scan_topk(from_numpy(q), base[:50], DistanceMetric.L2, 60, tile_rows=TILE)
    assert (idx.numpy()[0, 50:] == -1).all() and np.isposinf(vals.numpy()[0, 50:]).all()
    jv, ji = jax_stream_topk(q, base[:50], JaxMetric.L2, 60, tile_rows=TILE)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_streaming_topk_mask_shorter_than_count(rng):
    """A mask captured before rows were appended is shorter than the rows
    scanned: the rows past it stay excluded (as in the JAX package)."""
    n, dim, k = 1000, 16, 10
    base = rng.standard_normal((n, dim)).astype(np.float32)
    q = base[:1].copy()
    mask = np.ones((700,), bool)
    mask[0] = False
    _, idx = streaming_scan_topk(
        from_numpy(q), base, DistanceMetric.L2, k, valid_count=n, row_mask=mask, tile_rows=256
    )
    oidx, _, _ = _oracle_topk(base[1:700], q, "L2", k)
    np.testing.assert_array_equal(idx.numpy()[0], oidx[0] + 1)
    _, jidx = jax_stream_topk(q, base, JaxMetric.L2, k, valid_count=n, row_mask=mask, tile_rows=256)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("metric", METRICS)
def test_streaming_distances_match_jax(metric, rng):
    n, dim = 2500, 32
    base = rng.standard_normal((n, dim)).astype(np.float32)
    q = rng.standard_normal((2, dim)).astype(np.float32)
    d = streaming_scan_distances(from_numpy(q), base, DistanceMetric(metric), tile_rows=TILE)
    want = jax_stream_distances(q, base, JaxMetric(metric), tile_rows=600)
    np.testing.assert_allclose(d, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(d, scan_distances(from_numpy(q), from_numpy(base), DistanceMetric(metric)).numpy())


@pytest.mark.parametrize("qtype", [QuantType.U8, QuantType.I8])
@pytest.mark.parametrize("metric", ["L2", "DOT", "COSINE"])
def test_streamed_int8_codes_equal_the_unstreamed_scan(qtype, metric, rng):
    """Integer-domain distances: the streamed scan of the codes equals the
    device-resident scan of the same codes bit for bit, masked or not."""
    lo, hi = (0, 256) if qtype is QuantType.U8 else (-128, 128)
    codes = rng.integers(lo, hi, (2100, 40)).astype(qtype.np_dtype)
    codes[1500] = codes[3]
    q = torch.from_numpy(rng.integers(lo, hi, (5, 40)).astype(qtype.np_dtype))
    mask = rng.random(2100) < 0.6
    for m in (None, mask):
        got = streaming_scan_topk(q, codes, DistanceMetric(metric), 130, row_mask=m, tile_rows=TILE)
        want = fused_scan_topk(q, torch.from_numpy(codes), DistanceMetric(metric), 130,
                               row_mask=None if m is None else torch.from_numpy(m))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("metric", ["L2", "SQUARED_L2", "COSINE", "DOT", "L1"])
def test_streamed_int4_equals_the_unstreamed_scan(metric, rng):
    base = rng.standard_normal((2100, 33)).astype(np.float32)
    base[1700] = base[9]
    packed, alpha, csq = quantize4_np(base)
    q = from_numpy(np.concatenate([base[[9]], rng.standard_normal((3, 33)).astype(np.float32)]))
    mask = rng.random(2100) < 0.5
    for m in (None, mask):
        got = int4_streaming_scan_topk(q, packed, alpha, csq, DistanceMetric(metric), 120,
                                       dim=33, row_mask=m, tile_rows=TILE)
        want = int4_scan_topk(q, *(from_numpy(a) for a in (packed, alpha, csq)), DistanceMetric(metric),
                              120, dim=33, row_mask=None if m is None else torch.from_numpy(m))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    d = int4_streaming_scan_distances(q, packed, alpha, csq, DistanceMetric(metric), dim=33, tile_rows=TILE)
    want = int4_scan_distances(q, *(from_numpy(a) for a in (packed, alpha, csq)), DistanceMetric(metric), dim=33)
    np.testing.assert_array_equal(d, want.numpy())


def test_sharded_and_bf16_sources(rng, tmp_path):
    """Tiles that straddle the shards of a ShardedRows view of memory maps
    read the right rows; bfloat16 rows stream as their uint16 bits."""
    base = rng.standard_normal((1000, 24)).astype(np.float32)
    parts = []
    for i, (s, e) in enumerate([(0, 130), (130, 131), (131, 600), (600, 1000)]):
        np.save(tmp_path / f"p{i}.npy", base[s:e])
        parts.append(np.load(tmp_path / f"p{i}.npy", mmap_mode="r"))
    view = ShardedRows(parts)
    q = from_numpy(base[[5, 599, 600]])
    got = streaming_scan_topk(q, view, DistanceMetric.L2, 25, tile_rows=TILE)
    want = streaming_scan_topk(q, base, DistanceMetric.L2, 25, tile_rows=TILE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    bits = bf16_bits(base)
    qb = q.to(torch.bfloat16)
    got = streaming_scan_topk(qb, bits, DistanceMetric.L2, 25, tile_rows=TILE)
    want = fused_scan_topk(qb, torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16), DistanceMetric.L2, 25)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    out = np.empty((300, 24), np.float32)
    view.read_into(100, out)
    np.testing.assert_array_equal(out, base[100:400])
    with pytest.raises(IndexError):
        view.read_into(900, out)


@pytest.mark.parametrize("threads", [1, 3])
def test_threaded_staging_reads_the_same_rows(threads, rng, tmp_path, monkeypatch):
    """Staging split over threads (each a slice of the tile's rows, from a
    ShardedRows view and a mask) gives the one-thread result."""
    monkeypatch.setattr(streaming, "STAGING_THREADS", threads)
    monkeypatch.setattr(streaming, "_SPLIT_BYTES", 0)
    base = rng.standard_normal((2000, 32)).astype(np.float32)
    np.save(tmp_path / "a.npy", base[:777])
    np.save(tmp_path / "b.npy", base[777:])
    view = ShardedRows([np.load(tmp_path / f, mmap_mode="r") for f in ("a.npy", "b.npy")])
    mask = rng.random(2000) < 0.7
    q = from_numpy(base[[1, 776, 777, 1999]])
    got = streaming_scan_topk(q, view, DistanceMetric.DOT, 30, row_mask=mask, tile_rows=301)
    want = fused_scan_topk(q, from_numpy(base), DistanceMetric.DOT, 30, row_mask=torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("source", ["array", "bf16 bits", "shards"])
def test_upload_rows_carries_the_rows_through_tiles(source, rng, tmp_path, monkeypatch):
    """upload_rows (the hbm load and preload() path) gives the first count
    rows, zeros up to cap, over many tiles; bfloat16 bits arrive as
    bfloat16."""
    monkeypatch.setattr(streaming, "DEFAULT_TILE_BYTES", TILE * 24 * 4)
    base = rng.standard_normal((1000, 24)).astype(np.float32)
    arr, want = base, torch.from_numpy(base)
    if source == "bf16 bits":
        arr = bf16_bits(base)
        want = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif source == "shards":
        np.save(tmp_path / "a.npy", base[:130])
        np.save(tmp_path / "b.npy", base[130:])
        arr = ShardedRows([np.load(tmp_path / f, mmap_mode="r") for f in ("a.npy", "b.npy")])
    cpu = torch.device("cpu")
    out = streaming.upload_rows(arr, 990, cpu, cap=1024)
    assert out.shape == (1024, 24) and out.dtype == want.dtype
    assert torch.equal(out[:990], want[:990]) and not out[990:].any()
    assert torch.equal(streaming.upload_rows(arr, 990, cpu), want[:990])
    assert streaming.upload_rows(arr, 0, cpu).shape == (0, 24)


def test_stream_position_bound(monkeypatch, rng):
    monkeypatch.setattr(streaming, "_MAX_STREAM_ROWS", 100)
    base = rng.standard_normal((101, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="int32 position space"):
        streaming_scan_topk(from_numpy(base[:1]), base, DistanceMetric.L2, 3)
    assert streaming_scan_topk(from_numpy(base[:1]), base, DistanceMetric.L2, 3, valid_count=100)[1][0, 0] == 0


def test_default_tile_rows_is_a_byte_budget():
    a = np.zeros((10, 768), np.float32)
    assert streaming.default_tile_rows([a]) == streaming.DEFAULT_TILE_BYTES // (768 * 4)
    packed, alpha = np.zeros((10, 384), np.uint8), np.zeros((10,), np.float32)
    assert streaming.default_tile_rows([packed, alpha, alpha]) == streaming.DEFAULT_TILE_BYTES // 392


# -- host-storage datasets -----------------------------------------------------


@pytest.fixture
def small_tiles(monkeypatch):
    """Dataset scans stream in tiles of about TILE rows."""
    monkeypatch.setattr(streaming, "DEFAULT_TILE_BYTES", TILE * 16 * 4)


def host_pair(options, rows, ids=None):
    jds = jax_svt.Dataset("h", jax_svt.parse_options(options), storage="host")
    pds = svt.Dataset("h", svt.parse_options(options), device="cpu", storage="host")
    np.testing.assert_array_equal(pds.add(rows, ids), jds.add(rows, ids))
    return jds, pds


def test_host_storage_dataset(rng, small_tiles):
    base = rng.standard_normal((3000, 16)).astype(np.float32)
    jds, pds = host_pair("dimension=16,type=FLOAT32,distance=L2", base)
    assert pds._vectors is None and pds.memory_bytes() == 0  # nothing on the device
    got, dist = pds.search(base[777], 5)
    assert got[0] == 778 and dist[0] == 0.0
    q = rng.standard_normal((2, 16)).astype(np.float32)
    oidx, _, _ = _oracle_topk(base, q, "L2", 10)
    np.testing.assert_array_equal(pds.search(q, 10)[0], oidx + 1)
    assert pds.quantize() == jds.quantize() == 3000
    assert not isinstance(pds._quant.codes, torch.Tensor)  # codes stay on the host
    np.testing.assert_array_equal(pds._quant.codes, np.asarray(jds._quant.codes))
    for k in (5, 150):
        np.testing.assert_array_equal(pds.search(base[777], k, exact=False)[0], jds.search(base[777], k, exact=False)[0])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mode", ["exact", "approx", "quantized", "rerank"])
def test_host_storage_search_modes_match_jax(metric, mode, rng, small_tiles):
    """Every mode over host storage against the JAX host dataset, with
    tombstones on the mirror and an ids_filter (int8 and int4 codes for the
    code modes)."""
    base = rng.standard_normal((1500, 16)).astype(np.float32)
    jds, pds = host_pair(f"dimension=16,type=FLOAT32,distance={metric}", base, np.arange(10, 1510))
    q = np.concatenate([base[[3, 900]], rng.standard_normal((2, 16)).astype(np.float32)])
    flt = np.arange(10, 1510)[rng.random(1500) < 0.5]
    for qtype in (("int8", "int4") if mode in ("quantized", "rerank") else ("int8",)):
        for ds in (jds, pds):
            ds.quantize(qtype=qtype)
        compare_mode(jds, pds, q, mode)
        compare_mode(jds, pds, q, mode, ids_filter=flt)
    for ds in (jds, pds):
        ds.remove(np.arange(10, 1510)[::7])
    assert pds.tombstones == jds.tombstones > 0
    compare_mode(jds, pds, q, mode, ids_filter=flt)
    compare_mode(jds, pds, q, mode)


def test_host_preload_pins_codes_on_the_device(rng, small_tiles):
    base = rng.standard_normal((500, 16)).astype(np.float32)
    ds = svt.Dataset("pre", svt.parse_options("dimension=16"), device="cpu", storage="host")
    ids = ds.add(base)
    for qtype, refine in (("int8", False), ("int4", True)):
        ds.quantize(qtype=qtype, refine=refine)
        assert not isinstance(ds._quant.codes, torch.Tensor)
        before = ds.search(base[:4], 7, exact=False)
        if refine:
            with pytest.raises(svt.VectorStateError, match="preload"):
                ds.search(base[9], 3, mode="refine")
        ds.preload()
        assert isinstance(ds._quant.codes, torch.Tensor)
        after = ds.search(base[:4], 7, exact=False)
        for b, a in zip(before, after):
            np.testing.assert_array_equal(a, b)
        assert after[0][0, 0] == ids[0]
    assert ds.search(base[9], 3, mode="refine")[0][0] == ids[9]


def test_host_storage_ids_filter_and_distances(rng, small_tiles):
    base = rng.standard_normal((3000, 16)).astype(np.float32)
    jds, pds = host_pair("dimension=16,type=FLOAT32", base)
    ids = pds.ids
    got, dist = pds.search(base[100], 3, ids_filter=ids[ids != ids[100]])
    assert ids[100] not in got and dist[0] > 0
    for ds in (jds, pds):
        ds.remove(ids[:40])
    np.testing.assert_allclose(pds.distances(base[:2]), jds.distances(base[:2]), rtol=1e-5, atol=1e-5)
    for qtype in ("int8", "int4"):
        for ds in (jds, pds):
            ds.quantize(qtype=qtype)
        np.testing.assert_allclose(
            pds.distances(base[:2], exact=False), np.asarray(jds.distances(base[:2], exact=False)),
            rtol=1e-5, atol=1e-4,
        )


def test_host_storage_mutations_match_jax(rng, small_tiles):
    base = rng.standard_normal((2000, 12)).astype(np.float32)
    jds, pds = host_pair("dimension=12,type=FLOAT32", base)
    new = rng.standard_normal((3, 12)).astype(np.float32)
    for ds in (jds, pds):
        ds.update(ds.ids[[4, 5, 4]], new)
        ds.remove(ds.ids[100:1200])  # past the threshold: a writable mirror compacts
        ds.add(new * 2)
    assert pds.tombstones == jds.tombstones == 0
    np.testing.assert_array_equal(pds.ids, jds.ids)
    np.testing.assert_array_equal(pds.get(pds.ids[[4, 5, -1]]), jds.get(jds.ids[[4, 5, -1]]))
    compare_mode(jds, pds, new, "exact")
    assert pds.compact() == 0


def test_from_arrays_host_adopts_without_copy(rng):
    base = rng.standard_normal((300, 8)).astype(np.float32)
    ds = svt.Dataset.from_arrays("fa", base, options="dimension=8", device="cpu", storage="host")
    assert ds._host_vectors is base and len(ds) == 300
    assert ds.search(base[7], 1)[0][0] == 8
    with pytest.raises(svt.VectorConfigError, match="duplicate ids"):
        svt.Dataset.from_arrays("d", base[:2], [1, 1], device="cpu", storage="host")
    with pytest.raises(svt.VectorConfigError, match="does not match"):
        svt.Dataset.from_arrays("d", base.astype(np.float64), device="cpu", storage="host")


def test_sharded_rows_match_jax(rng):
    """The port's ShardedRows (a copy) indexes like the JAX package's."""
    from sqlite_vector_tpu.hostarray import ShardedRows as JaxShardedRows

    parts = [rng.standard_normal((n, 6)).astype(np.float32) for n in (5, 1, 9)]
    mine, ref = ShardedRows(parts), JaxShardedRows(parts)
    assert mine.shape == ref.shape == (15, 6) and len(mine) == 15
    for key in (slice(0, 15), slice(4, 7), slice(6, 6), 5, -1, np.array([14, 0, 5, 5, -2])):
        np.testing.assert_array_equal(mine[key], ref[key])
    for bad in (slice(0, 9, 2), (1, 2), np.array([True, False]), np.array([15])):
        with pytest.raises(IndexError):
            mine[bad]
    np.testing.assert_array_equal(mine.view(np.int32)[3:8], ref.view(np.int32)[3:8])
