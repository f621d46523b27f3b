"""PyTorch port parity for meshes: row-sharded (1-D) and rows x dim (2-D)
datasets, one counterpart for each test of tests/test_sharded.py plus
int4, rerank, host storage, mutations, persistence and serving on a mesh.

The port's meshes put 8 shards on "cpu" (parallel.make_mesh(devices=
["cpu"] * 8)), as the JAX tests put 8 virtual devices on one host
(tests/conftest.py); both packages get the same numpy inputs from a seed.
Tolerances:
  - 1-D top-k: ids equal (tie-aware against the JAX package's distances
    where a dataset is compared, tests/test_torch_mutations.py:
    compare_mode), values within tests/parity.py:REL_TOL_BY_TYPE (float32
    sums in another order);
  - int8 params, codes and integer-domain distances: bit-equal; int4
    codes bit-equal, values within tests/test_torch_quantize4.py:
    assert_int4_values_close;
  - 2-D floats: the JAX 2-D tests' own tolerances (rtol 5e-4 / atol 1e-5
    for the top-k against the oracle, rtol 1e-4 / atol 1e-6 end to end;
    partial float32 sums are added across shards, so not bit-equal);
  - a port mesh against the port on one device (both on the CPU twins):
    ids and values bit-equal for 1-D.
"""

import jax
import numpy as np
import pytest
import torch

import sqlite_vector_tpu as jax_svt
import sqlite_vector_tpu_torch as svt
from sqlite_vector_tpu import oracle
from sqlite_vector_tpu.parallel import make_mesh as jax_make_mesh
from sqlite_vector_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from sqlite_vector_tpu.types import DistanceMetric as JaxMetric
from sqlite_vector_tpu.types import VectorType as JaxVectorType
from sqlite_vector_tpu_torch import parallel
from sqlite_vector_tpu_torch.device import from_numpy
from sqlite_vector_tpu_torch.interop import dataset_from_state
from sqlite_vector_tpu_torch.ops import streaming
from sqlite_vector_tpu_torch.parallel import (
    make_mesh,
    make_mesh_2d,
    sharded_scan_distances,
    sharded_scan_topk,
    sharded_scan_topk_2d,
)
from sqlite_vector_tpu_torch.types import DistanceMetric, VectorOptions, VectorType
from tests.parity import REL_TOL_BY_TYPE
from tests.test_torch_mutations import Pair, compare_mode
from tests.test_torch_quantize4 import assert_int4_values_close

METRICS = [m.value for m in DistanceMetric]
F32_REL = REL_TOL_BY_TYPE["FLOAT32"]

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8 virtual JAX devices")


@pytest.fixture(scope="module")
def meshes():
    """(JAX mesh, port mesh) of each kind."""
    return {
        "1d": (jax_make_mesh(), make_mesh(devices=["cpu"] * 8)),
        "2d": (jax_make_mesh_2d(4, 2), make_mesh_2d(4, 2, devices=["cpu"] * 8)),
    }


class MeshPair(Pair):
    """A JAX dataset and a port dataset on meshes of one kind, driven
    through the same calls (Pair's checks)."""

    def __init__(self, options: str, jmesh, pmesh, **kwargs):
        self.j = jax_svt.Dataset("d", jax_svt.parse_options(options), mesh=jmesh, **kwargs)
        self.p = svt.Dataset("d", svt.parse_options(options), mesh=pmesh, **kwargs)


def jax_topk(fn, *args, **kwargs):
    vals, idx = fn(*args, **kwargs)
    return np.asarray(vals), np.asarray(idx)


def qparams(ds):
    """(resolved qtype name, scale, offset) of either package's dataset."""
    qt, scale, offset = ds.quant_params
    return qt.value, scale, offset


# ---------------------------------------------------------------------------
# 1-D mesh: the executors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", METRICS)
def test_sharded_topk_matches_jax(meshes, metric, rng):
    """JAX test_sharded_topk_matches_oracle: both packages' sharded top-k
    over the same rows; the port mesh also equals the port on one device
    bit for bit."""
    from sqlite_vector_tpu.parallel import row_sharding, sharded_scan_topk as jax_sharded

    jmesh, pmesh = meshes["1d"]
    n, dim, b, k = 512, 64, 4, 10
    base = rng.standard_normal((n, dim)).astype(np.float32)
    q = rng.standard_normal((b, dim)).astype(np.float32)
    jv, ji = jax_topk(
        jax_sharded, jax.device_put(q), jax.device_put(base, row_sharding(jmesh)), JaxMetric(metric), k, jmesh
    )
    pv, pi = sharded_scan_topk(from_numpy(q), from_numpy(base), DistanceMetric(metric), k, pmesh)
    np.testing.assert_array_equal(pi.numpy(), ji)
    np.testing.assert_allclose(pv.numpy(), jv, rtol=F32_REL, atol=1e-5)
    from sqlite_vector_tpu_torch.ops.scan import fused_scan_topk

    ov, oi = fused_scan_topk(from_numpy(q), from_numpy(base), DistanceMetric(metric), k)
    assert torch.equal(pi, oi) and torch.equal(pv, ov)


def test_sharded_valid_count_masks_padding(meshes, rng):
    """valid_count cuts across shard boundaries: only the first 100 of 512
    rows are real, the zero rows past them would win L2."""
    _, pmesh = meshes["1d"]
    n, dim, real = 512, 32, 100
    base = np.zeros((n, dim), np.float32)
    base[:real] = rng.standard_normal((real, dim)).astype(np.float32) + 5.0
    q = np.zeros((1, dim), np.float32)
    _, idx = sharded_scan_topk(from_numpy(q), from_numpy(base), DistanceMetric.L2, 10, pmesh, valid_count=real)
    assert (idx[0] >= 0).all() and (idx[0] < real).all()


def test_sharded_k_larger_than_valid(meshes, rng):
    """k past the valid rows (and past each shard's): -1 / +inf slots, as
    in the JAX package."""
    from sqlite_vector_tpu.parallel import row_sharding, sharded_scan_topk as jax_sharded

    jmesh, pmesh = meshes["1d"]
    n, dim, real, k = 512, 16, 5, 20
    base = np.zeros((n, dim), np.float32)
    base[:real] = rng.standard_normal((real, dim)).astype(np.float32)
    q = rng.standard_normal((1, dim)).astype(np.float32)
    vals, idx = sharded_scan_topk(from_numpy(q), from_numpy(base), DistanceMetric.L2, k, pmesh, valid_count=real)
    vals, idx = vals.numpy(), idx.numpy()
    assert (idx[0, :real] >= 0).all() and (idx[0, real:] == -1).all()
    assert np.isposinf(vals[0, real:]).all()
    jv, ji = jax_topk(
        jax_sharded, jax.device_put(q), jax.device_put(base, row_sharding(jmesh)), JaxMetric.L2, k, jmesh,
        valid_count=real,
    )
    np.testing.assert_array_equal(idx, ji)


def test_sharded_rows_must_split_over_the_mesh(meshes):
    _, pmesh = meshes["1d"]
    with pytest.raises(ValueError, match="pad before sharding"):
        sharded_scan_topk(torch.zeros(1, 8), torch.zeros(100, 8), DistanceMetric.L2, 3, pmesh)


def test_sharded_distances_matches_jax(meshes, rng):
    from sqlite_vector_tpu.parallel import row_sharding, sharded_scan_distances as jax_dist

    jmesh, pmesh = meshes["1d"]
    n, dim, b = 256, 48, 3
    base = rng.standard_normal((n, dim)).astype(np.float32)
    q = rng.standard_normal((b, dim)).astype(np.float32)
    parts = sharded_scan_distances(from_numpy(q), from_numpy(base), DistanceMetric.SQUARED_L2, pmesh)
    assert len(parts) == 8 and all(p.shape == (b, n // 8) for p in parts)
    got = torch.cat(parts, dim=1).numpy()
    want = np.asarray(jax_dist(jax.device_put(q), jax.device_put(base, row_sharding(jmesh)), JaxMetric.SQUARED_L2, jmesh))
    np.testing.assert_allclose(got, want, rtol=F32_REL, atol=1e-4)


# ---------------------------------------------------------------------------
# 1-D mesh: datasets
# ---------------------------------------------------------------------------


def test_dataset_with_mesh_end_to_end(meshes, rng):
    """JAX test_dataset_with_mesh_end_to_end on both packages: exact
    (self-match at 0), int8 quantize (params and codes bit-equal), approx,
    distances, append after quantize (stale codes keep serving)."""
    pair = MeshPair("dimension=96,type=FLOAT32,distance=L2", *meshes["1d"])
    base = rng.standard_normal((3000, 96)).astype(np.float32)
    ids = pair.do("add", base)
    got, dist = pair.p.search(base[1234], 5)
    assert got[0] == ids[1234] and dist[0] == 0.0
    q = np.concatenate([base[[7, 2900]], rng.standard_normal((2, 96)).astype(np.float32)])
    for mode in ("exact", "approx"):
        compare_mode(pair.j, pair.p, q, mode)
    assert pair.do("quantize") == 3000
    assert qparams(pair.p) == qparams(pair.j)
    np.testing.assert_array_equal(pair.p._quant.codes.read(0, 3000).numpy(), np.asarray(pair.j._quant.codes)[:3000])
    compare_mode(pair.j, pair.p, q, "quantized")
    np.testing.assert_array_equal(pair.p.distances(q, exact=False), pair.j.distances(q, exact=False))
    d = pair.p.distances(q)
    assert d.shape == (4, 3000)
    np.testing.assert_allclose(d, pair.j.distances(q), rtol=F32_REL, atol=1e-4)
    pair.do("add", rng.standard_normal((10, 96)).astype(np.float32))
    assert pair.p.quant_stale and pair.j.quant_stale
    pair.check_state()
    pair.check_search(q)


def test_mesh_capacity_is_shard_multiple(meshes, rng):
    for kind in ("1d", "2d"):
        ds = svt.Dataset("pad", svt.parse_options("dimension=8,type=FLOAT32"), mesh=meshes[kind][1])
        ds.add(rng.standard_normal((1, 8)).astype(np.float32))
        assert ds._vectors.shape[0] % ds._mesh_size == 0
        assert ds._vectors.n_shards == {"1d": 8, "2d": 4}[kind]


def test_sharded_ids_filter(meshes, rng):
    pair = MeshPair("dimension=32,type=FLOAT32,distance=L2", *meshes["1d"])
    base = rng.standard_normal((600, 32)).astype(np.float32)
    ids = pair.do("add", base)
    got, _ = pair.p.search(base[50], 3)
    assert got[0] == ids[50]
    got, dist = pair.p.search(base[50], 3, ids_filter=ids[ids != ids[50]])
    assert ids[50] not in got and dist[0] > 0
    q = base[[50, 400]]
    for flt in (ids[ids != ids[50]], ids[::7], ids[550:]):
        compare_mode(pair.j, pair.p, q, "exact", ids_filter=flt)


def test_sqlite_surface_on_mesh(meshes, tmp_path, rng):
    """JAX test_sqlite_surface_on_mesh on two copies of one database, and a
    second connection's scan of the shadow table's codes, which the port
    shards over the mesh."""
    import shutil

    import sqlite_vector_tpu.sqlite as jsql
    import sqlite_vector_tpu_torch.sqlite as psql

    jmesh, pmesh = meshes["1d"]
    data = rng.standard_normal((400, 32)).astype(np.float32)
    out = {}
    for name, mod, mesh in (("jax", jsql, jmesh), ("port", psql, pmesh)):
        path = str(tmp_path / f"{name}.db")
        c = mod.connect(path, mesh=mesh)
        c.execute("CREATE TABLE t (v BLOB)")
        c.executemany("INSERT INTO t(v) VALUES (?)", ((r.tobytes(),) for r in data))
        c.commit()
        c.vector_init("t", "v", "type=FLOAT32,dimension=32,distance=L2")
        rows = c.vector_full_scan("t", "v", data[9].tobytes(), 3)
        assert rows[0][0] == 10 and rows[0][1] == 0.0
        c.vector_quantize("t", "v")
        c.commit()
        qrows = c.vector_quantize_scan("t", "v", data[9].tobytes(), 3)
        assert qrows[0][0] == 10
        c.close()
        shutil.copy(path, str(tmp_path / f"{name}2.db"))
        c2 = mod.connect(str(tmp_path / f"{name}2.db"), mesh=mesh)
        c2.vector_init("t", "v", "type=FLOAT32,dimension=32,distance=L2")
        out[name] = (rows, qrows, c2.vector_quantize_scan("t", "v", data[9].tobytes(), 5),
                     list(c2.vector_quantize_scan_stream("t", "v", data[9].tobytes())))
        if name == "port":
            assert isinstance(c2._contexts[("t", "v")].quant.codes, parallel.RowShards)
        c2.close()
    for got, want in zip(out["port"], out["jax"]):
        assert [r[0] for r in got] == [r[0] for r in want]
        np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want], rtol=F32_REL, atol=1e-5)


def test_int4_on_a_mesh_matches_jax(meshes, rng):
    """int4 on a 1-D mesh: packed codes, alpha and csq bit-equal to JAX's,
    search and distances equal; rerank over them; refine refused with
    JAX's message."""
    pair = MeshPair("dimension=24,type=FLOAT32,distance=L2", *meshes["1d"])
    base = rng.standard_normal((1500, 24)).astype(np.float32)
    ids = pair.do("add", base)
    pair.do("quantize", qtype="int4")
    jq, pq = pair.j._quant, pair.p._quant
    for got, want in ((pq.codes, jq.codes), (pq.row_scale, jq.row_scale), (pq.sq_norms, jq.sq_norms)):
        np.testing.assert_array_equal(got.read(0, 1500).numpy(), np.asarray(want)[:1500])
    q = np.concatenate([base[[3, 1400]], rng.standard_normal((2, 24)).astype(np.float32)])
    for mode in ("quantized", "rerank"):
        compare_mode(pair.j, pair.p, q, mode)
        compare_mode(pair.j, pair.p, q, mode, ids_filter=ids[::5])
    assert_int4_values_close(pair.p.distances(q, exact=False), pair.j.distances(q, exact=False), q, "L2")
    pair.raises("VectorConfigError", "quantize", qtype="int4", refine=True)


def test_rerank_on_a_mesh(meshes, rng):
    """Rerank over int8 codes on a mesh: the id-remap route (stage 1 on
    every shard, the candidates' rows gathered from their shards), fresh
    and after removes and adds, equal to the JAX package's."""
    pair = MeshPair("dimension=16,type=FLOAT32,distance=COSINE", *meshes["1d"])
    base = rng.standard_normal((2000, 16)).astype(np.float32)
    ids = pair.do("add", base)
    pair.do("quantize")
    q = np.concatenate([base[[11, 1999]], rng.standard_normal((2, 16)).astype(np.float32)])
    compare_mode(pair.j, pair.p, q, "rerank")
    got, dist = pair.p.search(base[11], 5, mode="rerank")
    assert got[0] == ids[11] and dist[0] == 0.0
    pair.do("remove", ids[10:20])
    pair.do("add", base[:30] + 0.25)
    compare_mode(pair.j, pair.p, q, "rerank")
    compare_mode(pair.j, pair.p, q, "rerank", ids_filter=ids[::3])


def test_mutations_on_a_mesh_match_jax(meshes, rng):
    """remove (tombstones, then past the threshold), update with a
    duplicate id, compact, quantize after remove, add: state and every
    mode's search agree with the JAX package after each step, and a mesh
    compaction moves rows between shards."""
    pair = MeshPair("dimension=16,type=FLOAT32,distance=L2", *meshes["1d"])
    base = rng.standard_normal((2500, 16)).astype(np.float32)
    ids = pair.do("add", base[:2000])
    q = np.concatenate([base[[20, 1700]], rng.standard_normal((2, 16)).astype(np.float32)])
    pair.do("quantize")
    pair.do("remove", ids[100:400])
    pair.check_state()
    pair.check_search(q)
    pair.check_search(q, ids_filter=ids[::4])
    pair.do("update", np.asarray([ids[20], ids[500], ids[20]]), base[2000:2003])
    pair.check_state()
    pair.check_search(q)
    pair.do("remove", ids[400:1300])  # past max(1024, count // 4): compaction
    assert pair.p.tombstones == pair.j.tombstones == 0
    pair.check_state()
    pair.check_search(q)
    pair.do("quantize")
    pair.do("add", base[2003:2500])
    pair.do("remove", ids[1500:1510])
    assert pair.p.compact() == pair.j.compact() == 10
    pair.check_state()
    pair.check_search(q)


def test_host_storage_on_a_mesh(meshes, rng, monkeypatch):
    """storage="host" on a 1-D mesh: each shard's rows (and codes) streamed
    to its device in small tiles, several a pass, and merged; exact, int8
    and int4 (streamed, then preloaded onto the mesh) equal the JAX
    package's, and equal the port's hbm mesh."""
    monkeypatch.setattr(streaming, "DEFAULT_TILE_BYTES", 64 * 16 * 4)
    jmesh, pmesh = meshes["1d"]
    base = rng.standard_normal((3000, 16)).astype(np.float32)
    pair = MeshPair("dimension=16,type=FLOAT32,distance=L2", jmesh, pmesh, storage="host")
    hbm = svt.Dataset("h", svt.parse_options("dimension=16,type=FLOAT32,distance=L2"), mesh=pmesh)
    ids = pair.do("add", base)
    hbm.add(base)
    q = np.concatenate([base[[5, 2999]], rng.standard_normal((2, 16)).astype(np.float32)])
    compare_mode(pair.j, pair.p, q, "exact")
    compare_mode(pair.j, pair.p, q, "exact", ids_filter=ids[::3])
    np.testing.assert_array_equal(pair.p.search(q, 8)[0], hbm.search(q, 8)[0])
    np.testing.assert_allclose(pair.p.distances(q), pair.j.distances(q), rtol=F32_REL, atol=1e-4)
    for qtype in ("int8", "int4"):
        pair.do("quantize", qtype=qtype)
        hbm.quantize(qtype=qtype)
        assert not isinstance(pair.p._quant.codes, parallel.RowShards)  # host codes until preload
        compare_mode(pair.j, pair.p, q, "quantized")
        want = hbm.search(q, 8, exact=False)
        got = pair.p.search(q, 8, exact=False)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        pair.do("preload")
        assert isinstance(pair.p._quant.codes, parallel.RowShards)
        got = pair.p.search(q, 8, exact=False)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_save_load_across_packages_on_meshes(meshes, rng, tmp_path):
    """A JAX mesh dataset saved and loaded onto a port mesh, and the
    reverse, with int8 codes; and interop.dataset_from_state(mesh=)
    carrying a JAX mesh dataset's state onto a port mesh."""
    jmesh, pmesh = meshes["1d"]
    pair = MeshPair("dimension=16,type=FLOAT32,distance=DOT", jmesh, pmesh)
    base = rng.standard_normal((1000, 16)).astype(np.float32)
    ids = pair.do("add", base)
    pair.do("quantize")
    pair.do("remove", ids[:30])
    q = np.concatenate([base[[40, 900]], rng.standard_normal((2, 16)).astype(np.float32)])
    pair.j.save(str(tmp_path / "j"))
    pair.p.save(str(tmp_path / "p"))
    back = MeshPair.__new__(MeshPair)
    back.j = jax_svt.Dataset.load(str(tmp_path / "p"), mesh=jmesh)
    back.p = svt.Dataset.load(str(tmp_path / "j"), mesh=pmesh)
    assert isinstance(back.p._vectors, parallel.RowShards)
    back.check_state()
    back.check_search(q)
    jds = pair.j
    state = {
        "vectors": np.asarray(jds._vectors)[: jds._count], "ids": jds._ids[: jds._count],
        "dead": jds._dead[: jds._count], "codes": np.asarray(jds._quant.codes)[: jds._quant.count],
        "qtype": jds._quant.qtype, "scale": jds._quant.scale, "offset": jds._quant.offset,
        "quant_ids": jds._quant.ids, "stale": jds._quant.stale,
    }
    moved = MeshPair.__new__(MeshPair)
    moved.j, moved.p = jds, dataset_from_state(state, "dimension=16,type=FLOAT32,distance=DOT", mesh=pmesh)
    moved.check_state()
    moved.check_search(q)


def test_batching_searcher_over_a_mesh(meshes, rng):
    """serving.BatchingSearcher coalesces requests onto a mesh dataset's
    search: each result's ids equal the direct search's, its values within
    rtol 1e-6 (float32 sums at another batch size, as in
    tests/test_torch_serving.py)."""
    ds = svt.Dataset("s", svt.parse_options("dimension=16,type=FLOAT32,distance=L2"), mesh=meshes["1d"][1])
    base = rng.standard_normal((500, 16)).astype(np.float32)
    ds.add(base)
    searcher = svt.BatchingSearcher(ds, max_batch=8, max_wait_ms=5.0)
    try:
        futs = [searcher.submit(base[i], 5) for i in range(12)]
        for i, f in enumerate(futs):
            ids, dist = f.result(timeout=30)
            want = ds.search(base[i], 5)
            np.testing.assert_array_equal(ids, want[0])
            np.testing.assert_allclose(dist, want[1], rtol=1e-6, atol=1e-6)
    finally:
        searcher.close()


def test_mesh_equals_one_device(meshes, rng):
    """A port mesh against the port on one device, both on the CPU twins:
    exact and quantized ids and values bit-equal (the shards' candidates
    are rescored row by row and merged in global order), and rerank's
    where both take the id-remap route (filtered); unfiltered over fresh
    codes one device takes the fused route, whose float32 rescore sums in
    another order: ids equal, values within rtol 1e-5."""
    opts = "dimension=20,type=FLOAT32,distance=L2"
    one = svt.VectorStore(device="cpu").create("o", opts)
    mesh = svt.VectorStore(mesh=meshes["1d"][1]).create("m", opts)
    base = rng.standard_normal((1200, 20)).astype(np.float32)
    base[600] = base[3]  # a tie across shards: the earlier row wins
    for ds in (one, mesh):
        ds.add(base)
        ds.remove(np.arange(100, 140))
    q = np.concatenate([base[[3, 700]], rng.standard_normal((2, 20)).astype(np.float32)])
    for qtype in ("int8", "int4"):
        for ds in (one, mesh):
            ds.quantize(qtype=qtype)
        for mode in ("exact", "quantized", "rerank"):
            for flt in (None, np.arange(1, 1200, 3)):
                a = one.search(q, 9, mode=mode, ids_filter=flt)
                b = mesh.search(q, 9, mode=mode, ids_filter=flt)
                np.testing.assert_array_equal(b[0], a[0])
                if mode == "rerank" and flt is None and qtype == "int8":
                    np.testing.assert_allclose(b[1], a[1], rtol=1e-5)
                else:
                    np.testing.assert_array_equal(b[1], a[1])


def test_sharding_placement_behaves_as_its_mesh(meshes, rng, monkeypatch):
    """JAX test_upload_padded_preserves_explicit_sharding: sharding=
    row_sharding(mesh) lays rows out as mesh= does; a replicated placement
    or a non-placement raises; make_mesh() takes the CUDA devices and
    raises without one, never falling back to the CPU."""
    pmesh = meshes["1d"][1]
    ds = svt.Dataset("sh", VectorOptions(dimension=16, type=VectorType.F32), sharding=parallel.row_sharding(pmesh))
    data = rng.standard_normal((2000, 16)).astype(np.float32)
    ids = ds.add(data)
    assert ds._mesh is pmesh and isinstance(ds._vectors, parallel.RowShards)
    got, dist = ds.search(data[5], 3)
    assert got[0] == ids[5] and dist[0] == 0.0
    with pytest.raises(svt.VectorConfigError, match="sharding="):
        svt.Dataset("r", VectorOptions(dimension=16), sharding=parallel.replicated_sharding(pmesh))
    with pytest.raises(svt.VectorConfigError, match="sharding="):
        svt.VectorStore(sharding=object())
    with pytest.raises(ValueError, match="need 8 devices"):
        make_mesh_2d(4, 2, devices=["cpu"] * 7)
    with pytest.raises(ValueError, match="no devices"):
        make_mesh(devices=[])
    assert make_mesh(devices=["cpu"] * 3).shape == {"rows": 3}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no devices"):
        make_mesh()


# ---------------------------------------------------------------------------
# 2-D mesh: rows x dim
# ---------------------------------------------------------------------------


def _jax_2d(meshes, base, q):
    from sqlite_vector_tpu.parallel import block_sharding_2d, dim_sharding_2d

    jmesh = meshes["2d"][0]
    return jax.device_put(q, dim_sharding_2d(jmesh)), jax.device_put(base, block_sharding_2d(jmesh))


@pytest.mark.parametrize("metric", METRICS)
def test_sharded_2d_topk_matches_jax(meshes, metric, rng):
    """JAX test_sharded_2d_topk_matches_oracle: ids equal to JAX's and the
    oracle's, values within the JAX test's rtol 5e-4 / atol 1e-5 of the
    oracle."""
    from sqlite_vector_tpu.parallel import sharded_scan_topk_2d as jax_2d

    jmesh, pmesh = meshes["2d"]
    n, d, b, k = 4 * 50, 64, 3, 7
    base = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    vals, idx = sharded_scan_topk_2d(from_numpy(q), from_numpy(base), DistanceMetric(metric), k, pmesh)
    jv, ji = jax_topk(jax_2d, *_jax_2d(meshes, base, q), JaxMetric(metric), k, jmesh)
    np.testing.assert_array_equal(idx.numpy(), ji)
    want = oracle.distance(q, base, JaxMetric(metric), JaxVectorType.F32)
    for bi in range(b):
        order = np.argsort(want[bi], kind="stable")[:k]
        assert idx[bi].tolist() == order.tolist()
        np.testing.assert_allclose(vals[bi].numpy(), oracle.snap_zero(want[bi][order]), rtol=5e-4, atol=1e-5)


def test_sharded_2d_int_codes_exact(meshes, rng):
    """int8 codes on a 2-D mesh: exact integer partial sums, values
    bit-equal to the oracle and to JAX."""
    from sqlite_vector_tpu.parallel import sharded_scan_topk_2d as jax_2d

    jmesh, pmesh = meshes["2d"]
    n, d, k = 4 * 32, 32, 5
    codes = rng.integers(-128, 128, (n, d)).astype(np.int8)
    q = rng.integers(-128, 128, (2, d)).astype(np.int8)
    for metric in METRICS:
        vals, idx = sharded_scan_topk_2d(from_numpy(q), from_numpy(codes), DistanceMetric(metric), k, pmesh)
        jv, ji = jax_topk(jax_2d, *_jax_2d(meshes, codes, q), JaxMetric(metric), k, jmesh)
        np.testing.assert_array_equal(idx.numpy(), ji)
        np.testing.assert_array_equal(vals.numpy(), jv)
    ref = oracle.distance(q, codes, JaxMetric.SQUARED_L2, JaxVectorType.I8)
    vals, idx = sharded_scan_topk_2d(from_numpy(q), from_numpy(codes), DistanceMetric.SQUARED_L2, k, pmesh)
    for bi in range(2):
        order = np.argsort(ref[bi], kind="stable")[:k]
        assert idx[bi].tolist() == order.tolist()
        np.testing.assert_array_equal(vals[bi].numpy(), ref[bi][order])


def test_sharded_2d_valid_count_and_padding(meshes, rng):
    pmesh = meshes["2d"][1]
    n, d, valid = 4 * 16, 32, 10
    base = np.zeros((n, d), np.float32)
    base[:valid] = rng.standard_normal((valid, d))
    base[valid:] = 7.7
    base[:, d - 2 :] = 0.0
    q = rng.standard_normal((1, d)).astype(np.float32)
    q[:, d - 2 :] = 0.0
    vals, idx = sharded_scan_topk_2d(from_numpy(q), from_numpy(base), DistanceMetric.L2, 15, pmesh, valid_count=valid)
    assert (idx[0][:valid] >= 0).all() and (idx[0][:valid] < valid).all()
    assert (idx[0][valid:] == -1).all() and np.isposinf(vals[0][valid:].numpy()).all()


def test_sharded_2d_rejects_uneven_blocks(meshes):
    with pytest.raises(ValueError, match="divide evenly"):
        sharded_scan_topk_2d(torch.zeros(1, 64), torch.zeros(101, 64), DistanceMetric.L2, 3, meshes["2d"][1])


def test_dataset_on_2d_mesh_end_to_end(meshes, rng):
    """JAX test_dataset_on_2d_mesh_end_to_end on both packages, d = 33 (pads
    to 34 on the 2-wide dim axis): exact, batched, int8 params and codes
    bit-equal (pad code columns zero), quantized values bit-equal, rerank,
    distances, ids_filter, append."""
    pair = MeshPair("dimension=33,type=FLOAT32,distance=L2", *meshes["2d"])
    base = (rng.standard_normal((500, 33)) * 2).astype(np.float32)
    ids = pair.do("add", base)
    assert pair.p._vectors.shape == (1024, 34)
    q = base[123]
    got, dist = pair.p.search(q, 5)
    ref = oracle.distance(q[None], base, JaxMetric.L2, JaxVectorType.F32)[0]
    order = np.argsort(ref, kind="stable")[:5]
    assert got.tolist() == [int(ids[i]) for i in order] and dist[0] == 0.0
    np.testing.assert_allclose(dist, oracle.snap_zero(ref[order]), rtol=1e-4, atol=1e-6)
    got_b, _ = pair.p.search(base[:7], 3)
    assert (got_b[:, 0] == ids[:7]).all()
    assert pair.do("quantize") == 500
    assert qparams(pair.p) == qparams(pair.j)
    codes = torch.cat(pair.p._quant.codes.blocks[0], dim=1)
    assert (codes[:, 33:] == 0).all()
    np.testing.assert_array_equal(pair.p._quant.codes.read(0, 500).numpy(), np.asarray(pair.j._quant.codes)[:500, :33])
    qs = np.concatenate([base[[123, 9]], rng.standard_normal((2, 33)).astype(np.float32)])
    a, b = pair.j.search(qs, 5, exact=False), pair.p.search(qs, 5, exact=False)
    np.testing.assert_array_equal(b[0], a[0])
    np.testing.assert_array_equal(b[1], a[1])
    r_ids, r_vals = pair.p.search(q, 5, mode="rerank")
    assert r_ids[0] == ids[123] and r_vals[0] == 0.0
    np.testing.assert_allclose(pair.p.search(qs, 5, mode="rerank")[1], pair.j.search(qs, 5, mode="rerank")[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pair.p.distances(base[:3]), pair.j.distances(base[:3]), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(pair.p.distances(qs, exact=False), pair.j.distances(qs, exact=False))
    f_ids, _ = pair.p.search(q, 3, ids_filter=ids[100:110])
    assert set(f_ids.tolist()) <= set(ids[100:110].tolist())
    extra = np.full((1, 33), 0.25, np.float32)
    new_ids = pair.do("add", extra)
    g2, d2 = pair.p.search(extra[0], 1)
    assert g2[0] == new_ids[0] and d2[0] == 0.0


def test_dataset_2d_mesh_tombstone_remove(meshes, rng):
    pair = MeshPair("dimension=33,type=FLOAT32,distance=L2", *meshes["2d"])
    base = rng.standard_normal((200, 33)).astype(np.float32)
    ids = pair.do("add", base)
    before = pair.p._vectors
    assert pair.do("remove", ids[10:20]) == 10
    assert pair.p._vectors is before and len(pair.p) == 190
    assert pair.p.search(base[15], 1)[0][0] != ids[15]
    got, dist = pair.p.search(base[30], 1)
    assert got[0] == ids[30] and dist[0] == 0.0
    keep = np.ones(200, bool)
    keep[10:20] = False
    ref = oracle.distance(base[40][None], base[keep], JaxMetric.L2, JaxVectorType.F32)[0]
    np.testing.assert_allclose(pair.p.search(base[40], 5)[1], oracle.snap_zero(np.sort(ref)[:5]), rtol=1e-4, atol=1e-6)
    pair.check_state()


def test_dataset_2d_mesh_quantized_save_load_roundtrip(meshes, rng, tmp_path):
    """Saves from a 2-D mesh cut the dim padding: a port 2-D save loads in
    the JAX package on one device and on its 2-D mesh, and a JAX 2-D save
    loads onto a port 2-D mesh and on one device."""
    jmesh, pmesh = meshes["2d"]
    pair = MeshPair("dimension=33,type=FLOAT32,distance=L2", jmesh, pmesh)
    base = rng.standard_normal((100, 33)).astype(np.float32)
    ids = pair.do("add", base)
    pair.do("quantize")
    pair.p.save(str(tmp_path / "p"))
    pair.j.save(str(tmp_path / "j"))
    for back in (jax_svt.Dataset.load(str(tmp_path / "p")), jax_svt.Dataset.load(str(tmp_path / "p"), mesh=jmesh),
                 svt.Dataset.load(str(tmp_path / "j"), device="cpu"), svt.Dataset.load(str(tmp_path / "j"), mesh=pmesh)):
        assert back.is_quantized and len(back) == 100
        got, _ = back.search(base[7], 3, mode="quantized")
        assert got[0] == ids[7]
    back = svt.Dataset.load(str(tmp_path / "j"), mesh=pmesh)
    np.testing.assert_array_equal(back.search(base[:4], 5, exact=False)[1], pair.j.search(base[:4], 5, exact=False)[1])


def test_dataset_2d_mesh_rejects_host_storage_and_int4(meshes):
    """As in the JAX package: host storage and int4 raise on a 2-D mesh,
    with its messages (less the host-storage message's pointer to the JAX
    package's STATUS.md, which does not describe the port)."""
    jmesh, pmesh = meshes["2d"]
    msgs = []
    for mod, mesh in ((jax_svt, jmesh), (svt, pmesh)):
        with pytest.raises(mod.VectorConfigError, match="2-D mesh") as e:
            mod.Dataset("h2", mod.parse_options("dimension=8"), mesh=mesh, storage="host")
        msgs.append(str(e.value))
        ds = mod.Dataset("i4", mod.parse_options("dimension=8"), mesh=mesh)
        ds.add(np.ones((4, 8), np.float32))
        with pytest.raises(mod.VectorConfigError, match="INT4") as e:
            ds.quantize(qtype="int4")
        msgs.append(str(e.value))
    assert [msgs[0].replace(" (see STATUS.md)", ""), msgs[1]] == msgs[2:]


@pytest.mark.nonfinite_inputs
@pytest.mark.parametrize("metric", METRICS)
def test_dataset_2d_mesh_nonfinite_policy_matches_unsharded(meshes, metric, rng):
    """f16 lane-skip policies on the 2-D mesh (policy_pairwise_sharded):
    the same neighbors as the port on one device, values within the JAX
    test's rtol 1e-5 / atol 1e-6, and as the JAX 2-D mesh."""
    d, n, k = 24, 64, 8
    base = rng.standard_normal((n, d)).astype(np.float16)
    base[3, 2] = np.nan
    base[5, 20] = np.inf
    base[9, 1] = -np.inf
    base[11, 0] = np.nan
    base[11, 15] = np.inf
    opts = f"dimension={d},type=FLOAT16,distance={metric}"
    one = svt.Dataset("nf1", svt.parse_options(opts), device="cpu")
    pair = MeshPair(opts, *meshes["2d"])
    one.add(base)
    pair.do("add", base)
    q_nan = base[1].astype(np.float32)
    q_nan[7] = np.nan
    for q in (base[0].astype(np.float32), np.full(d, 0.5, np.float32), q_nan):
        ids1, d1 = one.search(q, k)
        ids2, d2 = pair.p.search(q, k)
        jids, jd = pair.j.search(q, k)
        assert ids1.tolist() == ids2.tolist() == jids.tolist(), metric
        np.testing.assert_allclose(d2, d1, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(d2, jd, rtol=1e-5, atol=1e-6)


@pytest.mark.nonfinite_inputs
def test_sharded_2d_policy_dot_first_inf_across_shards(meshes, rng):
    """DOT's short-circuit takes the FIRST infinite product by GLOBAL lane
    index across the dim shards (src/distance-cpu.c:414-421): the port's
    sharded policy equals its one-device policy and JAX's sharded one."""
    from sqlite_vector_tpu.parallel import sharded_scan_distances_2d as jax_dist_2d

    from sqlite_vector_tpu_torch.ops.nonfinite import policy_pairwise
    from sqlite_vector_tpu_torch.parallel import sharded_scan_distances_2d

    jmesh, pmesh = meshes["2d"]
    n, d = 8, 64
    base = (rng.standard_normal((n, d)) * 0.1).astype(np.float32)
    q = np.abs(rng.standard_normal((1, d))).astype(np.float32) + 0.5
    base[0, 40] = np.inf
    base[1, 10] = -np.inf
    base[1, 50] = np.inf
    base[2, 33] = np.inf
    base[2, 5] = np.nan
    want = policy_pairwise(from_numpy(q), from_numpy(base), DistanceMetric.DOT, VectorType.F16).numpy()
    got = torch.cat(sharded_scan_distances_2d(
        from_numpy(q), from_numpy(base), DistanceMetric.DOT, pmesh, policy_vtype=VectorType.F16
    ), dim=1).numpy()
    jgot = np.asarray(jax_dist_2d(*_jax_2d(meshes, base, q), JaxMetric.DOT, jmesh, policy_vtype=JaxVectorType.F16))
    assert np.isneginf(want[0, 0]) and np.isposinf(want[0, 1]) and np.isneginf(want[0, 2])
    finite = np.isfinite(want)
    for other in (got, jgot):
        np.testing.assert_array_equal(np.isfinite(other), finite)
        np.testing.assert_array_equal(other[~finite], want[~finite])
        np.testing.assert_allclose(other[finite], want[finite], rtol=1e-5)


@pytest.mark.nonfinite_inputs
def test_dataset_2d_mesh_f32_inf_raw_distances(meshes, rng):
    """f32 L2 distances on the 2-D mesh expose the reference's raw values
    for Inf rows (+Inf, not the decomposition's NaN), as JAX's do."""
    d, n = 16, 32
    base = rng.standard_normal((n, d)).astype(np.float32)
    base[4, 3] = np.inf
    base[7, 12] = np.nan
    pair = MeshPair(f"dimension={d},type=FLOAT32,distance=L2", *meshes["2d"])
    pair.do("add", base)
    q = rng.standard_normal(d).astype(np.float32)
    got, jgot = pair.p.distances(q), pair.j.distances(q)
    want = oracle.distance(q[None, :], base, JaxMetric.L2, JaxVectorType.F32)[0]
    assert np.isposinf(got[4]) and np.isnan(got[7])
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(jgot))


def test_dataset_2d_mesh_custom_axis_names(rng):
    mesh = make_mesh_2d(4, 2, devices=["cpu"] * 8, axis_names=("r", "d"))
    ds = svt.Dataset("ax", VectorOptions(dimension=16, distance=DistanceMetric.L2), mesh=mesh)
    base = rng.standard_normal((200, 16)).astype(np.float32)
    ids = ds.add(base)
    got, dist = ds.search(base[42], 3)
    assert got[0] == ids[42] and dist[0] == 0.0
    ds.quantize()
    assert ds.search(base[42], 3, exact=False)[0][0] == ids[42]
    dm = ds.distances(base[7])
    assert dm.shape == (200,) and abs(dm[7]) < 1e-5


def test_sharded_2d_l1_snaps_nearly_zero(meshes, rng):
    base = rng.standard_normal((4 * 16, 32)).astype(np.float32)
    vals, idx = sharded_scan_topk_2d(from_numpy(base[5][None]), from_numpy(base), DistanceMetric.L1, 1, meshes["2d"][1])
    assert idx[0][0] == 5 and vals[0][0] == 0.0


@pytest.mark.parametrize("metric", METRICS)
def test_sharded_2d_cached_norms_match_uncached(meshes, metric, rng):
    """Full-dim norms passed in (parallel.ops.full_dim_sq_norms) give the
    uncached results: float32 and int8, bit-equal (the cache is the same
    sum of the blocks' partial norms)."""
    from sqlite_vector_tpu_torch.parallel.ops import full_dim_sq_norms

    pmesh = meshes["2d"][1]
    n, d, b, k = 4 * 40, 64, 3, 9
    for dtype in (np.float32, np.int8):
        if dtype is np.float32:
            base = rng.standard_normal((n, d)).astype(np.float32)
            q = rng.standard_normal((b, d)).astype(np.float32)
        else:
            base = rng.integers(-128, 128, (n, d)).astype(np.int8)
            q = rng.integers(-128, 128, (b, d)).astype(np.int8)
        shards = parallel.RowShards.from_tensor(from_numpy(base), pmesh.grid())
        m = DistanceMetric(metric)
        v0, i0 = sharded_scan_topk_2d(from_numpy(q), shards, m, k, pmesh)
        v1, i1 = sharded_scan_topk_2d(from_numpy(q), shards, m, k, pmesh, base_sq_norms=full_dim_sq_norms(shards))
        assert torch.equal(i0, i1) and torch.equal(v0, v1)


def test_dataset_2d_mesh_norm_cache_reuse(meshes, rng):
    ds = svt.Dataset("dnc", VectorOptions(dimension=32, distance=DistanceMetric.COSINE), mesh=meshes["2d"][1])
    base = rng.standard_normal((400, 32)).astype(np.float32)
    ids = ds.add(base)
    got1, _ = ds.search(base[7], 5)
    assert ds._sq_norms is not None and ds._sq_norms[0] is ds._vectors
    cached = ds._sq_norms[1]
    got2, _ = ds.search(base[7], 5)
    assert ds._sq_norms[1] is cached and got1[0] == ids[7] == got2[0]
    ds.quantize()
    a1, _ = ds.search(base[7], 5, exact=False)
    qsq = ds._code_norms[1]
    a2, _ = ds.search(base[7], 5, exact=False)
    assert ds._code_norms[1] is qsq and a1[0] == ids[7] == a2[0]
    ds.add(rng.standard_normal((8, 32)).astype(np.float32))
    assert ds.search(base[7], 5)[0][0] == ids[7]
    assert ds._sq_norms[0] is ds._vectors


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_dataset_2d_mesh_append_after_search(meshes, metric, rng):
    """Rows appended in place after a search (which cached the full-dim
    norms) are scored with their own norms: a query that is none of the
    new rows, but lies near them, gets the same ids as JAX's 2-D mesh and
    the port on one device, values within the JAX end-to-end tolerance
    (rtol 1e-4 / atol 1e-6); distances() over every row likewise."""
    opts = f"dimension=33,type=FLOAT32,distance={metric}"
    pair = MeshPair(opts, *meshes["2d"])
    one = svt.VectorStore(device="cpu").create("o", opts)
    base = rng.standard_normal((500, 33)).astype(np.float32)
    q = rng.standard_normal(33).astype(np.float32)
    extra = (q + 0.05 * rng.standard_normal((4, 33))).astype(np.float32)
    pair.do("add", base)
    one.add(base)
    pair.p.search(q, 5)
    assert pair.p._sq_norms is not None
    new_ids = pair.do("add", extra)
    one.add(extra)
    got, dist = pair.p.search(q, 5)
    assert set(new_ids.tolist()) <= set(got.tolist())
    for want in (pair.j.search(q, 5), one.search(q, 5)):
        np.testing.assert_array_equal(got, want[0])
        np.testing.assert_allclose(dist, want[1], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pair.p.distances(q[None]), pair.j.distances(q[None]), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_mesh_append_amortized(meshes, rng, kind, monkeypatch):
    """An append below the capacity writes only the new rows into their
    shards: no re-layout, no full upload, the shards' tensors kept."""
    ds = svt.Dataset("ma", svt.parse_options("dimension=16,type=FLOAT32,distance=L2"), mesh=meshes[kind][1])
    base = rng.standard_normal((1000, 16)).astype(np.float32)
    ids = ds.add(base)
    before = [list(row) for row in ds._vectors.blocks]

    def boom(*a, **kw):
        raise AssertionError("append re-laid the matrix out")

    monkeypatch.setattr(parallel.RowShards, "take", boom)
    monkeypatch.setattr(parallel.RowShards, "from_host", boom)
    extra = rng.standard_normal((10, 16)).astype(np.float32)
    extra_ids = ds.add(extra)
    assert all(a is b for ra, rb in zip(before, ds._vectors.blocks) for a, b in zip(ra, rb))
    got, dist = ds.search(extra[3], 3)
    assert got[0] == extra_ids[3] and dist[0] == 0.0
    assert ds.search(base[123], 3)[0][0] == ids[123]
