"""Persistence of the port (Dataset.save / save_stream / load, the JAX
package's on-disk format) and the host-storage quantize build with its
checkpoints, against the JAX package on the same inputs (both on the CPU).

Rows, ids, codes, params and tokens must come back bit-equal across the
two packages; searches of a loaded dataset match the JAX dataset's (int8
bit-equal; float32 within REL_TOL_BY_TYPE, ids tie-aware, through
tests/test_torch_mutations.py:compare_mode). Tests that crash a save or a
build patch the port's own functions."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import sqlite_vector_tpu as jax_svt
import sqlite_vector_tpu_torch as svt
import sqlite_vector_tpu_torch.dataset as dsmod
from sqlite_vector_tpu_torch.device import bf16_bits
from sqlite_vector_tpu_torch.hostarray import ShardedRows
from sqlite_vector_tpu import oracle
from sqlite_vector_tpu_torch.types import QuantType
from tests.test_torch_mutations import compare_mode

DTYPES = ["FLOAT32", "FLOAT16", "FLOATB16", "UINT8", "INT8"]
STORAGES = [("hbm", False), ("host", False), ("host", True)]


def rows_of(dtype, rng, shape):
    if dtype == "UINT8":
        return rng.integers(0, 256, shape).astype(np.float32)
    if dtype == "INT8":
        return rng.integers(-128, 128, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def port_rows(ds) -> np.ndarray:
    """The port dataset's rows in the host form (bfloat16 as bits)."""
    n = ds._count
    if ds._storage == "host":
        return np.asarray(ds._host_vectors[:n])
    return dsmod._rows_to_host(ds._vectors[:n], ds.dtype)


def jax_rows(ds) -> np.ndarray:
    rows = np.asarray(ds._host_vectors)[: ds._count]
    return rows.view(np.uint16) if rows.dtype.name == "bfloat16" else rows


def as_np(x, n):
    return x[:n].numpy() if isinstance(x, torch.Tensor) else np.asarray(x)[:n]


def assert_same_state(pds, jds):
    assert len(pds) == len(jds) and pds.tombstones == jds.tombstones
    np.testing.assert_array_equal(pds._ids[: pds._count], jds._ids[: jds._count])
    np.testing.assert_array_equal(pds._dead[: pds._count], jds._dead[: jds._count])
    np.testing.assert_array_equal(port_rows(pds), jax_rows(jds))
    assert pds._next_rowid == jds._next_rowid
    assert pds._has_nonfinite == jds._has_nonfinite
    assert pds.is_quantized == jds.is_quantized
    if not pds.is_quantized:
        return
    pq, jq = pds._quant, jds._quant
    assert (pq.qtype.value, pq.scale, pq.offset, pq.count, pq.stale) == (
        jq.qtype.value, jq.scale, jq.offset, jq.count, jq.stale
    )
    np.testing.assert_array_equal(pq.ids, jq.ids)
    n = pq.count
    pairs = [("codes", pq.codes, jq.codes), ("alpha", pq.row_scale, jq.row_scale),
             ("csq", pq.sq_norms, jq.sq_norms), ("codes8", pq.codes8, jq.codes8)]
    for name, p, j in pairs:
        assert (p is None) == (j is None), name
        if p is not None:
            want = as_np(j, n)
            if name in ("codes", "codes8") and pq.qtype is not QuantType.I4 or name == "codes8":
                want = want[:, : pds.dimension]
            np.testing.assert_array_equal(as_np(p, n), want, err_msg=name)
    if pq.codes8 is not None:
        assert (pq.qtype8.value, pq.scale8, pq.offset8) == (jq.qtype8.value, jq.scale8, jq.offset8)


def build_pair(dtype, rng, n=700, dim=24, metric="L2"):
    """The same rows, mutations and int8 codes in a JAX and a port dataset
    (hbm), with a stale quantization and tombstones left over."""
    opts = f"dimension={dim},type={dtype},distance={metric}"
    jds = jax_svt.VectorStore().create("p", opts)
    pds = svt.VectorStore(device="cpu").create("p", opts)
    base = rows_of(dtype, rng, (n, dim))
    for ds in (jds, pds):
        ds.add(base, ids=np.arange(3, 3 + n))
        ds.quantize()
        ds.remove(np.arange(3, 3 + n)[::9])  # tombstones, below the threshold
    return jds, pds, base


@pytest.mark.parametrize("storage,mmap", STORAGES, ids=["hbm", "host", "host-mmap"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_load_both_ways(dtype, storage, mmap, rng, tmp_path):
    jds, pds, base = build_pair(dtype, rng)
    q = base[[5, 400]]
    for shard_rows in (None, 250):
        jdir, pdir = str(tmp_path / f"j{shard_rows}"), str(tmp_path / f"p{shard_rows}")
        jds.save(jdir, shard_rows=shard_rows)
        pds.save(pdir, shard_rows=shard_rows)
        assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir))
        with open(os.path.join(jdir, "manifest.json")) as f:
            jm = json.load(f)
        with open(os.path.join(pdir, "manifest.json")) as f:
            pm = json.load(f)
        assert pm.keys() == jm.keys() and pm["quant"].keys() == jm["quant"].keys()
        p_from_j = svt.Dataset.load(jdir, device="cpu", storage=storage, mmap=mmap)
        j_from_p = jax_svt.Dataset.load(pdir, storage=storage, mmap=mmap)
        j_from_j = jax_svt.Dataset.load(jdir, storage=storage, mmap=mmap)
        assert_same_state(p_from_j, j_from_j)
        assert_same_state(p_from_j, j_from_p)
        assert p_from_j._data_token == jds._data_token and j_from_p._data_token == pds._data_token
        if dtype in ("FLOAT16", "FLOATB16"):
            continue  # their exact search waits for the non-finite policy port
        compare_mode(j_from_j, p_from_j, q, "exact")
        compare_mode(j_from_j, p_from_j, q, "quantized")


@pytest.mark.parametrize("storage,mmap", STORAGES, ids=["hbm", "host", "host-mmap"])
def test_cross_load_int4_refine_and_stale_snapshot(storage, mmap, rng, tmp_path):
    """int4 codes with the refine sidecar, and a stale quantization of more
    rows than the live matrix (its qids), both ways."""
    base = rng.standard_normal((1300, 20)).astype(np.float32)
    opts = "dimension=20,distance=COSINE"
    jds = jax_svt.VectorStore().create("p", opts)
    pds = svt.VectorStore(device="cpu").create("p", opts)
    for ds in (jds, pds):
        ds.add(base)
        ds.quantize(qtype="int4", refine=True)
        ds.remove(ds.ids[:1100])  # past the threshold: compacts, codes stale
    for src, dst, load in ((jds, "j", svt.Dataset.load), (pds, "p", jax_svt.Dataset.load)):
        src.save(str(tmp_path / dst), shard_rows=128)
    kw = {"storage": storage, "mmap": mmap}
    p_from_j = svt.Dataset.load(str(tmp_path / "j"), device="cpu", **kw)
    j_from_p = jax_svt.Dataset.load(str(tmp_path / "p"), **kw)
    j_from_j = jax_svt.Dataset.load(str(tmp_path / "j"), **kw)
    assert p_from_j._quant.stale and p_from_j._quant.count == 1300 and len(p_from_j) == 200
    assert_same_state(p_from_j, j_from_j)
    assert_same_state(p_from_j, j_from_p)
    assert p_from_j._data_token == jds._data_token and j_from_p._data_token == pds._data_token
    q = base[[1200, 1250]]
    for mode in ("exact", "quantized", "rerank"):
        compare_mode(j_from_j, p_from_j, q, mode)
    if storage == "host":
        for ds in (j_from_j, p_from_j):
            ds.preload()
    compare_mode(j_from_j, p_from_j, q, "refine")


def test_save_load_roundtrip(rng, tmp_path):
    base = rng.standard_normal((37, 16)).astype(np.float32)
    ds = svt.Dataset.from_arrays("r", base, options="dimension=16,distance=COSINE", device="cpu")
    ds.quantize()
    ds.save(str(tmp_path / "ds"))
    back = svt.Dataset.load(str(tmp_path / "ds"), device="cpu")
    assert len(back) == 37 and back.metric is svt.DistanceMetric.COSINE
    assert back.quant_params == ds.quant_params
    for exact in (True, False):
        for a, b in zip(back.search(base[5], 5, exact=exact), ds.search(base[5], 5, exact=exact)):
            np.testing.assert_array_equal(a, b)


def test_resave_onto_own_directory_mmap_sources(rng, tmp_path):
    """save() onto the directory a dataset was loaded from reads its codes
    (and, with mmap, its shards) through memory maps of the files it
    writes: the temp-and-rename commit keeps the old inode for them."""
    d = str(tmp_path / "self")
    data = (rng.standard_normal((40, 12)) * 2).astype(np.float32)
    ds = svt.Dataset("s", svt.parse_options("dimension=12,type=FLOATB16"), device="cpu", storage="host")
    ids = ds.add(data)
    ds.quantize()
    ds.remove([int(ids[3])])
    ds.quantize()
    want = ds.search(data[5], 4, exact=False)[0].tolist()
    for _ in range(3):
        ds.save(d)
        ds = svt.Dataset.load(d, device="cpu", storage="host")
        assert ds.search(data[5], 4, exact=False)[0].tolist() == want
    d2 = str(tmp_path / "self2")
    ds2 = svt.Dataset.from_arrays("s2", data, options="dimension=12", device="cpu")
    ds2.save(d2, shard_rows=16)
    for _ in range(3):
        ds2 = svt.Dataset.load(d2, device="cpu", storage="host", mmap=True)
        np.testing.assert_array_equal(ds2._host_vectors[0:40], data)
        assert int(ds2.search(data[5], 1)[0][0]) == 6
        ds2.save(d2, shard_rows=16)  # writes FROM the mmap of these shards


def test_save_resume_provenance(rng, tmp_path, monkeypatch):
    """save(resume=True) skips a shard only with proven provenance (the
    marker of an interrupted save, or the manifest, under this data token)."""
    data = rng.standard_normal((64, 8)).astype(np.float32)
    ds = svt.Dataset("r", svt.parse_options("dimension=8"), device="cpu")
    ds.add(data)
    d = str(tmp_path / "r")
    real = dsmod._atomic_npy_save
    calls = {"n": 0}

    def dying(limit):
        def save(path, arr):
            calls["n"] += 1
            if calls["n"] >= limit:
                raise OSError("simulated disk failure")
            real(path, arr)
        return save

    def counting(path, arr):
        calls["n"] += 1
        real(path, arr)

    # (a) crash on shard 3 (ids + 2 shards land); resume rewrites ids + 2
    monkeypatch.setattr(dsmod, "_atomic_npy_save", dying(4))
    with pytest.raises(OSError, match="simulated"):
        ds.save(d, shard_rows=16)
    monkeypatch.setattr(dsmod, "_atomic_npy_save", counting)
    calls["n"] = 0
    ds.save(d, shard_rows=16, resume=True)
    assert calls["n"] == 3
    np.testing.assert_array_equal(svt.Dataset.load(d, device="cpu").get(ds.ids), data)
    assert not os.path.exists(os.path.join(d, "save_in_progress.json"))
    # (b) a same-count update between saves rewrites its shard
    new_row = (data[0] * 7 + 1).astype(np.float32)
    ds.update(ds.ids[0], new_row)
    ds.save(d, shard_rows=16, resume=True)
    np.testing.assert_array_equal(svt.Dataset.load(d, device="cpu").get(ds.ids[0])[0], new_row)
    # (c) an unchanged re-save skips every shard (the manifest proves them)
    calls["n"] = 0
    ds.save(d, shard_rows=16, resume=True)
    assert calls["n"] == 1
    # (d) a crashed rewrite of same-count new content proves only the
    # shards it completed; load refuses the mixed directory meanwhile
    data2 = (data * 3 + 2).astype(np.float32)
    ds.update(ds.ids, data2)
    calls["n"] = 0
    monkeypatch.setattr(dsmod, "_atomic_npy_save", dying(3))
    with pytest.raises(OSError, match="simulated"):
        ds.save(d, shard_rows=16)
    with pytest.raises(ValueError, match="interrupted save"):
        svt.Dataset.load(d, device="cpu")
    with pytest.raises(ValueError, match="interrupted save"):
        jax_svt.Dataset.load(d)
    monkeypatch.setattr(dsmod, "_atomic_npy_save", counting)
    calls["n"] = 0
    ds.save(d, shard_rows=16, resume=True)
    assert calls["n"] == 4
    np.testing.assert_array_equal(svt.Dataset.load(d, device="cpu").get(ds.ids), data2)
    # (e) a foreign marker disproves everything: a full rewrite
    with open(os.path.join(d, "save_in_progress.json"), "w") as f:
        json.dump({"data_token": "foreign", "done_shards": {}}, f)
    calls["n"] = 0
    ds.save(d, shard_rows=16, resume=True)
    assert calls["n"] == 5


def test_save_stream_out_of_core(rng, tmp_path):
    d = str(tmp_path / "oc")
    data = rng.standard_normal((1000, 24)).astype(np.float32)
    n = svt.Dataset.save_stream(d, (data[s : s + 300] for s in range(0, 1000, 300)),
                                options="dimension=24,type=FLOAT32,distance=L2")
    assert n == 1000
    ds = svt.Dataset.load(d, device="cpu", storage="host", mmap=True)
    assert isinstance(ds._host_vectors, ShardedRows)
    assert len(ds) == 1000 and ds.ids[0] == 1 and ds.ids[-1] == 1000
    ref = svt.Dataset.from_arrays("ref", data, options="dimension=24", device="cpu")
    np.testing.assert_array_equal(ds.search(data[123], 5)[0], ref.search(data[123], 5)[0])
    qdir = str(tmp_path / "q")
    assert ds.quantize(checkpoint=qdir) == 1000
    ds2 = svt.Dataset.load(d, device="cpu", storage="host", mmap=True)
    assert ds2.quantize(checkpoint=qdir) == 1000  # all chunks done: no work
    assert ds2.quant_params == ds.quant_params
    # the JAX package reads the same directory and resumes the same build
    jds = jax_svt.Dataset.load(d, storage="host", mmap=True)
    assert jds._data_token == ds._data_token
    jds.quantize(checkpoint=qdir)
    np.testing.assert_array_equal(np.asarray(jds._quant.codes), ds2._quant.codes)


def test_save_stream_crash_leaves_disproof(rng, tmp_path):
    d = str(tmp_path / "cs")
    data = rng.standard_normal((600, 16)).astype(np.float32)
    opts = "dimension=16,type=FLOAT32"
    svt.Dataset.save_stream(d, (data[s : s + 200] for s in range(0, 600, 200)), options=opts)
    assert svt.Dataset.load(d, device="cpu", storage="host").search(data[5], 1)[1][0] == 0.0
    newer = data + 1.0

    def dying_chunks():
        yield newer[:200]
        raise RuntimeError("simulated crash mid-stream")

    with pytest.raises(RuntimeError):
        svt.Dataset.save_stream(d, dying_chunks(), options=opts)
    with pytest.raises(ValueError, match="interrupted save"):
        svt.Dataset.load(d, device="cpu", storage="host")
    assert svt.Dataset.save_stream(d, (newer[s : s + 200] for s in range(0, 600, 200)), options=opts) == 600
    assert svt.Dataset.load(d, device="cpu", storage="host").search(newer[7], 1)[1][0] == 0.0


def test_save_stream_shard_writes_are_atomic(rng, tmp_path, monkeypatch):
    d = str(tmp_path / "at")
    real_replace = os.replace
    renamed = set()

    def spy(src, dst):
        renamed.add(os.path.basename(dst))
        return real_replace(src, dst)

    monkeypatch.setattr(dsmod.os, "replace", spy)
    svt.Dataset.save_stream(d, [rng.standard_normal((100, 8)).astype(np.float32)], options="dimension=8")
    assert {"vectors-00000.npy", "ids.npy", "manifest.json"} <= renamed


def test_save_stream_bf16_and_dim_infer(rng, tmp_path):
    d = str(tmp_path / "ocb")
    data = rng.standard_normal((64, 8)).astype(np.float32)
    assert svt.Dataset.save_stream(d, [data], options="type=FLOATB16") == 64
    ds = svt.Dataset.load(d, device="cpu")
    assert ds.dtype is svt.VectorType.BF16 and ds.dimension == 8 and len(ds) == 64
    np.testing.assert_array_equal(np.load(os.path.join(d, "vectors-00000.npy")), bf16_bits(data))
    jds = jax_svt.Dataset.load(d)  # the JAX package rounds the same way
    np.testing.assert_array_equal(np.asarray(jds._host_vectors)[:64].view(np.uint16), bf16_bits(data))
    with pytest.raises(svt.VectorConfigError, match="dimension"):
        svt.Dataset.save_stream(str(tmp_path / "bad"), [data, data[:, :4]], options="type=FLOAT32")


def test_save_stream_empty_roundtrip(tmp_path):
    d = str(tmp_path / "empty")
    assert svt.Dataset.save_stream(d, [], options="dimension=8,type=FLOAT32") == 0
    for kw in ({}, {"storage": "host", "mmap": True}, {"storage": "host"}):
        ds = svt.Dataset.load(d, device="cpu", **kw)
        assert len(ds) == 0 and ds.search(np.zeros(8, np.float32), 3)[0].shape == (0,)


@pytest.mark.parametrize("shard_rows", [None, 64])
def test_mmap_host_dataset_remove_quantize_save(shard_rows, rng, tmp_path):
    """Read-only memory-mapped mirrors never compact: tombstones stay,
    scans mask them, quantize and save filter them chunk by chunk."""
    base = rng.standard_normal((300, 16)).astype(np.float32)
    src = svt.Dataset.from_arrays("src", base, options="dimension=16", device="cpu")
    ids = src.ids
    src.save(str(tmp_path / "d"), shard_rows=shard_rows)
    ds = svt.Dataset.load(str(tmp_path / "d"), device="cpu", storage="host", mmap=True)
    assert not ds._host_writable()
    assert ds.remove(ids[100:200]) == 100
    assert ds._n_dead == 100 and len(ds) == 200
    assert ds.search(base[150], 1)[0][0] != ids[150]
    got, dist = ds.search(base[50], 1)
    assert got[0] == ids[50] and dist[0] == 0.0
    with pytest.raises(svt.VectorStateError, match="read-only"):
        ds.compact()
    assert ds.quantize() == 200 and ds._quant.count == 200
    assert not np.isin(ids[100:200], ds._quant.ids).any()
    assert ds.search(base[20], 3, mode="quantized")[0][0] == ids[20]
    ds.save(str(tmp_path / "d2"), shard_rows=shard_rows)
    back = svt.Dataset.load(str(tmp_path / "d2"), device="cpu")
    assert len(back) == 200 and not np.isin(ids[100:200], back.ids).any()
    # update and add copy the mirror into a writable one first
    ds.update(ids[:1], base[1:2])
    new_ids = ds.add(base[:2])
    assert ds._host_writable() and len(ds) == 202 and new_ids[0] == ids[-1] + 1
    assert ds.search(base[1], 2)[0].tolist() == [ids[0], ids[1]]


def test_bf16_sharded_mmap_load(rng, tmp_path):
    ds = svt.Dataset("bfm", svt.parse_options("dimension=8,type=FLOATB16"), device="cpu")
    base = rng.standard_normal((9, 8)).astype(np.float32)
    ids = ds.add(base)
    ds.save(str(tmp_path / "bf"), shard_rows=4)
    for kw in ({"storage": "host", "mmap": True}, {"storage": "hbm"}):
        back = svt.Dataset.load(str(tmp_path / "bf"), device="cpu", **kw)
        got, dist = back.search(base[2], 1)
        assert got[0] == ids[2] and dist[0] == 0.0
        np.testing.assert_array_equal(back.get(ids).view(np.uint16), ds.get(ids).view(np.uint16))


def test_bf16_loads_and_searches_without_ml_dtypes(rng, tmp_path):
    """bfloat16 rows travel as their uint16 bits and are reinterpreted on
    the device: load and search need no numpy bfloat16 (ml_dtypes)."""
    d = str(tmp_path / "bf")
    base = rng.standard_normal((300, 16)).astype(np.float32)
    svt.Dataset.save_stream(d, [base[:120], base[120:]], options="dimension=16,type=FLOATB16")
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None  # import ml_dtypes now raises\n"
        "import numpy as np\n"
        "from sqlite_vector_tpu_torch import Dataset\n"
        "base = np.load(sys.argv[2])\n"
        "for kw in ({'storage': 'host', 'mmap': True}, {'storage': 'hbm'}):\n"
        "    ds = Dataset.load(sys.argv[1], device='cpu', **kw)\n"
        "    ids, d = ds.search(base[[7, 200]], 3)\n"
        "    assert ids[:, 0].tolist() == [8, 201] and (d[:, 0] == 0).all(), (ids, d)\n"
        "    assert ds.quantize() == 300\n"
    )
    np.save(tmp_path / "base.npy", base)
    subprocess.run([sys.executable, "-c", code, d, str(tmp_path / "base.npy")], check=True, timeout=120)


def test_host_storage_load_keeps_codes_host_resident(rng, tmp_path):
    base = rng.standard_normal((300, 16)).astype(np.float32)
    ds = svt.Dataset.from_arrays("hl", base, options="dimension=16", device="cpu")
    ds.quantize()
    ds.save(str(tmp_path / "ds"))
    back = svt.Dataset.load(str(tmp_path / "ds"), device="cpu", storage="host", mmap=True)
    assert not isinstance(back._quant.codes, torch.Tensor)
    assert back.memory_bytes() == 0  # host bytes are not device bytes
    want = ds.search(base[7], 3, exact=False)[0].tolist()
    assert back.search(base[7], 3, exact=False)[0].tolist() == want
    back.preload()
    assert isinstance(back._quant.codes, torch.Tensor)
    assert back.memory_bytes() == 300 * 16
    assert back.search(base[7], 3, exact=False)[0].tolist() == want


def test_load_stale_quant_larger_than_live_matrix(rng, tmp_path):
    n, dim = 3000, 8
    base = rng.standard_normal((n, dim)).astype(np.float32)
    base[7] += 8.0
    ds = svt.Dataset.from_arrays("st", base, options=f"dimension={dim}", device="cpu")
    ids = ds.ids
    ds.quantize()
    assert ds.remove(ids[500:]) == 2500
    ds.save(str(tmp_path / "ds"))
    back = svt.Dataset.load(str(tmp_path / "ds"), device="cpu")
    assert back._quant.stale and back._quant.count == n and len(back) == 500
    np.testing.assert_array_equal(back._quant.codes.numpy(), ds._quant.codes.numpy())
    got, dist = back.search(base[7], 3, mode="rerank")
    assert got[0] == ids[7] and dist[0] == 0.0
    assert ids[700] not in back.search(base[700], 3, mode="rerank")[0]


def test_quantize_and_save_compact_tombstones(rng, tmp_path):
    base = rng.standard_normal((60, 8)).astype(np.float32)
    ds = svt.Dataset.from_arrays("qc", base, options="dimension=8", device="cpu")
    ids = ds.ids
    ds.remove(ids[:15])
    assert ds.quantize() == 45 and ds._n_dead == 0
    ds.remove(ids[20:25])
    ds.save(str(tmp_path / "d"))
    back = svt.Dataset.load(str(tmp_path / "d"), device="cpu")
    assert len(back) == 40 and not np.isin(ids[20:25], back.ids).any()


def test_memory_bytes_against_jax():
    """memory_bytes is the port's own layout (ROADMAP queue 3, by design):
    the port keeps codes at `count` rows where the JAX package pads them to
    the matrix capacity, so JAX - port = (capacity - count) x code width."""
    base = np.random.default_rng(0).standard_normal((1500, 16)).astype(np.float32)
    jds = jax_svt.VectorStore().create("m", "dimension=16")
    pds = svt.VectorStore(device="cpu").create("m", "dimension=16")
    for ds in (jds, pds):
        ds.add(base)
    assert pds.memory_bytes() == jds.memory_bytes() == 2048 * 16 * 4
    for qtype, width, want in (("int8", 16, (163_840, 155_072)), ("int4", 8, (147_456, 143_072))):
        for ds in (jds, pds):
            ds.quantize(qtype=qtype)
        assert (jds.memory_bytes(), pds.memory_bytes()) == want
        assert jds.memory_bytes() - pds.memory_bytes() == (2048 - 1500) * width
    # host storage: no device bytes until preload() uploads the codes
    hds = svt.Dataset.from_arrays("h", base, options="dimension=16", device="cpu", storage="host")
    hds.quantize()
    assert hds.memory_bytes() == 0
    hds.preload()
    assert hds.memory_bytes() == 1500 * 16


# -- the host quantize build and its checkpoints ------------------------------


@pytest.fixture
def small_chunks(monkeypatch):
    """Host builds in 64-row chunks at dim 16 (the JAX package's too)."""
    import sqlite_vector_tpu.dataset as jax_dsmod

    monkeypatch.setattr(dsmod, "HOST_CHUNK_ELEMS", 16 * 64)
    monkeypatch.setattr(jax_dsmod, "HOST_CHUNK_ELEMS", 16 * 64)


def host_ds(rng, n=500, dim=16):
    data = (rng.standard_normal((n, dim)) * 5).astype(np.float32)
    ds = svt.Dataset("ckpt", svt.parse_options(f"dimension={dim}"), device="cpu", storage="host")
    ds.add(data)
    return ds, data


@pytest.mark.parametrize("qtype", ["int8", "uint8", "int4"])
def test_host_build_is_bit_equal_to_jax(qtype, rng, tmp_path, small_chunks):
    """The chunked host build over a read-only sharded mirror with
    tombstones (filtered chunk by chunk) gives the JAX host build's codes,
    params, alpha, csq and refine sidecar, bit for bit, and equals the
    port's own device build of the same live rows."""
    data = (rng.standard_normal((700, 16)) * 3).astype(np.float32)
    if qtype == "uint8":
        data = np.abs(data)
    data[11, 2] = np.nan  # NaN lanes: skipped by the params, coded 0
    d = str(tmp_path / "src")
    svt.Dataset.save_stream(d, [data[:300], data[300:]], options="dimension=16")
    refine = qtype == "int4"
    built = []
    for pkg, kw in ((svt, {"device": "cpu"}), (jax_svt, {})):
        ds = pkg.Dataset.load(d, storage="host", mmap=True, **kw)
        ds.remove(np.arange(1, 701)[5::11])
        ds.quantize(qtype=qtype, refine=refine, checkpoint=str(tmp_path / pkg.__name__))
        built.append(ds)
    pds, jds = built
    assert pds.tombstones == jds.tombstones == 64
    assert_same_state(pds, jds)
    live = np.ones(700, bool)
    live[5::11] = False
    dev = svt.Dataset.from_arrays("dev", data[live], options="dimension=16", device="cpu")
    dev.quantize(qtype=qtype, refine=refine)
    np.testing.assert_array_equal(pds._quant.codes, dev._quant.codes.numpy())
    assert pds.quant_params == dev.quant_params
    if refine:
        np.testing.assert_array_equal(pds._quant.codes8, dev._quant.codes8.numpy())
        np.testing.assert_array_equal(pds._quant.row_scale, dev._quant.row_scale.numpy())


def test_quantize_checkpoint_bit_identical(rng, tmp_path, small_chunks):
    ds, data = host_ds(rng)
    ds.quantize()
    plain, params = ds._quant.codes.copy(), ds.quant_params
    ds.drop_quantization()
    assert ds.quantize(checkpoint=str(tmp_path / "ck")) == len(data)
    np.testing.assert_array_equal(ds._quant.codes, plain)
    assert ds.quant_params == params
    with open(tmp_path / "ck" / "quant_checkpoint.json") as f:
        assert json.load(f)["done"] == -(-len(data) // 64)
    # on device storage the checkpoint is ignored, as in the JAX package
    dev = svt.Dataset.from_arrays("d", data, device="cpu")
    assert dev.quantize(checkpoint=str(tmp_path / "unused")) == len(data)
    assert not os.path.exists(tmp_path / "unused")
    np.testing.assert_array_equal(dev._quant.codes.numpy(), plain)


def test_quantize_checkpoint_resumes_after_crash(rng, tmp_path, small_chunks, monkeypatch):
    ds, data = host_ds(rng)
    ck = str(tmp_path / "ck")
    real = dsmod.quantize_device
    calls = {"n": 0}

    def dying(*a, **kw):
        if calls["n"] >= 3:
            raise RuntimeError("simulated crash mid-build")
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(dsmod, "quantize_device", dying)
    with pytest.raises(RuntimeError, match="simulated crash"):
        ds.quantize(checkpoint=ck)
    assert ds._quant is None  # the failed build published nothing

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    calls["n"] = 0
    monkeypatch.setattr(dsmod, "quantize_device", counting)
    assert ds.quantize(checkpoint=ck) == len(data)
    assert calls["n"] == -(-len(data) // 64) - 3  # resumed, not restarted
    got = ds._quant.codes.copy()
    ds.drop_quantization()
    ds.quantize()
    np.testing.assert_array_equal(got, ds._quant.codes)
    calls["n"] = 0
    ds.quantize(checkpoint=ck)  # finished: no chunk re-quantized
    assert calls["n"] == 0
    np.testing.assert_array_equal(ds._quant.codes, got)


def test_quantize_checkpoint_mismatch_restarts(rng, tmp_path, small_chunks):
    ds, data = host_ds(rng)
    ck = str(tmp_path / "ck")
    ds.quantize(checkpoint=ck)
    ds.add((rng.standard_normal((64, 16)) * 5).astype(np.float32))
    assert ds.quantize(checkpoint=ck) == len(data) + 64
    got = ds._quant.codes.copy()
    ds.drop_quantization()
    ds.quantize()
    np.testing.assert_array_equal(got, ds._quant.codes)


def test_quantize_checkpoint_rebuild_preserves_old_snapshot(rng, tmp_path, small_chunks):
    """A rebuild unlinks the old code files rather than truncating them: a
    search still holding the old snapshot reads what it read before."""
    ds, data = host_ds(rng)
    ck = str(tmp_path / "ck")
    ds.quantize(checkpoint=ck)
    old = ds._quant
    old_copy = np.array(old.codes)
    ds.remove(ds.ids[:8])
    ds.update(ds.ids[0], (data[8] * 10).astype(np.float32))
    ds.quantize(checkpoint=ck)
    assert ds._quant.count == len(data) - 8
    np.testing.assert_array_equal(np.asarray(old.codes), old_copy)


def test_quantize_checkpoint_detects_same_count_mutations(rng, tmp_path, small_chunks, monkeypatch):
    ds, data = host_ds(rng)
    ck = str(tmp_path / "ck")
    ds.quantize(checkpoint=ck)
    # (a) update(): same counts, a new token -> the codes rebuild
    new_row = (data[0] * 50).astype(np.float32)
    ds.update(ds.ids[0], new_row)
    ds.quantize(checkpoint=ck)
    q = ds._quant
    pos = int(np.flatnonzero(q.ids == int(ds.ids[0]))[0])
    np.testing.assert_array_equal(q.codes[pos], oracle.quantize(new_row[None], q.scale, q.offset, jax_svt.QuantType(q.qtype.value))[0])
    # (b) add + remove netting to the same counts -> a rebuild too
    kept = int(ds.ids[1])
    ds.remove([kept])
    added = (rng.standard_normal((1, 16)) * 5).astype(np.float32)
    (new_id,) = ds.add(added)
    ds.quantize(checkpoint=ck)
    q = ds._quant
    assert int(new_id) in set(q.ids.tolist()) and kept not in set(q.ids.tolist())
    pos = int(np.flatnonzero(q.ids == int(new_id))[0])
    np.testing.assert_array_equal(q.codes[pos], oracle.quantize(added, q.scale, q.offset, jax_svt.QuantType(q.qtype.value))[0])
    # (c) a save/load round trip keeps the token: the finished build resumes
    d = str(tmp_path / "rt")
    ds.save(d)
    ck2 = str(tmp_path / "ck2")
    svt.Dataset.load(d, device="cpu", storage="host", mmap=True).quantize(checkpoint=ck2)
    real, calls = dsmod.quantize_device, {"n": 0}

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(dsmod, "quantize_device", counting)
    ds3 = svt.Dataset.load(d, device="cpu", storage="host", mmap=True)
    ds3.quantize(checkpoint=ck2)
    assert calls["n"] == 0


def test_int4_and_refine_checkpoint_resume(rng, tmp_path):
    data = rng.standard_normal((300, 16)).astype(np.float32)
    d = str(tmp_path / "ck")
    svt.Dataset.save_stream(d, [data], options="dimension=16,distance=L2")
    ckpt = str(tmp_path / "q4ck")
    ds = svt.Dataset.load(d, device="cpu", storage="host", mmap=True)
    ds.quantize(qtype="int4", refine=True, checkpoint=ckpt)
    ids_a, d_a = ds.search(data[7], 3, mode="quantized")
    ds.preload()
    r_a = ds.search(data[7], 3, mode="refine")
    mtimes = {f: os.path.getmtime(os.path.join(ckpt, f)) for f in ("qcodes.npy", "refine8.npy")}
    ds2 = svt.Dataset.load(d, device="cpu", storage="host", mmap=True)
    ds2.quantize(qtype="int4", refine=True, checkpoint=ckpt)  # resumes both builds
    assert {f: os.path.getmtime(os.path.join(ckpt, f)) for f in mtimes} == mtimes
    ids_b, d_b = ds2.search(data[7], 3, mode="quantized")
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(d_a, d_b)
    ds2.preload()
    for a, b in zip(r_a, ds2.search(data[7], 3, mode="refine")):
        np.testing.assert_array_equal(a, b)
    # a mutation makes a new token: both rebuild
    ds2.update(ds2.ids[:1], data[1:2] + 5.0)
    ds2.quantize(qtype="int4", refine=True, checkpoint=ckpt)
    assert ds2.search(data[1] + 5.0, 1, mode="quantized")[0][0] == ds2.ids[0]
    ds2.preload()
    assert ds2.search(data[1] + 5.0, 1, mode="refine")[0][0] == ds2.ids[0]


def test_refine_sidecar_params_from_stats(rng, tmp_path, monkeypatch):
    """The sidecar's params from the int4 loop's accumulated min/max equal
    the dedicated params pass, across many chunks, with a NaN lane; a
    refine build over a finished plain int4 checkpoint (no stats) falls
    back to the params pass; a build crashed mid-way resumes its stats."""
    import sqlite_vector_tpu.dataset as jax_dsmod

    monkeypatch.setattr(dsmod, "HOST_CHUNK_ELEMS", 16 * 16)
    monkeypatch.setattr(jax_dsmod, "HOST_CHUNK_ELEMS", 16 * 16)
    data = rng.standard_normal((300, 16)).astype(np.float32)
    data[17, 3] = np.nan
    data[5] *= 50.0  # the extremes in chunk 0
    d = str(tmp_path / "hs")
    svt.Dataset.save_stream(d, [data], options="dimension=16,distance=L2")
    want = oracle.compute_quant_params_chunked(iter([data]), jax_svt.QuantType.AUTO)

    def sidecar(ds):
        q = ds._quant
        return q.qtype8.value, float(q.scale8), float(q.offset8)

    ds = svt.Dataset.load(d, device="cpu", storage="host", mmap=True)
    ds.quantize(qtype="int4", refine=True)
    assert sidecar(ds) == (want[0].value, float(want[1]), float(want[2]))
    ck = str(tmp_path / "ck")
    ds.quantize(qtype="int4", checkpoint=ck)  # no refine, no stats
    ds.quantize(qtype="int4", refine=True, checkpoint=ck)
    assert sidecar(ds) == (want[0].value, float(want[1]), float(want[2]))
    real, calls = dsmod.quantize4_device, {"n": 0}

    def boom(chunk):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("synthetic crash")
        return real(chunk)

    ck2 = str(tmp_path / "ck2")
    monkeypatch.setattr(dsmod, "quantize4_device", boom)
    with pytest.raises(RuntimeError, match="synthetic crash"):
        ds.quantize(qtype="int4", refine=True, checkpoint=ck2)
    monkeypatch.setattr(dsmod, "quantize4_device", real)
    ds.quantize(qtype="int4", refine=True, checkpoint=ck2)
    assert sidecar(ds) == (want[0].value, float(want[1]), float(want[2]))
    mtime = os.path.getmtime(os.path.join(ck2, "refine8.npy"))
    jds = jax_svt.Dataset.load(d, storage="host", mmap=True)
    jds.quantize(qtype="int4", refine=True, checkpoint=ck2)  # the JAX build resumes the port's
    assert os.path.getmtime(os.path.join(ck2, "refine8.npy")) == mtime
    assert_same_state(ds, jds)
