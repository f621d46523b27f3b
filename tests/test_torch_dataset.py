"""PyTorch port parity for the Dataset slices: create -> add -> exact search
-> quantize (int8 or int4, with the refine sidecar) -> quantized and refine
search, against the JAX VectorStore on the same rows (both on the CPU),
plus the port's own contracts: no jax import, no silent CPU fallback, and a
clear error for everything not yet ported."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import sqlite_vector_tpu as jax_svt
import sqlite_vector_tpu_torch as svt
from sqlite_vector_tpu_torch.interop import dataset_from_state
from tests.parity import REL_TOL_BY_TYPE, assert_topk_parity
from tests.test_torch_quantize4 import assert_int4_values_close

METRICS = ["L2", "SQUARED_L2", "COSINE", "DOT", "L1"]


def both(options, batches):
    """The same rows, added batch by batch, in a JAX and a port dataset."""
    jds = jax_svt.VectorStore().create("docs", options)
    pds = svt.VectorStore(device="cpu").create("docs", options)
    for rows in batches:
        np.testing.assert_array_equal(pds.add(rows), jds.add(rows))
    return jds, pds


def assert_same_neighbors(jds, pds, q, k, vtype="FLOAT32"):
    """Port ids tie-aware against the JAX dataset's own distances."""
    oracle = np.asarray(jds.distances(q), np.float64)
    pid, pd = pds.search(q, k)
    jid, jd = jds.search(q, k)
    assert pid.shape == jid.shape == (q.shape[0], k) and pid.dtype == np.int64
    for i in range(q.shape[0]):
        assert_topk_parity(
            jds.ids, oracle[i], pid[i], pd[i], k,
            rel_tol=REL_TOL_BY_TYPE[vtype], label=f"port q{i}",
        )
    np.testing.assert_allclose(pd, jd, rtol=REL_TOL_BY_TYPE[vtype], atol=1e-5)
    return pid, pd


@pytest.mark.parametrize("metric", METRICS)
def test_exact_and_quantized_slice_match_jax(metric):
    rng = np.random.default_rng(METRICS.index(metric))
    base = rng.standard_normal((1500, 48)).astype(np.float32)
    # two batches: the second crosses the 1024-row capacity (doubling)
    jds, pds = both(f"dimension=48,type=FLOAT32,distance={metric}", [base[:1000], base[1000:]])
    assert len(pds) == len(jds) == 1500
    assert pds._vectors.shape[0] == 2048
    q = np.concatenate([base[[3, 1200]], rng.standard_normal((2, 48)).astype(np.float32)])
    pid, pd = assert_same_neighbors(jds, pds, q, 10)
    if metric in ("L2", "SQUARED_L2"):
        assert pid[0, 0] == 4 and pd[0, 0] == 0.0  # self-match first at 0
    # single-vector query: [k] results
    sid, sd = pds.search(q[1], 10)
    np.testing.assert_array_equal(sid, pid[1])

    assert pds.quantize() == jds.quantize() == 1500
    (jq, js, jo), (pq, ps, po) = jds.quant_params, pds.quant_params
    assert (pq.value, ps, po) == (jq.value, js, jo)
    np.testing.assert_array_equal(
        pds._quant.codes.numpy(), np.asarray(jds._quant.codes)[:1500]
    )
    # integer-domain distances: identical ids and values
    jid, jd = jds.search(q, 10, exact=False)
    qid, qd = pds.search(q, 10, exact=False)
    np.testing.assert_array_equal(qid, jid)
    np.testing.assert_array_equal(qd, jd)


@pytest.mark.parametrize("vtype", ["UINT8", "INT8", "FLOAT16", "FLOATB16"])
def test_exact_search_other_dtypes_match_jax(vtype):
    rng = np.random.default_rng(5)
    if vtype in ("UINT8", "INT8"):
        lo, hi = (0, 256) if vtype == "UINT8" else (-128, 128)
        base = rng.integers(lo, hi, (700, 40)).astype(np.float32)
    else:
        base = rng.standard_normal((700, 40)).astype(np.float32)
    jds, pds = both(f"dimension=40,type={vtype},distance=L2", [base])
    q = base[[0, 350, 699]]
    pid, pd = assert_same_neighbors(jds, pds, q, 7, vtype)
    assert pd[0, 0] == 0.0
    np.testing.assert_array_equal(
        np.asarray(pds.get(pds.ids[[0, 350]]), np.float32),
        np.asarray(jds.get(jds.ids[[0, 350]]), np.float32),
    )


def test_normalized_cosine_fast_path_matches_jax():
    rng = np.random.default_rng(6)
    base = rng.standard_normal((600, 32)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    base[10] = 0.0  # zero-norm row scores exactly 1.0
    jds, pds = both("dimension=32,distance=COSINE,normalized=1", [base])
    q = np.concatenate([base[[4, 10]], rng.standard_normal((1, 32)).astype(np.float32)])
    assert pds._cosine_dot_fast(q)
    pid, pd = assert_same_neighbors(jds, pds, q, 5)
    assert pid[0, 0] == 5 and pd[0, 0] == 0.0
    assert (pd[1] == 1.0).all()


def test_quantized_state_through_interop_matches_jax():
    """dataset_from_state: the port searches the JAX dataset's own rows and
    int8 codes; uint8 here (non-negative data -> AUTO resolves to UINT8)."""
    rng = np.random.default_rng(8)
    base = rng.random((900, 24)).astype(np.float32) * 5
    jds = jax_svt.VectorStore().create("docs", "dimension=24,distance=COSINE")
    jds.add(base, ids=np.arange(100, 1000))
    jds.quantize()
    quant, count = jds._quant, len(jds)
    pds = dataset_from_state(
        {
            "vectors": np.asarray(jds._vectors)[:count],
            "ids": jds.ids,
            "codes": np.asarray(quant.codes)[:count],
            "qtype": quant.qtype.value,
            "scale": quant.scale,
            "offset": quant.offset,
        },
        "dimension=24,distance=COSINE",
        device="cpu",
    )
    assert pds.quant_params[0] is svt.QuantType.U8
    q = base[[1, 2, 3]] + 0.01
    np.testing.assert_array_equal(pds.search(q, 6, exact=False)[0], jds.search(q, 6, exact=False)[0])
    np.testing.assert_array_equal(pds.search(q, 6, exact=False)[1], jds.search(q, 6, exact=False)[1])
    assert_same_neighbors(jds, pds, q, 6)


def test_stale_codes_keep_their_snapshot_ids():
    rng = np.random.default_rng(9)
    base = rng.standard_normal((300, 16)).astype(np.float32)
    jds, pds = both("dimension=16", [base])
    jds.quantize()
    pds.quantize()
    extra = base[:5] * 1.0001
    jds.add(extra)
    pds.add(extra)
    assert pds.quant_stale and jds.quant_stale
    q = base[:2]
    np.testing.assert_array_equal(pds.search(q, 8, exact=False)[0], jds.search(q, 8, exact=False)[0])
    assert_same_neighbors(jds, pds, q, 8)  # exact sees the appended rows


def test_edge_results_and_errors_match_jax():
    rng = np.random.default_rng(10)
    base = rng.standard_normal((6, 8)).astype(np.float32)
    jds, pds = both("dimension=8", [base])
    for k in (0, 10):  # k=0, and k > count: -1 / +inf padding
        pid, pd = pds.search(base[:2], k)
        jid, jd = jds.search(base[:2], k)
        np.testing.assert_array_equal(pid, jid)
        np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-5)
    assert pds.search(base[0], 10)[0].shape == (6,)  # single query: trimmed
    with pytest.raises(svt.VectorCodecError):
        pds.search(np.zeros(7, np.float32), 3)
    with pytest.raises(svt.VectorStateError):
        pds.search(base[0], 3, exact=False)
    with pytest.raises(svt.VectorConfigError):
        pds.add(base[:2], ids=[1, 99])  # id 1 exists
    with pytest.raises(svt.VectorConfigError):
        pds.search(base[0], -1)
    with pytest.raises(svt.VectorStateError):
        pds.get([12345])
    store = svt.VectorStore(device="cpu")
    store.create("A", "dimension=8")
    assert "a" in store and store.names() == ["A"]
    with pytest.raises(svt.VectorConfigError):
        store.create("a", "dimension=9")
    store.drop("A")
    assert "a" not in store
    with pytest.raises(svt.VectorStateError):
        store.get("A")


def test_unported_paths_raise_config_error():
    base = np.random.default_rng(11).standard_normal((20, 8)).astype(np.float32)
    # storage="host", quantize(checkpoint=) and meshes are ported
    # (tests/test_torch_persistence.py, tests/test_torch_streaming.py,
    # tests/test_torch_sharded.py); mesh= takes a parallel.Mesh, and any
    # other object raises a VectorConfigError that names what it takes
    with pytest.raises(svt.VectorConfigError, match="mesh= takes a sqlite_vector_tpu_torch.parallel.Mesh"):
        svt.VectorStore(device="cpu", mesh=object())
    with pytest.raises(svt.VectorConfigError, match="mesh= takes a sqlite_vector_tpu_torch.parallel.Mesh"):
        svt.Dataset("h", svt.parse_options("dimension=8"), device="cpu", storage="host", mesh=object())
    # the non-finite policy paths are ported (tests/test_torch_nonfinite.py):
    # they answer as the JAX package does instead of raising
    bad = base.copy()
    bad[3, 2] = np.nan
    jhalf, half = both("dimension=8,type=FLOAT16", [bad])
    want = jhalf.search(base[0], 3)
    np.testing.assert_array_equal(half.search(base[0], 3)[0], want[0])
    for qtype, refine, mode in (("int4", True, "refine"), ("int8", False, "approx"), ("int8", False, "rerank")):
        half.quantize(qtype=qtype, refine=refine)
        np.testing.assert_array_equal(half.search(base[0], 3, mode=mode)[0], want[0])  # as exact
    # exact distances of f32 L2 over a row holding Inf: +Inf, as in JAX
    inf_rows = base.copy()
    inf_rows[2, 1] = np.inf
    jf32, f32 = both("dimension=8,distance=L2", [inf_rows])
    got = f32.distances(base[0])
    assert np.isposinf(got[2])
    np.testing.assert_allclose(got, np.asarray(jf32.distances(base[0])), rtol=1e-5)


def test_default_device_refuses_missing_gpu(monkeypatch):
    """device=None means CUDA; with no GPU it raises instead of running on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(svt.VectorConfigError, match="CUDA"):
        svt.VectorStore()
    with pytest.raises(svt.VectorConfigError, match="CUDA"):
        svt.Dataset("d", svt.parse_options("dimension=4"))
    assert svt.backend() == "cpu/torch"


def test_package_imports_without_jax(tmp_path):
    """Every module imports without jax, and persistence, host-storage
    streaming, the non-finite policies, the SQL surface (its virtual
    tables and the native loader), serving and the CLI run without it."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import sqlite_vector_tpu_torch, sqlite_vector_tpu_torch.interop\n"
        "import sqlite_vector_tpu_torch.ops.block_scan, sqlite_vector_tpu_torch.ops._build\n"
        "import sqlite_vector_tpu_torch.ops.quantize4, sqlite_vector_tpu_torch.ops.int4_scan\n"
        "import sqlite_vector_tpu_torch.ops.refine, sqlite_vector_tpu_torch.ops.streaming\n"
        "import sqlite_vector_tpu_torch.hostarray, sqlite_vector_tpu_torch.ops.nonfinite\n"
        "import sqlite_vector_tpu_torch.sqlite, sqlite_vector_tpu_torch.serving\n"
        "import sqlite_vector_tpu_torch.cli, sqlite_vector_tpu_torch.native\n"
        "import sqlite_vector_tpu_torch.tools.recall, sqlite_vector_tpu_torch.models.embedders\n"
        "from sqlite_vector_tpu_torch.dataset import Dataset\n"
        "d = sys.argv[1]\n"
        "rows = np.eye(6, dtype=np.float32)\n"
        "Dataset.from_arrays('x', rows, device='cpu').save(d + '/a', shard_rows=4)\n"
        "back = Dataset.load(d + '/a', device='cpu', storage='host', mmap=True)\n"
        "assert back.search(rows[4], 1)[0][0] == 5\n"
        "assert back.quantize(checkpoint=d + '/ck') == 6\n"
        "half = rows.astype(np.float16)\n"
        "half[2, 3] = np.nan\n"
        "h = Dataset.from_arrays('h', half, options='type=FLOAT16', device='cpu')\n"
        "assert h.search(rows[2], 1)[0][0] == 3\n"
        "back.to_sqlite(d + '/x.db', 'docs', 'v')\n"
        "c = sqlite_vector_tpu_torch.sqlite.connect(d + '/x.db', device='cpu')\n"
        "c.vector_init('docs', 'v', 'dimension=6,type=FLOAT32')\n"
        "sql = \"SELECT id FROM vector_quantize_scan('docs', 'v', ?, 1)\" if c.vtab_loaded else None\n"
        "assert sql is None or c.execute(sql, (rows[1].tobytes(),)).fetchone()[0] == 2\n"
        "s = sqlite_vector_tpu_torch.BatchingSearcher(back)\n"
        "assert s.search(rows[3], 1)[0][0] == 4\n"
        "s.close()\n"
        "assert sqlite_vector_tpu_torch.cli.main(['--cpu', 'ds-info', d + '/a']) == 0\n"
        "sqlite_vector_tpu_torch.models.embedders.HashEmbedder().encode(['text'])\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'sqlite_vector_tpu']\n"
    )
    subprocess.run([sys.executable, "-c", code, str(tmp_path)], check=True, timeout=120)


def int4_state(jds):
    """The JAX dataset's int4 quantization (and refine sidecar) as the
    arrays interop.dataset_from_state takes."""
    quant, count = jds._quant, len(jds)
    state = {
        "vectors": np.asarray(jds._vectors)[:count],
        "ids": jds.ids,
        "packed": np.asarray(quant.codes)[:count],
        "alpha": np.asarray(quant.row_scale)[:count],
        "csq": np.asarray(quant.sq_norms)[:count],
    }
    if quant.codes8 is not None:
        state.update(
            codes8=np.asarray(quant.codes8)[:count], qtype8=quant.qtype8.value,
            scale8=quant.scale8, offset8=quant.offset8,
        )
    return state


@pytest.mark.parametrize("dim", [33, 48])
def test_int4_quantize_builds_the_jax_state(dim):
    """quantize(qtype="int4", refine=True): packed codes, alpha, csq and the
    int8 sidecar with its AUTO params, bit-equal to the JAX dataset's."""
    rng = np.random.default_rng(dim)
    base = rng.standard_normal((1100, dim)).astype(np.float32)
    base[7] = 0.0
    jds, pds = both(f"dimension={dim},distance=L2", [base[:600], base[600:]])
    assert pds.quantize(qtype="int4", refine=True) == jds.quantize(qtype="int4", refine=True)
    (jq, js, jo), (pq, ps, po) = jds.quant_params, pds.quant_params
    assert (pq.value, ps, po) == (jq.value, js, jo) == ("INT4", 1.0, 0.0)
    want, got = int4_state(jds), pds._quant
    for name, tensor in (("packed", got.codes), ("alpha", got.row_scale), ("csq", got.sq_norms),
                         ("codes8", got.codes8)):
        np.testing.assert_array_equal(tensor.numpy(), want[name], err_msg=name)
    assert (got.qtype8.value, got.scale8, got.offset8) == (want["qtype8"], want["scale8"], want["offset8"])
    assert pds.memory_bytes() == pds._vectors.numel() * 4 + got.codes.numel()


@pytest.mark.parametrize("metric", METRICS)
def test_int4_and_refine_search_through_interop_match_jax(metric):
    """The port searches the JAX dataset's own int4 codes and sidecar:
    mode="quantized" and mode="refine" give the JAX ids up to ties and its
    values within the stated int4 tolerances (assert_int4_values_close;
    refine's float32 rescore sums within rtol 1e-5)."""
    rng = np.random.default_rng(30 + METRICS.index(metric))
    base = rng.standard_normal((800, 40)).astype(np.float32)
    opts = f"dimension=40,distance={metric}"
    jds = jax_svt.VectorStore().create("docs", opts)
    jds.add(base, ids=np.arange(5, 805))
    jds.quantize(qtype="int4", refine=True)
    pds = dataset_from_state(int4_state(jds), opts, device="cpu")
    assert pds.quant_params[0] is svt.QuantType.I4
    q = np.concatenate([base[[4, 500]], rng.standard_normal((2, 40)).astype(np.float32)])
    for mode in ("quantized", "refine"):
        jid, jd = jds.search(q, 8, mode=mode)
        pid, pd = pds.search(q, 8, mode=mode)
        assert pid.shape == jid.shape == (4, 8)
        if mode == "quantized":
            assert_int4_values_close(pd, jd, q, metric)
        else:
            np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-5)
        swapped = pid != jid
        np.testing.assert_allclose(pd[swapped], jd[swapped], rtol=1e-5, atol=1e-5)
        assert pid[0, 0] == jid[0, 0] == 9  # the self-match
    # single-vector queries and expand
    np.testing.assert_array_equal(pds.search(q[1], 8, mode="refine")[0], pds.search(q, 8, mode="refine")[0][1])
    np.testing.assert_array_equal(
        pds.search(q, 5, mode="refine", expand=2)[0], jds.search(q, 5, mode="refine", expand=2)[0]
    )


def test_int4_codes_go_stale_with_their_snapshot_ids():
    rng = np.random.default_rng(40)
    base = rng.standard_normal((300, 16)).astype(np.float32)
    jds, pds = both("dimension=16", [base])
    jds.quantize(qtype="int4", refine=True)
    pds.quantize(qtype="int4", refine=True)
    jds.add(base[:5] * 1.0001)
    pds.add(base[:5] * 1.0001)
    assert pds.quant_stale and jds.quant_stale
    for mode in ("quantized", "refine"):
        np.testing.assert_array_equal(pds.search(base[:2], 6, mode=mode)[0], jds.search(base[:2], 6, mode=mode)[0])


def test_int4_and_refine_errors_match_jax():
    base = np.random.default_rng(41).standard_normal((50, 8)).astype(np.float32)
    jds, pds = both("dimension=8", [base])
    msgs = []
    for ds in (jds, pds):
        with pytest.raises(jax_svt.VectorStateError if ds is jds else svt.VectorStateError) as e1:
            ds.search(base[0], 3, mode="refine")  # nothing quantized
        ds.quantize(qtype="int4")
        with pytest.raises(jax_svt.VectorStateError if ds is jds else svt.VectorStateError) as e2:
            ds.search(base[0], 3, mode="refine")  # no sidecar
        ds.quantize(qtype="int8")
        with pytest.raises(jax_svt.VectorStateError if ds is jds else svt.VectorStateError) as e3:
            ds.search(base[0], 3, mode="refine")  # int8, not int4
        with pytest.raises(jax_svt.VectorConfigError if ds is jds else svt.VectorConfigError) as e4:
            ds.quantize(qtype="int8", refine=True)
        msgs.append([str(e.value) for e in (e1, e2, e3, e4)])
    assert msgs[0] == msgs[1]
    assert "refine" in msgs[1][0] and "int4" in msgs[1][3]
    # zero rows: an int4 quantize records its params, as in JAX
    empty_j = jax_svt.VectorStore().create("e", "dimension=8")
    empty_p = svt.VectorStore(device="cpu").create("e", "dimension=8")
    assert empty_p.quantize(qtype="int4") == empty_j.quantize(qtype="int4") == 0
    assert empty_p.quant_params[0].value == empty_j.quant_params[0].value == "INT4"
