"""The port's SQL surface (sqlite_vector_tpu_torch/sqlite.py) against the
JAX package's, on the CPU: the same SQL on two copies of one database,
one opened by sqlite_vector_tpu.sqlite and one by the port (device="cpu").

Contracts held:
  - scans: ids equal (tie-aware where floats may differ in the last
    ulps), float values within rtol 1e-5 (REL_TOL_BY_TYPE for 16-bit
    rows), int8-domain values bit-equal, int4 values within the qscale ulp
    of tests/test_torch_quantize4.py:assert_int4_values_close;
  - vector_quantize writes byte-identical shadow tables and
    `_sqliteai_vector` rows (u8, i8 and the packed int4 records);
  - each package scans the other's quantized file with equal results;
  - transactions, SAVEPOINTs, ROLLBACK, the incremental refresh and the
    error messages behave as in the JAX package.
"""

import json
import os
import shutil
import sqlite3
import sys

import numpy as np
import pytest
import torch

import sqlite_vector_tpu as jax_svt
import sqlite_vector_tpu.sqlite as jsql
import sqlite_vector_tpu_torch as svt
import sqlite_vector_tpu_torch.sqlite as psql
from sqlite_vector_tpu_torch import native
from tests.parity import REL_TOL_BY_TYPE
from tests.test_torch_quantize4 import assert_int4_values_close

DIM = 32
N = 300


def make_db(path, rows, table="docs", column="v", extra=""):
    c = sqlite3.connect(path)
    c.execute(f"CREATE TABLE {table} (id INTEGER PRIMARY KEY, {column} BLOB{extra})")
    c.executemany(f"INSERT INTO {table}({column}) VALUES (?)", ((r.tobytes(),) for r in rows))
    c.commit()
    c.close()


@pytest.fixture
def data(rng):
    return rng.standard_normal((N, DIM)).astype(np.float32)


@pytest.fixture
def twin(tmp_path, data):
    """(port connection, JAX connection) on two copies of one database,
    vector_init done on both."""
    make_db(str(tmp_path / "p.db"), data)
    shutil.copy(tmp_path / "p.db", tmp_path / "j.db")
    p = psql.connect(str(tmp_path / "p.db"), device="cpu")
    j = jsql.connect(str(tmp_path / "j.db"))
    for c in (p, j):
        c.execute(f"SELECT vector_init('docs', 'v', 'type=FLOAT32,dimension={DIM},distance=L2')")
    yield p, j
    p.close()
    j.close()


def both(twin, sql, args=()):
    return [c.execute(sql, args).fetchall() for c in twin]


def assert_rows_close(got, want, rtol=1e-5):
    assert [r[0] for r in got] == [r[0] for r in want]
    # atol: the near-zero snap threshold (8 float32 eps)
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want], rtol=rtol, atol=1e-6)


def shadow_and_meta(conn):
    shadow = conn.execute(
        "SELECT name FROM sqlite_master WHERE name LIKE 'vector0%' ORDER BY name"
    ).fetchall()
    rows = [conn.execute(f'SELECT * FROM "{n}" ORDER BY rowid1').fetchall() for (n,) in shadow]
    meta = conn.execute("SELECT * FROM _sqliteai_vector ORDER BY tblname, colname, key").fetchall()
    return shadow, rows, meta


# -- scalar functions, init ------------------------------------------------------


def test_scalar_functions_match_jax(twin):
    for sql, args in (
        ("SELECT vector_as_f32('[1, 2.5, -3]')", ()),
        ("SELECT vector_as_u8('[0, 255]', 2)", ()),
        ("SELECT vector_as_i8('[-128, 127, 3]')", ()),
        ("SELECT vector_as_f16('[0.1, 65504, -2]')", ()),
        ("SELECT vector_as_bf16('[0.1, 3.0e38, -2]')", ()),
        ("SELECT vector_as_f32(?)", (np.arange(4, dtype=np.float32).tobytes(),)),
        ("SELECT vector_version()", ()),
    ):
        got, want = both(twin, sql, args)
        assert got == want, sql
    assert twin[0].execute("SELECT vector_backend()").fetchone()[0] == "cpu/torch" or torch.cuda.is_available()
    for bad in ("SELECT vector_as_u8('[300]')", "SELECT vector_as_f32(x'000000')", "SELECT vector_as_f32()"):
        msgs = []
        for c in twin:
            with pytest.raises(sqlite3.OperationalError) as e:
                c.execute(bad).fetchone()
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], bad


def test_init_errors_match_jax(twin):
    for table, column, opts in (
        ("missing", "v", f"type=FLOAT32,dimension={DIM}"),
        ("docs", "nope", f"type=FLOAT32,dimension={DIM}"),
        ("docs", "v", "type=FLOAT32"),
        ("docs", "v", f"type=FLOAT32,dimension={DIM + 1}"),
        ("docs", "v", f"type=FLOAT16,dimension={DIM}"),
    ):
        msgs = []
        for c, err in zip(twin, (svt.VectorConfigError, jax_svt.VectorConfigError)):
            with pytest.raises(err) as e:
                c.vector_init(table, column, opts)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for c, err in zip(twin, (svt.VectorStateError, jax_svt.VectorStateError)):
        with pytest.raises(err, match="was not initialized"):
            c.vector_full_scan("other", "v", b"", 3)
        with pytest.raises(err, match="quantization table not found"):
            c.vector_quantize_scan("docs", "v", np.zeros(DIM, np.float32).tobytes(), 3)


def test_connect_defaults_to_the_card_and_refuses_meshes(tmp_path, monkeypatch):
    with pytest.raises(svt.VectorConfigError, match="mesh= takes a sqlite_vector_tpu_torch.parallel.Mesh"):
        psql.connect(":memory:", device="cpu", mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(svt.VectorConfigError, match="CUDA"):
        psql.connect(str(tmp_path / "x.db"))
    assert psql.connect(":memory:", device="cpu").device == torch.device("cpu")


# -- scans ------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["L2", "SQUARED_L2", "COSINE", "DOT", "L1"])
@pytest.mark.parametrize("vtype", ["FLOAT32", "FLOAT16", "FLOATB16", "INT8"])
def test_vtab_scans_match_jax(metric, vtype, tmp_path, rng):
    """The reference's SQL verbatim through both packages' virtual tables:
    vector_full_scan, then vector_quantize and vector_quantize_scan, and
    both stream modules."""
    if vtype == "INT8":
        rows = rng.integers(-128, 128, (N, DIM)).astype(np.int8)
    else:
        rows = rng.standard_normal((N, DIM)).astype(jax_svt.VectorType(vtype).np_dtype)
    make_db(str(tmp_path / "p.db"), rows)
    shutil.copy(tmp_path / "p.db", tmp_path / "j.db")
    conns = (psql.connect(str(tmp_path / "p.db"), device="cpu"), jsql.connect(str(tmp_path / "j.db")))
    assert conns[0].vtab_loaded and conns[1].vtab_loaded
    rtol = max(REL_TOL_BY_TYPE[vtype], 1e-5)
    for c in conns:
        c.execute(f"SELECT vector_init('docs', 'v', 'type={vtype},dimension={DIM},distance={metric}')")
    q = rows[11].tobytes()
    got, want = both(conns, "SELECT id, distance FROM vector_full_scan('docs', 'v', ?, 10)", (q,))
    assert len(got) == 10 and [r[1] for r in got] == sorted(r[1] for r in got)
    assert_rows_close(got, want, rtol)
    got, want = both(conns, "SELECT id, distance FROM vector_full_scan_stream('docs', 'v', ?)", (q,))
    assert len(got) == N
    assert_rows_close(got, want, rtol)
    for c in conns:
        c.execute("SELECT vector_quantize('docs', 'v')").fetchall()
    assert shadow_and_meta(conns[0]) == shadow_and_meta(conns[1])
    got, want = both(conns, "SELECT id, distance FROM vector_quantize_scan('docs', 'v', ?, 10)", (q,))
    if metric == "COSINE":
        # the integer-domain COSINE snap: the port's block-minima route
        # snaps a near-zero distance to 0, the JAX plain scan does not
        # (ROADMAP.md queue 3, inherited)
        assert_rows_close(got, want, 0.0)
    else:
        assert got == want
    got, want = both(conns, "SELECT id, distance FROM vector_quantize_scan_stream('docs', 'v', ?)", (q,))
    assert got == want
    for c in conns:
        c.close()


def test_python_api_scans_and_json_shims_match_jax(twin, data):
    p, j = twin
    q = data[17]
    for query in (q.tobytes(), json.dumps([float(x) for x in q]), q):
        assert_rows_close(p.vector_full_scan("docs", "v", query, 10), j.vector_full_scan("docs", "v", query, 10))
    assert p.vector_full_scan("docs", "v", q.tobytes(), 0) == [] == j.vector_full_scan("docs", "v", q.tobytes(), 0)
    assert len(p.vector_full_scan("docs", "v", q.tobytes(), N + 50)) == N
    sql = ("SELECT e.value ->> 'id', e.value ->> 'distance' "
           "FROM json_each(vector_full_scan_json('docs', 'v', ?, 5)) AS e")
    got, want = both(twin, sql, (q.tobytes(),))
    assert_rows_close(got, want)
    for c in twin:
        c.vector_quantize("docs", "v")
    sql = sql.replace("vector_full_scan_json", "vector_quantize_scan_json")
    got, want = both(twin, sql, (q.tobytes(),))
    assert got == want
    assert p.vector_quantize_memory("docs", "v") == j.vector_quantize_memory("docs", "v") == N * (8 + DIM)
    for c, err in zip(twin, (svt.VectorCodecError, jax_svt.VectorCodecError)):
        with pytest.raises(err, match="dimension"):
            c.vector_full_scan("docs", "v", np.zeros(DIM + 1, np.float32), 3)


# -- quantize: byte-identical files, cross-package reads ---------------------------


@pytest.mark.parametrize("qopts", [None, "qtype=UINT8", "qtype=INT8", "max_memory=3000", "max_memory=banana"])
def test_quantize_writes_byte_identical_shadow(twin, qopts):
    for c in twin:
        assert c.vector_quantize("docs", "v", qopts) == N
    assert shadow_and_meta(twin[0]) == shadow_and_meta(twin[1])


def test_int4_shadow_records_and_scans_match_jax(twin, data):
    """qtype=INT4: the packed records [rowid][alpha][csq][codes] under
    vector0i4_*, byte-identical; scans within the qscale ulp."""
    for c in twin:
        assert c.execute("SELECT vector_quantize('docs', 'v', 'qtype=INT4')").fetchone()[0] == N
    assert shadow_and_meta(twin[0]) == shadow_and_meta(twin[1])
    assert shadow_and_meta(twin[0])[0] == [("vector0i4_docs_v",)]
    q = data[42:43]
    got, want = (c.vector_quantize_scan("docs", "v", q[0].tobytes(), 5) for c in twin)
    assert [r[0] for r in got] == [r[0] for r in want]
    assert_int4_values_close([[r[1] for r in got]], [[r[1] for r in want]], q, "L2")
    got, want = (list(c.vector_quantize_scan_stream("docs", "v", q[0].tobytes())) for c in twin)
    assert [r[0] for r in got] == [r[0] for r in want]
    assert_int4_values_close([[r[1] for r in got]], [[r[1] for r in want]], q, "L2")
    # int4 <-> int8 churn leaves one generation, named after the qtype
    for c in twin:
        c.vector_quantize("docs", "v", "qtype=INT8")
    assert shadow_and_meta(twin[0]) == shadow_and_meta(twin[1])
    assert shadow_and_meta(twin[0])[0] == [("vector0_docs_v",)]


@pytest.mark.parametrize("qtype", ["INT8", "UINT8", "INT4"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cross_package_quantized_files(qtype, writer, tmp_path, rng):
    """One package quantizes, a fresh connection of the other scans the
    shadow table (and a fresh one of the writer): equal results."""
    rows = rng.standard_normal((N, DIM)).astype(np.float32)
    if qtype == "UINT8":
        rows = np.abs(rows)
    path = str(tmp_path / "x.db")
    make_db(path, rows)
    opts = f"type=FLOAT32,dimension={DIM},distance=L2"
    mods = {"port": lambda: psql.connect(path, device="cpu"), "jax": lambda: jsql.connect(path)}
    w = mods[writer]()
    w.vector_init("docs", "v", opts)
    w.vector_quantize("docs", "v", f"qtype={qtype}")
    own = w.vector_quantize_scan("docs", "v", rows[7].tobytes(), 5)
    own_stream = list(w.vector_quantize_scan_stream("docs", "v", rows[7].tobytes()))
    w.close()
    results = {}
    for reader in ("port", "jax"):
        r = mods[reader]()
        r.vector_init("docs", "v", opts)
        r.vector_quantize_preload("docs", "v")
        results[reader] = (
            r.vector_quantize_scan("docs", "v", rows[7].tobytes(), 5),
            list(r.vector_quantize_scan_stream("docs", "v", rows[7].tobytes())),
        )
        assert r._contexts[("docs", "v")].quant.count == N
        r.close()
    for scan, stream in results.values():
        assert [x[0] for x in scan] == [x[0] for x in own] and scan[0][0] == 8
        assert [x[0] for x in stream] == [x[0] for x in own_stream]
        if qtype == "INT4":
            q = rows[7:8]
            assert_int4_values_close([[x[1] for x in scan]], [[x[1] for x in own]], q, "L2")
            assert_int4_values_close([[x[1] for x in stream]], [[x[1] for x in own_stream]], q, "L2")
        else:
            assert scan == own and stream == own_stream
    # the port's codes from a shadow table stay at their row count
    r = psql.connect(path, device="cpu")
    r.vector_init("docs", "v", opts)
    r.vector_quantize_preload("docs", "v")
    assert r._contexts[("docs", "v")].quant.codes.shape[0] == N
    r.close()


def test_cross_connection_scan_bit_equal_own_connection(tmp_path, data):
    """A second port connection reads the shadow table and scans it with
    the Dataset's own calls: the same values bit for bit, int8 and int4."""
    path = str(tmp_path / "c.db")
    make_db(path, data)
    a = psql.connect(path, device="cpu")
    a.vector_init("docs", "v", f"type=FLOAT32,dimension={DIM},distance=COSINE")
    for qtype in ("INT8", "INT4"):
        a.vector_quantize("docs", "v", f"qtype={qtype}")
        b = psql.connect(path, device="cpu")
        b.vector_init("docs", "v", f"type=FLOAT32,dimension={DIM},distance=COSINE")
        q = data[:4]
        for i in range(4):
            assert a.vector_quantize_scan("docs", "v", q[i], 20) == b.vector_quantize_scan("docs", "v", q[i], 20)
        assert list(a.vector_quantize_scan_stream("docs", "v", q[0])) == list(
            b.vector_quantize_scan_stream("docs", "v", q[0]))
        assert not b._own_codes(b._contexts[("docs", "v")], b._contexts[("docs", "v")].quant)
        b.close()
    a.close()


def test_int4_zero_rows_round_trips(tmp_path):
    path = str(tmp_path / "p0.db")
    c1 = psql.connect(path, device="cpu")
    c1.execute("CREATE TABLE t (v BLOB)")
    c1.commit()
    c1.vector_init("t", "v", f"type=FLOAT32,dimension={DIM}")
    c1.vector_quantize("t", "v", "qtype=INT4")
    names = {r[0] for r in c1.execute("SELECT name FROM sqlite_master WHERE name LIKE 'vector0%'")}
    assert names == {"vector0i4_t_v"}
    c1.close()
    c2 = jsql.connect(path)
    c2.vector_init("t", "v", f"type=FLOAT32,dimension={DIM}")
    assert c2.vector_quantize_scan("t", "v", np.zeros(DIM, np.float32).tobytes(), 5) == []
    c2.close()


def test_int4_params_with_legacy_shadow_mismatch_errors(tmp_path, data):
    path = str(tmp_path / "mm.db")
    make_db(path, data)
    c1 = psql.connect(path, device="cpu")
    c1.vector_init("docs", "v", f"type=FLOAT32,dimension={DIM}")
    c1.vector_quantize("docs", "v", "qtype=INT4")
    c1.execute("ALTER TABLE vector0i4_docs_v RENAME TO vector0_docs_v")
    c1.commit()
    c1.close()
    for mod, err in ((psql, svt.VectorStateError), (jsql, jax_svt.VectorStateError)):
        c2 = mod.connect(path, device="cpu") if mod is psql else mod.connect(path)
        c2.vector_init("docs", "v", f"type=FLOAT32,dimension={DIM}")
        with pytest.raises(err, match="does not match"):
            c2.vector_quantize_scan("docs", "v", data[0].tobytes(), 5)
        c2.close()


# -- transactions, SAVEPOINTs, refresh ---------------------------------------------


def test_quantize_inside_a_callers_transaction_matches_jax(twin, data):
    """vector_quantize under a caller's open transaction: the transaction
    stays open, a ROLLBACK reverts the shadow table and the next quantized
    scan errors as the reference does; a standalone quantize commits."""
    outcomes = []
    for c in twin:
        c.execute("CREATE TABLE unrelated (x INTEGER)")
        c.commit()
        c.execute("INSERT INTO unrelated(x) VALUES (1)")
        assert c.vector_quantize("docs", "v") == N
        inside = c.vector_quantize_scan("docs", "v", data[1].tobytes(), 3)
        still_open = c.in_transaction
        c.rollback()
        with pytest.raises(Exception, match="vector_quantize") as e:
            c.vector_quantize_scan("docs", "v", data[1].tobytes(), 3)
        after = (c.execute("SELECT COUNT(*) FROM unrelated").fetchone()[0], type(e.value).__name__, str(e.value))
        c.vector_quantize("docs", "v")
        outcomes.append((inside, still_open, after, c.in_transaction,
                         c.vector_quantize_scan("docs", "v", data[1].tobytes(), 3)))
        c.execute("INSERT INTO unrelated(x) VALUES (2)")
        c.vector_quantize_cleanup("docs", "v")
        assert c.in_transaction
        c.rollback()
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][1] is True and outcomes[0][3] is False and outcomes[0][0][0][0] == 2


def test_rollback_discards_provisional_quant_like_jax(tmp_path, data):
    results = []
    for mod in (psql, jsql):
        path = str(tmp_path / f"{mod.__name__}.db")
        make_db(path, data[:40])
        c = mod.connect(path, device="cpu") if mod is psql else mod.connect(path)
        c.vector_init("docs", "v", f"type=FLOAT32,dimension={DIM}")
        c.vector_quantize("docs", "v")
        v1 = c.vector_quantize_scan("docs", "v", data[0].tobytes(), 5)
        c.execute("BEGIN")
        c.executemany("INSERT INTO docs(v) VALUES (?)", ((r.tobytes(),) for r in data[40:]))
        assert c.vector_quantize("docs", "v") == N
        c.execute("ROLLBACK")
        after = c.vector_quantize_scan("docs", "v", data[0].tobytes(), 5)
        stream = list(c.vector_quantize_scan_stream("docs", "v", data[0].tobytes()))
        assert after == v1 and len(stream) == 40 and max(r[0] for r in stream) <= 40
        # a scan inside a transaction is not cached past its ROLLBACK
        probe = np.full(DIM, 7.25, np.float32)
        c.execute("INSERT INTO docs(v) VALUES (?)", (probe.tobytes(),))
        inside = c.vector_full_scan("docs", "v", probe.tobytes(), 1)
        c.rollback()
        outside = c.vector_full_scan("docs", "v", probe.tobytes(), 1)
        assert inside[0] == (41, 0.0) and outside[0][0] != 41
        results.append((v1, inside, outside[0][0]))
        c.close()
    assert results[0][0] == results[1][0] and results[0][1] == results[1][1]


def test_cross_connection_requantize_refreshes_cache(tmp_path, rng):
    """Connection A's cached codes follow a re-quantize by connection B of
    the other package, an AUTO flip I8 -> U8 included."""
    path = str(tmp_path / "xq.db")
    neg = rng.standard_normal((30, DIM)).astype(np.float32)
    make_db(path, neg)
    a = psql.connect(path, device="cpu")
    a.vector_init("docs", "v", f"type=FLOAT32,dimension={DIM}")
    a.vector_quantize("docs", "v")
    assert a.vector_quantize_scan("docs", "v", neg[3].tobytes(), 3)[0][0] == 4
    b = jsql.connect(path)
    pos = np.abs(neg) + 1.0
    b.execute("DELETE FROM docs")
    b.executemany("INSERT INTO docs(v) VALUES (?)", ((r.tobytes(),) for r in pos))
    b.commit()
    b.vector_init("docs", "v", f"type=FLOAT32,dimension={DIM}")
    b.vector_quantize("docs", "v")
    want = b.vector_quantize_scan("docs", "v", pos[5].tobytes(), 3)
    got = a.vector_quantize_scan("docs", "v", pos[5].tobytes(), 3)
    assert got == want and got[0][1] == 0.0
    assert a._contexts[("docs", "v")].quant.qtype is svt.QuantType.U8
    a.close()
    b.close()


def test_incremental_refresh_fast_paths(tmp_path, data, monkeypatch):
    """Appends load only the new rows; deletes tombstone in place with no
    load; updates, mixed batches and other connections' writes reload in
    full; a NULL-vector row above every pk does not fool the proof."""
    path = str(tmp_path / "inc.db")
    make_db(path, data)
    c = psql.connect(path, device="cpu")
    c.execute("INSERT INTO docs(v) VALUES (NULL)")
    c.commit()
    c.vector_init("docs", "v", f"type=FLOAT32,dimension={DIM}")
    assert c.vector_full_scan("docs", "v", data[0].tobytes(), 1)[0][0] == 1
    ctx = c._lookup("docs", "v", "test")
    calls = []
    orig = psql.VectorConnection._load_rows

    def spy(self, ctx, *, min_pk):
        ids, arr = orig(self, ctx, min_pk=min_pk)
        calls.append((min_pk, len(ids)))
        return ids, arr

    monkeypatch.setattr(psql.VectorConnection, "_load_rows", spy)
    extra = np.arange(DIM, dtype=np.float32)
    c.execute("INSERT INTO docs(v) VALUES (?)", (extra.tobytes(),))
    c.execute("INSERT INTO docs(v) VALUES (?)", ((extra + 1).tobytes(),))
    c.commit()
    assert c.vector_full_scan("docs", "v", extra.tobytes(), 1)[0] == (N + 2, 0.0)
    assert calls == [(N + 1, 2)]
    ds = ctx.dataset
    c.execute("DELETE FROM docs WHERE id IN (2, 5, 7)")
    c.commit()
    assert 2 not in [r[0] for r in c.vector_full_scan("docs", "v", data[1].tobytes(), 3)]
    assert calls == [(N + 1, 2)] and ctx.dataset is ds and len(ds) == N - 1
    c.execute("UPDATE docs SET v=? WHERE id=1", ((extra + 7).tobytes(),))
    c.commit()
    assert c.vector_full_scan("docs", "v", (extra + 7).tobytes(), 1)[0] == (1, 0.0)
    assert calls[-1][0] is None
    other = sqlite3.connect(path)
    other.execute("INSERT INTO docs(v) VALUES (?)", ((extra + 13).tobytes(),))
    other.commit()
    other.close()
    n_calls = len(calls)
    assert c.vector_full_scan("docs", "v", (extra + 13).tobytes(), 1)[0][1] == 0.0
    assert calls[n_calls][0] is None
    c.execute("DROP TABLE docs")
    c.commit()
    with pytest.raises((sqlite3.OperationalError, svt.VectorError)):
        c.vector_full_scan("docs", "v", data[0].tobytes(), 1)
    c.close()


def test_quantize_shadow_uses_quantize_time_ids(twin, data, monkeypatch):
    p, _ = twin
    ctx = p._lookup("docs", "v", "test")
    ds = p._refresh(ctx)
    real = ds.quantize

    def quantize_then_mutate(*a, **kw):
        n = real(*a, **kw)
        ds.remove(ds.ids[: N // 2])  # compacts: ds.ids shrink and reorder
        return n

    monkeypatch.setattr(ds, "quantize", quantize_then_mutate)
    assert p.vector_quantize("docs", "v") == N
    assert p.vector_quantize_scan("docs", "v", data[7].tobytes(), 1)[0][0] == 8
    assert len(list(p.vector_quantize_scan_stream("docs", "v", data[7].tobytes()))) == N


def test_cleanup_case_insensitive_and_without_rowid(tmp_path, data):
    c = psql.connect(str(tmp_path / "cc.db"), device="cpu")
    c.execute("CREATE TABLE Docs (V BLOB, note TEXT DEFAULT 'without rowid')")
    c.executemany("INSERT INTO Docs(V) VALUES (?)", ((r.tobytes(),) for r in data))
    c.execute("CREATE TABLE wr (pk INTEGER PRIMARY KEY, v BLOB) WITHOUT ROWID")
    c.executemany("INSERT INTO wr(pk, v) VALUES (?, ?)", ((i + 100, r.tobytes()) for i, r in enumerate(data[:50])))
    c.commit()
    c.vector_init("Docs", "V", f"type=FLOAT32,dimension={DIM}")
    c.vector_quantize("Docs", "V")
    c.vector_quantize_cleanup("docs", "v")
    assert c.execute("SELECT COUNT(*) FROM sqlite_master WHERE name LIKE 'vector0_%'").fetchone()[0] == 0
    c.vector_init("wr", "v", f"type=FLOAT32,dimension={DIM}")
    assert c.vector_full_scan("wr", "v", data[10].tobytes(), 3)[0] == (110, 0.0)
    c.close()


# -- loaders ---------------------------------------------------------------------------


def test_python_loader_fallback_and_memory_db(tmp_path, data, monkeypatch):
    """Without the native loader the Python row loop gives the same rows;
    oversized blobs read their first dim elements; short and empty blobs
    raise the same message from both loaders."""
    path = str(tmp_path / "fb.db")
    make_db(path, data)
    with sqlite3.connect(path) as raw:
        raw.execute("INSERT INTO docs(v) VALUES (?)", (data[0].tobytes() + b"\0\0\0\0",))
    native_rows = psql.connect(path, device="cpu")
    native_rows.vector_init("docs", "v", f"type=FLOAT32,dimension={DIM}")
    want = native_rows.vector_full_scan("docs", "v", data[0].tobytes(), 3)
    assert native_rows.last_loader == ("native" if native.available() else "python")
    monkeypatch.setattr(psql, "native_load_blobs", lambda *a: None)
    c = psql.connect(path, device="cpu")
    c.vector_init("docs", "v", f"type=FLOAT32,dimension={DIM}")
    got = c.vector_full_scan("docs", "v", data[0].tobytes(), 3)
    assert got == want and got[0][1] == 0.0 and got[1][1] == 0.0 and c.last_loader == "python"
    c.execute("INSERT INTO docs(v) VALUES (x'')")
    c.commit()
    for conn in (c, native_rows):
        with pytest.raises(svt.VectorCodecError, match=f"Invalid vector size for rowid {N + 2}"):
            conn.vector_full_scan("docs", "v", data[0].tobytes(), 3)
    m = psql.connect(":memory:", device="cpu")
    m.execute("CREATE TABLE t (v BLOB)")
    m.executemany("INSERT INTO t(v) VALUES (?)", ((r.tobytes(),) for r in data))
    m.vector_init("t", "v", f"type=FLOAT32,dimension={DIM}")
    assert m.vector_full_scan("t", "v", data[9].tobytes(), 1)[0] == (10, 0.0)
    assert m.last_loader == "python"


def test_native_modules_stay_apart_from_jax_builds():
    """The port's _svt_native is loaded by path and kept out of
    sys.modules, so the JAX package's build (imported by name) and the
    port's coexist in one process, in either order; the vtab keeps the
    file name its entry point is derived from."""
    from sqlite_vector_tpu import native as jax_native

    before = sys.modules.get("_svt_native")
    mine = native._load()
    assert sys.modules.get("_svt_native") is before
    theirs = jax_native._load()
    if mine is not None and theirs is not None:
        assert mine is not theirs
        assert os.path.dirname(mine.__file__) == str(native.build_dir())
        assert native._load() is mine
    path = native.vtab_extension_path()
    if path is not None:
        assert os.path.basename(path) == "svtvtab.so" and os.path.dirname(path) == str(native.build_dir())
    assert str(native.THIRD_PARTY).endswith(os.path.join("sqlite_vector_tpu_torch", "csrc", "third_party"))
    assert sorted(os.listdir(native.THIRD_PARTY)) == ["sqlite3.h", "sqlite3ext.h"]


def test_native_json_parser_matches_codec(rng):
    from sqlite_vector_tpu_torch.codec import vector_from_json
    from sqlite_vector_tpu_torch.types import VectorType

    if not native.available():
        pytest.skip("the native module does not build here")
    for vtype in (VectorType.F32, VectorType.F16, VectorType.U8, VectorType.I8):
        vals = rng.integers(0, 100, 12) if vtype in (VectorType.U8, VectorType.I8) else rng.standard_normal(12)
        text = json.dumps([float(v) for v in vals])
        np.testing.assert_array_equal(native.parse_json_vector(text, vtype, 12), vector_from_json(text, vtype, 12))
    for bad in ("[1, 2", "{1}", "[1,,2]"):
        with pytest.raises(svt.VectorCodecError) as a:
            native.parse_json_vector(bad, VectorType.F32)
        with pytest.raises(svt.VectorCodecError) as b:
            vector_from_json(bad, VectorType.F32)
        assert str(a.value) == str(b.value)


def test_vtab_reference_queries_run_verbatim(tmp_path, data):
    """The reference's documented SQL (its API.md, README.md and
    QUANTIZATION.md recall recipe) through the port's virtual tables, and
    the arity errors in the reference's words."""
    path = str(tmp_path / "tvf.db")
    c = psql.connect(path, device="cpu")
    c.execute("CREATE TABLE documents (id INTEGER PRIMARY KEY, embedding BLOB)")
    c.executemany("INSERT INTO documents(embedding) VALUES (?)", ((r.tobytes(),) for r in data))
    c.commit()
    c.execute(f"SELECT vector_init('documents', 'embedding', 'dimension={DIM},type=FLOAT32,distance=L2')")
    q = data[11].tobytes()
    rows = c.execute("SELECT rowid, distance FROM vector_full_scan('documents', 'embedding', ?, 5)", (q,)).fetchall()
    assert rows[0] == (12, 0.0) and len(rows) == 5
    c.execute("SELECT vector_quantize('documents', 'embedding')")
    recall_sql = """
WITH
exact_knn AS (SELECT e.rowid FROM documents AS e
    JOIN vector_full_scan('documents', 'embedding', ?1, ?2) AS v ON e.rowid = v.rowid),
approx_knn AS (SELECT e.rowid FROM documents AS e
    JOIN vector_quantize_scan('documents', 'embedding', ?1, ?2) AS v ON e.rowid = v.rowid),
matches AS (SELECT COUNT(*) AS match_count FROM exact_knn WHERE rowid IN (SELECT rowid FROM approx_knn)),
total AS (SELECT COUNT(*) AS total_count FROM exact_knn)
SELECT (SELECT match_count FROM matches), (SELECT total_count FROM total)
"""
    match_count, total_count = c.execute(recall_sql, (q, 20)).fetchone()
    assert total_count == 20 and match_count >= 18
    assert c.execute(
        "SELECT id FROM vector_full_scan_stream('documents', 'embedding', ?) ORDER BY distance LIMIT 1", (q,)
    ).fetchone()[0] == 12
    for sql, msg in (
        ("SELECT id FROM vector_full_scan('documents', 'embedding', ?)", "expects 4 arguments, but 3 were provided"),
        ("SELECT id FROM vector_full_scan_stream('documents', 'embedding', ?, 20)", "expects 3 arguments"),
    ):
        with pytest.raises(sqlite3.OperationalError, match=msg):
            c.execute(sql, (q,)).fetchall()
    c.close()
    raw = sqlite3.connect(path)
    w = psql.wrap(raw, device="cpu")
    assert w.vtab_loaded
    w.vector_init("documents", "embedding", f"dimension={DIM},type=FLOAT32")
    assert w.execute("SELECT id FROM vector_quantize_scan('documents', 'embedding', ?, 1)", (q,)).fetchone()[0] == 12
    w.close()


def test_vtab_can_be_disabled(monkeypatch):
    monkeypatch.setenv("SVT_DISABLE_VTAB", "1")
    assert not psql.connect(":memory:", device="cpu").vtab_loaded


# -- non-finite and 16-bit tables ---------------------------------------------------


@pytest.mark.nonfinite_inputs
@pytest.mark.parametrize("vtype,metric", [("FLOAT16", "L2"), ("FLOATB16", "DOT"), ("FLOAT32", "L2")])
def test_nonfinite_tables_match_jax(vtype, metric, tmp_path, rng):
    """NaN and +-Inf lanes: vector_full_scan and vector_full_scan_stream
    (which reach the raw-value policies) answer as the JAX package does."""
    rows = rng.standard_normal((120, DIM)).astype(np.float32)
    rows[3, 2], rows[9, 5], rows[15, 1] = np.nan, np.inf, -np.inf
    rows = rows.astype(jax_svt.VectorType(vtype).np_dtype)
    make_db(str(tmp_path / "p.db"), rows)
    shutil.copy(tmp_path / "p.db", tmp_path / "j.db")
    conns = (psql.connect(str(tmp_path / "p.db"), device="cpu"), jsql.connect(str(tmp_path / "j.db")))
    for c in conns:
        c.vector_init("docs", "v", f"type={vtype},dimension={DIM},distance={metric}")
    q = rows[3].tobytes()
    got, want = (c.vector_full_scan("docs", "v", q, 20) for c in conns)
    assert_rows_close(got, want, max(REL_TOL_BY_TYPE[vtype], 1e-5))
    got, want = (list(c.vector_full_scan_stream("docs", "v", q)) for c in conns)
    g, w = np.array([r[1] for r in got]), np.array([r[1] for r in want])
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
    fin = np.isfinite(w)
    np.testing.assert_allclose(g[fin], w[fin], rtol=max(REL_TOL_BY_TYPE[vtype], 1e-5), atol=1e-5)
    for c in conns:
        c.close()


# -- Dataset.to_sqlite / from_sqlite --------------------------------------------------


@pytest.mark.parametrize("qtype", [None, "int8", "int4"])
def test_to_sqlite_and_from_sqlite_match_jax(qtype, tmp_path, rng):
    """Both packages export the same dataset (ids 10.., a removed row, a
    quantization) into byte-identical files; each imports the other's."""
    rows = rng.standard_normal((150, DIM)).astype(np.float32)
    opts = f"dimension={DIM},type=FLOAT32,distance=L2"
    pds = svt.Dataset.from_arrays("d", rows, np.arange(10, 160), options=opts, device="cpu")
    jds = jax_svt.Dataset("d", jax_svt.parse_options(opts))
    jds.add(rows, np.arange(10, 160))
    for ds in (pds, jds):
        ds.remove([12])
        if qtype:
            ds.quantize(qtype=qtype)
    pds.to_sqlite(str(tmp_path / "p.db"), "docs", "emb")
    jds.to_sqlite(str(tmp_path / "j.db"), "docs", "emb")
    with sqlite3.connect(tmp_path / "p.db") as a, sqlite3.connect(tmp_path / "j.db") as b:
        for sql in ("SELECT rowid, emb FROM docs ORDER BY rowid", "SELECT * FROM _sqliteai_vector ORDER BY key"):
            assert a.execute(sql).fetchall() == b.execute(sql).fetchall()
        assert shadow_and_meta(a) == shadow_and_meta(b)
    for src in ("p.db", "j.db"):
        back = svt.Dataset.from_sqlite(str(tmp_path / src), "docs", "emb", opts, device="cpu")
        jback = jax_svt.Dataset.from_sqlite(str(tmp_path / src), "docs", "emb", opts)
        np.testing.assert_array_equal(back.ids, jback.ids)
        assert 12 not in back.ids.tolist() and len(back) == 149
        got, want = back.search(rows[40], 5), jback.search(rows[40], 5)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


def test_bf16_from_sqlite_needs_no_numpy_bfloat16(tmp_path, rng):
    """bfloat16 columns load as their bits: the port's rows equal the JAX
    package's bit for bit."""
    import ml_dtypes

    rows = rng.standard_normal((40, 8)).astype(ml_dtypes.bfloat16)
    make_db(str(tmp_path / "b.db"), rows)
    opts = "dimension=8,type=FLOATB16,distance=L2"
    back = svt.Dataset.from_sqlite(str(tmp_path / "b.db"), "docs", "v", opts, device="cpu")
    jback = jax_svt.Dataset.from_sqlite(str(tmp_path / "b.db"), "docs", "v", opts)
    np.testing.assert_array_equal(back.get(back.ids).view(np.uint16), np.asarray(jback.get(jback.ids)).view(np.uint16))
