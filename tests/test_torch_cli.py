"""The port's CLI (python -m sqlite_vector_tpu_torch), tools/recall.py and
the offline embedders, against the JAX package's on the same inputs, on
the CPU (--cpu, device="cpu").

Every subcommand runs in-process through cli.main(); each SQLite and
dataset-directory result is held against the JAX CLI's on a copy of the
same file (ids equal, values within rtol 1e-5; int8 values equal). The
embedders' vectors are bit-equal to the JAX package's.
"""

import json
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from sqlite_vector_tpu import cli as jax_cli
from sqlite_vector_tpu.models import embedders as jax_embedders
from sqlite_vector_tpu.tools import recall as jax_recall
from sqlite_vector_tpu_torch import cli
from sqlite_vector_tpu_torch.cli import main
from sqlite_vector_tpu_torch.models import embedders
from sqlite_vector_tpu_torch.tools import recall

OPTS = "dimension=16,type=FLOAT32,distance=L2"


@pytest.fixture
def vecs_npy(tmp_path, rng):
    mat = rng.standard_normal((200, 16)).astype(np.float32)
    p = tmp_path / "vecs.npy"
    np.save(p, mat)
    return str(p), mat


def run(capsys, argv, jax=False):
    """One CLI call (the port's with --cpu, or the JAX CLI's); returns
    (exit code, stdout)."""
    rc = jax_cli.main(argv) if jax else main(["--cpu", *argv])
    return rc, capsys.readouterr().out


def test_version(capsys):
    rc, out = run(capsys, ["version"])
    assert rc == 0 and out.startswith("sqlite_vector_tpu_torch 0.4.0 (")


def test_sqlite_workflow_matches_jax_cli(tmp_path, vecs_npy, capsys):
    """import -> init -> quantize -> search (exact and quantized, JSON and
    text) on one database, the JAX CLI on a copy: equal outputs, equal
    shadow tables and metadata."""
    npy, mat = vecs_npy
    db, jdb = str(tmp_path / "t.db"), str(tmp_path / "j.db")
    rc, out = run(capsys, ["import", db, "docs", "emb", npy, "--create", "--options", OPTS])
    assert rc == 0 and "imported 200" in out
    shutil.copy(db, jdb)
    for jax in (False, True):
        d = jdb if jax else db
        assert run(capsys, ["init", d, "docs", "emb", OPTS], jax)[0] == 0
        rc, out = run(capsys, ["quantize", d, "docs", "emb", "--options", OPTS], jax)
        assert rc == 0 and "quantized 200" in out
    q = json.dumps(mat[17].tolist())
    outs = {}
    for jax in (False, True):
        d = jdb if jax else db
        for mode in ("exact", "quantized"):
            rc, out = run(capsys, ["search", d, "docs", "emb", q, "-k", "3", "--json",
                                   "--mode", mode, "--options", OPTS], jax)
            assert rc == 0
            outs[jax, mode] = json.loads(out)
    assert outs[False, "exact"]["ids"][0] == 18 and outs[False, "exact"]["distances"][0] == 0.0
    for mode in ("exact", "quantized"):
        assert outs[False, mode]["ids"] == outs[True, mode]["ids"]
        np.testing.assert_allclose(outs[False, mode]["distances"], outs[True, mode]["distances"], rtol=1e-5)
    rc, text = run(capsys, ["search", db, "docs", "emb", q, "-k", "3", "--options", OPTS])
    assert [line.split("\t")[0] for line in text.strip().splitlines()] == ["18", *map(str, outs[False, "exact"]["ids"][1:])]
    import sqlite3

    for sql in ("SELECT * FROM vector0_docs_emb", "SELECT * FROM _sqliteai_vector ORDER BY key"):
        with sqlite3.connect(db) as a, sqlite3.connect(jdb) as b:
            assert a.execute(sql).fetchall() == b.execute(sql).fetchall()


def test_import_bf16_column(tmp_path, rng, capsys):
    """import writes bfloat16 rows as the JAX CLI does (round to nearest
    even, little-endian bits)."""
    mat = rng.standard_normal((20, 8)).astype(np.float32)
    np.save(tmp_path / "m.npy", mat)
    opts = "dimension=8,type=FLOATB16,distance=L2"
    dbs = {jax: str(tmp_path / f"{jax}.db") for jax in (False, True)}
    for jax, d in dbs.items():
        assert run(capsys, ["import", d, "t", "v", str(tmp_path / "m.npy"), "--create", "--options", opts], jax)[0] == 0
    import sqlite3

    with sqlite3.connect(dbs[False]) as a, sqlite3.connect(dbs[True]) as b:
        assert a.execute("SELECT * FROM t").fetchall() == b.execute("SELECT * FROM t").fetchall()


def test_dataset_dir_workflow(tmp_path, vecs_npy, capsys):
    """ds-create -> ds-info -> ds-search (exact, rerank, host-streamed, a
    batch of queries), against the JAX CLI on the same directory."""
    npy, mat = vecs_npy
    d = str(tmp_path / "ds")
    rc, out = run(capsys, ["ds-create", d, OPTS, "--npy", npy])
    assert rc == 0 and "saved 200 rows" in out
    rc, out = run(capsys, ["ds-info", d])
    info = json.loads(out)
    assert info["count"] == 200 and info["dimension"] == 16 and info["backend"] in ("cpu/torch", "cuda/kernel")
    qpath = str(tmp_path / "q.npy")
    np.save(qpath, mat[5])
    for extra in ([], ["--host"], ["--mode", "approx"]):
        got = json.loads(run(capsys, ["ds-search", d, qpath, "-k", "2", "--json", *extra])[1])
        want = json.loads(run(capsys, ["ds-search", d, qpath, "-k", "2", "--json", *extra], jax=True)[1])
        assert got["ids"] == want["ids"] and got["ids"][0] == 6 and got["distances"][0] == 0.0
    np.save(qpath, mat[[5, 9]])
    got = json.loads(run(capsys, ["ds-search", d, qpath, "-k", "2", "--json"])[1])
    assert got["ids"][0][0] == 6 and got["ids"][1][0] == 10
    text = run(capsys, ["ds-search", d, qpath, "-k", "2"])[1]
    assert "# query 0" in text and "# query 1" in text


def test_warm(capsys):
    rc, out = run(capsys, ["warm", "--n", "500", "--dim", "16", "-k", "3", "--max-batch", "4",
                           "--modes", "exact,rerank"])
    # 2 modes x batches {1, 2, 4} x {unmasked, masked}
    assert rc == 0 and "warmed 12 searches" in out and "warm masked exact" in out
    assert "native module" in out and "on cpu" in out


def test_search_error_path(tmp_path, capsys):
    db = str(tmp_path / "e.db")
    run(capsys, ["import", db, "docs", "emb", _npy(tmp_path), "--create", "--options", "dimension=2,type=FLOAT32"])
    rc = main(["--cpu", "search", db, "missing", "emb", "[1,2]", "--options", "dimension=2,type=FLOAT32"])
    assert rc == 1 and "error:" in capsys.readouterr().err
    # no --cpu on a machine without a card: the CUDA default refuses
    if not __import__("torch").cuda.is_available():
        assert main(["search", db, "docs", "emb", "[1,2]"]) == 1
        assert "CUDA" in capsys.readouterr().err


def _npy(tmp_path):
    p = str(tmp_path / "two.npy")
    np.save(p, np.eye(2, dtype=np.float32))
    return p


def test_recall_command_matches_jax_tool(capsys):
    """`recall` forwards to tools.recall: the same synthetic rows, codes and
    queries as the JAX tool, so the same report."""
    argv = ["--n", "2000", "--dim", "16", "--k", "5", "--queries", "8"]
    rc, out = run(capsys, ["recall", *argv])
    assert rc == 0 and "recall@5:" in out and "quant params:" in out
    assert float(out.split("recall@5:")[1].split()[0]) > 0.8
    monkey_argv, sys.argv = sys.argv, ["recall", *argv]
    try:
        jax_recall.main()
    finally:
        sys.argv = monkey_argv
    jout = capsys.readouterr().out
    assert out.splitlines()[0] == jout.splitlines()[0]


def test_measure_recall_matches_jax(rng):
    import sqlite_vector_tpu as jax_svt
    import sqlite_vector_tpu_torch as svt

    base = rng.standard_normal((1500, 24)).astype(np.float32)
    q = base[:12] + 0.01 * rng.standard_normal((12, 24)).astype(np.float32)
    pds = svt.VectorStore(device="cpu").create("r", "dimension=24,type=FLOAT32,distance=L2")
    jds = jax_svt.VectorStore().create("r", "dimension=24,type=FLOAT32,distance=L2")
    for ds in (pds, jds):
        ds.add(base)
        ds.quantize()
    got, want = recall.measure_recall(pds, q, 10), jax_recall.measure_recall(jds, q, 10)
    assert (got.match_count, got.total_count, got.n_queries) == (want.match_count, want.total_count, want.n_queries)
    assert str(got) == str(want)


def test_serve_command(tmp_path, vecs_npy, monkeypatch, capsys):
    """`serve --dir` end to end: a real POST /search against the live
    server from the block hook, then a clean shutdown."""
    import urllib.request

    import sqlite_vector_tpu_torch as svt

    npy, mat = vecs_npy
    d = str(tmp_path / "ds")
    assert run(capsys, ["ds-create", d, OPTS, "--npy", npy])[0] == 0
    captured = {}

    def request_then_interrupt(server):
        host, port = server.server_address[:2]
        body = json.dumps({"vector": mat[3].tolist(), "k": 2}).encode()
        req = urllib.request.Request(f"http://{host}:{port}/search", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            captured["resp"] = json.loads(r.read())
        raise KeyboardInterrupt

    monkeypatch.setattr(cli, "_serve_block", request_then_interrupt)
    assert main(["--cpu", "serve", "--dir", d, "--port", "0", "--quantize"]) == 0
    assert captured["resp"]["ids"][0] == 4 and captured["resp"]["distances"][0] == 0.0
    assert "serving 200 x 16" in capsys.readouterr().out
    assert svt.serve is not None


def test_serve_from_sqlite_source(tmp_path, vecs_npy, monkeypatch, capsys):
    npy, mat = vecs_npy
    db = str(tmp_path / "s.db")
    run(capsys, ["import", db, "docs", "emb", npy, "--create", "--options", OPTS])
    seen = {}

    def stop(server):
        seen["served"] = True
        raise KeyboardInterrupt

    monkeypatch.setattr(cli, "_serve_block", stop)
    assert main(["--cpu", "serve", "--db", db, "docs", "emb", "--options", OPTS, "--port", "0"]) == 0
    assert seen["served"] and "serving 200 x 16" in capsys.readouterr().out


def test_serve_sigterm_clean_shutdown(tmp_path, vecs_npy, capsys):
    """SIGTERM takes ctrl-C's clean shutdown path: exit 0."""
    npy, _ = vecs_npy
    d = str(tmp_path / "ds")
    assert run(capsys, ["ds-create", d, OPTS, "--npy", npy])[0] == 0
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "sqlite_vector_tpu_torch", "--cpu", "serve", "--dir", d, "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = time.time() + 120
        started = False
        while time.time() < deadline:
            line = proc.stdout.readline()
            if line.startswith("serving"):
                started = True
                break
        assert started, "the server never printed its startup line"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


@pytest.mark.parametrize("cls", ["HashEmbedder", "RandomProjectionEmbedder"])
def test_offline_embedders_bit_equal_jax(cls):
    texts = ["The quick brown fox", "jumps over the lazy dog", "", "  spaced   out  words ", "ünïcödé text"]
    got = getattr(embedders, cls)().encode(texts)
    want = getattr(jax_embedders, cls)().encode(texts)
    assert got.dtype == np.float32 and got.shape == (5, embedders.DIM)
    np.testing.assert_array_equal(got, want)
    norms = np.linalg.norm(got[[0, 1, 3, 4]], axis=1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)

