"""PyTorch port parity for utils/: timed_search's QueryStats, StatsRecorder,
Timer and format_bytes against sqlite_vector_tpu/utils on the same seeded
numpy inputs; profile_trace and annotate on torch.profiler; the build
cache (utils/compile_cache.py) that ops/_build.py and native/ build into;
ShardedRows.astype and iter_tiles; the package's exports.

Tolerances: QueryStats fields are integers and flags, equal exactly (the
wall time is each package's own clock, so it is set equal before str() is
compared); summaries of the same walls are equal exactly.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import sqlite_vector_tpu as jax_svt
import sqlite_vector_tpu_torch as svt
from sqlite_vector_tpu.hostarray import ShardedRows as JaxShardedRows
from sqlite_vector_tpu.parallel import make_mesh as jax_make_mesh
from sqlite_vector_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from sqlite_vector_tpu.utils import QueryStats as JaxQueryStats
from sqlite_vector_tpu.utils import StatsRecorder as JaxStatsRecorder
from sqlite_vector_tpu.utils import Timer as JaxTimer
from sqlite_vector_tpu.utils import format_bytes as jax_format_bytes
from sqlite_vector_tpu.utils import timed_search as jax_timed_search
from sqlite_vector_tpu.utils.compile_cache import enable_persistent_cache as jax_enable_cache
from sqlite_vector_tpu_torch import native
from sqlite_vector_tpu_torch.hostarray import ShardedRows
from sqlite_vector_tpu_torch.ops import _build
from sqlite_vector_tpu_torch.parallel import GATHERED, make_mesh, make_mesh_2d
from sqlite_vector_tpu_torch.utils import (
    QueryStats,
    StatsRecorder,
    Timer,
    annotate,
    format_bytes,
    profile_trace,
    timed_search,
)
from sqlite_vector_tpu_torch.utils import compile_cache
from sqlite_vector_tpu_torch.utils.timing import trace

REPO = Path(__file__).resolve().parent.parent
FIELDS = ("n_rows", "n_queries", "k", "exact", "bytes_scanned", "collective_bytes")


def stats_fields(stats) -> dict:
    return {f: getattr(stats, f) for f in FIELDS}


def make_pair(layout: str):
    """(JAX dataset, port dataset) of 16-dim FLOAT32 L2 rows on one device,
    a 1-D mesh of 8 or a 2-D 4 x 2 mesh (8 "cpu" shards in the port)."""
    opts = "dimension=16,type=FLOAT32,distance=L2"
    if layout == "one":
        return jax_svt.VectorStore().create("u", opts), svt.VectorStore(device="cpu").create("u", opts)
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual JAX devices")
    jmesh, pmesh = {
        "1d": (jax_make_mesh, lambda: make_mesh(devices=["cpu"] * 8)),
        "2d": (lambda: jax_make_mesh_2d(4, 2), lambda: make_mesh_2d(4, 2, devices=["cpu"] * 8)),
    }[layout]
    return (jax_svt.VectorStore(mesh=jmesh()).create("u", opts),
            svt.VectorStore(mesh=pmesh()).create("u", opts))


@pytest.mark.parametrize(
    "layout, mode",
    [(layout, mode) for layout in ("one", "1d", "2d") for mode in ("exact", "int8")]
    + [("one", "int4"), ("1d", "int4")],
)
@pytest.mark.parametrize("b", [1, 3])
def test_timed_search_stats_equal_the_jax_querystats(layout, mode, b):
    """Every QueryStats field but wall_s equal to the JAX package's for the
    same search; str() equal once wall_s is; the ids those of a plain
    search; collective_bytes equal to the port's GATHERED delta; both
    recorders fed."""
    rng = np.random.default_rng(7)
    rows = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((b, 16)).astype(np.float32)
    jds, pds = make_pair(layout)
    jds.add(rows)
    pds.add(rows)
    exact = mode == "exact"
    if not exact:
        jds.quantize(qtype=mode)
        pds.quantize(qtype=mode)
    jds.stats_recorder, pds.stats_recorder = JaxStatsRecorder(), StatsRecorder()
    _, _, want = jax_timed_search(jds, q if b > 1 else q[0], 5, exact=exact)
    GATHERED.reset()
    ids, dist, got = timed_search(pds, q if b > 1 else q[0], 5, exact=exact)
    assert GATHERED.total == got.collective_bytes
    assert (got.collective_bytes > 0) == (layout != "one")
    assert stats_fields(got) == stats_fields(want)
    assert got.bytes_scanned == 300 * 16 * (4 if exact else 1)
    plain_ids, plain_dist = pds.search(q if b > 1 else q[0], 5, exact=exact)
    np.testing.assert_array_equal(ids, plain_ids)
    np.testing.assert_array_equal(dist, plain_dist)
    got.wall_s = want.wall_s
    assert str(got) == str(want) and got.qps == want.qps and got.gb_per_s == want.gb_per_s
    assert pds.stats_recorder.entries == [got]
    assert jds.stats_recorder.summary()["count"] == pds.stats_recorder.summary()["count"] == 1


def test_dataset_has_a_stats_recorder_slot():
    """Dataset.stats_recorder, as sqlite_vector_tpu/dataset.py:394: None
    until set; a plain search never reads it."""
    ds = svt.VectorStore(device="cpu").create("s", "dimension=4,type=FLOAT32")
    assert ds.stats_recorder is None
    ds.add(np.eye(4, dtype=np.float32))
    ds.search(np.eye(4, dtype=np.float32)[0], 1)
    assert ds.stats_recorder is None


@pytest.mark.parametrize("capacity, n", [(1, 3), (4, 6), (4, 4), (256, 10)])
def test_stats_recorder_matches_jax(capacity, n):
    """The same walls give the same ring buffer and summary()."""
    walls = np.random.default_rng(capacity * 100 + n).uniform(1e-4, 5e-3, n)
    mine, theirs = StatsRecorder(capacity), JaxStatsRecorder(capacity)
    assert mine.summary() == theirs.summary() == {}
    for i, w in enumerate(walls):
        args = dict(wall_s=float(w), n_rows=1000, n_queries=i + 1, k=5, exact=i % 2 == 0, bytes_scanned=4000)
        mine.add(QueryStats(**args))
        theirs.add(JaxQueryStats(**args))
    assert mine.summary() == theirs.summary()
    assert mine.summary()["count"] == min(n, capacity)
    assert [str(e) for e in mine.entries] == [str(e) for e in theirs.entries]


@pytest.mark.parametrize("n", [0, 1, 512, 1023, 1024, 1536, 3 * 1024**3, 5 * 1024**5, -2048])
def test_format_bytes_matches_jax(n):
    assert format_bytes(n) == jax_format_bytes(n)


def test_timer_matches_jax():
    for cls in (Timer, JaxTimer):
        t = cls()
        assert t.elapsed == 0.0
        with t as entered:
            time.sleep(0.01)
        assert entered is t and t.elapsed >= 0.01


def test_query_stats_zero_wall_matches_jax():
    args = dict(wall_s=0.0, n_rows=10, n_queries=2, k=1, exact=True, bytes_scanned=40)
    assert str(QueryStats(**args)) == str(JaxQueryStats(**args))
    assert QueryStats(**args).qps == float("inf") and QueryStats(**args).gb_per_s == 0.0


class Sentinel(Exception):
    pass


def test_profile_trace_writes_a_trace_with_the_annotations(tmp_path):
    """One profile_trace: a port search inside annotate() and trace(
    enabled=True); a nested profile_trace raises; the region then raises,
    and the trace is written all the same, holding both names."""
    ds = svt.VectorStore(device="cpu").create("p", "dimension=8,type=FLOAT32")
    ds.add(np.random.default_rng(3).standard_normal((64, 8)).astype(np.float32))
    log_dir, nested_dir = tmp_path / "trace", tmp_path / "nested"
    with pytest.raises(Sentinel):
        with profile_trace(str(log_dir)):
            with annotate("svt.test.search"):
                ds.search(np.ones(8, np.float32), 3)
            with trace("svt.test.trace", enabled=True):
                ds.search(np.zeros(8, np.float32), 3)
            with pytest.raises(RuntimeError, match="already been started"):
                with profile_trace(str(nested_dir)):
                    pass
            raise Sentinel
    assert not nested_dir.exists()
    files = sorted(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert {"svt.test.search", "svt.test.trace"} <= names


def test_annotations_outside_a_trace_are_no_ops(monkeypatch):
    """annotate() outside a trace changes nothing; trace(enabled=False)
    does not even open a profiler range."""
    ds = svt.VectorStore(device="cpu").create("n", "dimension=4,type=FLOAT32")
    ds.add(np.eye(4, dtype=np.float32))
    want = ds.search(np.eye(4, dtype=np.float32), 2)
    with annotate("svt.idle"):
        got = ds.search(np.eye(4, dtype=np.float32), 2)
    np.testing.assert_array_equal(got[0], want[0])

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with enabled=False")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace("svt.off"):
        got = ds.search(np.eye(4, dtype=np.float32), 2)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("setting", ["unset", "dir", "off"])
def test_build_cache_setting_moves_the_builds(setting, tmp_path, monkeypatch):
    """SVT_COMPILE_CACHE, read at each call: unset -> the package's _build/,
    <dir> -> <dir>, off -> None, with the builds in this process's own
    temporary directory (one for every thread). The kernel library and the
    native builds both resolve under it."""
    if setting == "unset":
        monkeypatch.delenv("SVT_COMPILE_CACHE", raising=False)
        want = str(REPO / "sqlite_vector_tpu_torch" / "_build")
    elif setting == "dir":
        monkeypatch.setenv("SVT_COMPILE_CACHE", str(tmp_path / "cache"))
        want = str(tmp_path / "cache")
    else:
        monkeypatch.setenv("SVT_COMPILE_CACHE", "off")
        want = None
        assert jax_enable_cache() is None  # the JAX meaning of "off"
    got = svt.enable_persistent_cache()
    assert got == want == compile_cache.ensure_persistent_cache() == compile_cache.ensure_persistent_cache()
    if setting == "off":
        roots = []
        threads = [threading.Thread(target=lambda: roots.append(compile_cache.build_root())) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(set(roots)) == 1 and roots[0].is_dir()
        root = roots[0]
        assert REPO not in root.parents and root.parent == Path(tempfile.gettempdir())
    else:
        root = Path(want)
        if setting == "dir":
            assert not root.exists()  # resolving creates nothing
    assert _build.library_path().parent == root
    assert native.build_dir().parent == root


def test_import_builds_nothing_and_creates_no_directory(tmp_path):
    """A fresh interpreter importing every module of the package, with the
    cache pointed at a directory that does not exist and TMPDIR empty,
    creates neither; with the cache off the temporary build directory
    appears only when a build asks for it, and is gone at exit."""
    cache, tmp = tmp_path / "cache", tmp_path / "tmp"
    tmp.mkdir()
    code = (
        "import os, sys\n"
        "import sqlite_vector_tpu_torch, sqlite_vector_tpu_torch.utils\n"
        "import sqlite_vector_tpu_torch.ops._build, sqlite_vector_tpu_torch.native\n"
        "import sqlite_vector_tpu_torch.sqlite, sqlite_vector_tpu_torch.cli\n"
        "from sqlite_vector_tpu_torch.utils import compile_cache\n"
        "cache, tmp = sys.argv[1], sys.argv[2]\n"
        "assert 'jax' not in sys.modules\n"
        "sqlite_vector_tpu_torch.ops._build.library_path()\n"
        "assert not os.path.exists(cache), 'import created the cache directory'\n"
        "os.environ['SVT_COMPILE_CACHE'] = 'off'\n"
        "assert not os.listdir(tmp), 'import created a temporary directory'\n"
        "root = compile_cache.build_root()\n"
        "assert os.path.dirname(str(root)) == tmp and os.path.isdir(root)\n"
    )
    env = {**os.environ, "SVT_COMPILE_CACHE": str(cache), "TMPDIR": str(tmp)}
    r = subprocess.run(
        [sys.executable, "-c", code, str(cache), str(tmp)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=180,
    )
    assert r.returncode == 0, r.stderr
    assert not cache.exists()
    assert not os.listdir(tmp), "the temporary build directory outlived its process"


@pytest.mark.parametrize("tile_rows", [1, 3, 7, 11, 100])
def test_sharded_rows_astype_and_iter_tiles_match_jax(tmp_path, tile_rows):
    """astype and iter_tiles over a memory-mapped two-shard array equal the
    JAX package's copy of the class."""
    rng = np.random.default_rng(tile_rows)
    parts = []
    for i, n in enumerate((7, 4)):
        np.save(tmp_path / f"s{i}.npy", rng.standard_normal((n, 5)).astype(np.float32))
        parts.append(np.load(tmp_path / f"s{i}.npy", mmap_mode="r"))
    mine, theirs = ShardedRows(parts), JaxShardedRows(parts)
    for dtype, copy in ((np.float64, True), (np.float32, False), (np.float16, True)):
        a, b = mine.astype(dtype, copy=copy), theirs.astype(dtype, copy=copy)
        assert a.dtype == b.dtype and not isinstance(a, np.memmap)
        np.testing.assert_array_equal(a, b)
    got, want = list(mine.iter_tiles(tile_rows)), list(theirs.iter_tiles(tile_rows))
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(0, 11, tile_rows))
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate([t for _, t in got]), np.concatenate(parts))


def test_package_exports_everything_the_jax_package_does():
    assert set(jax_svt.__all__) <= set(svt.__all__)
    for name in jax_svt.__all__:
        assert getattr(svt, name) is not None
    import sqlite_vector_tpu.utils as jax_utils
    import sqlite_vector_tpu_torch.utils as utils

    assert utils.__all__ == jax_utils.__all__
    assert svt.human_to_number("1KB") == jax_svt.human_to_number("1KB")
    assert svt.DEFAULT_MAX_MEMORY == jax_svt.DEFAULT_MAX_MEMORY
    v = np.arange(4, dtype=np.float32)
    assert svt.vector_as_blob(v, svt.VectorType.F32) == jax_svt.vector_as_blob(v, jax_svt.VectorType.F32)
    assert len(svt.make_mesh(devices=["cpu"] * 2).devices.reshape(-1)) == 2
