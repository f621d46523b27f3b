"""The bytes the port's sharded scans gather for their merges
(parallel.audit.GATHERED) against the JAX package's figures for the same
shapes: its HLO audit of the compiled executors (parallel/audit.py,
tests/test_collective_audit.py) and the QueryStats figure of a mesh
search (utils/profiling.py), which the port's own timed_search reports
too. Counts are integers: they must be equal.
"""

import jax
import numpy as np
import pytest
import torch

import sqlite_vector_tpu as jax_svt
import sqlite_vector_tpu_torch as svt
from sqlite_vector_tpu.parallel import (
    audit_sharded_int4_scan,
    audit_sharded_int8_scan,
    audit_sharded_scan,
)
from sqlite_vector_tpu.parallel import collective_bytes_per_query as jax_bytes
from sqlite_vector_tpu.parallel import make_mesh as jax_make_mesh
from sqlite_vector_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from sqlite_vector_tpu.types import DistanceMetric as JaxMetric
from sqlite_vector_tpu.utils.profiling import timed_search
from sqlite_vector_tpu_torch.ops.quantize4 import packed_width
from sqlite_vector_tpu_torch.parallel import (
    GATHERED,
    collective_bytes_per_query,
    make_mesh,
    make_mesh_2d,
    sharded_int4_scan_topk,
    sharded_scan_topk,
    sharded_scan_topk_2d,
)
from sqlite_vector_tpu_torch.types import DistanceMetric
from sqlite_vector_tpu_torch.utils import timed_search as port_timed_search

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8 virtual JAX devices")

CPU8 = ["cpu"] * 8


def gathered(fn, *args, **kwargs) -> int:
    GATHERED.reset()
    fn(*args, **kwargs)
    return GATHERED.total


def zeros(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def test_collective_bytes_per_query_is_the_jax_figure():
    for d, b, k in ((1, 1, 1), (8, 2, 5), (32, 64, 20)):
        assert collective_bytes_per_query(d, b, k) == jax_bytes(d, b, k) == 8 * d * b * k


@pytest.mark.parametrize("b, k, n", [(1, 20, 8192), (16, 5, 65536)])
def test_1d_merge_bytes_equal_the_jax_hlo_audit(b, k, n):
    """The merge of a 1-D sharded top-k gathers what the JAX executor's two
    all-gathers move, as its compiled HLO shows."""
    want = audit_sharded_scan(jax_make_mesh(), batch=b, k=k, n=n, dim=64)["total_bytes"]
    got = gathered(sharded_scan_topk, zeros((b, 64)), zeros((n, 64)), DistanceMetric.L2, k, make_mesh(devices=CPU8))
    assert got == want == collective_bytes_per_query(8, b, k)


@pytest.mark.parametrize("metric", ["COSINE", "L1"])
def test_1d_merge_bytes_metric_independent(metric):
    want = audit_sharded_scan(jax_make_mesh(), batch=4, k=10, n=4096, dim=32, metric=JaxMetric(metric))["total_bytes"]
    got = gathered(
        sharded_scan_topk, zeros((4, 32)), zeros((4096, 32)), DistanceMetric(metric), 10, make_mesh(devices=CPU8)
    )
    assert got == want


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_merge_bytes_equal_the_jax_hlo_audit(kind):
    """The int8 and int4 scans gather the same [D, B, k] candidates: the
    codes never leave their shard."""
    mesh = make_mesh(devices=CPU8)
    for b, k, n in ((1, 20, 8192), (16, 5, 65536)):
        if kind == "int8":
            want = audit_sharded_int8_scan(jax_make_mesh(), batch=b, k=k, n=n, dim=64)["total_bytes"]
            got = gathered(
                sharded_scan_topk, zeros((b, 64), torch.int8), zeros((n, 64), torch.int8), DistanceMetric.L2, k, mesh
            )
        else:
            want = audit_sharded_int4_scan(jax_make_mesh(), batch=b, k=k, n=n, dim=64)["total_bytes"]
            got = gathered(
                sharded_int4_scan_topk, torch.ones((b, 64)), zeros((n, packed_width(64)), torch.uint8),
                zeros((n,)), zeros((n,), torch.int32), DistanceMetric.L2, k, mesh, dim=64,
            )
        assert got == want == collective_bytes_per_query(8, b, k)


def test_2d_bytes_equal_the_jax_merge_and_dim_sum():
    """A 2-D top-k's merge over the 4 row groups equals the JAX executor's
    all-gathers, and its dim-axis sum the JAX all-reduce's [B, N/rows]
    float32 partial block."""
    b, k, n, dim = 4, 20, 4096, 64
    r = audit_sharded_scan(jax_make_mesh_2d(4, 2), batch=b, k=k, n=n, dim=dim, two_d=True)
    jax_merge = sum(c["bytes"] for c in r["collectives"] if c["op"] == "all-gather")
    (reduce,) = [c for c in r["collectives"] if c["op"] == "all-reduce"]
    assert ("f32", [b, n // 4]) in reduce["shapes"]
    GATHERED.reset()
    sharded_scan_topk_2d(zeros((b, dim)), zeros((n, dim)), DistanceMetric.L2, k, make_mesh_2d(4, 2, devices=CPU8))
    assert GATHERED.merge == jax_merge == collective_bytes_per_query(4, b, k)
    assert GATHERED.dim_sum == 4 * b * (n // 4)


def test_dataset_search_bytes_equal_the_jax_querystats():
    """JAX test_querystats_surfaces_collective_bytes: a mesh dataset's
    search gathers the QueryStats figure of the same search in the JAX
    package, on a 1-D and a 2-D mesh, and the port's own timed_search
    reports that figure too; one device gathers nothing."""
    data = np.random.default_rng(0).standard_normal((256, 16)).astype(np.float32)
    for jmesh, pmesh in ((jax_make_mesh(), make_mesh(devices=CPU8)),
                         (jax_make_mesh_2d(4, 2), make_mesh_2d(4, 2, devices=CPU8))):
        jds = jax_svt.VectorStore(mesh=jmesh).create("m", "dimension=16,type=FLOAT32")
        pds = svt.VectorStore(mesh=pmesh).create("m", "dimension=16,type=FLOAT32")
        jds.add(data)
        pds.add(data)
        _, _, stats = timed_search(jds, data[:2], 5)
        assert gathered(pds.search, data[:2], 5) == stats.collective_bytes > 0
        GATHERED.reset()
        _, _, mine = port_timed_search(pds, data[:2], 5)
        assert mine.collective_bytes == GATHERED.total == stats.collective_bytes
    solo = svt.VectorStore(device="cpu").create("s", "dimension=16,type=FLOAT32")
    solo.add(data)
    assert gathered(solo.search, data[:2], 5) == 0
    assert port_timed_search(solo, data[:2], 5)[2].collective_bytes == 0


def test_merge_bytes_scale_linearly_in_shards():
    """8 -> 16 -> 32 shards: 8 * D * B * k exactly, as the JAX audit finds
    for 8, 16 and 32 virtual devices."""
    got = [
        gathered(sharded_scan_topk, zeros((2, 32)), zeros((d * 1024, 32)), DistanceMetric.L2, 8,
                 make_mesh(devices=["cpu"] * d))
        for d in (8, 16, 32)
    ]
    assert got == [collective_bytes_per_query(d, 2, 8) for d in (8, 16, 32)] == [8 * d * 2 * 8 for d in (8, 16, 32)]
