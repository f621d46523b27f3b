"""The exact float32 search held to the benchmark's plain reference
(vbench/reference/float_exact.py), on the CPU at small sizes: the port's
Dataset.search(mode="exact") over rows drawn as the benchmark draws them,
judged by vbench/check.py against the configuration's limits, passes; the
reference one precision step down (TF32) fails them. And the finish's
spans: the gathered finish of L1 rows returns the same answer with its
element bound cut and records no span inside `ops.finish`; the float and
codes finishes on the rescore route record `ops.rescore` there, one a
query chunk, and no counter."""

import numpy as np
import pytest
import torch

import sqlite_vector_tpu_torch as svt
from sqlite_vector_tpu_torch.device import from_numpy
from sqlite_vector_tpu_torch.ops import rerank
from sqlite_vector_tpu_torch.ops.scan import scan_topk
from sqlite_vector_tpu_torch.types import DistanceMetric
from sqlite_vector_tpu_torch.utils import profiling
from vbench import check, data, spec

N, K, POOL = 3000, 10, 64
CONFIG = "openai-5m-1536"
METRICS = ["COSINE", "L2", "SQUARED_L2", "DOT"]
DIMS = [1536, 48]


def cfg_for(metric, d):
    cfg = spec.config(CONFIG)
    cfg.update(rows=N, dim=d, k=K, metric=metric)
    return cfg


def pool(seed, d):
    plan = data.QueryPlan(seed, N, d, POOL, 0.5, 0.1, "cpu")
    for start, rows in data.row_chunks(seed, N, d, "cpu"):
        plan.take(start, rows)
    return plan.queries()


def reference(cfg, precision="reference"):
    return spec.reference(cfg["reference"]).Reference(cfg, precision)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("metric", METRICS)
def test_exact_search_passes_the_configurations_check(metric, d):
    seed = 4_000_000_000 + d
    cfg = cfg_for(metric, d)
    ds = svt.Dataset("t", svt.parse_options(f"dimension={d},type=FLOAT32,distance={metric}"), device="cpu")
    for start, rows in data.row_chunks(seed, N, d, "cpu"):
        ds.add(rows.numpy(), np.arange(start + 1, start + rows.shape[0] + 1))
    q = pool(seed, d)
    ids, dist = ds.search(q, K, mode="exact")
    answers = [(i, q[i], (ids[i], dist[i])) for i in range(len(q))]
    numbers = check.judge(answers, reference(cfg), seed, cfg, "cpu")
    assert check.correct(numbers), numbers
    if metric == spec.config(CONFIG)["metric"]:
        # under the metric the limits were set for, the program's readings
        # sit at most a fifth of them
        for name in ("dist_err", "rank_gap"):
            assert numbers[name]["value"] <= numbers[name]["limit"] / 5, numbers


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("metric", METRICS)
def test_the_tf32_control_fails_the_configurations_check(metric, d):
    seed = 4_100_000_000 + d
    cfg = cfg_for(metric, d)
    q = pool(seed, d)
    own = check.control_answers(reference(cfg), seed, cfg, "cpu", q)
    assert check.correct(check.judge(own, reference(cfg), seed, cfg, "cpu"))
    ctrl = check.control_answers(reference(cfg, "control"), seed, cfg, "cpu", q)
    numbers = check.judge(ctrl, reference(cfg), seed, cfg, "cpu")
    assert not check.correct(numbers), numbers
    assert numbers["dist_err"]["value"] > 5 * numbers["dist_err"]["limit"], numbers


def test_tf32_rounds_to_nearest_even_on_ten_mantissa_bits():
    tf32 = spec.reference("float_exact").tf32
    one = 1.0
    ulp = 2.0 ** -10  # TF32's step at 1
    x = torch.tensor([one, one + ulp / 2, one + 3 * ulp / 2, one + ulp / 2 + 2 ** -20,
                      -(one + 3 * ulp / 2), 3.0e38, 0.0], dtype=torch.float32)
    want = [one, one, one + 2 * ulp, one + ulp, -(one + 2 * ulp)]
    got = tf32(x)
    assert got[:5].tolist() == want  # ties to the even neighbour, else the nearest
    assert got[6] == 0.0 and torch.isfinite(got[5])
    low = got.view(torch.int32) & 0x1FFF
    assert not bool(low.any())


def _dataset(n, d, qtype=None, metric="COSINE"):
    ds = svt.VectorStore(device="cpu").create("t", f"dimension={d},type=FLOAT32,distance={metric}")
    ds.add(np.random.default_rng(0).standard_normal((n, d)).astype(np.float32))
    if qtype:
        ds.quantize(qtype=qtype)
    return ds


@pytest.mark.parametrize("chunk_elems", [None, 1280])
def test_the_gathered_finish_records_its_gather_and_counts_its_rows(monkeypatch, chunk_elems):
    """B = 3 queries, k = 5 over 1,000 L1 rows (8 groups, 5 kept): 3 * 5 *
    128 candidate rows of 24 float32 elements. With the rescore's element
    bound cut to 1,280 (two queries a finish chunk, one query and 53
    candidates a gathered slice) the finish returns what it returns uncut,
    and what the plain scan_topk returns; `ops.finish` holds no span on
    this route and counts nothing."""
    n, d, b, k = 1000, 24, 3, 5
    ds = _dataset(n, d, metric="L1")
    q = np.random.default_rng(1).standard_normal((b, d)).astype(np.float32)
    want = ds.search(q, k, mode="exact")
    if chunk_elems is not None:
        monkeypatch.setattr(rerank, "RESCORE_CHUNK_ELEMS", chunk_elems)
    with profiling.recording() as rec:
        got = ds.search(q, k, mode="exact")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    plain_v, plain_i = scan_topk(from_numpy(q), ds._vectors[:n], DistanceMetric.L1, k)
    np.testing.assert_array_equal(got[0], ds._ids[plain_i.numpy()])
    np.testing.assert_allclose(got[1], plain_v.numpy(), rtol=1e-6)
    finish = rec.named("ops.finish")
    assert len(finish) == 1
    assert [s.name for s in rec.spans if s.parent == finish[0].id] == []
    assert finish[0].counts is None and not any(name.startswith("finish.") for name in rec.counters)


@pytest.mark.parametrize("chunk_elems", [None, 1280])
def test_the_float_finish_records_its_rescore_and_no_gather(monkeypatch, chunk_elems):
    """The COSINE float finish takes the rescore route: one `ops.rescore`
    span a query chunk inside `ops.finish` (B = 3, or B = 2 and B = 1 with
    the bound cut to two queries' [queries, 640] distances), nothing else
    inside it and no `finish.*` counter."""
    if chunk_elems is not None:
        monkeypatch.setattr(rerank, "RESCORE_CHUNK_ELEMS", chunk_elems)
    ds = _dataset(1000, 24)
    q = np.random.default_rng(1).standard_normal((3, 24)).astype(np.float32)
    with profiling.recording() as rec:
        ds.search(q, 5, mode="exact")
    finish = rec.named("ops.finish")
    rescores = rec.named("ops.rescore")
    assert len(finish) == 1 and [r.parent for r in rescores] == [finish[0].id] * len(rescores)
    assert [r.attrs for r in rescores] == ([{"B": 3}] if chunk_elems is None else [{"B": 2}, {"B": 1}])
    assert [s.name for s in rec.spans if s.parent == finish[0].id] == ["ops.rescore"] * len(rescores)
    assert not any(name.startswith("finish.") for name in rec.counters)


def test_the_codes_finish_records_no_gather():
    ds = _dataset(1000, 24, "int8")
    q = np.random.default_rng(1).standard_normal((3, 24)).astype(np.float32)
    with profiling.recording() as rec:
        ds.search(q, 5, mode="quantized")
    assert len(rec.named("ops.rescore")) == 1
    assert not any(name.startswith("finish.") for name in rec.counters)
