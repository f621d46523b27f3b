"""The port's non-finite policies (ops/nonfinite.py and the routing to them)
against the JAX package on the same inputs, both on the CPU: the cases of
tests/test_nonfinite.py, each run through both packages.

Tolerances: values within rtol 1e-5 of the JAX package's (both sum float32
lanes, in another order), NaN and +-Inf positions equal; ids tie-aware
(tests/parity.py) against the JAX package's own policy distances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqlite_vector_tpu as jax_svt
import sqlite_vector_tpu_torch as svt
from sqlite_vector_tpu import oracle
from sqlite_vector_tpu.ops import nonfinite as jax_nonfinite
from sqlite_vector_tpu.types import DistanceMetric as JaxMetric
from sqlite_vector_tpu.types import VectorType as JaxVectorType
from sqlite_vector_tpu_torch.ops import nonfinite, streaming
from sqlite_vector_tpu_torch.ops.scan import fused_scan_topk
from sqlite_vector_tpu_torch.types import DistanceMetric, VectorType
from tests.parity import assert_topk_parity

pytestmark = pytest.mark.nonfinite_inputs

METRICS = ["L2", "SQUARED_L2", "COSINE", "DOT", "L1"]
FLOAT_TYPES = ["FLOAT32", "FLOAT16", "FLOATB16"]
DIM = 32
RTOL = 1e-5


def _special_base(rng, vtype, n=40):
    """Random rows plus one of each non-finite pattern (JAX
    tests/test_nonfinite.py:_special_base)."""
    base = rng.standard_normal((n, DIM)).astype(np.float32)
    base[3, 7] = np.nan            # single NaN lane
    base[5, :] = np.nan            # all-NaN row
    base[8, 2] = np.inf            # unmatched +Inf lane
    base[11, 4] = -np.inf          # unmatched -Inf lane
    base[14, :] = 0.0              # zero row (cosine zero-norm -> 1.0)
    return base.astype(JaxVectorType(vtype).np_dtype)


def pair(options, rows, storage="hbm"):
    jds = jax_svt.Dataset("nf", jax_svt.parse_options(options), storage=storage)
    pds = svt.Dataset("nf", svt.parse_options(options), device="cpu", storage=storage)
    np.testing.assert_array_equal(pds.add(rows), jds.add(rows))
    assert pds._has_nonfinite == jds._has_nonfinite
    return jds, pds


def assert_close(got, want, label=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, label
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{label}: NaN positions")
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want), err_msg=f"{label}: +inf")
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want), err_msg=f"{label}: -inf")
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=1e-6, err_msg=label)


def assert_same_search(jds, pds, q, k, **kw):
    """The port's top-k against the JAX dataset's: ids tie-aware against
    the JAX policy distances, values within RTOL."""
    q2 = np.atleast_2d(q)
    oracle_d = np.atleast_2d(np.asarray(jds.distances(q2), np.float64))
    if kw.get("ids_filter") is not None:
        oracle_d[:, ~np.isin(jds.ids, kw["ids_filter"])] = np.inf
    pid, pv = pds.search(q2, k, **kw)
    jid, jv = jds.search(q2, k, **kw)
    for i in range(q2.shape[0]):
        assert_topk_parity(jds.ids, oracle_d[i], pid[i], pv[i], k, rel_tol=RTOL, label=f"q{i}")
    assert_close(pv, jv, "search values")
    return pid, pv


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("vtype", FLOAT_TYPES)
def test_nonfinite_base_matches_jax_and_oracle(metric, vtype, rng):
    """Every metric x float dtype over rows holding every non-finite
    pattern: the port's search equals the JAX package's and the oracle's
    neighbor order; exact distances equal the JAX raw-policy values."""
    base = _special_base(rng, vtype)
    jds, pds = pair(f"dimension={DIM},type={vtype},distance={metric}", base)
    assert pds._has_nonfinite
    q = rng.standard_normal(DIM).astype(np.float32)
    pid, pv = assert_same_search(jds, pds, q, 40)
    # the oracle's order (the reference's exclusion rules)
    d = np.asarray(oracle.distance(
        q.astype(JaxVectorType(vtype).np_dtype), base, JaxMetric(metric), JaxVectorType(vtype)
    ), np.float64)
    d = np.where(np.isnan(d), np.inf, d)
    order = np.argsort(d, kind="stable")
    keep = order[~np.isposinf(d[order])]
    assert set(pid[0][pid[0] >= 0].tolist()) == set((keep + 1).tolist())
    assert_close(pds.distances(q), jds.distances(q), "distances")


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("vtype", FLOAT_TYPES)
def test_policy_pairwise_matches_jax(metric, vtype, rng):
    """policy_pairwise against the JAX function on the special rows, with
    NaN and +-Inf query lanes."""
    base = _special_base(rng, vtype).astype(np.float32)
    q = rng.standard_normal((4, DIM)).astype(np.float32)
    q[1, 7] = np.nan
    q[2, 2] = np.inf
    q[3, 4] = -np.inf
    got = nonfinite.policy_pairwise(
        torch.from_numpy(q), torch.from_numpy(base), DistanceMetric(metric), VectorType(vtype)
    )
    want = jax_nonfinite.policy_pairwise(
        jnp.asarray(q), jnp.asarray(base), JaxMetric(metric), JaxVectorType(vtype)
    )
    assert got.dtype == torch.float32
    assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("vtype", FLOAT_TYPES)
def test_policy_row_tiling_matches_untiled(metric, vtype, rng, monkeypatch):
    """Tiles of 16 rows (40 -> three, the last ragged) give the untiled
    values, and the tiled policy top-k the untiled one."""
    base = torch.from_numpy(_special_base(rng, vtype).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((3, DIM)).astype(np.float32))
    q[1, 7] = np.nan
    m, v = DistanceMetric(metric), VectorType(vtype)
    want = nonfinite._policy_impl(q, base, m, v)
    want_top = fused_scan_topk(q, base, m, 12, policy_vtype=v)
    monkeypatch.setattr(nonfinite, "POLICY_ROW_TILE", 16)
    assert nonfinite.policy_tile_rows(3, DIM) == 16
    assert_close(nonfinite.policy_pairwise(q, base, m, v).numpy(), nonfinite._snap(want).numpy())
    got_top = fused_scan_topk(q, base, m, 12, policy_vtype=v)
    assert_close(got_top[0].numpy(), want_top[0].numpy())
    np.testing.assert_array_equal(got_top[1].numpy(), want_top[1].numpy())


def test_policy_tile_rows_bound_the_cube(monkeypatch):
    assert nonfinite.policy_tile_rows(1, 384) == nonfinite.POLICY_ROW_TILE
    assert nonfinite.policy_tile_rows(64, 384) == (1 << 27) // (64 * 384)
    monkeypatch.setattr(nonfinite, "POLICY_CUBE_ELEMS", 10)
    assert nonfinite.policy_tile_rows(64, 384) == 1


@pytest.mark.parametrize("vtype", ["FLOAT16", "FLOATB16"])
def test_nan_lane_skipped_not_poisoned(vtype, rng):
    """A single NaN lane does not exclude the row: its distance runs over
    the other lanes."""
    arr = rng.standard_normal((20, DIM)).astype(JaxVectorType(vtype).np_dtype)
    arr[7, 0] = np.nan
    jds, pds = pair(f"dimension={DIM},type={vtype}", arr)
    q = arr[7].astype(np.float32)
    q[0] = 0.0
    pid, _ = assert_same_search(jds, pds, q, 20)
    assert 8 in pid[0].tolist()
    b = arr[7].astype(np.float32)
    expect = float(np.sqrt(np.sum((q[1:] - b[1:]) ** 2)))
    np.testing.assert_allclose(pds.distances(q)[7], expect, rtol=1e-3, atol=1e-3)
    assert_close(pds.distances(q), jds.distances(q))


def test_f32_nan_row_excluded(rng):
    """f32 plain math: a NaN row is never returned; its raw distance is NaN."""
    base = rng.standard_normal((30, DIM)).astype(np.float32)
    base[4, 9] = np.nan
    jds, pds = pair(f"dimension={DIM},type=FLOAT32", base)
    got_ids, got_vals = pds.search(base[10], 30)
    np.testing.assert_array_equal(got_ids, jds.search(base[10], 30)[0])
    assert 5 not in got_ids.tolist() and len(got_ids) == 29 and np.isfinite(got_vals).all()
    d = pds.distances(base[10])
    assert np.isnan(d[4])
    assert_close(d, jds.distances(base[10]))


def test_nonfinite_query_routes_policy(rng):
    """A non-finite query against a clean f16 dataset takes the policy path
    (lane skipped, not poisoned)."""
    base = rng.standard_normal((25, DIM)).astype(np.float16)
    jds, pds = pair(f"dimension={DIM},type=FLOAT16", base)
    assert not pds._has_nonfinite
    q = base[12].astype(np.float32).copy()
    q[3] = np.nan
    assert pds._nonfinite_policy(q) is VectorType.F16
    pid, pv = pds.search(q, 1)
    assert pid[0] == 13
    jid, jv = jds.search(q, 1)
    np.testing.assert_array_equal(pid, jid)
    assert_close(pv, jv)


def test_matched_inf_lanes_contribute_zero(rng):
    """LASSQ: matched same-sign Inf lanes are skipped; an unmatched one
    gives +Inf (the row is excluded)."""
    base = rng.standard_normal((10, DIM)).astype(np.float16)
    base[2, 5] = np.inf
    base[3, 5] = -np.inf
    jds, pds = pair(f"dimension={DIM},type=FLOAT16", base)
    q = base[2].astype(np.float32)
    pid, pv = assert_same_search(jds, pds, q, 10)
    assert pid[0, 0] == 3 and pv[0, 0] == 0.0
    assert 4 not in pid[0].tolist()


def test_f16_dot_inf_short_circuit(rng):
    """f16 DOT: an infinite product returns -Inf of its sign, so a +Inf
    product row is the best hit."""
    base = rng.standard_normal((12, DIM)).astype(np.float16)
    base[6, 0] = np.inf
    jds, pds = pair(f"dimension={DIM},type=FLOAT16,distance=DOT", base)
    q = np.zeros(DIM, np.float32)
    q[0] = 1.0
    pid, pv = pds.search(q, 3)
    assert pid[0] == 7 and pv[0] == -np.inf
    jid, jv = jds.search(q, 3)
    np.testing.assert_array_equal(pid, jid)
    assert_close(pv, jv)


def test_nonfinite_flag_persistence(tmp_path, rng):
    """The flag survives save/load in either package and either direction,
    and a reloaded dataset searches under the policies."""
    base = rng.standard_normal((20, DIM)).astype(np.float16)
    base[1, 1] = np.nan
    jds, pds = pair(f"dimension={DIM},type=FLOAT16", base)
    pds.save(str(tmp_path / "p"))
    jds.save(str(tmp_path / "j"))
    q = base[1].astype(np.float32)
    q[1] = 0.0
    want = jds.search(q, 5)
    for d in ("p", "j"):
        for kw in ({}, {"storage": "host", "mmap": True}):
            back = svt.Dataset.load(str(tmp_path / d), device="cpu", **kw)
            assert back._has_nonfinite
            got = back.search(q, 5)
            np.testing.assert_array_equal(got[0], want[0])
            assert_close(got[1], want[1])
    assert jax_svt.Dataset.load(str(tmp_path / "p"))._has_nonfinite


@pytest.mark.parametrize("vtype", ["FLOAT16", "FLOATB16"])
def test_host_streaming_policy(vtype, rng, monkeypatch):
    """storage='host' threads the policy through every streamed tile (tiles
    of 512 rows): search and distances equal the JAX host dataset's."""
    monkeypatch.setattr(streaming, "DEFAULT_TILE_BYTES", 512 * DIM * 2)
    base = rng.standard_normal((5000, DIM)).astype(JaxVectorType(vtype).np_dtype)
    base[100, 3] = np.nan
    base[2600, 5] = np.inf
    jds, pds = pair(f"dimension={DIM},type={vtype}", base, storage="host")
    q = base[100].astype(np.float32)
    q[3] = 0.0
    pid, _ = assert_same_search(jds, pds, q, 5)
    assert 101 in pid[0].tolist()
    assert_close(pds.distances(q), jds.distances(q))
    flt = np.arange(1, 5001)[::3]
    assert_same_search(jds, pds, q, 5, ids_filter=flt)


@pytest.mark.parametrize("metric", ["L2", "SQUARED_L2"])
@pytest.mark.parametrize("storage", ["hbm", "host"])
def test_f32_stream_raw_values_match_reference_semantics(metric, storage, rng):
    """f32 L2/SQUARED_L2 raw distances take the direct sum: +Inf on an Inf
    row (not the decomposition's NaN), NaN on a NaN row, equal to the JAX
    package and the oracle."""
    base = rng.standard_normal((64, DIM)).astype(np.float32)
    base[8, 2] = np.inf
    base[11, 4] = -np.inf
    base[3, 7] = np.nan
    jds, pds = pair(f"dimension={DIM},type=FLOAT32,distance={metric}", base, storage)
    q = rng.standard_normal(DIM).astype(np.float32)
    got = pds.distances(q)
    assert np.isposinf(got[8]) and np.isposinf(got[11]) and np.isnan(got[3])
    assert_close(got, jds.distances(q))
    want = oracle.snap_zero(oracle.distance(q[None], base, JaxMetric(metric), JaxVectorType.F32)[0])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_rerank_and_refine_fall_back_to_exact(rng):
    """f16 lane-skip data: rerank and refine return the policy-true
    neighbor set (they run as exact), as in the JAX package; approx too."""
    base = rng.standard_normal((64, 8)).astype(np.float16)
    base[5, 3] = np.nan
    jds, pds = pair("dimension=8,type=FLOAT16,distance=L2", base)
    for ds in (jds, pds):
        ds.quantize()
    q = base[5].astype(np.float32)
    q[3] = 1.0
    e_ids, e_vals = pds.search(q, 5)
    assert 6 in e_ids.tolist()
    for mode in ("rerank", "approx"):
        r_ids, r_vals = pds.search(q, 5, mode=mode)
        np.testing.assert_array_equal(r_ids, e_ids)
        np.testing.assert_array_equal(r_vals, e_vals)
        np.testing.assert_array_equal(r_ids, jds.search(q, 5, mode=mode)[0])
    # the int8 codes serve quantized mode unchanged (no policy there)
    np.testing.assert_array_equal(pds.search(q, 5, exact=False)[0], jds.search(q, 5, exact=False)[0])
    for ds in (jds, pds):
        ds.quantize(qtype="int4", refine=True)
    f_ids, f_vals = pds.search(q, 5, mode="refine")
    np.testing.assert_array_equal(f_ids, e_ids)
    np.testing.assert_array_equal(f_ids, jds.search(q, 5, mode="refine")[0])


def test_policy_outputs_are_nearly_zero_snapped():
    """Every emitted policy distance carries the near-zero snap; NaN lanes
    are skipped and an infinite product reads -inf."""
    q = np.zeros((1, 8), np.float32)
    q[0, 0] = 1.0
    rows = np.zeros((3, 8), np.float32)
    rows[0, 0] = 4e-7
    rows[1, 1] = np.nan
    rows[2, 0] = np.inf
    out = nonfinite.policy_pairwise(
        torch.from_numpy(q), torch.from_numpy(rows), DistanceMetric.DOT, VectorType.F16
    ).numpy()
    assert out[0, 0] == 0.0 and out[0, 1] == 0.0 and np.isneginf(out[0, 2])
    want = np.asarray(jax_nonfinite.policy_pairwise(
        jnp.asarray(q), jnp.asarray(rows), JaxMetric.DOT, JaxVectorType.F16
    ))
    np.testing.assert_array_equal(out, want)


def test_cosine_zero_norm_beats_nan(rng):
    """f32 COSINE (no raw policy): a zero-norm row reads 1.0 for a
    NaN-bearing query, every other row NaN, as in the JAX package."""
    rows = np.concatenate([np.zeros((1, 4), np.float32), rng.standard_normal((20, 4)).astype(np.float32)])
    jds, pds = pair("dimension=4,type=FLOAT32,distance=COSINE", rows)
    nanrow = np.array([1.0, np.nan, 2.0, 3.0], np.float32)
    d = pds.distances(nanrow)
    assert d[0] == 1.0 and np.isnan(d[1:]).all()
    assert_close(d, jds.distances(nanrow))


def test_needs_policy_tables_match_jax():
    for vtype in VectorType:
        for metric in DistanceMetric:
            jv, jm = JaxVectorType(vtype.value), JaxMetric(metric.value)
            assert nonfinite.needs_policy(vtype, metric) == jax_nonfinite.needs_policy(jv, jm)
            assert nonfinite.needs_raw_policy(vtype, metric) == jax_nonfinite.needs_raw_policy(jv, jm)
