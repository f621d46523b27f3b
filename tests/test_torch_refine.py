"""PyTorch port parity for mode="refine": int4 prefilter + int8 rescore.

The port's ops/refine.py against sqlite_vector_tpu/ops/refine.py on the
same packed int4 codes and int8 sidecar. The JAX function's prefilter runs
its tile loop here (the Pallas route is TPU-only); the port's runs K2's
twin for the matmul metrics. Both rescore the same candidate rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqlite_vector_tpu.ops import quantize as jquant
from sqlite_vector_tpu.ops import quantize4 as jq4
from sqlite_vector_tpu.ops.refine import int4_refine_topk as jax_refine
from sqlite_vector_tpu.types import DistanceMetric as JaxMetric
from sqlite_vector_tpu.types import QuantType as JaxQuantType
from sqlite_vector_tpu_torch.device import from_numpy
from sqlite_vector_tpu_torch.ops import refine
from sqlite_vector_tpu_torch.ops.refine import int4_refine_topk
from sqlite_vector_tpu_torch.types import DistanceMetric
from tests.test_torch_block_scan import MASKS, mask_case

METRICS = [m.value for m in DistanceMetric]


def refine_case(seed, n=700, dim=40, b=4, u8=False):
    """Rows (non-negative for a uint8 sidecar), queries with two
    self-matches, packed int4 codes and the AUTO-resolved int8 sidecar."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    if u8:
        x = np.abs(x)
    x[n - 1] = x[3]  # a duplicate row
    q = np.concatenate([x[[3, n // 2]], rng.standard_normal((b - 2, dim)).astype(np.float32)])
    packed, alpha, csq = jq4.quantize4_np(x)
    qt, s8, o8 = jquant.resolve_quant_params(
        float(x.min()), float(x.max()), bool((x < 0).any()), JaxQuantType.AUTO
    )
    codes8 = np.asarray(jquant.quantize_device(jnp.asarray(x), s8, o8, qt))
    return q, packed, alpha, csq, codes8, s8, o8


def run_both(q, packed, alpha, csq, codes8, s8, o8, metric, k, expand, valid):
    jv, ji = jax_refine(
        jnp.asarray(q), jnp.asarray(packed), jnp.asarray(alpha), jnp.asarray(csq),
        jnp.asarray(codes8), s8, o8, JaxMetric(metric), k,
        dim=q.shape[1], expand=expand, valid_count=valid,
    )
    gv, gi = int4_refine_topk(
        from_numpy(q), from_numpy(packed), from_numpy(alpha), from_numpy(csq),
        from_numpy(codes8), s8, o8, DistanceMetric(metric), k,
        dim=q.shape[1], expand=expand, valid_count=valid,
    )
    return (np.asarray(jv), np.asarray(ji)), (gv.numpy(), gi.numpy())


def assert_refine_close(jv, ji, gv, gi):
    np.testing.assert_allclose(gv, jv, rtol=1e-5, atol=1e-5)
    swapped = ji != gi
    np.testing.assert_allclose(gv[swapped], jv[swapped], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("u8", [False, True], ids=["int8", "uint8"])
def test_refine_matches_jax(metric, u8):
    """Same candidate set, same rescore: ids equal (any swap must be a tie
    within the tolerance) and values within rtol 1e-5 (float32 sums over d
    in another order; the candidate sets agree because the int4 prefilter
    keeps k*expand rows, far more than the prefilter values' ulp-level
    differences could reorder at the k-th refined row)."""
    case = refine_case(METRICS.index(metric) + 10 * u8, u8=u8)
    (jv, ji), (gv, gi) = run_both(*case, metric, 10, 4, 690)
    assert_refine_close(jv, ji, gv, gi)
    assert (gi < 690).all()
    if metric in ("L2", "SQUARED_L2"):
        # the earlier of two duplicate rows wins (at the int8 row's distance)
        assert gi[0, 0] == 3 and ji[0, 0] == 3


@pytest.mark.parametrize("metric", ["L2", "COSINE", "DOT"])
def test_refine_matches_jax_when_the_minima_choose_the_groups(metric):
    """N=3000, k=3, expand=2: the port's prefilter rescores 6 of 24 groups,
    chosen by K2's minima; the JAX prefilter scans every row."""
    case = refine_case(33 + METRICS.index(metric), n=3000, dim=24)
    (jv, ji), (gv, gi) = run_both(*case, metric, 3, 2, 2990)
    assert_refine_close(jv, ji, gv, gi)
    assert gi[0, 0] == 3 and gi[1, 0] == 1500  # the self-matches


@pytest.mark.parametrize("expand", [1, 3])
def test_refine_expand_and_padding_match_jax(expand):
    """k beyond the valid rows pads with -1 / +inf in both."""
    q, packed, alpha, csq, codes8, s8, o8 = refine_case(30, n=60, dim=16)
    (jv, ji), (gv, gi) = run_both(q, packed, alpha, csq, codes8, s8, o8, "L2", 25, expand, 20)
    np.testing.assert_array_equal(gi, ji)
    np.testing.assert_allclose(gv, jv, rtol=1e-6)
    assert (gi[:, 20:] == -1).all() and np.isinf(gv[:, 20:]).all()


def test_rescore_chunks_match_one_pass(monkeypatch):
    case = refine_case(31, n=900, dim=32, b=6)
    want = run_both(*case, "COSINE", 8, 4, 900)[1]
    seen = []
    real = refine.candidate_distances

    def spy(q, cand, m):
        seen.append(cand.shape[0])
        return real(q, cand, m)

    monkeypatch.setattr(refine, "_RESCORE_CHUNK_ELEMS", 32 * 32 * 2)  # 2 queries a chunk
    monkeypatch.setattr(refine, "candidate_distances", spy)
    got = run_both(*case, "COSINE", 8, 4, 900)[1]
    assert seen == [2, 2, 2]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_refine_on_the_twin_route_never_calls_the_tile_loop(monkeypatch):
    from sqlite_vector_tpu_torch.ops import quantize4

    def fail(*a, **kw):
        raise AssertionError("plain tile loop called")

    monkeypatch.setattr(quantize4, "int4_scan_topk_plain", fail)
    q, packed, alpha, csq, codes8, s8, o8 = refine_case(32)
    v, i = int4_refine_topk(
        from_numpy(q), from_numpy(packed), from_numpy(alpha), from_numpy(csq),
        from_numpy(codes8), s8, o8, DistanceMetric.DOT, 5, dim=40,
    )
    assert i.shape == (4, 5) and torch.isfinite(v).all()


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("metric", ["L2", "COSINE", "DOT", "L1"])
def test_masked_refine_matches_jax(kind, metric):
    """int4_refine_topk(row_mask=) against the JAX function with the same
    mask: the mask applies to stage 1 only (JAX ops/refine.py), so masked
    rows never reach the rescore; values within rtol 1e-5 and ids equal up
    to ties (assert_refine_close); fewer live rows than k pad."""
    q, packed, alpha, csq, codes8, s8, o8 = refine_case(50 + len(kind), n=700, dim=24)
    mask = mask_case(kind, 700, 3)
    k, expand, valid = 8, 3, 690
    jv, ji = jax_refine(
        jnp.asarray(q), jnp.asarray(packed), jnp.asarray(alpha), jnp.asarray(csq),
        jnp.asarray(codes8), s8, o8, JaxMetric(metric), k, dim=24, expand=expand,
        valid_count=valid, row_mask=jnp.asarray(mask),
    )
    gv, gi = int4_refine_topk(
        from_numpy(q), from_numpy(packed), from_numpy(alpha), from_numpy(csq),
        from_numpy(codes8), s8, o8, DistanceMetric(metric), k, dim=24,
        expand=expand, valid_count=valid, row_mask=torch.from_numpy(mask),
    )
    gv, gi, jv, ji = gv.numpy(), gi.numpy(), np.asarray(jv), np.asarray(ji)
    assert mask[gi[gi >= 0]].all() and (gi < valid).all()
    np.testing.assert_array_equal(np.isinf(gv), np.isinf(jv))
    fin = np.isfinite(jv)
    assert_refine_close(jv[fin], ji[fin], gv[fin], gi[fin])
    if kind == "fewer-than-k":
        assert (gi[:, 3:] == -1).all()
