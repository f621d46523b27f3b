"""PyTorch port parity for the packed-int4 block-minima scan (K2).

The twin (int4_block_minima_reference) is held against the JAX package's
Pallas kernels run in interpret mode on the CPU, as tests/test_quantize4.py
runs them (SVT_PALLAS_INT4_TILE_ROWS=256); int4_block_scan_topk against
pallas_int4_scan_topk, and the router's L1 route against the JAX tile
loop. The CUDA kernel itself is held against the twin in
tests/test_torch_kernel_cuda.py, on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqlite_vector_tpu.ops import pallas_int4
from sqlite_vector_tpu.ops import quantize4 as jq4
from sqlite_vector_tpu.types import DistanceMetric as JaxMetric
from sqlite_vector_tpu_torch.device import from_numpy
from sqlite_vector_tpu_torch.ops import block_scan, int4_scan
from sqlite_vector_tpu_torch.ops import quantize4 as q4
from sqlite_vector_tpu_torch.ops.block_scan import BLOCK
from sqlite_vector_tpu_torch.ops.int4_scan import (
    int4_block_minima,
    int4_block_minima_reference,
    int4_block_scan_topk,
)
from sqlite_vector_tpu_torch.types import DistanceMetric
from tests.parity import assert_topk_parity
from tests.test_torch_block_scan import MASKS, mask_case
from tests.test_torch_quantize4 import assert_int4_values_close, rows_with_edges

K2_METRICS = ["L2", "SQUARED_L2", "COSINE", "DOT"]


@pytest.fixture(autouse=True)
def small_pallas_tiles(monkeypatch):
    monkeypatch.setenv("SVT_PALLAS_INT4_TILE_ROWS", "256")


def case(seed, n, dim, b, *, overflow=False):
    """Packed codes of rows with a zero row, duplicates and non-finite
    elements (rows_with_edges), queries with a self-match; `overflow`
    scales every third row by 1e25 so that alpha^2 * csq overflows float32
    and the L2 surrogate reads inf - inf = NaN."""
    rng = np.random.default_rng(seed)
    x = rows_with_edges(rng, n, dim)
    q = rng.standard_normal((b, dim)).astype(np.float32)
    if overflow:
        with np.errstate(over="ignore"):  # the 1e25 row of rows_with_edges -> inf
            x[::3] *= 1e25
        q *= 1e25
    q[0] = np.where(np.isfinite(x[10]), x[10], 0)
    return q, jq4.quantize4_np(x)


def port_minima(q, packed, alpha, csq, metric, valid):
    qc, qs, _ = q4.quantize_query_int8(from_numpy(q))
    return int4_block_minima(
        qc, qs, from_numpy(packed), from_numpy(alpha), from_numpy(csq),
        DistanceMetric(metric), valid,
    ).numpy()


def minima_atol(q, packed, alpha, csq, metric, valid):
    """Per (query, group) bound on |port - JAX|: 1e-6 of the largest
    surrogate term among the group's rows below `valid`, in float64 from the
    port's query codes. The JAX kernels quantize the query inside jit, where
    absmax / 127 becomes a multiply by 1/127 (qscale an ulp off the spec
    value the port uses), and COSINE's rsqrt need not be correctly rounded
    there: either moves a row's surrogate by a few ulp of its terms,
    alpha^2 csq and 2 qscale alpha |dot| (L2 family), qscale alpha |dot|
    (DOT), |dot| / sqrt(csq) (COSINE). Rows whose terms overflow float32
    read +-inf or NaN (-> +inf) in both and are left out of the bound, so
    one 1e25 row cannot widen its group's tolerance."""
    qc, qs, _ = (t.numpy().astype(np.float64) for t in q4.quantize_query_int8(from_numpy(q)))
    dot = np.abs(qc @ q4.unpack4_np(packed, q.shape[1]).astype(np.float64).T)
    a, c = alpha.astype(np.float64), csq.astype(np.float64)
    with np.errstate(over="ignore", invalid="ignore"):
        if metric == "COSINE":
            terms = dot / np.sqrt(np.maximum(c, 1.0))
        else:
            terms = qs[:, None] * a * dot
            if metric != "DOT":
                terms = 2.0 * terms + a * a * c
        terms = np.where(terms <= np.finfo(np.float32).max, terms, 0.0)
    terms[:, valid:] = 0.0
    groups = -(-terms.shape[1] // BLOCK)
    terms = np.pad(terms, ((0, 0), (0, groups * BLOCK - terms.shape[1])))
    return 1e-6 * terms.reshape(len(q), groups, BLOCK).max(-1)


def assert_minima_close(got, want, atol):
    """+-inf positions equal, no NaN, finite minima within `atol`
    (minima_atol) entry by entry."""
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert not np.isnan(got).any()
    fin = np.isfinite(want)
    with np.errstate(invalid="ignore"):  # inf - inf where both are +-inf
        err = np.abs(got.astype(np.float64) - want)
    bad = fin & (err > atol)
    assert not bad.any(), (got[bad], want[bad], atol[bad])


@pytest.mark.parametrize("metric", K2_METRICS)
@pytest.mark.parametrize("dim", [16, 95, 384])
def test_twin_minima_match_jax_manual_kernel(metric, dim):
    q, (packed, alpha, csq) = case(K2_METRICS.index(metric) + dim, 700, dim, 3)
    n, valid = packed.shape[0], 650  # valid < n: rows >= 650 are +inf
    want = np.asarray(
        pallas_int4._int4_block_minima_manual(
            jnp.asarray(q), jnp.asarray(packed), jnp.asarray(alpha), jnp.asarray(csq),
            jnp.int32(valid), metric=JaxMetric(metric), dim=dim, interpret=True,
        )
    )[: q.shape[0], : -(-n // BLOCK)]
    got = port_minima(q, packed, alpha, csq, metric, valid)
    assert got.shape == want.shape
    assert_minima_close(got, want, minima_atol(q, packed, alpha, csq, metric, valid))


@pytest.mark.parametrize("metric", K2_METRICS)
@pytest.mark.parametrize("dim", [16, 95])
def test_twin_minima_match_jax_grid_kernel(metric, dim):
    q, (packed, alpha, csq) = case(40 + K2_METRICS.index(metric), 600, dim, 2)
    n, valid = packed.shape[0], 333
    want = np.asarray(
        pallas_int4._int4_block_minima(
            jnp.asarray(q), jnp.asarray(packed), jnp.asarray(alpha), jnp.asarray(csq),
            jnp.int32(valid), metric=JaxMetric(metric), dim=dim, interpret=True,
        )
    )[: q.shape[0], : -(-n // BLOCK)]
    got = port_minima(q, packed, alpha, csq, metric, valid)
    assert_minima_close(got, want, minima_atol(q, packed, alpha, csq, metric, valid))


@pytest.mark.parametrize("metric", K2_METRICS)
def test_overflowing_rows_rank_like_jax(metric):
    """alpha^2 * csq overflows: NaN surrogates are +inf in both packages,
    and a group can read +inf or -inf (DOT) without poisoning the others."""
    q, (packed, alpha, csq) = case(60, 700, 16, 2, overflow=True)
    want = np.asarray(
        pallas_int4._int4_block_minima_manual(
            jnp.asarray(q), jnp.asarray(packed), jnp.asarray(alpha), jnp.asarray(csq),
            jnp.int32(700), metric=JaxMetric(metric), dim=16, interpret=True,
        )
    )[:2, :6]
    got = port_minima(q, packed, alpha, csq, metric, 700)
    assert_minima_close(got, want, minima_atol(q, packed, alpha, csq, metric, 700))


def test_all_nan_group_reads_inf():
    """Every row of the first group overflows: its L2 minimum is +inf, not
    NaN, and the other groups keep their finite minima."""
    rng = np.random.default_rng(61)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    x[:BLOCK] *= 1e25
    packed, alpha, csq = jq4.quantize4_np(x)
    q = rng.standard_normal((1, 8)).astype(np.float32)
    got = port_minima(q, packed, alpha, csq, "L2", 300)
    assert np.isposinf(got[0, 0]) and np.isfinite(got[0, 1:]).all()


@pytest.mark.parametrize("metric", K2_METRICS)
@pytest.mark.parametrize("n, k", [(900, 12), (3000, 5)], ids=["all-groups", "minima-choose"])
def test_block_scan_topk_matches_jax(metric, n, k):
    """At N=900, k=12 every group is rescored; at N=3000, k=5 the finish
    rescores 5 of 24 groups, so the minima decide which rows can win."""
    q, (packed, alpha, csq) = case(70 + K2_METRICS.index(metric), n, 48, 4)
    valid = n - 50
    jm = JaxMetric(metric)
    jv, ji = pallas_int4.pallas_int4_scan_topk(
        jnp.asarray(q), jnp.asarray(packed), jnp.asarray(alpha), jnp.asarray(csq),
        jm, k, dim=48, valid_count=valid, interpret=True,
    )
    gv, gi = int4_block_scan_topk(
        from_numpy(q), from_numpy(packed), from_numpy(alpha), from_numpy(csq),
        DistanceMetric(metric), k, dim=48, valid_count=valid,
    )
    oracle = np.asarray(
        jq4.int4_scan_distances(
            jnp.asarray(q), jnp.asarray(packed), jnp.asarray(alpha), jnp.asarray(csq), jm, dim=48
        )
    ).astype(np.float64)
    oracle[:, valid:] = np.inf
    for i in range(q.shape[0]):
        assert_topk_parity(
            np.arange(n), oracle[i], gi[i].numpy(), gv[i].numpy(), k,
            rel_tol=1e-5, label=f"{metric}[{i}]",
        )
    assert_int4_values_close(gv.numpy(), np.asarray(jv), q, metric)


@pytest.mark.parametrize("metric", ["L2", "COSINE", "DOT", "L1"])
def test_router_matches_jax_tile_loop(metric):
    """int4_scan_topk: the four matmul metrics through K2's route, L1 through
    the plain tile loop; all against the JAX tile loop on the same codes."""
    q, (packed, alpha, csq) = case(80, 500, 24, 3)
    k, valid = 7, 480
    jv, ji = jq4._int4_scan_topk_impl(
        jnp.asarray(q), jnp.asarray(packed), jnp.asarray(alpha), jnp.asarray(csq),
        jnp.int32(valid), jnp.zeros((0,), bool), metric=JaxMetric(metric), k=k,
        dim=24, row_tile=jq4.INT4_ROW_TILE, has_mask=False,
    )
    gv, gi = q4.int4_scan_topk(
        from_numpy(q), from_numpy(packed), from_numpy(alpha), from_numpy(csq),
        DistanceMetric(metric), k, dim=24, valid_count=valid,
    )
    assert_int4_values_close(gv.numpy(), np.asarray(jv), q, metric)
    for i in range(q.shape[0]):  # ids equal up to ties
        same = np.asarray(ji)[i] == gi[i].numpy()
        np.testing.assert_allclose(gv[i].numpy()[~same], np.asarray(jv)[i][~same], rtol=1e-5)


def test_router_sends_l1_to_the_tile_loop_and_the_rest_to_k2(monkeypatch):
    q, (packed, alpha, csq) = case(81, 300, 16, 2)
    args = (from_numpy(q), from_numpy(packed), from_numpy(alpha), from_numpy(csq))
    calls = []
    real = int4_scan.int4_block_minima

    def spy(*a):
        calls.append(a[5])
        return real(*a)

    monkeypatch.setattr(int4_scan, "int4_block_minima", spy)
    for metric in DistanceMetric:
        q4.int4_scan_topk(*args, metric, 5, dim=16)
    assert calls == [m for m in DistanceMetric if m is not DistanceMetric.L1]


@pytest.mark.parametrize("limit", [3000, 20000])
@pytest.mark.parametrize("metric", ["SQUARED_L2", "COSINE"])
def test_finish_chunks_stay_under_the_element_bound(monkeypatch, limit, metric):
    """A small bound splits the finish over queries and candidates: the
    result is unchanged and no unpacked candidate block holds more elements
    than the bound."""
    q, (packed, alpha, csq) = case(90, 1500, 24, 4)
    args = (from_numpy(q), from_numpy(packed), from_numpy(alpha), from_numpy(csq))
    tm = DistanceMetric(metric)
    want = int4_block_scan_topk(*args, tm, 9, dim=24, valid_count=1400)
    seen = []
    real = int4_scan.int4_distances

    def spy(qc, qs, qq, qf, codes, a, c, m):
        seen.append(codes.numel())
        return real(qc, qs, qq, qf, codes, a, c, m)

    monkeypatch.setattr(block_scan, "_FINISH_CHUNK_ELEMS", limit)
    monkeypatch.setattr(int4_scan, "int4_distances", spy)
    got = int4_block_scan_topk(*args, tm, 9, dim=24, valid_count=1400)
    assert len(seen) > 4 and max(seen) <= limit
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_twin_chunks_match_one_pass(monkeypatch):
    q, (packed, alpha, csq) = case(91, 1000, 40, 3)
    qc, qs, _ = q4.quantize_query_int8(from_numpy(q))
    args = (qc, qs, from_numpy(packed), from_numpy(alpha), from_numpy(csq), DistanceMetric.L2, 990)
    whole = int4_block_minima_reference(*args)
    monkeypatch.setattr(int4_scan, "_TWIN_CHUNK_ELEMS", 300)  # 128-row chunks
    assert torch.equal(int4_block_minima_reference(*args), whole)


@pytest.mark.parametrize(
    "d,tiles",
    [
        # 384 codes: 192 packed bytes, 3 chunks of 64, 384 bytes a query
        (384, {1: 8, 8: 8, 9: 16, 16: 16, 17: 32, 33: 64, 64: 64, 65: 64, 200: 64}),
        (9, {1: 8, 200: 64}),
        # the widest rows of each tile (64 queries x 2,048 plane bytes =
        # 131,072), and one code past them (one more 64-byte chunk)
        (2048, {1: 8, 64: 64, 200: 64}),
        (2049, {33: 32, 64: 32}),
        (4096, {32: 32, 64: 32}),
        (4097, {17: 16, 32: 16}),
        (8192, {1: 8, 16: 16, 64: 16}),
        (8193, {9: 8, 16: 8}),
        (16384, {1: 8, 65: 8}),
        (16385, {1: 0, 64: 0}),
    ],
    ids=str,
)
def test_k2_query_tile_is_the_narrowest_that_covers_b_and_fits(d, tiles):
    for b, want in tiles.items():
        assert int4_scan.k2_query_tile(d, b) == want, b
        if want:
            per_query = 2 * 64 * -(-q4.packed_width(d) // 64)
            assert want * per_query <= int4_scan._K2_QUERY_BYTES


def test_k2_wide_query_tiles_stay_within_the_exact_float_conversion():
    """The tensor-core body converts the dots of 32- and 64-query tiles to
    float32 by adding them to 1.5 * 2^23, exact while |dot| <= 8 * 128 * d
    <= 2^22, so d <= 4,096; its launcher refuses those tiles past that, so
    k2_query_tile must never pick them there."""
    for d in range(1, 16385):
        if int4_scan.k2_query_tile(d, 200) >= 32:
            assert d <= 4096, d
    assert int4_scan.k2_query_tile(4096, 200) == 32


def test_k2_body_routes_by_d_alone():
    """The tensor-core body up to d = 16,384 (8 queries of 16,384 plane
    bytes fill the 131,072-byte budget), the CUDA-core body past it."""
    for d in (1, 9, 16, 95, 384, 768, 2049, 16383, 16384):
        assert int4_scan.k2_body(d) == "mma", d
    for d in (16385, 20000, 2**21 - 1):
        assert int4_scan.k2_body(d) == "simt", d


def test_launch_k2_takes_only_cuda_tensors():
    """The CPU routes to the twin before any body; a body asked for CPU
    tensors raises instead of running the twin, and counts nothing."""
    qc = torch.zeros((2, 8), dtype=torch.int8)
    args = (qc, torch.ones(2), torch.zeros((10, 4), dtype=torch.uint8), torch.ones(10),
            torch.ones(10, dtype=torch.int32), DistanceMetric.L2, 10, None)
    before = (int4_block_minima.launches, dict(int4_block_minima.body_launches))
    for body in ("mma", "simt"):
        with pytest.raises(ValueError, match="unsupported device"):
            int4_scan._launch_k2(*args, body)
    int4_block_minima(*args[:7])
    assert (int4_block_minima.launches, int4_block_minima.body_launches) == before


def test_int4_block_minima_rejects_what_the_kernel_does_not_take():
    qc = torch.zeros((2, 8), dtype=torch.int8)
    qs = torch.ones(2)
    packed = torch.zeros((10, 4), dtype=torch.uint8)
    alpha, csq = torch.ones(10), torch.ones(10, dtype=torch.int32)
    ok = (qc, qs, packed, alpha, csq)
    assert int4_block_minima(*ok, DistanceMetric.L2, 10).shape == (2, 1)
    bad = [
        ((qc, qs, torch.zeros((10, 5), dtype=torch.uint8), alpha, csq), DistanceMetric.L2, 10),
        ((qc.float(), qs, packed, alpha, csq), DistanceMetric.L2, 10),
        ((qc, qs, packed, alpha, csq.long()), DistanceMetric.L2, 10),
        (ok, DistanceMetric.L1, 10),
        (ok, DistanceMetric.L2, 11),
    ]
    for tensors, metric, valid in bad:
        with pytest.raises(ValueError):
            int4_block_minima(*tensors, metric, valid)


# -- row masks ---------------------------------------------------------------

@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("metric", K2_METRICS)
def test_masked_twin_minima_are_group_minima_of_live_rows(kind, metric):
    """The masked twin's minima equal the per-group minimum of the per-row
    surrogates (the JAX _surrogate_block's ops, computed here for every
    row) with masked rows and rows >= valid at +inf, bit for bit; a group
    with no live row reads +inf."""
    q, (packed, alpha, csq) = case(120 + K2_METRICS.index(metric), 700, 40, 3)
    mask = mask_case(kind, 700, K2_METRICS.index(metric))
    qc, qs, _ = q4.quantize_query_int8(from_numpy(q))
    args = (qc, qs, from_numpy(packed), from_numpy(alpha), from_numpy(csq), DistanceMetric(metric), 650)
    got = int4_block_minima(*args, torch.from_numpy(mask))
    dot = qc.float() @ q4.unpack4(from_numpy(packed), 40).float().T
    sv = int4_scan._surrogate(dot, qs, from_numpy(alpha), from_numpy(csq), DistanceMetric(metric))
    keep = torch.from_numpy(mask) & (torch.arange(700) < 650)
    sv = torch.where(keep & ~torch.isnan(sv), sv, torch.inf)
    sv = torch.nn.functional.pad(sv, (0, 6 * BLOCK - 700), value=torch.inf)
    assert torch.equal(got, sv.view(3, 6, BLOCK).amin(-1))
    if kind in ("dead-group", "all-masked"):
        assert torch.isinf(got[:, 1]).all()


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("metric", ["L2", "SQUARED_L2", "COSINE", "DOT", "L1"])
def test_masked_scan_matches_jax_masked_route(kind, metric):
    """int4_scan_topk(row_mask=) (K2's route; L1 the plain tile loop)
    against the JAX masked route, its tile loop: values within the int4
    tolerances (assert_int4_values_close), ids equal up to ties; masked
    rows never come back; fewer live rows than k pad with -1 / +inf. With
    the two partial masks k = 4 of the 6 groups, so K2's masked minima
    choose the groups rescored."""
    q, (packed, alpha, csq) = case(130 + len(kind), 700, 24, 3)
    mask = mask_case(kind, 700, 11)
    k, valid = (4 if kind in ("half", "dead-group") else 9), 650
    jv, ji = jq4.int4_scan_topk(
        jnp.asarray(q), jnp.asarray(packed), jnp.asarray(alpha), jnp.asarray(csq),
        JaxMetric(metric), k, dim=24, valid_count=valid, row_mask=jnp.asarray(mask),
    )
    gv, gi = q4.int4_scan_topk(
        from_numpy(q), from_numpy(packed), from_numpy(alpha), from_numpy(csq),
        DistanceMetric(metric), k, dim=24, valid_count=valid,
        row_mask=torch.from_numpy(mask),
    )
    gv, gi, jv, ji = gv.numpy(), gi.numpy(), np.asarray(jv), np.asarray(ji)
    live = mask & (np.arange(700) < valid)
    assert live[gi[gi >= 0]].all()
    assert_int4_values_close(gv, jv, q, metric)
    swapped = gi != ji
    np.testing.assert_allclose(gv[swapped], jv[swapped], rtol=1e-5)
    if kind == "all-masked":
        assert (gi == -1).all() and np.isinf(gv).all()
    if kind == "fewer-than-k":
        assert ((gi >= 0).sum(1) <= 3).all() and (gi[:, 3:] == -1).all()
