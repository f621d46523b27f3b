"""PyTorch port parity for the block-minima scan (K1).

The twin (block_minima_reference) is held against the JAX package's Pallas
kernels run in interpret mode on the CPU, as tests/test_pallas_scan.py runs
them; block_scan_topk against pallas_scan_topk. The CUDA kernel itself is
held against the twin in tests/test_torch_kernel_cuda.py, on a card.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from sqlite_vector_tpu.ops import distance as jax_distance
from sqlite_vector_tpu.ops import pallas_scan
from sqlite_vector_tpu.types import DistanceMetric as JaxMetric
from sqlite_vector_tpu_torch.device import from_numpy
from sqlite_vector_tpu_torch.ops import block_scan, rerank
from sqlite_vector_tpu_torch.ops.block_scan import (
    BLOCK,
    block_minima,
    block_minima_reference,
    block_scan_topk,
)
from sqlite_vector_tpu_torch.ops.scan import fused_scan_topk, scan_topk
from sqlite_vector_tpu_torch.types import DistanceMetric
from tests.parity import REL_TOL_BY_TYPE, assert_topk_parity

DTYPES = {
    "FLOAT32": np.float32,
    "FLOAT16": np.float16,
    "FLOATB16": ml_dtypes.bfloat16,
    "UINT8": np.uint8,
    "INT8": np.int8,
}
METRICS = [m.value for m in DistanceMetric]


def rows(rng, dtype, shape):
    if dtype in (np.uint8, np.int8):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max + 1, shape).astype(dtype)
    return rng.standard_normal(shape).astype(np.float32).astype(dtype)


def scan_case(vtype, seed, n=700, d=100, b=3):
    """Unaligned shapes with a NaN row (floats), a duplicated row, a
    zero-norm row and a self-match."""
    rng = np.random.default_rng(seed)
    base = rows(rng, DTYPES[vtype], (n, d))
    q = rows(rng, DTYPES[vtype], (b, d))
    if vtype not in ("UINT8", "INT8"):
        base[5] = np.nan
    base[400] = base[10]
    base[200] = 0
    q[0] = base[10]
    return q, base


def assert_minima_match(got, want, vtype):
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    if vtype in ("UINT8", "INT8"):
        np.testing.assert_array_equal(got, want)
        return
    tol = 1e-5 if vtype == "FLOAT32" else REL_TOL_BY_TYPE[vtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("vtype", list(DTYPES))
@pytest.mark.parametrize("metric", METRICS)
def test_twin_minima_match_jax_manual_kernel(vtype, metric):
    q, base = scan_case(vtype, METRICS.index(metric))
    n, valid = base.shape[0], 650  # valid < n: rows >= 650 are +inf
    want = np.asarray(
        pallas_scan._pallas_block_minima_manual(
            q, base, np.int32(valid), metric=JaxMetric(metric), interpret=True
        )
    )[: q.shape[0], : -(-n // BLOCK)]
    got = block_minima(from_numpy(q), from_numpy(base), DistanceMetric(metric), valid)
    assert_minima_match(got.numpy(), want, vtype)


@pytest.mark.parametrize("vtype", ["FLOAT32", "INT8"])
@pytest.mark.parametrize("metric", METRICS)
def test_twin_minima_match_jax_grid_kernel(vtype, metric):
    q, base = scan_case(vtype, 40 + METRICS.index(metric), n=500, d=40, b=2)
    n, valid = base.shape[0], 333
    if vtype == "INT8":
        bsq = (base.astype(np.int32) ** 2).sum(-1)
    else:
        bsq = (base.astype(np.float32) ** 2).sum(-1)
    want = np.asarray(
        pallas_scan._pallas_block_minima(
            q, base, bsq, np.int32(valid), metric=JaxMetric(metric), interpret=True
        )
    )[: q.shape[0], : -(-n // BLOCK)]
    got = block_minima_reference(
        from_numpy(q), from_numpy(base), DistanceMetric(metric), valid
    )
    assert_minima_match(got.numpy(), want, vtype)


@pytest.mark.parametrize("vtype", ["FLOAT32", "FLOATB16", "UINT8"])
@pytest.mark.parametrize("metric", METRICS)
def test_block_scan_topk_matches_jax(vtype, metric):
    q, base = scan_case(vtype, 70 + METRICS.index(metric))
    valid, k = 650, 12
    jm, tm = JaxMetric(metric), DistanceMetric(metric)
    want_v, want_i = pallas_scan.pallas_scan_topk(
        q, base, jm, k, valid_count=valid, interpret=True, variant="manual"
    )
    got_v, got_i = block_scan_topk(from_numpy(q), from_numpy(base), tm, k, valid_count=valid)
    got_v, got_i = got_v.numpy(), got_i.numpy()
    if vtype == "UINT8":
        # integer-domain distances are exact: identical ids and values
        np.testing.assert_array_equal(got_i, np.asarray(want_i))
        np.testing.assert_array_equal(got_v, np.asarray(want_v))
        return
    # tie-aware against the JAX package's full distance matrix
    oracle = np.asarray(jax_distance.pairwise_distance(q, base, jm)).astype(np.float64)
    oracle[:, valid:] = np.inf
    for i in range(q.shape[0]):
        assert_topk_parity(
            np.arange(base.shape[0]), oracle[i], got_i[i], got_v[i], k,
            rel_tol=REL_TOL_BY_TYPE[vtype], label=f"{vtype}/{metric}[{i}]",
        )
    np.testing.assert_allclose(
        got_v, np.asarray(want_v), rtol=REL_TOL_BY_TYPE[vtype], atol=1e-5
    )


def test_l2_snap_in_squared_domain():
    """The pre-ranking snap is NEARLY_ZERO^2 for L2 (squared until the
    finish's sqrt): a true 9.5e-4 neighbor must not be zeroed and tie with
    an exact duplicate (JAX: tests/test_pallas_scan.py)."""
    rng = np.random.default_rng(0)
    q = np.zeros((1, 8), np.float32)
    q[0, 0] = 1e-3
    base = rng.standard_normal((200, 8)).astype(np.float32)
    base[3] = q[0]
    base[3, 1] = 9.5e-4  # squared distance 9.02e-7 > NEARLY_ZERO^2
    base[124] = q[0]  # exact duplicate: true distance 0
    want_v, want_i = pallas_scan.pallas_scan_topk(q, base, JaxMetric.L2, 2, interpret=True)
    got_v, got_i = block_scan_topk(from_numpy(q), from_numpy(base), DistanceMetric.L2, 2)
    assert got_i.tolist() == [[124, 3]] == np.asarray(want_i).tolist()
    assert float(got_v[0, 0]) == 0.0
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-6)


def test_near_zero_snap_ties_go_to_earliest_row():
    """DOT distances within NEARLY_ZERO snap to 0 before ranking, so the
    earliest row wins among them, exactly as the plain scan ranks them."""
    base = np.zeros((600, 32), np.float32)
    base[2, 0] = 1e-7  # raw -4e-7, snapped to 0
    q = np.zeros((1, 32), np.float32)
    q[0, 0] = 4.0
    got_v, got_i = block_scan_topk(from_numpy(q), from_numpy(base), DistanceMetric.DOT, 1)
    want_v, want_i = pallas_scan.pallas_scan_topk(q, base, JaxMetric.DOT, 1, interpret=True)
    plain_v, plain_i = scan_topk(from_numpy(q), from_numpy(base), DistanceMetric.DOT, 1)
    assert int(got_i[0, 0]) == int(np.asarray(want_i)[0, 0]) == int(plain_i[0, 0]) == 0
    assert float(got_v[0, 0]) == float(plain_v[0, 0]) == 0.0


def test_cosine_zero_norm_query_beats_nan_group():
    """A zero-norm query scores 1.0 against every row, NaN rows included
    (zero norm is applied last), so a fully-NaN first group still yields
    row 0 first."""
    rng = np.random.default_rng(1)
    base = rng.standard_normal((700, 64)).astype(np.float32)
    base[:128] = np.nan
    q = np.zeros((1, 64), np.float32)
    want_v, want_i = pallas_scan.pallas_scan_topk(q, base, JaxMetric.COSINE, 3, interpret=True)
    got_v, got_i = block_scan_topk(from_numpy(q), from_numpy(base), DistanceMetric.COSINE, 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert int(got_i[0, 0]) == 0 and float(got_v[0, 0]) == 1.0


def test_k_beyond_valid_rows_pads():
    rng = np.random.default_rng(2)
    base = np.zeros((512, 16), np.float32)
    base[:7] = rng.standard_normal((7, 16)).astype(np.float32) + 3.0
    q = np.zeros((1, 16), np.float32)
    got_v, got_i = block_scan_topk(
        from_numpy(q), from_numpy(base), DistanceMetric.L2, 20, valid_count=7
    )
    assert set(got_i[0, :7].tolist()) == set(range(7))
    assert (got_i[0, 7:] == -1).all() and torch.isinf(got_v[0, 7:]).all()


def test_router_sends_scans_to_block_scan():
    rng = np.random.default_rng(4)
    base = from_numpy(rows(rng, np.float32, (300, 16)))
    q = base[:2].clone()
    got = fused_scan_topk(q, base, DistanceMetric.L2, 3, valid_count=290)
    want = block_scan_topk(q, base, DistanceMetric.L2, 3, valid_count=290)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[1][:, 0].tolist() == [0, 1]


@pytest.mark.parametrize("limit", [3000, 6144])
@pytest.mark.parametrize("vtype", ["FLOAT32", "FLOAT16", "UINT8", "INT8"])
@pytest.mark.parametrize("metric", ["L2", "COSINE", "L1"])
def test_finish_chunks_stay_under_the_element_bound(monkeypatch, limit, vtype, metric):
    """A small bound splits the finish over queries (its [queries, 1,152]
    distances: 2 a chunk at 3000, all 4 at 6144) and its gathered rescore
    over queries and candidates (1 query a slice, 125 or 256 candidates):
    the result is unchanged, and no gathered block of candidate rows holds
    more elements than the bound."""
    q, base = scan_case(vtype, 90 + METRICS.index(metric), n=1500, d=24, b=4)
    q, base, tm = from_numpy(q), from_numpy(base), DistanceMetric(metric)
    want = block_scan_topk(q, base, tm, 9, valid_count=1400)
    seen = []
    rescore = block_scan.candidate_distances

    def spy(qs, cand, m):
        seen.append(cand.numel())
        return rescore(qs, cand, m)

    monkeypatch.setattr(rerank, "RESCORE_CHUNK_ELEMS", limit)
    monkeypatch.setattr(block_scan, "candidate_distances", spy)
    got = block_scan_topk(q, base, tm, 9, valid_count=1400)
    assert len(seen) > 4 and max(seen) <= limit
    assert torch.equal(got[1], want[1])
    if vtype in ("UINT8", "INT8"):
        assert torch.equal(got[0], want[0])
    else:  # a float dot may round differently in a smaller matmul
        torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)


def test_block_minima_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((2, 8), dtype=torch.float32)
    with pytest.raises(ValueError):
        block_minima(q, torch.zeros((10, 8), dtype=torch.float64), DistanceMetric.L2, 10)
    with pytest.raises(ValueError):
        block_minima(q, torch.zeros((10, 9)), DistanceMetric.L2, 10)
    with pytest.raises(ValueError):
        block_minima(q, torch.zeros((10, 8)), DistanceMetric.L2, 11)



# -- the int8/u8 finish's rescore (rescore_groups) ---------------------------

RESCORE_METRICS = ["L2", "SQUARED_L2", "COSINE", "DOT"]


@pytest.mark.parametrize("vtype", ["FLOAT32", "FLOATB16", "UINT8", "INT8"])
@pytest.mark.parametrize("metric", METRICS)
def test_finish_rescores_codes_under_the_dot_family_with_rescore_groups(monkeypatch, vtype, metric):
    """u8/i8 codes and float rows under L2, SQUARED_L2, COSINE and DOT
    take rescore_groups (one call for the one query chunk); L1 rows keep
    the gathered rescore; the result is the same either way."""
    q, base = scan_case(vtype, 300 + METRICS.index(metric))
    tq, tb, tm = from_numpy(q), from_numpy(base), DistanceMetric(metric)
    calls = []
    real = block_scan.rescore_groups

    def spy(*a, **kw):
        calls.append(a[0].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(block_scan, "rescore_groups", spy)
    got = block_scan_topk(tq, tb, tm, 7, valid_count=690)
    takes = metric != "L1"
    assert calls == ([3] if takes else [])
    monkeypatch.setattr(block_scan, "rescore_takes", lambda dtype, m: False)
    want = block_scan_topk(tq, tb, tm, 7, valid_count=690)
    assert len(calls) == len(set(calls)) and all(torch.equal(g, w) for g, w in zip(got, want))


def test_int4_finish_keeps_the_gathered_rescore(monkeypatch):
    from sqlite_vector_tpu_torch.ops.int4_scan import int4_block_scan_topk
    from sqlite_vector_tpu_torch.ops.quantize4 import quantize4_device

    def fail(*a, **kw):
        raise AssertionError("int4 rescored with rescore_groups")

    monkeypatch.setattr(block_scan, "rescore_groups", fail)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((700, 32)).astype(np.float32))
    packed, alpha, csq = quantize4_device(x)[:3]
    for metric in ("L2", "COSINE", "DOT"):
        int4_block_scan_topk(x[:3], packed, alpha, csq, DistanceMetric(metric), 5, dim=32)


def test_cpu_tensors_never_launch_the_rescore_kernel(monkeypatch):
    from sqlite_vector_tpu_torch.ops import _build

    def fail(*a, **kw):
        raise AssertionError("a kernel launch for CPU tensors")

    monkeypatch.setattr(block_scan, "_launch_rescore", fail)
    monkeypatch.setattr(_build, "load_library", fail)
    before = block_scan.rescore_groups.launches
    for vtype in ("UINT8", "INT8", "FLOAT32", "FLOAT16", "FLOATB16"):
        q, base = scan_case(vtype, 40)
        for metric in RESCORE_METRICS:
            block_scan_topk(from_numpy(q), from_numpy(base), DistanceMetric(metric), 5)
    assert block_scan.rescore_groups.launches == before


def rescore_case(dtype, n, d, b, seed):
    """numpy codes over their whole range with rows at the extremes (all
    top, all bottom, alternating), a zero row and a duplicate; query 0 a
    self-match, query 1 zero, query 2 at the top."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    base = rng.integers(info.min, info.max + 1, (n, d)).astype(dtype)
    q = rng.integers(info.min, info.max + 1, (b, d)).astype(dtype)
    base[1], base[2], base[3] = info.max, info.min, 0
    base[4, ::2], base[4, 1::2] = info.min, info.max
    base[n - 3] = base[10]
    q[0] = base[10]
    q[1:2] = 0
    q[2:3] = info.max
    return torch.from_numpy(q), torch.from_numpy(base)


def gathered_rescore(q, base, gidx, valid, metric, row_mask=None):
    """The gathered path, written out as the finish ran it before the
    kernel: rows gathered whole, candidate_distances, _rank_ready, keep."""
    n = base.shape[0]
    pos = (gidx[:, :, None] * BLOCK + torch.arange(BLOCK)).reshape(gidx.shape[0], -1)
    d = block_scan._rank_ready(block_scan.candidate_distances(q, base[pos.clamp(0, n - 1)], metric), metric)
    keep = (pos < valid) & (pos < n)
    if row_mask is not None:
        keep &= row_mask[pos.clamp(0, n - 1)]
    return torch.where(keep, d, torch.inf)


@pytest.mark.parametrize("dtype", [np.uint8, np.int8], ids=["u8", "i8"])
@pytest.mark.parametrize("metric", RESCORE_METRICS)
@pytest.mark.parametrize("d", [5, 95, 384, 768])
@pytest.mark.parametrize("b", [1, 2, 32, 62, 65])
def test_rescore_twin_equals_the_gathered_path(dtype, metric, d, b):
    """rescore_groups on CPU tensors (its twin) equals the per-row values of
    the plain [B, N] integer distances, bit for bit, over N = 1,000 (a
    ragged last group), three groups a query (the first and the last among
    them), unmasked and with valid < N and a row mask; the latter also
    equals the gathered path."""
    n = 1000
    q, base = rescore_case(dtype, n, d, b, seed=d + b)
    gen = torch.Generator().manual_seed(b)
    gidx = torch.stack([torch.tensor([0, 7, 1 + int(torch.randint(6, (1,), generator=gen))]) for _ in range(b)])
    gidx = torch.sort(gidx, dim=-1).values
    mask = np.random.default_rng(d).random(n) < 0.5
    tm = DistanceMetric(metric)
    pos = (gidx[:, :, None] * BLOCK + torch.arange(BLOCK)).reshape(b, -1)
    for valid, row_mask in ((n, None), (n - 77, mask)):
        tmask = None if row_mask is None else torch.from_numpy(row_mask)
        got = block_scan.rescore_groups(q, base, gidx, valid, tm, tmask)
        if row_mask is not None:
            assert torch.equal(got, gathered_rescore(q, base, gidx, valid, tm, tmask))
        plain = per_row(q, base, tm, valid, np.ones(n, bool) if row_mask is None else row_mask)
        assert torch.equal(got, torch.gather(plain, 1, pos))


@pytest.mark.parametrize("d", [16513, 16520])
def test_rescore_twin_wraps_int32_terms_of_wide_u8_codes(d):
    """u8 codes near the top past d = 16,512: q_sq + c_sq passes 2^31 and
    wraps, and the squared L2 is still exact."""
    rng = np.random.default_rng(d)
    base = torch.from_numpy(rng.integers(250, 256, (300, d)).astype(np.uint8))
    q = torch.full((2, d), 255, dtype=torch.uint8)
    q[1] = base[7]
    gidx = torch.tensor([[0, 2], [0, 1]])
    assert 2 * int((q[0].long() ** 2).sum()) >= 2**31
    for metric in RESCORE_METRICS:
        tm = DistanceMetric(metric)
        got = block_scan.rescore_groups(q, base, gidx, 300, tm)
        assert torch.equal(got, gathered_rescore(q, base, gidx, 300, tm))
    got = block_scan.rescore_groups(q, base, gidx, 300, DistanceMetric.SQUARED_L2)
    assert torch.equal(got[0, :128], ((q[0].long() - base[:128].long()) ** 2).sum(-1).float())
    assert float(got[1, 7]) == 0.0


def test_rescore_width_is_the_widest_word_d_and_both_starts_allow():
    q = torch.zeros((2, 64), dtype=torch.int8)
    flat = torch.zeros(64 * 10 + 16, dtype=torch.int8)
    assert flat.data_ptr() % 16 == 0
    assert block_scan.rescore_width(q, flat[:640].view(10, 64)) == 16
    assert block_scan.rescore_width(q, flat[4:644].view(10, 64)) == 4
    assert block_scan.rescore_width(q, flat[1:641].view(10, 64)) == 1
    assert block_scan.rescore_width(q[:, :60].contiguous(), flat[:600].view(10, 60)) == 4
    assert block_scan.rescore_width(q[:, :5].contiguous(), flat[:50].view(10, 5)) == 1


def test_rescore_groups_rejects_what_it_does_not_take():
    q = torch.zeros((2, 8), dtype=torch.int8)
    base = torch.zeros((300, 8), dtype=torch.int8)
    gidx = torch.tensor([[0, 1], [1, 2]])
    dot = DistanceMetric.DOT
    block_scan.rescore_groups(q, base, gidx, 300, dot)
    for args in (
        (q.double(), base.double(), gidx, 300, dot),
        (q.float(), base.half(), gidx, 300, dot),
        (q.float(), base.float(), gidx, 300, DistanceMetric.L1),
        (q, base.to(torch.uint8), gidx, 300, dot),
        (q, base, gidx, 300, DistanceMetric.L1),
        (q[:, :4], base, gidx, 300, dot),
        (q[:1], base, gidx, 300, dot),
        (q, base, gidx.int(), 300, dot),
        (q, base, gidx[0], 300, dot),
        (q, base, gidx, 301, dot),
    ):
        with pytest.raises(ValueError):
            block_scan.rescore_groups(*args)
    with pytest.raises(ValueError):
        block_scan.rescore_groups(q, base, gidx, 300, dot, torch.ones(299, dtype=torch.bool))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int8], ids=str)
def test_the_rescore_kernels_wrapper_refuses_tensors_that_are_not_contiguous(dtype):
    """The kernel reads rows by their pitch: a transposed base, a strided
    gidx or a strided mask is refused before any launch."""
    q = torch.zeros((2, 8), dtype=dtype)
    base = torch.zeros((8, 300), dtype=dtype).t()
    gidx = torch.tensor([[0, 1, 2, 0], [1, 2, 0, 1]])
    mask = torch.ones(600, dtype=torch.bool)
    dot = DistanceMetric.DOT
    for args in (
        (q, base, gidx[:, :2].contiguous(), 300, dot, None),
        (q, base.contiguous(), gidx[:, ::2], 300, dot, None),
        (q, base.contiguous(), gidx[:, :2].contiguous(), 300, dot, mask[::2]),
    ):
        with pytest.raises(ValueError, match="contiguous"):
            block_scan._launch_rescore(*args)


def test_rescore_width_counts_bytes_for_float_rows():
    """Float rows: 16 bytes where a row's bytes and both starts allow,
    else 4, else the element (a 16-bit row of odd width)."""
    for dtype, elem in ((torch.float32, 4), (torch.float16, 2), (torch.bfloat16, 2)):
        q = torch.zeros((2, 96), dtype=dtype)
        flat = torch.zeros(96 * 10 + 16, dtype=dtype)
        assert flat.data_ptr() % 16 == 0
        assert block_scan.rescore_width(q, flat[: 960].view(10, 96)) == 16
        assert block_scan.rescore_width(q, flat[1:961].view(10, 96)) == elem
        d4 = 95 if elem == 4 else 94  # a row of 380 or 188 bytes
        assert block_scan.rescore_width(q[:, :d4].contiguous(), flat[: 10 * d4].view(10, d4)) == 4
        odd = torch.zeros((2, 97), dtype=dtype)
        assert block_scan.rescore_width(odd, flat[:970].view(10, 97)) == elem
    q = torch.zeros((2, 64), dtype=torch.float16)
    flat = torch.zeros(64 * 10 + 16, dtype=torch.float16)
    assert block_scan.rescore_width(q, flat[2:642].view(10, 64)) == 4  # 4-byte aligned start


def float_rescore_case(dtype, n, d, b, seed):
    """Float rows with a NaN row, a zero row and a duplicate; query 0 a
    self-match, query 1 zero."""
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dtype)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dtype)
    base[5] = torch.nan
    base[3] = 0
    base[n - 3] = base[10]
    q[0] = base[10]
    q[1:2] = 0
    return q, base


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16], ids=str)
@pytest.mark.parametrize("metric", RESCORE_METRICS)
@pytest.mark.parametrize("d", [97, 1536])
@pytest.mark.parametrize("b", [1, 33])
def test_float_rescore_twin_equals_the_gathered_path(dtype, metric, d, b):
    """rescore_groups on CPU float rows (the twin the float kernel is held
    to) equals the gathered path bit for bit, and the plain [B, N]
    distances within float32 rounding, over N = 1,000 (a ragged last
    group), three groups a query, unmasked and with valid < N and a row
    mask; a self-match reads exactly 0 and the NaN row +inf."""
    n = 1000
    q, base = float_rescore_case(dtype, n, d, b, seed=d + b)
    gen = torch.Generator().manual_seed(b)
    gidx = torch.stack([torch.tensor([0, 7, 1 + int(torch.randint(6, (1,), generator=gen))]) for _ in range(b)])
    gidx = torch.sort(gidx, dim=-1).values
    mask = np.random.default_rng(d).random(n) < 0.5
    tm = DistanceMetric(metric)
    pos = (gidx[:, :, None] * BLOCK + torch.arange(BLOCK)).reshape(b, -1)
    for valid, row_mask in ((n, None), (n - 77, mask)):
        tmask = None if row_mask is None else torch.from_numpy(row_mask)
        got = block_scan.rescore_groups(q, base, gidx, valid, tm, tmask)
        assert torch.equal(got, gathered_rescore(q, base, gidx, valid, tm, tmask))
        plain = torch.gather(per_row(q, base, tm, valid, np.ones(n, bool) if row_mask is None else row_mask), 1, pos)
        assert torch.equal(torch.isinf(got), torch.isinf(plain))
        fin = torch.isfinite(plain)
        torch.testing.assert_close(got[fin], plain[fin], rtol=1e-5, atol=1e-4)
    got = block_scan.rescore_groups(q, base, gidx, n, tm)
    if tm is DistanceMetric.COSINE and b > 1:
        # a zero norm reads 1.0, ahead of the NaN row (the reference's order)
        assert bool((got[1, :BLOCK] == 1.0).all())
        got = got[[0, *range(2, b)]]
    assert bool(torch.isposinf(got[:, 5]).all())
    if tm is not DistanceMetric.DOT:
        assert float(got[0, 10]) == 0.0


# -- row masks ---------------------------------------------------------------

MASKS = ["half", "dead-group", "all-masked", "fewer-than-k"]


def mask_case(kind, n, seed):
    """A random 50% mask; the same with group 1 (rows 128-255) all masked;
    every row masked; and three live rows, fewer than the k of the tests."""
    m = np.random.default_rng(seed).random(n) < 0.5
    if kind == "dead-group":
        m[BLOCK : 2 * BLOCK] = False
    elif kind == "all-masked":
        m[:] = False
    elif kind == "fewer-than-k":
        m[:] = False
        m[[3, 400, 649]] = True
    return m


def per_row(q, base, metric, valid, mask):
    """The rank-ready per-row values the twin reduces, with rows >= valid
    and masked rows at +inf, padded to whole groups."""
    sq = DistanceMetric.SQUARED_L2 if metric is DistanceMetric.L2 else metric
    from sqlite_vector_tpu_torch.ops.distance import pairwise_distance

    d = block_scan._rank_ready(pairwise_distance(q, base, sq, snap=False), metric)
    keep = torch.from_numpy(mask) & (torch.arange(base.shape[0]) < valid)
    d = torch.where(keep, d, torch.inf)
    pad = -(-base.shape[0] // BLOCK) * BLOCK - base.shape[0]
    return torch.nn.functional.pad(d, (0, pad), value=torch.inf)


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("vtype", ["FLOAT32", "FLOATB16", "UINT8", "INT8"])
@pytest.mark.parametrize("metric", METRICS)
def test_masked_twin_minima_are_group_minima_of_live_rows(kind, vtype, metric):
    """The masked twin's minima equal the per-group minimum of the unmasked
    per-row values with masked rows at +inf, exactly (the same float ops);
    a group with no live row reads +inf."""
    q, base = scan_case(vtype, 200 + METRICS.index(metric))
    mask = mask_case(kind, base.shape[0], METRICS.index(metric))
    tq, tb, tm = from_numpy(q), from_numpy(base), DistanceMetric(metric)
    got = block_minima(tq, tb, tm, 650, torch.from_numpy(mask))
    want = per_row(tq, tb, tm, 650, mask).view(q.shape[0], -1, BLOCK).amin(-1)
    assert torch.equal(got, want)
    if kind in ("dead-group", "all-masked"):
        assert torch.isinf(got[:, 1]).all()


def jax_masked_scan(q, base, metric, k, valid, mask):
    from sqlite_vector_tpu.ops.scan import scan_topk as jax_scan_topk

    v, i = jax_scan_topk(
        q, base, JaxMetric(metric), k, valid_count=valid, row_mask=np.asarray(mask)
    )
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("vtype", ["FLOAT32", "UINT8"])
@pytest.mark.parametrize("metric", METRICS)
def test_masked_block_scan_topk_matches_jax_masked_scan(kind, vtype, metric):
    """block_scan_topk(row_mask=) against the JAX masked route
    (ops/scan.py scan_topk(row_mask=)): integer-domain ids and values equal;
    float ids tie-aware against JAX's own masked distances, values within
    REL_TOL_BY_TYPE. Masked rows never come back, and a mask with fewer
    live rows than k pads with -1 / +inf. With the two partial masks k = 4
    of the 6 groups, so the masked minima choose the groups rescored."""
    q, base = scan_case(vtype, 300 + METRICS.index(metric))
    mask = mask_case(kind, base.shape[0], 7 + METRICS.index(metric))
    valid, k = 650, (4 if kind in ("half", "dead-group") else 12)
    tm = DistanceMetric(metric)
    got_v, got_i = fused_scan_topk(
        from_numpy(q), from_numpy(base), tm, k, valid_count=valid,
        row_mask=torch.from_numpy(mask),
    )
    got_v, got_i = got_v.numpy(), got_i.numpy()
    want_v, want_i = jax_masked_scan(q, base, metric, k, valid, mask)
    live = mask & (np.arange(base.shape[0]) < valid)
    assert live[got_i[got_i >= 0]].all()
    assert ((got_i >= 0).sum(1) <= live.sum()).all()
    if vtype == "UINT8":
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_v, want_v)
        return
    oracle = np.asarray(jax_distance.pairwise_distance(q, base, JaxMetric(metric))).astype(np.float64)
    oracle[:, ~live] = np.inf
    for i in range(q.shape[0]):
        assert_topk_parity(
            np.arange(base.shape[0]), oracle[i], got_i[i], got_v[i], k,
            rel_tol=REL_TOL_BY_TYPE[vtype], label=f"{kind}/{metric}[{i}]",
        )
    np.testing.assert_allclose(got_v, want_v, rtol=REL_TOL_BY_TYPE[vtype], atol=1e-5)


def test_masked_plain_scan_matches_jax_masked_scan():
    """The plain scan_topk(row_mask=) (what chip_smoke.py holds the masked
    searches against) equals the JAX masked route on integer codes."""
    q, base = scan_case("INT8", 5)
    mask = mask_case("half", base.shape[0], 5)
    got_v, got_i = scan_topk(
        from_numpy(q), from_numpy(base), DistanceMetric.L2, 9, valid_count=650,
        row_mask=torch.from_numpy(mask),
    )
    want_v, want_i = jax_masked_scan(q, base, "L2", 9, 650, mask)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_v.numpy(), want_v)


def test_row_mask_rejects_wrong_shape_and_dtype():
    q = torch.zeros((2, 8))
    base = torch.zeros((10, 8))
    for bad in (torch.ones(9, dtype=torch.bool), torch.ones(10, dtype=torch.uint8)):
        with pytest.raises(ValueError, match="row_mask"):
            block_minima(q, base, DistanceMetric.L2, 10, bad)
        with pytest.raises(ValueError, match="row_mask"):
            scan_topk(q, base, DistanceMetric.L2, 3, row_mask=bad)


# -- K1's two bodies: which one serves a scan --------------------------------

@pytest.mark.parametrize(
    "dtype,d,tiles",
    [
        # 384 f32 columns: 1,552-byte padded rows, 64 of them fit the budget
        (torch.float32, 384, {1: 8, 8: 8, 9: 16, 16: 16, 17: 32, 33: 64, 64: 64, 65: 64, 200: 64}),
        # the widest rows of the 64- and 32-query tiles, and one column past
        (torch.float32, 416, {64: 64}),
        (torch.float32, 417, {64: 32}),
        (torch.float32, 832, {64: 32}),
        (torch.float32, 833, {64: 16}),
        # 1,024 f32 columns: 4,240-byte rows, 16 fit (67,840 bytes), 32 do not
        (torch.float32, 1024, {1: 8, 9: 16, 16: 16, 17: 16, 64: 16, 200: 16}),
        # the widest f32 row of the resident tile: 13,840 bytes, only 8 fit;
        # past it the tile is streamed, and every tile fits again
        (torch.float32, 3424, {1: 8, 9: 8, 64: 8}),
        (torch.float32, 3425, {1: 8, 64: 64}),
        (torch.float32, 4096, {1: 8, 8: 8, 9: 16, 16: 16, 17: 32, 33: 64, 64: 64, 200: 64}),
        # 384 codes: 400-byte rows, every tile fits
        (torch.int8, 384, {1: 8, 8: 8, 9: 16, 32: 32, 33: 64, 65: 64}),
        (torch.uint8, 13696, {1: 8, 64: 8}),
        # streamed codes, up to the int32 bound
        (torch.uint8, 13697, {1: 8, 9: 16, 64: 64}),
        (torch.int8, 131071, {17: 32, 65: 64}),
        # 384 16-bit columns: 784-byte rows, every tile fits
        (torch.float16, 384, {1: 8, 9: 16, 17: 32, 33: 64, 200: 64}),
        # the 16-bit tile edges: 64 queries to d = 832, 32 to 1,664, 16 to
        # 3,392, 8 to 6,848 (13,696 bytes a row); streamed past
        (torch.bfloat16, 832, {64: 64}),
        (torch.bfloat16, 833, {64: 32}),
        (torch.float16, 1664, {64: 32}),
        (torch.float16, 1665, {64: 16}),
        (torch.bfloat16, 3392, {64: 16}),
        (torch.bfloat16, 3393, {64: 8}),
        (torch.float16, 6848, {1: 8, 64: 8}),
        (torch.bfloat16, 6848, {1: 8, 64: 8}),
        (torch.float16, 6849, {1: 8, 9: 16, 33: 64}),
        (torch.bfloat16, 6849, {1: 8}),
        (torch.float16, 8192, {1: 8, 16: 16, 17: 32, 200: 64}),
    ],
    ids=str,
)
def test_mma_query_tile_is_the_narrowest_that_covers_b_and_fits(dtype, d, tiles):
    """A resident tile fits the shared budget; where not even 8 padded
    query rows do, the tile is streamed."""
    pitch = -(-d * dtype.itemsize // 128) * 128 + 16
    streamed = block_scan.mma_streams_queries(dtype, d)
    assert streamed == (8 * pitch > block_scan._MMA_QUERY_BYTES)
    for b, want in tiles.items():
        assert block_scan.mma_query_tile(dtype, d, b) == want, b
        if not streamed:
            assert want * pitch <= block_scan._MMA_QUERY_BYTES


@pytest.mark.parametrize(
    "dtype,last_mma_d",
    # the widest d whose 8 padded query rows (row bytes rounded up to 128,
    # plus 16) fit the 110,592-byte budget (13,696 bytes a row): the last
    # resident tile, past which the tile is streamed and the route stays
    [(torch.float32, 3424), (torch.float16, 6848), (torch.bfloat16, 6848), (torch.uint8, 13696),
     (torch.int8, 13696)],
    ids=str,
)
@pytest.mark.parametrize("metric", METRICS)
def test_k1_body_routes_by_metric_dtype_and_d(dtype, last_mma_d, metric):
    """The dot family takes a tensor-core body at every width the int32
    bound allows (floats have none): the wgmma body where TMA takes the
    float rows' pitch, the mma.sync body otherwise; L1 the CUDA-core body
    at every d; the mma.sync body's query tile streams exactly past the
    resident edge."""
    m = DistanceMetric(metric)

    def want(d):
        if m is DistanceMetric.L1:
            return "simt"
        return "wgmma" if dtype.is_floating_point and d * dtype.itemsize % 16 == 0 else "mma"

    for d in (1, 95, 100, 384, 768, last_mma_d, last_mma_d + 1, 4096, 8192, 33025):
        assert block_scan.k1_body(dtype, m, d) == want(d), d
    assert not block_scan.mma_streams_queries(dtype, last_mma_d)
    assert block_scan.mma_streams_queries(dtype, last_mma_d + 1)
    # floats have no bound; codes leave the tensor cores past the int32 one
    past = 10**6 if dtype.is_floating_point else block_scan._MMA_MAX_DIM[dtype] + 1
    assert block_scan.k1_body(dtype, m, past) == (want(past) if dtype.is_floating_point else "simt")


@pytest.mark.parametrize(
    "dtype", [torch.float32, torch.float16, torch.bfloat16, torch.uint8, torch.int8], ids=str
)
@pytest.mark.parametrize("d", [1, 384, 6848, 131072])
def test_k1_body_keeps_l1_on_cuda_cores(monkeypatch, dtype, d):
    """L1 has no tensor-core form: every dtype and d takes the CUDA-core
    body, whatever the shared budget allows."""
    assert block_scan.k1_body(dtype, DistanceMetric.L1, d) == "simt"
    monkeypatch.setattr(block_scan, "_MMA_QUERY_BYTES", 1 << 40)
    assert block_scan.k1_body(dtype, DistanceMetric.L1, d) == "simt"


@pytest.mark.parametrize(
    "dtype,bound,top", [(torch.uint8, 33025, 255), (torch.int8, 131071, 128)], ids=str
)
def test_k1_body_keeps_codes_off_mma_where_int32_could_overflow(monkeypatch, dtype, bound, top):
    """With the shared budget out of the way, the integer bound alone
    routes: d * top^2 stays below 2^31 up to the bound and not past it."""
    assert bound * top * top < 2**31 <= (bound + 1) * top * top
    monkeypatch.setattr(block_scan, "_MMA_QUERY_BYTES", 1 << 40)
    for metric in (DistanceMetric.L2, DistanceMetric.COSINE, DistanceMetric.DOT):
        assert block_scan.k1_body(dtype, metric, bound) == "mma"
        assert block_scan.k1_body(dtype, metric, bound + 1) == "simt"
    assert block_scan.k1_body(torch.float32, DistanceMetric.L2, 10**6) == "wgmma"
    assert block_scan.k1_body(torch.float32, DistanceMetric.L2, 10**6 + 1) == "mma"


FLOATS = [torch.float32, torch.float16, torch.bfloat16]


@pytest.mark.parametrize("dtype", FLOATS, ids=str)
@pytest.mark.parametrize("d", [1, 4, 8, 100, 383, 384, 385, 4096, 8193, 18432])
@pytest.mark.parametrize("metric", METRICS)
def test_k1_body_sends_tma_ready_float_rows_to_wgmma(dtype, d, metric):
    """Float dot-family rows take the wgmma body exactly where TMA copies
    them (a row pitch that is a multiple of 16 bytes: f32 d % 4 == 0,
    16-bit d % 8 == 0, and both starts 16-byte aligned); other widths and
    unaligned tensors keep the mma.sync body; L1 stays on CUDA cores."""
    m = DistanceMetric(metric)
    if m is DistanceMetric.L1:
        assert block_scan.k1_body(dtype, m, d) == "simt"
        assert block_scan.k1_body(dtype, m, d, aligned=False) == "simt"
        return
    pitch_ok = d * dtype.itemsize % 16 == 0
    assert block_scan.k1_body(dtype, m, d) == ("wgmma" if pitch_ok else "mma")
    assert block_scan.k1_body(dtype, m, d, aligned=False) == "mma"


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8], ids=str)
def test_k1_body_keeps_codes_on_mma_sync(dtype):
    """u8/i8 codes have no wgmma instance: TMA-ready code rows stay on the
    mma.sync body up to the int32 bound."""
    for d in (16, 384, 4096, 13697):
        for metric in (DistanceMetric.L2, DistanceMetric.COSINE, DistanceMetric.DOT):
            assert block_scan.k1_body(dtype, metric, d) == "mma"


def test_tma_ready_needs_a_16_byte_start_and_pitch():
    t = torch.zeros((10, 384))
    assert block_scan.tma_ready(t) and block_scan.tma_ready(t.half())
    assert not block_scan.tma_ready(torch.zeros((10, 383)))  # 1,532-byte rows
    assert not block_scan.tma_ready(torch.zeros((10, 100), dtype=torch.float16))  # 200 bytes
    assert block_scan.tma_ready(torch.zeros((10, 104), dtype=torch.bfloat16))
    flat = torch.zeros(3841)
    assert flat.data_ptr() % 16 == 0
    assert not block_scan.tma_ready(flat[1:].view(10, 384))  # starts 4 bytes in


@pytest.mark.parametrize(
    "dtype,d,plans",
    [
        # 384 f32 columns, two planes (q_hi, q_lo): 3,072 bytes a query, 32
        # queries fit the 98,304-byte budget; wider tiles stream
        (torch.float32, 384, {1: (8, False), 8: (8, False), 9: (16, False), 17: (32, False),
                              33: (64, True), 64: (64, True), 200: (64, True)}),
        # 384 16-bit columns, one plane: 768 bytes a query, every tile fits
        (torch.float16, 384, {1: (8, False), 9: (16, False), 33: (64, False), 200: (64, False)}),
        (torch.bfloat16, 768, {64: (64, False)}),
        (torch.bfloat16, 776, {33: (64, True), 32: (32, False)}),
        # f32 1,536 columns: 12,288 bytes a query, 8 fit, 9 do not
        (torch.float32, 1536, {1: (8, False), 8: (8, False), 9: (16, True), 64: (64, True)}),
        (torch.float32, 4096, {1: (8, True), 64: (64, True)}),
        (torch.float16, 6144, {1: (8, False), 9: (16, True)}),
        (torch.bfloat16, 18432, {1: (8, True), 64: (64, True)}),
    ],
    ids=str,
)
def test_wgmma_plan_keeps_the_planes_resident_while_they_fit(dtype, d, plans):
    """The wgmma body's query tile: the narrowest of 8/16/32/64 covering
    min(B, 64), resident while its planes (two for f32) fit the budget,
    else streamed."""
    planes = 2 if dtype is torch.float32 else 1
    per_query = -(-d * dtype.itemsize // 128) * 128 * planes
    for b, (tile, streamed) in plans.items():
        assert block_scan.wgmma_plan(dtype, d, b) == (tile, streamed), b
        assert tile >= min(b, 64)
        assert streamed == (tile * per_query > block_scan._WGMMA_QUERY_BYTES)


def test_tf32_planes_are_tf32_exact_and_sum_to_the_queries():
    """q_hi is q rounded to TF32 to nearest with ties away from zero (the
    kernel's to_tf32: its 13 low mantissa bits zero, so the tensor cores
    read it exactly), q_lo = q - q_hi, and q_hi + q_lo == q bit for bit."""
    rng = np.random.default_rng(13)
    q = (rng.standard_normal((6, 384)) * 10.0 ** rng.integers(-30, 30, (6, 384))).astype(np.float32)
    bits = q.view(np.uint32)
    bits[0, :4] = [0x3F801000, 0xBF801000, 0x3F801FFF, 0x3FFFF000]  # ties, a round up, a carry
    bits[1, :3] = [0, 0x80000000, 0x00001234]  # +-0 and a denormal
    planes = block_scan.tf32_planes(torch.from_numpy(q))
    assert planes.shape == (2, 6, 384) and planes.dtype == torch.float32
    hi, lo = planes[0], planes[1]
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert torch.equal(hi + lo, torch.from_numpy(q))
    want = ((bits.astype(np.uint64) + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(hi.numpy(), want)
    assert hi[0, :4].tolist() == [1.0009765625, -1.0009765625, 1.0009765625, 2.0]


# -- the bound arithmetic chip_smoke.py reports beside each kernel time -------

def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("svt_chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize(
    "args,ms,by",
    [
        # f32 B=64: 1.54 GB at 3.35 TB/s outweighs 3 x 49.2 GFLOP of TF32
        # at 495 TFLOP/s (0.298 ms)
        ((64, 1_000_000, 384, 4), 0.45913386029850745, "bytes"),
        ((1, 1_000_000, 384, 4), 0.4585172501492537, "bytes"),
        # 1,024 f32 queries: the TF32 products outweigh the bytes
        ((1024, 1_000_000, 384, 4), 4.766254545454545, "operations"),
        ((64, 1_000_000, 384, 1), 0.11523125492537313, "bytes"),
        ((1, 1_000_000, 384, 1), 0.11463630925373133, "bytes"),
        # 16-bit rows: 768 MB, against 2 x 49.2 GFLOP at 989 TFLOP/s (0.050 ms)
        ((64, 1_000_000, 384, 2), 0.22986545671641792, "bytes"),
        ((1, 1_000_000, 384, 2), 0.2292632895522388, "bytes"),
        # 16,384 16-bit queries: the products outweigh the bytes
        ((16384, 1_000_000, 384, 2), 12.722863498483317, "operations"),
    ],
)
def test_k1_bound_is_the_larger_of_bytes_and_operations(args, ms, by):
    smoke = _chip_smoke()
    got, side = smoke.k1_bound(*args)
    assert side == by and got == pytest.approx(ms, rel=1e-12)
    b, n, d, elem = args
    nbytes = (b + n) * d * elem + b * (-(-n // 128)) * 4
    ops = {4: 3 * 2 * b * n * d / 495e12, 2: 2 * b * n * d / 989e12, 1: 2 * b * n * d / 1979e12}[elem]
    assert got == pytest.approx(max(nbytes / 3.35e12, ops) * 1e3)
    masked, _ = smoke.k1_bound(*args, masked=True)
    if by == "bytes":
        assert masked == pytest.approx(got + n / 3.35e12 * 1e3)


@pytest.mark.parametrize(
    "b,elem,signed,ms,by",
    [
        # f32 B=1: 1.54 GB at 3.35 TB/s outweigh 0.77 G FP32 instructions
        (1, 4, False, 0.4585172501492537, "bytes"),
        # f32 B=64: 2 x 64 x 1M x 384 = 49.2 G FP32 instructions at 33.5 T/s
        (64, 4, False, 1.467223880597015, "operations"),
        (64, 2, False, 1.467223880597015, "operations"),
        (1, 2, False, 0.2292632895522388, "bytes"),
        # u8 codes: one integer instruction per 4 pairs at 16.75 T/s
        (64, 1, False, 0.36680597014925376, "operations"),
        (1, 1, False, 0.11463630925373133, "bytes"),
        # i8 codes: two
        (64, 1, True, 0.7336119402985075, "operations"),
    ],
)
def test_k1_l1_bound_counts_instructions_of_the_cuda_core_body(b, elem, signed, ms, by):
    smoke = _chip_smoke()
    n, d = 1_000_000, 384
    got, side = smoke.k1_bound_cuda_core(b, n, d, elem, signed)
    assert side == by and got == pytest.approx(ms, rel=1e-12)
    nbytes = (b + n) * d * elem + b * (-(-n // 128)) * 4
    per4 = 2 if signed else 1
    instr = 2 * b * n * d / 33.5e12 if elem > 1 else per4 * (b * n * d / 4) / 16.75e12
    assert got == pytest.approx(max(nbytes / 3.35e12, instr) * 1e3)


def test_k2_bound_counts_packed_codes_and_scales():
    smoke = _chip_smoke()
    got, side = smoke.k2_bound(64, 1_000_000, 384)
    nbytes = 1_000_000 * (192 + 8) + 64 * (384 + 4) + 64 * 7813 * 4
    assert side == "bytes" and got == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)


@pytest.mark.parametrize(
    "b,kg,ms",
    [
        # B=32, k=100 over 768-wide codes: 315 MB of codes and 1.6 MB of
        # distances at 3.35 TB/s, against 78.6 M dp4a at 16.75 T/s
        (32, 100, 0.09440638089552239),
        (1, 100, 0.0029501994029850747),
        (64, 100, 0.18881276179104478),
    ],
)
def test_rescore_bound_is_the_bytes_of_the_selected_groups(b, kg, ms):
    smoke = _chip_smoke()
    got, side = smoke.rescore_bound(b, kg, 768)
    assert side == "bytes" and got == pytest.approx(ms, rel=1e-12)
    nbytes = b * 768 + b * kg * 8 + b * kg * 128 * (768 + 4)
    assert got == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert 2 * (b * kg * 128 * 768 / 4) / 16.75e12 * 1e3 < got



@pytest.mark.parametrize("b,elem", [(1, 4), (32, 4), (64, 4), (32, 2)])
def test_rescore_rows_bound_is_the_bytes_of_the_selected_float_rows(b, elem):
    """B queries, k = 100 groups over 1,536-wide rows: the rows read once at
    their element size (2.52 GB of float32 at B = 32), the queries and
    group indices read once, the distances written once, over 3.35 TB/s;
    the two FMAs an element at 33.5 T/s take far less."""
    smoke = _chip_smoke()
    got, side = smoke.rescore_rows_bound(b, 100, 1536, elem)
    cand = b * 100 * 128
    nbytes = b * 1536 * elem + b * 100 * 8 + cand * (1536 * elem + 4)
    assert side == "bytes" and got == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    assert 2 * cand * 1536 / 33.5e12 * 1e3 < got / 4
    if (b, elem) == (32, 4):
        assert got == pytest.approx(0.7517740322388059, rel=1e-12)