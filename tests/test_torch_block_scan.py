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
from sqlite_vector_tpu_torch.ops import block_scan
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
    """A small bound splits the finish over queries (2 per chunk at 6144,
    1 at 3000) and candidates: the result is unchanged, and no gathered
    block of candidate rows holds more elements than the bound."""
    q, base = scan_case(vtype, 90 + METRICS.index(metric), n=1500, d=24, b=4)
    q, base, tm = from_numpy(q), from_numpy(base), DistanceMetric(metric)
    want = block_scan_topk(q, base, tm, 9, valid_count=1400)
    seen = []
    rescore = block_scan.candidate_distances

    def spy(qs, cand, m):
        seen.append(cand.numel())
        return rescore(qs, cand, m)

    monkeypatch.setattr(block_scan, "_FINISH_CHUNK_ELEMS", limit)
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
        # the widest f32 row of the MMA body: 13,840 bytes, only 8 fit
        (torch.float32, 3424, {1: 8, 9: 8, 64: 8}),
        (torch.float32, 3425, {1: 0, 64: 0}),
        # 384 codes: 400-byte rows, every tile fits
        (torch.int8, 384, {1: 8, 8: 8, 9: 16, 32: 32, 33: 64, 65: 64}),
        (torch.uint8, 13696, {1: 8, 64: 8}),
        (torch.uint8, 13697, {1: 0}),
    ],
    ids=str,
)
def test_mma_query_tile_is_the_narrowest_that_covers_b_and_fits(dtype, d, tiles):
    for b, want in tiles.items():
        assert block_scan.mma_query_tile(dtype, d, b) == want, b
        if want:
            pitch = -(-d * dtype.itemsize // 128) * 128 + 16
            assert want * pitch <= block_scan._MMA_QUERY_BYTES


@pytest.mark.parametrize(
    "dtype,last_mma_d",
    # the widest d whose 8 padded query rows (row bytes rounded up to 128,
    # plus 16) fit the 110,592-byte budget: 13,696 bytes a row
    [(torch.float32, 3424), (torch.uint8, 13696), (torch.int8, 13696)],
    ids=str,
)
@pytest.mark.parametrize("metric", METRICS)
def test_k1_body_routes_by_metric_dtype_and_d(dtype, last_mma_d, metric):
    m = DistanceMetric(metric)
    want = "simt" if m is DistanceMetric.L1 else "mma"
    for d in (1, 95, 100, 384, 768, last_mma_d):
        assert block_scan.k1_body(dtype, m, d) == want, d
    assert block_scan.k1_body(dtype, m, last_mma_d + 1) == "simt"


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16], ids=str)
@pytest.mark.parametrize("metric", METRICS)
def test_k1_body_keeps_half_floats_on_cuda_cores(dtype, metric):
    for d in (1, 384, 4096):
        assert block_scan.k1_body(dtype, DistanceMetric(metric), d) == "simt"


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
    assert block_scan.k1_body(torch.float32, DistanceMetric.L2, 10**6) == "mma"


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
    ],
)
def test_k1_bound_is_the_larger_of_bytes_and_operations(args, ms, by):
    smoke = _chip_smoke()
    got, side = smoke.k1_bound(*args)
    assert side == by and got == pytest.approx(ms, rel=1e-12)
    b, n, d, elem = args
    nbytes = (b + n) * d * elem + b * (-(-n // 128)) * 4
    ops = 3 * 2 * b * n * d / 495e12 if elem == 4 else 2 * b * n * d / 1979e12
    assert got == pytest.approx(max(nbytes / 3.35e12, ops) * 1e3)
    masked, _ = smoke.k1_bound(*args, masked=True)
    if by == "bytes":
        assert masked == pytest.approx(got + n / 3.35e12 * 1e3)


def test_k2_bound_counts_packed_codes_and_scales():
    smoke = _chip_smoke()
    got, side = smoke.k2_bound(64, 1_000_000, 384)
    nbytes = 1_000_000 * (192 + 8) + 64 * (384 + 4) + 64 * 7813 * 4
    assert side == "bytes" and got == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
