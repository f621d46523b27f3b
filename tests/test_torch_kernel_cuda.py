"""The port's CUDA kernels on the card: K1 (csrc/block_minima_mma.cu and
csrc/block_minima.cu) and K2 (csrc/int4_minima_mma.cu and
csrc/int4_minima.cu), unmasked and with row masks, and the searches that
launch them.

Every test here needs a CUDA device and skips without one. The file imports
neither jax nor the JAX package, so on a machine without jax it runs on its
own, skipping tests/conftest.py (which configures jax):

    python -m pytest tests/test_torch_kernel_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

import sqlite_vector_tpu_torch as svt
from sqlite_vector_tpu_torch.ops.block_scan import (
    block_minima,
    block_minima_reference,
    block_scan_topk,
)
from sqlite_vector_tpu_torch.ops.int4_scan import (
    int4_block_minima,
    int4_block_minima_reference,
)
from sqlite_vector_tpu_torch.ops.quantize4 import (
    int4_scan_topk_plain,
    quantize4_device,
    quantize_query_int8,
)
from sqlite_vector_tpu_torch.ops.refine import int4_refine_topk, refine_candidates
from sqlite_vector_tpu_torch.ops.scan import scan_topk
from sqlite_vector_tpu_torch.types import DistanceMetric

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.uint8, torch.int8]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def case(dtype, n, d, b, device, seed=0):
    """Ragged n with a NaN row (floats), duplicated rows, a zero row and a
    self-match."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if dtype.is_floating_point:
        base = torch.randn((n, d), generator=gen, device=device).to(dtype)
        q = torch.randn((b, d), generator=gen, device=device).to(dtype)
        base[5] = torch.nan
    else:
        lo, hi = (0, 256) if dtype is torch.uint8 else (-128, 128)
        base = torch.randint(lo, hi, (n, d), generator=gen, device=device).to(dtype)
        q = torch.randint(lo, hi, (b, d), generator=gen, device=device).to(dtype)
    base[n - 3] = base[10]
    base[200] = 0
    q[0] = base[10]
    return q, base


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b", [1, 3, 17])
def test_kernel_matches_twin(cuda, dtype, b):
    """Integers equal; floats within accumulation order (both widen to f32
    and accumulate in f32)."""
    q, base = case(dtype, 5003, 100, b, cuda)
    before = block_minima.launches
    for metric in DistanceMetric:
        got = block_minima(q, base, metric, 4990)
        want = block_minima_reference(q, base, metric, 4990)
        assert torch.equal(torch.isinf(got), torch.isinf(want)), metric
        if dtype.is_floating_point:
            fin = torch.isfinite(want)
            torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-3)
        else:
            assert torch.equal(got, want), metric
    assert block_minima.launches == before + len(DistanceMetric)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", list(DistanceMetric), ids=lambda m: m.value)
def test_block_scan_topk_on_card_matches_cpu_twin_path(cuda, metric):
    """Kernel minima + finish on the card == twin minima + finish on the
    CPU, exactly, over integer codes; the ids also equal the plain scan's."""
    q, base = case(torch.int8, 9000, 64, 4, cuda, seed=1)
    got_v, got_i = block_scan_topk(q, base, metric, 15, valid_count=8888)
    want_v, want_i = block_scan_topk(q.cpu(), base.cpu(), metric, 15, valid_count=8888)
    assert torch.equal(got_i.cpu(), want_i) and torch.equal(got_v.cpu(), want_v)
    _, plain_i = scan_topk(q, base, metric, 15, valid_count=8888)
    assert torch.equal(got_i, plain_i)


@pytest.mark.cuda
def test_finish_memory_is_bounded_at_large_batch_and_k(cuda):
    """B=1024, k=100 over 1M x 384 int8 codes: the finish rescores 12,800
    candidate rows per query (5 G gathered elements, 40 GB as float64 if
    done at once) in bounded chunks, so its peak stays under 4 GiB."""
    n, d, b, k = 1_000_000, 384, 1024, 100
    gen = torch.Generator(device=cuda).manual_seed(3)
    base = torch.randint(-128, 128, (n, d), generator=gen, device=cuda, dtype=torch.int32)
    base = base.to(torch.int8)
    q = base[:b].clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    vals, idx = block_scan_topk(q, base, DistanceMetric.L2, k)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - held < 4 * 2**30
    assert torch.equal(idx[:, 0], torch.arange(b, device=cuda))
    assert bool((vals[:, 0] == 0).all())
    plain_v, plain_i = scan_topk(q[:8], base, DistanceMetric.L2, k)
    assert torch.equal(idx[:8], plain_i) and torch.equal(vals[:8], plain_v)


@pytest.mark.cuda
def test_dataset_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(2)
    base = rng.standard_normal((3000, 96)).astype(np.float32)
    q = base[[7, 2500]] + np.float32(1e-3)
    results = []
    for device in ("cuda", "cpu"):
        ds = svt.VectorStore(device=device).create("d", "dimension=96,distance=COSINE")
        ds.add(base)
        ds.quantize()
        results.append((ds.search(q, 9), ds.search(q, 9, exact=False)))
    (ce, cq), (pe, pq) = results
    np.testing.assert_array_equal(ce[0], pe[0])
    np.testing.assert_allclose(ce[1], pe[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(cq[0], pq[0])
    np.testing.assert_array_equal(cq[1], pq[1])


K2_METRICS = [m for m in DistanceMetric if m is not DistanceMetric.L1]


def int4_case(n, d, b, device, seed=0):
    """Packed int4 codes of rows with a zero row (csq 0), duplicate rows,
    and rows scaled by 1e25: every fifth row and all of group 1 (rows
    128-255). Against the last query, also scaled, alpha^2 * csq and the
    cross term both overflow, so the L2 surrogate is inf - inf = NaN there
    and group 1 must read +inf. Query codes with a self-match. chip_smoke.py
    runs K2 on these cases too, at N = 100,003."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, d), generator=gen, device=device)
    big = torch.zeros(n, dtype=torch.bool, device=device)
    big[::5] = True
    big[128:256] = True
    x[big] *= 1e25
    x[300] = 0
    x[n // 2] = x[11]
    x[n - 3] = x[11]
    q = torch.randn((b, d), generator=gen, device=device)
    if b > 1:
        q[-1] *= 1e25
    q[0] = x[11]
    packed, alpha, csq = quantize4_device(x)
    qc, qs, _ = quantize_query_int8(q)
    return (qc, qs, packed, alpha, csq), x


def assert_k2_matches_twin(got, want):
    """+inf positions equal; finite minima equal. Both compute the exact
    integer dot and then the same float32 epilogue, each op rounded once in
    the same order (the kernel with __fmul_rn/__fsub_rn and a correctly
    rounded 1/sqrt), so they agree bit for bit."""
    assert not bool(torch.isnan(got).any())
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    assert torch.equal(got[fin], want[fin])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [9, 16, 95, 384])  # 1-byte (9, 16) and 16-byte staging
@pytest.mark.parametrize("b", [1, 3, 17])
def test_int4_kernel_matches_twin(cuda, d, b):
    tensors, _ = int4_case(5003, d, b, cuda)
    before = int4_block_minima.launches
    for metric in K2_METRICS:
        got = int4_block_minima(*tensors, metric, 4990)
        want = int4_block_minima_reference(*tensors, metric, 4990)
        torch.cuda.synchronize()
        assert_k2_matches_twin(got, want)
        assert bool(torch.isinf(got[:, -1]).all())  # rows >= valid only
        if b > 1 and metric is DistanceMetric.L2:
            assert float(got[-1, 1]) == float("inf")  # all NaN or +inf
    assert int4_block_minima.launches == before + len(K2_METRICS)


def assert_k2_bodies_match_twin(tensors, metric, valid, mask=None):
    """K2 forced into each body (_launch_k2): each against the twin as
    assert_k2_matches_twin holds it, and the two bodies equal bit for bit
    (float32 bit patterns). Returns the tensor-core body's minima."""
    from sqlite_vector_tpu_torch.ops.int4_scan import _launch_k2

    want = int4_block_minima_reference(*tensors, metric, valid, mask)
    got = {body: _launch_k2(*tensors, metric, valid, mask, body) for body in ("mma", "simt")}
    torch.cuda.synchronize()
    for minima in got.values():
        assert_k2_matches_twin(minima, want)
    assert torch.equal(got["mma"].view(torch.int32), got["simt"].view(torch.int32)), metric
    return got["mma"]


@pytest.mark.cuda
def test_int4_kernel_unaligned_packed_rows(cuda):
    """A packed view that starts off a 16-byte boundary takes the 1-byte
    staging in both bodies and still equals the twin."""
    (qc, qs, packed, alpha, csq), _ = int4_case(1000, 64, 2, cuda, seed=4)
    view = packed.view(-1)[1 : 1 + 999 * 32].view(999, 32)  # row 0 at byte 1
    assert_k2_bodies_match_twin((qc, qs, view, alpha[:999], csq[:999]), DistanceMetric.L2, 999)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", list(DistanceMetric), ids=lambda m: m.value)
def test_int4_and_refine_search_launch_k2_except_l1(cuda, metric):
    """search(mode="quantized") over int4 codes and search(mode="refine")
    launch K2 for the matmul metrics and never for L1; both equal the same
    searches run on the CPU over the same rows (ids; values within 1e-5,
    float32 sums of another order)."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal((3000, 96)).astype(np.float32)
    q = base[[7, 2500]] + np.float32(1e-3)
    results = []
    for device in ("cuda", "cpu"):
        ds = svt.VectorStore(device=device).create("d", f"dimension=96,distance={metric.value}")
        ds.add(base)
        ds.quantize(qtype="int4", refine=True)
        before = int4_block_minima.launches
        results.append((ds.search(q, 9, mode="quantized"), ds.search(q, 9, mode="refine")))
        if device == "cuda":
            launched = int4_block_minima.launches - before
            assert launched == (0 if metric is DistanceMetric.L1 else 2)
    for got, want in zip(results[0], results[1]):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_refine_memory_is_bounded_at_large_batch_and_k(cuda):
    """B=256, k=100, expand=4 over 1M x 384 int4 codes: the int4 finish
    rescores 400 groups x 128 rows per query (256 x 51,200 x 384 = 5 G
    unpacked codes, 20 GB as float32 at once) in blocks of at most 2^26
    codes, and the refine rescore gathers [256, 400, 384] int8 rows (39 M
    elements); the peak above the resident codes stays under 2 GiB."""
    n, d, b, k = 1_000_000, 384, 256, 100
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((n, d), generator=gen, device=cuda)
    packed, alpha, csq = quantize4_device(x)
    scale8 = np.float32(127.0) / np.float32(float(x.abs().max()))
    codes8 = torch.clamp(torch.round(x * float(scale8)), -127, 127).to(torch.int8)
    q = x[:b].clone()
    del x
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    before = int4_block_minima.launches
    vals, idx = int4_refine_topk(
        q, packed, alpha, csq, codes8, scale8, 0.0, DistanceMetric.L2, k, dim=d, expand=4
    )
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - held < 2 * 2**30
    assert int4_block_minima.launches == before + 1
    assert torch.equal(idx[:, 0], torch.arange(b, device=cuda))  # self-matches
    # the first 4 queries against a refine prefiltered by the plain tile loop
    _, cand = int4_scan_topk_plain(q[:4], packed, alpha, csq, DistanceMetric.L2, 4 * k, dim=d)
    pv, pi = refine_candidates(q[:4], cand, codes8, scale8, 0.0, DistanceMetric.L2, k)
    assert torch.equal(idx[:4], pi) and torch.equal(vals[:4], pv)


MASK_KINDS = ["half", "dead-group", "all-masked", "fewer-than-k"]


def mask_case(kind, n, device, seed=0):
    """Row masks ([n] torch.bool): a random 50% mask; the same with group 1
    (rows 128-255) all masked; every row masked; three live rows (fewer than
    any k used). chip_smoke.py runs the kernels on these cases too, at
    N = 100,003."""
    gen = torch.Generator(device=device).manual_seed(seed)
    m = torch.rand(n, generator=gen, device=device) < 0.5
    if kind == "dead-group":
        m[128:256] = False
    elif kind == "all-masked":
        m[:] = False
    elif kind == "fewer-than-k":
        m[:] = False
        m[[3, n // 2, n - 80]] = True
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("kind", MASK_KINDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_masked_kernel_matches_twin(cuda, kind, dtype):
    """Masked K1 against its masked twin for the 5 metrics of each dtype
    (25 pairs over the dtype cases), B in {1, 17}: +inf positions equal
    (a group with no live row reads +inf), integers equal, floats within
    accumulation order as unmasked."""
    for b in (1, 17):
        q, base = case(dtype, 5003, 100, b, cuda, seed=b)
        mask = mask_case(kind, 5003, cuda, seed=b)
        before = block_minima.launches
        for metric in DistanceMetric:
            got = block_minima(q, base, metric, 4990, mask)
            want = block_minima_reference(q, base, metric, 4990, mask)
            assert torch.equal(torch.isinf(got), torch.isinf(want)), metric
            if kind in ("dead-group", "all-masked"):
                assert bool(torch.isinf(got[:, 1]).all())
            if dtype.is_floating_point:
                fin = torch.isfinite(want)
                torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-3)
            else:
                assert torch.equal(got, want), metric
        assert block_minima.launches == before + len(DistanceMetric)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", MASK_KINDS)
@pytest.mark.parametrize("d", [16, 95, 384])
def test_masked_int4_kernel_matches_twin(cuda, kind, d):
    """Masked K2 against its masked twin for its 4 metrics: bit-equal."""
    for b in (1, 17):
        tensors, _ = int4_case(5003, d, b, cuda, seed=b)
        mask = mask_case(kind, 5003, cuda, seed=b)
        before = int4_block_minima.launches
        for metric in K2_METRICS:
            got = int4_block_minima(*tensors, metric, 4990, mask)
            want = int4_block_minima_reference(*tensors, metric, 4990, mask)
            torch.cuda.synchronize()
            assert_k2_matches_twin(got, want)
            if kind in ("dead-group", "all-masked"):
                assert bool(torch.isinf(got[:, 1]).all())
        assert int4_block_minima.launches == before + len(K2_METRICS)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", list(DistanceMetric), ids=lambda m: m.value)
def test_masked_searches_launch_the_kernels_and_match_cpu(cuda, metric, monkeypatch):
    """With tombstones and an ids_filter, every mode on a CUDA dataset
    launches K1 or K2 (int4 L1 excepted, as in the JAX package) and never
    the plain scan or a twin; ids equal the same searches on the CPU and
    values agree within 1e-5 (float32 sums in another order)."""
    from sqlite_vector_tpu_torch.ops import block_scan, int4_scan, scan

    rng = np.random.default_rng(7)
    base = rng.standard_normal((3000, 96)).astype(np.float32)
    q = base[[7, 2500]] + np.float32(1e-3)
    flt = np.arange(1, 3001)[::2]
    results = {}
    for device in ("cuda", "cpu"):
        ds = svt.VectorStore(device=device).create("d", f"dimension=96,distance={metric.value}")
        ids = ds.add(base)
        out = []
        for qtype, gone in (("int8", ids[100:160]), ("int4", ids[200:260])):
            ds.quantize(qtype=qtype, refine=qtype == "int4")  # compacts first
            ds.remove(gone)
            modes = ["exact", "approx", "quantized", "rerank"] + (["refine"] if qtype == "int4" else [])
            for mode in modes:
                if device == "cuda":
                    def fail(*a, **kw):
                        raise AssertionError("plain route on a CUDA tensor")

                    for mod, name in ((scan, "scan_topk"), (block_scan, "block_minima_reference"),
                                      (int4_scan, "int4_block_minima_reference")):
                        monkeypatch.setattr(mod, name, fail)
                    k1, k2 = block_minima.launches, int4_block_minima.launches
                out.append(ds.search(q, 9, mode=mode, ids_filter=flt))
                if device == "cuda":
                    monkeypatch.undo()
                    int4_l1 = metric is DistanceMetric.L1 and qtype == "int4" and mode not in ("exact", "approx")
                    launched = block_minima.launches - k1 + int4_block_minima.launches - k2
                    assert launched > 0 or int4_l1, (qtype, mode)
        results[device] = out
    for got, want in zip(results["cuda"], results["cpu"]):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


# -- K1's tensor-core body (csrc/block_minima_mma.cu) ------------------------

DOT_FAMILY = [m for m in DistanceMetric if m is not DistanceMetric.L1]


def minima_tolerance(q, base, metric, valid, ref):
    """[B, G] float64: 1e-5 of the magnitude each float minimum accumulates,
    the largest over its group's rows: sum |q_i b_i| for DOT, and with the
    norms, ||q||^2 + ||b||^2 + 2 sum |q_i b_i|, for L2; 1 for COSINE and
    |minimum| + 1 for L1. Rows with a non-finite value give no finite
    distance and count 0; a non-finite magnitude leaves no room."""
    if metric is DistanceMetric.COSINE:
        return torch.full_like(ref, 1e-5, dtype=torch.float64)
    if metric is DistanceMetric.L1:
        return 1e-5 * (ref.double().abs() + 1.0)
    qf, bf = q.double(), base[:valid].double()
    bf = torch.where(torch.isfinite(bf).all(-1, keepdim=True), bf, 0.0)
    mag = qf.abs() @ bf.abs().T
    if metric is not DistanceMetric.DOT:
        mag = (qf * qf).sum(-1)[:, None] + (bf * bf).sum(-1)[None, :] + 2.0 * mag
    groups = ref.shape[1]
    full = torch.zeros((q.shape[0], groups * 128), dtype=torch.float64, device=q.device)
    full[:, :valid] = mag
    tol = 1e-5 * full.view(q.shape[0], groups, 128).amax(-1)
    return torch.where(torch.isfinite(tol), tol, 0.0)


def nonfinite_case(n, device, b=8, d=384, seed=0):
    """float32 rows and queries with non-finite values and overflowing
    norms. Rows: group 20 scaled by 1.5e18 (squared norms overflow, every
    dot stays finite); group 30 with +Inf in column 3 and group 31 with
    -Inf in column 0; row 1000 all +Inf, row 5000 scaled by 1.5e18, row
    6000 with one -Inf, each in an otherwise finite group. Queries: 0 a
    self-match; 1 with a zero in column 3 (0 x Inf against group 30); 2 and
    3 with +1 and -1 there (DOT reads -inf, then +inf, over group 30); 4
    with +Inf in column 5; 5 scaled by 1.5e18; 6 with -Inf in column 0 (DOT
    -inf over group 31); 7 plain. n > 6000. No dot overflows: the sum of
    finite terms that overflows float32 takes its sign from the order of
    summation (an fmaf chain keeps the first infinite partial sum, cuBLAS
    can meet both signs and give NaN), so no kernel can match the twin
    there. chip_smoke.py runs K1 on this case too, at N = 100,003."""
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn((n, d), generator=gen, device=device)
    q = torch.randn((b, d), generator=gen, device=device)
    base[20 * 128 : 21 * 128] *= 1.5e18
    base[30 * 128 : 31 * 128, 3] = float("inf")
    base[31 * 128 : 32 * 128, 0] = float("-inf")
    base[1000] = float("inf")
    base[5000] *= 1.5e18
    base[6000, 7] = float("-inf")
    q[0] = base[10]
    q[1, 3] = 0.0
    q[2, 3] = 1.0
    q[3, 3] = -1.0
    q[4, 5] = float("inf")
    q[5] *= 1.5e18
    q[6, 0] = float("-inf")
    return q, base


def assert_k1_matches_twin(q, base, metric, valid, mask=None):
    """+inf and -inf positions equal, no NaN; integer minima equal, float
    minima within minima_tolerance."""
    got = block_minima(q, base, metric, valid, mask)
    want = block_minima_reference(q, base, metric, valid, mask)
    assert not bool(torch.isnan(got).any())
    assert torch.equal(torch.isposinf(got), torch.isposinf(want)), metric
    assert torch.equal(torch.isneginf(got), torch.isneginf(want)), metric
    fin = torch.isfinite(want)
    if base.dtype.is_floating_point:
        err = (got.double() - want.double()).abs()[fin]
        assert bool((err <= minima_tolerance(q, base, metric, valid, want)[fin]).all()), metric
    else:
        assert torch.equal(got, want), metric
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8], ids=str)
@pytest.mark.parametrize("d", [95, 100, 384])  # 1-byte, 4-byte and 16-byte staging
@pytest.mark.parametrize("b", [1, 8, 64, 65])  # query tiles of 8, 64 and two
def test_mma_body_integer_minima_are_bit_equal(cuda, dtype, d, b):
    q, base = case(dtype, 5003, d, b, cuda, seed=d + b)
    before = block_minima.body_launches["mma"]
    for metric in DOT_FAMILY:
        assert_k1_matches_twin(q, base, metric, 4990)
    assert block_minima.body_launches["mma"] == before + len(DOT_FAMILY)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", list(DistanceMetric), ids=lambda m: m.value)
def test_nonfinite_f32_keeps_the_twin_semantics(cuda, metric):
    """Inf, -Inf, NaN-making 0 x Inf and overflowing norms, unmasked and
    with each row mask: the same +inf and -inf groups as the twin, finite
    minima within tolerance; DOT over a +Inf column reads -inf."""
    q, base = nonfinite_case(7001, cuda)
    for kind in [None, *MASK_KINDS]:
        mask = None if kind is None else mask_case(kind, 7001, cuda, seed=3)
        got = assert_k1_matches_twin(q, base, metric, 6990, mask)
        if metric is DistanceMetric.DOT and kind is None:
            assert float(got[2, 30]) == float("-inf") and float(got[6, 31]) == float("-inf")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8, torch.int8], ids=str)
@pytest.mark.parametrize("kind", ["dead-group", "all-masked"])
def test_mma_body_rows_past_valid_and_masked_groups_read_inf(cuda, dtype, kind):
    """Rows >= valid (the last two groups and part of a third) and a group
    with no live row read +inf in the tensor-core body, at B = 8 and 65."""
    n, valid = 5003, 5003 - 300
    mask = mask_case(kind, n, cuda, seed=4)
    for b in (8, 65):
        q, base = case(dtype, n, 100, b, cuda, seed=b)
        before = block_minima.body_launches["mma"]
        for metric in DOT_FAMILY:
            for m in (None, mask):
                got = assert_k1_matches_twin(q, base, metric, valid, m)
                assert bool(torch.isinf(got[:, valid // 128 + 1 :]).all())
                if m is not None:
                    assert bool(torch.isinf(got[:, 1]).all())
        assert block_minima.body_launches["mma"] == before + 2 * len(DOT_FAMILY)


@pytest.mark.cuda
def test_mma_body_is_refused_where_it_does_not_apply(cuda):
    from sqlite_vector_tpu_torch.ops.block_scan import _launch_k1

    q, base = case(torch.float16, 300, 16, 2, cuda)
    with pytest.raises(ValueError, match="body"):
        _launch_k1(q, base, DistanceMetric.L2, 300, None, "mma")
    q, base = case(torch.float32, 300, 16, 2, cuda)
    with pytest.raises(ValueError, match="body"):
        _launch_k1(q, base, DistanceMetric.L1, 300, None, "mma")
    q, base = case(torch.float32, 300, 3425, 2, cuda)  # 8 query rows pass the budget
    with pytest.raises(ValueError, match="body"):
        _launch_k1(q, base, DistanceMetric.L2, 300, None, "mma")
    assert_k1_matches_twin(q, base, DistanceMetric.L2, 300)  # the CUDA-core body takes it


@pytest.mark.cuda
@pytest.mark.parametrize(
    "d,b,tile",
    # the widest f32 rows each query tile holds, and one column past them
    [(416, 64, 64), (417, 64, 32), (832, 32, 32), (833, 32, 16), (1024, 65, 16),
     (1696, 16, 16), (1697, 16, 8), (3424, 1, 8), (3424, 65, 8)],
)
def test_mma_body_at_the_widest_rows_of_each_query_tile(cuda, d, b, tile):
    """f32 rows up to d = 3,424 (several query tiles for B past the tile):
    the minima, a self-match's included, stay within tolerance of the twin,
    which needs the narrow tiles' per-chunk sums at large d."""
    from sqlite_vector_tpu_torch.ops.block_scan import mma_query_tile

    assert mma_query_tile(torch.float32, d, b) == tile
    q, base = case(torch.float32, 700, d, b, cuda, seed=d + b)
    before = block_minima.body_launches["mma"]
    for metric in DOT_FAMILY:
        assert_k1_matches_twin(q, base, metric, 690)
    assert block_minima.body_launches["mma"] == before + len(DOT_FAMILY)


# -- K2's tensor-core body (csrc/int4_minima_mma.cu) -------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d", [9, 16, 95, 384])  # 1-, 4- and 16-byte staging; odd d
@pytest.mark.parametrize("b", [1, 8, 64, 65, 200])  # query tiles of 8 and 64, and several
def test_k2_bodies_match_twin_and_each_other(cuda, d, b):
    """Both bodies of K2 for its 4 metrics, rows >= valid, unmasked and with
    each row mask: equal to the twin (tolerance 0) and to each other bit for
    bit; the routed call takes the tensor-core body."""
    tensors, _ = int4_case(5003, d, b, cuda, seed=d + b)
    masks = [None] + [mask_case(kind, 5003, cuda, seed=d) for kind in MASK_KINDS]
    for metric in K2_METRICS:
        for mask in masks:
            got = assert_k2_bodies_match_twin(tensors, metric, 4990, mask)
            assert bool(torch.isinf(got[:, -1]).all())  # rows >= valid only
        before = dict(int4_block_minima.body_launches)
        int4_block_minima(*tensors, metric, 4990)
        assert int4_block_minima.body_launches == {**before, "mma": before["mma"] + 1}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "d,b,tile",
    # the widest rows each query tile holds, and one column past them
    [(2048, 64, 64), (2049, 64, 32), (4096, 32, 32), (4097, 32, 16), (8192, 16, 16),
     (8193, 16, 8), (16384, 1, 8), (16384, 65, 8)],
)
def test_k2_tensor_core_body_at_the_widest_rows_of_each_query_tile(cuda, d, b, tile):
    from sqlite_vector_tpu_torch.ops.int4_scan import k2_query_tile

    assert k2_query_tile(d, b) == tile
    tensors, _ = int4_case(700, d, b, cuda, seed=d + b)
    for metric in K2_METRICS:
        assert_k2_bodies_match_twin(tensors, metric, 690)


@pytest.mark.cuda
def test_k2_tensor_core_body_is_refused_where_it_does_not_apply(cuda):
    """Past d = 16,384 not even 8 queries fit the tensor-core body's shared
    budget: forcing it raises, and the routed call takes the CUDA-core body
    and equals the twin."""
    from sqlite_vector_tpu_torch.ops.int4_scan import _launch_k2

    tensors, _ = int4_case(400, 16385, 2, cuda)
    with pytest.raises(ValueError, match="body"):
        _launch_k2(*tensors, DistanceMetric.L2, 400, None, "mma")
    before = dict(int4_block_minima.body_launches)
    got = int4_block_minima(*tensors, DistanceMetric.L2, 400)
    assert int4_block_minima.body_launches == {**before, "simt": before["simt"] + 1}
    assert_k2_matches_twin(got, int4_block_minima_reference(*tensors, DistanceMetric.L2, 400))


# -- host storage: scans streamed through pinned tiles (ops/streaming.py) ----


def _tiny_tiles(monkeypatch, row_bytes: int, rows: int = 257) -> None:
    from sqlite_vector_tpu_torch.ops import streaming

    monkeypatch.setattr(streaming, "DEFAULT_TILE_BYTES", rows * row_bytes)


@pytest.mark.cuda
def test_streamed_search_equals_the_device_search_bit_for_bit(cuda, tmp_path, monkeypatch):
    """Host storage with tiles of 257 rows (47 tiles): exact search over
    integer-valued float32 rows (every dot exact, so any summation order
    gives the same bits), int8 and int4 quantized search, each equal bit
    for bit to the same search of a device-storage load of the same
    directory; with so many small tiles a staging buffer refilled before
    its copy completed, or a device tile overwritten before its scan, would
    show. K1 and K2 launch for the streamed searches, in their tensor-core
    bodies."""
    rng = np.random.default_rng(21)
    base = rng.integers(-8, 9, (12_000, 64)).astype(np.float32)
    base[11_000] = base[17]  # a tie across tiles: the earlier row wins
    q = np.concatenate([base[[17, 6000]], rng.integers(-8, 9, (62, 64)).astype(np.float32)])
    d = str(tmp_path / "ds")
    svt.Dataset.from_arrays("s", base, options="dimension=64,distance=L2", device="cpu").save(d, shard_rows=5000)
    host = svt.Dataset.load(d, device="cuda", storage="host", mmap=True)
    dev = svt.Dataset.load(d, device="cuda")
    _tiny_tiles(monkeypatch, 64 * 4)
    block_minima.launches, block_minima.body_launches = 0, {"mma": 0, "simt": 0}
    for b in (1, 64):
        for got, want in zip(host.search(q[:b], 20), dev.search(q[:b], 20)):
            np.testing.assert_array_equal(got, want)
    assert host.search(q[0], 2)[0].tolist() == [18, 11_001]
    for qtype in ("int8", "int4"):
        for ds in (host, dev):
            ds.quantize(qtype=qtype)
        assert not isinstance(host._quant.codes, torch.Tensor)
        _tiny_tiles(monkeypatch, 64 if qtype == "int8" else 32 + 8)
        for b in (1, 64):
            for got, want in zip(host.search(q[:b], 20, exact=False), dev.search(q[:b], 20, exact=False)):
                np.testing.assert_array_equal(got, want)
    assert block_minima.launches > 0 and block_minima.body_launches["simt"] == 0
    assert int4_block_minima.launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [257, 32_768])  # the small and the large pool
def test_streamed_scan_after_work_queued_on_the_current_stream(cuda, tile):
    """Blocks freed while work that uses them is still queued on the current
    stream go back to the caching allocator at once, and the streamed
    scan's device tiles are taken from them. Tensors of a tile's size are
    freed behind a long sleep and a fill: the copies into the tiles must
    wait for that work, or the fill lands on the staged rows, and the int8
    scan right after would differ from the resident scan."""
    from sqlite_vector_tpu_torch.ops.scan import fused_scan_topk
    from sqlite_vector_tpu_torch.ops.streaming import streaming_scan_topk

    rng = np.random.default_rng(24)
    codes = rng.integers(-128, 128, (tile * 5 + 3, 64)).astype(np.int8)
    q = torch.from_numpy(rng.integers(-128, 128, (8, 64)).astype(np.int8)).to(cuda)
    want = fused_scan_topk(q, torch.from_numpy(codes).to(cuda), DistanceMetric.L2, 20)
    for _ in range(3):
        torch.cuda.synchronize()
        junk = [torch.empty((tile, 64), dtype=torch.int8, device=cuda) for _ in range(4)]
        torch.cuda._sleep(200_000_000)  # ~0.1 s of work queued ahead of the fill
        for j in junk:
            j.fill_(0)  # zero rows would rank first for every query
        del junk
        got = streaming_scan_topk(q, codes, DistanceMetric.L2, 20, tile_rows=tile)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_streamed_tiles_straddle_shards(cuda, tmp_path):
    """A ShardedRows source of uneven memory-mapped shards, with tiles that
    straddle shard boundaries, streams the right rows."""
    from sqlite_vector_tpu_torch.hostarray import ShardedRows
    from sqlite_vector_tpu_torch.ops.streaming import streaming_scan_topk

    rng = np.random.default_rng(22)
    base = rng.standard_normal((9000, 48)).astype(np.float32)
    parts = []
    for i, (s, e) in enumerate([(0, 1000), (1000, 1001), (1001, 5000), (5000, 9000)]):
        np.save(tmp_path / f"p{i}.npy", base[s:e])
        parts.append(np.load(tmp_path / f"p{i}.npy", mmap_mode="r"))
    q = torch.from_numpy(base[[3, 1000, 4999, 8999]]).to(cuda)
    got = streaming_scan_topk(q, ShardedRows(parts), DistanceMetric.L2, 9, tile_rows=333)
    want = streaming_scan_topk(q, base, DistanceMetric.L2, 9, tile_rows=333)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[1][:, 0].tolist() == [3, 1000, 4999, 8999]


@pytest.mark.cuda
def test_bf16_host_storage_loads_without_ml_dtypes(cuda, tmp_path):
    """bfloat16 rows load (host + mmap, and device storage) and search on
    the card with ml_dtypes hidden from the import path."""
    import subprocess
    import sys

    rng = np.random.default_rng(23)
    base = rng.standard_normal((3000, 32)).astype(np.float32)
    d = str(tmp_path / "bf")
    svt.Dataset.save_stream(d, [base[:1000], base[1000:]], options="dimension=32,type=FLOATB16")
    np.save(tmp_path / "base.npy", base)
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import numpy as np\n"
        "from sqlite_vector_tpu_torch import Dataset\n"
        "base = np.load(sys.argv[2])\n"
        "res = []\n"
        "for kw in ({'storage': 'host', 'mmap': True}, {'storage': 'hbm'}):\n"
        "    ds = Dataset.load(sys.argv[1], device='cuda', **kw)\n"
        "    ids, dist = ds.search(base[[7, 2000]], 5)\n"
        "    assert ids[:, 0].tolist() == [8, 2001] and (dist[:, 0] == 0).all(), (ids, dist)\n"
        "    res.append((ids, dist))\n"
        "assert all((a == b).all() for a, b in zip(*res))\n"
    )
    subprocess.run([sys.executable, "-c", code, d, str(tmp_path / "base.npy")], check=True, timeout=300)


def sql_table(path, rows):
    import sqlite3

    c = sqlite3.connect(path)
    c.execute("CREATE TABLE docs (id INTEGER PRIMARY KEY, v BLOB)")
    c.executemany("INSERT INTO docs (v) VALUES (?)", ((r.tobytes(),) for r in rows))
    c.commit()
    c.close()


@pytest.mark.cuda
def test_sql_full_scan_launches_k1_and_equals_the_dataset(cuda, tmp_path):
    """SQL vector_full_scan on the card (connect() with no device): one K1
    launch on its tensor-core body a call, the Dataset's result."""
    import sqlite_vector_tpu_torch.sqlite as psql

    rows = np.random.default_rng(4).standard_normal((6000, 64)).astype(np.float32)
    sql_table(str(tmp_path / "t.db"), rows)
    conn = psql.connect(str(tmp_path / "t.db"))
    assert conn.device.type == "cuda"
    conn.vector_init("docs", "v", "dimension=64,type=FLOAT32,distance=L2")
    ref = svt.Dataset.from_arrays("ref", rows, device=cuda)
    for q in rows[[3, 4000]] + np.float32(1e-3):
        conn.vector_full_scan("docs", "v", q, 10)  # loads the table
        before, mma = block_minima.launches, block_minima.body_launches["mma"]
        got = conn.vector_full_scan("docs", "v", q, 10)
        assert block_minima.launches == before + 1 and block_minima.body_launches["mma"] == mma + 1
        ids, dist = ref.search(q, 10)
        assert [r[0] for r in got] == ids.tolist()
        np.testing.assert_allclose([r[1] for r in got], dist, rtol=1e-5, atol=1e-6)
    conn.close()


@pytest.mark.cuda
def test_sql_int4_quantize_scan_launches_k2_and_equals_the_dataset(cuda, tmp_path):
    """SQL vector_quantize(..., 'qtype=INT4') and vector_quantize_scan on
    the card, own connection and a second one reading the shadow table:
    K2 on its tensor-core body, bit-equal to the Dataset's int4 search."""
    import sqlite_vector_tpu_torch.sqlite as psql

    rows = np.random.default_rng(5).standard_normal((6000, 64)).astype(np.float32)
    path = str(tmp_path / "t.db")
    sql_table(path, rows)
    conn = psql.connect(path)
    conn.vector_init("docs", "v", "dimension=64,type=FLOAT32,distance=L2")
    conn.vector_quantize("docs", "v", "qtype=INT4")
    ref = svt.Dataset.from_arrays("ref", rows, device=cuda)
    ref.quantize(qtype="int4")
    other = psql.connect(path)
    other.vector_init("docs", "v", "dimension=64,type=FLOAT32,distance=L2")
    q = rows[11]
    ids, dist = ref.search(q, 10, mode="quantized")
    for c in (conn, other):
        before, mma = int4_block_minima.launches, int4_block_minima.body_launches["mma"]
        got = c.vector_quantize_scan("docs", "v", q, 10)
        assert int4_block_minima.launches == before + 1 and int4_block_minima.body_launches["mma"] == mma + 1
        assert [r[0] for r in got] == ids.tolist()
        assert [r[1] for r in got] == dist.astype(np.float64).tolist()
    conn.close()
    other.close()
