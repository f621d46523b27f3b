"""The port's CUDA kernels on the card: K1 (csrc/block_minima_wgmma.cu,
csrc/block_minima_mma.cu and csrc/block_minima.cu), K2
(csrc/int4_minima_wgmma.cu and csrc/int4_minima_mma.cu), the int8/u8
finish's rescore
(csrc/rescore_codes.cu) and the float finish's (csrc/rescore_rows.cu),
unmasked and with row masks, and the searches that launch them.

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
from sqlite_vector_tpu_torch.ops.block_scan import tma_ready
from sqlite_vector_tpu_torch.ops.int4_scan import (
    int4_block_minima,
    int4_block_minima_reference,
    k2_body,
    k2_wgmma_plan,
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


def k2_bodies(tensors):
    """The bodies of K2 that take these codes: both where the route takes
    the wgmma body (TMA copies the packed rows), else the mma.sync body."""
    packed = tensors[2]
    wgmma = k2_body(tensors[0].shape[1], tma_ready(packed)) == "wgmma"
    return ("wgmma", "mma") if wgmma else ("mma",)


def assert_k2_bodies_match_twin(tensors, metric, valid, mask=None, streamed=None):
    """K2 forced into each body that takes the codes (_launch_k2,
    k2_bodies): each against the twin as assert_k2_matches_twin holds it,
    and the bodies equal bit for bit (float32 bit patterns). `streamed`
    forces the wgmma body's query tile resident or streamed. Returns the
    mma.sync body's minima."""
    from sqlite_vector_tpu_torch.ops.int4_scan import _launch_k2

    want = int4_block_minima_reference(*tensors, metric, valid, mask)
    got = {body: _launch_k2(*tensors, metric, valid, mask, body, streamed if body == "wgmma" else None)
           for body in k2_bodies(tensors)}
    torch.cuda.synchronize()
    for minima in got.values():
        assert_k2_matches_twin(minima, want)
    for body, minima in got.items():
        assert torch.equal(minima.view(torch.int32), got["mma"].view(torch.int32)), (metric, body)
    return got["mma"]


@pytest.mark.cuda
def test_int4_kernel_unaligned_packed_rows(cuda):
    """A packed view that starts off a 16-byte boundary takes the 1-byte
    staging in the mma.sync body and still equals the twin;
    TMA cannot copy it, so the route takes the mma.sync body and the wgmma
    body refuses it."""
    from sqlite_vector_tpu_torch.ops.int4_scan import _launch_k2

    (qc, qs, packed, alpha, csq), _ = int4_case(1000, 64, 2, cuda, seed=4)
    view = packed.view(-1)[1 : 1 + 999 * 32].view(999, 32)  # row 0 at byte 1
    tensors = (qc, qs, view, alpha[:999], csq[:999])
    assert k2_bodies(tensors) == ("mma",)
    assert_k2_bodies_match_twin(tensors, DistanceMetric.L2, 999)
    before = dict(int4_block_minima.body_launches)
    int4_block_minima(*tensors, DistanceMetric.L2, 999)
    assert int4_block_minima.body_launches == {**before, "mma": before["mma"] + 1}
    with pytest.raises(ValueError, match="TMA"):
        _launch_k2(*tensors, DistanceMetric.L2, 999, None, "wgmma")


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
    assert k2_body(96) == "wgmma"  # 48 packed bytes a row
    for device in ("cuda", "cpu"):
        ds = svt.VectorStore(device=device).create("d", f"dimension=96,distance={metric.value}")
        ds.add(base)
        ds.quantize(qtype="int4", refine=True)
        before = (int4_block_minima.launches, int4_block_minima.body_launches["wgmma"])
        results.append((ds.search(q, 9, mode="quantized"), ds.search(q, 9, mode="refine")))
        if device == "cuda":
            launched = int4_block_minima.launches - before[0]
            assert launched == (0 if metric is DistanceMetric.L1 else 2)
            assert int4_block_minima.body_launches["wgmma"] - before[1] == launched
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
                                      (block_scan, "rescore_groups_reference"),
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
    distance and count 0; a non-finite magnitude leaves no room. Computed
    over slices of 65,536 rows, so no float64 copy of a large matrix is
    made."""
    if metric is DistanceMetric.COSINE:
        return torch.full_like(ref, 1e-5, dtype=torch.float64)
    if metric is DistanceMetric.L1:
        return 1e-5 * (ref.double().abs() + 1.0)
    qf = q.double()
    groups = ref.shape[1]
    full = torch.zeros((q.shape[0], groups * 128), dtype=torch.float64, device=q.device)
    for s in range(0, valid, 1 << 16):
        bf = base[s : min(valid, s + (1 << 16))].double()
        bf = torch.where(torch.isfinite(bf).all(-1, keepdim=True), bf, 0.0)
        mag = qf.abs() @ bf.abs().T
        if metric is not DistanceMetric.DOT:
            mag = (qf * qf).sum(-1)[:, None] + (bf * bf).sum(-1)[None, :] + 2.0 * mag
        full[:, s : s + bf.shape[0]] = mag
    tol = 1e-5 * full.view(q.shape[0], groups, 128).amax(-1)
    return torch.where(torch.isfinite(tol), tol, 0.0)


def nonfinite_case(n, device, b=8, d=384, seed=0, dtype=torch.float32):
    """Rows and queries with non-finite values and overflowing norms, made
    in float32 and cast to dtype (bfloat16 keeps the 1.5e18 values, float16
    turns them into +-Inf). Rows: group 20 scaled by 1.5e18 (squared norms overflow, every
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
    return q.to(dtype), base.to(dtype)


def assert_k1_matches_twin(q, base, metric, valid, mask=None, body=None):
    """K1, routed or in `body`: +inf and -inf positions equal, no NaN;
    integer minima equal, float minima within minima_tolerance."""
    from sqlite_vector_tpu_torch.ops.block_scan import _launch_k1

    if body is None:
        got = block_minima(q, base, metric, valid, mask)
    else:
        got = _launch_k1(q, base, metric, valid, mask, body)
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


# K1's two tensor-core bodies: the wgmma body takes float rows TMA copies,
# the mma.sync body every float dot-family scan (the cross-check)
FLOAT_BODIES = ["mma", "wgmma"]


@pytest.mark.cuda
@pytest.mark.parametrize("body", FLOAT_BODIES)
@pytest.mark.parametrize("metric", list(DistanceMetric), ids=lambda m: m.value)
def test_nonfinite_f32_keeps_the_twin_semantics(cuda, metric, body):
    """Inf, -Inf, NaN-making 0 x Inf and overflowing norms, unmasked and
    with each row mask, in each tensor-core body (L1 in its own): the same
    +inf and -inf groups as the twin, finite minima within tolerance; DOT
    over a +Inf column reads -inf."""
    q, base = nonfinite_case(7001, cuda)
    forced = None if metric is DistanceMetric.L1 else body
    for kind in [None, *MASK_KINDS]:
        mask = None if kind is None else mask_case(kind, 7001, cuda, seed=3)
        got = assert_k1_matches_twin(q, base, metric, 6990, mask, forced)
        if metric is DistanceMetric.DOT and kind is None:
            assert float(got[2, 30]) == float("-inf") and float(got[6, 31]) == float("-inf")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,body",
    [(torch.float32, "mma"), (torch.float32, "wgmma"), (torch.uint8, "mma"), (torch.int8, "mma")],
    ids=str,
)
@pytest.mark.parametrize("kind", ["dead-group", "all-masked"])
def test_mma_body_rows_past_valid_and_masked_groups_read_inf(cuda, dtype, kind, body):
    """Rows >= valid (the last two groups and part of a third) and a group
    with no live row read +inf in each tensor-core body, at B = 8 and 65."""
    n, valid = 5003, 5003 - 300
    mask = mask_case(kind, n, cuda, seed=4)
    for b in (8, 65):
        q, base = case(dtype, n, 100, b, cuda, seed=b)
        before = block_minima.body_launches[body]
        for metric in DOT_FAMILY:
            for m in (None, mask):
                got = assert_k1_matches_twin(q, base, metric, valid, m, body)
                assert bool(torch.isinf(got[:, valid // 128 + 1 :]).all())
                if m is not None:
                    assert bool(torch.isinf(got[:, 1]).all())
        assert block_minima.body_launches[body] == before + 2 * len(DOT_FAMILY)


@pytest.mark.cuda
def test_mma_body_is_refused_where_it_does_not_apply(cuda):
    """The wrapper refuses L1 and codes past the int32 bound in the MMA
    body (the CUDA-core body takes them), and the kernel refuses a query
    tile it has no instance for, resident or streamed: the launch returns
    an error (the wrapper raises on it), nothing falls back."""
    from sqlite_vector_tpu_torch.ops._build import load_library
    from sqlite_vector_tpu_torch.ops.block_scan import _launch_k1

    q, base = case(torch.uint8, 300, 33026, 2, cuda)  # an int32 sum could overflow
    with pytest.raises(ValueError, match="body"):
        _launch_k1(q, base, DistanceMetric.L2, 300, None, "mma")
    assert_k1_matches_twin(q, base, DistanceMetric.L2, 300)  # the CUDA-core body takes it
    q, base = case(torch.bfloat16, 300, 16, 2, cuda)
    with pytest.raises(ValueError, match="body"):
        _launch_k1(q, base, DistanceMetric.L1, 300, None, "mma")
    q, base = case(torch.float32, 300, 3425, 2, cuda)
    out = torch.empty((2, 3), device=cuda)
    lib = load_library()
    stream = torch.cuda.current_stream().cuda_stream
    args = [q.data_ptr(), base.data_ptr(), None, out.data_ptr(), 2, 300, 3425, 300, 0, 0]
    for tile in (0, 12, 128):  # no instance: 8, 16, 32 and 64 only
        assert lib.svt_block_minima_mma(*args, tile, 1, stream) != 0
        assert lib.svt_block_minima_mma(*args, tile, 0, stream) != 0
    # the wgmma body: codes, rows whose pitch TMA does not take, and
    # unaligned starts are refused by the wrapper and by the kernel
    with pytest.raises(ValueError, match="body"):
        _launch_k1(q, base, DistanceMetric.L2, 300, None, "wgmma")
    q, base = case(torch.uint8, 300, 384, 2, cuda)
    with pytest.raises(ValueError, match="body"):
        _launch_k1(q, base, DistanceMetric.L2, 300, None, "wgmma")
    q, base = case(torch.float32, 301, 384, 2, cuda)
    shifted = base.view(-1)[1 : 1 + 300 * 384].view(300, 384)
    with pytest.raises(ValueError, match="body"):
        _launch_k1(q, shifted, DistanceMetric.L2, 300, None, "wgmma")
    wargs = [q.data_ptr(), q.data_ptr(), shifted.data_ptr(), None, out.data_ptr(), 2, 300, 384, 300, 0, 0]
    assert lib.svt_block_minima_wgmma(*wargs, 8, 0, 0, stream) != 0
    wargs[2] = base.data_ptr()
    for tile in (0, 12, 128):
        assert lib.svt_block_minima_wgmma(*wargs, tile, 0, 0, stream) != 0
        assert lib.svt_block_minima_wgmma(*wargs, tile, 1, 0, stream) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 383), (torch.float16, 385), (torch.bfloat16, 100)], ids=str)
def test_rows_tma_cannot_copy_route_to_the_mma_sync_body(cuda, dtype, d):
    """Float rows whose pitch is not a multiple of 16 bytes (f32 d = 383,
    16-bit d = 385 and 100), and rows of a TMA-legal width that start off a
    16-byte boundary, route to the mma.sync body and match the twin."""
    from sqlite_vector_tpu_torch.ops.block_scan import k1_body, tma_ready

    q, base = case(dtype, 5003, d, 9, cuda, seed=d)
    assert not tma_ready(base)
    wide = torch.zeros((5004 * 384,), dtype=dtype, device=cuda)
    shifted = wide[1 : 1 + 5003 * 384].view(5003, 384)
    shifted.copy_(case(dtype, 5003, 384, 9, cuda, seed=d)[1])
    q384 = case(dtype, 5003, 384, 9, cuda, seed=d)[0]
    assert k1_body(dtype, DistanceMetric.L2, 384) == "wgmma" and not tma_ready(shifted)
    for qq, bb in ((q, base), (q384, shifted)):
        for metric in DOT_FAMILY:
            before = dict(block_minima.body_launches)
            assert_k1_matches_twin(qq, bb, metric, 4990)
            assert block_minima.body_launches == {**before, "mma": before["mma"] + 1}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "body,d,b,plan",
    # the mma.sync body: the widest f32 rows each query tile holds, and one
    # column past them ((tile, streamed))
    [("mma", d, b, (tile, d > 3424)) for d, b, tile in [
        (416, 64, 64), (417, 64, 32), (832, 32, 32), (833, 32, 16), (1024, 65, 16),
        (1696, 16, 16), (1697, 16, 8), (3424, 1, 8), (3424, 65, 8), (3425, 1, 8), (3425, 65, 64)]]
    # the wgmma body: the widest f32 rows whose two query planes each
    # resident tile holds, and the next TMA-legal width, streamed
    + [("wgmma", d, b, plan) for d, b, plan in [
        (192, 64, (64, False)), (196, 64, (64, True)), (384, 32, (32, False)), (388, 32, (32, True)),
        (768, 16, (16, False)), (772, 16, (16, True)), (1536, 8, (8, False)), (1536, 65, (64, True)),
        (1540, 8, (8, True)), (3424, 65, (64, True))]],
    ids=str,
)
def test_mma_body_at_the_widest_rows_of_each_query_tile(cuda, body, d, b, plan):
    """f32 rows at the edges of each tensor-core body's resident query
    tiles and past them on streamed ones (several query tiles for B past
    the tile): the minima, a self-match's included, stay within tolerance
    of the twin, which needs the narrow tiles' per-chunk sums at large d."""
    from sqlite_vector_tpu_torch.ops.block_scan import mma_query_tile, mma_streams_queries, wgmma_plan

    if body == "mma":
        assert (mma_query_tile(torch.float32, d, b), mma_streams_queries(torch.float32, d)) == plan
    else:
        assert wgmma_plan(torch.float32, d, b) == plan
    q, base = case(torch.float32, 700, d, b, cuda, seed=d + b)
    before = block_minima.body_launches[body]
    for metric in DOT_FAMILY:
        assert_k1_matches_twin(q, base, metric, 690, body=body)
    assert block_minima.body_launches[body] == before + len(DOT_FAMILY)


# rows past the resident query tile's widths (f32 3,424, 16-bit 6,848,
# codes 13,696): the streamed tiles
STREAMED = [(torch.float32, 3425), (torch.float32, 4096), (torch.float32, 8192),
            (torch.float16, 6849), (torch.bfloat16, 6849), (torch.float16, 8192),
            (torch.bfloat16, 8192), (torch.uint8, 13697), (torch.int8, 13697)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,d,body",
    [(dt, d, "mma") for dt, d in STREAMED]
    + [(dt, d, "wgmma") for dt, d in STREAMED if dt.is_floating_point and d * dt.itemsize % 16 == 0],
    ids=str,
)
@pytest.mark.parametrize("b", [1, 9, 64, 65])  # tiles of 8, 16 and 64, and two of 64
def test_streamed_mma_body_matches_twin_and_cuda_core_body(cuda, dtype, d, b, body):
    """Each tensor-core body with its query tile streamed beside the rows
    (the wgmma body at the widths TMA takes): every dot-family metric, unmasked and with each row mask, rows >= valid,
    a NaN row and (floats) a row with +Inf (the non-finite recompute), a
    self-match, over 34,003 rows (more row tiles than SMs: a block's later
    tiles reuse the query norms summed in its first). Codes equal the twin
    and the CUDA-core body bit for bit; floats within minima_tolerance of
    the twin (1e-5 of the magnitude each minimum accumulates, as at the
    resident widths: no band widens with d) and within twice it of the
    CUDA-core body."""
    from sqlite_vector_tpu_torch.ops.block_scan import _launch_k1, k1_body, mma_streams_queries, wgmma_plan

    n, valid = 34_003, 34_003 - 300
    q, base = case(dtype, n, d, b, cuda, seed=d + b)
    if dtype.is_floating_point:
        base[300, 7] = float("inf")
    masks = [None] + [mask_case(kind, n, cuda, seed=d) for kind in MASK_KINDS]
    for metric in DOT_FAMILY:
        if body == "wgmma":
            assert k1_body(dtype, metric, d) == "wgmma" and wgmma_plan(dtype, d, b)[1]
        else:
            assert k1_body(dtype, metric, d) in ("mma", "wgmma") and mma_streams_queries(dtype, d)
        for mask in masks:
            before = block_minima.body_launches[body]
            got = assert_k1_matches_twin(q, base, metric, valid, mask, body)
            assert block_minima.body_launches[body] == before + 1
            assert bool(torch.isinf(got[:, valid // 128 + 1 :]).all())
            simt = _launch_k1(q, base, metric, valid, mask, "simt")
            torch.cuda.synchronize()
            if not dtype.is_floating_point:
                assert torch.equal(got, simt)
                continue
            want = block_minima_reference(q, base, metric, valid, mask)
            tol = minima_tolerance(q, base, metric, valid, want)
            fin = torch.isfinite(want)
            assert torch.equal(torch.isinf(simt), torch.isinf(got))
            assert bool(((got.double() - simt.double()).abs()[fin] <= 2 * tol[fin]).all())


def assert_close_to_twin(got, want):
    """Float minima against the twin: +inf and -inf positions equal, no NaN,
    finite minima within rtol 1e-5 and atol 1e-3 (f32 sums in another
    order)."""
    assert not bool(torch.isnan(got).any())
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16], ids=str)
@pytest.mark.parametrize(
    "d,body",
    # 6,848: the widest resident 16-bit row of the mma.sync body; the
    # wgmma body takes 104 (TMA-legal) for 100 and keeps 3,424 and 6,848
    # resident at 8 queries and streamed past them
    [(d, "mma") for d in (100, 384, 3424, 6848)] + [(d, "wgmma") for d in (104, 384, 3424, 6848)],
    ids=str,
)
@pytest.mark.parametrize("b", [1, 8, 9, 33, 64, 65, 200])  # the query tiles' edges
def test_16bit_mma_body_matches_twin_and_cuda_core_body(cuda, dtype, d, b, body):
    """float16 and bfloat16 rows on each tensor-core body (f16/bf16 MMA, f32
    sums, per-chunk sums for the 8- and 16-query tiles): every dot-family
    metric, unmasked and with each row mask, against the twin and the
    CUDA-core body. Up to d = 384 within rtol 1e-5 and atol 1e-3 (f32 sums
    in another order); at every d within minima_tolerance, 1e-5 of the
    magnitude each minimum accumulates, as the f32 tensor-core body is held:
    at d = 6,848 the CUDA-core body's fmaf chains sit ~1e-5 of the value
    off the twin, and a self-match's L2, whose norms are fmaf chains and
    whose dot comes from the tensor cores, reads up to ~0.06 where the
    twin's clamp reads 0 (the finish's exact rescore still returns 0)."""
    from sqlite_vector_tpu_torch.ops.block_scan import _launch_k1, k1_body

    q, base = case(dtype, 5003, d, b, cuda, seed=d + b)
    masks = [None] + [mask_case(kind, 5003, cuda, seed=d) for kind in MASK_KINDS]
    for metric in DOT_FAMILY:
        assert k1_body(dtype, metric, d) == ("wgmma" if d % 8 == 0 else "mma")
        for mask in masks:
            before = block_minima.body_launches[body]
            got = assert_k1_matches_twin(q, base, metric, 4990, mask, body)
            assert block_minima.body_launches[body] == before + 1
            simt = _launch_k1(q, base, metric, 4990, mask, "simt")
            torch.cuda.synchronize()
            want = block_minima_reference(q, base, metric, 4990, mask)
            tol = minima_tolerance(q, base, metric, 4990, want)
            fin = torch.isfinite(want)
            assert torch.equal(torch.isinf(simt), torch.isinf(got))
            assert bool(((got.double() - simt.double()).abs()[fin] <= 2 * tol[fin]).all())
            if d <= 384:
                assert_close_to_twin(got, want)
                assert_close_to_twin(got, simt)


@pytest.mark.cuda
@pytest.mark.parametrize("body", FLOAT_BODIES)
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16], ids=str)
@pytest.mark.parametrize("metric", list(DistanceMetric), ids=lambda m: m.value)
def test_nonfinite_16bit_keeps_the_twin_semantics(cuda, dtype, metric, body):
    """16-bit rows with +-Inf, NaN-making 0 x Inf and (bfloat16) squared
    norms past float32's range, unmasked and with each row mask: each
    tensor-core body and the CUDA-core body give the twin's +inf and -inf groups and finite minima within
    tolerance; DOT over a +Inf column reads -inf."""
    from sqlite_vector_tpu_torch.ops.block_scan import _launch_k1

    q, base = nonfinite_case(7001, cuda, dtype=dtype)
    forced = None if metric is DistanceMetric.L1 else body
    for kind in [None, *MASK_KINDS]:
        mask = None if kind is None else mask_case(kind, 7001, cuda, seed=3)
        got = assert_k1_matches_twin(q, base, metric, 6990, mask, forced)
        if metric is not DistanceMetric.L1:
            simt = _launch_k1(q, base, metric, 6990, mask, "simt")
            torch.cuda.synchronize()
            assert_close_to_twin(simt, block_minima_reference(q, base, metric, 6990, mask))
        if metric is DistanceMetric.DOT and kind is None:
            assert float(got[2, 30]) == float("-inf") and float(got[6, 31]) == float("-inf")


# -- K1's L1 body (csrc/block_minima.cu:l1_minima_kernel) --------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [95, 100, 384, 3000])  # 1-, 4- and 16-byte staging; many chunks
def test_l1_body_matches_twin(cuda, dtype, d):
    """L1 on the CUDA-core body for every dtype, B at the query tiles' edges
    (8, 16, 32, 64 and several tiles), unmasked and with each row mask,
    rows >= valid at +inf: codes equal to the twin bit for bit, floats
    within rtol 1e-5 and atol 1e-3 (f32 sums in another order)."""
    n, valid = 5003, 5003 - 300
    masks = [None] + [mask_case(kind, n, cuda, seed=d) for kind in MASK_KINDS]
    for b in (1, 8, 9, 17, 33, 64, 65, 200):
        q, base = case(dtype, n, d, b, cuda, seed=d + b)
        for mask in masks:
            before = block_minima.body_launches["simt"]
            got = block_minima(q, base, DistanceMetric.L1, valid, mask)
            assert block_minima.body_launches["simt"] == before + 1
            want = block_minima_reference(q, base, DistanceMetric.L1, valid, mask)
            torch.cuda.synchronize()
            assert bool(torch.isinf(got[:, valid // 128 + 1 :]).all())
            if dtype.is_floating_point:
                assert_close_to_twin(got, want)
            else:
                assert torch.equal(got, want)


# -- K2's tensor-core body (csrc/int4_minima_mma.cu) -------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d", [9, 16, 95, 97, 384])  # 1-, 4- and 16-byte staging; odd d
@pytest.mark.parametrize("b", [1, 8, 64, 65, 200])  # query tiles of 8 and 64, and several
def test_k2_bodies_match_twin_and_each_other(cuda, d, b):
    """Every body of K2 that takes the codes, for its 4 metrics, rows >=
    valid, unmasked and with each row mask: equal to the twin (tolerance 0)
    and to each other bit for bit; the routed call takes the wgmma body
    where TMA copies the packed rows (d = 95, 384: 48 and 192 bytes), the
    mma.sync body elsewhere (d = 9, 16, 97: 5, 8 and 49 bytes)."""
    tensors, _ = int4_case(5003, d, b, cuda, seed=d + b)
    masks = [None] + [mask_case(kind, 5003, cuda, seed=d) for kind in MASK_KINDS]
    body = "wgmma" if d in (95, 384) else "mma"
    assert k2_bodies(tensors)[0] == body
    for metric in K2_METRICS:
        for mask in masks:
            got = assert_k2_bodies_match_twin(tensors, metric, 4990, mask)
            assert bool(torch.isinf(got[:, -1]).all())  # rows >= valid only
        before = dict(int4_block_minima.body_launches)
        int4_block_minima(*tensors, metric, 4990)
        assert int4_block_minima.body_launches == {**before, body: before[body] + 1}


# the wgmma body's resident and streamed query tiles at each width: every
# width takes a streamed tile, and a resident one where it fits the shared
# budget (not at d = 18,432)
K2_WGMMA_CASES = [
    (d, streamed)
    for d in (64, 383, 384, 768, 4096, 8192, 16384, 18432)
    for streamed in (False, True)
    if streamed or k2_wgmma_plan(d, 1, False)[0]
]


@pytest.mark.cuda
@pytest.mark.parametrize("d,streamed", K2_WGMMA_CASES)
def test_k2_wgmma_body_matches_twin_and_each_other(cuda, d, streamed):
    """K2's wgmma body with its query tile forced resident or streamed, B in
    1, 7, 8, 9, 33, 64, 65 and 130 (each tile's edges, several tiles), for
    the 4 metrics, rows >= valid, unmasked and with each row mask: equal to
    the twin (tolerance 0) and to the mma.sync body bit for bit (torch.equal
    of the float32 bits)."""
    # the last group's rows all at or past valid
    n, valid = (5003, 4990) if d <= 768 else (1411, 1408)
    masks = [None] + [mask_case(kind, n, cuda, seed=d) for kind in MASK_KINDS]
    for b in (1, 7, 8, 9, 33, 64, 65, 130):
        tensors, _ = int4_case(n, d, b, cuda, seed=d + b)
        assert k2_bodies(tensors) == ("wgmma", "mma")
        for metric in K2_METRICS:
            for mask in masks:
                got = assert_k2_bodies_match_twin(tensors, metric, valid, mask, streamed)
                assert bool(torch.isinf(got[:, -1]).all())  # rows >= valid only


@pytest.mark.cuda
@pytest.mark.parametrize(
    "d,b,tile",
    # the widest rows each resident query tile holds in the shared budget,
    # and one column past them (the next narrower tile)
    [(2048, 64, 64), (2049, 64, 32), (4096, 32, 32), (4097, 32, 16), (8192, 16, 16),
     (8193, 16, 8), (16384, 1, 8), (16384, 65, 8)],
)
def test_k2_tensor_core_body_at_the_widest_rows_of_each_query_tile(cuda, d, b, tile):
    """The resident tile forced at its widest rows, and the routed call
    (the tile streamed at each of these shapes: its planes would pass the
    route's 65,536 bytes), equal to the twin and to the wgmma body bit for
    bit where it takes the rows."""
    from sqlite_vector_tpu_torch.ops.int4_scan import _launch_k2, k2_query_tile

    assert k2_query_tile(d, b, False) == tile
    tensors, _ = int4_case(700, d, b, cuda, seed=d + b)
    for metric in K2_METRICS:
        want = assert_k2_bodies_match_twin(tensors, metric, 690)
        got = _launch_k2(*tensors, metric, 690, None, "mma", False)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), metric


@pytest.mark.cuda
def test_k2_tensor_core_body_is_refused_where_it_does_not_apply(cuda):
    """Past d = 16,384 not even 8 queries fit the tensor-core body's shared
    budget: forcing the resident tile raises, and the routed call takes
    the tensor-core body with the query tile streamed, equal to the twin
    and to the wgmma body."""
    from sqlite_vector_tpu_torch.ops.int4_scan import _launch_k2

    tensors, _ = int4_case(400, 16385, 2, cuda)
    with pytest.raises(ValueError, match="resident"):
        _launch_k2(*tensors, DistanceMetric.L2, 400, None, "mma", False)
    before = dict(int4_block_minima.body_launches)
    streamed = int4_block_minima.streamed_launches
    got = int4_block_minima(*tensors, DistanceMetric.L2, 400)
    assert int4_block_minima.body_launches == {**before, "mma": before["mma"] + 1}
    assert int4_block_minima.streamed_launches == streamed + 1
    assert_k2_matches_twin(got, int4_block_minima_reference(*tensors, DistanceMetric.L2, 400))
    assert torch.equal(got, assert_k2_bodies_match_twin(tensors, DistanceMetric.L2, 400))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16385, 16400, 18432, 18433, 32768])  # odd and even h, 16-byte rows
@pytest.mark.parametrize("b", [1, 8, 64, 65])  # streamed tiles of 8 and 64, and two of 64
def test_streamed_k2_body_matches_twin_and_cuda_core_body(cuda, d, b):
    """K2's tensor-core body with its query tile streamed beside the codes
    (every d past 16,384): its 4 metrics, rows >= valid, unmasked and with
    each row mask, over 3,003 rows (more ring steps than one row tile's),
    valid 2,900: equal to the twin (tolerance 0) and to the wgmma body bit
    for bit where it takes the rows, each call counted as streamed."""
    from sqlite_vector_tpu_torch.ops.int4_scan import k2_streams_queries

    assert k2_streams_queries(d, b)
    tensors, _ = int4_case(3003, d, b, cuda, seed=d + b)
    masks = [None] + [mask_case(kind, 3003, cuda, seed=d) for kind in MASK_KINDS]
    # the bodies that run: both stream at these widths
    streaming = len(k2_bodies(tensors))
    assert streaming == 1 or k2_wgmma_plan(d, b)[1]
    for metric in K2_METRICS:
        for mask in masks:
            before = int4_block_minima.streamed_launches
            got = assert_k2_bodies_match_twin(tensors, metric, 2900, mask)
            assert int4_block_minima.streamed_launches == before + streaming
            assert bool(torch.isinf(got[:, -1]).all())  # rows >= valid only


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4096, 8192, 16384])
@pytest.mark.parametrize("b", [1, 64])
def test_k2_resident_and_streamed_tiles_agree(cuda, d, b):
    """Where both fit, the resident query tile (at B=64 several narrow
    tiles) and the streamed one give the same minima bit for bit, equal to
    the twin and to the wgmma body, for the 4 metrics with a row mask."""
    from sqlite_vector_tpu_torch.ops.int4_scan import _launch_k2

    tensors, _ = int4_case(1500, d, b, cuda, seed=d + b)
    mask = mask_case("half", 1500, cuda, seed=d)
    for metric in K2_METRICS:
        want = assert_k2_bodies_match_twin(tensors, metric, 1490, mask)
        for streamed in (False, True):
            got = _launch_k2(*tensors, metric, 1490, mask, "mma", streamed)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (metric, streamed)


@pytest.mark.cuda
def test_k2_wgmma_work_counters_are_left_zero_on_each_stream(cuda):
    """The wgmma body hands out groups from per-stream work counters that
    each launch leaves zero: launches back to back on the current stream
    and on a side stream (two query tiles a launch), each equal to the
    mma.sync body bit for bit, and the counters zero after them."""
    from sqlite_vector_tpu_torch.ops import int4_scan

    tensors, _ = int4_case(5003, 384, 65, cuda, seed=7)
    want = int4_scan._launch_k2(*tensors, DistanceMetric.L2, 4990, None, "mma")
    side = torch.cuda.Stream()
    got = [int4_scan._launch_k2(*tensors, DistanceMetric.L2, 4990, None, "wgmma") for _ in range(3)]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got += [int4_scan._launch_k2(*tensors, DistanceMetric.L2, 4990, None, "wgmma") for _ in range(2)]
    torch.cuda.synchronize()
    for minima in got:
        assert torch.equal(minima.view(torch.int32), want.view(torch.int32))
    for stream in (torch.cuda.current_stream(), side):
        buf = int4_scan._WORK_COUNTERS[(cuda.index or 0, stream.cuda_stream)]
        assert not bool(buf.any())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 65])
def test_k2_exact_where_unbiased_sums_pass_int32(cuda, b):
    """d = 1,200,000: rows of int4 code +7 (nibble 15) in most columns and
    a query of code +127 in every column (N = 300), so unbiased nibble sums
    would reach ~15 * 127 * d > 2^31, while the bodies' partial sums, the
    -8 bias in their start, stay within 1,016 d < 2^31; both must equal the
    twin's exact dot (float64) bit for bit, streamed."""
    from sqlite_vector_tpu_torch.ops.int4_scan import k2_streams_queries

    n, d = 300, 1_200_000
    gen = torch.Generator(device=cuda).manual_seed(b)
    x = torch.ones((n, d), device=cuda)  # code +7 where 1.0 is the row's largest value
    x[:, :50_000] = torch.rand((n, 50_000), generator=gen, device=cuda)  # rows differ here
    x[::7] = torch.randn((n // 7 + 1, d), generator=gen, device=cuda)  # and some N(0, 1) rows
    packed, alpha, csq = quantize4_device(x)
    del x
    q = torch.randn((b, d), generator=gen, device=cuda)
    q[0] = 1.0
    qc, qs, _ = quantize_query_int8(q)
    assert bool((qc[0] == 127).all())
    nib = (packed[1].to(torch.int64) & 15).sum() + (packed[1].to(torch.int64) >> 4).sum()
    assert int(nib) * 127 > 2**31  # row 1's unbiased sum against query 0
    assert k2_streams_queries(d, b) and k2_wgmma_plan(d, b)[1]
    assert k2_bodies((qc, qs, packed, alpha, csq)) == ("wgmma", "mma")
    for metric in K2_METRICS:
        assert_k2_bodies_match_twin((qc, qs, packed, alpha, csq), metric, n)


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
    block_minima.launches, block_minima.body_launches = 0, {"wgmma": 0, "mma": 0, "simt": 0}
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
def test_wide_int4_host_storage_and_mesh_take_the_streamed_body(cuda, tmp_path, monkeypatch):
    """int4-quantized search of 2,000 x 16,400 rows (past every resident
    query tile) streamed from host storage in tiles of 257 rows, and on a
    4-shard 1-D mesh on the card: each equal bit for bit to the one-device
    search of the same directory, every K2 launch on the tensor-core body
    with its query tile streamed."""
    from sqlite_vector_tpu_torch.parallel import make_mesh

    d = 16400
    rng = np.random.default_rng(25)
    base = rng.standard_normal((2000, d)).astype(np.float32)
    q = np.concatenate([base[[5, 1500]], rng.standard_normal((7, d)).astype(np.float32)])
    path = str(tmp_path / "w")
    svt.Dataset.from_arrays("w", base, options=f"dimension={d},distance=L2", device="cpu").save(path, shard_rows=700)
    dev = svt.Dataset.load(path, device="cuda")
    host = svt.Dataset.load(path, device="cuda", storage="host", mmap=True)
    mesh = svt.Dataset.load(path, mesh=make_mesh(devices=["cuda"] * 4))
    for ds in (dev, host, mesh):
        ds.quantize(qtype="int4")
    _tiny_tiles(monkeypatch, d // 2 + 8)
    for b in (1, 9):
        want = dev.search(q[:b], 10, mode="quantized")
        for ds in (host, mesh):
            before = (int4_block_minima.launches, int4_block_minima.streamed_launches,
                      int4_block_minima.body_launches["mma"])
            got = ds.search(q[:b], 10, mode="quantized")
            launched = int4_block_minima.launches - before[0]
            assert launched > 1  # a tile or a shard each
            assert int4_block_minima.streamed_launches - before[1] == launched
            assert int4_block_minima.body_launches["mma"] - before[2] == launched
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    assert want[0][0, 0] == 6  # row 5's id, found first


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
    launch on its tensor-core body (wgmma: f32 rows of 256 bytes) a call,
    the Dataset's result."""
    import sqlite_vector_tpu_torch.sqlite as psql

    rows = np.random.default_rng(4).standard_normal((6000, 64)).astype(np.float32)
    sql_table(str(tmp_path / "t.db"), rows)
    conn = psql.connect(str(tmp_path / "t.db"))
    assert conn.device.type == "cuda"
    conn.vector_init("docs", "v", "dimension=64,type=FLOAT32,distance=L2")
    ref = svt.Dataset.from_arrays("ref", rows, device=cuda)
    for q in rows[[3, 4000]] + np.float32(1e-3):
        conn.vector_full_scan("docs", "v", q, 10)  # loads the table
        before, wgmma = block_minima.launches, block_minima.body_launches["wgmma"]
        got = conn.vector_full_scan("docs", "v", q, 10)
        assert block_minima.launches == before + 1 and block_minima.body_launches["wgmma"] == wgmma + 1
        ids, dist = ref.search(q, 10)
        assert [r[0] for r in got] == ids.tolist()
        np.testing.assert_allclose([r[1] for r in got], dist, rtol=1e-5, atol=1e-6)
    conn.close()


@pytest.mark.cuda
def test_sql_int4_quantize_scan_launches_k2_and_equals_the_dataset(cuda, tmp_path):
    """SQL vector_quantize(..., 'qtype=INT4') and vector_quantize_scan on
    the card, own connection and a second one reading the shadow table:
    K2 on its wgmma body (32 packed bytes a row), bit-equal to the
    Dataset's int4 search."""
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
        before, wgmma = int4_block_minima.launches, int4_block_minima.body_launches["wgmma"]
        got = c.vector_quantize_scan("docs", "v", q, 10)
        assert int4_block_minima.launches == before + 1 and int4_block_minima.body_launches["wgmma"] == wgmma + 1
        assert [r[0] for r in got] == ids.tolist()
        assert [r[1] for r in got] == dist.astype(np.float64).tolist()
    conn.close()
    other.close()


@pytest.mark.cuda
def test_exact_search_reads_wide_bfloat16_self_matches_at_zero(cuda):
    """Exact Dataset.search over 20,000 x 18,432 FLOATB16 L2 rows (737 MB;
    the width of a kNN-LM datastore keyed by Nemotron-4-340B's hidden
    states): 32 queries drawn from the base, every self-match first at
    exactly 0.0. The finish rescores L2 as the direct sum((x - q)^2); the
    decomposition, summed in cuBLAS's order against the norms', left
    0.265-0.280 for 6 of 32 such self-matches on an H100. K1 runs on its
    wgmma body."""
    n, d = 20_000, 18_432
    gen = torch.Generator(device=cuda).manual_seed(18)
    rows = torch.randn((n, d), generator=gen, device=cuda).to(torch.bfloat16)
    ds = svt.VectorStore(device="cuda").create("knn", f"dimension={d},type=FLOATB16,distance=L2")
    ds._add_host_rows(rows.view(torch.int16).cpu().numpy().view(np.uint16), None)  # as the SQL loader adds
    pick = np.random.default_rng(18).choice(n, 32, replace=False)
    q = rows[torch.from_numpy(pick).to(cuda)].float().cpu().numpy()
    before = dict(block_minima.body_launches)
    ids, dist = ds.search(q, 5)
    assert block_minima.body_launches == {**before, "wgmma": before["wgmma"] + 1}
    np.testing.assert_array_equal(ids[:, 0], np.asarray(ds.ids)[pick])
    np.testing.assert_array_equal(dist[:, 0], 0.0)
    assert bool((dist[:, 1] > 100.0).all())


# -- the int8/u8 finish's rescore (csrc/rescore_codes.cu) --------------------

RESCORE_METRICS = [DistanceMetric.L2, DistanceMetric.SQUARED_L2, DistanceMetric.COSINE, DistanceMetric.DOT]


def rescore_case(dtype, n, d, b, device, seed=0):
    """Codes over their whole range, rows at the extremes (every code at
    the top, every code at the bottom, both alternating), a zero row and a
    duplicate row; query 0 a self-match, query 1 zero, query 2 at the top."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lo, hi = (0, 255) if dtype is torch.uint8 else (-128, 127)
    base = torch.randint(lo, hi + 1, (n, d), generator=gen, device=device, dtype=torch.int32).to(dtype)
    q = torch.randint(lo, hi + 1, (b, d), generator=gen, device=device, dtype=torch.int32).to(dtype)
    base[1], base[2], base[3] = hi, lo, 0
    base[4, ::2], base[4, 1::2] = lo, hi
    base[n - 3] = base[10]
    q[0] = base[10]
    q[1:2] = 0
    q[2:3] = hi
    return q, base


def group_choice(b, groups, kg, device, seed=0):
    """[b, kg] ascending int64 groups, each query's holding the first group
    (the extreme rows) and the last (ragged where N is not a multiple of
    128), the rest drawn."""
    gen = torch.Generator().manual_seed(seed)
    picks = [torch.cat([torch.tensor([0, groups - 1]), 1 + torch.randperm(groups - 2, generator=gen)[: kg - 2]])
             for _ in range(b)]
    return torch.sort(torch.stack(picks), dim=-1).values.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8], ids=str)
@pytest.mark.parametrize("metric", RESCORE_METRICS, ids=lambda m: m.value)
@pytest.mark.parametrize("d", [5, 95, 384, 768])  # 1-, 1-, 16- and 16-byte words
@pytest.mark.parametrize("b", [1, 2, 32, 62, 65])
def test_rescore_kernel_is_bit_equal_to_the_gathered_path(cuda, dtype, metric, d, b):
    """The kernel's rank-ready distances equal its twin's, the gathered
    float64 path it replaced (held to the plain [B, N] distances in
    tests/test_torch_block_scan.py), bit for bit over N = 1,000 (the last
    group 104 rows), unmasked, and with valid < N and a row mask; one
    launch a call."""
    from sqlite_vector_tpu_torch.ops.block_scan import rescore_groups, rescore_groups_reference

    n = 1000
    q, base = rescore_case(dtype, n, d, b, cuda, seed=d + b)
    gidx = group_choice(b, 8, 5, cuda, seed=b)
    mask = torch.rand(n, generator=torch.Generator(device=cuda).manual_seed(d), device=cuda) < 0.5
    before = rescore_groups.launches
    for valid, row_mask in ((n, None), (n - 77, mask)):
        got = rescore_groups(q, base, gidx, valid, metric, row_mask)
        want = rescore_groups_reference(q, base, gidx, valid, metric, row_mask)
        assert torch.equal(got, want), (valid, row_mask is None)
    assert rescore_groups.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16513, 16520])  # 1- and 4-byte words
@pytest.mark.parametrize("metric", RESCORE_METRICS, ids=lambda m: m.value)
def test_rescore_kernel_wraps_int32_terms_of_wide_u8_codes(cuda, d, metric):
    """Past d = 16,512 the u8 square norms of codes near the top sum past
    2^31: the int32 terms wrap, yet the L2 values are exact (below 2^31 up
    to d = 33,025) and every value equals the twin's."""
    from sqlite_vector_tpu_torch.ops.block_scan import rescore_groups, rescore_groups_reference

    gen = torch.Generator(device=cuda).manual_seed(d)
    base = torch.randint(250, 256, (300, d), generator=gen, device=cuda, dtype=torch.int32).to(torch.uint8)
    q = torch.full((2, d), 255, dtype=torch.uint8, device=cuda)
    q[1] = base[7]
    gidx = torch.tensor([[0, 2], [0, 1]], device=cuda)
    got = rescore_groups(q, base, gidx, 300, metric)
    assert torch.equal(got, rescore_groups_reference(q, base, gidx, 300, metric))
    if metric is DistanceMetric.SQUARED_L2:
        qsq = (q.long() ** 2).sum(-1)
        assert int(qsq[0]) * 2 >= 2**31  # the terms wrap
        exact = ((q[0].long() - base[:128].long()) ** 2).sum(-1).float()
        assert torch.equal(got[0, :128], exact)
        assert float(got[1, 7]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("metric", RESCORE_METRICS, ids=lambda m: m.value)
def test_rescore_kernel_reads_unaligned_rows_in_narrower_words(cuda, metric):
    """Rows or queries that start off a 16-byte (or 4-byte) boundary take
    4-byte (or 1-byte) words, with the same values."""
    from sqlite_vector_tpu_torch.ops.block_scan import rescore_groups, rescore_width

    q, base = rescore_case(torch.int8, 1001, 384, 3, cuda, seed=5)
    gidx = group_choice(3, 7, 4, cuda)
    want = rescore_groups(q, base, gidx, 1000, metric)
    for skip in (4, 1):
        flat = torch.empty(1000 * 384 + skip, dtype=torch.int8, device=cuda)
        moved = flat[skip:].view(1000, 384)
        moved.copy_(base[:1000])
        assert rescore_width(q, moved) == skip
        assert torch.equal(rescore_groups(q, moved, gidx, 1000, metric), want)


@pytest.mark.cuda
def test_rescore_kernel_refuses_what_it_does_not_take(cuda):
    from sqlite_vector_tpu_torch.ops.block_scan import rescore_groups

    q, base = rescore_case(torch.int8, 300, 32, 2, cuda)
    gidx = torch.tensor([[0, 1], [1, 2]], device=cuda)
    with pytest.raises(ValueError):
        rescore_groups(q, base.t(), gidx, 300, DistanceMetric.DOT)  # not contiguous
    with pytest.raises(ValueError):
        rescore_groups(q, base, gidx[:, ::2], 300, DistanceMetric.DOT)
    with pytest.raises(ValueError):
        rescore_groups(q, base.float(), gidx, 300, DistanceMetric.DOT)
    with pytest.raises(ValueError):
        rescore_groups(q, base, gidx, 300, DistanceMetric.L1)
    with pytest.raises(ValueError):
        rescore_groups(q, base, gidx.cpu(), 300, DistanceMetric.DOT)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", RESCORE_METRICS, ids=lambda m: m.value)
def test_block_scan_topk_at_100k_x_768_int8_equals_the_cpu_twin(cuda, metric):
    """K1 + the rescore kernel on the card == the twins on the CPU, values
    and positions, at 100,000 x 768 int8 codes and k = 100 (with valid < N
    and ties from duplicate rows)."""
    from sqlite_vector_tpu_torch.ops.block_scan import rescore_groups

    q, base = rescore_case(torch.int8, 100_000, 768, 8, cuda, seed=11)
    before = rescore_groups.launches
    got = block_scan_topk(q, base, metric, 100, valid_count=99_990)
    assert rescore_groups.launches == before + 1
    want = block_scan_topk(q.cpu(), base.cpu(), metric, 100, valid_count=99_990)
    assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[0].cpu(), want[0])


@pytest.mark.cuda
def test_only_u8_and_i8_dot_family_searches_launch_the_rescore_kernel(cuda):
    """An int8 quantized search and an exact float dot-family search each
    launch a rescore kernel once (k = 9 over 3,000 rows: one query chunk);
    int4 quantized and refine search and the L1 int8 and float searches
    launch it never."""
    from sqlite_vector_tpu_torch.ops.block_scan import rescore_groups

    rng = np.random.default_rng(19)
    base = rng.standard_normal((3000, 96)).astype(np.float32)
    q = base[[7, 2500]] + np.float32(1e-3)
    for metric, qtype, mode, want in (
        ("COSINE", "int8", "quantized", 1),
        ("DOT", "int8", "quantized", 1),
        ("L1", "int8", "quantized", 0),
        ("COSINE", "int8", "exact", 1),
        ("L1", "int8", "exact", 0),
        ("L2", "int4", "quantized", 0),
        ("L2", "int4", "refine", 0),
    ):
        ds = svt.VectorStore(device="cuda").create("d", f"dimension=96,distance={metric}")
        ds.add(base)
        ds.quantize(qtype=qtype, refine=qtype == "int4")
        before = rescore_groups.launches
        ds.search(q, 9, mode=mode)
        assert rescore_groups.launches - before == want, (metric, qtype, mode)


# -- the float finish's rescore (csrc/rescore_rows.cu) ------------------------

FLOAT_DTYPES = [torch.float32, torch.float16, torch.bfloat16]


def float_rescore_case(dtype, n, d, b, device, seed=0):
    """N(0, 1) rows with a NaN row, a zero row and a duplicate row; query 0
    a self-match of the duplicated row, query 1 zero."""
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn((n, d), generator=gen, device=device).to(dtype)
    q = torch.randn((b, d), generator=gen, device=device).to(dtype)
    base[5] = torch.nan
    base[3] = 0
    base[n - 3] = base[10]
    q[0] = base[10]
    q[1:2] = 0
    return q, base


def assert_float_rescore_close(got, want, metric):
    """The kernel's float32 sums run in another order than the twin's:
    +inf at the same places, the values within rtol 1e-5 (COSINE's, in
    [0, 2], within 1e-5 of each other; others within K1's card test's
    atol of 1e-3 beside their magnitude)."""
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    fin = torch.isfinite(want)
    atol = 1e-5 if metric is DistanceMetric.COSINE else 1e-3
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=str)
@pytest.mark.parametrize("metric", RESCORE_METRICS, ids=lambda m: m.value)
@pytest.mark.parametrize("d", [1536, 97, 8192])  # 16-byte words, the element's / 4-byte, 16-byte
@pytest.mark.parametrize("b", [1, 32, 64])
def test_float_rescore_kernel_matches_its_twin(cuda, dtype, metric, d, b):
    """The kernel's rank-ready distances against its twin, the gathered
    float32 path it replaced, over N = 1,000 (the last group 104 rows),
    every group kept (k = G = 8) and 5 of them, unmasked, and with
    valid < N and a row mask; one launch a call. A self-match reads
    exactly 0 under L2, SQUARED_L2 and COSINE."""
    from sqlite_vector_tpu_torch.ops.block_scan import rescore_groups, rescore_groups_reference

    n = 1000
    q, base = float_rescore_case(dtype, n, d, b, cuda, seed=d + b)
    mask = torch.rand(n, generator=torch.Generator(device=cuda).manual_seed(d), device=cuda) < 0.5
    before = rescore_groups.launches
    for kg in (8, 5):
        gidx = group_choice(b, 8, kg, cuda, seed=b + kg)
        for valid, row_mask in ((n, None), (n - 77, mask)):
            got = rescore_groups(q, base, gidx, valid, metric, row_mask)
            want = rescore_groups_reference(q, base, gidx, valid, metric, row_mask)
            assert_float_rescore_close(got, want, metric)
    assert rescore_groups.launches == before + 4
    if metric is not DistanceMetric.DOT:
        got = rescore_groups(q[:1], base, torch.zeros((1, 1), dtype=torch.int64, device=cuda), n, metric)
        assert float(got[0, 10]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=str)
@pytest.mark.parametrize("metric", RESCORE_METRICS, ids=lambda m: m.value)
def test_float_rescore_kernel_reads_unaligned_rows_in_narrower_words(cuda, dtype, metric):
    """Rows that start off a 16-byte boundary take 4-byte or one-element
    words (rescore_width), with values within the sums' rounding."""
    from sqlite_vector_tpu_torch.ops.block_scan import rescore_groups, rescore_width

    q, base = float_rescore_case(dtype, 1001, 1536, 3, cuda, seed=5)
    gidx = group_choice(3, 7, 4, cuda)
    want = rescore_groups(q, base, gidx, 1000, metric)
    elem = base.element_size()
    for skip in sorted({4 // elem, 1}):
        flat = torch.empty(1000 * 1536 + skip, dtype=dtype, device=cuda)
        moved = flat[skip:].view(1000, 1536)
        moved.copy_(base[:1000])
        assert rescore_width(q, moved) == skip * elem
        assert_float_rescore_close(rescore_groups(q, moved, gidx, 1000, metric), want, metric)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=str)
@pytest.mark.parametrize("metric", RESCORE_METRICS, ids=lambda m: m.value)
def test_block_scan_topk_over_float_rows_matches_the_cpu_twin(cuda, dtype, metric):
    """K1 + the float rescore kernel on the card against the twins on the
    CPU at 20,000 x 1,536 and k = 100 (valid < N, ties from duplicate
    rows): one rescore launch a scan, the same +inf slots, the values
    within the sums' rounding and the ids tie-aware equal
    (tests/parity.py) to the plain distances."""
    import importlib.util
    from pathlib import Path

    from sqlite_vector_tpu_torch.ops.block_scan import rescore_groups

    spec = importlib.util.spec_from_file_location("svt_parity", Path(__file__).with_name("parity.py"))
    parity = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parity)
    n, d, k, valid = 20_000, 1536, 100, 19_990
    q, base = float_rescore_case(dtype, n, d, 8, cuda, seed=23)
    before = rescore_groups.launches
    got_v, got_i = block_scan_topk(q, base, metric, k, valid_count=valid)
    assert rescore_groups.launches == before + 1
    want_v, _ = block_scan_topk(q.cpu(), base.cpu(), metric, k, valid_count=valid)
    assert_float_rescore_close(got_v.cpu(), want_v, metric)
    plain = pairwise_plain(q.cpu(), base.cpu()[:valid], metric)
    vtype = {torch.float32: "FLOAT32", torch.float16: "FLOAT16", torch.bfloat16: "FLOATB16"}[dtype]
    for i in range(q.shape[0]):
        parity.assert_topk_parity(np.arange(valid), plain[i], got_i[i].cpu().numpy(), got_v[i].cpu().numpy(), k,
                                  rel_tol=parity.REL_TOL_BY_TYPE[vtype], label=f"{dtype} {metric.value} q{i}")


def pairwise_plain(q, base, metric):
    """[B, N] float32 distances by the plain torch ops (ops/distance.py),
    snapped as the search returns them."""
    from sqlite_vector_tpu_torch.ops.distance import pairwise_distance

    return pairwise_distance(q, base, metric).numpy()
