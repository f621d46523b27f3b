"""The port's CUDA kernel (K1, csrc/block_minima.cu) on the card.

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
