"""PyTorch port parity: top-k selection ties go to the earliest row, with
indices identical to the JAX package's ops.topk (lax.top_k prefers lower
indices; the port uses a stable sort)."""

import numpy as np
import pytest
import torch

from sqlite_vector_tpu.ops import topk as jax_topk
from sqlite_vector_tpu_torch.ops.topk import merge_topk, topk_ascending


def tied_distances(rng, b, n):
    # few distinct values: every selection boundary falls inside a tie run
    return rng.integers(0, 7, (b, n)).astype(np.float32)


@pytest.mark.parametrize(
    "n,k",
    [
        (300, 10),  # direct lax.top_k in the JAX package
        (20000, 20),  # JAX's hierarchical two-level selection
        (5, 9),  # k > n: +inf / -1 padding
    ],
)
def test_topk_ties_match_jax(n, k):
    rng = np.random.default_rng(n)
    d = tied_distances(rng, 3, n)
    d[1, ::3] = np.inf
    want_v, want_i = jax_topk.topk_ascending(d, k)
    got_v, got_i = topk_ascending(torch.from_numpy(d), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_topk_duplicate_rows_earliest_first():
    d = np.zeros((1, 300), np.float32)  # all rows identical
    got_v, got_i = topk_ascending(torch.from_numpy(d), 5)
    want_v, want_i = jax_topk.topk_ascending(d, 5)
    np.testing.assert_array_equal(got_i.numpy()[0], np.arange(5))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_topk_gathers_ids_like_jax():
    rng = np.random.default_rng(5)
    d = tied_distances(rng, 2, 50)
    ids = np.arange(1000, 1050, dtype=np.int32)
    want_v, want_i = jax_topk.topk_ascending(d, 60, ids=ids)
    got_v, got_i = topk_ascending(torch.from_numpy(d), 60, ids=torch.from_numpy(ids))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_merge_topk_running_set_wins_ties():
    rng = np.random.default_rng(9)
    va = np.sort(tied_distances(rng, 2, 8), axis=-1)
    vb = np.sort(tied_distances(rng, 2, 8), axis=-1)
    ia = np.arange(8, dtype=np.int32)[None].repeat(2, 0)
    ib = ia + 100
    want_v, want_i = jax_topk.merge_topk(va, ia, vb, ib, 10)
    got_v, got_i = merge_topk(*(torch.from_numpy(x) for x in (va, ia, vb, ib)), 10)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
