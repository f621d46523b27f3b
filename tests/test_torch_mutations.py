"""PyTorch port parity for row mutations: remove (tombstones), compact,
update, and what they do to search, quantization state and interop.

A JAX Dataset and a port Dataset (both on the CPU) go through the SAME
calls on the same seeded rows; after every step their len, ids,
tombstones, quantization state (quant_stale, snapshot ids) and get()
agree exactly, and so do their searches in every mode the state allows
(exact and approx always; quantized and rerank once quantized; refine over
an int4 quantization with its sidecar). Tolerances, by mode:
  - exact, approx: ids tie-aware (tests/parity.py) against the JAX
    dataset's own distances of the live rows, values within
    REL_TOL_BY_TYPE (float32 sums in another order);
  - quantized over int8 codes: ids and integer-domain values equal;
  - quantized over int4 codes: values within assert_int4_values_close;
  - rerank, refine: values within rtol 1e-5 (float32 rescores in another
    order; rerank's id-remap route rescores by direct sums on both sides);
and wherever an id differs the two values are a tie within that tolerance.
"""

import numpy as np
import pytest

import sqlite_vector_tpu as jax_svt
import sqlite_vector_tpu_torch as svt
from sqlite_vector_tpu_torch.interop import dataset_from_state
from tests.parity import REL_TOL_BY_TYPE, assert_topk_parity
from tests.test_torch_quantize4 import assert_int4_values_close

K = 8


class Pair:
    """A JAX dataset and a port dataset driven through the same calls."""

    def __init__(self, options: str):
        self.j = jax_svt.VectorStore().create("d", options)
        self.p = svt.VectorStore(device="cpu").create("d", options)

    def do(self, name, *args, **kwargs):
        """Call `name` on both; the results must be equal (a search's ids
        equal and its float32 distances within REL_TOL_BY_TYPE: sums in
        another order; the data here has no ties)."""
        want = getattr(self.j, name)(*args, **kwargs)
        got = getattr(self.p, name)(*args, **kwargs)
        if name == "search":
            np.testing.assert_array_equal(got[0], want[0])
            rel = REL_TOL_BY_TYPE[self.p.dtype.value]
            np.testing.assert_allclose(got[1], want[1], rtol=rel, atol=1e-5)
        else:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=name)
        return got

    def raises(self, error: str, name, *args, **kwargs):
        """Both raise `error` (by class name) with the same message."""
        msgs = []
        for ds, mod in ((self.j, jax_svt), (self.p, svt)):
            with pytest.raises(getattr(mod, error)) as e:
                getattr(ds, name)(*args, **kwargs)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]

    def check_state(self):
        j, p = self.j, self.p
        assert len(p) == len(j)
        np.testing.assert_array_equal(p.ids, j.ids)
        assert p.tombstones == j.tombstones
        assert p.is_quantized == j.is_quantized
        assert p.quant_stale == j.quant_stale
        if p.is_quantized:
            assert p._quant.count == j._quant.count
            np.testing.assert_array_equal(p._quant.ids, j._quant.ids)
        if len(j):
            sample = j.ids[:: max(1, len(j) // 7)]
            np.testing.assert_array_equal(p.get(sample), j.get(sample))

    def modes(self):
        quant = self.p._quant
        out = ["exact", "approx"]
        if quant is not None and quant.codes is not None:
            out += ["quantized", "rerank"]
            if quant.codes8 is not None:
                out.append("refine")
        return out

    def check_search(self, q, ids_filter=None):
        for mode in self.modes():
            compare_mode(self.j, self.p, q, mode, ids_filter)


def compare_mode(jds, pds, q, mode, ids_filter=None, k=K):
    jid, jd = jds.search(q, k, mode=mode, ids_filter=ids_filter)
    pid, pd = pds.search(q, k, mode=mode, ids_filter=ids_filter)
    label = f"{mode}, filter={ids_filter is not None}"
    assert pid.shape == jid.shape and pid.dtype == np.int64, label
    metric = pds.metric.value
    if mode in ("exact", "approx"):
        oracle = np.asarray(jds.distances(q), np.float64)
        live = jds.ids
        if ids_filter is not None:
            oracle[:, ~np.isin(live, ids_filter)] = np.inf
        rel = REL_TOL_BY_TYPE[pds.dtype.value]
        for i in range(q.shape[0]):
            assert_topk_parity(live, oracle[i], pid[i], pd[i], k, rel_tol=rel, label=f"{label} q{i}")
        np.testing.assert_allclose(pd, jd, rtol=rel, atol=1e-5, err_msg=label)
        return
    if mode == "quantized" and pds._quant.qtype is not svt.QuantType.I4:
        np.testing.assert_array_equal(pid, jid, err_msg=label)
        # integer-domain COSINE: the block-minima route snaps |d| <= 2^-20
        # to 0, the JAX scan_topk route does not (ROADMAP queue 3, inherited)
        snap = lambda d: np.where(np.abs(d) <= 8 * 1.1920929e-07, 0.0, d)  # noqa: E731
        np.testing.assert_array_equal(snap(pd), snap(jd), err_msg=label)
        return
    if mode == "quantized":
        assert_int4_values_close(pd, jd, q, metric)
    else:
        np.testing.assert_array_equal(np.isinf(pd), np.isinf(jd), err_msg=label)
        np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-5, err_msg=label)
    swapped = pid != jid
    np.testing.assert_allclose(pd[swapped], jd[swapped], rtol=1e-5, atol=1e-5, err_msg=label)


def queries(rng, rows, dim):
    """Two stored rows (self-matches), one of them maybe removed later, and
    two random queries."""
    return np.concatenate([rows, rng.standard_normal((2, dim)).astype(np.float32)])


@pytest.mark.parametrize("metric", ["L2", "COSINE", "DOT"])
def test_operation_sequence_matches_jax(metric):
    """add, quantize, remove below the threshold, add after quantize,
    update with a duplicate id and an unknown one, remove past the
    threshold (compaction), quantize after remove, explicit compact, int4
    with its sidecar, more removes and adds: state and searches agree with
    the JAX package after every step."""
    rng = np.random.default_rng(["L2", "COSINE", "DOT"].index(metric))
    dim = 16
    base = rng.standard_normal((1500, dim)).astype(np.float32)
    pair = Pair(f"dimension={dim},type=FLOAT32,distance={metric}")
    ids = pair.do("add", base[:1000])
    q = queries(rng, base[[20, 700]], dim)
    pair.check_state()
    pair.check_search(q)

    assert pair.do("quantize") == 1000
    pair.check_state()
    pair.check_search(q)  # rerank: the fused route (fresh codes)

    assert pair.do("remove", ids[10:60]) == 50  # below max(1024, count // 4)
    assert pair.p.tombstones == 50 and pair.p.quant_stale
    pair.check_state()
    pair.check_search(q, ids_filter=ids[::3])  # rerank: the id-remap route
    pair.check_search(queries(rng, base[[15, 30]], dim))  # removed rows' vectors

    ids2 = pair.do("add", base[1000:1400])  # add after quantize
    pair.check_state()
    pair.check_search(q)

    fresh = rng.standard_normal((3, dim)).astype(np.float32)
    assert pair.do("update", ids[[5, 70, 5]], fresh) == 3  # id 5 twice: the last wins
    np.testing.assert_array_equal(pair.p.get(ids[5]), fresh[2:3])
    pair.raises("VectorStateError", "update", [999_999], fresh[:1])
    pair.raises("VectorStateError", "update", [ids[30]], fresh[:1])  # removed
    pair.raises("VectorStateError", "get", [ids[30]])
    pair.check_state()
    pair.check_search(queries(rng, fresh[[2, 1]], dim))

    # past the threshold: 1150 tombstones >= max(1024, 1400 // 4) compacts
    pair.do("remove", np.concatenate([ids[100:1000], ids2[:200]]))
    assert pair.p.tombstones == 0 and len(pair.p) == 1400 - 1150
    pair.check_state()
    pair.check_search(queries(rng, base[[1300, 1399]], dim), ids_filter=ids2[::2])

    assert pair.do("quantize") == 250  # fresh codes of the compacted rows
    pair.do("remove", ids2[200:210])
    assert pair.do("compact") == 10
    assert pair.p.tombstones == 0 and pair.p.quant_stale
    pair.check_state()
    pair.check_search(queries(rng, base[[1300, 1250]], dim))

    pair.do("quantize", qtype="int4", refine=True)
    pair.do("remove", ids2[300:320])
    pair.do("add", base[1400:1500])
    pair.check_state()
    pair.check_search(queries(rng, base[[1350, 1450]], dim), ids_filter=ids2[250:])


def test_remove_rows():
    """JAX test_dataset.py::test_remove_rows on both packages."""
    rng = np.random.default_rng(1)
    base = rng.standard_normal((50, 8)).astype(np.float32)
    pair = Pair("dimension=8,type=FLOAT32")
    ids = pair.do("add", base)
    assert pair.do("remove", ids[10:20]) == 10
    assert len(pair.p) == 40
    got, dist = pair.do("search", base[15], 1)
    assert dist[0] > 0.0
    got, dist = pair.do("search", base[5], 1)
    assert got[0] == ids[5] and dist[0] == 0.0
    assert pair.do("remove", [99999]) == 0
    pair.check_state()


def test_remove_is_lazy_no_device_reupload():
    """JAX test_remove_is_lazy_no_device_reupload: below the threshold the
    device matrix object is unchanged and scans mask the dead rows."""
    rng = np.random.default_rng(2)
    base = rng.standard_normal((200, 8)).astype(np.float32)
    pair = Pair("dimension=8,type=FLOAT32")
    ids = pair.do("add", base)
    dev_before = pair.p._vectors
    assert pair.do("remove", ids[50:60]) == 10
    assert pair.p._vectors is dev_before
    assert len(pair.p) == 190 == len(np.unique(pair.p.ids))
    got, _ = pair.do("search", base[55], 1)
    assert got[0] != ids[55]
    d = pair.p.distances(base[0])
    assert d.shape == (190,)
    np.testing.assert_allclose(d, pair.j.distances(base[0]), rtol=3e-5, atol=1e-5)
    with pytest.raises(svt.VectorStateError, match="unknown row id"):
        pair.p.get([ids[55]])
    np.testing.assert_allclose(pair.p.get([ids[61]])[0], base[61])
    got, _ = pair.do("search", base[70], 5, ids_filter=ids[50:80])
    assert ids[55] not in got and got[0] == ids[70]
    sub = Pair("dimension=8,type=FLOAT32")
    sids = sub.do("add", base[:5])
    sub.do("remove", sids[:3])
    got, _ = sub.do("search", base[0], 5)
    assert len(got) == 2 and set(got) == set(sids[3:])


def test_explicit_compact():
    """JAX test_explicit_compact, its device-storage part."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal((50, 8)).astype(np.float32)
    pair = Pair("dimension=8,type=FLOAT32")
    ids = pair.do("add", base)
    assert pair.do("compact") == 0
    pair.do("remove", ids[:10])
    assert pair.p.tombstones == 10
    dev_before, layout = pair.p._vectors, pair.p._layout_gen
    assert pair.do("compact") == 10
    assert pair.p.tombstones == 0 and len(pair.p) == 40
    # the layout generation is a sequence lock: odd while rows move, even
    # again after, so one compaction advances it by two
    assert pair.p._vectors is not dev_before and pair.p._layout_gen == layout + 2
    got, dist = pair.do("search", base[20], 1)
    assert got[0] == ids[20] and dist[0] == 0.0
    pair.check_state()


def test_remove_compacts_at_threshold():
    """JAX test_remove_compacts_at_threshold: removing every row compacts
    at once; so do max(1024, count // 4) tombstones, and not one fewer."""
    rng = np.random.default_rng(4)
    pair = Pair("dimension=8,type=FLOAT32")
    ids = pair.do("add", rng.standard_normal((40, 8)).astype(np.float32))
    dev_before = pair.p._vectors
    pair.do("remove", ids)
    assert pair.p._n_dead == 0 and len(pair.p) == 0
    assert pair.p._vectors is not dev_before
    for n, threshold in ((5000, 1250), (2000, 1024)):  # count // 4, then the 1024 floor
        big = Pair("dimension=4,type=FLOAT32")
        ids = big.do("add", rng.standard_normal((n, 4)).astype(np.float32))
        big.do("remove", ids[: threshold - 1])
        assert big.p.tombstones == threshold - 1
        big.do("remove", ids[threshold - 1 : threshold])
        assert big.p.tombstones == 0 and len(big.p) == n - threshold
        big.check_state()


def test_update_rows():
    """JAX test_update_rows."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal((20, 8)).astype(np.float32)
    pair = Pair("dimension=8,type=FLOAT32")
    ids = pair.do("add", base)
    new_vec = rng.standard_normal((1, 8)).astype(np.float32)
    before = pair.p._vectors
    assert pair.do("update", [ids[3]], new_vec) == 1
    assert pair.p._vectors is not before  # written out of place
    np.testing.assert_array_equal(before[3].numpy(), base[3])
    got, dist = pair.do("search", new_vec[0], 1)
    assert got[0] == ids[3] and dist[0] == 0.0
    pair.raises("VectorStateError", "update", [123456], new_vec)
    pair.raises("VectorConfigError", "update", ids[:2], new_vec)


def test_update_scatter_batches():
    """JAX test_update_scatter_batches: exact results across batch sizes
    and beside tombstones."""
    rng = np.random.default_rng(6)
    base = rng.standard_normal((50, 8)).astype(np.float32)
    pair = Pair("dimension=8,type=FLOAT32")
    ids = pair.do("add", base)
    pair.do("remove", ids[40:45])
    for nb in (1, 3, 7):
        sel = ids[:nb]
        fresh = rng.standard_normal((nb, 8)).astype(np.float32)
        assert pair.do("update", sel, fresh) == nb
        for j in range(nb):
            got, dist = pair.do("search", fresh[j], 1)
            assert got[0] == sel[j] and dist[0] == 0.0
    got, dist = pair.do("search", base[20], 1)
    assert got[0] == ids[20] and dist[0] == 0.0
    got, _ = pair.do("search", base[42], 1)
    assert got[0] != ids[42]
    pair.check_state()


def test_quant_stale_after_remove():
    """JAX test_quant_stale_after_remove, and update and add going stale the
    same way; quantize() compacts first and is fresh again."""
    rng = np.random.default_rng(7)
    pair = Pair("dimension=8,type=FLOAT32")
    ids = pair.do("add", rng.standard_normal((30, 8)).astype(np.float32))
    for step in (
        lambda: pair.do("remove", ids[:5]),
        lambda: pair.do("update", ids[6:7], np.ones((1, 8), np.float32)),
        lambda: pair.do("add", np.ones((1, 8), np.float32)),
    ):
        pair.do("quantize")
        assert not pair.p.quant_stale and pair.p.tombstones == 0
        step()
        assert pair.p.quant_stale
        pair.check_state()


def test_quantized_search_after_remove():
    """JAX test_quantized_search_after_remove: stale codes keep serving
    with their own ids; exact sees the live rows; rerank drops removed
    candidates; the quantized filter applies in snapshot space."""
    rng = np.random.default_rng(8)
    base = rng.standard_normal((50, 16)).astype(np.float32)
    pair = Pair("dimension=16,type=FLOAT32")
    ids = pair.do("add", base)
    pair.do("quantize")
    pair.do("remove", ids[:20])
    got, _ = pair.do("search", base[30], 3, exact=False)
    assert got[0] == ids[30]
    got5, _ = pair.do("search", base[5], 1, exact=False)
    assert got5[0] == ids[5]
    egot, edist = pair.do("search", base[5], 1)
    assert egot[0] != ids[5] or edist[0] > 0
    rgot, rdist = pair.p.search(base[30], 3, mode="rerank")
    assert rgot[0] == ids[30] and rdist[0] == 0.0 and ids[5] not in rgot
    compare_mode(pair.j, pair.p, base[[30, 5]], "rerank")
    fgot, _ = pair.do("search", base[30], 3, exact=False, ids_filter=ids[25:])
    assert set(fgot.tolist()) <= set(ids[25:].tolist())


def test_rerank_after_remove_drops_dead_candidates():
    """JAX test_rerank_after_remove_drops_dead_candidates."""
    rng = np.random.default_rng(9)
    base = rng.standard_normal((100, 8)).astype(np.float32)
    pair = Pair("dimension=8,type=FLOAT32")
    ids = pair.do("add", base)
    pair.do("quantize")
    pair.do("remove", [ids[7]])
    got, _ = pair.p.search(base[7], 3, mode="rerank")
    assert ids[7] not in got and len(got) == 3
    compare_mode(pair.j, pair.p, base[[7, 8]], "rerank")
    assert pair.p.last_rerank_decomposition.keys() == pair.j.last_rerank_decomposition.keys()
    assert pair.p.last_rerank_decomposition["gathered_rows"] > 0


@pytest.mark.parametrize("metric", ["L2", "DOT"])
def test_rerank_remap_rescore_excludes_nonfinite(metric):
    """JAX test_rerank_host_rescore_excludes_nonfinite: the id-remap
    route's rescore admits finite distances only (an Inf row scores +inf
    under L2 and -inf under DOT, a NaN row NaN), so such rows never come
    back; the results equal JAX's."""
    rng = np.random.default_rng(15)
    base = rng.standard_normal((30, 8)).astype(np.float32)
    base[4, 2] = np.inf
    base[9, 5] = np.nan
    pair = Pair(f"dimension=8,type=FLOAT32,distance={metric}")
    ids = pair.do("add", base)
    pair.do("quantize")
    got_ids, got_vals = pair.p.search(base[0], 30, mode="rerank", expand=4, ids_filter=ids)
    assert ids[4] not in got_ids and ids[9] not in got_ids
    assert np.isfinite(got_vals).all() and len(got_ids) == 28
    want_ids, want_vals = pair.j.search(base[0], 30, mode="rerank", expand=4, ids_filter=ids)
    np.testing.assert_array_equal(np.sort(got_ids), np.sort(want_ids))
    np.testing.assert_allclose(got_vals, want_vals, rtol=1e-5, atol=1e-5)


def test_filter_after_remove_and_compaction_uses_snapshot_space():
    """remove -> compaction -> filtered quantized search: live positions
    moved, the codes did not, so the filter must index the snapshot; a
    filter built in live space would select other rows."""
    rng = np.random.default_rng(10)
    base = rng.standard_normal((1200, 8)).astype(np.float32)
    pair = Pair("dimension=8,type=FLOAT32")
    ids = pair.do("add", base)
    pair.do("quantize")
    pair.do("remove", ids[:1100])  # past the threshold: compacts
    assert pair.p.tombstones == 0 and len(pair.p) == 100
    flt = ids[1050:1150]  # live 1100-1149, removed 1050-1099
    for mode in ("quantized", "rerank", "exact", "approx"):
        got, _ = pair.p.search(base[1120], 5, mode=mode, ids_filter=flt)
        assert got[0] == ids[1120] and np.isin(got, flt).all()
        compare_mode(pair.j, pair.p, base[[1120, 1060]], mode, ids_filter=flt)


def test_removed_id_can_be_added_again():
    """A removed id is free again (JAX test_add_rejects_duplicate_ids): the
    tombstoned row and its successor share the id, only one is live."""
    rng = np.random.default_rng(11)
    base = rng.standard_normal((5, 8)).astype(np.float32)
    pair = Pair("dimension=8,type=FLOAT32")
    pair.do("add", base, ids=[10, 11, 12, 13, 14])
    pair.raises("VectorConfigError", "add", base[:1], ids=[12])
    pair.do("remove", [12])
    pair.do("add", base[:1], ids=[12])
    got, dist = pair.do("search", base[0], 1)
    assert dist[0] == 0.0
    pair.check_state()


def test_concurrent_searches_see_consistent_layouts():
    """Searchers race a mutator that removes (with and without compaction),
    adds, updates and re-quantizes: a stable row (never removed or
    updated) must always come back first at distance 0 in exact, approx
    and rerank mode, whatever layout the search raced (the layout
    generation re-runs a search that raced a compaction); afterwards the
    dataset's rows and ids are the ones the mutator left."""
    import sys
    import threading

    rng = np.random.default_rng(13)
    dim = 8
    ds = svt.VectorStore(device="cpu").create("c", f"dimension={dim}")
    # rows before the stable ones, so a compaction moves the stable rows
    ds.add(rng.standard_normal((1000, dim)).astype(np.float32))
    stable_rows = rng.standard_normal((300, dim)).astype(np.float32)
    stable = ds.add(stable_rows)
    ds.add(rng.standard_normal((500, dim)).astype(np.float32))
    ds.quantize()
    errors, stop = [], threading.Event()
    expected = set(ds.ids.tolist())

    def mutate():
        mrng = np.random.default_rng(14)
        try:
            for step in range(60):
                others = np.setdiff1d(ds.ids, stable)
                gone = mrng.choice(others, 300 if step % 7 == 0 else 40, replace=False)
                ds.remove(gone)
                expected.difference_update(gone.tolist())
                expected.update(ds.add(mrng.standard_normal((60, dim)).astype(np.float32)).tolist())
                upd = mrng.choice(np.setdiff1d(ds.ids, stable), 5, replace=False)
                ds.update(upd, mrng.standard_normal((5, dim)).astype(np.float32))
                if step % 5 == 0:
                    ds.compact()
                if step % 11 == 0:
                    ds.quantize()
        except Exception as e:  # reported by the assertion below
            errors.append(e)
        finally:
            stop.set()

    def search(seed):
        srng = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                i = int(srng.integers(len(stable)))
                for mode in ("exact", "approx", "rerank"):
                    got, dist = ds.search(stable_rows[i], 3, mode=mode)
                    assert got[0] == stable[i] and dist[0] == 0.0, (mode, got, dist)
        except Exception as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=mutate)] + [
            threading.Thread(target=search, args=(s,)) for s in range(6)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert set(ds.ids.tolist()) == expected and len(ds) == len(expected)
    got, dist = ds.search(stable_rows, 1)
    np.testing.assert_array_equal(got[:, 0], stable)
    assert (dist[:, 0] == 0.0).all()


@pytest.mark.parametrize("call", ["exact", "approx", "distances"])
def test_read_inside_a_compaction_sees_one_layout(call):
    """A read that runs wholly inside a compaction, after the rows and ids
    moved but before the count did, must not keep what it read there: it
    returns what the finished layout gives. The compaction is held in that
    window (its _invalidate_row_caches call waits on an event) while the
    read starts; then the compaction is released. The query is a removed
    row: in the window the new matrix's padding rows, copies of it, sit
    below the old count."""
    import threading

    rng = np.random.default_rng(17)
    rows = rng.standard_normal((1000, 8)).astype(np.float32)
    ds = svt.VectorStore(device="cpu").create("w", "dimension=8")
    ids = ds.add(rows)
    ds.remove(ids[:100])  # below the compaction threshold
    entered, release = threading.Event(), threading.Event()
    invalidate = ds._invalidate_row_caches

    def held_invalidate():
        invalidate()
        if threading.current_thread() is compactor:
            entered.set()
            assert release.wait(30)

    ds._invalidate_row_caches = held_invalidate
    compactor = threading.Thread(target=ds.compact)
    compactor.start()
    assert entered.wait(30)
    if call == "distances":
        read = lambda: ds.distances(rows[0])
    else:
        read = lambda: ds.search(rows[0], 3, mode=call)
    result = []
    reader = threading.Thread(target=lambda: result.append(read()))
    reader.start()
    reader.join(0.5)  # a read that waits for the layout is still waiting
    release.set()
    compactor.join(30)
    reader.join(30)
    assert not compactor.is_alive() and not reader.is_alive() and len(result) == 1
    assert len(ds) == 900
    if call == "distances":
        np.testing.assert_array_equal(result[0], read())
        np.testing.assert_allclose(
            result[0], np.linalg.norm(rows[100:] - rows[0], axis=1), rtol=1e-5
        )
    else:
        got, dist = result[0]
        want = read()
        np.testing.assert_array_equal(got, want[0])
        np.testing.assert_array_equal(dist, want[1])
        assert len(got) == 3 and set(got.tolist()) <= set(ids[100:].tolist())


def jax_state(jds):
    """The JAX dataset's whole state (tombstones and a stale quantization
    included) as the arrays interop.dataset_from_state takes."""
    count, quant = jds._count, jds._quant
    state = {
        "vectors": np.asarray(jds._vectors)[:count],
        "ids": jds._ids[:count],
        "dead": jds._dead[:count],
    }
    if quant is not None:
        n = quant.count
        state.update(quant_ids=quant.ids, stale=quant.stale)
        if quant.qtype is jax_svt.QuantType.I4:
            state.update(
                packed=np.asarray(quant.codes)[:n], alpha=np.asarray(quant.row_scale)[:n],
                csq=np.asarray(quant.sq_norms)[:n],
            )
            if quant.codes8 is not None:
                state.update(
                    codes8=np.asarray(quant.codes8)[:n], qtype8=quant.qtype8.value,
                    scale8=quant.scale8, offset8=quant.offset8,
                )
        else:
            state.update(
                codes=np.asarray(quant.codes)[:n], qtype=quant.qtype.value,
                scale=quant.scale, offset=quant.offset,
            )
    return state


@pytest.mark.parametrize("qtype", ["int8", "int4"])
def test_interop_carries_tombstones_and_stale_codes(qtype):
    """A JAX dataset after remove + update + add-after-quantize crosses
    over intact (dataset_from_state with dead, quant_ids and stale) and
    both engines give the same results in all five modes."""
    rng = np.random.default_rng(12)
    base = rng.standard_normal((600, 16)).astype(np.float32)
    opts = "dimension=16,type=FLOAT32,distance=L2"
    jds = jax_svt.VectorStore().create("d", opts)
    ids = jds.add(base[:500])
    jds.quantize(qtype=qtype, refine=qtype == "int4")
    jds.remove(ids[40:90])
    jds.update(ids[[3, 4]], base[[500, 501]] + 1.0)
    jds.add(base[500:600])
    pds = dataset_from_state(jax_state(jds), opts, device="cpu")
    assert pds.tombstones == jds.tombstones == 50
    assert pds.quant_stale and len(pds) == len(jds)
    np.testing.assert_array_equal(pds.ids, jds.ids)
    np.testing.assert_array_equal(pds._quant.ids, jds._quant.ids)
    q = queries(rng, base[[60, 550]], 16)
    modes = ["exact", "approx", "quantized", "rerank"] + (["refine"] if qtype == "int4" else [])
    for mode in modes:
        compare_mode(jds, pds, q, mode)
        compare_mode(jds, pds, q, mode, ids_filter=ids[::2])
