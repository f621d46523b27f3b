"""The plain reference against a brute-force NumPy top-k at tiny sizes,
and the comparison that decides `correct`: the reference's own answers
pass it, its control (one precision step down) fails it."""

import numpy as np

from vbench import check, data, spec

N, D, K, S = 3000, 48, 10, 16


def cfg_for(name):
    cfg = spec.config(name)
    cfg.update(rows=N, dim=D, k=K)
    return cfg


def rows_np(seed):
    return np.concatenate([x.numpy() for _, x in data.row_chunks(seed, N, D, "cpu")])


def queries(seed):
    plan = data.QueryPlan(seed, N, D, 64, 0.5, 0.1, "cpu")
    for start, x in data.row_chunks(seed, N, D, "cpu"):
        plan.take(start, x)
    return plan.queries()[:S]


def brute_cosine(q, x):
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    dot = q64 @ x64.T
    return 1.0 - dot / (np.linalg.norm(q64, axis=1)[:, None] * np.linalg.norm(x64, axis=1)[None, :])


def int8_codes(a, scale):
    s = a.astype(np.float32) * np.float32(scale)
    r = np.trunc(s + np.where(s < 0, np.float32(-0.5), np.float32(0.5)).astype(np.float32))
    return np.clip(r, -128, 127).astype(np.int64)


def test_rows_are_drawn_alike_from_one_seed_and_differ_across_seeds():
    a = rows_np(7)
    assert np.array_equal(a, rows_np(7))
    assert not np.array_equal(a, rows_np(8))
    chunks = list(data.row_chunks(7, N, D, "cpu", chunk=700))
    assert [s for s, _ in chunks] == [0, 700, 1400, 2100, 2800]
    # chunk c comes from its own stream: a chunk is the same wherever it sits
    assert np.array_equal(chunks[0][1].numpy(), np.concatenate([x.numpy() for _, x in data.row_chunks(7, 700, D, "cpu", chunk=700)]))
    assert np.allclose(np.linalg.norm(a, axis=1), 1.0, atol=1e-6)
    plan_q = queries(7)
    assert plan_q.shape == (S, D)
    # half of the pool sits near a base row
    d = brute_cosine(queries(7), a).min(1)
    assert (d < 0.02).any() and (d > 0.2).any()


def test_int8_reference_matches_brute_force_over_global_min_max_codes():
    seed = 11
    cfg = cfg_for("cohere-10m-768-int8")
    q = queries(seed)
    x = rows_np(seed)
    scale = np.float32(127.0) / np.float32(max(abs(x.min()), abs(x.max())))
    qc, xc = int8_codes(q, scale), int8_codes(x, scale)
    dot = (qc @ xc.T).astype(np.float64)
    full = 1.0 - dot / (np.sqrt((qc * qc).sum(1))[:, None] * np.sqrt((xc * xc).sum(1))[None, :])
    ref = spec.reference(cfg["reference"]).Reference(cfg)
    best, pos, _ = check.scan(ref, seed, cfg, "cpu", q, K)
    assert ref.scale == scale
    want = np.sort(full, 1)[:, :K]
    assert np.allclose(best.numpy(), want, rtol=0, atol=1e-12)


def test_the_reference_passes_and_its_control_fails():
    seed = 21
    cfg = cfg_for("cohere-10m-768-int8")
    mod = spec.reference(cfg["reference"])
    q = queries(seed)
    # the reference's own answers, rounded to float32 as the program reports them
    own = check.control_answers(mod.Reference(cfg), seed, cfg, "cpu", q)
    good = check.judge(own, mod.Reference(cfg), seed, cfg, "cpu")
    assert check.correct(good), good
    ctrl = check.control_answers(mod.Reference(cfg, "control"), seed, cfg, "cpu", q)
    bad = check.judge(ctrl, mod.Reference(cfg), seed, cfg, "cpu")
    assert not check.correct(bad), bad


def test_malformed_answers_count_as_bad():
    k, n = 3, 10
    assert check.well_formed((np.array([1, 2, 3]), np.array([0.1, 0.2, 0.2])), k, n)
    for ids, dist in [([1, 2], [0.1, 0.2]), ([1, 1, 2], [0.1, 0.2, 0.3]), ([0, 1, 2], [0.1, 0.2, 0.3]),
                      ([1, 2, 11], [0.1, 0.2, 0.3]), ([1, 2, 3], [0.3, 0.2, 0.1]), ([1, 2, 3], [0.1, np.nan, 0.3])]:
        assert not check.well_formed((np.array(ids), np.array(dist)), k, n)
    assert not check.well_formed(None, k, n)
