"""The float reference against a brute-force NumPy float64 top-k at tiny
sizes: its own answers pass the comparison that decides `correct`, its
TF32 control fails it."""

import numpy as np
import pytest

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


def brute_float(metric, q, x):
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    dot = q64 @ x64.T
    if metric == "DOT":
        return -dot
    if metric == "COSINE":
        return 1.0 - dot / (np.linalg.norm(q64, axis=1)[:, None] * np.linalg.norm(x64, axis=1)[None, :])
    sq = ((q64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)
    return np.sqrt(sq) if metric == "L2" else sq


@pytest.mark.parametrize("metric", ["COSINE", "L2", "SQUARED_L2", "DOT"])
def test_float_reference_matches_brute_force_float64(metric):
    seed = 13
    cfg = cfg_for("openai-5m-1536")
    cfg["metric"] = metric
    q, x = queries(seed), rows_np(seed)
    full = brute_float(metric, q, x)
    ref = spec.reference(cfg["reference"]).Reference(cfg)
    best, pos, _ = check.scan(ref, seed, cfg, "cpu", q, K)
    assert np.allclose(best.numpy(), np.sort(full, 1)[:, :K], rtol=0, atol=1e-12)
    # the positions are those of the distances
    assert np.allclose(np.take_along_axis(full, pos.numpy(), 1), best.numpy(), rtol=0, atol=1e-12)


def test_float_reference_passes_and_its_tf32_control_fails():
    seed = 23
    cfg = cfg_for("openai-5m-1536")
    mod = spec.reference(cfg["reference"])
    q = queries(seed)
    own = check.control_answers(mod.Reference(cfg), seed, cfg, "cpu", q)
    good = check.judge(own, mod.Reference(cfg), seed, cfg, "cpu")
    assert check.correct(good), good
    ctrl = check.control_answers(mod.Reference(cfg, "control"), seed, cfg, "cpu", q)
    bad = check.judge(ctrl, mod.Reference(cfg), seed, cfg, "cpu")
    assert not check.correct(bad), bad
