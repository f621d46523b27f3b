"""A whole run on the CPU (the look for a CUDA device skipped, a small
configuration in place of the named file), with the timed path sound and
with it broken underneath: `correct` must read true only for the sound
path. The faults a search can have: an answer altered where it is
produced, and half of a batch left out (its answers taken from the other
half)."""

import io
import json

import numpy as np
import pytest

import run
from sqlite_vector_tpu_torch.dataset import Dataset
from vbench import spec

BENCH = spec.load_benchmark()


def small(cell_name):
    cell = spec.workload(BENCH, cell_name)
    cfg, tr = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    cfg.update(rows=4000, dim=32, k=10)
    tr.update(pool=64, warm_seconds=0.2, clients=min(tr["clients"], 4))
    return cfg, tr


def drive(cell_name, seed=5_000_000_011):
    cfg, tr = small(cell_name)
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", cell_name, "--seed", str(seed), "--seconds", "0.6", "--trace", "0"],
                  device="cpu", config=cfg, traffic=tr, out=out, err=err)
    assert rc == 0, err.getvalue()
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    # the numbers compared are the last lines of standard error too
    tail = err.getvalue().strip().splitlines()[-3:]
    assert [line.split()[1] for line in tail] == list(result["checks"])
    assert list(result)[-1] == "checks"
    return result


def altered(search):
    def wrong(self, q, k, **kw):
        ids, dist = search(self, q, k, **kw)
        ids = np.array(ids, copy=True)
        last = ids[..., -1]
        ids[..., -1] = np.where(last == len(self), 1, last + 1)
        # keep the ids distinct, as a plausible wrong answer would be
        return ids, dist
    return wrong


def half_batch(search):
    def wrong(self, q, k, **kw):
        q = np.atleast_2d(q)
        h = (len(q) + 1) // 2
        ids, dist = search(self, q[:h], k, **kw)
        pick = np.arange(len(q)) % h
        return ids[pick], dist[pick]
    return wrong


CELLS = [c["name"] for c in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_path_is_correct(cell):
    r = drive(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {m["name"] for m in spec.metrics_for(BENCH, cell, False)}


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced_is_caught(cell, monkeypatch):
    monkeypatch.setattr(Dataset, "search", altered(Dataset.search))
    assert not drive(cell)["correct"]


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"] if c["traffic"] == "concurrent"])
def test_half_of_a_batch_left_out_is_caught(cell, monkeypatch):
    monkeypatch.setattr(Dataset, "search", half_batch(Dataset.search))
    r = drive(cell)
    assert not r["correct"]
