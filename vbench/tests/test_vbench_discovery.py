"""Every piece BENCHMARK.json names is found by its name, and the
declaration keeps to the benchmark contract's forms."""

import json
import re

import pytest

from vbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vbench"] and BENCH["command"] == ["python3", "vbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_each_configuration_file_is_found_and_names_its_reference(cfg):
    assert cfg["file"] == f"vbench/configs/{cfg['name']}.json"
    body = spec.config(cfg["name"])
    assert body["name"] == cfg["name"]
    ref = spec.reference(body["reference"])
    assert hasattr(ref, "Reference")
    assert set(body["check"]) == {"dist_err", "rank_gap"}


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_each_cell_finds_its_configuration_and_traffic(cell):
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    tr = spec.traffic(cell["traffic"])
    assert tr["entry"] in ("search", "batching")
    assert 1 <= tr["clients"] <= 100  # VectorDBBench's concurrency sweep
    assert cell["chips"] == 1
    assert len(cell["why"]) <= 200
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = {m["name"] for m in spec.metrics_for(BENCH, cell["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_for(BENCH, cell["name"], True)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_metric_has_a_reader_and_its_forms(metric):
    assert callable(spec.metric_reader(metric["name"]))
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        for cell in metric["workloads"]:
            reported = {m["name"] for m in spec.metrics_for(BENCH, cell, False)}
            assert metric["moves"] in reported


def test_names_are_unique_and_well_formed():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[key]]
        assert all(NAME.match(n) for n in names)
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_a_new_piece_is_found_by_its_name_alone(tmp_path, monkeypatch):
    # a configuration, a mix and a metric added as files, with no edit to
    # any file that is there
    for kind in ("configs", "traffic", "metrics"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "new-config.json").write_text('{"name": "new-config"}')
    (tmp_path / "traffic" / "new-mix.json").write_text('{"entry": "search", "clients": 2}')
    (tmp_path / "metrics" / "new.metric.py").write_text("def read(run):\n    return 7.0\n")
    monkeypatch.setattr(spec, "HERE", tmp_path)
    assert spec.config("new-config")["name"] == "new-config"
    assert spec.traffic("new-mix")["clients"] == 2
    assert spec.metric_reader("new.metric")(None) == 7.0
    bench = {"end_to_end": [{"name": "qps"}], "per_layer": [
        {"name": "new.metric", "moves": "qps"},
        {"name": "other", "moves": "qps", "workloads": ["elsewhere"]}]}
    assert [m["name"] for m in spec.metrics_for(bench, "any.cell", True)] == ["new.metric"]
