"""The benchmark's declaration (BENCHMARK.json at the checkout's root) and
the pieces it names, each found by name: a configuration is
`configs/<name>.json`, a traffic mix `traffic/<name>.json`, a metric's
reader `metrics/<name>.py` and a configuration's plain reference
`reference/<name>.py`. Adding one of them is adding a file."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def load_benchmark(path: Path | None = None) -> dict:
    with open(path or CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def _json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def load_module(path: Path, name: str) -> ModuleType:
    """A module from its file, whatever the file's name (metric files are
    named after metrics, which hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The reader of one metric: read(run) -> float | None."""
    return load_module(HERE / "metrics" / f"{name}.py", f"vbench_metric_{name}").read


def reference(name: str) -> ModuleType:
    return load_module(HERE / "reference" / f"{name}.py", f"vbench_reference_{name}")


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics, or with
    trace its per-layer metrics (those that list the cell, or that list no
    cells and move an end-to-end metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [
        m for m in bench["per_layer"]
        if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)
    ]
