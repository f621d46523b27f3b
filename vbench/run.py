"""One run of one cell of the benchmark.

    python3 vbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, vbench/ and the
port. Set-up builds the cell's dataset from the seed and warms the cell's
own traffic; the window then measures for --seconds; the answers of the
window are judged against the plain reference once it has closed. The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics, read from a profiled slice that follows the window),
`device`, with --trace 1 `breakdown`, and last `checks`, each number
compared beside its limit (also the last lines of standard error).

Exits non-zero, printing no result, without enough CUDA devices, when the
port cannot be imported from the checkout, or when jax, jaxlib, flax or the
JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import os
import sys
from pathlib import Path


def _since_process_start() -> float:
    """Seconds from the process's start to now, from /proc (0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


START_S = _since_process_start()  # the interpreter's own start
T0 -= START_S
HERE = Path(__file__).resolve().parent
# every build and kernel cache at a fixed path inside the checkout
os.environ["SVT_COMPILE_CACHE"] = str(HERE / "_build")
for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(HERE / "_cache" / sub)
# load from one process with few threads
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
from dataclasses import dataclass  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sqlite_vector_tpu")


@dataclass
class RunRecord:
    """What the metric readers read."""

    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window: object  # load.Window
    calls: list  # (start, end, B) of the window's searches, traced runs only
    trace: object  # tracing.Summary, traced runs only


class CollectorLog:
    """The cyclic collector's runs while it is installed in gc.callbacks:
    (generation, start, seconds)."""

    def __init__(self):
        self.runs: list = []
        self._start = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        now = time.perf_counter()
        if phase == "start":
            self._start = now
        else:
            self.runs.append((info["generation"], self._start, now - self._start))

    def summary(self, until: float) -> dict:
        """Per generation, the runs that started before `until`: how many,
        and their longest and total ms."""
        out = {}
        for g in (0, 1, 2):
            ms = [s * 1e3 for gen, start, s in self.runs if gen == g and start < until]
            out[f"gen{g}"] = [len(ms), round(max(ms, default=0.0), 3), round(sum(ms), 3)]
        return out


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None, *, device=None, config=None, traffic=None, out=None, err=None) -> int:
    """One run. Tests pass `device` (skipping the look for CUDA devices)
    and small `config` / `traffic` dicts in place of the named files."""
    out, err = out or sys.stdout, err or sys.stderr
    args = parse(argv)
    parts = {"start_s": START_S}
    t = time.perf_counter()
    import torch

    from vbench import check, spec
    from vbench.load import Clients
    from vbench.stats import percentile
    from vbench.system import System, load_program
    from vbench.tracing import Tracer, summarize

    parts["import_s"] = time.perf_counter() - t
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    cfg = config or spec.config(cell["config"])
    tr = traffic or spec.traffic(cell["traffic"])
    wanted = spec.metrics_for(bench, cell["name"], bool(args.trace))
    readers = {m["name"]: spec.metric_reader(m["name"]) for m in wanted}
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"needs {cell['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=err)
            return 2
        device = torch.device("cuda:0")
    device = torch.device(device)
    cuda = device.type == "cuda"
    t = time.perf_counter()
    if cuda:
        torch.zeros(1, device=device)  # the device's context
    parts["cuda_s"] = time.perf_counter() - t
    try:
        svt = load_program()
    except ImportError as e:
        print(f"the port is not in this checkout: {e}", file=err)
        return 3
    parts["program_s"] = time.perf_counter() - t - parts["cuda_s"]

    system = System(svt, cfg, tr, args.seed, device)
    pool = system.build(parts)
    call = system.entry()
    tracer = None
    if args.trace:
        tracer = Tracer(float("inf"), tr["trace_seconds"], tr["trace_settle"], cuda)
        system.probe(tracer)
    t = time.perf_counter()
    system.first_search(pool[0])
    parts["first_search_s"] = time.perf_counter() - t
    clients = Clients(call, pool, tr["clients"])
    t = time.perf_counter()
    clients.start()
    time.sleep(tr["warm_seconds"])
    parts["warm_s"] = time.perf_counter() - t
    now = time.perf_counter()
    clients.close_at = now + args.seconds
    clients.open_at = now
    setup_s = now - T0
    print("# setup " + json.dumps({k: round(v, 4) for k, v in parts.items()}), file=out, flush=True)
    collector = CollectorLog()
    gc.callbacks.append(collector)
    time.sleep(max(0.0, clients.close_at - time.perf_counter()))
    gc.callbacks.remove(collector)
    if tracer is not None:
        tracer.start_at = clients.close_at
        if not tracer.done.wait(tr["trace_settle"] + tr["trace_seconds"] + 120):
            raise RuntimeError("the traced slice did not end")
    clients.stop()
    for e in clients.errors:
        print(f"request failed: {e}", file=err)
    window = clients.window()
    calls = [c for c in system.calls if window.open_at <= c[0] < window.close_at]
    lat = window.latencies()
    print("# load " + json.dumps({
        "attempted": window.attempted, "completions": window.completions,
        "p50_ms": round(percentile(lat, 50) * 1e3, 4) if len(lat) else None,
        "p99_ms": round(percentile(lat, 99) * 1e3, 4) if len(lat) else None}), file=out, flush=True)
    print("# gc " + json.dumps(collector.summary(clients.close_at)), file=out, flush=True)

    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                "count": cell["chips"],
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if cuda else 0}
    summary = None
    if tracer is not None:
        summary = summarize(tracer.events(), tr["trace_settle"] * 1e6)
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.slice_s

    # the program's state is freed before the reference runs
    clients.call = call = None
    system.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = spec.reference(cfg["reference"]).Reference(cfg)
    numbers = check.judge(window.answers, ref, args.seed, cfg, device)

    bad = forbidden_modules()
    if bad:
        print(f"loaded in the process that reports: {', '.join(bad)}", file=err)
        return 4
    record = RunRecord(cell, cfg, tr, setup_s, window, calls, summary)
    metrics = {}
    for m in wanted:
        value = readers[m["name"]](record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {
        "correct": check.correct(numbers),
        "attempted": window.attempted,
        "failed": int(numbers["bad_answers"]["value"]),
        "metrics": metrics,
        "device": dev_info,
    }
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.top_ops, "idle_gaps": summary.idle_gaps}
    result["checks"] = numbers
    for name, v in numbers.items():
        print(f"check {name} = {v['value']!r} (limit {v['limit']!r})", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    # Python's bytecode is a build cache like the kernels': kept in the
    # checkout, so that only a checkout's first run compiles torch's and
    # the port's modules from source (an interpreter started with
    # PYTHONDONTWRITEBYTECODE and site-packages without bytecode would
    # compile them in every run: 5-11 s of set-up on the card's host).
    sys.pycache_prefix = str(HERE / "_cache" / "pycache")
    sys.dont_write_bytecode = False
    sys.exit(main())
