"""The control's readings: the plain reference one precision step down
(reference/<name>.py, precision="control") put in the program's place, at
the cell's own size, judged exactly as a run judges the program's answers.
The limits in a configuration's `check` lie between the program's readings
(printed by every run under `checks`) and these. The benchmark's runs do
not run this.

    python3 vbench/calibrate.py --workload <cell> --seeds 11,12,13

prints one JSON line a seed. Imports nothing of the program.
"""

import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

import argparse  # noqa: E402
import json  # noqa: E402


def readings(cell_name: str, seed: int, device, config=None, traffic=None) -> dict:
    """The control's numbers for one seed: its answers to a sample of the
    cell's query pool, judged against the reference."""
    import torch

    from vbench import check, data, spec

    bench = spec.load_benchmark()
    cell = spec.workload(bench, cell_name)
    cfg = config or spec.config(cell["config"])
    tr = traffic or spec.traffic(cell["traffic"])
    device = torch.device(device)
    plan = data.QueryPlan(seed, cfg["rows"], cfg["dim"], tr["pool"], tr["near_share"], tr["near_noise"], device)
    for start, rows in data.row_chunks(seed, cfg["rows"], cfg["dim"], device):
        plan.take(start, rows)
    pool = plan.queries()
    q = pool[data.sample(seed, len(pool), check.SAMPLE)]
    ref = spec.reference(cfg["reference"])
    answers = check.control_answers(ref.Reference(cfg, "control"), seed, cfg, device, q)
    return check.judge(answers, ref.Reference(cfg), seed, cfg, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        numbers = readings(args.workload, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": numbers,
                          "seconds": round(time.perf_counter() - t, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
