"""One short run of a cell on the card, as the driver starts
it: `python -m pytest vbench/tests/test_vbench_card.py -q` on a machine
with a CUDA device (skips elsewhere)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
def test_a_run_on_the_card_is_correct_and_reports_its_metrics():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    proc = subprocess.run(
        [sys.executable, "vbench/run.py", "--workload", "cohere10m-int8.serial", "--seed", "4294967311",
         "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert {"qps", "p50_ms", "setup_s"} <= set(result["metrics"])
