"""CPU tests of the benchmark harness: `python -m pytest vbench/tests -q`
from the checkout's root. Tests marked `cuda` need the card and skip
elsewhere, deciding inside the test."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "vbench"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips where torch.cuda.is_available() is False)")
