"""CPU tests of the benchmark harness. ``cuda`` tests decide inside the
test whether a card is there. One torch thread: the port's CPU forms
run in these tests beside the reference's worker processes."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    import torch

    torch.set_num_threads(1)
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips where torch.cuda.is_available() is false")
