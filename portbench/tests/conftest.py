"""The benchmark's own tests, run from the checkout's root:

    python -m pytest portbench/tests -q

They run on the CPU at sizes it holds. Tests marked ``card`` need a CUDA
device and skip without one; run them on the card with the same command.
Whether there is a card is decided in the ``card`` fixture, never while a
module is imported.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")
