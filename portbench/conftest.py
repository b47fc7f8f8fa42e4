"""pytest settings of the benchmark's own tests (``portbench/tests``).

Tests marked ``card`` need a CUDA card; whether one is present is decided
inside the ``card`` fixture, never while a module is imported, so every
worker collects the same tests."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    import torch

    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
    # the CPU runs are small: a few threads each, so that workers do not
    # oversubscribe the cores
    torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark runs the port's kernels")
    return torch.device("cuda")
