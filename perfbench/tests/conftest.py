"""Tests of the benchmark harness. The ones that need the card carry the
``card`` marker and take the ``card`` fixture, which skips where no CUDA
device is visible; on a machine with the card:

    python -m pytest perfbench/tests -q
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped where none is visible")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
