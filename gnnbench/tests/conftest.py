"""Tests of the benchmark's own code.  Run from the root of the checkout:

    python -m pytest gnnbench/tests -q

Tests marked ``cuda`` need the card and skip without one; on the chip:
``python -m pytest gnnbench/tests -q -m cuda``."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")
