"""CPU tests of the benchmark harness; tests marked `cuda` skip without a card."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skipped without one)")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
