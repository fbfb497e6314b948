"""CPU tests of the benchmark (`python -m pytest port_bench/tests`).

The `cuda` marker marks a test that needs the card; the `card` fixture
decides inside the test whether one is there and skips it otherwise."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
