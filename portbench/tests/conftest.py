"""The benchmark's own tests (``python -m pytest portbench/tests -q``):
CPU tests at tiny sizes, and ``cuda`` tests that skip without a card."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    """The CUDA device, decided when the test runs; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
