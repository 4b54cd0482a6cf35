"""The benchmark's own tests (CPU, plus one marked ``card``)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, when
    the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the card")
    return torch.device("cuda", 0)
