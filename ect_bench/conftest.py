"""pytest settings of the benchmark's own tests (``python3 -m pytest
ect_bench/tests``): the one marker of tests that need a CUDA card, and the
fixture that decides, when a test runs, whether there is one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    """Skips the test unless CUDA is available (decided at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda", 0)
