"""Test settings of the benchmark: the ``card`` marker, and the fixture that
decides, when a test runs, whether a CUDA card is there."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped where torch sees none")


@pytest.fixture
def card():
    """The card a ``card`` test runs on; skips the test without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: bench/run.py measures on the card only")
    return torch.device("cuda", 0)
