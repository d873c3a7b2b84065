"""The benchmark's CPU tests: ``pytest port_bench/tests`` from the root of
the repository.  Tests marked ``card`` need a CUDA device and skip without
one; the ``card`` fixture decides."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
