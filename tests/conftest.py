"""Pytest settings of the repo's tests: the ``card`` marker of the port's
tests that need an NVIDIA H100, and the fixture that skips them without
one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA H100; run on the chip with "
        "`python3 -m pytest -q -m card tests/test_torch_prefill_ladder.py`")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided in the test,
    never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip: python3 -m pytest -q -m card "
                    "tests/test_torch_prefill_ladder.py)")
    return torch.device("cuda")
