"""The benchmark's own tests. Run them from the repository root:

    python -m pytest portbench/tests -q

Tests that need the card carry the `card` marker and take the `card`
fixture, which skips them where no CUDA device is present.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here: this test runs on the card")
    return "cuda"
