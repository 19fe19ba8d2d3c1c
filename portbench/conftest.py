"""pytest settings of the benchmark's own tests (``portbench/tests``):
the ``card`` marker, and a fixture that skips a test without a CUDA
device, decided when the test runs."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: "
                    "python -m pytest portbench/tests -m card")
    return torch.device("cuda")
