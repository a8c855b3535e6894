"""The card fixture of the benchmark's tests (the card tests: ``python -m
pytest cinebench/tests -m cuda``)."""

import pytest


@pytest.fixture
def cuda_device():
    """The card; the test skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
