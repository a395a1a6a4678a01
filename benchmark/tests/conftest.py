import pytest
import torch


@pytest.fixture
def card():
    """The CUDA device, or a skip where this machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
