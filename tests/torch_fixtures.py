"""Fixtures shared by the port's test files: import them by name into a
test module (pytest finds a fixture among the module's globals)."""

import pytest
import torch


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for torch: the suite runs in several worker
    processes at once, whose thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
