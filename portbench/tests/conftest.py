import pytest


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none (decided here, at run
    time, never while a module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark's runs measure the H100")
    return torch.device("cuda")
