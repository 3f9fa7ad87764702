"""The benchmark's own tests: the reference and the counts held to the port
at small sizes on the CPU, CPU rehearsals of whole runs at a tiny size, and
(marked ``cuda``) the lower-precision control on the card."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
