"""pytest settings of the benchmark's own tests: the ``cuda`` marker, and
the card decided inside a fixture, never while a module is imported."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
for path in (str(ROOT / "src"), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (runs on the card only)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: runs on the card")
    return "cuda"


@pytest.fixture(autouse=True)
def one_thread():
    """Each test of the benchmark on one torch thread: the suite runs its
    files in several processes at once, and small products on many threads
    each only contend."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
