"""One intra-op thread for the port's CPU test modules.

The suite runs in several pytest-xdist worker processes on one host, and
PyTorch's CPU operators would each run a pool of one thread a core: the
pools spin against each other (the port's test files took 1.6x longer
with -n 6 so). A test module that imports :func:`one_torch_thread` runs
on one intra-op thread and gives its worker the old count back after its
last test; a test that needs the process's own count (one whose numerics
were measured at it) takes :func:`default_torch_threads` too.

    from torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch

# the count a worker starts with, before any module changes it
DEFAULT_THREADS = torch.get_num_threads()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def default_torch_threads():
    torch.set_num_threads(DEFAULT_THREADS)
    yield
    torch.set_num_threads(1)
