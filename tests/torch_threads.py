"""One intra-op thread for the port's CPU tests.

The port's tests run tiny tensors beside other test workers (pytest-xdist).
Torch's intra-op worker threads then only contend for the cores: its
spinning threads made a tiny matmul ~100x slower than in a process alone,
and a test file of the port up to ~20x slower in all. Each test module of
the port imports this autouse fixture, which runs its tests on one thread
and restores the count after them.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
