"""Torch's CPU threads in the port's test modules.

The tier-1 run puts several pytest workers on one machine's cores, and
torch's default of one intra-op thread per core in each of them (beside
XLA's own pools and the mesh tests' gloo ranks) oversubscribes the cores
many times over.  A module imports :func:`few_torch_threads` to run each
of its tests on ``THREADS`` threads, restored afterwards:

    from torch_threads import few_torch_threads  # noqa: F401 (autouse)
"""

import pytest
import torch

THREADS = 2


@pytest.fixture(autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, THREADS))
    yield
    torch.set_num_threads(n)
