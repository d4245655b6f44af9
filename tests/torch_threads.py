"""An autouse fixture for the port's test files: one torch intra-op thread
per test.

The suite runs in several xdist workers that share the host's cores. With
torch's default of one intra-op thread per core in every worker, the
workers' threads outnumber the cores many times over, and the small
tensors of these tests spend their time waiting for each other's turn: six
of the port's heaviest test files took 351 s on 6 workers of an 8-core
host with the default threads and 68 s with one thread per test. Tests
import the fixture by name:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
