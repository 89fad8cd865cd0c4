"""An autouse fixture for the port's CPU tests of many small operations.

Under ``pytest-xdist`` every worker's PyTorch starts one intra-op thread
per core, so the workers' pools contend for the same cores, and a test of
thousands of small operations (a training loop, the recipe) slows down by
two orders of magnitude.  A test module that imports this fixture runs its
tests with one intra-op thread and restores the worker's setting after.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
