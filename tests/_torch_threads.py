"""One intra-op thread for the port's CPU tests.

The suite runs test files in several worker processes at once; PyTorch's
default of one intra-op thread per core in every worker oversubscribes the
cores, and the port's small CPU ops then spend most of their time waiting
on each other (a file of ``[nv, nv]`` dense-scan tests ran 10x slower in
parallel than alone).  Results do not depend on the thread count: every
decision of the port folds in a fixed order.  Import the fixture into a
test module to use it.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
