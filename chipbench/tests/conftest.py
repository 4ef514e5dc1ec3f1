"""The benchmark's CPU tests run on one intra-op thread a module (the suite
runs in parallel workers that share the machine's cores)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
