"""One torch intra-op thread per test module, for the port's test files.

The suite runs in parallel workers that share the machine's cores, and
torch gives each worker a pool of one thread per core, so the many small
CPU ops of the port's tests (working-set solves, model layers) spin
waiting on one another: the admission preset's port and reference runs
took 0.3 s in six concurrent processes with one thread each and 114 s
with torch's default of eight (8 cores). A module imports the fixture
to run its tests on one thread; the count is restored after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
