"""The one-intra-op-thread policy of the port's CPU tests.

The suite's parallel workers share the cores, and torch's default pool (a
thread per core in every worker) oversubscribes them on the many small ops
of the CPU training runs and plain scans (an epoch measured 100x slower).
A test module takes the policy with

    from torch_threads import one_torch_thread as _one_torch_thread
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's tests, the pool restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
