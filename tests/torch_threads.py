"""One torch thread for the port's tests at toy shapes.

The suite's workers share the machine's cores. A toy tensor's work is too
small to share out, and torch's default of one thread a core makes each
worker's OpenMP threads contend with every other worker's. A test module that
imports :func:`one_torch_thread` runs on one torch thread, set before its
module-scoped fixtures and restored after its last test."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
