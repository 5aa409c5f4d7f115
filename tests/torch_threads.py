"""One torch intra-op thread for a test module.

Beside the session's eight-device JAX runtime and, under xdist, the other
workers, torch's intra-op pool oversubscribes the cores, and a test that
runs many small ops (threads of an engine, a fit's inner loop) waits on it.
A module imports :func:`one_torch_thread` to run its tests on one thread
(restored after the module)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
