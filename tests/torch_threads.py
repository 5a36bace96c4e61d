"""One PyTorch intra-op thread for each test of the port.

The tier-1 run starts six test workers on the machine's cores.  Each
worker's PyTorch thread pool defaults to one thread a core, so the pools
oversubscribe the cores, and the many small ops of the port's tests then run
5-50x slower (tests/test_torch_mlp_examples.py went from 441 s to 57 s in
the tier-1 run with one thread).  Every ``tests/test_torch_*.py`` imports
:func:`one_thread`, which pytest then applies to each of its tests.
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """``torch.set_num_threads(1)`` for the test, the count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
