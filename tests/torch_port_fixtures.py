"""Fixtures shared by the PyTorch port's CPU tests."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the module's torch ops on one thread. The suite runs several
    workers at once, each with JAX's own thread pool; torch's default of one
    thread per core on top of that oversubscribes the cores and slows a
    64-px train step by an order of magnitude."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
