"""Fixtures shared by the port's CPU parity tests (``tests/test_torch_*.py``).

A test module takes a fixture by importing it; pytest then applies it there
and nowhere else::

    from _torch_fixtures import one_torch_thread  # noqa: F401

This module imports torch and pytest only.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while the importing module runs, the count
    before it restored after. The tests' models are tiny: a thread pool
    costs more than it gains on their ops, and far more when the suite's
    parallel workers, each with its own torch and XLA pools, share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
