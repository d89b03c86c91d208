"""A module-scoped fixture for the port's test files: torch computes on
one intra-op thread while a file's tests run, and gets its thread count
back after them.

The suite runs its files in parallel worker processes (``-n 6``). Each
torch process otherwise keeps an OpenMP thread per core, and their
barriers stall when the workers' threads outnumber the cores. On an
8-core host under ``-n 6`` the port's files took 190-196 s of wall time
without it and 108-113 s with it (and 41 more tests). A test file imports it by name
(``from torch_one_thread import one_torch_thread``); pytest applies it
to every test of that file.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)
