"""One PyTorch thread for the CPU parity tests.

A test file takes the fixture below by importing it:

    from torch_threads import one_torch_thread  # noqa: F401

At the tests' sizes more threads buy little, while several test workers
side by side, each with a thread per core, slow one another down many
times over (their OpenMP teams spin on cores the others hold).
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
