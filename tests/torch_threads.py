"""A module-scoped fixture that caps torch's intra-op threads for the
port's test files. The suite runs six pytest workers on eight cores; a
torch process with a thread per core beside five others runs several
times slower than with two threads. Each ``tests/test_torch_*.py`` file
imports :func:`cap_torch_threads`, which sets two threads for the file's
duration and restores the old count after it, so the JAX files a worker
runs later keep theirs."""

import pytest
import torch

TEST_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def cap_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, TEST_THREADS))
    yield
    torch.set_num_threads(old)
