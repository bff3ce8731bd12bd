"""The one-thread fixture of the port's test files.

The suite's workers share the host's cores, and tier S is too small to gain
from intra-op threads: each ``tests/test_torch_*.py`` that trains imports
:func:`one_thread`, which runs the module (its module-scoped fixtures
included) on one torch thread and restores the count after. Subprocesses
get ``OMP_NUM_THREADS=1`` from their test file.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
