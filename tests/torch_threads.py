"""One torch intra-op thread in each pytest-xdist worker.

Under ``-n 6`` six workers share the machine's cores. With torch's default
thread count (one a core) each contends with the others, and a test that
takes seconds alone takes minutes. The slowest ``test_torch_*`` files import
the fixture below: it caps torch at one thread while their tests run in a
worker (``PYTEST_XDIST_WORKER`` set) and restores the count after the
module. A run without workers keeps torch's default.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread_per_worker():
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
