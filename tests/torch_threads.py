"""The intra-op thread count of the port's CPU tests.

pytest-xdist (``-n N``) runs N test processes on the host's cores, and
torch's CPU ops would each use every core: oversubscribed, their threads
wait at every parallel region's barrier for threads that are not running.
On an 8-core host, beside five busy processes, the 8-step ``ell``
training run of ``tests/test_torch_train.py`` took ~7 minutes with
torch's 8 threads and ~1 with one (~27 s alone).  Each port test module that imports
:func:`torch_threads_per_worker` runs with the cores divided among the
workers; run alone, with all of them.
"""
import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_threads_per_worker():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
