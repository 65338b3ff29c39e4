"""Each test worker's share of the machine's cores for torch.

pytest-xdist runs the suite in several worker processes, and torch gives
each of them a thread per core, so that six workers on eight cores run
their convolutions on 48 threads and wait on each other. The fixture gives
torch in a worker its share of the cores for one test module (every core
in a run without workers) and restores the count after it. A test module
takes it by importing it: ``from tests.torch_threads import
torch_threads_share  # noqa: F401``.
"""

import os

import pytest
import torch


@pytest.fixture(scope='module', autouse=True)
def torch_threads_share():
    workers = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
    yield
    torch.set_num_threads(before)
