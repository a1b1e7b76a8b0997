"""One intra-op thread for the port's tests on the CPU.

The suite runs in six processes on eight cores.  At torch's default of a
thread a core, every small parallel region of each process waits on
threads that the other processes have taken the cores from: one test that
takes 0.67 s alone took 279 s so.  Each ``test_torch_*.py`` that runs torch
imports :func:`one_thread`, an autouse fixture of module scope, which sets
one thread for the module's tests (``OMP_NUM_THREADS`` too, for the
processes they start) and restores both after them;
``tests/test_torch_threads.py`` checks that every such file does.

    from torch_threads import one_thread  # noqa: F401
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(before[0])
    if before[1] is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = before[1]
