"""Torch's thread policy for the port's CPU tests: one intra-op thread.

Tier-1 runs six test processes on one host, and the CLI and training tests
start processes of their own (prep pools, two-process runs, gloo workers).
At torch's default of one intra-op thread per core their small ops spend
most of their time contending: under the suite one stack-emulation test
took 260 s at torch's default of eight threads and 1.2 s at one.
Every ``tests/test_torch_*.py`` that runs torch on the CPU therefore takes
the autouse fixture with

    from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)

so that the policy holds whether a file runs alone or under xdist, and a
test file that runs as a worker process calls ``use_one_thread()``.
``OMP_NUM_THREADS=1`` goes into the environment as well, so that the
processes a test starts begin at one thread. ``tests/test_torch_cuda.py``
runs only on the card, in a pytest process of its own, and keeps torch's
default.

Inter-op threads are left alone: no port test runs inter-op parallel work
(``torch.jit.fork``), and torch refuses a new inter-op count once any has
run.
"""

import os

import pytest
import torch


def use_one_thread() -> None:
    """One intra-op thread here and in every process started from here."""
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """``use_one_thread()`` for the module's tests; the process's own
    setting comes back after them, for the test files that follow."""
    threads, omp = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    use_one_thread()
    yield
    torch.set_num_threads(threads)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = omp
