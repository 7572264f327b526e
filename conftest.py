"""One share of the cores for torch in each pytest-xdist worker.

The suite runs in six xdist workers on an eight-core machine. Left alone,
each worker's torch takes eight intra-op threads, so 48 threads contend
for eight cores and a CPU test of the port that takes seconds alone takes
minutes. Inside a worker (``PYTEST_XDIST_WORKER`` set), torch gets the
cores divided by the number of workers, at least one; ``OMP_NUM_THREADS``
and ``MKL_NUM_THREADS`` carry the same count to the processes a test
spawns (the gloo ranks of the multi-rank tests), so they run as the
in-process side they are compared with. A run in one process keeps torch's
defaults. XLA's threads are left as they are.

Pytest loads this file before ``tests/conftest.py``.
"""
import os

if os.environ.get("PYTEST_XDIST_WORKER"):
    import torch

    _threads = max(1, (os.cpu_count() or 1)
                   // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
    torch.set_num_threads(_threads)
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = str(
        _threads)
