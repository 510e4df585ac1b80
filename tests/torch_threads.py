"""Caps torch's intra-op threads in a pytest-xdist worker.

Imported by every ``tests/test_torch_*.py``.  Under xdist each worker
would otherwise start one intra-op thread per core for torch, beside
XLA's own pool in the same process, so the workers oversubscribe the
cores many times over.  A worker gets its share of the cores
(``os.cpu_count() // PYTEST_XDIST_WORKER_COUNT``, at least one); a run
without xdist keeps torch's default.  The cap changes how work is
split across threads, not what is computed.
"""
import os

import torch


def worker_threads():
    """The intra-op thread count for this process, or None (no xdist)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers <= 0:
        return None
    return max(1, (os.cpu_count() or 1) // workers)


_N = worker_threads()
if _N is not None:
    torch.set_num_threads(_N)
