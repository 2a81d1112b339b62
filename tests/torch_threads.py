"""The torch intra-op thread count of the port's CPU tests: the host's
cores shared out among pytest-xdist's workers. At torch's default each
worker would run on every core, and six workers would oversubscribe the
CPU many times over."""

import os

import torch


def share_cores() -> int:
    """Set torch's intra-op threads to the cores over the xdist workers
    (1 worker outside xdist); returns the count."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, (os.cpu_count() or 1) // workers)
    torch.set_num_threads(n)
    return n
