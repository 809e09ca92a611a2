"""One intra-op thread for the port's tests.

The tier-1 suite runs several pytest-xdist workers on the host's cores, and
each spawns ranks and CLI subprocesses of its own; PyTorch's default (one
intra-op thread per core in every process) oversubscribes the host many
times over, and its threads spin while they wait. Every CPU port test
module (the card-only ``*_cuda.py`` files aside) imports ``one_thread``, an
autouse fixture of module scope: while that module's tests run, the worker
takes one intra-op thread and ``OMP_NUM_THREADS=1`` passes the same to
every process they start (a spawned rank keeps it:
``parallel/mesh._rank_main`` respects the variable). Both are restored
after the module, so the JAX package's tests, which a worker may run in the
same process, run as they do alone.

``default_threads()`` gives a block the process's default thread count
back: a parity test whose f32 result was held to its tolerance at that
count (a convolution's gradient sums in another order on one thread) runs
its port step inside it."""
import contextlib
import os
from typing import Iterator

import pytest
import torch

DEFAULT = torch.get_num_threads()  # the count this process started with


@pytest.fixture(scope="module", autouse=True)
def one_thread() -> Iterator[None]:
    prior, prior_env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prior)
        if prior_env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = prior_env


@contextlib.contextmanager
def default_threads() -> Iterator[None]:
    prior = torch.get_num_threads()
    torch.set_num_threads(DEFAULT)
    try:
        yield
    finally:
        torch.set_num_threads(prior)
