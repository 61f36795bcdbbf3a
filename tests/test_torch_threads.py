"""One torch thread a test worker, for the port's CPU tests.

The suite runs several pytest workers at once, and torch gives each as many
intra-op threads as the machine has cores: together they oversubscribe the
cores, and torch's threads wait on one another at every op, so a port run
that takes seconds alone takes minutes under the suite's load.  At these
tests' tiny widths one thread does an op about as fast as many, so the
modules that run the port's loops and steps take ``one_torch_thread``
(import it into the module), which holds one thread for the module and
puts the count back after it."""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_module_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
