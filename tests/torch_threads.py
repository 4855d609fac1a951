"""One torch thread for the port's CPU tests: ``tests/test_torch_*.py``
import :func:`one_torch_thread`, an autouse fixture, into their namespace.

The suite runs in several pytest-xdist workers on one host. torch's intra-op
pool sizes itself to every core in each of them, and the pools then spin
against each other on the shared cores: on an 8-core host, six port test
files under six workers took 472 s with the default pool and 69 s with one
thread each (the same 109 tests passing). The port's tests run tiny shapes, where one
thread loses nothing. The fixture sets one thread for its module and puts
the count back after it, so that the tests of other files run as before."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
