"""Fixtures every port test file (``tests/test_torch_*.py``) imports into its
namespace: one torch thread, and torch's global CPU RNG left as it was found.

:func:`one_torch_thread`: the suite runs in several pytest-xdist workers on
one host. torch's intra-op pool sizes itself to every core in each of them,
and the pools then spin against each other on the shared cores: on an
8-core host, six port test files under six workers took 472 s with the
default pool and 69 s with one thread each (the same 109 tests passing).
The port's tests run tiny shapes, where one thread loses nothing. The
fixture sets one thread for its module and puts the count back after it, so
that the tests of other files run as before.

:func:`torch_rng_restored`: a port test that builds a module with torch's
default initialization, or calls ``torch.randn`` without a generator, moves
the global RNG. A later file on the same worker that draws from the global
RNG without seeding it would then see a state that depends on which port
files ran before it. The fixture saves the state before its module and
restores it after, so that the port's files leave it as they found it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def torch_rng_restored():
    state = torch.random.get_rng_state()
    yield
    torch.random.set_rng_state(state)
