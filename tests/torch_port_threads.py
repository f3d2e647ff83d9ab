"""One intra-op torch thread for a whole port test module: imported by
tests/test_torch_port_*.py as an autouse module fixture.

The suite runs in several worker processes on few cores. With a thread
pool per worker, torch's many small operations wait on one another's
spinning threads: on the tiny models a test ran 10x to 100x slower in
the full run than alone. Module scope, so the module fixtures that build
and run models (a trainer's epochs, a tracker's frames) run on one thread
too; a single thread also makes CPU backward passes repeatable bit for
bit."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
