"""One PyTorch intra-op thread for a port test module.

Import the fixture into the module (``from _torch_threads import
one_torch_thread  # noqa: F401``): pytest then runs the whole module
with ``torch.set_num_threads(1)`` and restores the count after it.
The suite runs with six xdist workers on eight cores; PyTorch's
default pool of a thread a core in each of them oversubscribes the CPU
and made the port's heavy files several times slower than alone (a
ResNet archive test 392 s against 22 s). With one thread a worker the
port's random draws also take the hash's cache-sized chunks
(``random.py::_threefry_tensors``).
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
