"""One intra-op torch thread for a port test module.

Under the suite's six workers a pool of one thread a core oversubscribes
the cores, and its spinning workers made the port's small CPU ops up to
100x slower; these ops are tiny, so one thread costs nothing alone. A
module takes the fixture by importing it::

    from torch_one_thread import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
