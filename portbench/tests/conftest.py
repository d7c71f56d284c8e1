"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
repository root. CPU tests at tiny sizes; those marked ``cuda`` run the
cells' control on the card and skip without one."""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads: the suite's workers share the machine."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
