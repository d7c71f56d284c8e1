"""Collectives layer: the NCCL-shaped Communicator and the member-stacked wrappers.

Port of ``uccl_tpu/collective/__init__.py``:

* :class:`Communicator` — host API over tensors with an explicit leading
  rank dimension (one "NCCL buffer" per member), whose kernel algos run the
  hand-written ring kernels of ``ring_ccl``.
* :mod:`uccl_tpu_torch.collective.ops` — the member-stacked wrappers.
"""

from uccl_tpu_torch.collective.communicator import Communicator, ReduceOp
from uccl_tpu_torch.collective import ops

__all__ = ["Communicator", "ReduceOp", "ops"]
