"""Interop adapters: torch tensors over the transfer engine.

Port of ``uccl_tpu/interop``. ``allreduce_gradients`` needs ``DcnGroup``
(``collective/hierarchical.py``), which is not ported yet (ROADMAP queue A
item 15).
"""

from uccl_tpu_torch.interop.torch_bridge import (
    tensor_buffer,
    register_tensor,
    advertise_tensor,
    send_tensor,
)

__all__ = [
    "tensor_buffer",
    "register_tensor",
    "advertise_tensor",
    "send_tensor",
]
