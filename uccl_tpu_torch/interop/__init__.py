"""Interop adapters: torch tensors over the transfer engine.

Port of ``uccl_tpu/interop``: tensors over the transfer engine and
``allreduce_gradients``, DDP-style averaging over ``DcnGroup``.
"""

from uccl_tpu_torch.interop.torch_bridge import (
    tensor_buffer,
    register_tensor,
    advertise_tensor,
    send_tensor,
    allreduce_gradients,
)

__all__ = [
    "tensor_buffer",
    "register_tensor",
    "advertise_tensor",
    "send_tensor",
    "allreduce_gradients",
]
