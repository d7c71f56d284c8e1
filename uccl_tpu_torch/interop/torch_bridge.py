"""Torch interop: move torch tensors through the transfer engine.

Port of ``uccl_tpu/interop/torch_bridge.py``: zero-copy registration of
CPU tensors and one-sided transfer into a peer's advertised window.
``allreduce_gradients`` (DDP-style averaging over ``DcnGroup``) waits for
``collective/hierarchical.py`` (ROADMAP queue A item 15).
"""

from __future__ import annotations

import numpy as np

from uccl_tpu_torch.p2p.endpoint import host_array


def tensor_buffer(t) -> np.ndarray:
    """Zero-copy numpy view of a contiguous CPU torch tensor.

    Dtypes numpy can't express (bfloat16, fp8, …) are reinterpreted as
    same-width integers — transfers move bytes, so the view is faithful.
    A CUDA tensor raises ``ValueError`` (stage it first)."""
    return host_array(t, "tensor_buffer")


def register_tensor(ep, t) -> int:
    """Register a torch tensor's memory with an Endpoint; returns mr id."""
    return ep.reg(tensor_buffer(t))


def send_tensor(ep_or_chan, conn_or_none, t, fifo: bytes) -> None:
    """One-sided write of a torch tensor into a peer's advertised window.

    Accepts either (Endpoint, conn_id) or (Channel, None).
    """
    buf = tensor_buffer(t)
    if conn_or_none is None:
        ep_or_chan.write(buf, fifo)
    else:
        ep_or_chan.write(conn_or_none, buf, fifo)


def advertise_tensor(ep, t) -> bytes:
    """Register + advertise a torch tensor in one step; returns the 64-byte
    FifoItem to hand to the writer. One-sided writes then land in the tensor
    in place — there is no separate receive call."""
    return ep.advertise(register_tensor(ep, t))
