"""Torch interop: move torch tensors through the transfer engine.

Port of ``uccl_tpu/interop/torch_bridge.py``: zero-copy registration of
CPU tensors, one-sided transfer into a peer's advertised window, and
``allreduce_gradients`` (DDP-style averaging over ``DcnGroup``; gradients
on the card are staged through pinned host memory).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from uccl_tpu_torch.p2p.endpoint import host_array, host_copy


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


def allreduce_gradients(parameters: Iterable, dcn_group) -> None:
    """Average gradients of torch parameters across the DCN group in place.

    The DDP contract over this framework's wire: flatten all grads into one
    bucket (like DDP's gradient bucketing), ring-allreduce it across
    processes through the transfer engine, unflatten, divide by world. A
    bucket on the card goes to pinned host memory and back; the division
    runs on the host, as in the JAX package, so the averages are the same
    bits on either device.
    """
    import torch

    params = [p for p in parameters if p.grad is not None]
    if not params:
        return
    flats = [p.grad.detach().reshape(-1) for p in params]
    # Reduce in float32: bf16 has no numpy dtype, and summing lower-precision
    # grads in f32 is what DDP does anyway. Cast back per-param on copy_.
    bucket = host_copy(torch.cat(flats).float())
    reduced = dcn_group.all_reduce(bucket.numpy())
    reduced = torch.from_numpy(reduced) / dcn_group.world
    dev = params[0].grad.device
    if dev.type == "cuda":
        reduced = reduced.pin_memory().to(dev, non_blocking=True)
    off = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(reduced[off : off + n].reshape(p.grad.shape).to(p.grad.dtype))
        off += n
