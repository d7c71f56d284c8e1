"""uccl_tpu_torch.interop: torch tensors through the port's transfer engine,
case for case as tests/test_torch_interop.py::TestTensorTransfer holds the
JAX package's bridge (its DDP case needs ``DcnGroup``, ROADMAP queue A item
15), plus a tensor over a Channel, the refusal of a device tensor, and the
bridge across the packages: a port tensor written into a JAX endpoint's
advertised tensor and the reverse.
"""

import threading

import numpy as np
import pytest
import torch

from uccl_tpu_torch.interop import advertise_tensor, register_tensor, send_tensor, tensor_buffer
from uccl_tpu_torch.p2p import Channel, Endpoint


class TestTensorTransfer:
    def test_one_sided_tensor_write(self):
        with Endpoint() as server, Endpoint() as client:
            conn = client.connect("127.0.0.1", server.port)
            server.accept()
            dst = torch.zeros(1024, dtype=torch.float32)
            mr = register_tensor(server, dst)
            fifo = server.advertise(mr)
            src = torch.randn(1024)
            send_tensor(client, conn, src, fifo)
            assert torch.equal(dst, src)  # landed in place, zero copies

    def test_non_contiguous_rejected(self):
        with Endpoint() as ep:
            t = torch.randn(8, 8).t()
            with pytest.raises(ValueError):
                register_tensor(ep, t)

    def test_dtype_roundtrip(self):
        with Endpoint() as server, Endpoint() as client:
            conn = client.connect("127.0.0.1", server.port)
            server.accept()
            for dtype in (torch.float16, torch.int64, torch.uint8, torch.bfloat16):
                dst = torch.zeros(64, dtype=dtype)
                fifo = server.advertise(register_tensor(server, dst))
                src = (torch.arange(64) % 7).to(dtype)
                send_tensor(client, conn, src, fifo)
                assert torch.equal(dst, src)

    def test_device_tensor_refused(self):
        with Endpoint() as ep:
            with pytest.raises(ValueError, match="device memory"):
                register_tensor(ep, torch.zeros(4, device="meta"))
            with pytest.raises(ValueError, match="device memory"):
                tensor_buffer(torch.zeros(4, device="meta"))

    def test_advertise_and_send_over_channel(self):
        with Endpoint(n_engines=2) as server, Endpoint(n_engines=2) as client:
            res = {}
            t = threading.Thread(target=lambda: res.setdefault("c", Channel.accept(server)))
            t.start()
            chan = Channel.connect(client, "127.0.0.1", server.port, n_paths=2,
                                   chunk_bytes=16 << 10)
            t.join(timeout=60)
            dst = torch.zeros(100_000, dtype=torch.bfloat16)
            fifo = advertise_tensor(server, dst)
            src = torch.linspace(-1, 1, 100_000, dtype=torch.bfloat16)
            send_tensor(chan, None, src, fifo)
            assert torch.equal(dst.view(torch.int16), src.view(torch.int16))

    def test_tensor_buffer_views_in_place(self):
        t = torch.zeros(8, dtype=torch.bfloat16)
        buf = tensor_buffer(t)
        assert buf.dtype == np.int16 and buf.ctypes.data == t.data_ptr()


@pytest.mark.parametrize("port_holds_dst", [True, False])
def test_bridge_across_packages(port_holds_dst):
    """The JAX bridge's tensor and the port's meet on one wire."""
    from uccl_tpu.interop import register_tensor as jregister
    from uccl_tpu.interop import send_tensor as jsend
    from uccl_tpu.p2p import Endpoint as JEndpoint

    (S, reg), (C, send) = (Endpoint, register_tensor), (JEndpoint, jsend)
    if not port_holds_dst:
        (S, reg), (C, send) = (JEndpoint, jregister), (Endpoint, send_tensor)
    with S() as server, C() as client:
        conn = client.connect("127.0.0.1", server.port)
        server.accept()
        for dtype in (torch.float32, torch.bfloat16, torch.int64):
            dst = torch.zeros(513, dtype=dtype)
            fifo = server.advertise(reg(server, dst))
            src = (torch.arange(513) % 97).to(dtype) - 40
            send(client, conn, src, fifo)
            assert torch.equal(dst, src)
