"""The port's p2p plane on the card: CUDA tensors staged through pinned host
memory (``Endpoint.send_device`` / ``recv_device``) at chunked and
monolithic sizes and in bf16, a CUDA tensor refused by ``reg``, and a weight
push published from CUDA tensors, with a planted fault: a byte flipped in
one staged chunk must fail that group's CRC at the fetching peer.

Every test needs a CUDA GPU and skips without one. This file imports
neither jax nor the JAX package, so it runs alone, past the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_p2p.py

Tolerance: none; every transfer is bit-exact.
"""

import threading

import pytest
import torch

from uccl_tpu_torch.p2p import Channel, Endpoint, WeightPublisher
from uccl_tpu_torch.p2p import weight_push as wp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the staging path copies between the card and pinned memory)")
    return torch.device("cuda")


@pytest.fixture
def pair():
    with Endpoint() as server, Endpoint() as client:
        conn_c = client.connect("127.0.0.1", server.port)
        conn_s = server.accept()
        yield server, client, conn_s, conn_c


def _roundtrip(pair, x, **kw):
    server, client, conn_s, conn_c = pair
    err = []

    def send():
        try:
            client.send_device(conn_c, x, **kw)
        except BaseException as e:  # surfaced below
            err.append(e)

    t = threading.Thread(target=send)
    t.start()
    y = server.recv_device(conn_s, tuple(x.shape), x.dtype, timeout_ms=60000)
    t.join(timeout=120)
    assert not err, err
    return y


def _same_bits(a, b):
    n = a.element_size()
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[n]
    return torch.equal(a.contiguous().view(ints).cpu(), b.contiguous().view(ints).cpu())


@pytest.mark.parametrize("chunk_bytes", [1 << 20, 1 << 30])
def test_device_roundtrip_chunked_and_monolithic(dev, pair, chunk_bytes):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(3, 1000, 1001, device=dev, generator=g)  # 12 MB, an uneven tail
    y = _roundtrip(pair, x, chunk_bytes=chunk_bytes)
    assert y.device.type == "cuda" and y.shape == x.shape and y.dtype == x.dtype
    assert _same_bits(y, x)


def test_device_roundtrip_bf16(dev, pair):
    x = torch.linspace(-4, 4, 1 << 20, device=dev, dtype=torch.bfloat16).reshape(1024, 1024)
    y = _roundtrip(pair, x, chunk_bytes=64 << 10)
    assert y.dtype == torch.bfloat16 and _same_bits(y, x)


def test_non_contiguous_device_tensor_is_staged_in_order(dev, pair):
    x = torch.arange(4096 * 3, device=dev, dtype=torch.int32).reshape(4096, 3).t()
    y = _roundtrip(pair, x, chunk_bytes=4096)
    assert torch.equal(y.cpu(), x.cpu())


def test_device_to_host_receiver(dev, pair):
    """A CUDA sender and a receiver that asks for the CPU."""
    server, client, conn_s, conn_c = pair
    x = torch.arange(100_000, device=dev, dtype=torch.float32)
    t = threading.Thread(target=client.send_device, args=(conn_c, x),
                         kwargs={"chunk_bytes": 32 << 10})
    t.start()
    y = server.recv_device(conn_s, (100_000,), torch.float32, device="cpu", timeout_ms=60000)
    t.join(timeout=60)
    assert y.device.type == "cpu" and torch.equal(y, x.cpu())


def test_reg_of_a_cuda_tensor_refused(dev, pair):
    server, client, _, conn_c = pair
    x = torch.zeros(1024, device=dev)
    with pytest.raises(ValueError, match="device memory"):
        server.reg(x)
    with pytest.raises(ValueError, match="device memory"):
        client.send(conn_c, x)


def _chan_pair(server_ep, client_ep):
    res = {}
    t = threading.Thread(target=lambda: res.setdefault("c", Channel.accept(server_ep)))
    t.start()
    c = Channel.connect(client_ep, "127.0.0.1", server_ep.port, n_paths=2)
    t.join(timeout=60)
    return res["c"], c


def _cuda_tree(dev):
    """Three 2 MiB weights, a bf16 bias and a step counter on the card:
    three slab groups at 256 KiB groups."""
    g = torch.Generator(device=dev).manual_seed(1)
    return {**{f"w{i}": torch.randn(512, 1024, device=dev, generator=g) for i in range(3)},
            "b": torch.randn(1024, device=dev, generator=g).to(torch.bfloat16),
            "step": torch.tensor([3], device=dev)}


def test_publish_from_cuda_fetch_bit_exact(dev):
    tree = _cuda_tree(dev)
    pub = WeightPublisher(group_bytes=256 << 10)
    pub.publish("m", tree)
    with Endpoint(n_engines=2) as pep, Endpoint(n_engines=2) as sep:
        srv, cli = _chan_pair(pep, sep)
        t = threading.Thread(target=lambda: pub.serve(srv))
        t.start()
        snap = wp.fetch(cli, "m")
        t.join(timeout=60)
    got = snap.tree()
    for k in tree:
        assert got[k].device.type == "cpu"
        assert _same_bits(got[k], tree[k]), k


def test_flipped_byte_in_a_staged_chunk_fails_the_group_crc(dev):
    """Planted fault: one byte of the staged host copy flipped after the
    CRCs were taken. The peer's fetch must refuse that group."""
    pub = WeightPublisher(group_bytes=256 << 10)
    pub.publish("m", _cuda_tree(dev))
    snap = pub.get("m")
    assert len(snap.manifest["groups"]) >= 3
    a, b = snap.group_range(1)
    snap.buf[(a + b) // 2] ^= 0x01
    with Endpoint(n_engines=2) as pep, Endpoint(n_engines=2) as sep:
        srv, cli = _chan_pair(pep, sep)

        def serve():
            try:
                pub.serve(srv, timeout_ms=30000)
            except Exception:
                pass  # the fetch gave up: later writes land nowhere

        t = threading.Thread(target=serve)
        t.start()
        with pytest.raises(wp.FetchError, match="group 1 CRC mismatch"):
            wp.fetch(cli, "m")
        cli.close()
        t.join(timeout=60)
