"""uccl_tpu_torch.p2p's endpoint, registration cache, store and NIXL-style
API over loopback, case for case as the JAX package's suites hold
uccl_tpu.p2p (tests/test_p2p.py, test_p2p_udp.py, test_mr_cache.py,
test_store.py's store, test_ray_api.py without its example runs), plus what
the port adds: its own build of the native runtime beside the JAX package's
in one process (each endpoint talks to the other's), CPU tensors as
buffers, the refusal of device tensors, and device staging in the JAX
package's chunked message format. Every wait on a transfer that must succeed
is capped at 30 s or more.
"""

import multiprocessing as mp
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from uccl_tpu_torch.p2p import Endpoint, XferEndpoint
from uccl_tpu_torch.p2p import endpoint as tep
from uccl_tpu_torch.p2p.mr_cache import ClosedIntervalTree
from uccl_tpu_torch.p2p.store import StoreClient, StoreServer


def _poll(cond, cap_s: float = 30.0, every_s: float = 0.02):
    """Poll ``cond()`` until it is truthy or ``cap_s`` passed; returns its
    last value."""
    deadline = time.monotonic() + cap_s
    while True:
        v = cond()
        if v or time.monotonic() > deadline:
            return v
        time.sleep(every_s)


@pytest.fixture
def pair():
    """Two endpoints connected over loopback in one process."""
    with Endpoint() as server, Endpoint() as client:
        conn_c = client.connect("127.0.0.1", server.port)
        conn_s = server.accept()
        yield server, client, conn_s, conn_c


class TestBuild:
    def test_runtime_builds_into_the_ports_directory(self):
        path = tep._build_if_needed()
        assert path == tep._SO_PATH
        assert os.path.dirname(path) == tep.NATIVE_BUILD_DIR
        assert os.path.join("build", "uccl_tpu_torch", "native") in path
        assert not path.startswith(os.path.join(tep._NATIVE_DIR, "build"))

    def test_imports_without_jax_or_ml_dtypes(self):
        """The p2p plane and the KV tiers import in a process where jax,
        ml_dtypes and the JAX package cannot be imported."""
        code = (
            "import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', 'uccl_tpu'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import uccl_tpu_torch.p2p, uccl_tpu_torch.serving.kv_tiers\n"
            "import uccl_tpu_torch.interop, uccl_tpu_torch.serving.adapters\n"
            "from uccl_tpu_torch.p2p import compress, lossless\n"
            "import torch\n"
            "b = compress.encode_fp8(torch.ones(256, dtype=torch.bfloat16))\n"
            "assert compress.decode_any(b).dtype == torch.bfloat16\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ml_dtypes', 'uccl_tpu')]\n"
            "print('ok')\n")
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        assert r.stdout.strip() == "ok"


class TestOneSided:
    def test_write(self, pair, rng):
        server, client, conn_s, conn_c = pair
        dst = np.zeros(1024, np.float32)
        mr = server.reg(dst)
        fifo = server.advertise(mr)
        src = rng.standard_normal(1024).astype(np.float32)
        client.write(conn_c, src, fifo)
        np.testing.assert_array_equal(dst, src)

    def test_read(self, pair, rng):
        server, client, conn_s, conn_c = pair
        src = rng.standard_normal(2048).astype(np.float64)
        mr = server.reg(src)
        fifo = server.advertise(mr)
        dst = np.zeros(2048, np.float64)
        client.read(conn_c, dst, fifo)
        np.testing.assert_array_equal(dst, src)

    def test_write_at_offset(self, pair, rng):
        server, client, conn_s, conn_c = pair
        dst = np.zeros(100, np.uint8)
        mr = server.reg(dst)
        fifo = server.advertise(mr, offset=10, length=50)
        src = np.arange(50, dtype=np.uint8)
        client.write(conn_c, src, fifo)
        np.testing.assert_array_equal(dst[10:60], src)
        assert dst[:10].sum() == 0 and dst[60:].sum() == 0

    def test_large_transfer(self, pair, rng):
        server, client, conn_s, conn_c = pair
        n = 16 << 20  # 16 MB
        dst = np.zeros(n, np.uint8)
        mr = server.reg(dst)
        src = rng.integers(0, 255, n).astype(np.uint8)
        client.write(conn_c, src, server.advertise(mr))
        np.testing.assert_array_equal(dst, src)

    def test_async_and_poll(self, pair, rng):
        server, client, conn_s, conn_c = pair
        dst = np.zeros(4096, np.float32)
        mr = server.reg(dst)
        src = rng.standard_normal(4096).astype(np.float32)
        xid = client.write_async(conn_c, src, server.advertise(mr))
        assert client.wait(xid)
        np.testing.assert_array_equal(dst, src)
        # completions are one-shot (engine.h contract): a consumed id is gone
        with pytest.raises(IOError):
            client.poll_async(xid)

    def test_writev(self, pair, rng):
        server, client, conn_s, conn_c = pair
        dsts = [np.zeros(256, np.float32) for _ in range(4)]
        fifos = [server.advertise(server.reg(d)) for d in dsts]
        srcs = [rng.standard_normal(256).astype(np.float32) for _ in range(4)]
        client.writev(conn_c, srcs, fifos)
        for d, s in zip(dsts, srcs):
            np.testing.assert_array_equal(d, s)


class TestTensors:
    """What the port adds: CPU tensors register and move in place (bf16
    as its bits), a CUDA tensor is refused by name."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16,
                                       torch.int64, torch.uint8])
    def test_cpu_tensor_write_and_read(self, pair, dtype):
        server, client, conn_s, conn_c = pair
        src = (torch.arange(3000) % 251).to(dtype)
        dst = torch.zeros(3000, dtype=dtype)
        fifo = server.advertise(server.reg(dst))
        client.write(conn_c, src, fifo)
        assert torch.equal(dst, src)
        back = torch.zeros_like(src)
        client.read(conn_c, back, fifo)
        assert torch.equal(back, src)

    def test_device_tensor_refused_by_name(self, pair):
        server, client, conn_s, conn_c = pair
        dev = torch.zeros(16, device="meta")
        with pytest.raises(ValueError, match="device memory"):
            server.reg(dev)
        with pytest.raises(ValueError, match="device memory"):
            client.send(conn_c, dev)
        fifo = server.advertise(server.reg(np.zeros(64, np.uint8)))
        with pytest.raises(ValueError, match="device memory"):
            client.write(conn_c, dev, fifo)

    def test_non_contiguous_tensor_refused(self, pair):
        server, _, _, _ = pair
        with pytest.raises(ValueError, match="contiguous"):
            server.reg(torch.zeros(8, 8).t())


class TestTwoSided:
    def test_send_recv_bytes(self, pair):
        server, client, conn_s, conn_c = pair
        client.send(conn_c, b"hello uccl")
        assert server.recv(conn_s) == b"hello uccl"

    def test_send_recv_ordering(self, pair):
        server, client, conn_s, conn_c = pair
        for i in range(20):
            client.send(conn_c, f"msg{i}".encode())
        for i in range(20):
            assert server.recv(conn_s) == f"msg{i}".encode()

    def test_recv_timeout(self, pair):
        server, client, conn_s, conn_c = pair
        with pytest.raises(TimeoutError):
            server.recv(conn_s, timeout_ms=100)


class TestSafety:
    def test_bad_token_rejected(self, pair, rng):
        """A forged FifoItem (wrong token) must not corrupt memory."""
        server, client, conn_s, conn_c = pair
        dst = np.zeros(64, np.uint8)
        mr = server.reg(dst)
        fifo = bytearray(server.advertise(mr))
        fifo[16] ^= 0xFF  # corrupt the token field
        src = np.ones(64, np.uint8)
        with pytest.raises(IOError):
            client.write(conn_c, src, bytes(fifo))
        assert dst.sum() == 0

    def test_out_of_range_write_rejected(self, pair):
        server, client, conn_s, conn_c = pair
        dst = np.zeros(64, np.uint8)
        fifo = server.advertise(server.reg(dst))
        src = np.ones(128, np.uint8)  # larger than advertised
        with pytest.raises(IOError):
            client.write(conn_c, src, fifo)
        assert dst.sum() == 0

    def test_dereg_then_write_fails(self, pair):
        server, client, conn_s, conn_c = pair
        dst = np.zeros(64, np.uint8)
        mr = server.reg(dst)
        fifo = server.advertise(mr)
        server.dereg(mr)
        with pytest.raises(IOError):
            client.write(conn_c, np.ones(64, np.uint8), fifo)

    def test_drop_rate_times_out(self, pair):
        """Fault injection: 100% frame drop -> transfer never completes."""
        server, client, conn_s, conn_c = pair
        dst = np.zeros(64, np.uint8)
        fifo = server.advertise(server.reg(dst))
        client.set_drop_rate(1.0)
        xid = client.write_async(conn_c, np.ones(64, np.uint8), fifo)
        assert not client.wait(xid, timeout_ms=300)
        client.set_drop_rate(0.0)

    def test_stats_counters(self, pair, rng):
        server, client, conn_s, conn_c = pair
        dst = np.zeros(1000, np.uint8)
        fifo = server.advertise(server.reg(dst))
        client.write(conn_c, rng.integers(0, 255, 1000).astype(np.uint8), fifo)
        assert client.stats["bytes_tx"] >= 1000
        assert server.stats["bytes_rx"] >= 1000


class TestLifecycle:
    def test_use_after_close_raises(self):
        ep = Endpoint()
        ep.close()
        with pytest.raises(ValueError):
            _ = ep.port
        ep.close()  # double close is a no-op

    def test_port_in_use_raises(self):
        with Endpoint() as ep:
            with pytest.raises(RuntimeError):
                Endpoint(ep.port)

    def test_large_message_recv_retries(self, pair):
        server, client, conn_s, conn_c = pair
        big = np.arange(2 << 20, dtype=np.uint8)  # 2 MB > default 1 MB buffer
        client.send(conn_c, big)
        got = server.recv(conn_s)  # transparently retries with exact size
        np.testing.assert_array_equal(np.frombuffer(got, np.uint8), big)

    def test_async_temporary_buffer_survives(self, pair, rng):
        """The engine must keep async sources alive until completion (the
        caller may pass a temporary)."""
        server, client, conn_s, conn_c = pair
        dst = np.zeros(1 << 20, np.float32)
        fifo = server.advertise(server.reg(dst))
        src = rng.standard_normal(1 << 20).astype(np.float32)
        xid = client.write_async(conn_c, torch.from_numpy(src) + 0.0, fifo)  # temporary!
        import gc

        gc.collect()
        assert client.wait(xid)
        np.testing.assert_array_equal(dst, src)

    def test_concurrent_bidirectional_reads(self, pair, rng):
        """Large reads in both directions at once must not deadlock the
        engines (read responses ride the tx proxy, not the io thread)."""
        server, client, conn_s, conn_c = pair
        n = 8 << 20
        a = rng.integers(0, 255, n).astype(np.uint8)
        b = rng.integers(0, 255, n).astype(np.uint8)
        fifo_a = server.advertise(server.reg(a))
        fifo_b = client.advertise(client.reg(b))
        dst_a = np.zeros(n, np.uint8)
        dst_b = np.zeros(n, np.uint8)
        xc = client.read_async(conn_c, dst_a, fifo_a)
        xs = server.read_async(conn_s, dst_b, fifo_b)
        assert client.wait(xc, timeout_ms=60000)
        assert server.wait(xs, timeout_ms=60000)
        np.testing.assert_array_equal(dst_a, a)
        np.testing.assert_array_equal(dst_b, b)


def _server_proc(port_q, result_q):
    server = Endpoint()
    port_q.put(server.port)
    conn = server.accept(timeout_ms=20000)
    dst = np.zeros(4096, np.float32)
    mr = server.reg(dst)
    server.send(conn, server.advertise(mr))  # fifo travels over the wire OOB
    # wait for the client's completion signal
    assert server.recv(conn, timeout_ms=20000) == b"done"
    result_q.put(dst.copy())
    server.close()


def test_multiprocess_write():
    """Two real processes, advertise handshake over the engine itself."""
    ctx = mp.get_context("spawn")
    port_q, result_q = ctx.Queue(), ctx.Queue()
    p = ctx.Process(target=_server_proc, args=(port_q, result_q))
    p.start()
    try:
        port = port_q.get(timeout=60)
        client = Endpoint()
        conn = client.connect("127.0.0.1", port)
        fifo = client.recv(conn, timeout_ms=30000)
        src = np.arange(4096, dtype=np.float32)
        client.write(conn, src, fifo)
        client.send(conn, b"done")
        got = result_q.get(timeout=30)
        np.testing.assert_array_equal(got, src)
        client.close()
    finally:
        p.join(timeout=30)
        if p.is_alive():
            p.terminate()


class TestNoHeadOfLine:
    """One misbehaving peer must not stall an engine's other connections."""

    def test_stalled_partial_frame_peer_does_not_block_rx(self, rng):
        with Endpoint(n_engines=1) as server, Endpoint() as client:
            rogue = socket.create_connection(("127.0.0.1", server.port))
            rogue.sendall(struct.pack("<IHH", 0x7C71, 1, 0)[:6])  # 6 of 48 bytes
            time.sleep(0.2)  # let the io thread observe the partial header
            conn_c = client.connect("127.0.0.1", server.port)
            assert server.accept() >= 0
            dst = np.zeros(1 << 16, np.uint8)
            fifo = server.advertise(server.reg(dst))
            src = rng.integers(0, 255, 1 << 16).astype(np.uint8)
            client.write(conn_c, src, fifo)  # raises on failure/timeout
            np.testing.assert_array_equal(dst, src)
            rogue.close()

    def test_backpressured_peer_does_not_block_tx(self, rng):
        with Endpoint(n_engines=1) as server, Endpoint() as client:
            rogue = socket.create_connection(("127.0.0.1", server.port))
            rogue_conn = server.accept()
            payload = bytes(256 << 10)
            for _ in range(64):  # ~16 MB queued, far beyond socket buffers
                server.send(rogue_conn, payload)
            time.sleep(0.1)
            conn_c = client.connect("127.0.0.1", server.port)
            conn_s = server.accept()
            dst = np.zeros(1 << 16, np.uint8)
            fifo = client.advertise(client.reg(dst))
            src = rng.integers(0, 255, 1 << 16).astype(np.uint8)
            server.write(conn_s, src, fifo)  # server tx must not be wedged
            np.testing.assert_array_equal(dst, src)
            rogue.close()


class TestVectorized:
    def test_writev_readv_roundtrip(self, pair, rng):
        server, client, conn_s, conn_c = pair
        dsts = [np.zeros(4096, np.uint8) for _ in range(6)]
        fifos = [server.advertise(server.reg(d)) for d in dsts]
        srcs = [rng.integers(0, 255, 4096).astype(np.uint8) for _ in range(6)]
        client.writev(conn_c, srcs, fifos)
        for d, s in zip(dsts, srcs):
            np.testing.assert_array_equal(d, s)
        back = [np.zeros(4096, np.uint8) for _ in range(6)]
        client.readv(conn_c, back, fifos)
        for b, s in zip(back, srcs):
            np.testing.assert_array_equal(b, s)

    def test_writev_async_out_of_order_completion(self, pair, rng):
        server, client, conn_s, conn_c = pair
        sizes = [1 << 20, 1024, 256 << 10, 64]
        dsts = [np.zeros(n, np.uint8) for n in sizes]
        fifos = [server.advertise(server.reg(d)) for d in dsts]
        srcs = [rng.integers(0, 255, n).astype(np.uint8) for n in sizes]
        xids = client.writev_async(conn_c, srcs, fifos)
        assert len(set(xids)) == len(sizes)
        for x in xids:
            assert client.wait(x)
        for d, s in zip(dsts, srcs):
            np.testing.assert_array_equal(d, s)

    def test_writev_element_over_window_fails_cleanly(self, pair, rng):
        server, client, conn_s, conn_c = pair
        dst = np.zeros(128, np.uint8)
        fifo = server.advertise(server.reg(dst))
        big = rng.integers(0, 255, 4096).astype(np.uint8)
        ok = rng.integers(0, 255, 128).astype(np.uint8)
        dst2 = np.zeros(128, np.uint8)
        fifo2 = server.advertise(server.reg(dst2))
        xids = client.writev_async(conn_c, [big, ok], [fifo, fifo2])
        assert not client.wait(xids[0])   # over-window element fails
        assert client.wait(xids[1])       # sibling still lands
        np.testing.assert_array_equal(dst2, ok)


class TestDeviceStaging:
    """send_device/recv_device on host tensors (the CUDA arms run on the
    card: tests/test_torch_cuda_p2p.py), and the message format against the
    JAX package's send_jax/recv_jax in both directions: chunked and
    monolithic senders interoperate."""

    def _roundtrip(self, pair, x, shape, dtype, **kw):
        server, client, conn_s, conn_c = pair
        t = threading.Thread(target=client.send_device, args=(conn_c, x), kwargs=kw)
        t.start()
        y = server.recv_device(conn_s, shape, dtype, device="cpu")
        t.join(timeout=60)
        assert not t.is_alive()
        return y

    def test_host_tensor_roundtrip(self, pair):
        x = torch.arange(1 << 16, dtype=torch.float32).reshape(256, 256)
        y = self._roundtrip(pair, x, (256, 256), torch.float32, chunk_bytes=64 << 10)
        assert torch.equal(y, x)

    def test_bf16_payload(self, pair):
        x = torch.linspace(-4.0, 4.0, 8192, dtype=torch.bfloat16)
        y = self._roundtrip(pair, x, (8192,), torch.bfloat16, chunk_bytes=4096)
        assert torch.equal(y.view(torch.int16), x.view(torch.int16))

    def test_numpy_input_still_works(self, pair):
        x = np.random.default_rng(0).standard_normal(512).astype(np.float32)
        y = self._roundtrip(pair, x, (512,), torch.float32, chunk_bytes=512)
        np.testing.assert_array_equal(y.numpy(), x)

    def test_misaligned_message_refused(self, pair):
        server, client, conn_s, conn_c = pair
        client.send(conn_c, np.zeros(6, np.uint8))
        with pytest.raises(IOError, match="misaligned"):
            server.recv_device(conn_s, (4,), torch.float32, device="cpu")

    def test_default_device_is_cuda(self, pair):
        server, _, conn_s, _ = pair
        if torch.cuda.is_available():
            pytest.skip("the card is present: the default resolves")
        with pytest.raises(RuntimeError, match="cuda"):
            server.recv_device(conn_s, (4,), torch.float32)

    @pytest.mark.parametrize("chunk_bytes", [1024, 64 << 10, 1 << 30])
    def test_jax_chunked_sender_port_receiver(self, chunk_bytes):
        """uccl_tpu's send_jax (chunked or monolithic) into the port's
        recv_device, each package on its own build of the runtime."""
        import jax.numpy as jnp

        from uccl_tpu.p2p import Endpoint as JaxEndpoint

        with Endpoint() as server, JaxEndpoint() as client:
            conn_c = client.connect("127.0.0.1", server.port)
            conn_s = server.accept()
            x = jnp.arange(1000 * 33, dtype=jnp.int32).reshape(1000, 33)
            t = threading.Thread(target=client.send_jax, args=(conn_c, x),
                                 kwargs={"chunk_bytes": chunk_bytes})
            t.start()
            y = server.recv_device(conn_s, (1000, 33), torch.int32, device="cpu")
            t.join(timeout=60)
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))

    def test_port_sender_jax_receiver_bf16(self):
        import jax.numpy as jnp

        from uccl_tpu.p2p import Endpoint as JaxEndpoint

        with JaxEndpoint() as server, Endpoint() as client:
            conn_c = client.connect("127.0.0.1", server.port)
            conn_s = server.accept()
            x = torch.linspace(-3.0, 3.0, 4096, dtype=torch.bfloat16)
            t = threading.Thread(target=client.send_device, args=(conn_c, x))
            t.start()
            y = server.recv_jax(conn_s, (4096,), jnp.bfloat16)
            t.join(timeout=60)
            np.testing.assert_array_equal(np.asarray(y).view(np.int16),
                                          x.view(torch.int16).numpy())


class TestEngineStats:
    def test_stats_shape_and_latency_percentiles(self, pair, rng):
        server, client, conn_s, conn_c = pair
        dst = np.zeros(1 << 16, np.uint8)
        fifo = server.advertise(server.reg(dst))
        src = rng.integers(0, 255, 1 << 16).astype(np.uint8)
        for _ in range(20):
            client.write(conn_c, src, fifo)
        s = client.stats
        assert s["bytes_tx"] > 20 * (1 << 16)
        engines = s["engines"]
        assert len(engines) >= 1
        assert sum(e["tx_frames"] for e in engines) >= 20
        for e in engines:
            if e["tx_frames"] > 0:
                assert e["tx_p99_us"] >= e["tx_p50_us"] > 0
        r = server.stats
        assert sum(e["rx_frames"] for e in r["engines"]) >= 20
        for e in r["engines"]:
            if e["rx_frames"]:
                assert e["rx_p99_us"] >= e["rx_p50_us"] > 0

    def test_stats_thread_ticks(self, monkeypatch):
        monkeypatch.setenv("UCCL_TPU_ENGINE_STATS_MS", "40")
        with Endpoint() as ep:
            assert _poll(lambda: ep.stats["stats_ticks"] >= 2)


class TestNotifs:
    def test_notif_roundtrip_after_write(self, pair, rng):
        server, client, conn_s, conn_c = pair
        assert server.get_notifs() == []  # non-blocking empty drain
        dst = np.zeros(4096, np.uint8)
        fifo = server.advertise(server.reg(dst))
        src = rng.integers(0, 255, 4096).astype(np.uint8)
        client.write(conn_c, src, fifo)
        client.send_notif(conn_c, b"xfer:kv:done")
        assert _poll(server.get_notifs) == [(conn_s, b"xfer:kv:done")]
        np.testing.assert_array_equal(dst, src)

    def test_notifs_do_not_consume_recv_queue(self, pair):
        server, client, conn_s, conn_c = pair
        client.send_notif(conn_c, b"n1")
        client.send(conn_c, b"regular")
        assert server.recv(conn_s) == b"regular"
        assert _poll(server.get_notifs) == [(conn_s, b"n1")]

    def test_pending_notifs_visible_in_stats(self, pair):
        server, client, conn_s, conn_c = pair
        client.send_notif(conn_c, b"queued")
        assert _poll(lambda: server.stats.get("notifs_pending", 0) == 1)
        assert server.get_notifs() == [(conn_s, b"queued")]
        assert server.stats["notifs_pending"] == 0

    def test_notif_ordering_and_large(self, pair):
        server, client, conn_s, conn_c = pair
        big = b"B" * 10000  # larger than the 4096 drain buffer
        client.send_notif(conn_c, b"first")
        client.send_notif(conn_c, big)
        got = []

        def two():
            got.extend(server.get_notifs())
            return len(got) == 2

        assert _poll(two)
        assert got == [(conn_s, b"first"), (conn_s, big)]


class TestCrossPackage:
    """Both packages' builds of the runtime in one process (ctypes
    ``RTLD_LOCAL``): a port endpoint and a JAX endpoint speak one wire."""

    def test_two_libraries_loaded(self):
        from uccl_tpu.p2p import endpoint as jep

        jep._load()
        tep._load()
        assert jep._lib is not tep._lib
        assert os.path.realpath(jep._lib._name) != os.path.realpath(tep._lib._name)

    @pytest.mark.parametrize("port_is_server", [True, False])
    def test_one_sided_and_two_sided_across(self, port_is_server, rng):
        from uccl_tpu.p2p import Endpoint as JaxEndpoint

        S, C = (Endpoint, JaxEndpoint) if port_is_server else (JaxEndpoint, Endpoint)
        with S() as server, C() as client:
            conn_c = client.connect("127.0.0.1", server.port)
            conn_s = server.accept()
            dst = np.zeros(1 << 20, np.uint8)
            fifo = server.advertise(server.reg(dst))
            src = rng.integers(0, 255, 1 << 20).astype(np.uint8)
            client.write(conn_c, src, fifo)
            np.testing.assert_array_equal(dst, src)
            back = np.zeros_like(src)
            client.read(conn_c, back, fifo)
            np.testing.assert_array_equal(back, src)
            client.send(conn_c, b"ping")
            assert server.recv(conn_s) == b"ping"


# -- the UDP wire (tests/test_p2p_udp.py) -------------------------------------


@pytest.fixture()
def udp_pair(monkeypatch):
    monkeypatch.setenv("UCCL_TPU_WIRE", "udp")
    a = b = None
    try:
        a = Endpoint(port=0, n_engines=1)
        b = Endpoint(port=0, n_engines=1)
        cid_ab = a.connect("127.0.0.1", b.port)
        assert cid_ab >= 0, "UDP handshake failed"
        cid_ba = b.accept(timeout_ms=30000)
        assert cid_ba >= 0
        yield a, b, cid_ab, cid_ba
    finally:
        if a is not None:
            a.close()
        if b is not None:
            b.close()


class TestUdpBasics:
    def test_handshake_active(self, udp_pair):
        a, b, cid_ab, cid_ba = udp_pair
        assert a.conn_stats(cid_ab)["udp_active"]
        assert b.conn_stats(cid_ba)["udp_active"]

    def test_send_recv_roundtrip(self, udp_pair):
        a, b, cid_ab, cid_ba = udp_pair
        msg = np.arange(300_000, dtype=np.uint8)  # spans many packets
        a.send(cid_ab, msg)
        out = np.zeros_like(msg)
        n = b.recv_into(cid_ba, out, timeout_ms=30000)
        assert n == msg.nbytes
        np.testing.assert_array_equal(out, msg)

    def test_write_read_windows(self, udp_pair):
        a, b, cid_ab, cid_ba = udp_pair
        dst = np.zeros(1 << 18, np.uint8)
        mr = b.reg(dst)
        item = b.advertise(mr, 0, dst.nbytes)
        src = np.random.default_rng(1).integers(0, 256, 1 << 18).astype(np.uint8)
        assert a.wait(a.write_async(cid_ab, src, item), timeout_ms=30000)
        np.testing.assert_array_equal(dst, src)
        got = np.zeros(1 << 18, np.uint8)
        item2 = b.advertise(mr, 0, dst.nbytes)
        assert a.wait(a.read_async(cid_ab, got, item2), timeout_ms=30000)
        np.testing.assert_array_equal(got, src)

    def test_rtt_sampled(self, udp_pair):
        a, b, cid_ab, cid_ba = udp_pair
        dst = np.zeros(4096, np.uint8)
        mr = b.reg(dst)
        src = np.ones(4096, np.uint8)
        for _ in range(3):
            item = b.advertise(mr, 0, dst.nbytes)
            assert a.wait(a.write_async(cid_ab, src, item), timeout_ms=30000)
        st = a.conn_stats(cid_ab)
        assert st["rtt_us"] > 0.0
        assert st["pkts_tx"] >= 3 and st["acks_rx"] >= 1


class TestUdpLoss:
    @pytest.mark.parametrize("loss", [0.05, 0.2])
    def test_bit_exact_under_loss(self, udp_pair, loss):
        a, b, cid_ab, cid_ba = udp_pair
        dst = np.zeros(1 << 20, np.uint8)
        mr = b.reg(dst)
        item = b.advertise(mr, 0, dst.nbytes)
        src = np.random.default_rng(2).integers(0, 256, 1 << 20).astype(np.uint8)
        a.set_drop_rate(loss)
        try:
            xid = a.write_async(cid_ab, src, item)
            assert a.wait(xid, timeout_ms=60000), f"lost at {loss:.0%}"
        finally:
            a.set_drop_rate(0.0)
        np.testing.assert_array_equal(dst, src)
        assert a.conn_stats(cid_ab)["pkts_rtx"] > 0, "recovery must be retransmission-driven"

    def test_flush_means_acked(self, udp_pair):
        """Under 10% loss the transfer completes and lands bit-exact; once
        it has, a flush finds every byte acked. (The JAX case flushes
        while the loss is still on, which ROADMAP lists as unsteady.)"""
        a, b, cid_ab, cid_ba = udp_pair
        dst = np.zeros(1 << 19, np.uint8)
        mr = b.reg(dst)
        item = b.advertise(mr, 0, dst.nbytes)
        src = np.full(1 << 19, 7, np.uint8)
        a.set_drop_rate(0.1)
        try:
            xid = a.write_async(cid_ab, src, item)
            assert a.wait(xid, timeout_ms=60000)
        finally:
            a.set_drop_rate(0.0)
        assert a.flush(cid_ab, timeout_ms=60000)
        np.testing.assert_array_equal(dst, src)
        assert _poll(lambda: a.conn_stats(cid_ab)["bytes_unacked"] == 0)


class TestUdpCc:
    def test_cc_controller_governs_rate(self, udp_pair):
        """Of the wire, what it guarantees: the rate the controller sets
        is the one conn_stats reads, and the transfers complete. The
        controller's decisions themselves are held on a fixed RTT/loss
        sequence against the JAX TimelyCC (tests/test_torch_p2p_cc.py)."""
        from uccl_tpu_torch.p2p.cc import CcController, TimelyCC

        a, b, cid_ab, cid_ba = udp_pair
        dst = np.zeros(1 << 18, np.uint8)
        mr = b.reg(dst)
        src = np.ones(1 << 18, np.uint8)
        cc = CcController(a, cid_ab, TimelyCC(rate=50e6))
        assert cc.tick() is None  # no RTT signal yet
        item = b.advertise(mr, 0, dst.nbytes)
        assert a.wait(a.write_async(cid_ab, src, item), timeout_ms=60000)
        r1 = cc.tick()
        assert r1 is not None and r1 >= cc.min_rate
        assert a.conn_stats(cid_ab)["rate_bps"] == int(r1)
        a.set_drop_rate(0.3)
        try:
            item = b.advertise(mr, 0, dst.nbytes)
            assert a.wait(a.write_async(cid_ab, src, item), timeout_ms=60000)
        finally:
            a.set_drop_rate(0.0)
        r2 = cc.tick()
        assert r2 is not None and r2 >= cc.min_rate
        assert a.conn_stats(cid_ab)["rate_bps"] == int(r2)
        np.testing.assert_array_equal(dst, src)

    def test_per_conn_rate_paces_transfer(self, udp_pair):
        """A tight per-conn rate slows a transfer (the pacer is in the
        datapath): 512 KiB at 1 MiB/s takes at least 0.2 s however slow
        the machine; the transfer itself waits up to 30 s."""
        a, b, cid_ab, cid_ba = udp_pair
        dst = np.zeros(1 << 19, np.uint8)
        mr = b.reg(dst)
        src = np.ones(1 << 19, np.uint8)
        item = b.advertise(mr, 0, dst.nbytes)
        a.set_conn_rate(cid_ab, 1 << 20)
        t0 = time.perf_counter()
        try:
            assert a.wait(a.write_async(cid_ab, src, item), timeout_ms=30000)
        finally:
            a.set_conn_rate(cid_ab, 0)
        dt = time.perf_counter() - t0
        assert dt > 0.2, f"paced transfer finished in {dt:.3f}s — pacer inert?"
        np.testing.assert_array_equal(dst, src)


class TestUdpTeardown:
    def test_remove_conn_fails_cleanly(self, udp_pair):
        a, b, cid_ab, cid_ba = udp_pair
        assert b.remove_conn(cid_ba)
        # sender's conn eventually observes death via the TCP liveness fd
        assert _poll(lambda: not a.conn_alive(cid_ab), every_s=0.1)


# -- the registration cache (tests/test_mr_cache.py) --------------------------


class TestIntervalTree:
    def test_containing_queries(self):
        t = ClosedIntervalTree()
        for s, e, d in [(1, 10, "large"), (2, 5, "sub"), (3, 4, "core"),
                        (15, 25, "region"), (20, 30, "overlap")]:
            t.add(s, e, d)
        got = {d for _, _, d in t.query_containing(3, 4)}
        assert got == {"large", "sub", "core"}
        assert {d for _, _, d in t.query_containing(16, 18)} == {"region"}
        assert {d for _, _, d in t.query_containing(22, 24)} == {
            "region", "overlap"
        }
        assert t.query_containing(12, 14) == []

    def test_remove_and_iterate(self):
        t = ClosedIntervalTree()
        t.add(1, 10, "a")
        t.add(2, 5, "b")
        assert len(t) == 2
        assert t.remove(2, 5, "b")
        assert not t.remove(2, 5, "b")  # already gone
        assert [(s, e, d) for s, e, d in t] == [(1, 10, "a")]

    def test_exact_and_overlapping(self):
        t = ClosedIntervalTree()
        t.add(10, 20, "x")
        t.add(10, 30, "y")
        assert [r[2] for r in t.query_exact(10, 20)] == ["x"]
        assert {r[2] for r in t.query_overlapping(25, 40)} == {"y"}
        assert t.query_overlapping(40, 50) == []

    def test_bad_interval(self):
        with pytest.raises(ValueError):
            ClosedIntervalTree().add(5, 3, "bad")


def _subregion_server(q):
    sxp = XferEndpoint(n_engines=1)
    buf = np.zeros(4096, np.float32)
    base = sxp.register_memory([buf])[0]
    sub = sxp.register_memory([buf[1024:2048]])[0]
    assert sub["mr_id"] == base["mr_id"]
    q.put((sxp.get_metadata(), sxp.get_serialized_descs([sub])))
    assert sxp.accept() >= 0
    _poll(lambda: any(p == b"DONE" for _, p in sxp.get_notifs()), every_s=0.05)
    # only [1024:2048] may have been written
    q.put((float(buf[:1024].sum()), float(buf[1024:2048].sum()), float(buf[2048:].sum())))
    sxp.close()


class TestMrCache:
    def test_same_buffer_reuses_base(self):
        xp = XferEndpoint(n_engines=1)
        try:
            arr = np.ones(4096, np.float32)
            d1 = xp.register_memory([arr])[0]
            d2 = xp.register_memory([arr])[0]
            # fresh API handle, shared key material (reference contract)
            assert d1["handle"] != d2["handle"]
            assert d1["mr_id"] == d2["mr_id"]
            # releasing one handle keeps the cached base alive
            xp.deregister_memory([d1])
            d3 = xp.register_memory([arr])[0]
            assert d3["mr_id"] == d2["mr_id"]
            xp.deregister_memory([d2, d3])
            assert xp.mr_cache.stats()["bases"] == 0
        finally:
            xp.close()

    def test_subregion_reuses_base(self):
        xp = XferEndpoint(n_engines=1)
        try:
            arr = np.ones(4096, np.float32)
            sub = arr[256:1280]  # contiguous view inside arr
            base = xp.register_memory([arr])[0]
            subd = xp.register_memory([sub])[0]
            assert subd["mr_id"] == base["mr_id"]
            assert subd["handle"] != base["handle"]
            xp.deregister_memory([base])
            sub2 = xp.register_memory([sub])[0]
            assert sub2["mr_id"] == subd["mr_id"]  # alive while referenced
            xp.deregister_memory([subd, sub2])
            assert xp.mr_cache.stats()["bases"] == 0
        finally:
            xp.close()

    def test_partial_overlap_and_disjoint_miss(self):
        xp = XferEndpoint(n_engines=1)
        try:
            arr = np.ones(4096, np.float32)
            a = xp.register_memory([arr[:2048]])[0]
            b = xp.register_memory([arr[1024:3072]])[0]  # partial overlap
            c = xp.register_memory([arr[2048:]])[0]  # disjoint from a
            assert len({a["mr_id"], b["mr_id"], c["mr_id"]}) == 3
            st = xp.mr_cache.stats()
            assert st["misses"] == 3 and st["hits"] == 0
            xp.deregister_memory([a, b, c])
        finally:
            xp.close()

    def test_tensor_subregion_reuses_base(self):
        """What the port adds: CPU tensor views register through the same
        containment rule."""
        xp = XferEndpoint(n_engines=1)
        try:
            t = torch.zeros(8192, dtype=torch.bfloat16)
            base = xp.register_memory([t])[0]
            sub = xp.register_memory([t[1024:2048]])[0]
            assert sub["mr_id"] == base["mr_id"] and sub["size"] == 2048
            with pytest.raises(ValueError, match="device memory"):
                xp.register_memory([torch.zeros(4, device="meta")])
            xp.deregister_memory([base, sub])
        finally:
            xp.close()

    def test_cached_subregion_transfer_lands_correctly(self):
        """A window advertised through a cache hit must target the
        subregion's bytes, not the base's start."""
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        proc = ctx.Process(target=_subregion_server, args=(q,))
        proc.start()
        try:
            md, blob = q.get(timeout=60)
            xp = XferEndpoint(n_engines=1)
            ok, conn = xp.add_remote_endpoint(md)
            assert ok
            remote = XferEndpoint.deserialize_descs(blob)
            src = np.ones(1024, np.float32)
            assert xp.wait(xp.transfer(conn, "WRITE", [src], remote))
            xp.send_notif(conn, b"DONE")
            lo, mid, hi = q.get(timeout=60)
            assert (lo, mid, hi) == (0.0, 1024.0, 0.0)
            xp.close()
        finally:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.terminate()

    def test_deregister_unknown_handle(self):
        xp = XferEndpoint(n_engines=1)
        try:
            with pytest.raises(KeyError):
                xp.deregister_memory([{"handle": 999}])
        finally:
            xp.close()

    def test_deregister_drains_past_bad_handle(self):
        xp = XferEndpoint(n_engines=1)
        try:
            arr = np.ones(1024, np.float32)
            d1 = xp.register_memory([arr])[0]
            d2 = xp.register_memory([arr])[0]
            with pytest.raises(KeyError):
                xp.deregister_memory([d1, {"handle": 999}, d2])
            assert xp.mr_cache.stats()["handles"] == 0
            assert xp.mr_cache.stats()["bases"] == 0
        finally:
            xp.close()

    def test_failed_batch_unwinds(self):
        xp = XferEndpoint(n_engines=1)
        try:
            good = np.ones(1024, np.float32)
            with pytest.raises(TypeError):
                xp.register_memory([good, [1, 2, 3]])
            with pytest.raises(ValueError, match="zero-size"):
                xp.register_memory([good, np.zeros(0, np.float32)])
            assert xp.mr_cache.stats()["handles"] == 0
            assert xp.mr_cache.stats()["bases"] == 0
        finally:
            xp.close()

    def test_dereg_while_cached_hit_active_keeps_windows_valid(self):
        xp = XferEndpoint(n_engines=1)
        try:
            arr = np.ones(2048, np.float32)
            d1 = xp.register_memory([arr])[0]
            d2 = xp.register_memory([arr[:1024]])[0]
            st = xp.mr_cache.stats()
            assert st == {"bases": 1, "handles": 2, "hits": 1, "misses": 1}
            xp.deregister_memory([d1, d2])
        finally:
            xp.close()


# -- the rendezvous store (tests/test_store.py::TestStore) ---------------------


@pytest.fixture
def store():
    server = StoreServer()
    client = StoreClient("127.0.0.1", server.port)
    yield server, client
    client.close()
    server.close()


class TestStore:
    def test_set_get(self, store):
        _, client = store
        client.set("k1", b"v1")
        assert client.get("k1") == b"v1"
        assert client.get("missing") is None

    def test_wait_blocks_until_set(self, store):
        server, client = store
        other = StoreClient("127.0.0.1", server.port)

        def setter():
            time.sleep(0.2)
            other.set("late", b"here")

        t = threading.Thread(target=setter)
        t.start()
        assert client.wait("late", timeout_s=30) == b"here"
        t.join()
        other.close()

    def test_wait_timeout(self, store):
        _, client = store
        with pytest.raises(TimeoutError):
            client.wait("never", timeout_s=0.3)

    def test_many_clients(self, store):
        server, _ = store
        clients = [StoreClient("127.0.0.1", server.port) for _ in range(4)]
        for i, c in enumerate(clients):
            c.set(f"rank/{i}", str(i).encode())
        for c in clients:
            for i in range(4):
                assert c.get(f"rank/{i}") == str(i).encode()
        [c.close() for c in clients]

    def test_binary_values(self, store):
        _, client = store
        blob = bytes(range(256)) * 100
        client.set("bin", blob)
        assert client.get("bin") == blob

    def test_jax_client_on_port_server(self, store):
        """One rendezvous for both packages: the JAX StoreClient against
        the port's StoreServer."""
        from uccl_tpu.p2p.store import StoreClient as JaxStoreClient

        server, client = store
        other = JaxStoreClient("127.0.0.1", server.port)
        try:
            other.set("from-jax", b"\x00\x01")
            assert client.get("from-jax") == b"\x00\x01"
            client.set("from-port", b"v")
            assert other.wait("from-port", timeout_s=30) == b"v"
        finally:
            other.close()


# -- the NIXL-style API (tests/test_ray_api.py) --------------------------------


class TestDescriptors:
    def test_register_memory_fields(self):
        xp = XferEndpoint(n_engines=1)
        try:
            arrs = [np.ones(1024, np.float32), np.zeros(512, np.float32)]
            descs = xp.register_memory(arrs)
            assert len(descs) == 2
            for arr, d in zip(arrs, descs):
                assert d["addr"] == arr.ctypes.data
                assert d["size"] == arr.nbytes
                assert d["mr_id"] > 0
                assert len(bytes.fromhex(d["fifo"])) == 64
        finally:
            xp.close()

    def test_serialize_roundtrip(self):
        xp = XferEndpoint(n_engines=1)
        try:
            arrs = [np.ones(1024, np.float32), np.zeros(512, np.float16),
                    np.ones(256, np.int32)]
            descs = xp.register_memory(arrs)
            back = XferEndpoint.deserialize_descs(xp.get_serialized_descs(descs))
            assert back == descs
        finally:
            xp.close()

    def test_non_numpy_rejected(self):
        xp = XferEndpoint(n_engines=1)
        try:
            with pytest.raises(TypeError, match="numpy"):
                xp.register_memory([[1, 2, 3]])
        finally:
            xp.close()

    def test_transfer_validation(self):
        xp = XferEndpoint(n_engines=1)
        try:
            with pytest.raises(ValueError, match="WRITE or READ"):
                xp.transfer(1, "PUT", [], [])
            with pytest.raises(ValueError, match="local arrays"):
                xp.transfer(1, "WRITE", [np.ones(4, np.float32)], [])
        finally:
            xp.close()


def _ray_server(q):
    xp = XferEndpoint(n_engines=1)
    dst = [np.zeros(4096, np.float32), np.zeros(100, np.float32)]
    descs = xp.register_memory(dst)
    q.put((xp.get_metadata(), xp.get_serialized_descs(descs)))
    assert xp.accept() >= 0
    _poll(lambda: any(p == b"DONE" for _, p in xp.get_notifs()), every_s=0.05)
    q.put([float(d.sum()) for d in dst])
    _poll(lambda: any(p == b"READ_DONE" for _, p in xp.get_notifs()), every_s=0.05)
    xp.close()


class TestTwoProcessTransfer:
    def test_write_then_read(self):
        """Metadata + descs out-of-band, WRITE local->remote, verify, then
        READ the same windows back and verify bit-exactness (the local side
        a pair of CPU tensors)."""
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        proc = ctx.Process(target=_ray_server, args=(q,))
        proc.start()
        try:
            metadata, blob = q.get(timeout=60)
            xp = XferEndpoint(n_engines=1)
            ok, conn = xp.add_remote_endpoint(metadata)
            assert ok and conn >= 0
            remote = XferEndpoint.deserialize_descs(blob)
            g = torch.Generator().manual_seed(5)
            src = [torch.randn(4096, generator=g), torch.randn(100, generator=g)]
            assert xp.wait(xp.transfer(conn, "WRITE", src, remote))
            xp.send_notif(conn, b"DONE")
            sums = q.get(timeout=60)
            np.testing.assert_allclose(sums, [float(s.sum()) for s in src], rtol=1e-5)
            back = [torch.zeros(4096), torch.zeros(100)]
            assert xp.wait(xp.transfer(conn, "READ", back, remote))
            for b, s in zip(back, src):
                assert torch.equal(b, s)
            xp.send_notif(conn, b"READ_DONE")
            xp.close()
        finally:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.terminate()
        assert proc.exitcode == 0
