"""uccl_tpu_torch.parallel.{distributed,health} against the JAX package's:
``tests/test_store.py::TestExchange`` and
``tests/test_cc_health.py::TestHeartbeat``, case for case, plus the
session bootstrap (``initialize``) with and without ``torch.distributed``
and one exchange between a port session and a JAX session on one store.

Exact: the exchanged payloads are compared byte for byte. The heartbeat
cases wait for the monitor's verdict with a deadline; no case sleeps a
fixed time or asserts on the wall clock.
"""

import multiprocessing as mp
import socket
import threading
import time

import pytest
import torch

from uccl_tpu.parallel import distributed as jdist
from uccl_tpu.p2p.store import StoreClient as JStoreClient
from uccl_tpu_torch.p2p.store import StoreClient, StoreServer
from uccl_tpu_torch.parallel import distributed as tdist
from uccl_tpu_torch.parallel.distributed import Session, exchange, exchange_json
from uccl_tpu_torch.parallel.health import HeartbeatMonitor

from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture
def store():
    server = StoreServer()
    client = StoreClient("127.0.0.1", server.port)
    yield server, client
    client.close()
    server.close()


def _until(cond, timeout_s=20.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gloo_rank_main(rank, port, q):
    import os

    import torch
    import torch.distributed as td

    coord = f"127.0.0.1:{port}"
    if rank == 0:
        sess = tdist.initialize(coord, 0, 2)
    else:
        os.environ.update(UCCL_TPU_COORD=coord, UCCL_TPU_RANK="1",
                          UCCL_TPU_WORLD="2")
        os.environ.pop("UCCL_TPU_INIT_JAX", None)
        sess = tdist.initialize_from_env()
    t = torch.full((3,), float(rank + 1))
    td.all_reduce(t)
    out = {"backend": td.get_backend(), "world": td.get_world_size(),
           "rank": td.get_rank(), "torch_pg": sess._torch_pg,
           "store_port": sess._server.port if sess._server else None,
           "sum": t.tolist(), "exchange": exchange(sess, "x", bytes([rank])),
           "again": tdist._init_torch(coord, rank, 2)}
    td.barrier()  # rank 0's store outlives rank 1's exchange
    sess.close()
    out["closed"] = not td.is_initialized()
    q.put((rank, out))


class TestExchange:
    def test_exchange_two_ranks(self, store):
        server, c0 = store
        c1 = StoreClient("127.0.0.1", server.port)
        s0 = Session(rank=0, world=2, store=c0)
        s1 = Session(rank=1, world=2, store=c1)
        results = {}

        def run(sess, payload):
            results[sess.rank] = exchange(sess, "meta", payload, timeout_s=5)

        t0 = threading.Thread(target=run, args=(s0, b"zero"))
        t1 = threading.Thread(target=run, args=(s1, b"one"))
        t0.start(), t1.start()
        t0.join(), t1.join()
        assert results[0] == [b"zero", b"one"]
        assert results[1] == [b"zero", b"one"]
        c1.close()

    def test_exchange_json(self, store):
        server, c0 = store
        s0 = Session(rank=0, world=1, store=c0)
        out = exchange_json(s0, "cfg", {"port": 1234})
        assert out == [{"port": 1234}]

    def test_port_and_jax_sessions_exchange_on_one_store(self, store):
        """A port rank and a JAX rank see one exchange, byte for byte."""
        server, c0 = store
        c1 = JStoreClient("127.0.0.1", server.port)
        s0 = Session(rank=0, world=2, store=c0)
        s1 = jdist.Session(rank=1, world=2, store=c1)
        results = {}

        def run(mod, sess, obj):
            results[sess.rank] = mod.exchange_json(sess, "mixed", obj, timeout_s=10)

        ts = [threading.Thread(target=run, args=(tdist, s0, {"r": 0, "ip": "a"})),
              threading.Thread(target=run, args=(jdist, s1, {"r": 1, "ip": "b"}))]
        [t.start() for t in ts]
        [t.join() for t in ts]
        assert results[0] == results[1] == [{"r": 0, "ip": "a"}, {"r": 1, "ip": "b"}]
        c1.close()


class TestInitialize:
    def test_store_port_is_coordinator_port_plus_one(self):
        port = _free_port()
        sess = tdist.initialize(f"127.0.0.1:{port}", 0, 1)
        try:
            assert sess._server.port == port + 1 and not sess._torch_pg
            assert exchange(sess, "k", b"v") == [b"v"]
        finally:
            sess.close()

    def test_two_ranks_bring_up_torch_distributed_on_gloo(self):
        """Two processes bring up one gloo group at the coordinator and the
        OOB store at its port + 1: rank 0 through ``initialize``, rank 1
        through ``initialize_from_env`` with the launcher's variables and
        the bring-up left on. A gloo all-reduce and a store exchange both
        span the two ranks; exact."""
        port = _free_port()
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        procs = [ctx.Process(target=_gloo_rank_main, args=(r, port, q))
                 for r in range(2)]
        [p.start() for p in procs]
        try:
            results = dict(q.get(timeout=120) for _ in procs)
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.terminate()
        assert [p.exitcode for p in procs] == [0, 0]
        for rank in range(2):
            r = results[rank]
            assert (r["backend"], r["world"], r["rank"]) == ("gloo", 2, rank)
            assert r["torch_pg"] and r["store_port"] == (port + 1 if rank == 0 else None)
            assert r["sum"] == [3.0, 3.0, 3.0]  # 1 + 2
            assert r["exchange"] == [b"\x00", b"\x01"]
            assert r["again"] is False  # a group already up is left alone
            assert r["closed"] is True  # close() took the group down

    def test_initialize_from_env(self, monkeypatch):
        port = _free_port()
        monkeypatch.setenv("UCCL_TPU_COORD", f"127.0.0.1:{port}")
        monkeypatch.setenv("UCCL_TPU_RANK", "0")
        monkeypatch.setenv("UCCL_TPU_WORLD", "1")
        monkeypatch.setenv("UCCL_TPU_INIT_JAX", "0")
        sess = tdist.initialize_from_env()
        try:
            assert (sess.rank, sess.world, sess._torch_pg) == (0, 1, False)
        finally:
            sess.close()


class TestHeartbeat:
    def test_detects_silent_peer(self):
        server = StoreServer()
        c0 = StoreClient("127.0.0.1", server.port)
        s0 = Session(rank=0, world=2, store=c0)
        failures = []
        mon = HeartbeatMonitor(
            s0, interval_s=0.1, timeout_s=0.5, on_failure=failures.append
        )
        mon.start()
        assert _until(lambda: mon.suspected() == [1])  # rank 1 never posts
        assert failures == [1]
        # rank 1 comes alive -> recovered
        c1 = StoreClient("127.0.0.1", server.port)
        s1 = Session(rank=1, world=2, store=c1)
        m1 = HeartbeatMonitor(s1, interval_s=0.1, timeout_s=0.5)
        m1.start()
        assert _until(lambda: mon.suspected() == [])
        assert failures == [1]  # the callback fires once per suspicion
        mon.stop()
        m1.stop()
        c0.close()
        c1.close()
        server.close()

    def test_port_monitor_watches_a_jax_rank(self):
        """A JAX rank's heartbeats keep a port monitor's view healthy: the
        two packages post the same keys and values."""
        from uccl_tpu.parallel.health import HeartbeatMonitor as JMonitor

        server = StoreServer()
        c0 = StoreClient("127.0.0.1", server.port)
        c1 = JStoreClient("127.0.0.1", server.port)
        mon = HeartbeatMonitor(Session(rank=0, world=2, store=c0),
                               interval_s=0.1, timeout_s=0.5)
        jmon = JMonitor(jdist.Session(rank=1, world=2, store=c1),
                        interval_s=0.1, timeout_s=0.5)
        jmon.start()
        mon.start()
        try:
            assert _until(lambda: c0.get("health/hb/1") is not None
                          and c1.get("health/hb/0") is not None)
            assert _until(lambda: len(mon._last_seen) == 1)
            assert mon.suspected() == [] and jmon.suspected() == []
            jmon.stop()  # rank 1 goes silent
            assert _until(lambda: mon.suspected() == [1])
        finally:
            mon.stop()
            jmon.stop()
            c0.close()
            c1.close()
            server.close()
