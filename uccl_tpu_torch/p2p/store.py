"""Out-of-band rendezvous store over the P2P engine.

Port of ``uccl_tpu/p2p/store.py`` (host code, copied).

The reference bootstraps every pillar over plain TCP metadata exchange
(include/util/net.h OOB handshakes; ukernel's oob exchangers,
experimental/ukernel/src/transport/oob/; torch Store in the EP benches). This
is the TPU framework's equivalent: a tiny key-value store served by rank 0's
Endpoint, used to exchange FifoItems, mesh coordinates, and addresses before
any data-plane traffic. Protocol: length-prefixed msgpack-free frames —
``SET key value`` / ``GET key`` / ``WAIT key timeout`` over the engine's
two-sided send/recv.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from uccl_tpu_torch.p2p.endpoint import Endpoint
from uccl_tpu_torch.utils.logging import get_logger

_log = get_logger("P2P")


def _pack(*parts: bytes) -> bytes:
    out = []
    for p in parts:
        out.append(len(p).to_bytes(4, "big"))
        out.append(p)
    return b"".join(out)


def _unpack(buf: bytes):
    parts = []
    i = 0
    while i < len(buf):
        n = int.from_bytes(buf[i : i + 4], "big")
        i += 4
        parts.append(buf[i : i + n])
        i += n
    return parts


class StoreServer:
    """Rank-0 side: serves SET/GET over accepted connections."""

    def __init__(self, port: int = 0):
        self._ep = Endpoint(port)
        self._kv: Dict[bytes, bytes] = {}
        self._cv = threading.Condition()
        self._stop = False
        self._threads = []
        self._acceptor = threading.Thread(target=self._accept_loop, daemon=True)
        self._acceptor.start()

    @property
    def port(self) -> int:
        return self._ep.port

    def close(self):
        # Signal and join worker threads BEFORE destroying the native
        # endpoint: they block inside its accept/recv calls.
        self._stop = True
        self._acceptor.join(timeout=5)
        for t in self._threads:
            t.join(timeout=5)
        self._ep.close()

    def _accept_loop(self):
        while not self._stop:
            try:
                conn = self._ep.accept(timeout_ms=500)
            except TimeoutError:
                continue
            except Exception:
                return
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: int):
        while not self._stop:
            try:
                msg = self._ep.recv(conn, timeout_ms=1000)
            except TimeoutError:
                continue
            except Exception:
                return
            try:
                parts = _unpack(msg)
                op = parts[0]
                if op == b"SET":
                    with self._cv:
                        self._kv[parts[1]] = parts[2]
                        self._cv.notify_all()
                    self._ep.send(conn, _pack(b"OK"))
                elif op == b"GET":
                    with self._cv:
                        val = self._kv.get(parts[1])
                    if val is None:
                        self._ep.send(conn, _pack(b"MISS"))
                    else:
                        self._ep.send(conn, _pack(b"OK", val))
                elif op == b"WAIT":
                    timeout_s = float(parts[2].decode())
                    deadline = time.monotonic() + timeout_s
                    with self._cv:
                        while parts[1] not in self._kv:
                            left = deadline - time.monotonic()
                            if left <= 0 or self._stop:
                                break
                            self._cv.wait(timeout=min(left, 0.5))
                        val = self._kv.get(parts[1])
                    if val is None:
                        self._ep.send(conn, _pack(b"MISS"))
                    else:
                        self._ep.send(conn, _pack(b"OK", val))
                else:
                    self._ep.send(conn, _pack(b"ERR", b"bad op"))
            except Exception as e:  # keep serving other clients
                _log.warning("store serve error: %r", e)
                return


class StoreClient:
    """Any rank: set/get/wait against the rank-0 store.

    Connect retries for ``connect_timeout_s`` — at bootstrap the server rank
    may come up a beat later than the workers (the reference's bootstrap
    handshakes retry the same way).
    """

    def __init__(self, ip: str, port: int, connect_timeout_s: float = 10.0):
        self._ep = Endpoint()
        deadline = time.monotonic() + connect_timeout_s
        while True:
            try:
                self._conn = self._ep.connect(ip, port)
                break
            except ConnectionError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.1)
        self._lock = threading.Lock()

    def close(self):
        self._ep.close()

    def set(self, key: str, value: bytes) -> None:
        with self._lock:
            self._ep.send(self._conn, _pack(b"SET", key.encode(), value))
            resp = _unpack(self._ep.recv(self._conn))
        if resp[0] != b"OK":
            raise IOError(f"store set({key}) failed: {resp}")

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            self._ep.send(self._conn, _pack(b"GET", key.encode()))
            resp = _unpack(self._ep.recv(self._conn))
        return resp[1] if resp[0] == b"OK" else None

    def wait(self, key: str, timeout_s: float = 30.0) -> bytes:
        with self._lock:
            self._ep.send(
                self._conn,
                _pack(b"WAIT", key.encode(), str(timeout_s).encode()),
            )
            resp = _unpack(
                self._ep.recv(self._conn, timeout_ms=int(timeout_s * 1000) + 2000)
            )
        if resp[0] != b"OK":
            raise TimeoutError(f"store wait({key}) timed out")
        return resp[1]
