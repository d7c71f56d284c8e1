"""NIXL-style tensor-transfer API — the surface Ray-based RL frameworks use.

Port of ``uccl_tpu/p2p/ray_api.py``. Arrays are host numpy arrays or
contiguous CPU tensors; device tensors reach it via staging.

The reference exposes this through nanobind (p2p/engine_api.cc:143
``NB_MODULE(p2p)``: ``register_memory`` over tensor lists, descriptor
serialize/deserialize, ``get_metadata``/``add_remote_endpoint``,
``transfer(conn_id, op, local_descs, remote_descs)`` — exercised by
p2p/tests/test_ray_api.py from Ray actors doing weight transfer). This
module is that veneer over :class:`uccl_tpu_torch.p2p.Endpoint`:

* arrays are host numpy (TPU arrays reach it via staging, the framework's
  standing analog of the reference's GPU registration),
* a descriptor carries the window token (``fifo``) the engine's one-sided
  ops need — the role of the reference's rkeys: possession of a serialized
  descriptor is the permission to read/write that byte range,
* metadata is the dialable (ip, port) blob exchanged out-of-band (a Ray
  object store, the repo's StoreClient, a pipe — anything).

Works the same inside Ray actors or plain processes; see
examples/ray_weight_transfer.py.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from uccl_tpu_torch.p2p.endpoint import Endpoint, host_array


class XferEndpoint:
    """Endpoint wrapper speaking the reference's tensor/descriptor API
    (p2p/engine_api.cc: register_memory:?, transfer:448, serialize:420)."""

    def __init__(self, ep: Optional[Endpoint] = None, *, n_engines: int = 2):
        from uccl_tpu_torch.p2p.mr_cache import MrCache

        self.ep = ep if ep is not None else Endpoint(n_engines=n_engines)
        # interval-containment registration cache (reference:
        # test_register_memory_cache.py): repeat/subregion registrations
        # reuse the base MR behind fresh handles, refcounted
        self.mr_cache = MrCache(self.ep)

    # -- registration + descriptors ------------------------------------
    def register_memory(self, arrays: Sequence[np.ndarray]) -> List[dict]:
        """Register each array and mint transfer descriptors.

        Descriptor fields mirror the reference's (addr/size + key material):
        ``fifo`` is the engine's advertised-window token — the rkey analog —
        so a peer holding the descriptor can one-sided read/write exactly
        this byte range and nothing else. Arrays must be C-contiguous: a
        silent ascontiguousarray copy here would register the COPY, and
        peer writes would never reach the caller's array (live model
        weights, in the Ray pattern). The endpoint's registry keeps each
        registered array alive."""
        # Validate the WHOLE batch first: a failure after some registrations
        # already happened would discard the descs list and leak handles the
        # caller can never release. CPU tensors are viewed in place; a CUDA
        # tensor raises ValueError.
        arrays = [host_array(a, "register_memory") for a in arrays]
        for arr in arrays:
            if not isinstance(arr, np.ndarray):
                raise TypeError("register_memory takes host numpy arrays or CPU "
                                "tensors (stage device tensors first)")
            if not arr.flags["C_CONTIGUOUS"]:
                raise ValueError(
                    "register_memory needs C-contiguous arrays (a view/"
                    "transpose would silently register a copy the peer "
                    "writes into instead of your array)"
                )
            if arr.nbytes == 0:
                raise ValueError("register_memory: zero-size array")
        descs = []
        try:
            for arr in arrays:
                hid, mr, off = self.mr_cache.register(arr)
                fifo = self.ep.advertise(mr, off, arr.nbytes)
                descs.append({
                    "addr": arr.ctypes.data,
                    "size": int(arr.nbytes),
                    # the shared key material (reference lkeys/rkeys
                    # analog): cache hits repeat the base mr_id at an offset
                    "mr_id": int(mr),
                    # the per-call API handle deregister_memory() takes
                    "handle": int(hid),
                    "fifo": fifo.hex(),
                })
        except Exception:
            for d in descs:  # unwind the partial batch
                self.mr_cache.deregister(d["handle"])
            raise
        return descs

    def deregister_memory(self, descs: List[dict]) -> None:
        """Release registrations by descriptor (reference
        deregister_memory): the underlying base MR is freed only when its
        last handle is gone. Drains the WHOLE batch even when one handle is
        bad, then reports the failures — stopping early would leave the
        tail pinned forever."""
        bad = []
        for d in descs:
            try:
                self.mr_cache.deregister(d["handle"])
            except KeyError:
                bad.append(d.get("handle"))
        if bad:
            raise KeyError(f"unknown registration handle(s): {bad}")

    @staticmethod
    def get_serialized_descs(descs: List[dict]) -> bytes:
        return json.dumps(descs).encode()

    @staticmethod
    def deserialize_descs(blob: bytes) -> List[dict]:
        descs = json.loads(blob.decode())
        if not isinstance(descs, list):
            raise ValueError("descriptor blob must decode to a list")
        return descs

    # -- out-of-band endpoint exchange ---------------------------------
    def get_metadata(self) -> bytes:
        """Dialable endpoint blob (reference get_metadata, p2p/engine.h:289):
        ship it to the peer over any OOB channel. Address preference: the
        interface the endpoint is actually BOUND to (listen_ip /
        UCCL_TPU_LISTEN_IP — on a multi-homed host the hostname may resolve
        to a NIC nothing is listening on), then UCCL_TPU_HOST_IP, then the
        hostname's address, then loopback."""
        import os
        import socket

        host = getattr(self.ep, "listen_ip", None)
        if host in ("0.0.0.0", "::"):  # wildcard binds are not dialable
            host = None
        if not host:
            host = os.environ.get("UCCL_TPU_HOST_IP")
        if not host:
            try:
                resolved = socket.gethostbyname(socket.gethostname())
                if resolved and not resolved.startswith("127."):
                    host = resolved
            except OSError:
                pass
        if not host:
            host = "127.0.0.1"
        return json.dumps({"ip": host, "port": self.ep.port}).encode()

    def add_remote_endpoint(self, metadata: bytes) -> Tuple[bool, int]:
        """Connect to a peer's metadata blob (reference add_remote_endpoint,
        p2p/engine.h:269). Returns (ok, conn_id)."""
        try:
            md = json.loads(metadata.decode())
            cid = self.ep.connect(md["ip"], int(md["port"]))
            return True, cid
        except Exception:
            return False, -1

    def accept(self, timeout_ms: int = 30000) -> int:
        return self.ep.accept(timeout_ms=timeout_ms)

    # -- transfers -----------------------------------------------------
    def transfer(self, conn_id: int, op: str, local: Sequence[np.ndarray],
                 remote_descs: List[dict]) -> List[int]:
        """Issue one-sided transfers pairing local arrays with remote
        descriptors (reference transfer over XferDescList,
        engine_api.cc:448). op: "WRITE" pushes local -> remote window;
        "READ" pulls remote window -> local. Returns per-pair transfer ids
        for :meth:`poll`/:meth:`wait`."""
        if op not in ("WRITE", "READ"):
            raise ValueError(f"op must be WRITE or READ, got {op!r}")
        if len(local) != len(remote_descs):
            raise ValueError(
                f"{len(local)} local arrays vs {len(remote_descs)} remote "
                "descriptors"
            )
        arrs, fifos = [], []
        for arr, desc in zip(local, remote_descs):
            if isinstance(arr, torch.Tensor) and op == "WRITE":
                arr = arr.contiguous()
            arr = host_array(arr, "transfer")
            arr = np.ascontiguousarray(arr) if op == "WRITE" else arr
            if arr.nbytes > desc["size"]:
                raise ValueError(
                    f"local {arr.nbytes}B exceeds remote window "
                    f"{desc['size']}B"
                )
            if op == "READ" and (
                not arr.flags["C_CONTIGUOUS"] or not arr.flags["WRITEABLE"]
            ):
                raise ValueError("READ needs a writable contiguous dst")
            arrs.append(arr)
            fifos.append(bytes.fromhex(desc["fifo"]))
        # vectorized batch (one C call, one engine wake — the XferDescList
        # semantics of engine_api.cc:448)
        if op == "WRITE":
            return self.ep.writev_async(conn_id, arrs, fifos)
        return self.ep.readv_async(conn_id, arrs, fifos)

    def poll(self, xid: int) -> Optional[bool]:
        return self.ep.poll_async(xid)

    def wait(self, xids, timeout_ms: int = 30000) -> bool:
        """Wait on every id, DRAINING all of them even after a failure —
        abandoning the tail would leak keepalives and let callers reuse
        buffers a proxy thread is still reading (Endpoint._wait_all's
        pattern)."""
        if isinstance(xids, int):
            xids = [xids]
        ok = True
        for x in xids:
            ok = self.ep.wait(x, timeout_ms=timeout_ms) and ok
        return ok

    def send_notif(self, conn_id: int, payload: bytes) -> None:
        self.ep.send_notif(conn_id, payload)

    def get_notifs(self):
        return self.ep.get_notifs()

    def close(self) -> None:
        self.ep.close()
