"""Python API of the P2P transfer engine (ctypes over the C++ runtime).

Port of ``uccl_tpu/p2p/endpoint.py``. The C++ engine is the unchanged
``native/`` runtime, built from its sources at first use into the port's
own build directory (``build/uccl_tpu_torch/native/``, never
``native/build/``) and loaded with ctypes' default ``RTLD_LOCAL``, so the
JAX package's copy of the library can live in the same process without
either binding the other's ``ucclt_*`` symbols.

The engine's threads read and write host memory. Buffers are numpy arrays
or contiguous CPU tensors (dtypes numpy lacks, such as bfloat16, are moved
as same-width integers); a CUDA tensor is refused by name. CUDA tensors
cross the wire through :meth:`Endpoint.send_device` /
:meth:`Endpoint.recv_device`, which stage them through pinned host memory
chunk by chunk (the JAX package's ``send_jax`` / ``recv_jax``, in the same
message format).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple, Union

import numpy as np
import torch

from uccl_tpu_torch import obs, resolve_device
from uccl_tpu_torch.utils.build import BUILD_DIR
from uccl_tpu_torch.utils.config import param
from uccl_tpu_torch.utils.logging import get_logger

_log = get_logger("P2P")

# Transfer-engine byte accounting on the obs registry: one labeled series
# for every verb class, incremented at the Python call site with the
# payload size (native bytes_tx/rx remain the wire-level truth, including
# retransmits; this series is application intent).
_P2P_BYTES = obs.counter(
    "p2p_bytes_total",
    "payload bytes entering the p2p engine per verb "
    "(write/read/send/recv/notif; vectorized calls count per element)",
)
# Terminal transfer failures, by reason (reason=wait_timeout: a vectorized
# write/read element never completed; reason=undelivered/stalled/
# credit_stall: the windowed SACK transport gave up, p2p/channel.py).
_P2P_FAILS = obs.counter(
    "p2p_transfer_failures_total",
    "one-sided transfers that failed terminally, by reason",
)

_stage_chunk_bytes = param(
    "stage_chunk_bytes", 8 << 20,
    help="device<->host staging pipeline chunk size for send_device/recv_device",
)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
NATIVE_BUILD_DIR = os.path.join(str(BUILD_DIR), "native")
_SO_PATH = os.path.join(NATIVE_BUILD_DIR, "libuccl_tpu.so")
_NET_SO_PATH = os.path.join(NATIVE_BUILD_DIR, "libuccl_tpu_net.so")
_ARTIFACTS = (_SO_PATH, _NET_SO_PATH)

FIFO_ITEM_BYTES = 64

_lib = None
_lib_lock = threading.Lock()


def _sources():
    srcs = [os.path.join(_NATIVE_DIR, "Makefile")]
    for sub, ext in (("src", ".cc"), (os.path.join("include", "uccl_tpu"), ".h")):
        d = os.path.join(_NATIVE_DIR, sub)
        srcs += sorted(os.path.join(d, f) for f in os.listdir(d) if f.endswith(ext))
    return srcs


def _build_if_needed() -> str:
    """Path of the port's build of ``native/``'s ``libuccl_tpu.so``, built
    first, with the net plugin ``libuccl_tpu_net.so`` beside it, if either
    is missing or was built from other sources.

    Freshness is a content hash of the runtime's sources (not mtimes), so
    checkout-order mtime skew can neither skip a needed rebuild nor load a
    stale binary; a file lock keeps concurrent first uses (test workers,
    forked peers) from racing ``make`` on the same objects."""

    def src_digest() -> str:
        hasher = hashlib.sha256()
        for s in _sources():
            with open(s, "rb") as f:
                hasher.update(f.read())
        return hasher.hexdigest()

    digest_path = os.path.join(NATIVE_BUILD_DIR, ".src_hash")

    def fresh() -> bool:
        if not all(os.path.exists(a) for a in _ARTIFACTS) or not os.path.exists(digest_path):
            return False
        with open(digest_path) as f:
            return f.read().strip() == src_digest()

    if fresh():
        return _SO_PATH
    import fcntl

    for tool in ("make", os.environ.get("CXX", "g++")):
        if shutil.which(tool) is None:
            raise RuntimeError(
                f"building the native p2p runtime needs `{tool}`, which is not "
                "on PATH")
    os.makedirs(NATIVE_BUILD_DIR, exist_ok=True)
    with open(os.path.join(NATIVE_BUILD_DIR, ".build.lock"), "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        if not fresh():  # re-check under the lock
            _log.info("building native runtime into %s", NATIVE_BUILD_DIR)
            proc = subprocess.run(
                ["make", "-C", _NATIVE_DIR, f"BUILD={NATIVE_BUILD_DIR}", *_ARTIFACTS],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"make of the native p2p runtime failed:\n{proc.stdout}{proc.stderr}")
            with open(digest_path, "w") as f:
                f.write(src_digest())
    return _SO_PATH


def net_plugin_path() -> str:
    """Path to the port's build of the loadable NCCL-net-shaped plugin .so
    (built if needed).

    Consumers dlopen it and read the exported ``ucclt_net_v1`` vtable
    (native/include/uccl_tpu/net_plugin.h) — the analog of pointing
    NCCL_NET_PLUGIN at the reference's libnccl-net-uccl.so."""
    _build_if_needed()
    return _NET_SO_PATH


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build_if_needed())
        c = ctypes.c_void_p
        lib.ucclt_create.restype = c
        lib.ucclt_create.argtypes = [ctypes.c_uint16, ctypes.c_int]
        lib.ucclt_create_bound.restype = ctypes.c_void_p
        lib.ucclt_create_bound.argtypes = [
            ctypes.c_char_p, ctypes.c_uint16, ctypes.c_int,
        ]
        lib.ucclt_destroy.argtypes = [c]
        lib.ucclt_listen_port.restype = ctypes.c_uint16
        lib.ucclt_listen_port.argtypes = [c]
        lib.ucclt_connect.restype = ctypes.c_int64
        lib.ucclt_connect.argtypes = [c, ctypes.c_char_p, ctypes.c_uint16]
        lib.ucclt_connect_from.restype = ctypes.c_int64
        lib.ucclt_connect_from.argtypes = [
            c, ctypes.c_char_p, ctypes.c_uint16, ctypes.c_char_p,
        ]
        lib.ucclt_peer_addr.restype = ctypes.c_int
        lib.ucclt_peer_addr.argtypes = [
            c, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.ucclt_conn_alive.restype = ctypes.c_int
        lib.ucclt_conn_alive.argtypes = [c, ctypes.c_uint64]
        lib.ucclt_accept.restype = ctypes.c_int64
        lib.ucclt_accept.argtypes = [c, ctypes.c_int]
        lib.ucclt_remove_conn.restype = ctypes.c_int
        lib.ucclt_remove_conn.argtypes = [c, ctypes.c_uint64]
        lib.ucclt_reg.restype = ctypes.c_uint64
        lib.ucclt_reg.argtypes = [c, ctypes.c_void_p, ctypes.c_size_t]
        lib.ucclt_dereg.restype = ctypes.c_int
        lib.ucclt_dereg.argtypes = [c, ctypes.c_uint64]
        lib.ucclt_advertise.restype = ctypes.c_int
        lib.ucclt_advertise.argtypes = [
            c, ctypes.c_uint64, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_char_p,
        ]
        for name in ("ucclt_write", "ucclt_read"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [c, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_size_t,
                           ctypes.c_char_p]
        for name in ("ucclt_write_async", "ucclt_read_async"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_uint64
            fn.argtypes = [c, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_size_t,
                           ctypes.c_char_p]
        for name in ("ucclt_writev_async", "ucclt_readv_async"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [
                c, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_void_p),   # srcs/dsts
                ctypes.POINTER(ctypes.c_size_t),   # lens
                ctypes.c_char_p,                   # packed fifos (n*64)
                ctypes.c_size_t,                   # n
                ctypes.POINTER(ctypes.c_uint64),   # xids_out
            ]
        lib.ucclt_poll.restype = ctypes.c_int
        lib.ucclt_poll.argtypes = [c, ctypes.c_uint64]
        lib.ucclt_wait.restype = ctypes.c_int
        lib.ucclt_wait.argtypes = [c, ctypes.c_uint64, ctypes.c_int]
        lib.ucclt_send.restype = ctypes.c_int
        lib.ucclt_send.argtypes = [c, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_size_t]
        lib.ucclt_recv.restype = ctypes.c_int64
        lib.ucclt_recv.argtypes = [c, ctypes.c_uint64, ctypes.c_void_p,
                                   ctypes.c_size_t, ctypes.c_int]
        if hasattr(lib, "ucclt_reap"):  # added after the v1 ABI
            lib.ucclt_reap.restype = None
            lib.ucclt_reap.argtypes = [c, ctypes.c_uint64]
        if hasattr(lib, "ucclt_send_notif"):
            lib.ucclt_send_notif.restype = ctypes.c_int
            lib.ucclt_send_notif.argtypes = [
                c, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_size_t
            ]
            lib.ucclt_get_notif.restype = ctypes.c_int64
            lib.ucclt_get_notif.argtypes = [
                c, ctypes.POINTER(ctypes.c_uint64), ctypes.c_void_p,
                ctypes.c_size_t,
            ]
        lib.ucclt_set_drop_rate.argtypes = [c, ctypes.c_double]
        if hasattr(lib, "ucclt_set_reorder_rate"):
            lib.ucclt_set_reorder_rate.argtypes = [c, ctypes.c_double]
            lib.ucclt_set_delay_jitter_us.argtypes = [c, ctypes.c_int64]
            lib.ucclt_set_conn_fault.restype = ctypes.c_int
            lib.ucclt_set_conn_fault.argtypes = [
                c, ctypes.c_uint64, ctypes.c_double, ctypes.c_double,
                ctypes.c_int64,
            ]
        lib.ucclt_set_rate_limit.argtypes = [c, ctypes.c_uint64]
        if hasattr(lib, "ucclt_conn_stats"):
            lib.ucclt_conn_stats.restype = ctypes.c_int
            lib.ucclt_conn_stats.argtypes = [
                c, ctypes.c_uint64, ctypes.POINTER(_ConnStatsC)
            ]
            lib.ucclt_set_conn_rate.restype = ctypes.c_int
            lib.ucclt_set_conn_rate.argtypes = [
                c, ctypes.c_uint64, ctypes.c_uint64
            ]
        if hasattr(lib, "ucclt_flush_conn"):
            lib.ucclt_flush_conn.restype = ctypes.c_int
            lib.ucclt_flush_conn.argtypes = [c, ctypes.c_uint64, ctypes.c_int]
        lib.ucclt_bytes_tx.restype = ctypes.c_uint64
        lib.ucclt_bytes_tx.argtypes = [c]
        lib.ucclt_bytes_rx.restype = ctypes.c_uint64
        lib.ucclt_bytes_rx.argtypes = [c]
        lib.ucclt_stats_json.restype = ctypes.c_int64
        lib.ucclt_stats_json.argtypes = [c, ctypes.c_char_p, ctypes.c_size_t]
        _lib = lib
        return _lib


class _ConnStatsC(ctypes.Structure):
    """Mirror of ucclt_conn_stats_t (append-only layout)."""

    _fields_ = [
        ("rtt_us", ctypes.c_double),
        ("pkts_tx", ctypes.c_uint64),
        ("pkts_rtx", ctypes.c_uint64),
        ("pkts_rx", ctypes.c_uint64),
        ("acks_rx", ctypes.c_uint64),
        ("bytes_unacked", ctypes.c_uint64),
        ("rate_bps", ctypes.c_uint64),
        ("udp_active", ctypes.c_int32),
        ("pad", ctypes.c_int32),
    ]


_INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def host_array(x, what: str = "p2p buffer") -> np.ndarray:
    """Zero-copy numpy view of host memory the engine may read or write.

    numpy arrays pass as they are; a CPU tensor becomes a view of its own
    storage (dtypes numpy lacks, such as bfloat16 or fp8, as same-width
    integers: transfers move bytes, so the view is faithful). A CUDA tensor
    raises ``ValueError``: the engine's threads would dereference a device
    pointer. Stage it with :meth:`Endpoint.send_device` /
    :meth:`Endpoint.recv_device` or ``.cpu()``."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(
                f"{what}: a {x.device} tensor is device memory, and the p2p "
                "engine reads and writes host memory only; stage it through "
                "Endpoint.send_device/recv_device or .cpu()")
        if not x.is_contiguous():
            raise ValueError(f"{what}: tensor must be contiguous")
        x = x.detach()
        try:
            return x.numpy()
        except TypeError:
            return x.view(_INT_OF_WIDTH[x.element_size()]).numpy()
    return x


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of ``t`` that the caller owns: a CPU tensor is
    cloned; a CUDA tensor lands in pinned host memory through a
    ``non_blocking`` copy and one wait on its event, as
    :meth:`Endpoint.send_device` stages each chunk."""
    t = t.detach()
    if t.device.type != "cuda":
        return t.contiguous().clone()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    ev.synchronize()
    return buf


def _as_buffer(arr) -> Tuple[ctypes.c_void_p, int]:
    arr = host_array(arr)
    if not arr.flags["C_CONTIGUOUS"]:
        raise ValueError("array must be C-contiguous")
    return arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes


class Endpoint:
    """P2P transfer endpoint (reference: p2p Endpoint, engine.h:243).

    Threat model: built for a trusted cluster fabric (the reference's RDMA
    assumption) — window tokens guard against buggy peers and stale
    descriptors, not adversaries with TCP reach. On multi-tenant hosts pass
    ``listen_ip`` (or set ``UCCL_TPU_LISTEN_IP``) to pin the listener to the
    fabric interface instead of INADDR_ANY.
    """

    def __init__(self, port: int = 0, n_engines: int = 2,
                 listen_ip: Optional[str] = None):
        self._lib = _load()
        if listen_ip is None:
            listen_ip = os.environ.get("UCCL_TPU_LISTEN_IP")
        self.listen_ip = listen_ip  # the bound interface (None = INADDR_ANY)
        self._h = self._lib.ucclt_create_bound(
            listen_ip.encode() if listen_ip else None, port, n_engines
        )
        if not self._h:
            raise RuntimeError(
                f"failed to create endpoint (port {port} in use, or bad "
                f"listen ip {listen_ip!r}?)"
            )
        self._mrs = {}  # mr_id -> ndarray (keepalive)
        self._inflight = {}  # xfer_id -> ndarray (keepalive until completion)
        # C++ completions are one-shot (the engine reclaims the entry on first
        # observation); this caches the terminal result so wait() followed by
        # poll_async() stays friendly. Entries are tiny and consumed on read.
        self._results = {}

    def _handle(self):
        if not self._h:
            raise ValueError("endpoint is closed")
        return self._h

    # -- lifecycle -------------------------------------------------------
    @property
    def port(self) -> int:
        return self._lib.ucclt_listen_port(self._handle())

    def close(self):
        if self._h:
            self._lib.ucclt_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- connections -----------------------------------------------------
    def connect(self, ip: str, port: int, local_ip: str = None) -> int:
        """``local_ip`` binds the conn's source address to one interface —
        per-path NIC selection for multipath channels (the reference's
        multi-NIC data channels, p2p/rdma/rdma_endpoint.h:117)."""
        if local_ip:
            cid = self._lib.ucclt_connect_from(
                self._handle(), ip.encode(), port, local_ip.encode()
            )
        else:
            cid = self._lib.ucclt_connect(self._handle(), ip.encode(), port)
        if cid < 0:
            raise ConnectionError(
                f"connect to {ip}:{port} failed"
                + (f" (local_ip={local_ip})" if local_ip else "")
            )
        return cid

    def peer_addr(self, conn_id: int) -> str:
        """'ip:port' of the conn's peer (verifies per-path NIC placement)."""
        buf = ctypes.create_string_buffer(64)
        if self._lib.ucclt_peer_addr(self._handle(), conn_id, buf, 64) != 0:
            # Unknown id OR getpeername failed (peer reset a registered conn)
            raise KeyError(
                f"conn {conn_id}: unknown, or peer address unavailable "
                "(disconnected?)"
            )
        return buf.value.decode()

    def conn_alive(self, conn_id: int) -> bool:
        """True while the conn is registered and not marked dead."""
        return bool(self._lib.ucclt_conn_alive(self._handle(), conn_id))

    def accept(self, timeout_ms: int = 10000) -> int:
        cid = self._lib.ucclt_accept(self._handle(), timeout_ms)
        if cid < 0:
            raise TimeoutError("accept timed out")
        return cid

    def remove_conn(self, conn_id: int) -> bool:
        return self._lib.ucclt_remove_conn(self._handle(), conn_id) == 0

    # -- memory ----------------------------------------------------------
    def reg(self, arr) -> int:
        """Register a writable host buffer (a numpy array or a contiguous
        CPU tensor; a CUDA tensor raises ``ValueError``). The endpoint keeps
        it alive until :meth:`dereg`."""
        arr = host_array(arr, "reg")
        ptr, nbytes = _as_buffer(arr)
        mr = self._lib.ucclt_reg(self._handle(), ptr, nbytes)
        self._mrs[mr] = arr
        return mr

    def dereg(self, mr: int) -> bool:
        self._mrs.pop(mr, None)
        return self._lib.ucclt_dereg(self._handle(), mr) == 0

    def advertise(self, mr: int, offset: int = 0, length: Optional[int] = None) -> bytes:
        """Serialize a 64-byte FifoItem for out-of-band exchange (reference:
        advertise + serialize_fifo_item, engine.h:347)."""
        if length is None:
            length = self._mrs[mr].nbytes - offset
        buf = ctypes.create_string_buffer(FIFO_ITEM_BYTES)
        if self._lib.ucclt_advertise(self._handle(), mr, offset, length, buf) != 0:
            raise ValueError("advertise failed (bad mr/range)")
        return buf.raw

    # -- one-sided -------------------------------------------------------
    def write(self, conn_id: int, src: np.ndarray, fifo: bytes) -> None:
        ptr, nbytes = _as_buffer(src)
        _P2P_BYTES.inc(nbytes, verb="write")
        if self._lib.ucclt_write(self._handle(), conn_id, ptr, nbytes, fifo) != 0:
            raise IOError("write failed")

    def read(self, conn_id: int, dst: np.ndarray, fifo: bytes) -> None:
        ptr, nbytes = _as_buffer(dst)
        _P2P_BYTES.inc(nbytes, verb="read")
        if self._lib.ucclt_read(self._handle(), conn_id, ptr, nbytes, fifo) != 0:
            raise IOError("read failed")

    def write_async(self, conn_id: int, src: np.ndarray, fifo: bytes) -> int:
        ptr, nbytes = _as_buffer(src)
        _P2P_BYTES.inc(nbytes, verb="write")
        xid = self._lib.ucclt_write_async(self._handle(), conn_id, ptr, nbytes, fifo)
        # Keep the buffer alive until completion: the tx proxy thread reads
        # from the raw pointer after this call returns.
        self._inflight[xid] = src
        return xid

    def read_async(self, conn_id: int, dst: np.ndarray, fifo: bytes) -> int:
        ptr, nbytes = _as_buffer(dst)
        _P2P_BYTES.inc(nbytes, verb="read")
        xid = self._lib.ucclt_read_async(self._handle(), conn_id, ptr, nbytes, fifo)
        self._inflight[xid] = dst
        return xid

    def _vec_async(self, c_fn, conn_id: int, arrays, fifos, verb: str):
        """Shared descriptor-array fan-out: one C call, one engine wake."""
        n = len(arrays)
        bufs = [_as_buffer(a) for a in arrays]
        ptrs = (ctypes.c_void_p * n)(*[p for p, _ in bufs])
        lens = (ctypes.c_size_t * n)(*[ln for _, ln in bufs])
        packed = b"".join(bytes(f) for f in fifos)
        if len(packed) != n * FIFO_ITEM_BYTES:
            raise ValueError("fifos must be n packed 64-byte descriptors")
        _P2P_BYTES.inc(sum(ln for _, ln in bufs), verb=verb)
        xids = (ctypes.c_uint64 * n)()
        c_fn(self._handle(), conn_id, ptrs, lens, packed, n, xids)
        out = list(xids)
        for x, a in zip(out, arrays):
            self._inflight[x] = a
        return out

    def writev_async(self, conn_id: int, srcs, fifos):
        """Vectorized async write over descriptor arrays (reference:
        writev_async + XferDescList, engine.h:317, engine_api.cc:448):
        one C call enqueues the whole batch with a single proxy wake.
        Returns per-element xfer ids."""
        return self._vec_async(self._lib.ucclt_writev_async, conn_id, srcs,
                               fifos, "write")

    def readv_async(self, conn_id: int, dsts, fifos):
        """Vectorized async read (reference: readv, engine.h:324)."""
        return self._vec_async(self._lib.ucclt_readv_async, conn_id, dsts,
                               fifos, "read")

    def _wait_all(self, xids, what: str) -> None:
        # Drain EVERY element before raising: abandoning the rest of the
        # batch would leak their _inflight keepalives + native completions.
        failed = [x for x in xids if not self.wait(x)]
        if failed:
            _P2P_FAILS.inc(len(failed), reason="wait_timeout")
            obs.instant("p2p_transfer_failed", track="wire",
                        reason="wait_timeout", what=what,
                        failed=len(failed), total=len(xids))
            raise IOError(f"{what}: {len(failed)}/{len(xids)} elements failed")

    def writev(self, conn_id: int, srcs, fifos) -> None:
        """Vectorized write (reference: writev, engine.h:311)."""
        self._wait_all(self.writev_async(conn_id, srcs, fifos), "writev")

    def readv(self, conn_id: int, dsts, fifos) -> None:
        """Vectorized read (reference: readv, engine.h:321)."""
        self._wait_all(self.readv_async(conn_id, dsts, fifos), "readv")

    def poll_async(self, xfer_id: int) -> Optional[bool]:
        """None = pending, True = done; raises on error (reference
        poll_async). Completions are one-shot: the first terminal
        observation (here or in wait()) consumes the id; polling a consumed
        id raises. A successful terminal poll leaves one cached entry for a
        follow-up wait() — wait() consumes it."""
        if xfer_id in self._results:
            return True  # parked success; wait() consumes it
        r = self._lib.ucclt_poll(self._handle(), xfer_id)
        if r == 0:
            return None
        self._inflight.pop(xfer_id, None)  # completed either way
        if r == 1:
            self._results[xfer_id] = True  # allow one follow-up observation
            return True
        raise IOError(f"transfer {xfer_id} failed")

    def wait(self, xfer_id: int, timeout_ms: int = 30000) -> bool:
        # _results holds only successful ids parked by poll_async for a
        # follow-up wait (errors raise there and then); popping one is True.
        if self._results.pop(xfer_id, None) is not None:
            return True
        ok = self._lib.ucclt_wait(self._handle(), xfer_id, timeout_ms) == 0
        if ok:
            # Terminal observation consumes the id — caching a True here
            # "for a follow-up" would leak one entry per completed transfer
            # (nothing performs the follow-up on success paths).
            self._inflight.pop(xfer_id, None)
            return True
        # Distinguish timeout (entry still pending) from a consumed
        # terminal. The completion can land in the race window between the
        # native wait's deadline and this poll — a kDone here IS success
        # (returning False would make retry loops count a delivered
        # transfer as lost, raising on the final attempt).
        r = self._lib.ucclt_poll(self._handle(), xfer_id)
        if r != 0:
            self._inflight.pop(xfer_id, None)
        return r == 1

    def reap(self, xfer_id: int) -> None:
        """Forget an abandoned transfer on BOTH sides of the boundary. For
        callers that observed completion via poll_async and will never
        wait() on the id, and for timed-out chunks being retransmitted —
        without this, late completions accumulate in the results cache and
        lost-frame xfers (which never complete) accumulate in the native
        tracking map forever."""
        self._results.pop(xfer_id, None)
        self._inflight.pop(xfer_id, None)
        reap = getattr(self._lib, "ucclt_reap", None)
        if reap is not None:
            reap(self._handle(), ctypes.c_uint64(xfer_id))

    # -- two-sided -------------------------------------------------------
    def send(self, conn_id: int, data: Union[bytes, np.ndarray, torch.Tensor]) -> None:
        if isinstance(data, (np.ndarray, torch.Tensor)):
            ptr, nbytes = _as_buffer(data)
        else:
            ptr, nbytes = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p), len(data)
        _P2P_BYTES.inc(nbytes, verb="send")
        if self._lib.ucclt_send(self._handle(), conn_id, ptr, nbytes) != 0:
            raise IOError("send failed")

    def send_notif(self, conn_id: int, data: bytes) -> None:
        """Send an out-of-band notification (NIXL notify: reference
        p2p/uccl_engine.h uccl_engine_send_notif). The peer drains these
        with :meth:`get_notifs` — across ALL connections, non-blocking —
        instead of a per-connection recv()."""
        fn = getattr(self._lib, "ucclt_send_notif", None)
        if fn is None:
            raise RuntimeError("loaded libuccl_tpu_torch.so predates notif ABI")
        ptr = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p)
        _P2P_BYTES.inc(len(data), verb="notif")
        if fn(self._handle(), conn_id, ptr, len(data)) != 0:
            raise IOError("send_notif failed")

    def get_notifs(self, max_n: int = 0) -> list:
        """Drain pending notifications non-blocking (NIXL get_notifs).
        Returns [(conn_id, bytes), ...] oldest-first; at most max_n if >0."""
        fn = getattr(self._lib, "ucclt_get_notif", None)
        if fn is None:
            return []  # old ABI: nothing can have been sent either
        out = []
        cap = 4096
        buf = ctypes.create_string_buffer(cap)
        conn = ctypes.c_uint64()
        while not max_n or len(out) < max_n:
            n = fn(self._handle(), ctypes.byref(conn), buf, cap)
            if n <= -2:  # message larger than buf: resize and retry
                cap = -(int(n) + 2)
                buf = ctypes.create_string_buffer(cap)
                continue
            if n < 0:
                break
            out.append((conn.value, buf.raw[: int(n)]))
        return out

    def recv(self, conn_id: int, max_bytes: int = 1 << 20, timeout_ms: int = 10000) -> bytes:
        buf = ctypes.create_string_buffer(max_bytes)
        n = self._lib.ucclt_recv(self._handle(), conn_id, buf, max_bytes, timeout_ms)
        if n <= -2:
            # message larger than the buffer: engine left it queued and told
            # us the required size — retry with an exact-size buffer
            needed = -(n + 2)
            buf = ctypes.create_string_buffer(needed)
            n = self._lib.ucclt_recv(self._handle(), conn_id, buf, needed, timeout_ms)
        if n < 0:
            raise TimeoutError("recv timed out")
        _P2P_BYTES.inc(int(n), verb="recv")
        return buf.raw[:n]

    def recv_into(self, conn_id: int, out: np.ndarray, timeout_ms: int = 10000) -> int:
        """Receive one message directly into a caller buffer (no allocation,
        no zero-fill — ``create_string_buffer`` memsets its whole capacity,
        which the chunked staging loop cannot afford). ``out`` must be a
        C-contiguous uint8 array (or CPU tensor); returns the message length."""
        out = host_array(out, "recv_into")
        assert out.dtype == np.uint8 and out.flags["C_CONTIGUOUS"]
        ptr = out.ctypes.data_as(ctypes.c_void_p)
        n = self._lib.ucclt_recv(
            self._handle(), conn_id, ptr, out.nbytes, timeout_ms
        )
        if n <= -2:
            raise IOError(
                f"recv_into: {-(n + 2)} B message exceeds {out.nbytes} B buffer"
            )
        if n < 0:
            raise TimeoutError("recv timed out")
        _P2P_BYTES.inc(int(n), verb="recv")
        return n

    # -- observability / fault injection ---------------------------------
    def set_drop_rate(self, p: float) -> None:
        """Drop each one-sided DATA-plane frame (kWrite/kRead/kReadResp/
        kWriteAck) with probability ``p``. Two-sided send/notif and the
        handshake ride untouched — injection models a lossy data fabric
        under a reliable control plane (UDP wire mode injects at the
        packet level instead, recovered by its SACK layer)."""
        self._lib.ucclt_set_drop_rate(self._handle(), p)

    def set_reorder_rate(self, p: float) -> None:
        """Hold each data frame back with probability ``p`` so the next
        frame on its conn overtakes it (released after ≤2 ms regardless):
        chunks land — and their completions arrive — out of order."""
        fn = getattr(self._lib, "ucclt_set_reorder_rate", None)
        if fn is None:
            raise RuntimeError("loaded libuccl_tpu_torch.so predates fault ABI")
        fn(self._handle(), p)

    def set_delay_jitter_us(self, max_us: int) -> None:
        """Stamp each data frame with a uniform [0, max_us] not-before
        delay (head-of-line per conn — an artificially slow path)."""
        fn = getattr(self._lib, "ucclt_set_delay_jitter_us", None)
        if fn is None:
            raise RuntimeError("loaded libuccl_tpu_torch.so predates fault ABI")
        fn(self._handle(), max_us)

    def set_conn_fault(self, conn_id: int, *, drop: float = -1.0,
                       reorder: float = -1.0, jitter_us: int = -1) -> None:
        """Per-conn fault overrides (−1 inherits the endpoint-global
        knobs) — make SOME multipath channel paths lossy/slow while the
        control path stays clean (the path-quality steering testbed)."""
        fn = getattr(self._lib, "ucclt_set_conn_fault", None)
        if fn is None:
            raise RuntimeError("loaded libuccl_tpu_torch.so predates fault ABI")
        if fn(self._handle(), conn_id, drop, reorder, jitter_us) != 0:
            raise KeyError(f"unknown conn {conn_id}")

    def set_rate_limit(self, bytes_per_sec: int) -> None:
        """Token-bucket pacing on the tx proxies; 0 disables (reference:
        Carousel timing-wheel pacing; actuator for the CC layer in cc.py)."""
        self._lib.ucclt_set_rate_limit(self._handle(), bytes_per_sec)

    def flush(self, conn_id: int, timeout_ms: int = 5000) -> bool:
        """Wait until every queued frame on the conn was handed to the
        kernel — and, on the UDP wire, until every serialized byte was
        ACKED by the peer (delivered, not merely transmitted)."""
        return self._lib.ucclt_flush_conn(
            self._handle(), conn_id, timeout_ms
        ) == 0

    def conn_stats(self, conn_id: int) -> dict:
        """Per-conn transport stats (UDP wire mode: RTT EWMA, packet/retx
        counts, unacked bytes) — the observation side of the CC control
        plane; see :class:`uccl_tpu_torch.p2p.cc.CcController`."""
        s = _ConnStatsC()
        if self._lib.ucclt_conn_stats(
            self._handle(), conn_id, ctypes.byref(s)
        ) != 0:
            raise KeyError(f"unknown conn {conn_id}")
        return {
            "rtt_us": s.rtt_us,
            "pkts_tx": s.pkts_tx,
            "pkts_rtx": s.pkts_rtx,
            "pkts_rx": s.pkts_rx,
            "acks_rx": s.acks_rx,
            "bytes_unacked": s.bytes_unacked,
            "rate_bps": s.rate_bps,
            "udp_active": bool(s.udp_active),
        }

    def set_conn_rate(self, conn_id: int, bytes_per_sec: int) -> None:
        """Per-conn pacing rate (0 = fall back to the endpoint-global
        bucket) — the actuation side of the CC control plane."""
        if self._lib.ucclt_set_conn_rate(
            self._handle(), conn_id, bytes_per_sec
        ) != 0:
            raise KeyError(f"unknown conn {conn_id}")

    @property
    def stats(self) -> dict:
        """Hot-loop engine stats (reference: periodic transport stats,
        collective/rdma/transport.cc:1797 + util/latency.h histograms):
        ``bytes_tx/rx``, ``stats_ticks`` (heartbeats of the 2s stats
        thread; UCCL_TPU_ENGINE_STATS=1 also logs each tick),
        ``notifs_pending`` (undrained out-of-band notifications), and
        per-engine ``engines[i]`` dicts with tx/rx frame counts, frame
        service latency p50/p99 (µs), queued tx bytes, and task-ring
        depth."""
        import json as _json

        buf = ctypes.create_string_buffer(1 << 16)
        n = self._lib.ucclt_stats_json(self._handle(), buf, len(buf))
        return _json.loads(buf.raw[:n].decode())

    # -- device staging helpers -----------------------------------------
    def send_device(self, conn_id: int, x, *, chunk_bytes: Optional[int] = None) -> None:
        """Device→host stage then two-sided send (the KV-cache push path).

        Pipelined: a CUDA tensor's ``chunk_bytes`` pieces are all copied
        into pinned host buffers up front (``non_blocking`` copies on the
        current stream, one CUDA event per chunk), and each chunk goes on
        the wire the moment its event has fired, so the wire send of chunk
        i overlaps the copies of chunks i+1... ``Endpoint.send`` only copies
        into the conn's tx queue; the tx proxy thread drains it. One message
        per chunk; :meth:`recv_device` reassembles by total byte count, so
        chunked and monolithic senders interoperate. A host tensor or
        numpy array is sent as one message."""
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            if isinstance(x, torch.Tensor):
                self.send(conn_id, x.detach().contiguous())
            else:
                self.send(conn_id, np.ascontiguousarray(np.asarray(x)))
            return
        if chunk_bytes is None:
            chunk_bytes = int(_stage_chunk_bytes.get())
        flat = x.detach().contiguous().reshape(-1)
        elems = max(1, chunk_bytes // flat.element_size())
        stream = torch.cuda.current_stream(flat.device)
        staged = []  # (pinned buffer, event): alive until the event fired
        for i in range(0, flat.numel(), elems):
            part = flat[i:i + elems]
            buf = torch.empty(part.shape, dtype=part.dtype, pin_memory=True)
            buf.copy_(part, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
            staged.append((buf, ev))
        for buf, ev in staged:
            ev.synchronize()
            self.send(conn_id, buf)

    def recv_device(self, conn_id: int, shape, dtype, device=None,
                    timeout_ms: int = 30000) -> torch.Tensor:
        """Receive a tensor staged by :meth:`send_device` (monolithic or
        chunked: messages are reassembled by total byte count) onto
        ``device`` (``cuda`` unless the caller asks for the CPU). On CUDA
        every message lands in one pinned host buffer and its host→device
        copy starts at once (``non_blocking``), overlapping the remaining
        wire receives; the call returns once every copy has completed, so
        the pinned buffer outlives them."""
        dev = resolve_device(device)
        shape = tuple(int(s) for s in shape)
        itemsize = torch.empty((), dtype=dtype).element_size()
        nbytes = int(np.prod(shape)) * itemsize
        if dev.type == "cuda":
            host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        else:
            host = out = torch.empty(nbytes, dtype=torch.uint8)
        view = host.numpy()
        got = 0
        while got < nbytes:
            n = self.recv_into(conn_id, view[got:], timeout_ms=timeout_ms)
            if n % itemsize:
                raise IOError(f"recv_device: {n} B message misaligned with dtype {dtype}")
            if dev.type == "cuda":
                out[got:got + n].copy_(host[got:got + n], non_blocking=True)
            got += n
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            ev.synchronize()
        return out.view(dtype).reshape(shape)
