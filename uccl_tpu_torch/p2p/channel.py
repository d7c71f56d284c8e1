"""Multipath transfer channel: windowed SACK transport over parallel conns.

Port of ``uccl_tpu/p2p/channel.py``, its params and counters under the
same names on the port's config and obs registry. Transfers take numpy
arrays or contiguous CPU tensors (viewed, never copied); a CUDA tensor
raises ``ValueError``.

The DCN re-expression of UCCL-Tran's core idea — spray chunks of one message
over many paths and complete out-of-order (reference: 32-way packet spraying,
collective/rdma/transport_config.h:40 PORT_ENTROPY; chunk size knob
UCCL_CHUNK_SIZE_KB:42). A :class:`Channel` bundles ``n_paths`` engine
connections to one peer; large writes split into chunks issued as independent
one-sided writes into the same advertised window (each chunk at its own
offset). Each connection is served by its own engine thread pair on both
ends, so paths genuinely move bytes in parallel.

Reliability is a real sender window (:mod:`uccl_tpu_torch.p2p.sack`): per-chunk
sequence numbers, bounded in-flight bytes, cumulative-ack + SACK state fed
by per-chunk completion acks, *selective repeat* — fast-retransmit of
exactly the SACK-gap chunks after K duplicate acks, RTO with exponential
backoff for the rest — and a per-path quality EWMA steering both
retransmits and new chunks away from lossy/slow paths (reference:
__retransmit_for_flow + pcb.h SACK bitmaps, collective/rdma/transport.cc).
Congestion control plugs into the same loop as a window-bytes protocol
(:class:`uccl_tpu_torch.p2p.cc.CongestionControl` — Timely/Swift fed by per-chunk
completion RTTs via :meth:`Channel.enable_window_cc`), and EQDS-style
receiver-driven credit (:mod:`uccl_tpu_torch.p2p.eqds`) gates chunk issue under
incast.
"""

from __future__ import annotations

import struct
import time
import uuid
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from uccl_tpu_torch import obs
from uccl_tpu_torch.p2p.endpoint import FIFO_ITEM_BYTES, Endpoint, host_array
from uccl_tpu_torch.utils.config import param

# Channel-level spray accounting (payload bytes are already counted per
# verb on p2p_bytes_total by the Endpoint the chunks issue through): how
# many chunk transfers the multipath fan-out created, and how many were
# re-issued after a completion timeout — the wire-health face of the
# credit-paced spray (docs/OBSERVABILITY.md).
_CHAN_CHUNKS = obs.counter(
    "p2p_channel_chunks_total",
    "chunk transfers issued by the multipath channel spray (incl. retx)",
)
_CHAN_RETX = obs.counter(
    "p2p_channel_retx_total",
    "channel chunks retransmitted, split by recovery kind "
    "(kind=fast: SACK-gap dup-ack fast retransmit; kind=rto: timeout "
    "with exponential backoff / path death)",
)
_CC_PROBE_ERRS = obs.counter(
    "p2p_cc_probe_errors_total",
    "background CC delay-probe iterations that raised (reason=exception "
    "class) — a dead CC loop is visible here instead of silent",
)
_CREDIT_STALL = obs.counter(
    "p2p_credit_stall_seconds_total",
    "seconds senders spent stalled waiting for receiver pull credit "
    "(EQDS pull mode) — the incast backpressure face of the credit plane",
)
_CREDIT_GRANTED = obs.gauge(
    "p2p_credit_granted_bytes",
    "cumulative pull-credit bytes GRANTED to the peer, per channel "
    "(conn=path-0 conn id of the granting side)",
)
_CREDIT_CONSUMED = obs.gauge(
    "p2p_credit_consumed_bytes",
    "cumulative pull-credit bytes CONSUMED by issued chunks, per channel "
    "(conn=path-0 conn id of the sending side)",
)
_CHAN_CWND = obs.gauge(
    "p2p_chan_cwnd_bytes",
    "sender window in effect at the last windowed transfer "
    "(CC cwnd when window CC is on, else the static cap; "
    "last-writer-wins across channels)",
)
_CHAN_SRTT = obs.gauge(
    "p2p_chan_srtt_us",
    "smoothed per-chunk completion RTT of the last windowed transfer "
    "(last-writer-wins across channels)",
)
_CHAN_RTO = obs.gauge(
    "p2p_chan_rto_ms",
    "retransmission timeout of the last windowed transfer "
    "(last-writer-wins across channels)",
)
# declared in p2p/endpoint.py — the windowed transport's terminal
# failures land on the same family so a chaos run's failure mix is
# auditable from metrics alone (docs/OBSERVABILITY.md)
_XFER_FAILS = obs.counter("p2p_transfer_failures_total")

_chunk_kb = param("chunk_size_kb", 1024, help="multipath chunk size in KiB")
_abandoned_cap = param(
    "chan_abandoned_cap",
    1024,
    help="max abandoned (timed-out, non-terminal) transfer ids kept alive; "
    "past this the oldest is force-reaped — only injected frame loss can "
    "reach the cap, so the traded keepalive guarantee is test-only",
)
_chunk_retries = param(
    "chunk_retries",
    2,
    help="extra transmissions per chunk (max_tx = retries + 1) for the "
    "windowed SACK sender: a chunk is re-issued by dup-ack fast "
    "retransmit or RTO, steered to the best-quality path. The engine "
    "wire is reliable TCP, so losing a chunk means injected loss "
    "(set_drop_rate), a dead path, or a stalled peer — the channel-level "
    "analog of the reference's SACK retransmit path "
    "(collective/rdma/pcb.h:20, __retransmit_for_flow transport.cc:3376)",
)
_window_bytes = param(
    "chan_window_bytes",
    8 << 20,
    help="static cap on a windowed transfer's in-flight bytes; window CC "
    "(Channel.enable_window_cc) tightens it dynamically, never widens it",
)
_dupack_k = param(
    "chan_dupack_k",
    3,
    help="duplicate-ack threshold for SACK-gap fast retransmit: K "
    "later-sequence completions while a chunk is outstanding mark it "
    "lost (TCP's classic 3, tolerant of mild multipath reordering)",
)
_nic_list = param(
    "nic_list",
    "",
    str,
    "comma-separated local source IPs to stripe channel paths across "
    "(multi-NIC data path; path 0 — which also carries channel control "
    "messages — is striped like any path, while the OOB store/bootstrap "
    "stay on the default route). Reference: per-GPU NIC selection + data "
    "channels across NICs, p2p/rdma/rdma_endpoint.h:117",
)


@dataclass(frozen=True)
class FifoItem:
    """Python view of the engine's 64-byte descriptor (native engine.h)."""

    rid: int
    size: int
    token: int
    offset: int

    _FMT = "<QQQQ32x"

    def pack(self) -> bytes:
        return struct.pack(self._FMT, self.rid, self.size, self.token, self.offset)

    @staticmethod
    def unpack(raw: bytes) -> "FifoItem":
        rid, size, token, offset = struct.unpack(FifoItem._FMT, raw)
        return FifoItem(rid, size, token, offset)

    def slice(self, offset: int, length: int) -> "FifoItem":
        """Descriptor for a chunk inside this window (server-side bounds are
        still enforced against the full advertised window)."""
        if offset + length > self.size:
            raise ValueError(f"chunk [{offset}, {offset + length}) outside window {self.size}")
        return FifoItem(self.rid, length, self.token, self.offset + offset)


class Channel:
    """n_paths connections to one peer + chunked multipath transfers.

    Client side: ``Channel.connect(ep, ip, port, n_paths)``.
    Server side: ``Channel.accept(ep)`` (reads the path handshake).
    """

    _HELLO = b"UCCLT_CHAN"

    def __init__(
        self,
        ep: Endpoint,
        conns: List[int],
        chunk_bytes: Optional[int] = None,
        meta: bytes = b"",
    ):
        self.ep = ep
        self.conns = conns
        self.chunk_bytes = chunk_bytes or _chunk_kb.get() * 1024
        self.retries = _chunk_retries.get()
        self.retransmitted_chunks = 0  # lifetime count of re-issued chunks
        self.retx_fast = 0  # lifetime SACK-gap fast retransmits
        self.retx_rto = 0   # lifetime RTO/path-death retransmits
        self.window_bytes = _window_bytes.get()
        self.dupack_k = _dupack_k.get()
        # window-bytes CC on the data path (cc.CongestionControl); None =
        # fixed window_bytes cap. Enable via enable_window_cc().
        self.window_cc = None
        self._last_win = None  # last transfer's SackTxWindow (stats)
        # persistent link-quality EWMA: the per-transfer
        # PathQuality resets with each SackTxWindow, so cross-transfer
        # consumers (the DCN scheduled-a2a demotion) fold each finished
        # window's WORST per-path delivery score here. None until the
        # first windowed transfer completes or fails.
        self._link_ewma: Optional[float] = None
        self._abandoned: List[int] = []  # timed-out xids awaiting terminal
        self._grant_xids: List[int] = []  # fire-and-forget grant writes
        self._cc_probe_logged = False  # log-once guard for probe errors
        # application tag carried in the connect handshake (e.g. which peer
        # rank dialed, for multi-channel topologies like a DCN full mesh)
        self.meta = meta
        # CC probe scratch: a 1-byte window each side advertises at channel
        # setup (reference analog: per-flow CC state installed at connection
        # setup, transport.cc handle_install_flow). Populated by
        # _exchange_probe_window on every public creation path.
        self._probe_buf = None
        self._probe_mr = None
        self._peer_probe_fifo: Optional[bytes] = None
        self._cc_stop = None
        self._cc_thread = None
        self.cc: Optional[object] = None  # active RateController, if any
        # EQDS-style pull mode (receiver-driven credit; reference
        # include/cc/eqds.h, pacer collective/rdma/eqds.h:93): the peer
        # one-sided-writes a CUMULATIVE byte allowance into _credit_buf;
        # when _pull_mode is set, write() gates chunk issue on it.
        self._credit_buf = None
        self._credit_mr = None
        self._peer_credit_fifo: Optional[bytes] = None
        self._pull_mode = False
        self._pull_sent = 0  # cumulative bytes issued under pull mode

    def _exchange_probe_window(self, timeout_ms: int = 10000) -> None:
        """Mint a 1-byte scratch window and swap descriptors with the peer on
        path 0 — the landing pad for the CC delay probes. Symmetric send-then
        -recv; runs before any application traffic on the channel.

        Eager by design even though CC may stay off: a lazy exchange would
        race application control messages on path 0 (the peer's first recv
        could consume the PF frame), and the cost is one 1-byte registration
        plus one round trip at setup — the dialer's PF is already in flight
        when the acceptor finishes assembling, so the recv is ~instant."""
        self._probe_buf = np.zeros(1, np.uint8)
        self._probe_mr = self.ep.reg(self._probe_buf)
        fifo = self.ep.advertise(self._probe_mr)
        self.ep.send(self.conns[0], b"PF" + fifo)
        msg = self.ep.recv(self.conns[0], timeout_ms=timeout_ms)
        if not msg.startswith(b"PF") or len(msg) != 2 + FIFO_ITEM_BYTES:
            raise IOError(f"probe-window exchange broken: {msg[:8]!r}")
        self._peer_probe_fifo = msg[2:]
        # credit window for EQDS-style pull mode: the peer writes a
        # cumulative uint64 byte allowance here (same eager rationale as PF)
        self._credit_buf = np.zeros(1, np.uint64)
        self._credit_mr = self.ep.reg(self._credit_buf)
        cw = self.ep.advertise(self._credit_mr)
        self.ep.send(self.conns[0], b"CW" + cw)
        msg = self.ep.recv(self.conns[0], timeout_ms=timeout_ms)
        if not msg.startswith(b"CW") or len(msg) != 2 + FIFO_ITEM_BYTES:
            raise IOError(f"credit-window exchange broken: {msg[:8]!r}")
        self._peer_credit_fifo = msg[2:]

    # -- congestion control (reference: CC in the transport hot path,
    # transport.cc:2845 EventOnRxACK; here a per-channel probe thread
    # actuating the endpoint's token-bucket pacer) ------------------------
    def enable_cc(
        self,
        algo: str = "timely",
        interval_s: float = 0.02,
        probe_timeout_ms: int = 250,
    ) -> None:
        """Start the background delay-probe thread driving the pacer.

        ``algo``: "timely" (RTT gradient) or "swift" (delay-target window).
        Probes ride the channel's LAST path into the peer's scratch window
        (see :meth:`probe_conn`); timed-out probes feed the controller the
        full timeout (loss is a congestion signal)."""
        import threading

        from uccl_tpu_torch.p2p.cc import (RateController, SwiftCC,
                                     SwiftRateAdapter, TimelyCC)
        from uccl_tpu_torch.utils.logging import get_logger

        if self._peer_probe_fifo is None:
            raise RuntimeError(
                "channel has no probe window (built without a handshake?)"
            )
        if self._cc_thread is not None:
            return
        if algo == "timely":
            rc = RateController(self.ep, TimelyCC())
        elif algo == "swift":
            rc = RateController(self.ep, SwiftRateAdapter(SwiftCC()))
        else:
            raise ValueError(f"unknown cc algo {algo!r}")
        self.cc = rc
        self._cc_stop = threading.Event()
        log = get_logger("P2P")

        def loop():
            try:
                while not self._cc_stop.wait(interval_s):
                    try:
                        rc.probe(
                            self.probe_conn, self._peer_probe_fifo,
                            probe_timeout_ms,
                        )
                    except ValueError:
                        return  # endpoint closed under us: loop is done
                    except Exception as e:
                        # A broken probe path must be VISIBLE, not a
                        # silently dead CC loop: count every failed
                        # iteration, log the first one per channel.
                        _CC_PROBE_ERRS.inc(reason=type(e).__name__)
                        if not self._cc_probe_logged:
                            self._cc_probe_logged = True
                            log.warning(
                                "channel CC probe failing (%s: %s); "
                                "counting on p2p_cc_probe_errors_total",
                                type(e).__name__, e,
                            )
            finally:
                # Never exit leaving the pacer stuck at a collapsed rate.
                try:
                    self.ep.set_rate_limit(0)
                except Exception:
                    pass

        self._cc_thread = threading.Thread(target=loop, daemon=True)
        self._cc_thread.start()

    def disable_cc(self) -> None:
        if self._cc_thread is None:
            return
        self._cc_stop.set()
        self._cc_thread.join(timeout=5)
        self._cc_thread = None
        self.ep.set_rate_limit(0)

    # -- window CC on the data path (no probe thread) ----------------------
    def enable_window_cc(self, algo="swift") -> None:
        """Congestion-control the windowed sender itself: a window-bytes
        controller (:class:`uccl_tpu_torch.p2p.cc.CongestionControl`) fed by
        every chunk's COMPLETION RTT and loss event inside the transfer
        loop — no side probe thread, no decoupled pacer. ``algo`` is
        "swift" | "timely" | a CongestionControl instance."""
        from uccl_tpu_torch.p2p.cc import make_window_cc

        self.window_cc = make_window_cc(algo) if isinstance(algo, str) else algo

    def disable_window_cc(self) -> None:
        self.window_cc = None

    # -- EQDS-style receiver-driven pull mode ------------------------------
    def enable_pull_sender(self) -> None:
        """Gate this channel's writes on receiver credit (EQDS pull mode,
        reference include/cc/eqds.h). Until the peer grants (via
        :class:`uccl_tpu_torch.p2p.eqds.PullPacer` or :meth:`grant_credit`),
        writes block at chunk granularity.

        The grant counter is cumulative over the CONNECTION (never reset —
        zeroing it would race in-flight grant writes, and a re-enable would
        otherwise inherit all historically granted bytes as free unpaced
        credit). Gating instead resumes from the current cumulative grant:
        bytes issued while pull mode was off are treated as already
        licensed, and new issues wait for NEW credit."""
        if self._peer_credit_fifo is None:
            raise RuntimeError(
                "channel has no credit window (built without a handshake?)"
            )
        self._pull_sent = int(self._credit_buf[0])
        self._pull_mode = True

    def disable_pull_sender(self) -> None:
        self._pull_mode = False

    @property
    def pull_credit(self) -> int:
        """Cumulative bytes the peer has licensed us to send."""
        return int(self._credit_buf[0])

    @property
    def pull_granted(self) -> int:
        """Cumulative bytes WE have granted the peer (receiver side)."""
        return getattr(self, "_granted", 0)

    def grant_credit(self, nbytes: int) -> int:
        """Receiver side: extend the peer's cumulative allowance by
        ``nbytes`` — one 8-byte one-sided write into the peer's credit
        window on the isolated probe path (ordered per conn, so the
        cumulative counter is monotonic on the peer). Returns the new
        cumulative grant. The EQDS 'pull quantum'.

        Fire-and-forget: the counter is CUMULATIVE, so a lost grant write
        (or a fault-injected lost ack) is superseded by the next one —
        blocking for the completion here would couple the receiver's
        grant loop to data-plane fault injection. Completion ids are
        reaped opportunistically, bounded."""
        if self._peer_credit_fifo is None:
            raise RuntimeError("channel has no peer credit window")
        self._granted = getattr(self, "_granted", 0) + int(nbytes)
        arr = np.asarray([self._granted], np.uint64)
        self._grant_xids.append(
            self.ep.write_async(self.probe_conn, arr, self._peer_credit_fifo)
        )
        if len(self._grant_xids) > 64:
            self._reap_grants()
        _CREDIT_GRANTED.set(self._granted, conn=str(self.conns[0]))
        return self._granted

    def _reap_grants(self) -> None:
        still = []
        for xid in self._grant_xids:
            try:
                r = self.ep.poll_async(xid)
            except IOError:
                self.ep.reap(xid)  # consumed error: clear parked state
                continue
            if r is None:
                still.append(xid)
            else:
                self.ep.reap(xid)
        # cap: a grant whose ack was fault-injected away never terminates;
        # past the cap the OLDEST is force-reaped — same documented
        # test-only trade as _abandon (only injected loss reaches here,
        # and by then the 8-byte frame left the tx queue long ago)
        while len(still) > 256:
            self.ep.reap(still.pop(0))
        self._grant_xids = still

    @classmethod
    def connect(
        cls,
        ep: Endpoint,
        ip: str,
        port: int,
        n_paths: int = 4,
        chunk_bytes: Optional[int] = None,
        meta: bytes = b"",
        nics: Optional[list] = None,
    ) -> "Channel":
        """``nics`` (or UCCL_TPU_NIC_LIST) stripes the data paths across
        local source interfaces round-robin: path i binds nics[i % len] —
        the multi-NIC data/ctrl split (control messages ride path 0 like
        any path, but the OOB store and bootstrap use the default route)."""
        if nics is None:
            raw = _nic_list.get()
            nics = [s.strip() for s in raw.split(",") if s.strip()] if raw else []
        token = uuid.uuid4().bytes
        conns = []
        try:
            for i in range(n_paths):
                local_ip = nics[i % len(nics)] if nics else None
                cid = ep.connect(ip, port, local_ip=local_ip)
                ep.send(cid, cls._HELLO + token + bytes([i, n_paths]) + meta)
                conns.append(cid)
        except Exception:
            # A later path failing (e.g. a misconfigured NIC bind) must not
            # leak the established ones; tearing them down also unblocks the
            # server's accept loop immediately instead of at its timeout.
            for cid in conns:
                ep.remove_conn(cid)
            raise
        chan = cls(ep, conns, chunk_bytes, meta)
        chan._exchange_probe_window()
        return chan

    @classmethod
    def _parse_hello(cls, hello: bytes):
        if not hello.startswith(cls._HELLO) or len(hello) < len(cls._HELLO) + 18:
            raise IOError("not a channel handshake")
        base = len(cls._HELLO)
        token = hello[base : base + 16]
        idx, n_paths = hello[base + 16], hello[base + 17]
        return token, idx, n_paths, hello[base + 18 :]

    @classmethod
    def accept(
        cls, ep: Endpoint, timeout_ms: int = 10000, chunk_bytes: Optional[int] = None
    ) -> "Channel":
        first_conn = ep.accept(timeout_ms)
        hello = ep.recv(first_conn, timeout_ms=timeout_ms)
        token, idx, n_paths, meta = cls._parse_hello(hello)
        paths = {idx: first_conn}
        while len(paths) < n_paths:
            cid = ep.accept(timeout_ms)
            h = ep.recv(cid, timeout_ms=timeout_ms)
            t2, i2, _, _ = cls._parse_hello(h)
            if t2 != token:
                raise IOError("path handshake mismatch (interleaved channels?)")
            paths[i2] = cid
        chan = cls(ep, [paths[i] for i in range(n_paths)], chunk_bytes, meta)
        chan._exchange_probe_window(timeout_ms)
        return chan


    @property
    def n_paths(self) -> int:
        return len(self.conns)

    @property
    def probe_conn(self) -> int:
        """The conn CC delay probes ride: the LAST path when there is more
        than one. Path 0 also carries application control messages, whose
        frames queue ahead of a probe on the same conn — a multi-MB control
        message would then inflate probe RTT and collapse the rate with no
        network congestion at all (per-conn queues are FIFO). The last data
        path shares the data plane's fate — queueing behind striped data
        chunks IS the congestion signal delay-CC wants — without the
        control-plane noise. Single-path channels have no choice."""
        return self.conns[-1] if len(self.conns) > 1 else self.conns[0]

    # -- control-plane helpers (ride path 0, ordered) ----------------------
    def send(self, data) -> None:
        self.ep.send(self.conns[0], data)

    def recv(self, max_bytes: int = 1 << 20, timeout_ms: int = 10000) -> bytes:
        return self.ep.recv(self.conns[0], max_bytes, timeout_ms)

    # -- data-plane: chunked multipath one-sided ops -----------------------
    def _chunks(self, total: int):
        """(offset, length) chunk list of `total` bytes."""
        cb = self.chunk_bytes
        return [(off, min(cb, total - off)) for off in range(0, total, cb)]

    @staticmethod
    def _flat_view(arr: np.ndarray) -> np.ndarray:
        if not arr.flags["C_CONTIGUOUS"]:
            raise ValueError("channel transfers need C-contiguous arrays")
        # reshape BEFORE the uint8 view: a 0-d row (e.g. a 1-D all_to_all's
        # scalar slice) rejects view() but reshapes to (1,) for free
        return arr.reshape(-1).view(np.uint8)

    def _elem_chunks(self, arr, fifo: bytes, scalar_ok: bool = False):
        """One transfer element → its windowed chunk descriptors
        ``(view, packed_fifo, nbytes)`` — the single place element
        validation and chunk splitting live (shared by write/read and
        writev so the entry points cannot drift)."""
        arr = host_array(arr, "channel transfer")  # CPU tensor -> view; CUDA raises
        if scalar_ok and isinstance(arr, np.generic):
            # numpy scalar (e.g. a 1-D array's row slice): value-copy is
            # fine for a TX source — never for a read destination (the
            # transfer would land in a discarded temporary; reads keep
            # the TypeError below)
            arr = np.asarray(arr).reshape(1)
        if not isinstance(arr, np.ndarray):
            # lists/bytes would be silently copied — fatal on the read path
            # (the transfer would land in a discarded temporary)
            raise TypeError(
                f"channel transfers need numpy arrays or CPU tensors, got {type(arr)}"
            )
        if arr.ndim == 0:
            arr = arr.reshape(1)  # 0-d → (1,) view: same memory, both paths
        flat = self._flat_view(arr)
        item = FifoItem.unpack(fifo)
        return [
            (flat[off:off + ln], item.slice(off, ln).pack(), ln)
            for off, ln in self._chunks(flat.nbytes)
        ]

    def _spray(self, arr, fifo, async_op, timeout_ms: int,
               scalar_ok: bool = False) -> None:
        """Windowed chunk fan-out for one-sided ops: the transfer's chunks
        run through the selective-repeat SACK window (`p2p/sack.py`) over
        all paths. Under pull mode every NEW chunk issue is licensed by
        receiver credit; window CC bounds in-flight bytes."""
        chunks = self._elem_chunks(arr, fifo, scalar_ok=scalar_ok)
        self._prune_abandoned()
        self._run_window(chunks, async_op, timeout_ms)

    def _run_window(self, chunks, async_op, timeout_ms: int) -> None:
        """Drive one windowed transfer: issue chunks within the sender
        window, feed completions (acks/errors) and their RTTs back into
        the SACK state machine and the window CC, retransmit exactly what
        the SACK state marks lost. ``chunks`` is a list of
        ``(src_or_dst_view, packed_fifo, nbytes)``.

        Pull-mode credit is charged ONCE per payload byte, at first issue:
        the receiver granted an allowance for the message, and a
        retransmission replaces a lost frame rather than sending new
        payload — re-debiting would wedge exact-credit receivers. A
        credit shortfall pauses NEW chunks only; retransmits (already
        licensed) keep flowing, so loss recovery is never credit-gated.
        """
        from uccl_tpu_torch.p2p.sack import NEW, SackTxWindow

        if not chunks:
            return
        win = SackTxWindow(
            [ln for _, _, ln in chunks],
            self.n_paths,
            max_tx=self.retries + 1,
            dupack_k=self.dupack_k,
            rto_init_s=min(max(0.05, timeout_ms / 1e3 / 4.0), 1.0),
            rto_max_s=max(0.2, timeout_ms / 1e3),
        )
        self._last_win = win
        # flight bundles capture this channel's live transport face
        # (cwnd, SACK splits, path EWMAs) for the duration of the
        # transfer — last writer wins across concurrent channels, and
        # the trigger's own context carries its window's stats anyway
        obs.flight_provider("transport", self.transport_stats)
        cc = self.window_cc
        inflight = {}  # xid -> (seq, t_issue, path); attempt-granular
        last_progress = time.monotonic()
        credit_stall_t0 = None  # monotonic start of a continuous stall

        def on_complete(xid: int, ok: bool, now: float) -> None:
            nonlocal last_progress
            seq, t0, path = inflight.pop(xid)
            if ok:
                rtt_us = (now - t0) * 1e6
                if win.on_ack(seq, path=path, rtt_us=rtt_us, now=now):
                    if cc is not None:
                        cc.on_ack(rtt_us, chunks[seq][2])
                last_progress = now
            else:
                # CC hears about this loss when the retransmit issues
                # (every lost chunk causes exactly one) — not here too.
                # t_sent lets the window ignore a SUPERSEDED attempt's
                # late error (a newer attempt owns recovery).
                win.on_error(seq, path, now, t_sent=t0)

        try:
            while not win.done():
                now = time.monotonic()
                # 1) non-blocking completion sweep (acks arrive out of
                # order across paths — this IS the SACK feed)
                for xid in list(inflight):
                    try:
                        r = self.ep.poll_async(xid)
                    except IOError:
                        on_complete(xid, False, now)
                        continue
                    if r is None:
                        continue
                    self.ep.reap(xid)  # consume the parked success
                    on_complete(xid, True, now)
                if win.done():
                    break
                # 2) issue within the window (retransmits first — sendable
                # orders them ahead of new chunks)
                limit = self.window_bytes
                if cc is not None:
                    limit = min(limit, cc.cwnd_bytes())
                for seq, kind in win.sendable(now, limit):
                    view, fifo_b, ln = chunks[seq]
                    if self._pull_mode and kind == NEW:
                        need = self._pull_sent + ln
                        if int(self._credit_buf[0]) < need:
                            # new chunks pause for credit; sendable lists
                            # retransmits first, so nothing lost waits
                            if credit_stall_t0 is None:
                                credit_stall_t0 = now
                            break
                        if credit_stall_t0 is not None:
                            _CREDIT_STALL.inc(now - credit_stall_t0)
                            credit_stall_t0 = None
                        self._pull_sent += ln
                        _CREDIT_CONSUMED.set(
                            self._pull_sent, conn=str(self.conns[0])
                        )
                    path = win.pick_path(seq, kind)
                    _CHAN_CHUNKS.inc()
                    if kind != NEW:
                        self.retransmitted_chunks += 1
                        _CHAN_RETX.inc(kind=kind)
                        if kind == "fast":
                            self.retx_fast += 1
                        else:
                            self.retx_rto += 1
                        if cc is not None:
                            cc.on_loss()
                    t_issue = time.monotonic()
                    xid = async_op(self.conns[path], view, fifo_b)
                    win.mark_sent(seq, path, kind, t_issue)
                    inflight[xid] = (seq, t_issue, path)
                # 3) failure checks
                now = time.monotonic()
                dead = win.exhausted(now)
                if dead:
                    _XFER_FAILS.inc(len(dead), reason="undelivered")
                    obs.instant("p2p_transfer_failed", track="wire",
                                reason="undelivered", chunks=len(dead),
                                attempts=win.max_tx)
                    raise IOError(
                        f"transfer failed: {len(dead)} chunks undelivered "
                        f"after {win.max_tx} attempts"
                    )
                if (credit_stall_t0 is not None
                        and now - credit_stall_t0 > timeout_ms / 1e3):
                    _CREDIT_STALL.inc(now - credit_stall_t0)
                    credit_stall_t0 = None
                    _XFER_FAILS.inc(reason="credit_stall")
                    obs.instant("p2p_transfer_failed", track="wire",
                                reason="credit_stall")
                    raise TimeoutError(
                        f"pull credit stalled: need "
                        f"{self._pull_sent + chunks[win._next_new][2]}, "
                        f"have {int(self._credit_buf[0])}"
                    )
                if now - last_progress > timeout_ms / 1e3:
                    _XFER_FAILS.inc(reason="stalled")
                    obs.instant("p2p_transfer_failed", track="wire",
                                reason="stalled", inflight=len(inflight))
                    raise IOError(
                        f"transfer stalled: no chunk completion in "
                        f"{timeout_ms} ms ({len(inflight)} in flight)"
                    )
                # 4) completion-driven wake: block briefly on the OLDEST
                # in-flight attempt instead of spinning the sweep
                if inflight:
                    oldest = next(iter(inflight))
                    if self.ep.wait(oldest, 2):
                        on_complete(oldest, True, time.monotonic())
                else:
                    time.sleep(0.0002)
        finally:
            if credit_stall_t0 is not None:
                _CREDIT_STALL.inc(time.monotonic() - credit_stall_t0)
            # stale attempts (superseded by a delivered retransmit, or a
            # failed transfer's in-flight chunks) keep their keepalive
            # until a terminal state is observed
            for xid in inflight:
                self._abandon(xid)
            _CHAN_CWND.set(
                cc.cwnd_bytes() if cc is not None else self.window_bytes
            )
            _CHAN_SRTT.set(win.srtt_us)
            _CHAN_RTO.set(win.rto_s * 1e3)
            worst = min(win.paths.score)
            self._link_ewma = (worst if self._link_ewma is None
                               else 0.5 * self._link_ewma + 0.5 * worst)

    def link_score(self) -> Optional[float]:
        """Cross-transfer link quality in [0, 1]: an EWMA (over completed
        windowed transfers) of the worst per-path delivery score — the
        pessimistic signal a scheduler reads to demote this link's edges
        (``DcnGroup.all_to_all(path_floor=...)``) while the per-transfer
        PathQuality keeps steering chunks WITHIN the link. None until a
        windowed transfer has run."""
        return self._link_ewma

    def transport_stats(self) -> dict:
        """Snapshot of the windowed transport's state: last transfer's
        SACK/RTT/path-quality stats plus lifetime retransmit splits — the
        numbers the incast bench reports per arm."""
        st = dict(self._last_win.stats()) if self._last_win is not None else {}
        st.update(
            retx_fast_total=self.retx_fast,
            retx_rto_total=self.retx_rto,
            retransmitted_chunks=self.retransmitted_chunks,
            cwnd_bytes=(self.window_cc.cwnd_bytes()
                        if self.window_cc is not None else self.window_bytes),
            pull_mode=self._pull_mode,
            pull_sent=self._pull_sent,
            pull_credit=(int(self._credit_buf[0])
                         if self._credit_buf is not None else 0),
            link_score=self._link_ewma,
        )
        return st

    def _abandon(self, xid: int) -> None:
        """Stop waiting on a timed-out transfer WITHOUT freeing its
        keepalive: the native tx path may still hold a zero-copy pointer
        into the source buffer (queued or mid-send frame), so the memory
        must stay alive until a terminal state is observed. Every abandoned
        id terminates eventually in production — a late ack completes it, a
        dead conn fails it — and the next _spray call prunes it. Only
        injected frame loss (set_drop_rate) produces never-terminating ids;
        so that long loss-soak tests don't grow memory unboundedly, the
        list is capped: past the cap the OLDEST id is force-reaped, trading
        the keepalive guarantee only in that already-test-only case."""
        self._abandoned.append(xid)
        cap = _abandoned_cap.get()
        if len(self._abandoned) > cap:
            # Prune terminal ids first — the cap should only ever evict a
            # genuinely still-in-flight id (the documented test-only trade),
            # not force-reap a live one while reapable dead ids sit in the
            # list.
            self._prune_abandoned()
            if len(self._abandoned) > cap:
                self.ep.reap(self._abandoned.pop(0))

    def _prune_abandoned(self) -> None:
        still = []
        for x in self._abandoned:
            try:
                r = self.ep.poll_async(x)
            except IOError:
                self.ep.reap(x)  # consumed error: clear parked state
                continue
            if r is None:
                still.append(x)  # still in flight: keepalive must live on
            else:
                self.ep.reap(x)  # parked success: release result+keepalive
        self._abandoned = still

    def fence(self, timeout_ms: int = 60000) -> None:
        """Block until every abandoned transfer reaches a terminal state.

        After a write/read that retransmitted, a stale attempt's frame can
        still be in flight on a recovering path; if the caller then REUSES
        the same advertised window (or read destination) for a *different*
        message, that late frame would land over the new bytes. fence()
        makes window reuse safe again: once every abandoned id is terminal
        (late ack — the peer consumed the frame — or conn death — the
        frame died with it), no stale data can arrive. Raises IOError if
        any id is still in flight at the deadline. Fresh-advertise-per-
        message callers never need this (a stale frame NACKs on the old
        token)."""
        deadline = time.monotonic() + timeout_ms / 1e3
        still = []
        for x in self._abandoned:
            while True:
                try:
                    r = self.ep.poll_async(x)
                except IOError:
                    r = False  # terminal error: consumed
                if r is not None:
                    if r:
                        self.ep.wait(x, 0)  # consume the parked success
                    self.ep.reap(x)
                    break
                if time.monotonic() > deadline:
                    still.append(x)
                    break
                time.sleep(0.005)
        self._abandoned = still
        if still:
            raise IOError(
                f"fence: {len(still)} abandoned transfers still in flight"
            )

    def write(self, src: np.ndarray, fifo: bytes, timeout_ms: int = 60000) -> None:
        """Spray `src` into the peer's advertised window across all paths."""
        self._spray(src, fifo, self.ep.write_async, timeout_ms,
                    scalar_ok=True)

    def writev(self, srcs, fifos, timeout_ms: int = 60000) -> None:
        """Vectorized windowed write: every (src, fifo) element becomes
        one or more chunks of ONE windowed transfer, so selective repeat,
        path steering, CC and pull credit act across the whole batch (the
        disagg KV slab path — reference: writev over descriptor lists,
        engine.h:311). Returns once every element is delivered."""
        chunks = []
        for src, fifo in zip(srcs, fifos):
            chunks.extend(self._elem_chunks(src, fifo, scalar_ok=True))
        self._prune_abandoned()
        self._run_window(chunks, self.ep.write_async, timeout_ms)

    def write_compressed(
        self, src: np.ndarray, fifo: bytes, timeout_ms: int = 60000,
        group: int = 128, codec: str = "fp8",
    ) -> int:
        """Compress `src` and spray the blob (reference: DietGPU wire
        compression on the P2P path, p2p/rdma/compression.h:46). codec:
        "fp8" (lossy, ~3.8x) or "lossless" (exact, byte-plane + native rANS —
        the DietGPU-faithful mode). The window owner decodes with
        :func:`Channel.decode` (blobs self-describe); size the window with
        ``compress.compressed_bound`` (fp8) or raw nbytes + 16 KiB slack
        (lossless). Returns the blob byte count (for the wire ratio)."""
        from uccl_tpu_torch.p2p.compress import encode

        blob = encode(src, codec, group)
        self.write(blob, fifo, timeout_ms)
        return int(blob.nbytes)

    @staticmethod
    def decode(window: np.ndarray) -> np.ndarray:
        """Decode a compressed blob previously landed in a window (either
        codec; routed by magic)."""
        from uccl_tpu_torch.p2p.compress import decode_any

        return decode_any(window)

    def read(self, dst: np.ndarray, fifo: bytes, timeout_ms: int = 60000) -> None:
        """Chunked multipath one-sided read into `dst`."""
        self._spray(dst, fifo, self.ep.read_async, timeout_ms)

    def close(self) -> None:
        self.disable_cc()
        for attr in ("_probe_mr", "_credit_mr"):
            mr = getattr(self, attr)
            if mr is not None:
                try:
                    self.ep.dereg(mr)
                except Exception:
                    pass  # endpoint already closed
                setattr(self, attr, None)
        for c in self.conns:
            self.ep.remove_conn(c)


class ChannelAcceptor:
    """Background channel dispatcher for multi-peer topologies.

    Several peers dialing one endpoint concurrently interleave their path
    connections in the accept queue; plain :meth:`Channel.accept` would see a
    token mismatch. This acceptor takes every inbound conn, groups handshakes
    by token, and delivers each completed channel to ``on_channel(chan)``
    (called on the acceptor thread; ``chan.meta`` identifies the dialer)."""

    # Worst-case blocking inside the loop: one accept (200ms) + one hello
    # recv + the setup-exchange recvs (PF probe window AND CW credit
    # window), each _HELLO_TIMEOUT_MS. close() must join for longer than
    # their sum so the native endpoint is never destroyed under a thread
    # inside a C call.
    _HELLO_TIMEOUT_MS = 2000
    _PARTIAL_TTL_S = 30.0

    @classmethod
    def _join_timeout_s(cls) -> float:
        return 0.2 + 3 * (cls._HELLO_TIMEOUT_MS / 1000.0) + 1.0

    def __init__(self, ep: Endpoint, on_channel, chunk_bytes: Optional[int] = None):
        import threading

        self.ep = ep
        self._on_channel = on_channel
        self._chunk_bytes = chunk_bytes
        self._stop = False
        self._partial = {}  # token -> (meta, n_paths, {idx: conn}, first_seen)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _expire_partials(self):
        """Drop handshakes whose dialer died mid-way so their conns don't
        accumulate on a long-lived endpoint."""
        import time

        now = time.monotonic()
        for token in list(self._partial):
            meta, np_, paths, first_seen = self._partial[token]
            if now - first_seen > self._PARTIAL_TTL_S:
                del self._partial[token]
                for cid in paths.values():
                    self.ep.remove_conn(cid)

    def _run(self):
        import time

        while not self._stop:
            self._expire_partials()
            try:
                cid = self.ep.accept(timeout_ms=200)
            except TimeoutError:
                continue
            except Exception:
                return  # endpoint closed
            try:
                hello = self.ep.recv(cid, timeout_ms=self._HELLO_TIMEOUT_MS)
                token, idx, n_paths, meta = Channel._parse_hello(hello)
            except Exception:
                self.ep.remove_conn(cid)  # junk or dawdling dialer
                continue
            meta0, np_, paths, _ = self._partial.setdefault(
                token, (meta, n_paths, {}, time.monotonic())
            )
            paths[idx] = cid
            if len(paths) == np_:
                del self._partial[token]
                chan = Channel(
                    self.ep,
                    [paths[i] for i in range(np_)],
                    self._chunk_bytes,
                    meta0,
                )
                try:
                    chan._exchange_probe_window(self._HELLO_TIMEOUT_MS)
                except Exception:
                    chan.close()  # dialer died mid-setup
                    continue
                self._on_channel(chan)

    def close(self):
        self._stop = True
        self._thread.join(timeout=self._join_timeout_s())
