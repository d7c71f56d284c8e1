"""Disaggregated prefill/decode serving: chunk-streamed KV handoff over p2p.

Port of ``uccl_tpu/serving/disagg.py``. The P2P pillar's reason to exist
(PAPER.md §0.2: a NIXL-style initiator-target KV-cache transfer engine) as a
serving architecture: a **PrefillWorker** runs a chunked-prefill
``ServingEngine`` and, as each C-token chunk of a prompt lands in its KV
slot, one-sided-writes that ``[off, off+C)`` KV slab into the decode
worker's advertised slot pool via ``Endpoint.writev_async`` — transfer of
chunk *i* overlaps prefill compute of chunk *i+1*, so when the last chunk's
logits produce the first token, only ONE chunk (plus the control notif)
remains in flight. The **DecodeWorker** reserved its slot when the stream
opened (BEGIN→GRANT), imports the streamed rows, and ``adopt()``s the
request into its own engine: TTFT is bounded by prefill + one chunk's
transfer, not prefill + whole-cache transfer. Add the prefill side's
prefix-reuse cache (``serving/prefix_cache.py``) and shared system prompts
are computed once: a hit resumes at ``prefill_pos = matched_len`` — still
shipping every chunk (the decode side needs all rows), but skipping their
compute.

The engines' KV pools live on the card and the transfer engine moves host
memory only: each chunk's slab is staged device to host through pinned
memory (``backend.export_slot_kv``: a ``non_blocking`` copy and one wait on
its event, a host sync per chunk) before ``writev_async``, and a decode
worker on the card keeps its host mirror in pinned memory, so the import is
one pinned host-to-device copy of the slot's rows.

Exactness: KV slabs cross the wire as raw float32 rows, the first token is
computed by the (oracle-exact, tested) prefill engine, and the decode
engine continues through the same masked decode primitive — so every
disaggregated request equals its ``replay_alone``, and, on the CPU, the
one-shot ``generate`` (tests/test_torch_disagg.py).

Wire format (docs/SERVING.md), byte for byte the JAX package's: the decode
side advertises its ENTIRE host KV mirror (one FifoItem for K, one for V,
exchanged in HELLO); the prefill side derives per-(layer, chunk) windows by
descriptor slicing (``FifoItem.slice``), so the steady-state control plane
is three small JSON notifs per request — BEGIN (prompt + timing), GRANT
(slot), FINAL (length + first token + timing) — and ALL KV bytes move
one-sided. A port worker and a JAX worker therefore pair.

Control-plane timestamps are wall-clock (``time.time()``): the TTFT split
(queue / prefill / transfer) spans two processes, where the engines'
monotonic clocks share no epoch.

Distributed tracing (docs/OBSERVABILITY.md): every submitted request's
:class:`~uccl_tpu_torch.obs.TraceContext` rides the BEGIN notif verbatim,
the decode side stamps it onto its GRANT/adopt/import events, and a
Chrome-trace flow pair (``s`` inside the first ``kv_stream.tx`` span, ``f``
inside ``kv_stream.import``, ids derived from the trace_id) binds the two
processes' spans into one Perfetto arrow. The HELLO handshake is followed
by a notif-borne clock exchange (``clock_ping`` → ``clock_pong`` →
``clock_sync``): the prefill side estimates the wall offset to its decode
peer by the RTT midpoint (:func:`uccl_tpu_torch.obs.estimate_clock_offset`)
and hands the decode process its offset from the reference (prefill)
clock, which lands in that process's trace metadata for merge-time
alignment.
"""

from __future__ import annotations

import base64
import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from uccl_tpu_torch import obs
from uccl_tpu_torch.serving.engine import ChunkEvent, ServingEngine
from uccl_tpu_torch.serving.health import DEAD as _PEER_DEAD
from uccl_tpu_torch.serving.request import Request, now

KV_DTYPE = np.float32

_STREAM_CHUNKS = obs.counter(
    "kv_stream_chunks_total",
    "KV slabs streamed between prefill and decode workers (role=tx|rx)",
)
_STREAM_REQS = obs.counter(
    "kv_stream_requests_total",
    "requests whose KV crossed the disagg stream (role=tx|rx)",
)
_LEASES_EXPIRED = obs.counter(
    "disagg_leases_expired_total",
    "GRANT leases reclaimed on the decode side: the reserved slot's KV "
    "never completed before expiry (reason=timeout) or its prefill peer "
    "was declared dead (reason=peer_dead) — the slot returns to the "
    "pool instead of leaking forever",
)
_STALE_FINALS = obs.counter(
    "disagg_stale_finals_total",
    "FINALs arriving for a stream whose lease already expired — dropped "
    "(the slot was reclaimed; importing would corrupt its new occupant)",
)
_CTRL_RETRIES = obs.counter(
    "disagg_ctrl_retries_total",
    "control-plane retransmissions by message (msg=begin: no GRANT "
    "within the retry window; msg=grant: a duplicate BEGIN re-answered "
    "idempotently; msg=final: no FINAL-ack within the window)",
)
_CTRL_DROPPED = obs.counter(
    "disagg_ctrl_dropped_total",
    "control notifs dropped by the Python-level chaos injector "
    "(set_ctrl_drop) — the notif plane's fault-injection face",
)
_DRAIN_TIMEOUTS = obs.counter(
    "disagg_drain_timeouts_total",
    "drain/serve deadlines that expired with work outstanding, by role "
    "— the structured-timeout counter (the raise names the stuck "
    "rids/conns)",
)

# -- control-plane fault injection ------------------------------------------
# The native injector (Endpoint.set_drop_rate / set_conn_fault) faults the
# one-sided DATA plane only — notifs ride the reliable control path by
# design (p2p/endpoint.py). Chaos runs that want control-plane loss
# (dropped GRANTs, lost FINALs) inject it HERE, at the send site, with a
# seeded RNG so runs reproduce. HELLO/clock/bye are exempt: they are
# handshake/teardown, not the retried steady-state plane under test.
_CTRL_DROP: Dict[str, object] = {"rate": 0.0, "rng": None}
_DROPPABLE = ("begin", "grant", "final", "final_ack", "hb")


def set_ctrl_drop(rate: float, seed: int = 0) -> None:
    """Drop each outgoing steady-state control notif (BEGIN/GRANT/FINAL/
    final-ack/heartbeat) with probability ``rate``, process-wide —
    counted on ``disagg_ctrl_dropped_total{msg}``. 0 disables."""
    import random

    _CTRL_DROP["rate"] = float(rate)
    _CTRL_DROP["rng"] = random.Random(seed)


# Flight-recorder arming for the notif plane: past ``storm_after``
# process-wide control retransmissions, ONE ``ctrl_storm`` bundle fires
# (docs/OBSERVABILITY.md) — a retry or two is the idempotent plane doing
# its job; a storm means the plane is lossy or the peer unresponsive.
_CTRL_FLIGHT: Dict[str, object] = {"storm_after": None, "fired": False,
                                   "retries": 0}


def arm_ctrl_flight(storm_after: Optional[int] = None) -> None:
    _CTRL_FLIGHT["storm_after"] = storm_after
    _CTRL_FLIGHT["fired"] = False
    _CTRL_FLIGHT["retries"] = 0


def _note_ctrl_retry(msg: str) -> None:
    _CTRL_RETRIES.inc(msg=msg)
    _CTRL_FLIGHT["retries"] += 1
    storm = _CTRL_FLIGHT["storm_after"]
    if (storm is not None and not _CTRL_FLIGHT["fired"]
            and _CTRL_FLIGHT["retries"] >= storm):
        _CTRL_FLIGHT["fired"] = True
        obs.flight_trigger("ctrl_storm", key="disagg:ctrl",
                           retries=_CTRL_FLIGHT["retries"],
                           storm_after=storm, last_msg=msg)


# -- wire format ------------------------------------------------------------
@dataclass(frozen=True)
class KVWireFormat:
    """Byte layout of a decode worker's host KV mirror — the contract both
    ends slice against. The mirror is the CANONICAL dense slot layout
    ``[L, n_slots, S_max, Hkv, D]`` float32 regardless of model stack (the
    MoE cache maps its [W, B_loc] grid to flat slot ids at import), so
    prefill and decode stacks only need matching model dims, not matching
    cache layouts. Pure host math — numpy-only."""

    n_layers: int
    n_slots: int
    max_seq: int
    n_kv_heads: int
    head_dim: int
    itemsize: int = 4

    @property
    def row_bytes(self) -> int:
        return self.n_kv_heads * self.head_dim * self.itemsize

    def pool_shape(self) -> Tuple[int, ...]:
        return (self.n_layers, self.n_slots, self.max_seq,
                self.n_kv_heads, self.head_dim)

    def pool_nbytes(self) -> int:
        n = 1
        for d in self.pool_shape():
            n *= d
        return n * self.itemsize

    def spans(self, slot: int, lo: int, hi: int) -> List[Tuple[int, int]]:
        """Per-layer ``(offset_bytes, length_bytes)`` of rows [lo, hi) of
        ``slot`` inside one pool array (K or V — same layout)."""
        if not (0 <= lo < hi <= self.max_seq):
            raise ValueError(f"rows [{lo}, {hi}) outside [0, {self.max_seq})")
        if not (0 <= slot < self.n_slots):
            raise ValueError(f"slot {slot} outside pool of {self.n_slots}")
        out = []
        for layer in range(self.n_layers):
            base = ((layer * self.n_slots + slot) * self.max_seq + lo)
            out.append((base * self.row_bytes, (hi - lo) * self.row_bytes))
        return out

    def to_meta(self) -> Dict:
        return {
            "n_layers": self.n_layers, "n_slots": self.n_slots,
            "max_seq": self.max_seq, "n_kv_heads": self.n_kv_heads,
            "head_dim": self.head_dim, "itemsize": self.itemsize,
        }

    @staticmethod
    def from_meta(meta: Dict) -> "KVWireFormat":
        return KVWireFormat(**{k: int(v) for k, v in meta.items()})


def _model_dims(backend) -> Dict[str, int]:
    """(n_layers, n_kv_heads, head_dim) of a serving backend — DenseBackend
    carries its config, MoEBackend's lives on its server."""
    cfg = getattr(backend, "cfg", None)
    if cfg is None:
        cfg = backend.server.cfg
    return {"n_layers": cfg.n_layers, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim}


def _on_card(backend) -> bool:
    """Does a serving backend's KV pool live on the card? (An MoE pool
    maps its [W, B_loc] grid onto the flat slot layout; a host stub has
    no pool.)"""
    cache = getattr(backend, "cache", None)
    cache = cache.flat() if hasattr(cache, "flat") else cache
    return cache is not None and cache.k.device.type == "cuda"


def _host_mirror(fmt: KVWireFormat, backend) -> np.ndarray:
    """A zeroed host mirror of the pool in the wire layout: pinned host
    memory when the backend's pool is on the card, so the import's
    host-to-device copy runs at the pinned rate."""
    import torch

    return torch.zeros(fmt.pool_shape(), dtype=torch.float32,
                       pin_memory=_on_card(backend)).numpy()


def wire_format_for(backend) -> KVWireFormat:
    """The wire format describing ``backend``'s slot pool as a mirror."""
    return KVWireFormat(n_slots=backend.n_slots, max_seq=backend.max_seq,
                        itemsize=np.dtype(KV_DTYPE).itemsize,
                        **_model_dims(backend))


# -- control plane ----------------------------------------------------------
def _send_msg(ep, conn: int, msg: Dict) -> None:
    rate = _CTRL_DROP["rate"]
    if rate and msg.get("t") in _DROPPABLE \
            and _CTRL_DROP["rng"].random() < rate:
        _CTRL_DROPPED.inc(msg=str(msg.get("t")))
        return
    ep.send_notif(conn, json.dumps(msg).encode())


def _drain_msgs(ep) -> List[Tuple[int, Dict]]:
    return [(conn, json.loads(raw.decode()))
            for conn, raw in ep.get_notifs()]


def _b64(raw: bytes) -> str:
    return base64.b64encode(raw).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s.encode())


# -- prefill side -----------------------------------------------------------
@dataclass
class _TxStream:
    """Prefill-side per-request stream state."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int]
    t_submit_wall: float
    trace: Optional["obs.TraceContext"] = None  # rides BEGIN verbatim
    begin_msg: Optional[Dict] = None  # resent verbatim until GRANTed
    t_begin_sent: float = 0.0  # monotonic mark of the last BEGIN tx
    t_admit_wall: Optional[float] = None
    t_done_wall: Optional[float] = None
    slabs: List[Tuple[int, int, np.ndarray, np.ndarray]] = field(
        default_factory=list)  # (lo, hi, k, v) exported, awaiting ship
    remote_slot: Optional[int] = None  # GRANTed decode-side slot
    xids: List[int] = field(default_factory=list)
    n_shipped: int = 0
    flow_emitted: bool = False  # the one flow-start per request went out
    first_token: Optional[int] = None
    done: bool = False  # prefill finished (first token known)
    cache_hit_len: int = 0  # rows reused from the prefix cache


class _ChunkFanout:
    """One prefill engine's chunk sink shared by several
    :class:`PrefillWorker` bonds — the N×M plane: each bond
    streams to a DIFFERENT decode worker over its own conn. Every bond
    sees every event and picks up only the rids it opened (``_on_chunks``
    drops unknown rids; a rid is submitted through exactly one bond), so
    no slab is ever exported or shipped twice."""

    def __init__(self):
        self.sinks: List = []

    def __call__(self, events) -> None:
        for s in self.sinks:
            s(events)


class PrefillWorker:
    """The prefill-fleet role: a chunked-prefill ``ServingEngine`` whose
    per-chunk KV output streams to one decode worker as it is computed.

    The engine must run ``prefill_chunk=C`` (the streaming granularity) and
    may carry a ``PrefixCache`` — cache-hit slabs ship without having been
    recomputed. Submissions go through :meth:`submit` (which opens the
    stream); drive the loop with :meth:`step` until :meth:`idle`.
    """

    def __init__(self, engine: ServingEngine, ep, ip: str, port: int,
                 *, timeout_ms: int = 30000,
                 heartbeat_s: Optional[float] = 0.5,
                 ctrl_retry_s: float = 0.5):
        _init_prefill_worker(self, engine, ep, ep.connect(ip, port),
                             timeout_ms=timeout_ms,
                             heartbeat_s=heartbeat_s,
                             ctrl_retry_s=ctrl_retry_s)

    # -- submission ----------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               priority: str = "interactive",
               tenant: str = "default",
               trace=None) -> Optional[Request]:
        """Open a KV stream and queue the prompt on the prefill engine
        (``max_new_tokens=1`` locally — this fleet never decodes; the
        requested budget rides the BEGIN message to the decode side).
        ``priority`` orders this fleet's own prefill queue (when its
        engine runs priority classes) and rides BEGIN so the adopted
        request keeps its class label decode-side. ``tenant`` rides the
        same way: it namespaces this fleet's prefix cache AND labels the
        decode side's adoption, so fleet-merged per-tenant series stay
        truthful across the process split. ``trace`` carries a
        router-minted :class:`~uccl_tpu_torch.obs.TraceContext` (None mints one
        here); it rides BEGIN verbatim so the decode side's spans join the
        same fleet-wide timeline. Returns the local Request, or None on
        queue backpressure."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        ctx = trace if trace is not None else obs.new_context()
        req = self.engine.submit(prompt, max_new_tokens=1,
                                 priority=priority, tenant=tenant,
                                 trace=ctx)
        if req is None:
            return None
        st = _TxStream(req.rid, prompt, max_new_tokens, eos_id,
                       t_submit_wall=time.time(), trace=ctx)
        self._streams[req.rid] = st
        st.begin_msg = {
            "t": "begin", "rid": req.rid, "prompt": prompt.tolist(),
            "max_new_tokens": max_new_tokens, "eos_id": eos_id,
            "priority": priority, "tenant": tenant,
            "t_submit": st.t_submit_wall,
            "trace": ctx.to_wire(),
        }
        st.t_begin_sent = time.monotonic()
        _send_msg(self.ep, self.conn, st.begin_msg)
        return req

    # -- engine hook ---------------------------------------------------
    def _on_chunks(self, events: List[ChunkEvent]) -> None:
        """Export every newly valid KV slab to host NOW (the slot may be
        freed/parked at this step's retirement) and queue it for the wire;
        cache-hit copies (``reused=True``) ship exactly like computed
        chunks — the decode side needs all rows either way."""
        for ev in events:
            st = self._streams.get(ev.req.rid)
            if st is None:
                continue  # warmup / non-streamed submission
            if st.t_admit_wall is None and ev.req.t_admit is not None:
                # back-date to the engine's admission mark (the first
                # event arrives AFTER the first chunk's compute — stamping
                # now() would misfile that compute under queue time)
                st.t_admit_wall = time.time() - max(
                    0.0, now() - ev.req.t_admit
                )
            with obs.span("kv_stream.export", track="wire", slot=ev.slot,
                          lo=ev.lo, hi=ev.hi, reused=ev.reused):
                k, v = self.engine.backend.export_slot_kv(
                    ev.slot, ev.lo, ev.hi
                )
            st.slabs.append((ev.lo, ev.hi, k, v))
            if ev.reused:
                st.cache_hit_len = max(st.cache_hit_len, ev.hi)
            if ev.done:
                st.done = True
                st.first_token = ev.first_token
                st.t_done_wall = time.time()

    # -- the pump ------------------------------------------------------
    def _ship(self, st: _TxStream) -> None:
        fifos_k, fifos_v = self._fifo_k, self._fifo_v
        for lo, hi, k, v in st.slabs:
            spans = self.fmt.spans(st.remote_slot, lo, hi)
            srcs = ([np.ascontiguousarray(k[layer])
                     for layer in range(self.fmt.n_layers)]
                    + [np.ascontiguousarray(v[layer])
                       for layer in range(self.fmt.n_layers)])
            fifos = ([fifos_k.slice(off, ln).pack() for off, ln in spans]
                     + [fifos_v.slice(off, ln).pack() for off, ln in spans])
            tr = obs.get_tracer()
            t0 = tr.now_us() if tr is not None else 0.0
            if self.chan is not None:
                # windowed SACK transport: the whole slab batch is ONE
                # selective-repeat transfer (loss recovered inside, pull
                # credit gates issue) — delivered when this returns, so
                # FINAL needs no per-xid waits for these slabs
                self.chan.writev(srcs, fifos, timeout_ms=self._timeout_ms)
            else:
                st.xids.extend(
                    self.ep.writev_async(self.conn, srcs, fifos)
                )
            if tr is not None:
                dur = tr.now_us() - t0
                tr.complete("kv_stream.tx", t0, dur, "wire", rid=st.rid,
                            slot=st.remote_slot, lo=lo, hi=hi,
                            bytes=sum(s.nbytes for s in srcs),
                            trace_id=(st.trace.trace_id
                                      if st.trace else None))
                if st.trace is not None and not st.flow_emitted:
                    # ONE flow-start per request, timestamped INSIDE the
                    # first tx span so Perfetto binds the arrow to it; the
                    # decode side's matching flow-finish sits inside its
                    # kv_stream.import span (same derived id, no extra
                    # coordination — the id IS the trace_id)
                    tr.flow("kv_handoff", "s",
                            obs.flow_id(st.trace.trace_id), "wire",
                            ts_us=t0 + dur / 2.0)
                    st.flow_emitted = True
            st.n_shipped += 1
            _STREAM_CHUNKS.inc(role="tx")
        st.slabs.clear()

    def adoption_backpressure(self) -> int:
        """Requests stuck waiting for decode-side capacity, as this worker
        can best estimate it: streams whose BEGIN has no GRANT yet (local,
        always current) vs the decode peer's own reported pending depth as
        of the last GRANT (covers OTHER prefill workers sharing the peer
        under fan-in) — the larger of the two, since each is a lower bound
        on the same backlog. 0 means the peer grants as fast as we BEGIN —
        the router's steering signal (serving/router.py)."""
        ungranted = sum(1 for st in self._streams.values()
                        if st.remote_slot is None)
        hinted = (self.decode_hint["queued"]
                  if self.decode_hint is not None else 0)
        return max(ungranted, hinted)

    def pump(self) -> None:
        """Drain GRANTs/acks, retry unanswered control messages, ship
        queued slabs, close finished streams (wait for every slab's
        completion, then send FINAL — writes and notifs share the conn,
        so the decode side sees all rows before FINAL).

        The control plane is LOSS-TOLERANT (docs/SERVING.md): a BEGIN
        with no GRANT inside ``ctrl_retry_s`` is resent verbatim (the
        decode side's rid-keyed dedup makes the retry idempotent — a
        lost GRANT never double-reserves), and a FINAL waits for an
        explicit ``final_ack`` and is resent until it lands (the decode
        side re-acks an already-adopted rid without re-adopting). Both
        retries count on ``disagg_ctrl_retries_total{msg}``."""
        now_m = time.monotonic()
        for _, msg in _drain_msgs(self.ep):
            if msg.get("t") == "grant":
                st = self._streams.get(msg["rid"])
                if st is not None:
                    st.remote_slot = int(msg["slot"])
                if "free" in msg:
                    self.decode_hint = {"free": int(msg["free"]),
                                        "queued": int(msg["queued"])}
            elif msg.get("t") == "final_ack":
                self._finaled.pop(int(msg["rid"]), None)
            elif msg.get("t") == "clock_pong":
                self._on_clock_pong(msg)
        if self.heartbeat_s is not None \
                and now_m - self._last_hb > self.heartbeat_s:
            self._last_hb = now_m
            _send_msg(self.ep, self.conn, {"t": "hb"})
        for st in self._streams.values():
            if (st.remote_slot is None
                    and now_m - st.t_begin_sent > self._ctrl_retry_s):
                # GRANT (or the BEGIN itself) lost: resend, idempotent
                st.t_begin_sent = now_m
                _note_ctrl_retry("begin")
                _send_msg(self.ep, self.conn, st.begin_msg)
            if st.remote_slot is not None and st.slabs:
                self._ship(st)
        for rid, st in list(self._streams.items()):
            if not (st.done and st.remote_slot is not None
                    and not st.slabs):
                continue
            for xid in st.xids:
                if not self.ep.wait(xid, self._timeout_ms):
                    obs.counter("p2p_transfer_failures_total").inc(
                        reason="kv_slab")
                    obs.instant("p2p_transfer_failed", track="wire",
                                reason="kv_slab", rid=rid)
                    raise IOError(
                        f"kv stream rid={rid}: slab write undelivered"
                    )
            final = {
                "t": "final", "rid": rid,
                "length": int(st.prompt.size),
                "first_token": int(st.first_token),
                "chunks": st.n_shipped,
                "cache_hit_len": st.cache_hit_len,
                "t_submit": st.t_submit_wall,
                "t_admit": st.t_admit_wall,
                "t_done": st.t_done_wall,
            }
            _send_msg(self.ep, self.conn, final)
            _STREAM_REQS.inc(role="tx")
            # await the decode side's final_ack; resent until it lands
            self._finaled[rid] = {"msg": final, "t_sent": now_m}
            del self._streams[rid]
        for rid, ent in self._finaled.items():
            if now_m - ent["t_sent"] > self._ctrl_retry_s:
                ent["t_sent"] = now_m
                _note_ctrl_retry("final")
                _send_msg(self.ep, self.conn, ent["msg"])

    def _send_clock_ping(self) -> None:
        self._clock_pings_left -= 1
        _send_msg(self.ep, self.conn, {
            "t": "clock_ping", "t0": time.time(),
            "mono_us": time.perf_counter() * 1e6,
        })

    def _on_clock_pong(self, msg: Dict) -> None:
        """Second leg of the HELLO clock exchange: the pong carries our
        ping's send time (t0) plus the peer's receive/send wall marks
        (t1/t2); with our receive time (t3) the RTT midpoint estimates the
        peer's wall-clock offset (obs/context.py). One round is not
        enough: the first ping can sit in the peer's notif queue across
        its compile warmup, inflating the RTT and (with it) the offset
        error bound of rtt/2 — so the exchange repeats a few rounds and
        keeps the MINIMUM-RTT estimate (the classic NTP clock filter).
        Each improvement goes BACK to the peer as ``clock_sync`` so the
        DECODE process records its own offset from the reference
        (prefill) clock in its trace metadata — scripts/trace_merge.py
        aligns on exactly that field."""
        t3 = time.time()
        offset_s, rtt_s = obs.estimate_clock_offset(
            float(msg["t0"]), float(msg["t1"]), float(msg["t2"]), t3
        )
        if self.clock_rtt_s is None or rtt_s < self.clock_rtt_s:
            self.clock_offset_s = offset_s
            self.clock_rtt_s = rtt_s
            # the reference process's own offset is 0 by definition;
            # record the measurement's provenance in this side's trace
            # metadata too
            obs.set_clock_offset(0.0, rtt_us=round(rtt_s * 1e6, 3),
                                 peer="decode", role="reference")
            _send_msg(self.ep, self.conn, {
                "t": "clock_sync",
                "offset_us": offset_s * 1e6,
                "rtt_us": rtt_s * 1e6,
            })
        if self._clock_pings_left > 0:
            self._send_clock_ping()

    def step(self) -> None:
        """One loop iteration: advance the engine (chunks export through
        the sink) then pump the wire."""
        if self.engine.has_work():
            self.engine.step()
        self.pump()

    def idle(self) -> bool:
        return (not self.engine.has_work() and not self._streams
                and not self._finaled)

    def outstanding(self) -> Dict[str, List[int]]:
        """What this worker is still waiting on, by kind — the structured
        face of a stuck drain (``ungranted`` BEGINs with no GRANT,
        ``granted`` streams mid-ship, ``unacked_final`` FINALs with no
        ack): a timeout names these instead of raising context-free."""
        return {
            "ungranted": sorted(rid for rid, st in self._streams.items()
                                if st.remote_slot is None),
            "granted": sorted(rid for rid, st in self._streams.items()
                              if st.remote_slot is not None),
            "unacked_final": sorted(self._finaled),
        }

    def drain(self, timeout_s: float = 120.0) -> None:
        deadline = time.monotonic() + timeout_s
        while not self.idle():
            if time.monotonic() > deadline:
                _DRAIN_TIMEOUTS.inc(role="prefill")
                out = self.outstanding()
                obs.instant("drain_timeout", track="wire", role="prefill",
                            **{k: len(v) for k, v in out.items()})
                raise TimeoutError(
                    f"prefill drain stalled after {timeout_s}s: "
                    f"ungranted BEGINs rid={out['ungranted']}, "
                    f"granted streams mid-ship rid={out['granted']}, "
                    f"unacked FINALs rid={out['unacked_final']}, "
                    f"engine queued={self.engine.sched.qsize} "
                    f"active={len(self.engine._by_slot)}"
                )
            self.step()
            if not self.engine.has_work():
                time.sleep(0.001)  # waiting on grants/completions only

    def close(self) -> None:
        _send_msg(self.ep, self.conn, {"t": "bye"})


# -- decode side ------------------------------------------------------------
class DecodeWorker:
    """The decode-fleet role: a ``ServingEngine`` whose requests arrive as
    KV streams. BEGIN reserves a slot (deferred under a full pool — the
    GRANT is the admission backpressure), streamed slabs land one-sided in
    the registered host mirror, FINAL imports rows [0, plen) into the
    engine's device cache and ``adopt()``s the request.

    **Lease-guarded grants** (docs/SERVING.md): with ``grant_lease_s``
    a GRANT is a *lease*, not a gift — if the stream's FINAL does not
    land before expiry (the prefill peer died post-GRANT, or its FINAL
    is lost forever), the reserved slot is reclaimed into the pool,
    counted on ``disagg_leases_expired_total{reason}``, and a late
    FINAL for the expired stream is dropped (``disagg_stale_finals_
    total``) instead of importing into the slot's new occupant. BEGINs
    are **idempotent** by (conn, rid): a retried BEGIN whose GRANT was
    lost re-answers with the SAME slot (counted ``disagg_ctrl_retries_
    total{msg="grant"}``) and never double-reserves; a retried FINAL
    after adoption re-acks without re-adopting. ``detector`` plugs a
    :class:`~uccl_tpu_torch.serving.health.FailureDetector` under the conn
    set — every control notif counts as a heartbeat (plus explicit hb
    messages from a ``heartbeat_s`` prefill worker), and a conn going
    DEAD expires its leases immediately (reason="peer_dead").
    """

    def __init__(self, engine: ServingEngine, ep,
                 pull_rate_bps: Optional[float] = None,
                 grant_lease_s: Optional[float] = None,
                 detector=None):
        self.engine = engine
        self.ep = ep
        self.grant_lease_s = grant_lease_s
        self.detector = detector
        self._pending_keys: set = set()  # (conn, rid) of queued BEGINs
        # settled-stream dedup windows, insertion-ordered and BOUNDED: a
        # retried BEGIN/FINAL only arrives within the sender's retry
        # horizon, so a long-lived decode worker must not accumulate one
        # key per request forever — past the cap the oldest settles for
        # good (a duplicate for an evicted key would raise as unknown,
        # which by then is the right answer)
        self._adopted_keys: Dict[Tuple[int, int], None] = {}
        self._expired_leases: Dict[Tuple[int, int], None] = {}
        self._settled_cap = 4096
        self.fmt = wire_format_for(engine.backend)
        self.mirror_k = _host_mirror(self.fmt, engine.backend)
        self.mirror_v = _host_mirror(self.fmt, engine.backend)
        self._mr_k = ep.reg(self.mirror_k)
        self._mr_v = ep.reg(self.mirror_v)
        # EQDS receiver-driven credit at disagg fan-in (docs/EQDS.md): the
        # GRANT already bounds concurrent inbound streams (slot admission
        # — "half of EQDS"); pull_rate_bps adds the other half, a
        # PullPacer granting byte credit across ALL attached inbound
        # channels at this decode worker's known drain rate, so N prefill
        # workers cannot burst past the fan-in link. Only active for
        # prefill workers attached over the channel transport with
        # pull=True (add_local_prefill).
        self.channels: List[object] = []
        self._pacer = None
        if pull_rate_bps:
            from uccl_tpu_torch.p2p.eqds import PullPacer

            self._pacer = PullPacer(pull_rate_bps)
        self._pending: Deque[Tuple[int, Dict]] = deque()
        self._granted: Dict[Tuple[int, int], Dict] = {}  # (conn, rid) -> st
        self._finished: List[Request] = []
        self.origin: Dict[int, Tuple[int, int]] = {}  # local rid -> (conn, remote rid)
        # closed = EVERY attached prefill conn said BYE (per-conn counting:
        # under N-to-1 fan-in one worker closing must not strand the rest)
        self.closed = False
        self._n_conns = 0
        self._n_byes = 0
        # this process's wall offset from the reference (prefill) clock,
        # as estimated by the peer's clock exchange (None until synced;
        # under fan-in the last sync wins — all peers measure the same
        # two clocks)
        self.clock_offset_us: Optional[float] = None
        self.clock_rtt_us: Optional[float] = None

    @property
    def port(self) -> int:
        return self.ep.port

    def attach(self, timeout_ms: int = 30000) -> int:
        """Accept one prefill worker and hand it the pool descriptors."""
        conn = self.ep.accept(timeout_ms=timeout_ms)
        return self._finish_attach(conn)

    def attach_channel(self, timeout_ms: int = 30000,
                       chunk_bytes: Optional[int] = None):
        """Accept one prefill worker dialing over a multipath
        :class:`~uccl_tpu_torch.p2p.channel.Channel` (the windowed SACK
        transport): KV slabs arrive as windowed chunk sprays instead of
        raw writev, control notifs ride the channel's path-0 conn, and —
        when this worker was built with ``pull_rate_bps`` — the channel
        attaches to the receiver-driven credit pacer, making the decode
        side the incast actuator. Returns the server-side Channel."""
        from uccl_tpu_torch.p2p.channel import Channel

        chan = Channel.accept(self.ep, timeout_ms=timeout_ms,
                              chunk_bytes=chunk_bytes)
        self.channels.append(chan)
        if self._pacer is not None:
            self._pacer.attach(chan)
            self._pacer.start()
        self._finish_attach(chan.conns[0])
        return chan

    def _finish_attach(self, conn: int) -> int:
        self._n_conns += 1
        # a conn attaching AFTER earlier conns all said BYE re-opens the
        # decoder (sequential fan-in must not inherit a stale closed flag)
        self.closed = self._n_byes >= self._n_conns
        if self.detector is not None:
            self.detector.register(conn)
        self.ep.send(conn, json.dumps({
            "t": "hello", "fmt": self.fmt.to_meta(),
            "k_fifo": _b64(self.ep.advertise(self._mr_k)),
            "v_fifo": _b64(self.ep.advertise(self._mr_v)),
        }).encode())
        return conn

    def close(self) -> None:
        """Stop the credit pacer (with a final flush so in-flight senders
        finish) and close attached channels (their conns + probe/credit
        registrations on this worker's endpoint). The endpoint itself
        stays open — it was handed in by the caller, who owns it."""
        if self._pacer is not None:
            self._pacer.stop(flush_bytes=self.fmt.pool_nbytes())
            self._pacer = None
        for chan in self.channels:
            try:
                chan.close()
            except Exception:
                pass  # peer already gone
        self.channels = []

    def _settle(self, window: Dict, key: Tuple[int, int]) -> None:
        window[key] = None
        while len(window) > self._settled_cap:
            window.pop(next(iter(window)))

    # -- control-plane handling ----------------------------------------
    def poll(self) -> None:
        for conn, msg in _drain_msgs(self.ep):
            kind = msg.get("t")
            if self.detector is not None:
                # ANY control traffic proves the peer alive; hb messages
                # exist so an idle peer still proves it
                self.detector.heartbeat(conn)
            if kind == "hb":
                continue
            if kind == "begin":
                key = (conn, int(msg["rid"]))
                granted = self._granted.get(key)
                if granted is not None:
                    # retried BEGIN whose GRANT was lost: idempotent —
                    # re-answer with the SAME slot, never re-reserve.
                    # Contact also RENEWS the lease (and lifts any
                    # quarantine): the retry proves the sender never had
                    # a grant, so nothing was ever shipped at this slot
                    # — the lease clock restarts from a real exchange,
                    # not from the first (lost) GRANT
                    granted["t_grant"] = time.monotonic()
                    granted.pop("expired", None)
                    _note_ctrl_retry("grant")
                    _send_msg(self.ep, conn, {
                        "t": "grant", "rid": key[1],
                        "slot": granted["slot"],
                        "free": self.engine.pool.n_free,
                        "queued": len(self._pending),
                    })
                    continue
                if key in self._expired_leases:
                    # the old incarnation was reclaimed, yet the sender
                    # is STILL asking to begin — it never held a grant
                    # (it only retries while ungranted), so nothing of
                    # the old stream was ever shipped: treat it as a
                    # fresh stream instead of wedging the retry loop
                    self._expired_leases.pop(key, None)
                if (key in self._pending_keys
                        or key in self._adopted_keys):
                    continue  # duplicate of a queued/settled stream
                self._pending_keys.add(key)
                self._pending.append((conn, msg))
            elif kind == "final":
                self._on_final(conn, msg)
            elif kind == "clock_ping":
                # timestamp on arrival AND on reply: the gap between the
                # two is the peer-side processing time the RTT-midpoint
                # formula subtracts out
                t1 = time.time()
                _send_msg(self.ep, conn, {
                    "t": "clock_pong", "t0": msg["t0"], "t1": t1,
                    "t2": time.time(),
                    "mono_us": time.perf_counter() * 1e6,
                    "wall_us": t1 * 1e6,
                })
            elif kind == "clock_sync":
                self.clock_offset_us = float(msg["offset_us"])
                self.clock_rtt_us = float(msg["rtt_us"])
                obs.set_clock_offset(self.clock_offset_us,
                                     rtt_us=round(self.clock_rtt_us, 3),
                                     peer="prefill", role="synced")
            elif kind == "bye":
                self._n_byes += 1
                self.closed = self._n_byes >= self._n_conns
        if self.detector is not None:
            self.detector.tick()
        self._expire_leases()
        self._try_grant()

    def _expire_leases(self) -> None:
        """Reclaim GRANTed slots whose stream never FINALed: past the
        lease (reason=timeout), or the moment the granting conn's peer
        is declared DEAD by the failure detector (reason=peer_dead).
        The reclaimed slot returns to the pool — the decode side never
        leaks capacity to a dead prefill worker — and the stream key is
        remembered so a late FINAL is dropped, not imported.

        One hazard needs care: a peer that is provably ALIVE (still
        heartbeating) but stalled mid-ship may still be one-sided-
        writing slabs into the slot's mirror rows — freeing the slot now
        would hand those rows to a new occupant mid-write. So with a
        detector attached, a timed-out lease on a live conn is
        **quarantined** instead: the expiry is counted (the lease DID
        lapse) but the slot stays reserved until the stream terminates
        (its FINAL arrives and is dropped as stale), the peer dies, or a
        retried BEGIN renews the lease (nothing was ever shipped — the
        poll handler's renewal path). Without a detector the decode side
        cannot tell alive from dead and frees at timeout — size
        ``grant_lease_s`` above the worst-case ship stall there, or run
        heartbeats + a detector (the default pairing)."""
        if self.grant_lease_s is None and self.detector is None:
            return
        now_m = time.monotonic()
        for key, st in list(self._granted.items()):
            dead_peer = False
            if self.detector is not None:
                try:
                    dead_peer = self.detector.state(key[0]) == _PEER_DEAD
                except KeyError:
                    pass
            overdue = (self.grant_lease_s is not None
                       and now_m - st["t_grant"] > self.grant_lease_s)
            if dead_peer:
                self._reclaim(key, st, "peer_dead")
            elif overdue:
                if self.detector is not None:
                    if not st.get("expired"):
                        st["expired"] = True
                        _LEASES_EXPIRED.inc(reason="timeout")
                        trace = st.get("trace")
                        obs.instant(
                            "lease_expired", track="wire", conn=key[0],
                            rid=key[1], slot=st["slot"],
                            reason="timeout", quarantined=True,
                            trace_id=(trace.trace_id if trace
                                      else None))
                else:
                    self._reclaim(key, st, "timeout")

    def _reclaim(self, key, st, reason: str) -> None:
        """Actually free a granted slot and settle the stream key (late
        FINALs drop). Counts the expiry unless quarantine already did."""
        del self._granted[key]
        self._settle(self._expired_leases, key)
        self.engine.pool.free(st["slot"])
        if not st.get("expired"):
            _LEASES_EXPIRED.inc(reason=reason)
        trace = st.get("trace")
        obs.instant("lease_reclaimed", track="wire", conn=key[0],
                    rid=key[1], slot=st["slot"], reason=reason,
                    trace_id=trace.trace_id if trace else None)

    def _try_grant(self) -> None:
        while self._pending:
            conn, msg = self._pending[0]
            slot = self.engine.pool.admit(int(msg["rid"]))
            if slot is None:
                break  # pool full: BEGINs wait (admission backpressure)
            self._pending.popleft()
            self._pending_keys.discard((conn, int(msg["rid"])))
            trace = obs.TraceContext.from_wire(msg.get("trace"))
            self._granted[(conn, int(msg["rid"]))] = {
                # monotonic: the lease is a purely LOCAL interval (never
                # crosses the wire), and a wall-clock step (NTP, VM
                # resume) must not spuriously expire every live lease
                "slot": slot, "msg": msg, "t_grant": time.monotonic(),
                "trace": trace,
            }
            obs.instant("grant", track="wire", rid=int(msg["rid"]),
                        slot=slot,
                        trace_id=trace.trace_id if trace else None)
            # capacity hints ride every GRANT (the adoption-backpressure
            # feed, docs/SERVING.md): free decode slots AFTER this grant
            # and the BEGINs still waiting for one — the prefill side
            # surfaces them so a router steers new prompts away from a
            # saturated decode peer
            _send_msg(self.ep, conn, {
                "t": "grant", "rid": int(msg["rid"]), "slot": slot,
                "free": self.engine.pool.n_free,
                "queued": len(self._pending),
            })

    def _on_final(self, conn: int, final: Dict) -> None:
        key = (conn, int(final["rid"]))
        if key in self._adopted_keys:
            # retried FINAL (our ack was lost): re-ack, never re-adopt
            _send_msg(self.ep, conn, {"t": "final_ack", "rid": key[1]})
            return
        if key in self._expired_leases:
            # the lease already reclaimed this stream's slot — importing
            # now would corrupt the slot's new occupant. Ack it anyway so
            # the sender stops retrying a stream the fleet gave up on.
            _STALE_FINALS.inc()
            obs.instant("stale_final", track="wire", conn=conn,
                        rid=key[1])
            _send_msg(self.ep, conn, {"t": "final_ack", "rid": key[1]})
            return
        quarantined = self._granted.get(key)
        if quarantined is not None and quarantined.get("expired"):
            # a QUARANTINED lease's stream just terminated: this FINAL is
            # the last thing the stream will ever write, so the slot is
            # finally safe to free — but the lease lapsed long ago, so
            # the request itself is dropped as stale, never adopted
            _STALE_FINALS.inc()
            obs.instant("stale_final", track="wire", conn=conn,
                        rid=key[1], quarantined=True)
            self._reclaim(key, quarantined, "timeout")
            _send_msg(self.ep, conn, {"t": "final_ack", "rid": key[1]})
            return
        st = self._granted.pop(key, None)
        if st is None:
            raise KeyError(
                f"FINAL for unknown stream rid={final['rid']} (no BEGIN "
                "grant recorded)"
            )
        slot, begin, trace = st["slot"], st["msg"], st["trace"]
        plen = int(final["length"])
        # full S_max rows: rows past plen are dead (masked attention), and
        # the fixed shape keeps every import on one compiled program
        k_rows = self.mirror_k[:, slot, :]
        v_rows = self.mirror_v[:, slot, :]
        tr = obs.get_tracer()
        ts0 = tr.now_us() if tr is not None else 0.0
        self.engine.backend.import_slot_kv(
            slot, k_rows, v_rows, length=plen
        )
        if tr is not None:
            dur = tr.now_us() - ts0
            tr.complete("kv_stream.import", ts0, dur, "wire", slot=slot,
                        rows=plen, chunks=int(final["chunks"]),
                        trace_id=trace.trace_id if trace else None)
            if trace is not None:
                # the flow-finish matching the prefill side's flow-start:
                # same derived id, timestamped inside this import span so
                # the merged trace renders one arrow tx -> import
                tr.flow("kv_handoff", "f", obs.flow_id(trace.trace_id),
                        "wire", ts_us=ts0 + dur / 2.0)
        _STREAM_CHUNKS.inc(int(final["chunks"]), role="rx")
        _STREAM_REQS.inc(role="rx")
        t_adopt = time.time()
        t_submit, t_admit, t_done = (final["t_submit"], final["t_admit"],
                                     final["t_done"])
        req = self.engine.adopt(
            np.asarray(begin["prompt"], np.int32),
            int(final["first_token"]),
            max_new_tokens=int(begin["max_new_tokens"]),
            eos_id=begin["eos_id"], slot=slot,
            priority=begin.get("priority", "interactive"),
            tenant=begin.get("tenant", "default"),
            queue_s=t_admit - t_submit, prefill_s=t_done - t_admit,
            transfer_s=t_adopt - t_done,
            trace=trace,
        )
        req.cache_hit_len = int(final.get("cache_hit_len", 0))
        self.origin[req.rid] = (conn, int(final["rid"]))
        self._settle(self._adopted_keys, key)
        _send_msg(self.ep, conn, {"t": "final_ack", "rid": key[1]})
        if req.is_done():  # max_new_tokens == 1 or EOS at the first token
            self._finished.append(req)

    def step(self) -> List[Request]:
        """One loop iteration: drain control messages, run one engine
        step when there is decode work. Returns requests finished now."""
        self.poll()
        out, self._finished = self._finished, []
        if self.engine.has_work():
            out.extend(self.engine.step())
        return out

    def serve(self, n_requests: Optional[int] = None,
              timeout_s: float = 300.0) -> List[Request]:
        """Loop until ``n_requests`` finished (or the peer said BYE and
        everything drained). The example/bench decode processes run this."""
        done: List[Request] = []
        deadline = time.monotonic() + timeout_s
        while True:
            done.extend(self.step())
            if n_requests is not None and len(done) >= n_requests:
                return done
            if (self.closed and not self.engine.has_work()
                    and not self._pending and not self._granted):
                return done
            if not self.engine.has_work():
                time.sleep(0.001)
            if time.monotonic() > deadline:
                _DRAIN_TIMEOUTS.inc(role="decode")
                open_keys = sorted(self._granted)
                pending = sorted((c, int(m["rid"]))
                                 for c, m in self._pending)
                obs.instant("drain_timeout", track="wire", role="decode",
                            granted=len(open_keys), pending=len(pending))
                raise TimeoutError(
                    f"decode serve stalled after {timeout_s}s at "
                    f"{len(done)} finished: granted-unFINALed "
                    f"(conn,rid)={open_keys}, queued BEGINs "
                    f"(conn,rid)={pending}, engine "
                    f"active={len(self.engine._by_slot)}"
                )


# -- shared one-shot reference + in-process pair helpers --------------------
def oneshot_reference(params, cfg, prompt, new_tokens: int, max_seq: int):
    """The single-worker greedy continuation the disaggregated pair is
    checked against (prefill + decode_step loop). Returns host tokens
    [B, new_tokens]."""
    import torch

    from uccl_tpu_torch.models.inference import prefill

    logits, cache = prefill(params, prompt, cfg, max_seq)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return decode_continue(params, cfg, cache, tok, new_tokens)


def decode_continue(params, cfg, cache, first_tok, new_tokens: int):
    """Continue ``new_tokens`` greedy steps from a warm cache + first
    token (the decode leg of the one-shot reference). Returns host tokens
    [B, new_tokens]."""
    import torch

    from uccl_tpu_torch.models.inference import decode_step

    tok = torch.as_tensor(np.asarray(first_tok) if not torch.is_tensor(first_tok)
                          else first_tok).to(torch.int32)
    toks = [tok.cpu().numpy()]
    for _ in range(new_tokens - 1):
        logits, cache = decode_step(params, tok, cache, cfg)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok.cpu().numpy())
    return np.stack(toks, axis=1)


def make_local_pair(prefill_engine: ServingEngine,
                    decode_engine: ServingEngine,
                    *,
                    transport: str = "ep",
                    pull_rate_bps: Optional[float] = None,
                    grant_lease_s: Optional[float] = None,
                    detector=None,
                    **transport_kw) -> Tuple[PrefillWorker, DecodeWorker]:
    """Both roles in ONE process over loopback endpoints — the in-process
    harness tests and benches drive (the example runs the same classes in
    two real processes). ``transport``/``pull_rate_bps``/extras route the
    KV plane over the windowed Channel transport (add_local_prefill);
    ``grant_lease_s``/``detector`` arm the decode side's lease guard and
    failure detector (docs/SERVING.md fault tolerance)."""
    from uccl_tpu_torch.p2p import Endpoint

    dw = DecodeWorker(decode_engine, Endpoint(),
                      pull_rate_bps=pull_rate_bps,
                      grant_lease_s=grant_lease_s, detector=detector)
    return add_local_prefill(dw, prefill_engine, transport=transport,
                             **transport_kw), dw


def add_local_prefill(dw: DecodeWorker,
                      prefill_engine: ServingEngine,
                      *,
                      transport: str = "ep",
                      n_paths: int = 2,
                      chunk_bytes: Optional[int] = None,
                      pull: bool = False,
                      window_cc: Optional[str] = None,
                      heartbeat_s: Optional[float] = 0.5,
                      ctrl_retry_s: float = 0.5) -> PrefillWorker:
    """Attach one more in-process prefill worker to ``dw`` — the loopback
    fan-in arrangement (N prefill engines streaming into one decode pool;
    each stream is its own conn, so GRANT/FINAL bookkeeping stays
    per-(conn, rid) and workers never see each other's slots).

    ``transport="channel"`` dials a multipath
    :class:`~uccl_tpu_torch.p2p.channel.Channel` instead of a bare conn: KV
    slabs ride the windowed SACK transport (selective repeat, per-path
    quality steering, loss/reorder-proof), ``pull=True`` gates slab issue
    on the decode worker's receiver-driven credit (requires ``dw`` built
    with ``pull_rate_bps``), and ``window_cc`` ("timely"|"swift") runs
    sender-side window CC off per-chunk completion RTTs."""
    from uccl_tpu_torch.p2p import Endpoint

    ep_p = Endpoint()
    pw = PrefillWorker.__new__(PrefillWorker)
    if transport == "channel":
        import threading

        from uccl_tpu_torch.p2p.channel import Channel

        res: Dict[str, object] = {}

        def _accept():
            try:
                res["chan"] = dw.attach_channel(chunk_bytes=chunk_bytes)
            except Exception as e:  # surfaced below, not swallowed
                res["err"] = e

        t = threading.Thread(target=_accept)
        t.start()
        chan = Channel.connect(ep_p, "127.0.0.1", dw.ep.port,
                               n_paths=n_paths, chunk_bytes=chunk_bytes)
        t.join(timeout=30)
        if "err" in res:
            raise res["err"]  # the real accept-side failure, with traceback
        if "chan" not in res:
            raise TimeoutError("decode side never accepted the channel")
        if pull:
            if dw._pacer is None:
                raise ValueError(
                    "pull=True needs a DecodeWorker(pull_rate_bps=...)"
                )
            chan.enable_pull_sender()
        if window_cc:
            chan.enable_window_cc(window_cc)
        _init_prefill_worker(pw, prefill_engine, ep_p, chan.conns[0],
                             chan=chan, heartbeat_s=heartbeat_s,
                             ctrl_retry_s=ctrl_retry_s)
    elif transport == "ep":
        # loopback: connect() completes against the listening endpoint
        # before accept() is called (the test_p2p pair idiom)
        conn_p = ep_p.connect("127.0.0.1", dw.ep.port)
        dw.attach()
        _init_prefill_worker(pw, prefill_engine, ep_p, conn_p,
                             heartbeat_s=heartbeat_s,
                             ctrl_retry_s=ctrl_retry_s)
    else:
        raise ValueError(f"unknown transport {transport!r}")
    return pw


def _init_prefill_worker(pw: PrefillWorker, engine: ServingEngine, ep,
                         conn: int, timeout_ms: int = 30000,
                         chan=None, heartbeat_s: Optional[float] = 0.5,
                         ctrl_retry_s: float = 0.5) -> None:
    """PrefillWorker init against an already-open conn (the local-pair
    path, where connect must precede the peer's accept). ``chan`` routes
    KV slabs over the windowed multipath Channel transport (conn must be
    its path-0 conn — the notif/control path). ``heartbeat_s`` sends a
    liveness hb notif at that interval (the decode side's failure
    detector feeds off it; ON by default — a detector-armed decode peer
    would otherwise age an idle-but-healthy conn to DEAD, and one tiny
    notif per interval is free; None disables); ``ctrl_retry_s`` is the
    control-plane retransmission window (BEGIN without GRANT, FINAL
    without ack)."""
    if engine.prefill_chunk is None:
        raise ValueError("PrefillWorker needs a chunked engine")
    sink = engine.chunk_sink
    if sink is None:
        sink = _ChunkFanout()
    elif not isinstance(sink, _ChunkFanout):
        raise ValueError("engine already has a chunk_sink")
    hello = json.loads(ep.recv(conn, timeout_ms=timeout_ms))
    assert hello.get("t") == "hello", hello
    from uccl_tpu_torch.p2p.channel import FifoItem

    pw.engine = engine
    pw.ep = ep
    pw.conn = conn
    pw.chan = chan
    pw.fmt = KVWireFormat.from_meta(hello["fmt"])
    dims = _model_dims(engine.backend)
    dims["max_seq"] = engine.backend.max_seq
    for k, v in dims.items():
        if getattr(pw.fmt, k) != v:
            raise ValueError(
                f"decode pool {k}={getattr(pw.fmt, k)} != prefill "
                f"backend {k}={v}: the KV slabs would not line up"
            )
    pw._fifo_k = FifoItem.unpack(_unb64(hello["k_fifo"]))
    pw._fifo_v = FifoItem.unpack(_unb64(hello["v_fifo"]))
    pw._streams = {}
    pw._finaled = {}  # rid -> FINAL awaiting the decode side's ack
    pw._timeout_ms = timeout_ms
    pw._ctrl_retry_s = ctrl_retry_s
    pw.heartbeat_s = heartbeat_s
    pw._last_hb = time.monotonic()
    # decode-peer capacity as of the last GRANT (free slots + pending
    # BEGIN depth) — feeds adoption_backpressure() / the replica router
    pw.decode_hint = None
    # clock exchange (docs/OBSERVABILITY.md): the first ping rides a
    # notif right after HELLO and its pong comes back through the regular
    # pump, so the exchange needs no extra blocking recv (the in-process
    # loopback pair pumps both sides from one thread); follow-up rounds
    # refine the estimate by minimum RTT (_on_clock_pong). None until the
    # first pong lands.
    pw.clock_offset_s = None  # estimated decode_wall - prefill_wall
    pw.clock_rtt_s = None
    pw._clock_pings_left = 8
    pw._send_clock_ping()
    sink.sinks.append(pw._on_chunks)
    engine.chunk_sink = sink


def drive_pair(pw: PrefillWorker, dw: DecodeWorker, prompts, arrivals,
               max_new_tokens: int, eos_id: Optional[int] = None,
               timeout_s: float = 300.0) -> Tuple[List[Request], float]:
    """Submit ``prompts`` at their Poisson ``arrivals`` offsets and step
    both workers until every accepted request finishes on the decode side.
    Returns (decode-side finished Requests, wall seconds) — the disagg
    analog of ``loadgen.drive``."""
    finished: List[Request] = []
    i, n = 0, len(prompts)
    accepted = 0
    t0 = now()
    deadline = time.monotonic() + timeout_s
    while i < n or not pw.idle() or len(finished) < accepted:
        t = now() - t0
        while i < n and arrivals[i] <= t:
            if pw.submit(prompts[i], max_new_tokens=max_new_tokens,
                         eos_id=eos_id) is not None:
                accepted += 1
            i += 1
        pw.step()
        finished.extend(dw.step())
        if not pw.engine.has_work() and not dw.engine.has_work():
            time.sleep(0.0005)
        if time.monotonic() > deadline:
            _DRAIN_TIMEOUTS.inc(role="pair")
            out = pw.outstanding()
            raise TimeoutError(
                f"disagg drive stalled after {timeout_s}s: "
                f"{len(finished)}/{accepted} finished; prefill side "
                f"ungranted rid={out['ungranted']} granted "
                f"rid={out['granted']} unacked-final "
                f"rid={out['unacked_final']}; decode side granted "
                f"(conn,rid)={sorted(dw._granted)}"
            )
    return finished, now() - t0


def warm_pair(pw: PrefillWorker, dw: DecodeWorker, prompt_len: int,
              new_tokens: int = 2) -> None:
    """One dummy request through the whole stream: compiles the prefill
    chunk program, the decode program, and touches every wire path — then
    zeroes both engines' metrics and clears the prefix cache (warmup
    prompts must not act as donors). Counters stay cumulative; benches
    snapshot deltas around each arm."""
    reps = 2 if pw.engine.prefix_cache is not None else 1
    for _ in range(reps):  # rep 2 hits the parked rep-1 donor: compiles
        pw.submit(np.zeros(max(1, prompt_len), np.int32),  # the copy path
                  max_new_tokens=max(2, new_tokens))
        got: List[Request] = []
        deadline = time.monotonic() + 120.0
        while len(got) < 1:
            pw.step()
            got.extend(dw.step())
            if time.monotonic() > deadline:
                _DRAIN_TIMEOUTS.inc(role="pair")
                out = pw.outstanding()
                raise TimeoutError(
                    f"disagg warmup stalled after 120s: prefill "
                    f"ungranted rid={out['ungranted']} granted "
                    f"rid={out['granted']} unacked-final "
                    f"rid={out['unacked_final']}; decode granted "
                    f"(conn,rid)={sorted(dw._granted)}"
                )
    pw.drain()
    if pw.engine.prefix_cache is not None:
        pw.engine.prefix_cache.clear(pw.engine.pool)
    pw.engine.reset_metrics()
    dw.engine.reset_metrics()
    from uccl_tpu_torch.serving.loadgen import _clear_warmup_trace

    _clear_warmup_trace()
