"""Cross-process trace context + clock-offset estimation.

Port copy of ``uccl_tpu/obs/context.py`` (jax-free there too).

The tracer gives every *process* a timeline; a fleet needs every
*request* to own one timeline across processes. Two host-only pieces,
both jax-free (the Dapper/W3C trace-context shape, PAPERS.md):

* :class:`TraceContext` — a ``trace_id`` (one per request, minted once at
  the ingress ``submit``/``Router.submit``) plus the minting side's
  ``span_id``. The context rides VERBATIM in the disagg BEGIN notif and
  is stamped onto every remote-side event, so a merged trace groups all
  of one request's spans under one id no matter which process emitted
  them. ``flow_id`` derives the Chrome-trace flow-event id from the
  trace_id, so the prefill-side ``kv_stream.tx`` span and the decode-side
  ``kv_stream.import`` span bind into one Perfetto arrow without any
  coordination beyond the id itself.
* :func:`estimate_clock_offset` — the NTP-style RTT-midpoint estimate the
  disagg HELLO handshake uses to relate two processes' wall clocks, so
  ``scripts/trace_merge.py`` can place both processes' events on one
  causally ordered timeline (no GRANT before its BEGIN).

Minting is counted on ``obs_trace_contexts_total`` so benches can stamp
how many request timelines an arm produced (a pure counter delta).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from uccl_tpu_torch.obs.counters import counter

__all__ = [
    "TraceContext", "new_context", "new_trace_id", "new_span_id",
    "flow_id", "estimate_clock_offset",
]

_MINTED = counter(
    "obs_trace_contexts_total",
    "trace contexts minted at request ingress (one per request timeline)",
)


def new_trace_id() -> str:
    """A 16-hex-char trace id (64 random bits — the W3C short form)."""
    return secrets.token_hex(8)


def new_span_id() -> str:
    """An 8-hex-char span id (32 random bits)."""
    return secrets.token_hex(4)


@dataclass(frozen=True)
class TraceContext:
    """One request's identity across processes: the trace id plus the
    minting side's root span id (the remote side's spans are children)."""

    trace_id: str
    span_id: str

    def to_wire(self) -> Dict[str, str]:
        """The JSON-ready form that rides control-plane notifs (BEGIN)."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @staticmethod
    def from_wire(d: Optional[Dict]) -> Optional["TraceContext"]:
        """Parse a wire dict; None (or a malformed dict) yields None —
        a peer without trace context must not break the control plane."""
        if not isinstance(d, dict):
            return None
        tid, sid = d.get("trace_id"), d.get("span_id")
        if not tid or not sid:
            return None
        return TraceContext(str(tid), str(sid))


def new_context() -> TraceContext:
    """Mint a fresh context (counted on ``obs_trace_contexts_total``)."""
    _MINTED.inc()
    return TraceContext(new_trace_id(), new_span_id())


def flow_id(trace_id: str) -> int:
    """Deterministic Chrome-trace flow-event id for a trace id: both
    processes derive the SAME id from the id that already crossed the
    wire, so the s/f pair binds with no extra coordination. 60 bits keeps
    the JSON integer exact in every double-based parser."""
    return int(trace_id[:15], 16)


def estimate_clock_offset(t0: float, t1: float, t2: float, t3: float
                          ) -> Tuple[float, float]:
    """RTT-midpoint clock-offset estimate (the NTP formula).

    ``t0``/``t3`` are the LOCAL clock at ping send / pong receive;
    ``t1``/``t2`` are the PEER clock at ping receive / pong send. Returns
    ``(offset, rtt)`` in the inputs' units, where ``offset`` estimates
    ``peer_clock - local_clock`` and ``rtt`` is the network round trip
    excluding the peer's processing time. The estimate is exact under
    symmetric path delays; an asymmetric path biases it by at most
    ``rtt / 2`` (the classic bound — tested in tests/test_trace_fleet.py).
    """
    rtt = (t3 - t0) - (t2 - t1)
    offset = ((t1 - t0) + (t2 - t3)) / 2.0
    return offset, rtt
