"""EQDS-style receiver-driven congestion control: the pull pacer.

Port of ``uccl_tpu/p2p/eqds.py`` (host code, copied).

The reference ships EQDS (include/cc/eqds.h; pacer thread
collective/rdma/eqds.h:93) — NSDI'22 receiver-driven credit, built for
incast: many senders converging on one receiver link, where sender-side
delay CC reacts a full RTT late. This is the credit half of the windowed
SACK transport (channel.py + sack.py): docs/EQDS.md records the measured
incast sweep where sender-side window CC collapses under loss while this
pacer holds goodput at the receiver's drain rate, and the disagg decode
worker runs it as the fan-in actuator (serving/disagg.py
``DecodeWorker(pull_rate_bps=...)``).

Mechanism (Channel-layer, wire-agnostic):

* every Channel minted a 1×uint64 **credit window** at setup (symmetric,
  like the CC probe window);
* a sender in pull mode (``chan.enable_pull_sender()``) issues a NEW chunk
  only once the receiver's CUMULATIVE grant covers it (the non-blocking
  credit gate inside ``Channel._run_window`` — retransmits are
  pre-licensed, and stalled wall time lands on
  ``p2p_credit_stall_seconds_total``) — the pull quantum, carried by an
  8-byte one-sided write instead of a pull packet;
* the receiver runs ONE :class:`PullPacer` for all inbound channels: a
  token bucket at the receiver's known link rate, split round-robin across
  active channels — the same fair pull schedule the reference's pacer
  computes, pointed at the receiver's own capacity (the EQDS premise: the
  receiver knows its downlink).

Grant writes ride each channel's isolated probe path, so credits never
queue behind striped data chunks or control messages.
"""

from __future__ import annotations

import threading
import time
from typing import List

from uccl_tpu_torch.utils.logging import get_logger

_log = get_logger("P2P")


class PullPacer:
    """Receiver-side credit scheduler over any number of inbound channels.

    ``rate_bytes_per_sec`` is the aggregate grant rate (the receiver's
    downlink budget); each tick mints ``rate * dt`` bytes of credit and
    splits them equally across attached channels (fair quanta). ``quantum``
    bounds per-tick growth so a long scheduler stall cannot mint one huge
    burst (EQDS's bounded credit backlog).
    """

    def __init__(
        self,
        rate_bytes_per_sec: float,
        tick_s: float = 0.002,
        quantum: int = 1 << 20,
    ):
        self.rate = float(rate_bytes_per_sec)
        self.tick_s = tick_s
        self.quantum = int(quantum)
        self._chans: List[object] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._residual = 0.0  # fractional bytes carried between ticks

    def attach(self, chan) -> None:
        """Start granting to this channel (its peer should be in pull mode)."""
        with self._lock:
            if chan not in self._chans:
                self._chans.append(chan)

    def detach(self, chan) -> None:
        with self._lock:
            if chan in self._chans:
                self._chans.remove(chan)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self, flush_bytes: int = 0) -> None:
        """Stop granting. ``flush_bytes`` > 0 hands every attached channel a
        final allowance so an in-flight sender can finish rather than stall
        at the exact moment the pacer goes away."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5)
        self._thread = None
        if flush_bytes:
            with self._lock:
                chans = list(self._chans)
            for c in chans:
                try:
                    c.grant_credit(flush_bytes)
                except Exception:
                    pass

    def _loop(self) -> None:
        last = time.monotonic()
        while not self._stop.wait(self.tick_s):
            now = time.monotonic()
            dt = now - last
            last = now
            with self._lock:
                chans = list(self._chans)
            if not chans:
                continue
            minted = min(self.rate * dt + self._residual,
                         float(self.quantum * len(chans)))
            share = int(minted // len(chans))
            self._residual = minted - share * len(chans)
            if share <= 0:
                continue
            for c in chans:
                try:
                    c.grant_credit(share)
                except Exception:
                    # a torn-down channel just stops receiving grants; the
                    # pacer must outlive individual flows
                    with self._lock:
                        if c in self._chans:
                            self._chans.remove(c)
