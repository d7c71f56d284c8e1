"""Congestion control for the DCN engine: Timely and Swift rate controllers.

Port of ``uccl_tpu/p2p/cc.py`` (host state machines, copied).

TPU-native re-design of the reference's pluggable CC layer
(include/cc/timely.h:49 TimelyCC — RTT-gradient rate control, SIGCOMM'15;
include/cc/swift.h:42 SwiftCC — delay-target cwnd, SIGCOMM'20). On the DCN
engine the actuator is the endpoint's token-bucket pacer
(``Endpoint.set_rate_limit``) rather than per-QP pacing; the sensor is the
measured completion RTT of chunk transfers. The algorithms themselves are
pure-python, unit-testable state machines — same role as the reference's
header-only CC classes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from uccl_tpu_torch.utils.logging import get_logger

_log = get_logger("P2P")


@dataclasses.dataclass
class TimelyCC:
    """RTT-gradient rate control.

    Rate increases additively while RTT gradients are flat/negative, and
    decreases multiplicatively proportional to the normalized gradient when
    RTTs grow (the HAI/gradient scheme of the paper, as in the reference's
    include/cc/timely.h parameter block :20-26).
    """

    min_rtt_us: float = 50.0
    t_low_us: float = 100.0
    t_high_us: float = 5000.0
    add_step: float = 10e6  # additive increase, bytes/s
    beta: float = 0.8  # multiplicative decrease factor
    ewma_alpha: float = 0.46
    rate: float = 100e6  # current rate, bytes/s
    max_rate: float = 12.5e9
    min_rate: float = 1e6

    _prev_rtt: Optional[float] = None
    _gradient: float = 0.0
    _hai_count: int = 0

    def on_rtt(self, rtt_us: float) -> float:
        """Feed one RTT sample; returns the new rate (bytes/s)."""
        if self._prev_rtt is None:
            self._prev_rtt = rtt_us
            return self.rate
        delta = rtt_us - self._prev_rtt
        self._prev_rtt = rtt_us
        norm_grad = (
            self.ewma_alpha * (delta / self.min_rtt_us)
            + (1 - self.ewma_alpha) * self._gradient
        )
        self._gradient = norm_grad

        if rtt_us < self.t_low_us:
            self._hai_count += 1
            boost = 5 if self._hai_count >= 5 else 1
            self.rate += boost * self.add_step
        elif rtt_us > self.t_high_us:
            self._hai_count = 0
            self.rate *= 1 - self.beta * (1 - self.t_high_us / rtt_us)
        elif norm_grad <= 0:
            self._hai_count += 1
            boost = 5 if self._hai_count >= 5 else 1
            self.rate += boost * self.add_step
        else:
            self._hai_count = 0
            self.rate *= 1 - self.beta * min(norm_grad, 1.0)
        self.rate = min(max(self.rate, self.min_rate), self.max_rate)
        return self.rate


@dataclasses.dataclass
class SwiftCC:
    """Delay-target congestion window control (cwnd in bytes).

    AIMD around a target delay: grow additively when the measured delay is
    under target, back off multiplicatively (bounded per-RTT) when over —
    the reference's include/cc/swift.h scheme with flow-scaling omitted
    (single flow per channel here).
    """

    target_delay_us: float = 300.0
    additive_inc: float = 64 * 1024  # bytes per update under target
    beta: float = 0.7  # max multiplicative decrease
    cwnd: float = 1e6
    min_cwnd: float = 64 * 1024
    max_cwnd: float = 1e9

    _last_decrease: float = 0.0

    def on_delay(self, delay_us: float, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        if delay_us < self.target_delay_us:
            self.cwnd += self.additive_inc
        else:
            # at most one multiplicative decrease per RTT-ish interval
            if now - self._last_decrease > self.target_delay_us / 1e6:
                factor = max(
                    self.beta, 1 - (delay_us - self.target_delay_us) / delay_us
                )
                self.cwnd *= factor
                self._last_decrease = now
        self.cwnd = min(max(self.cwnd, self.min_cwnd), self.max_cwnd)
        return self.cwnd

    def rate_for_rtt(self, rtt_us: float) -> float:
        """bytes/s equivalent of the current window at the given RTT."""
        return self.cwnd / (max(rtt_us, 1.0) / 1e6)


class CongestionControl:
    """Window-bytes congestion-control protocol for the data path.

    The windowed channel sender (``Channel`` + :class:`~uccl_tpu_torch.p2p.sack.
    SackTxWindow`) gates NEW chunk issue on ``cwnd_bytes()`` and feeds the
    controller every chunk's **completion RTT** (``on_ack``) and every
    loss event (``on_loss`` — RTO fire or path death). Window-sized rather
    than rate-sized because the sender's actuator is "how many bytes may
    be un-acked", the same quantity Swift controls natively and the
    reference actuates per flow (include/cc/swift.h cwnd). Implementations
    are plain objects with these three methods — duck-typed, no inheritance
    required; this class just documents the contract.
    """

    def cwnd_bytes(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def on_ack(self, rtt_us: float, nbytes: int) -> None:  # pragma: no cover
        raise NotImplementedError

    def on_loss(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class WindowedSwift(CongestionControl):
    """Swift on the data path: the cwnd IS the sender window.

    Completion RTTs feed the delay-target AIMD directly (they include
    queueing on the path — the signal Swift wants); a loss event applies
    the multiplicative decrease, bounded to once per target-delay interval
    exactly like the over-target path (include/cc/swift.h's
    retransmit-triggered decrease)."""

    def __init__(self, swift: Optional[SwiftCC] = None,
                 loss_beta: float = 0.7):
        self.swift = swift if swift is not None else SwiftCC()
        self.loss_beta = loss_beta

    def cwnd_bytes(self) -> int:
        return int(self.swift.cwnd)

    def on_ack(self, rtt_us: float, nbytes: int) -> None:
        self.swift.on_delay(rtt_us)

    def on_loss(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        s = self.swift
        if now - s._last_decrease > s.target_delay_us / 1e6:
            s.cwnd = max(s.min_cwnd, s.cwnd * self.loss_beta)
            s._last_decrease = now

    def __repr__(self) -> str:
        return f"WindowedSwift(cwnd={int(self.swift.cwnd)})"


class WindowedTimely(CongestionControl):
    """Timely on the data path: rate control converted to a window.

    Timely emits a RATE; the sender needs a WINDOW. The bridge is the
    bandwidth-delay product of the controlled rate: ``cwnd = rate × srtt``
    (srtt EWMA'd from the same completion samples). Loss feeds the
    gradient an RTT pinned above ``t_high`` — the loss-IS-congestion
    stance ``CcController.tick`` already takes for the UDP wire — so
    multiplicative decrease engages even when surviving chunks look
    healthy."""

    def __init__(self, timely: Optional[TimelyCC] = None,
                 min_window: int = 64 * 1024, max_window: int = 1 << 30):
        self.timely = timely if timely is not None else TimelyCC()
        self.srtt_us = 0.0
        self.min_window = min_window
        self.max_window = max_window

    def cwnd_bytes(self) -> int:
        srtt = max(self.srtt_us, self.timely.min_rtt_us)
        w = self.timely.rate * srtt / 1e6
        return int(min(max(w, self.min_window), self.max_window))

    def on_ack(self, rtt_us: float, nbytes: int) -> None:
        self.srtt_us = (rtt_us if self.srtt_us == 0.0
                        else 0.875 * self.srtt_us + 0.125 * rtt_us)
        self.timely.on_rtt(rtt_us)

    def on_loss(self) -> None:
        self.timely.on_rtt(self.timely.t_high_us * 2.0)

    def __repr__(self) -> str:
        return (f"WindowedTimely(rate={self.timely.rate:.3g}, "
                f"cwnd={self.cwnd_bytes()})")


def make_window_cc(algo: Optional[str]) -> Optional[CongestionControl]:
    """Factory for the channel's data-path CC: "timely", "swift" or None
    (fixed window)."""
    if algo is None or algo in ("", "off", "none"):
        return None
    if algo == "timely":
        return WindowedTimely()
    if algo == "swift":
        return WindowedSwift()
    raise ValueError(f"unknown window cc algo {algo!r}")


class SwiftRateAdapter:
    """Feed delays to Swift; expose ``on_rtt`` for :class:`RateController`
    (the probe-thread path wants a rate). Lived inline in
    ``Channel.enable_cc`` before the windowed data path existed — it is
    controller-adapter logic and belongs beside RateController."""

    def __init__(self, swift: SwiftCC):
        self._s = swift
        self.rate = swift.rate_for_rtt(swift.target_delay_us)

    def on_rtt(self, rtt_us: float) -> float:
        self._s.on_delay(rtt_us)
        self.rate = self._s.rate_for_rtt(rtt_us)
        return self.rate


class RateController:
    """Wires a CC algorithm onto an Endpoint's pacer.

    Call :meth:`sample` with each chunk's completion RTT; the controller
    updates the endpoint's token-bucket rate every ``update_every`` samples.
    """

    def __init__(self, ep, algo: Optional[TimelyCC] = None, update_every: int = 4):
        self.ep = ep
        self.algo = algo if algo is not None else TimelyCC()
        self.update_every = update_every
        self._n = 0

    def sample(self, rtt_us: float) -> None:
        rate = self.algo.on_rtt(rtt_us)
        self._n += 1
        if self._n % self.update_every == 0:
            self.ep.set_rate_limit(int(rate))

    _PROBE = None

    def probe(
        self, conn_id: int, probe_fifo: bytes, timeout_ms: int = 1000
    ) -> float:
        """Measure network delay with a 1-byte one-sided write (ack round
        trip) and feed it to the controller. This is the right Timely signal:
        decoupled from transfer size and (nearly) from the pacer itself —
        feeding whole-transfer completion times instead creates a positive
        feedback loop where the pacer's own delay drives the rate to the
        floor.

        A probe that exceeds ``timeout_ms`` (loss, or a congested peer) is
        fed to the controller as an RTT of the full timeout — loss IS a
        congestion signal, and bounding the wait keeps a background CC
        thread live through drops.

        ``probe_fifo`` MUST reference a dedicated scratch window on the peer
        (e.g. ``peer.advertise(peer.reg(np.zeros(1, np.uint8)))``) — the
        probe genuinely writes one byte at its offset 0, so pointing it at a
        data window would clobber the first byte of real data."""
        import numpy as np

        if RateController._PROBE is None:
            RateController._PROBE = np.zeros(1, np.uint8)
        # reap probes that timed out earlier but completed/failed since (a
        # raise here must never propagate — it would kill a background CC
        # thread over a bookkeeping error)
        def _still_pending(x):
            try:
                if self.ep.poll_async(x) is None:
                    return True
            except Exception:
                pass  # terminal either way; fall through to reap
            reap = getattr(self.ep, "reap", None)
            if reap is not None:
                reap(x)  # drop the cached result nobody will wait() on
            return False
        self._stale = [x for x in getattr(self, "_stale", []) if _still_pending(x)]
        t0 = time.perf_counter()
        xid = self.ep.write_async(conn_id, RateController._PROBE, probe_fifo)
        if self.ep.wait(xid, timeout_ms):
            rtt_us = (time.perf_counter() - t0) * 1e6
        else:
            self._stale.append(xid)
            rtt_us = timeout_ms * 1000.0
        self.sample(rtt_us)
        return rtt_us

    def timed_write(self, conn_id: int, src, fifo) -> float:
        """Write and return the completion time in µs (diagnostic only — do
        NOT feed transfer completion times to Timely; see :meth:`probe`)."""
        t0 = time.perf_counter()
        self.ep.write(conn_id, src, fifo)
        return (time.perf_counter() - t0) * 1e6


class CcController:
    """Per-conn CC loop for the UDP wire — the configuration where the CC
    algorithms are genuinely load-bearing: the engine's datagram path has no
    kernel congestion control underneath, so the pacing rate this controller
    sets is the ONLY thing standing between the sender and real packet loss
    (reference: per-flow CC actuation through the EventOn* hooks,
    collective/rdma/transport.h:449-533).

    Sensor: the engine's in-protocol RTT EWMA (ack timestamp echoes,
    ``Endpoint.conn_stats``) — no probe traffic needed. Actuator:
    ``Endpoint.set_conn_rate``. Call :meth:`tick` periodically (e.g. every
    few ms from a transfer loop or a background thread).
    """

    def __init__(self, ep, conn_id: int, algo=None, min_rate: float = 1e6):
        self.ep = ep
        self.conn_id = conn_id
        self.algo = algo if algo is not None else TimelyCC()
        self.min_rate = min_rate
        self._last_rtx = 0

    def tick(self) -> Optional[float]:
        """Read transport stats, update the algorithm, actuate the per-conn
        rate. Returns the new rate (bytes/s) or None when there is no RTT
        signal yet. Retransmissions since the last tick count as a loss
        signal: the RTT fed to the algorithm is inflated toward t_high so
        multiplicative decrease engages even when the surviving packets'
        RTTs look healthy (loss-IS-congestion, the EQDS/Swift stance)."""
        st = self.ep.conn_stats(self.conn_id)
        rtt = st["rtt_us"]
        if rtt <= 0.0:
            return None
        new_rtx = st["pkts_rtx"] - self._last_rtx
        self._last_rtx = st["pkts_rtx"]
        if new_rtx > 0:
            t_high = getattr(
                self.algo, "t_high_us",
                getattr(self.algo, "target_delay_us", 5000.0) * 4,
            )
            rtt = max(rtt, t_high)
        if hasattr(self.algo, "on_rtt"):  # Timely: gradient rate control
            rate = self.algo.on_rtt(rtt)
        else:  # Swift: update the delay-target window, convert to a rate
            self.algo.on_delay(rtt)
            rate = self.algo.rate_for_rtt(rtt)
        rate = max(rate, self.min_rate)
        self.ep.set_conn_rate(self.conn_id, int(rate))
        return rate
