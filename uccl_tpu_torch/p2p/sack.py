"""Selective-repeat SACK sender window for the multipath channel.

Port of ``uccl_tpu/p2p/sack.py`` (a host state machine, copied).

The paper's transport pillar (PAPER.md §0.1) re-expressed at chunk
granularity: a transfer's chunks get per-chunk sequence numbers and a
bounded in-flight window; per-chunk completion acks (the engine's
kWriteAck, arriving out of order across paths) drive **cumulative ack +
SACK** state exactly like the native UDP wire's packet layer
(native/src/engine.cc udp_send_ack / pcb.h in the reference:
snd_una/rcv_nxt + kSackBitmapSize bitmaps) — and that state drives
*selective repeat*: after ``dupack_k`` later-sequence acks land while an
earlier chunk is still outstanding, exactly that chunk fast-retransmits;
chunks nothing vouches for retransmit on an RTO with exponential backoff
(Jacobson srtt/rttvar, Karn's rule for samples). A per-path delivery EWMA
steers both retransmits and new chunks away from lossy/slow paths instead
of the old blind ``(ci + attempt) % n_paths`` rotation.

Pure host state machine — no transport calls, no threads — so the whole
window logic is property-testable in microseconds (tests/test_sack.py).
:class:`uccl_tpu_torch.p2p.channel.Channel` owns the transport loop that feeds
it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

# (re)transmission kinds, as exported on p2p_channel_retx_total{kind=}
NEW = "new"
FAST = "fast"  # SACK-gap fast retransmit after dupack_k duplicate acks
RTO = "rto"    # retransmission timeout (exponential backoff) / path death

# Flight-recorder arming (docs/OBSERVABILITY.md). Both thresholds are
# process-wide and default OFF: a handful of retransmits is the normal
# cost of a lossy path, not a pathology. A chaos arm (or a deployment
# that knows its loss budget) arms them; every subsequently created
# window then fires AT MOST one ``retx_storm`` / ``rto_backoff`` flight
# trigger, carrying its own stats() as the post-mortem context.
_FLIGHT = {"storm_after": None, "rto_backoff_s": None}


def arm_flight(storm_after: Optional[int] = None,
               rto_backoff_s: Optional[float] = None) -> None:
    """Arm (or with Nones, disarm) the transport flight triggers:
    ``storm_after`` = total retransmits within ONE window that count as
    a storm; ``rto_backoff_s`` = a backed-off per-chunk RTO this large
    means sustained loss/blackout rather than isolated drops."""
    _FLIGHT["storm_after"] = storm_after
    _FLIGHT["rto_backoff_s"] = rto_backoff_s


def flight_armed() -> Dict[str, Optional[float]]:
    return dict(_FLIGHT)


class PathQuality:
    """Per-path delivery EWMA + smoothed RTT + in-flight load.

    ``score`` is an EWMA of delivery outcomes in [0, 1] (ack → toward 1,
    loss → toward 0). New chunks go to the path maximizing
    ``score / (1 + inflight)`` — quality-weighted load balancing that
    degenerates to round-robin on healthy symmetric paths and starves a
    lossy path in proportion to its loss. Retransmits go to the
    best-scoring path *other than* the one that just lost the chunk.
    """

    def __init__(self, n_paths: int, alpha: float = 0.25):
        if n_paths < 1:
            raise ValueError("need at least one path")
        self.alpha = alpha
        self.score = [1.0] * n_paths
        self.srtt_us = [0.0] * n_paths
        self.inflight = [0] * n_paths

    @property
    def n_paths(self) -> int:
        return len(self.score)

    def on_sent(self, path: int) -> None:
        self.inflight[path] += 1

    def on_ack(self, path: int, rtt_us: Optional[float] = None) -> None:
        self.inflight[path] = max(0, self.inflight[path] - 1)
        self.score[path] += self.alpha * (1.0 - self.score[path])
        if rtt_us is not None:
            s = self.srtt_us[path]
            self.srtt_us[path] = (
                rtt_us if s == 0.0 else 0.875 * s + 0.125 * rtt_us
            )

    def on_loss(self, path: int) -> None:
        self.inflight[path] = max(0, self.inflight[path] - 1)
        self.score[path] *= 1.0 - self.alpha

    def pick_new(self) -> int:
        best, best_w = 0, -1.0
        for i in range(self.n_paths):
            w = self.score[i] / (1.0 + self.inflight[i])
            if w > best_w:
                best, best_w = i, w
        return best

    def pick_retx(self, avoid: int) -> int:
        if self.n_paths == 1:
            return 0
        best, best_w = -1, -1.0
        for i in range(self.n_paths):
            if i == avoid:
                continue
            # prefer quality; break ties toward the less-loaded path
            w = self.score[i] / (1.0 + self.inflight[i])
            if w > best_w:
                best, best_w = i, w
        return best


@dataclasses.dataclass
class _Chunk:
    seq: int
    nbytes: int
    acked: bool = False
    n_tx: int = 0
    t_last_tx: float = -1.0     # monotonic seconds of last (re)transmission
    last_path: int = -1
    dupacks: int = 0            # later-seq acks seen while outstanding
    fast_pending: bool = False  # marked for SACK-gap fast retransmit
    err_pending: bool = False   # transport error (path died): reissue now


class SackTxWindow:
    """Sender-side selective-repeat window over a fixed chunk list.

    Drive it with::

        win = SackTxWindow([len0, len1, ...], n_paths=4)
        while not win.done():
            for seq, kind in win.sendable(now, cwnd_bytes):
                path = win.pick_path(seq, kind)
                ...issue chunk seq on path...
                win.mark_sent(seq, path, kind, now)
            ...observe completions...
            win.on_ack(seq, path=path, rtt_us=rtt, now=now)

    ``max_tx`` bounds per-chunk attempts; once a chunk is *due* again with
    no attempts left it lands in :meth:`exhausted` and the caller fails
    the transfer. RTT samples follow Karn's rule (first transmissions
    only) into Jacobson srtt/rttvar; the RTO backs off 2× per attempt.
    """

    def __init__(
        self,
        sizes: Sequence[int],
        n_paths: int,
        *,
        max_tx: int = 3,
        dupack_k: int = 3,
        rto_init_s: float = 0.2,
        rto_min_s: float = 0.025,
        rto_max_s: float = 2.0,
    ):
        if max_tx < 1:
            raise ValueError("max_tx must be >= 1")
        self.chunks = [_Chunk(i, int(n)) for i, n in enumerate(sizes)]
        self.paths = PathQuality(n_paths)
        self.max_tx = max_tx
        self.dupack_k = dupack_k
        self.rto_min_s = rto_min_s
        self.rto_max_s = rto_max_s
        self.rto_s = min(max(rto_init_s, rto_min_s), rto_max_s)
        self.srtt_us = 0.0
        self.rttvar_us = 0.0
        self.cum_ack = 0        # every seq < cum_ack is acked
        self.acks = 0
        self.retx_fast = 0
        self.retx_rto = 0
        self._next_new = 0
        self._inflight_bytes = 0  # sent & un-acked, kept incrementally
        self._flight_fired = set()  # trigger kinds already fired here

    # -- progress --------------------------------------------------------
    def done(self) -> bool:
        return self.cum_ack >= len(self.chunks)

    def inflight_bytes(self) -> int:
        # maintained incrementally (mark_sent/on_ack) — sendable() runs
        # every transfer-loop tick, so a full O(chunks) sum here would
        # dominate large transfers' sender CPU
        return self._inflight_bytes

    def _backoff_rto(self, c: _Chunk) -> float:
        return min(self.rto_s * (2 ** (c.n_tx - 1)), self.rto_max_s)

    # -- receiver-view introspection (mirrors the native ack packet) -----
    def sack_bitmap(self, width: int = 64) -> int:
        """Bit ``rel-1`` set for acked seq ``cum_ack + rel`` (rel ≥ 1) —
        the same layout the native UDP wire puts on its ack packets."""
        bm = 0
        for rel in range(1, width + 1):
            s = self.cum_ack + rel
            if s < len(self.chunks) and self.chunks[s].acked:
                bm |= 1 << (rel - 1)
        return bm

    # -- events ----------------------------------------------------------
    def on_ack(
        self,
        seq: int,
        *,
        now: float,
        path: Optional[int] = None,
        rtt_us: Optional[float] = None,
    ) -> bool:
        """One chunk's delivery confirmed. Returns False for duplicate /
        stale acks (late completion of a superseded attempt)."""
        c = self.chunks[seq]
        if c.acked:
            # stale completion of a superseded attempt: no score/RTT
            # credit, but the attempt leaves the wire — balance the
            # per-path in-flight load term or steering would be biased
            # against the path for the rest of the transfer
            if path is not None:
                self.paths.inflight[path] = max(
                    0, self.paths.inflight[path] - 1)
            return False
        c.acked = True
        c.fast_pending = False
        c.err_pending = False
        self._inflight_bytes -= c.nbytes
        self.acks += 1
        first_tx = c.n_tx <= 1
        if path is not None:
            # Karn's rule: a retransmitted chunk's completion time is
            # ambiguous (which attempt got through?) — no RTT sample.
            self.paths.on_ack(path, rtt_us if first_tx else None)
        if rtt_us is not None and first_tx:
            self._rtt_sample(rtt_us)
        while (self.cum_ack < len(self.chunks)
               and self.chunks[self.cum_ack].acked):
            self.cum_ack += 1
        # Duplicate-ack bookkeeping: this completion is out-of-order
        # evidence against every earlier-sent, still-outstanding chunk
        # below it — after dupack_k such acks the gap chunk fast-retxes
        # (at most once per transmission: mark_sent resets the count).
        for h in self.chunks[self.cum_ack:seq]:
            if h.acked or h.n_tx == 0 or h.fast_pending or h.err_pending:
                continue
            if h.t_last_tx <= c.t_last_tx:
                h.dupacks += 1
                if h.dupacks >= self.dupack_k and h.n_tx < self.max_tx:
                    h.fast_pending = True
        return True

    def on_error(self, seq: int, path: int, now: float,
                 t_sent: Optional[float] = None) -> None:
        """The attempt's transport failed terminally (conn died): count
        the loss against the path and reissue without waiting for RTO.
        ``t_sent`` (the failed attempt's issue time) lets a SUPERSEDED
        attempt's late error charge the path without forcing another
        retransmission — a newer attempt is already in flight, and
        burning an extra n_tx here can exhaust max_tx on a chunk that
        was about to be delivered."""
        c = self.chunks[seq]
        if c.acked:
            self.paths.inflight[path] = max(0, self.paths.inflight[path] - 1)
            return
        self.paths.on_loss(path)
        if t_sent is not None and t_sent < c.t_last_tx:
            return  # stale attempt: the live one owns recovery
        if not c.fast_pending:
            c.err_pending = True

    def _rtt_sample(self, rtt_us: float) -> None:
        if self.srtt_us == 0.0:
            self.srtt_us = rtt_us
            self.rttvar_us = rtt_us / 2.0
        else:
            self.rttvar_us = (0.75 * self.rttvar_us
                              + 0.25 * abs(self.srtt_us - rtt_us))
            self.srtt_us = 0.875 * self.srtt_us + 0.125 * rtt_us
        self.rto_s = min(
            max((self.srtt_us + 4.0 * self.rttvar_us) / 1e6, self.rto_min_s),
            self.rto_max_s,
        )

    # -- scheduling ------------------------------------------------------
    def sendable(self, now: float, cwnd_bytes: int) -> List[Tuple[int, str]]:
        """(seq, kind) list to issue now: fast retransmits first (the SACK
        gaps), then RTO-due chunks, then new chunks while in-flight bytes
        fit ``cwnd_bytes``. Retransmits are exempt from the window gate
        (loss means the window has room); at least one chunk is always
        eligible when nothing is in flight, so a collapsed window can
        never livelock a transfer."""
        out: List[Tuple[int, str]] = []
        for c in self.chunks:
            if c.acked or c.n_tx == 0 or c.n_tx >= self.max_tx:
                continue
            if c.fast_pending:
                out.append((c.seq, FAST))
            elif c.err_pending:
                out.append((c.seq, RTO))
            elif now - c.t_last_tx > self._backoff_rto(c):
                out.append((c.seq, RTO))
        infl = self.inflight_bytes()
        i = self._next_new
        while i < len(self.chunks):
            c = self.chunks[i]
            if infl > 0 and infl + c.nbytes > cwnd_bytes:
                break
            out.append((c.seq, NEW))
            infl += c.nbytes
            i += 1
        return out

    def pick_path(self, seq: int, kind: str) -> int:
        if kind == NEW:
            return self.paths.pick_new()
        return self.paths.pick_retx(avoid=self.chunks[seq].last_path)

    def mark_sent(self, seq: int, path: int, kind: str, now: float) -> None:
        c = self.chunks[seq]
        if kind == NEW:
            self._next_new = max(self._next_new, seq + 1)
            self._inflight_bytes += c.nbytes
        else:
            # the previous attempt is now presumed lost on its path
            if not c.err_pending:  # on_error already charged the loss
                self.paths.on_loss(c.last_path)
            if kind == FAST:
                self.retx_fast += 1
            else:
                self.retx_rto += 1
                # the RTO that just expired for this attempt — past the
                # armed ceiling it is a blackout, not a drop
                limit = _FLIGHT["rto_backoff_s"]
                if (limit is not None
                        and self._backoff_rto(c) >= limit):
                    self._fire_flight("rto_backoff", seq=seq, path=path,
                                      backoff_s=self._backoff_rto(c),
                                      backoff_limit_s=limit)
            storm = _FLIGHT["storm_after"]
            if (storm is not None
                    and self.retx_fast + self.retx_rto >= storm):
                self._fire_flight("retx_storm", seq=seq, path=path,
                                  storm_after=storm)
        c.n_tx += 1
        c.t_last_tx = now
        c.last_path = path
        c.dupacks = 0
        c.fast_pending = False
        c.err_pending = False
        self.paths.on_sent(path)

    def _fire_flight(self, kind: str, **ctx) -> None:
        """At most one flight dump per (window, kind) locally, and the
        PROCESS-WIDE key ``sack:<kind>`` dedupes across windows too —
        one sustained loss episode spans many transfer windows, and one
        post-mortem per fault class is the recorder's contract (later
        windows' storms are counted suppressed, not dumped). Context
        carries the full window stats so the bundle is self-sufficient
        even when no transport provider is registered."""
        if kind in self._flight_fired:
            return
        self._flight_fired.add(kind)
        from uccl_tpu_torch.obs import flight as _flight_mod

        _flight_mod.trigger(kind, key=f"sack:{kind}",
                            **ctx, **self.stats())

    def exhausted(self, now: float) -> List[int]:
        """Chunks due for another transmission with no attempts left —
        non-empty means the transfer has failed."""
        out = []
        for c in self.chunks:
            if c.acked or c.n_tx < self.max_tx:
                continue
            if (c.fast_pending or c.err_pending
                    or now - c.t_last_tx > self._backoff_rto(c)):
                out.append(c.seq)
        return out

    # -- introspection ---------------------------------------------------
    def stats(self) -> Dict[str, object]:
        return {
            "chunks": len(self.chunks),
            "cum_ack": self.cum_ack,
            "acks": self.acks,
            "retx_fast": self.retx_fast,
            "retx_rto": self.retx_rto,
            "srtt_us": round(self.srtt_us, 3),
            "rto_ms": round(self.rto_s * 1e3, 3),
            "inflight_bytes": self.inflight_bytes(),
            "path_scores": [round(s, 4) for s in self.paths.score],
        }
