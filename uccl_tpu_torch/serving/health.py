"""Fleet failure detection: heartbeat/lease liveness for serving peers.

Port copy of ``uccl_tpu/serving/health.py`` (jax-free there too). A
:class:`FailureDetector` runs the per-peer **HEALTHY -> SUSPECT -> DEAD**
state machine off heartbeats, or, for in-process replicas (the Router's
engines), off a liveness probe called at every :meth:`tick` whose ``True``
counts as a heartbeat. A peer silent for ``suspect_after_s`` is SUSPECT
(excluded from new routing, not yet recovered); silent for
``dead_after_s`` it is DEAD, terminal for the registration (re-admit a
returning peer by re-registering it). A SUSPECT peer that heartbeats
returns to HEALTHY.

Telemetry: ``fleet_peer_state{peer}`` (0 healthy, 1 suspect, 2 dead),
``fleet_heartbeats_total{peer}``, ``serving_recovered_total{outcome}``, and
``peer_suspect`` / ``peer_dead`` trace instants.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from uccl_tpu_torch import obs
from uccl_tpu_torch.utils.logging import get_logger

_log = get_logger("UTIL")

HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"

_STATE_CODE = {HEALTHY: 0, SUSPECT: 1, DEAD: 2}

_PEER_STATE = obs.gauge(
    "fleet_peer_state",
    "failure-detector state per peer (0=healthy, 1=suspect, 2=dead)",
)
_HEARTBEATS = obs.counter(
    "fleet_heartbeats_total",
    "heartbeats observed per peer (notif-borne hb messages, or "
    "in-process liveness probes returning alive)",
)
_RECOVERED = obs.counter(
    "serving_recovered_total",
    "requests recovered off a DEAD replica by outcome: "
    "resubmitted (was queued — re-queued on a survivor under the same "
    "trace_id), restarted (was active — re-run from scratch on a "
    "survivor), lost (no survivor could take it, counted into the "
    "conservation invariant's `lost` term)",
)


@dataclass
class _Peer:
    name: str
    t_last: float
    state: str = HEALTHY
    probe: Optional[Callable[[], bool]] = None
    transitions: List[Tuple[str, float]] = field(default_factory=list)


class FailureDetector:
    """Per-peer HEALTHY→SUSPECT→DEAD liveness off heartbeats or probes.

    ``suspect_after_s`` is the silence that makes a peer SUSPECT (routing
    exclusion), ``dead_after_s`` the silence that makes it DEAD (recovery
    fires). The gap between the two is the **suspect grace window**: a
    peer that resumes heartbeating inside it returns to HEALTHY with no
    recovery churn. ``clock`` is injectable (monotonic seconds) so tests
    drive transitions without sleeping.
    """

    def __init__(self, *, suspect_after_s: float = 0.5,
                 dead_after_s: float = 1.5,
                 clock: Callable[[], float] = time.monotonic):
        if suspect_after_s <= 0:
            raise ValueError(
                f"suspect_after_s must be > 0, got {suspect_after_s}"
            )
        if dead_after_s <= suspect_after_s:
            raise ValueError(
                f"dead_after_s ({dead_after_s}) must exceed "
                f"suspect_after_s ({suspect_after_s}): the grace window "
                "is what keeps a slow peer from flapping straight to DEAD"
            )
        self.suspect_after_s = suspect_after_s
        self.dead_after_s = dead_after_s
        self._clock = clock
        self._peers: Dict[str, _Peer] = {}

    # -- membership ----------------------------------------------------
    def register(self, peer, probe: Optional[Callable[[], bool]] = None,
                 ) -> None:
        """Start tracking ``peer`` (any hashable — str()'d for labels),
        initially HEALTHY with a fresh heartbeat. ``probe`` makes it an
        in-process peer: each :meth:`tick` calls it, and ``True`` counts
        as a heartbeat (the Router's replica liveness equivalent).
        Re-registering an existing peer resets it to HEALTHY — the
        explicit resurrection path for a returning peer."""
        name = str(peer)
        self._peers[name] = _Peer(name, self._clock(), probe=probe)
        _PEER_STATE.set(0, peer=name)

    def deregister(self, peer) -> None:
        self._peers.pop(str(peer), None)

    def peers(self) -> List[str]:
        return list(self._peers)

    def state(self, peer) -> str:
        return self._peers[str(peer)].state

    def is_routable(self, peer) -> bool:
        """Only HEALTHY peers take new work (SUSPECT is excluded but not
        yet recovered; DEAD is gone)."""
        p = self._peers.get(str(peer))
        return p is not None and p.state == HEALTHY

    # -- liveness feeds ------------------------------------------------
    def heartbeat(self, peer, t: Optional[float] = None) -> None:
        """Record one heartbeat from ``peer`` (a notif-borne hb, or any
        control message proving liveness). A SUSPECT peer returns to
        HEALTHY; a DEAD peer stays dead (terminal per registration —
        its state was already recovered elsewhere)."""
        p = self._peers.get(str(peer))
        if p is None:
            return  # unknown peer: late hb after deregistration
        _HEARTBEATS.inc(peer=p.name)
        if p.state == DEAD:
            return
        p.t_last = t if t is not None else self._clock()
        if p.state == SUSPECT:
            p.state = HEALTHY
            p.transitions.append((HEALTHY, p.t_last))
            _PEER_STATE.set(0, peer=p.name)

    def tick(self, t: Optional[float] = None) -> List[Tuple[str, str]]:
        """Advance every peer's state at time ``t`` (default: the clock).
        Probed peers are probed first (alive == heartbeat). Returns the
        transitions fired this tick as ``(peer, new_state)`` pairs — the
        Router consumes the DEAD ones to trigger recovery."""
        now = t if t is not None else self._clock()
        fired: List[Tuple[str, str]] = []
        for p in self._peers.values():
            if p.state == DEAD:
                continue
            if p.probe is not None:
                alive = False
                try:
                    alive = bool(p.probe())
                except Exception:
                    pass  # a raising probe is a dead peer
                if alive:
                    self.heartbeat(p.name, t=now)
                    continue
            age = now - p.t_last
            if age > self.dead_after_s:
                p.state = DEAD
                p.transitions.append((DEAD, now))
                _PEER_STATE.set(2, peer=p.name)
                obs.instant("peer_dead", track="health", peer=p.name,
                            silent_s=round(age, 4))
                # terminal transition = post-mortem moment: freeze the
                # ring + registry before recovery churns them (one
                # bundle per peer — the recorder dedupes on the key)
                obs.flight_trigger(
                    "peer_dead",
                    # the detector's identity is part of the key: two
                    # detectors may both track a peer
                    # named "0", and each death deserves its own bundle
                    key=f"health:{id(self):x}:{p.name}", peer=p.name,
                    source="health", silent_s=round(age, 4),
                    suspect_after_s=self.suspect_after_s,
                    dead_after_s=self.dead_after_s,
                    transitions=[(s, round(ts, 4))
                                 for s, ts in p.transitions])
                _log.warning("peer %s DEAD after %.3fs silence",
                             p.name, age)
                fired.append((p.name, DEAD))
            elif age > self.suspect_after_s and p.state == HEALTHY:
                p.state = SUSPECT
                p.transitions.append((SUSPECT, now))
                _PEER_STATE.set(1, peer=p.name)
                obs.instant("peer_suspect", track="health", peer=p.name,
                            silent_s=round(age, 4))
                fired.append((p.name, SUSPECT))
        return fired


def abandon_engine(engine) -> List:
    """Strip every queued and in-slot request off a dead engine and count
    ALL of them lost (``serving_recovered_total{outcome="lost"}`` + the
    dead engine's ``lost`` metric — the conservation invariant's sink
    term). This is the no-survivors recovery (a standalone worker dying
    with nobody to resubmit to); the Router's recovery instead evacuates
    and re-routes (uccl_tpu_torch/serving/router.py). Returns the abandoned
    requests."""
    from uccl_tpu_torch.serving.request import RequestState

    queued, active = engine.evacuate()
    for req in queued + active:
        req.state = RequestState.LOST
        req.finish_reason = "replica_dead"
        engine.metrics.on_lost(req)
        _RECOVERED.inc(outcome="lost")
        obs.instant("recover", track="health", rid=req.rid,
                    outcome="lost", trace_id=req.trace_id)
    return queued + active
