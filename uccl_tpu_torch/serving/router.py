"""Replica router: least-loaded admission over N serving engine replicas.

Port copy of ``uccl_tpu/serving/router.py`` (jax-free there too). The
router reads each replica's live load signals (``replica_signals``): free
slots, token debt (``engine.pending_tokens()``), the recent queue wait and
adoption backpressure (a disaggregated ``PrefillWorker`` replica's
BEGINs still waiting for a decode-side GRANT).
Selection is lexicographic, ``(debt + bp_tokens * backpressure -
cached_prefix_tokens, -free_slots, queue_wait_ms, index)``, lowest wins,
with the index tail rotating by the routed count so equal replicas take
turns. A rejecting replica spills the request to the next-ranked one
(``serving_router_spillover_total``); when every replica rejects, the
router does (``serving_router_rejected_total{reason="saturated"}``).

With :meth:`Router.enable_health` a ``FailureDetector`` probes every
replica. SUSPECT replicas take no new work; a DEAD replica's requests are
recovered exactly once under their original trace context: queued ones
resubmit to a survivor, active ones restart from scratch there, and those
no survivor takes are counted lost. The conservation invariant ``submitted
== completed + active + queued + rejected + expired + lost`` then holds
across the set. Recovery re-submits a request's prompt, budget, EOS,
class and tenant, as the JAX router does: its sampling parameters and
adapter are not carried to the survivor. :meth:`detach` and :meth:`attach`
drain a replica out of the set and add one.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from uccl_tpu_torch import obs
from uccl_tpu_torch.serving.engine import ServingEngine
from uccl_tpu_torch.serving.health import DEAD, FailureDetector
from uccl_tpu_torch.serving.metrics import ServingMetrics
from uccl_tpu_torch.serving.request import Request, RequestState

_ROUTED = obs.counter(
    "serving_router_requests_total",
    "requests admitted per replica by the least-loaded router",
)
_SPILLOVER = obs.counter(
    "serving_router_spillover_total",
    "admissions that fell through to a lower-ranked replica after the "
    "chosen one rejected (bounded-queue race)",
)
_ROUTER_REJECTS = obs.counter(
    "serving_router_rejected_total",
    "requests rejected at the router: reason=saturated means every "
    "replica's queue was full",
)
_REPLICAS = obs.gauge(
    "serving_router_replicas", "replica count behind the serving router"
)
_DETACHED = obs.counter(
    "serving_router_detached_total",
    "replicas gracefully drained out of the set (the elastic down-scale "
    "primitive: admission drained, active work finished, parked "
    "prefix-cache donors handed back before removal)",
)
_ATTACHED = obs.counter(
    "serving_router_attached_total",
    "replicas added to a live router (warm-spare admission / elastic "
    "up-scale)",
)
_CACHE_STEERED = obs.counter(
    "serving_router_cache_steered_total",
    "admissions whose winning replica was ranked with a non-zero cached "
    "prefix (local trie or fleet-directory longest-prefix match) — the "
    "cache-aware steering signal actually changing placement",
)
# declared in serving/health.py (one family, shared label space)
_RECOVERED_COUNTER = obs.counter("serving_recovered_total")


def replica_signals(replica, *, recent: int = 8) -> Dict[str, float]:
    """The live load signals for one replica, as the router reads them.
    Exposed as a function so tests and benches can audit the exact inputs
    a routing decision saw."""
    eng = engine_of(replica)
    qw = eng.metrics.queue_wait_s[-recent:]
    bp = 0
    hook = getattr(replica, "adoption_backpressure", None)
    if callable(hook):
        bp = int(hook())
    return {
        "free_slots": eng.pool.n_free,
        "queued": eng.sched.qsize,
        "debt_tokens": eng.pending_tokens(),
        "queue_wait_ms": round(sum(qw) / len(qw) * 1e3, 3) if qw else 0.0,
        "backpressure": bp,
    }


def engine_of(replica) -> ServingEngine:
    """The ServingEngine inside a replica (identity for a bare engine,
    ``.engine`` for a disagg PrefillWorker)."""
    return getattr(replica, "engine", replica)


class Router:
    """Least-loaded front end over N serving replicas.

    ``bp_tokens`` prices one unit of adoption backpressure (one request
    stuck awaiting decode capacity) in debt-token units when ranking —
    the default assumes a stuck request is worth about one typical
    request's work.
    """

    def __init__(self, replicas: List, *, bp_tokens: int = 64,
                 detector: Optional[FailureDetector] = None,
                 directory=None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.replicas = list(replicas)
        self.bp_tokens = bp_tokens
        self.routed = [0] * len(self.replicas)  # per-replica admit counts
        # stable per-replica ids: counter labels and detector peers keep
        # their identity across detach/attach (list indices shift)
        self._pids = list(range(len(self.replicas)))
        self._next_pid = len(self.replicas)
        self._dead: set = set()      # pids already recovered — THE
        # exactly-once guard (one recovery per replica; a request object
        # lives on exactly one replica, so no trace re-runs while a live
        # incarnation exists)
        self._draining: set = set()  # pids mid-detach (no new routes)
        self.recoveries: List[Dict] = []  # audit log (the chaos bench)
        self.detector = detector
        # optional fleet prefix-cache directory (serving/fleet.py): ranking
        # then credits the replica OWNING the deepest published prefix of
        # the submitted prompt, so shared system prompts steer toward the
        # worker that already holds their KV (cache-aware steering)
        self.directory = directory
        if detector is not None:
            for i, r in enumerate(self.replicas):
                detector.register(self._pids[i], probe=self._probe_for(r))
        _REPLICAS.set(len(self.replicas))

    # -- health --------------------------------------------------------
    @staticmethod
    def _probe_for(replica):
        """In-process liveness probe: alive unless the engine was
        ``kill()``ed — the heartbeat equivalent for replicas sharing the
        router's process (a real remote peer heartbeats over notifs
        instead; see serving/health.py)."""
        eng = engine_of(replica)
        return lambda: not eng.dead

    def enable_health(self, *, suspect_after_s: float = 0.5,
                      dead_after_s: float = 1.5,
                      clock=None) -> FailureDetector:
        """Attach a failure detector over the current replica set (every
        replica registered with an in-process liveness probe). Ticked at
        every :meth:`step`; DEAD replicas are recovered in place."""
        kw = {"suspect_after_s": suspect_after_s,
              "dead_after_s": dead_after_s}
        if clock is not None:
            kw["clock"] = clock
        self.detector = FailureDetector(**kw)
        for i, r in enumerate(self.replicas):
            self.detector.register(self._pids[i], probe=self._probe_for(r))
        return self.detector

    def _routable(self, i: int) -> bool:
        pid = self._pids[i]
        if pid in self._dead or pid in self._draining:
            return False
        if engine_of(self.replicas[i]).dead:
            return False  # killed but not yet detector-confirmed
        if self.detector is not None and not self.detector.is_routable(
                str(pid)):
            return False
        return True

    def _health_tick(self) -> None:
        if self.detector is None:
            return
        for peer, state in self.detector.tick():
            if state != DEAD:
                continue
            try:
                idx = self._pids.index(int(peer))
            except ValueError:
                continue  # already detached
            self._recover(idx)

    def _recover(self, idx: int) -> None:
        """Recover a DEAD replica's requests exactly once: evacuate its
        queue and slots, resubmit each request to the best-ranked HEALTHY
        survivor under its ORIGINAL trace context (queued → resubmitted;
        active → restarted from scratch — the rows died with the
        process), count the unplaceable ones lost. The dead engine's
        copies all exit through its ``lost`` metric so the fleet
        conservation invariant stays exact (module docstring)."""
        from uccl_tpu_torch.obs import TraceContext

        pid = self._pids[idx]
        if pid in self._dead:
            return  # exactly-once per replica
        self._dead.add(pid)
        eng = engine_of(self.replicas[idx])
        queued, active = eng.evacuate()
        stranded = ([(r, "resubmitted") for r in queued]
                    + [(r, "restarted") for r in active])
        for req, kind in stranded:
            outcome = kind
            new_req = None
            # exactly-once is structural: the pid guard above means each
            # replica is recovered once, and a request object lives on
            # exactly one replica — so no trace is ever re-run while a
            # live incarnation exists. A CASCADING failure (the survivor
            # that took this trace dies too) legitimately recovers the
            # same trace_id again: it is a new incarnation of the same
            # request, still under the ORIGINAL context (no new mint).
            ctx = (TraceContext(req.trace_id, req.span_id)
                   if req.trace_id and req.span_id else obs.new_context())
            # a still-QUEUED request keeps its admission deadline (it may
            # even have expired while stranded — the survivor's aging
            # expires it honestly); a restarted ACTIVE request was
            # already admitted once, so re-applying the deadline would
            # break the same contract preemption resume honors. Worker
            # (disagg) replicas never carry deadlines (Router.submit
            # refuses them on such sets) and _submit_to's worker branch
            # ignores the argument.
            ddl = req.deadline_ms if kind == "resubmitted" else None
            ranked, _ = self._ranked()
            for _, i in ranked:
                if i == idx:
                    continue
                new_req = self._submit_to(
                    i, req.prompt, max_new_tokens=req.max_new_tokens,
                    eos_id=req.eos_id, priority=req.priority,
                    tenant=req.tenant, trace=ctx,
                    deadline_ms=ddl,
                )
                if new_req is not None:
                    new_req.replica = self._pids[i]
                    self.routed[i] += 1
                    _ROUTED.inc(replica=str(self._pids[i]))
                    break
            if new_req is None:
                outcome = "lost"
            req.state = RequestState.LOST
            req.finish_reason = "replica_dead"
            eng.metrics.on_lost(req)
            _RECOVERED_COUNTER.inc(outcome=outcome)
            self.recoveries.append({
                "replica": pid, "rid": req.rid, "outcome": outcome,
                "trace_id": req.trace_id,
            })
            obs.instant("recover", track="router", replica=pid,
                        rid=req.rid, outcome=outcome,
                        trace_id=req.trace_id)

    # -- the routing decision ------------------------------------------
    def _prefix_tokens(self, i: int, prompt, ns: str,
                       dir_hit=None) -> int:
        """Cached-prefix depth (tokens) replica ``i`` could resume this
        prompt from: the deepest of its own trie's longest-prefix match
        (side-effect-free: no counters, no LRU refresh) and the fleet
        directory's deepest entry WHEN this replica owns it. In debt-token
        units by construction: every matched token is prefill work the
        replica does not have to do."""
        eng = engine_of(self.replicas[i])
        best = 0
        cache = eng.prefix_cache
        if cache is not None:
            best = cache._lookup(prompt, ns)[0]
        if dir_hit is not None:
            fleet = getattr(eng, "fleet", None)
            if fleet is not None and dir_hit.get("owner") == fleet.worker:
                best = max(best, int(dir_hit.get("tokens", 0)))
        return best

    def _ranked(self, prompt=None, tenant: str = "default"
                ) -> Tuple[List[Tuple[tuple, int]], Dict[int, Dict]]:
        """ROUTABLE replicas ranked least-loaded first (dead, draining
        and detector-suspect replicas are excluded). With ``prompt`` the
        rank also credits cached prefixes (local trie / fleet directory
        longest-prefix match) against the debt term — cache-aware
        steering. The index tail rotates with the total routed count so
        exactly-equal replicas take turns instead of always electing
        replica 0 (cold-start skew)."""
        n = len(self.replicas)
        rot = sum(self.routed) % n
        ns = "" if tenant == "default" else tenant
        dir_hit = None
        if prompt is not None and self.directory is not None:
            dir_hit = self.directory.lookup(prompt, ns)
        ranked = []
        for i, r in enumerate(self.replicas):
            if not self._routable(i):
                continue
            s = replica_signals(r)
            if prompt is not None:
                s["prefix_tokens"] = self._prefix_tokens(
                    i, prompt, ns, dir_hit)
            key = (
                s["debt_tokens"] + self.bp_tokens * s["backpressure"]
                - s.get("prefix_tokens", 0),
                -s["free_slots"],
                s["queue_wait_ms"],
                (i - rot) % n,
            )
            ranked.append((key, i, s))
        ranked.sort(key=lambda t: t[0])
        return [(k, i) for k, i, _ in ranked], {i: s for _, i, s in ranked}

    def _submit_to(self, i: int, prompt, *, max_new_tokens: int,
                   eos_id, priority: str, trace,
                   tenant: str = "default",
                   deadline_ms: Optional[float] = None
                   ) -> Optional[Request]:
        """One admission attempt against replica ``i`` (engine or disagg
        worker) — shared by routing and recovery so the two cannot
        drift."""
        replica = self.replicas[i]
        eng = engine_of(replica)
        if replica is eng:
            return eng.submit(prompt, max_new_tokens=max_new_tokens,
                              eos_id=eos_id, priority=priority,
                              tenant=tenant,
                              deadline_ms=deadline_ms, trace=trace)
        # disagg prefill worker: the decode budget, the class label and
        # the tenant ride the BEGIN message (the worker's own engine
        # schedules its prefill queue by the same class, and the decode
        # side adopts under the same tenant so fleet-merged per-tenant
        # series stay truthful)
        return replica.submit(prompt, max_new_tokens=max_new_tokens,
                              eos_id=eos_id, priority=priority,
                              tenant=tenant, trace=trace)

    def submit(self, prompt, *, max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               priority: str = "interactive",
               tenant: str = "default",
               deadline_ms: Optional[float] = None) -> Optional[Request]:
        """Admit one request to the least-loaded replica; on rejection,
        spill to the next-ranked; None when every replica rejected.
        ``deadline_ms`` is refused when the set contains disagg prefill
        workers: their BEGIN already reserved decode-side state, so a
        queue-expired prefill request would strand the peer's grant."""
        if deadline_ms is not None and any(
                r is not engine_of(r) for r in self.replicas):
            raise ValueError(
                "deadline_ms is not supported on disagg prefill "
                "replicas: an expired queued request would strand its "
                "decode-side grant"
            )
        # the router IS the fleet ingress: mint the trace context here so
        # the routing decision and every downstream span (including a
        # disagg peer's, across processes) share one trace_id — a spilled
        # retry is the same request, so the context survives the loop
        ctx = obs.new_context()
        ranked, signals = self._ranked(prompt=prompt, tenant=tenant)
        for rank, (_, i) in enumerate(ranked):
            req = self._submit_to(i, prompt,
                                  max_new_tokens=max_new_tokens,
                                  eos_id=eos_id, priority=priority,
                                  tenant=tenant,
                                  trace=ctx, deadline_ms=deadline_ms)
            if req is None:
                continue  # bounded queue raced the signal read — spill
            req.replica = self._pids[i]
            self.routed[i] += 1
            _ROUTED.inc(replica=str(self._pids[i]))
            if rank > 0:
                _SPILLOVER.inc()
            if signals[i].get("prefix_tokens", 0) > 0:
                _CACHE_STEERED.inc()
            obs.instant("route", track="router", replica=self._pids[i],
                        rank=rank, rid=req.rid, cls=priority,
                        tenant=tenant,
                        trace_id=ctx.trace_id, **signals[i])
            return req
        _ROUTER_REJECTS.inc(reason="saturated")
        obs.instant("route_reject", track="router",
                    replicas=len(self.replicas))
        return None

    def cancel(self, rid_replica: Tuple[int, int]) -> bool:
        """Cancel a queued request by (replica index, rid)."""
        i, rid = rid_replica
        return engine_of(self.replicas[i]).cancel(rid)

    # -- the drive surface (loadgen.drive-compatible) ------------------
    def _pending_recovery(self) -> bool:
        """A killed-but-not-yet-recovered replica still holding requests
        is outstanding work: ``drain()`` must keep ticking the detector
        until recovery moves them (without health there is nothing to
        wait for — the kill is terminal)."""
        if self.detector is None:
            return False
        return any(engine_of(r).dead and self._pids[i] not in self._dead
                   and engine_of(r).has_work()
                   for i, r in enumerate(self.replicas))

    def has_work(self) -> bool:
        return any(
            not engine_of(r).dead
            and (engine_of(r).has_work()
                 or (hasattr(r, "idle") and not r.idle()))
            for r in self.replicas
        ) or self._pending_recovery()

    def step(self) -> List[Request]:
        """One iteration of every live replica that has work (a dead
        replica is skipped — a dead process does nothing — until the
        health tick recovers it); returns requests finished across the
        set this round."""
        self._health_tick()
        finished: List[Request] = []
        stepped = False
        for r in self.replicas:
            eng = engine_of(r)
            if eng.dead:
                continue
            if r is not eng:
                r.step()  # worker loop: engine step + wire pump
                stepped = True
            elif eng.has_work():
                finished.extend(eng.step())
                stepped = True
        if not stepped and self._pending_recovery():
            # nothing live to run: pace the detector ticks instead of
            # spinning drain()'s step budget away inside the grace window
            time.sleep(0.001)
        return finished

    def drain(self, max_steps: int = 100000) -> List[Request]:
        done: List[Request] = []
        steps = 0
        while self.has_work():
            done.extend(self.step())
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"router drain exceeded {max_steps} steps "
                    f"(queued={self.qsize}, active={self.n_active})"
                )
        return done

    # -- elastic membership --------------------------------------------
    def detach(self, index: int, *, max_steps: int = 100000
               ) -> List[Request]:
        """Gracefully drain replica ``index`` out of the set — the
        elastic DOWN-scale primitive (:meth:`attach` is the up-scale
        twin): admission to it stops immediately, the
        whole set keeps stepping until its queue and slots empty (its
        active work finishes normally — nothing is lost), parked
        prefix-cache donor slots are handed back, and only then is the
        replica removed. Returns every request that finished ACROSS the
        set while draining (a caller mid-load must not lose them).
        Raises if the replica cannot drain in ``max_steps`` or would
        leak a slot."""
        if not (0 <= index < len(self.replicas)):
            raise IndexError(f"no replica {index} (have "
                             f"{len(self.replicas)})")
        if len(self.replicas) == 1:
            raise ValueError("cannot detach the last replica")
        pid = self._pids[index]
        replica = self.replicas[index]
        eng = engine_of(replica)
        self._draining.add(pid)
        try:
            finished: List[Request] = []
            steps = 0

            def busy() -> bool:
                if eng.dead:
                    return False  # died mid-drain: recovery handles it
                if replica is not eng:
                    return eng.has_work() or not replica.idle()
                return eng.has_work()

            while busy():
                finished.extend(self.step())
                steps += 1
                if steps > max_steps:
                    raise RuntimeError(
                        f"detach: replica {pid} still busy after "
                        f"{max_steps} steps (queued={eng.sched.qsize}, "
                        f"active={len(eng._by_slot)})"
                    )
            if eng.dead and pid not in self._dead:
                # died mid-drain: recover NOW instead of waiting out the
                # detector window — detach's contract is "requests are
                # not lost", and the pool must be empty before removal
                self._recover(index)
            if eng.prefix_cache is not None:
                # hand parked donor slots back before removal — a
                # detached replica must leave nothing charged to its pool
                eng.prefix_cache.clear(eng.pool)
            leaked = eng.pool.leaked()
            if leaked:
                raise RuntimeError(
                    f"detach: replica {pid} drained but leaks "
                    f"{leaked} slot(s)"
                )
        finally:
            self._draining.discard(pid)
        self.replicas.pop(index)
        self.routed.pop(index)
        self._pids.pop(index)
        if self.detector is not None:
            self.detector.deregister(pid)
        _REPLICAS.set(len(self.replicas))
        _DETACHED.inc()
        obs.instant("detach", track="router", replica=pid, steps=steps)
        return finished

    def attach(self, replica) -> int:
        """Add a replica to the live set (warm-spare admission / elastic
        up-scale). Registered with the failure
        detector when health is on. Returns the replica's stable id."""
        pid = self._next_pid
        self._next_pid += 1
        self.replicas.append(replica)
        self.routed.append(0)
        self._pids.append(pid)
        if self.detector is not None:
            self.detector.register(pid, probe=self._probe_for(replica))
        _REPLICAS.set(len(self.replicas))
        _ATTACHED.inc()
        obs.instant("attach", track="router", replica=pid)
        return pid

    # -- aggregate inspection ------------------------------------------
    @property
    def engines(self) -> List[ServingEngine]:
        return [engine_of(r) for r in self.replicas]

    @property
    def qsize(self) -> int:
        return sum(e.sched.qsize for e in self.engines)

    @property
    def n_active(self) -> int:
        return sum(len(e._by_slot) for e in self.engines)

    def leaked(self) -> int:
        return sum(e.pool.leaked() for e in self.engines)

    def snapshot(self) -> dict:
        """Replica-set snapshot: the merged metrics (samples concatenated,
        counts summed — ServingMetrics.merged) plus per-replica snapshots
        and the router's own routed distribution."""
        merged = ServingMetrics.merged([e.metrics for e in self.engines])
        snap = merged.snapshot(
            queued=self.qsize, active=self.n_active,
            n_slots=sum(e.pool.n_slots for e in self.engines),
            occupancy=(sum(e.pool.n_active for e in self.engines)
                       / max(1, sum(e.pool.n_slots for e in self.engines))),
        )
        snap["replicas"] = len(self.replicas)
        snap["routed"] = list(self.routed)
        snap["per_replica"] = [e.snapshot() for e in self.engines]
        snap["dead_replicas"] = len(self._dead)
        snap["leaked"] = self.leaked()
        return snap

    def close(self) -> None:
        for e in self.engines:
            e.close()
