"""Admission scheduling: FIFO with backpressure, plus SLO priority classes.

Port copy of ``uccl_tpu/serving/scheduler.py`` (jax-free there too).

Orca/vLLM-shape policy, smallest useful core: arrivals queue in submission
order; every engine step admits from the queue head while KV slots are free
(so a long-running sequence never starves the queue — it just occupies one
slot); a bounded queue rejects at submit when full (backpressure — the
caller sees it immediately instead of timing out later).

Both schedulers support **queue aging + cancellation**: a request submitted
with ``deadline_ms`` that is still queued when the deadline passes leaves
the queue as ``RequestState.EXPIRED`` (the engine counts it on
``serving_rejected_total{reason="deadline"}``), and ``cancel(rid)`` removes
a queued request the same way — a stale queued request no longer occupies
the queue forever (previously it could only be rejected at submit time).

:class:`PriorityScheduler` adds latency classes (Llumnix/SLO-aware shape,
docs/SERVING.md): one FIFO queue per class, admission drains strictly in
class order (``interactive`` before ``batch``), and :meth:`requeue` puts an
engine-preempted request back at the HEAD of its class queue so a paused
victim resumes before any later same-class arrival.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Tuple

from uccl_tpu_torch.serving.request import Request, RequestState, now
from uccl_tpu_torch.serving.slots import SlotPool

# class order: admission drains lower-index classes first
PRIORITY_CLASSES = ("interactive", "batch")


class FIFOScheduler:
    """Bounded FIFO queue + admission loop over a :class:`SlotPool`."""

    def __init__(self, max_queue: Optional[int] = None):
        if max_queue is not None and max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.max_queue = max_queue
        self._queue: deque = deque()
        self._admit_seq = 0
        # queued requests carrying a deadline — expire()'s early-out, so
        # deadline-free engines never pay an O(qsize) scan per step
        self._n_deadlined = 0

    # single-queue view — PriorityScheduler overrides to expose its class
    # queues through the same iteration surface
    def _queues(self) -> List[deque]:
        return [self._queue]

    @property
    def qsize(self) -> int:
        return sum(len(q) for q in self._queues())

    def peek(self) -> Optional[Request]:
        """The request the next admission would take (None when empty) —
        lets the engine's make_room hook protect the prefix-cache donor
        this request is about to match from being the eviction victim."""
        for q in self._queues():
            if q:
                return q[0]
        return None

    def queued_requests(self) -> List[Request]:
        """Every queued request, in admission order (the router's token-debt
        signal sums outstanding work over these)."""
        return [r for q in self._queues() for r in q]

    def debug_state(self) -> dict:
        """Flight-bundle face (obs/flight.py): queue shape only, no
        Request bodies — a post-mortem dump must stay small and must not
        carry prompt content."""
        return {"kind": type(self).__name__, "qsize": self.qsize,
                "max_queue": self.max_queue,
                "deadlined": self._n_deadlined}

    def take_all(self) -> List[Request]:
        """Remove and return EVERY queued request, in admission order —
        the dead-replica evacuation (the router resubmits them to
        survivors, or counts them lost). The queues end empty."""
        out: List[Request] = []
        for q in self._queues():
            out.extend(q)
            q.clear()
        self._n_deadlined = 0
        return out

    def submit(self, req: Request) -> bool:
        """Queue a request; False = rejected (queue full, backpressure)."""
        if self.max_queue is not None and self.qsize >= self.max_queue:
            req.state = RequestState.REJECTED
            return False
        self._queue.append(req)
        if req.deadline_ms is not None:
            self._n_deadlined += 1
        return True

    def requeue(self, req: Request) -> None:
        """Put an engine-preempted request back at the queue head: a paused
        victim resumes before any later arrival of its class. Never bounded
        — the request already passed backpressure at submit."""
        self._queue.appendleft(req)

    def defer(self, req: Request) -> None:
        """Undo a just-granted admission: the engine's admission gate
        denied the request AFTER :meth:`admit` popped it (e.g. no adapter
        table row free), so put it back at the queue head with the
        admission stamps reverted — deadline aging and ``cancel`` apply
        exactly as before the attempt. A preemption victim waiting to
        resume (saved-token marker set) returns to PREEMPTED, which stays
        exempt from admission-deadline expiry; anything else is QUEUED
        again. The caller frees the granted slot; a fair scheduler never
        re-bills (``req.billed``)."""
        if req._saved_last_tok is not None:
            req.state = RequestState.PREEMPTED
        else:
            req.state = RequestState.QUEUED
            if req.deadline_ms is not None:
                # _place counted it admitted-in-time; it wasn't admitted
                self._n_deadlined += 1
        req.slot = None
        self.requeue(req)

    def expire(self, t: float) -> List[Request]:
        """Drop every QUEUED request whose admission deadline passed at
        engine-clock ``t`` (state → EXPIRED, finish_reason "deadline").
        Preempted requests waiting to resume are exempt: their deadline was
        an *admission* deadline and they were already admitted once. Free
        when nothing queued carries a deadline (the common case — one
        counter check, no queue scan)."""
        if self._n_deadlined == 0:
            return []
        expired: List[Request] = []
        for q in self._queues():
            for _ in range(len(q)):  # one full rotation keeps queue order
                r = q.popleft()
                if (r.state is RequestState.QUEUED
                        and r.deadline_passed(t)):
                    r.state = RequestState.EXPIRED
                    r.finish_reason = "deadline"
                    self._n_deadlined -= 1
                    expired.append(r)
                else:
                    q.append(r)
        return expired

    def cancel(self, rid: int) -> Optional[Request]:
        """Remove a queued request by id (state → EXPIRED, finish_reason
        "cancel"). Returns the request, or None when ``rid`` is not queued
        (already admitted, finished, or unknown) — only QUEUED requests are
        cancellable here; in-slot requests run to completion."""
        for q in self._queues():
            for r in q:
                if r.rid == rid and r.state is RequestState.QUEUED:
                    q.remove(r)
                    if r.deadline_ms is not None:
                        self._n_deadlined -= 1
                    r.state = RequestState.EXPIRED
                    r.finish_reason = "cancel"
                    return r
        return None

    def admit(self, pool: SlotPool, limit: Optional[int] = None,
              make_room: Optional[Callable[[], bool]] = None,
              ) -> List[Tuple[int, Request]]:
        """Move queue-head requests into free slots, in FIFO order, until
        either runs out. ``limit`` caps this call's admissions (the engine's
        per-step token budget: each admission under chunked prefill commits
        one chunk of prefill work per step until its prompt is in KV, so
        admission is where the budget is enforced — None = unbounded).
        ``make_room()`` is consulted only when the pool has no free slot
        and the queue still has work: return True after freeing one (the
        prefix cache's LRU eviction — parked donor slots yield to live
        admissions — or the engine's priority preemption), False to stop
        admitting. Returns the newly admitted (slot, request) pairs — the
        engine prefills exactly these."""
        admitted: List[Tuple[int, Request]] = []
        while (limit is None or len(admitted) < limit):
            queue = next((q for q in self._queues() if q), None)
            if queue is None:
                break
            if not pool.n_free and not (make_room is not None
                                        and make_room()):
                break
            req = queue.popleft()
            admitted.append((self._place(pool, req), req))
        return admitted

    def _place(self, pool: SlotPool, req: Request) -> int:
        """Shared per-admission bookkeeping (deadline counter, slot grant,
        state + timing stamps) — every scheduler's admit loop funnels
        through this once it has chosen a request and verified capacity."""
        if (req.deadline_ms is not None
                and req.state is RequestState.QUEUED):
            self._n_deadlined -= 1  # made it in before the deadline
        slot = pool.admit(req.rid)
        assert slot is not None  # n_free was checked by the caller
        req.slot = slot
        req.state = RequestState.ACTIVE
        req.t_admit = now()
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        return slot


class PriorityScheduler(FIFOScheduler):
    """Class-ordered admission: one bounded FIFO queue per priority class.

    ``interactive`` requests are always admitted before ``batch`` requests
    regardless of arrival order; within a class, order is FIFO. The shared
    ``max_queue`` bounds the TOTAL queued count (one backpressure surface —
    a saturated engine rejects both classes, and the router's spillover
    handles the rest). ``requeue`` (the engine's preemption path) restores
    a victim to the head of its own class queue.
    """

    def __init__(self, max_queue: Optional[int] = None):
        super().__init__(max_queue=max_queue)
        self._by_class = {cls: deque() for cls in PRIORITY_CLASSES}

    def _queues(self) -> List[deque]:
        return [self._by_class[cls] for cls in PRIORITY_CLASSES]

    def _class_queue(self, req: Request) -> deque:
        q = self._by_class.get(req.priority)
        if q is None:
            raise ValueError(
                f"unknown priority class {req.priority!r} "
                f"(classes: {PRIORITY_CLASSES})"
            )
        return q

    def submit(self, req: Request) -> bool:
        if self.max_queue is not None and self.qsize >= self.max_queue:
            req.state = RequestState.REJECTED
            return False
        self._class_queue(req).append(req)
        if req.deadline_ms is not None:
            self._n_deadlined += 1
        return True

    def requeue(self, req: Request) -> None:
        self._class_queue(req).appendleft(req)

    def debug_state(self) -> dict:
        st = super().debug_state()
        st["by_class"] = {cls: len(q)
                         for cls, q in self._by_class.items()}
        return st


class TenantFairScheduler(FIFOScheduler):
    """Per-tenant fair admission: one FIFO queue per tenant,
    **deficit round-robin** across tenants, plus optional per-tenant
    **token-bucket** rate limits.

    DRR (the classic Shreedhar/Varghese discipline, in request-token
    units): admission visits tenants round-robin; each visit grants the
    tenant one ``quantum`` of deficit, and its queue head is admitted
    while the deficit covers the request's token cost
    (``prompt + max_new_tokens``). A tenant with a thousand queued
    requests therefore gets the same admission *rate* as a tenant with
    one — backlog buys nothing — which is exactly the isolation the
    multi-tenant bench proves: an overloading tenant cannot push a
    victim's SLO attainment down (docs/SERVING.md). An emptied queue
    forfeits its deficit (the DRR rule that stops idle tenants hoarding
    credit).

    The token bucket (``rate`` tokens/sec, capacity ``burst``) is the
    hard per-tenant ceiling ON TOP of DRR's work-conserving share: a
    tenant above its rate holds in queue even when slots are free.
    ``rate=None`` (default) disables it — DRR alone is work-conserving.
    A request whose cost exceeds ``burst`` is REJECTED at submit: the
    bucket refills only up to ``burst``, so such a request could never
    be admitted and would otherwise wedge its tenant's queue head
    forever (livelock). A preempted or engine-deferred request is NOT
    re-charged on requeue (its tokens were billed at first admission).

    Per-tenant fairness and priority classes are mutually exclusive
    surfaces (the engine enforces it): within a tenant, order is FIFO.
    ``clock`` is injectable for deterministic bucket tests.
    """

    def __init__(self, max_queue: Optional[int] = None, *,
                 quantum: int = 64, rate: Optional[float] = None,
                 burst: Optional[float] = None, clock=now):
        super().__init__(max_queue=max_queue)
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        if rate is not None and rate <= 0:
            raise ValueError(f"rate must be > 0 tokens/sec, got {rate}")
        if burst is not None and burst <= 0:
            raise ValueError(f"burst must be > 0 tokens, got {burst}")
        self.quantum = int(quantum)
        self.rate = rate
        self.burst = float(burst) if burst is not None else (
            4.0 * rate if rate is not None else 0.0
        )
        self._clock = clock
        self._by_tenant: "OrderedDict[str, deque]" = OrderedDict()
        self._deficit: Dict[str, float] = {}
        self._bucket: Dict[str, float] = {}
        self._rr: deque = deque()  # round-robin rotation of tenant names
        self._last_refill: Optional[float] = None

    def _queues(self) -> List[deque]:
        return list(self._by_tenant.values())

    def _tenant_queue(self, tenant: str) -> deque:
        q = self._by_tenant.get(tenant)
        if q is None:
            q = self._by_tenant[tenant] = deque()
            self._deficit[tenant] = 0.0
            self._bucket[tenant] = self.burst
            self._rr.append(tenant)
        return q

    @staticmethod
    def _cost(req: Request) -> int:
        """A request's token cost: the prompt it prefills plus the budget
        it may decode — the unit both the deficit and the bucket meter."""
        return int(req.prompt.size) + int(req.max_new_tokens)

    def submit(self, req: Request) -> bool:
        if self.max_queue is not None and self.qsize >= self.max_queue:
            req.state = RequestState.REJECTED
            return False
        if self.rate is not None and self._cost(req) > self.burst:
            # the bucket never holds more than `burst` tokens, so this
            # request's charge could never be covered: fail fast at
            # submit instead of silently blocking the tenant's FIFO head
            # for every later request (admission livelock)
            req.state = RequestState.REJECTED
            req.finish_reason = "oversized"
            return False
        self._tenant_queue(req.tenant).append(req)
        if req.deadline_ms is not None:
            self._n_deadlined += 1
        return True

    def requeue(self, req: Request) -> None:
        self._tenant_queue(req.tenant).appendleft(req)

    def _refill(self) -> None:
        if self.rate is None:
            return
        t = self._clock()
        if self._last_refill is not None:
            dt = max(0.0, t - self._last_refill)
            for tenant in self._bucket:
                self._bucket[tenant] = min(
                    self.burst, self._bucket[tenant] + self.rate * dt
                )
        self._last_refill = t

    def admit(self, pool: SlotPool, limit: Optional[int] = None,
              make_room: Optional[Callable[[], bool]] = None,
              ) -> List[Tuple[int, Request]]:
        admitted: List[Tuple[int, Request]] = []
        self._refill()
        while limit is None or len(admitted) < limit:
            progress = deficit_short = False
            for _ in range(len(self._rr)):
                if limit is not None and len(admitted) >= limit:
                    break
                tenant = self._rr[0]
                self._rr.rotate(-1)
                q = self._by_tenant[tenant]
                if not q:
                    self._deficit[tenant] = 0.0  # idle forfeits credit
                    continue
                self._deficit[tenant] += self.quantum
                while q and (limit is None or len(admitted) < limit):
                    req = q[0]
                    # a requeued request (preemption resume, engine
                    # adapter-deferral) was billed at first admission
                    charge = 0 if req.billed else self._cost(req)
                    if (self.rate is not None
                            and self._bucket[tenant] < charge):
                        break  # rate-limited: holds even with free slots
                    if self._deficit[tenant] < charge:
                        deficit_short = True  # next round grants more
                        break
                    if not pool.n_free and not (make_room is not None
                                                and make_room()):
                        # The POOL is the blocker, not fairness — park the
                        # wheel back on the denied tenant and retract this
                        # visit's unspent grant (re-granted on resume).
                        # Without the park, every admit call walks a full
                        # rotation and the freed slot always lands on the
                        # front tenant: observed starvation of every other
                        # tenant under a 1-slot pool.
                        self._rr.rotate(1)
                        self._deficit[tenant] = max(
                            0.0, self._deficit[tenant] - self.quantum
                        )
                        return admitted
                    q.popleft()
                    slot = self._place(pool, req)
                    self._deficit[tenant] -= charge
                    if self.rate is not None:
                        self._bucket[tenant] -= charge
                    req.billed = True
                    admitted.append((slot, req))
                    progress = True
                if not q:
                    self._deficit[tenant] = 0.0
            if not progress and not deficit_short:
                break  # every queued tenant is rate-limited
        return admitted

    def debug_state(self) -> dict:
        st = super().debug_state()
        st["by_tenant"] = {t: len(q)
                          for t, q in self._by_tenant.items() if q}
        st["deficit"] = {t: round(v, 2)
                         for t, v in self._deficit.items() if v}
        if self.rate is not None:
            st["bucket"] = {t: round(v, 2)
                            for t, v in self._bucket.items()}
        return st
