"""Continuous-batching serving engine over the KV slot pool.

Port of ``uccl_tpu/serving/engine.py``. ``submit()`` queues a request; each
``step()`` (1) admits queue-head requests into free KV slots and
batch-prefills exactly those slots (masked: mid-decode neighbours are
untouched), (2) runs one masked batched decode step over every active slot,
(3) retires sequences on EOS or token budget and frees their slots for the
next admission. ``drain()`` steps until idle.

The engine is exact, not approximate: each request's tokens equal the
one-shot ``generate`` oracle's for the same prompt (and, sampled, the same
seed), tested on both stacks. The backends hold the model and the KV pool as
torch tensors on one device; the engine itself is host code (numpy), and
every batched call returns its tokens to the host, so a step's wall time
covers its device work.

Ported here: whole-prompt prefill (prompts bucketed to a power of two),
batched decode, greedy and sampled requests, FIFO admission with
backpressure, deadlines and ``cancel``, the SLO-class and per-tenant
schedulers (``priority_classes``, ``tenant_fair``), the slot lifecycle, the
metrics and the conservation check. The knobs whose modules are not ported
yet raise ``ValueError`` and name their ROADMAP queue A item: chunked
prefill (``prefill_chunk``, ``step_tokens``, ``chunk_sink``, ``preempt``),
speculative decoding (``spec_k``, ``drafter``), the prefix cache, the KV
tiers and adapters; ``adopt``, ``kill``, ``evacuate`` and ``attach_fleet``
(disagg, health, fleet) raise ``NotImplementedError`` the same way.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from uccl_tpu_torch import obs
from uccl_tpu_torch.models import inference as _inference
from uccl_tpu_torch.serving.metrics import ServingMetrics, reset_latency_histograms
from uccl_tpu_torch.serving.request import Request, RequestState, now
from uccl_tpu_torch.serving.sampling import (
    SamplingParams, pack as pack_sampling, slot_arrays, stamp_slot,
)
from uccl_tpu_torch.serving.scheduler import (
    PRIORITY_CLASSES, FIFOScheduler, PriorityScheduler, TenantFairScheduler,
)
from uccl_tpu_torch.serving.slots import SlotPool

# serving telemetry on the obs registry, under the JAX package's names
_REJECTS = obs.counter(
    "serving_admission_rejected_total",
    "requests rejected at submit: queue backpressure, or a token-bucket "
    "cost that exceeds the tenant's burst (could never be admitted)",
)
_OCCUPANCY = obs.gauge(
    "serving_slot_occupancy", "KV slot-pool occupancy after the last step"
)
_HIGH_WATER = obs.gauge(
    "serving_slot_high_water", "max concurrent KV slot occupancy observed"
)
_PREFILL_TOKENS = obs.counter(
    "serving_prefill_tokens_total",
    "prompt tokens per prefill path: kind=computed ran the model, "
    "kind=skipped were reused from the prefix cache (the auditable cut)",
)
_DROPPED = obs.counter(
    "serving_rejected_total",
    "queued requests dropped before admission: reason=deadline (aged out "
    "of the queue), reason=cancel (caller withdrew it), or "
    "reason=adapter_lost (the adapter was archive-evicted while queued)",
)
_TENANT_REQS = obs.counter(
    "serving_tenant_requests_total",
    "requests finished per tenant (labels: tenant)",
)
_TENANT_TOKS = obs.counter(
    "serving_tenant_tokens_total",
    "generated tokens delivered per tenant (labels: tenant)",
)


def _later(knob: str, item: str, module: str) -> str:
    return (f"{knob} needs {module}, which is not ported yet "
            f"(ROADMAP queue A item {item})")


def _bucket(n: int, cap: int) -> int:
    """Prefill bucket length: the next power of two (a bounded set of
    prefill shapes), clipped to cap."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class DenseBackend:
    """Slot-pool serving over the dense KV stack (``models/inference.py``):
    the parameters and the ``[n_slots, S_max]`` KV pool live on the
    parameters' device. The JAX backends' prefill offsets (chunked
    prefill), ``verify`` (speculative decoding), slot-KV moves (prefix
    cache, disaggregation) and adapter tables come with those modules
    (ROADMAP queue A items 10a-10h); the primitives under them
    (``prefill_slots``'s ``start``, ``verify_slots``, the caches'
    ``export_rows`` / ``import_rows`` / ``copy_prefix``, ``_lora_delta``)
    are ported."""

    def __init__(self, params, cfg, *, n_slots: int, max_seq: int):
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.cache = _inference.SlotKVCache.empty(cfg, n_slots, max_seq,
                                                  device=params["embed"].device)

    def prefill(self, tokens: np.ndarray, lens: np.ndarray, mask: np.ndarray,
                sampling=None) -> np.ndarray:
        t, self.cache = _inference.prefill_slots(self.params, tokens, lens, mask, self.cache,
                                                 self.cfg, sampling=sampling)
        return _host(t)

    def decode(self, tokens: np.ndarray, active: np.ndarray, sampling=None) -> np.ndarray:
        t, self.cache = _inference.decode_step_slots(self.params, tokens, active, self.cache,
                                                     self.cfg, sampling=sampling)
        return _host(t)


class MoEBackend:
    """Slot-pool serving over the EP MoE stack: slots are the ``[W, B_loc]``
    rows of the server's cache (slot s is member s // B_loc, row s % B_loc);
    prefill routes through the sorted EP path, decode through the packed LL
    path (the DeepEP decode regime) by default."""

    def __init__(self, server, params, *, batch_local: int, max_seq: int,
                 decode_impl: str = "ll"):
        self.server = server
        self.params = params
        self.world = server.world
        self.b_loc = batch_local
        self.n_slots = self.world * batch_local
        self.max_seq = max_seq
        self.decode_impl = decode_impl
        self.cache = server.slot_cache(batch_local, max_seq)

    def _grid(self, flat) -> np.ndarray:
        flat = np.asarray(flat)
        return flat.reshape((self.world, self.b_loc) + flat.shape[1:])

    def prefill(self, tokens: np.ndarray, lens: np.ndarray, mask: np.ndarray,
                sampling=None) -> np.ndarray:
        t, self.cache = self.server.prefill_slots(
            self.params, self._grid(tokens), self._grid(lens), self._grid(mask), self.cache,
            sampling=sampling)
        return _host(t).reshape(self.n_slots)

    def decode(self, tokens: np.ndarray, active: np.ndarray, sampling=None) -> np.ndarray:
        t, self.cache = self.server.decode_step_slots(
            self.params, self._grid(tokens), self._grid(active), self.cache,
            impl=self.decode_impl, sampling=sampling)
        return _host(t).reshape(self.n_slots)


def replay_alone(backend, req: Request) -> np.ndarray:
    """The engine's exactness oracle: ``req`` run again, alone, on a fresh
    copy of ``backend``'s slot programs, in the slot it had and at the
    prefill length it was admitted at, every other slot idle. Returns its
    ``req.n_generated`` tokens.

    Every call keeps the shapes it had in the engine's batch: the slot grid
    is fixed, and the MoE stack's expert products run on fixed blocks
    (``ep/ll.grouped_ffn``; the sorted path's capacity follows the token
    count). A row's result then depends on nothing else the batch held, so
    the tokens equal the engine's bit for bit on any device. The one-shot
    ``generate`` oracle runs other shapes; a GPU's GEMM and reduction
    kernels pick their summation order by shape, so on the card a near-tie
    there (a router's top-2 or the argmax) can fall the other way, and only
    the CPU holds the engine to ``generate`` exactly."""
    if req.slot is None or req.prefill_bucket is None:
        raise ValueError(f"request {req.rid} was never prefilled by the engine")
    b = _same_backend(backend, backend.params)
    n, slot, size = b.n_slots, req.slot, req.prompt.size
    samp = slot_arrays(n)
    stamp_slot(samp, slot, req.sampling)
    pos = np.zeros(n, np.int32)

    def kw():
        return {} if req.sampling is None else {"sampling": pack_sampling(samp, pos)}

    tokens = np.zeros((n, req.prefill_bucket), np.int32)
    tokens[slot, :size] = req.prompt
    lens = np.ones(n, np.int32)
    lens[slot] = size
    active = np.zeros(n, bool)
    active[slot] = True
    out = [int(b.prefill(tokens, lens, active, **kw())[slot])]
    last = np.zeros(n, np.int32)
    while len(out) < req.n_generated:
        last[slot], pos[slot] = out[-1], len(out)
        out.append(int(b.decode(last, active, **kw())[slot]))
    return np.asarray(out, np.int32)


def _same_backend(backend, params):
    if isinstance(backend, MoEBackend):
        return MoEBackend(backend.server, params, batch_local=backend.b_loc,
                          max_seq=backend.max_seq, decode_impl=backend.decode_impl)
    return DenseBackend(params, backend.cfg, n_slots=backend.n_slots, max_seq=backend.max_seq)


def replicate_backend(backend, n: int, weights=None) -> List:
    """``n`` replica backends from one prototype: every replica owns its KV
    pool and shares the prototype's parameters (MoE replicas share its
    server too). ``weights`` (a parameter tree of the prototype's
    structure and shapes, or an object whose ``tree()`` returns one) makes
    every replica, the prototype included, serve those instead;
    mismatches raise before any replica serves."""
    if n < 1:
        raise ValueError(f"need n >= 1 replicas, got {n}")
    if weights is not None:
        backend = _same_backend(backend, _reweight(backend.params, weights))
    return [backend] + [_same_backend(backend, backend.params) for _ in range(1, n)]


def _reweight(proto, weights):
    tree = weights.tree() if hasattr(weights, "tree") else weights

    def walk(p, g, path):
        if isinstance(p, dict):
            if not isinstance(g, dict) or set(g) != set(p):
                raise ValueError(f"pushed weight tree does not match the prototype's params "
                                 f"at {path or '<root>'}")
            return {k: walk(p[k], g[k], f"{path}.{k}" if path else k) for k in p}
        if tuple(np.shape(g)) != tuple(p.shape):
            raise ValueError(f"pushed weight leaf {path} shape {tuple(np.shape(g))} != "
                             f"prototype {tuple(p.shape)}")
        return torch.as_tensor(np.asarray(g) if not isinstance(g, torch.Tensor) else g,
                               device=p.device).to(p.dtype)

    return walk(proto, tree, "")


class ServingEngine:
    """submit()/step()/drain() over a backend (Dense or MoE).

    Whole-prompt prefill: each step prefills every request admitted in it
    in one batched call, bucketed to the next power of two of its longest
    prompt, then runs the step's decode pass. ``priority_classes`` admits
    ``interactive`` before ``batch`` requests (FIFO within a class);
    ``tenant_fair`` admits by per-tenant deficit round-robin (a dict passes
    the scheduler's ``quantum`` / ``rate`` / ``burst``)."""

    _stats_seq = 0  # distinct registry source name per registered engine

    def __init__(self, backend, *, max_queue: Optional[int] = None,
                 register_stats: bool = False,
                 prefill_chunk: Optional[int] = None,
                 step_tokens: Optional[int] = None,
                 prefix_cache=None,
                 kv_tiers=None,
                 chunk_sink=None,
                 spec_k: Optional[int] = None,
                 drafter=None,
                 priority_classes: bool = False,
                 preempt: bool = False,
                 adapters=None,
                 tenant_fair=None,
                 step_stall_s: Optional[float] = None):
        for knob, value, item, module in (
                ("prefill_chunk", prefill_chunk, "10g", "chunked prefill"),
                ("step_tokens", step_tokens, "10g", "chunked prefill"),
                ("chunk_sink", chunk_sink, "10g", "chunked prefill"),
                ("preempt", preempt or None, "10g", "chunked prefill (preemption pauses at "
                                                    "chunk boundaries)"),
                ("spec_k", spec_k, "10a", "serving/spec.py"),
                ("drafter", drafter, "10a", "serving/spec.py"),
                ("prefix_cache", prefix_cache, "10b", "serving/prefix_cache.py"),
                ("adapters", adapters, "10c", "serving/adapters.py"),
                ("kv_tiers", kv_tiers, "10f", "serving/kv_tiers.py")):
            if value is not None:
                raise ValueError(_later(knob, item, module))
        if tenant_fair and priority_classes:
            raise ValueError(
                "tenant_fair and priority_classes are mutually exclusive "
                "admission policies: per-tenant DRR has no class ladder "
                "(within a tenant, order is FIFO)"
            )
        if step_stall_s is not None and step_stall_s <= 0:
            raise ValueError(f"step_stall_s must be > 0, got {step_stall_s}")
        self.backend = backend
        self.pool = SlotPool(backend.n_slots)
        if tenant_fair:
            kw = dict(tenant_fair) if isinstance(tenant_fair, dict) else {}
            self.sched = TenantFairScheduler(max_queue=max_queue, **kw)
        elif priority_classes:
            self.sched = PriorityScheduler(max_queue=max_queue)
        else:
            self.sched = FIFOScheduler(max_queue=max_queue)
        self.metrics = ServingMetrics()
        # per-slot sampling rows, stamped at admission and cleared at
        # retire; the batched calls ship copies
        self._sampling = slot_arrays(backend.n_slots)
        self._by_slot = {}  # slot -> Request (every occupied slot)
        self._last_tok = np.zeros(backend.n_slots, np.int32)
        self._next_rid = 0
        self.step_stall_s = step_stall_s  # flight step_stall budget (off=None)
        self._conservation_fired = False
        self._flight_name = f"engine:{id(self):x}"
        obs.flight_provider(self._flight_name, self._flight_state)
        self._stats_name: Optional[str] = None
        if register_stats:
            n = ServingEngine._stats_seq
            ServingEngine._stats_seq += 1
            self._stats_name = "serving" if n == 0 else f"serving-{n}"
            self.metrics.register(self, self._stats_name)

    # -- the parts of later slices ------------------------------------------
    def attach_fleet(self, fleet) -> None:
        raise NotImplementedError(_later("attach_fleet", "10i", "serving/fleet.py"))

    def adopt(self, *args, **kwargs) -> Request:
        raise NotImplementedError(_later("adopt", "10h", "serving/disagg.py"))

    def kill(self) -> None:
        raise NotImplementedError(_later("kill", "10e", "serving/health.py"))

    def evacuate(self):
        raise NotImplementedError(_later("evacuate", "10e", "serving/health.py"))

    # -- submission ---------------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               priority: str = "interactive",
               deadline_ms: Optional[float] = None,
               tenant: str = "default",
               sampling: Optional[SamplingParams] = None,
               adapter: Optional[str] = None,
               trace=None) -> Optional[Request]:
        """Queue one request. Returns the Request, or None when rejected by
        backpressure (bounded queue full). ``priority`` picks the SLO class
        (meaningful on a ``priority_classes`` engine; a FIFO engine records
        the label). ``deadline_ms`` is an admission deadline: still queued
        that long after submit, the request leaves as EXPIRED. ``tenant``
        labels the request's metrics and picks its queue under
        ``tenant_fair``. ``sampling`` switches the request from greedy to
        lockstep-seeded sampling. ``trace`` carries an upstream
        :class:`~uccl_tpu_torch.obs.TraceContext`; None mints one."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must be non-empty")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size + max_new_tokens > self.backend.max_seq:
            raise ValueError(
                f"prompt {prompt.size} + new {max_new_tokens} tokens exceed "
                f"max_seq {self.backend.max_seq}: the slot would overflow"
            )
        if priority not in PRIORITY_CLASSES:
            raise ValueError(f"unknown priority {priority!r} (classes: {PRIORITY_CLASSES})")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        if not tenant or not isinstance(tenant, str):
            raise ValueError(f"tenant must be a non-empty string, got {tenant!r}")
        if sampling is not None and not isinstance(sampling, SamplingParams):
            raise ValueError(f"sampling must be a SamplingParams, got "
                             f"{type(sampling).__name__}")
        if adapter is not None:
            raise ValueError(_later("adapter", "10c", "serving/adapters.py"))
        ctx = trace if trace is not None else obs.new_context()
        req = Request(
            rid=self._next_rid, prompt=prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
            t_submit=now(), priority=priority, deadline_ms=deadline_ms, tenant=tenant,
            sampling=sampling, trace_id=ctx.trace_id, span_id=ctx.span_id,
        )
        self._next_rid += 1
        self.metrics.on_submit(req)
        obs.instant("submit", track=req.track, rid=req.rid, prompt_len=int(prompt.size),
                    max_new_tokens=max_new_tokens, cls=priority, tenant=tenant,
                    trace_id=req.trace_id)
        if not self.sched.submit(req):
            self.metrics.on_reject(req)
            _REJECTS.inc()
            obs.instant("reject", track=req.track, rid=req.rid)
            return None
        return req

    def cancel(self, rid: int) -> bool:
        """Withdraw a still-QUEUED request: it leaves as EXPIRED with
        ``finish_reason="cancel"``. False when ``rid`` is not queued."""
        req = self.sched.cancel(rid)
        if req is None:
            return False
        self.metrics.on_expire(req)
        _DROPPED.inc(reason="cancel")
        obs.instant("cancel", track=req.track, rid=req.rid)
        return True

    # -- the engine iteration ----------------------------------------------
    def has_work(self) -> bool:
        return bool(self.sched.qsize or self._by_slot)

    def step(self) -> List[Request]:
        """One iteration: admit and prefill, one masked decode, retire.
        Returns the requests finished during this step."""
        t0 = now()
        tr = obs.get_tracer()
        ts0 = tr.now_us() if tr is not None else 0.0
        finished: List[Request] = []
        # queue aging first: an expired request must not take this step's
        # admission
        for req in self.sched.expire(t0):
            self.metrics.on_expire(req)
            _DROPPED.inc(reason="deadline")
            obs.instant("expire", track=req.track, rid=req.rid, deadline_ms=req.deadline_ms)
        newly = self.sched.admit(self.pool)
        if newly:
            self._prefill(newly, finished)
        if self._by_slot:
            self._decode(finished)
        dt = now() - t0
        self.metrics.on_step(dt)
        if tr is not None:
            tr.complete("engine.step", ts0, tr.now_us() - ts0, "engine",
                        active=len(self._by_slot), queued=self.sched.qsize,
                        finished=len(finished))
        _OCCUPANCY.set(self.pool.occupancy)
        _HIGH_WATER.set(self.pool.high_water)
        if self.step_stall_s is not None and dt > self.step_stall_s:
            obs.flight_trigger(
                "step_stall", key=self._flight_name, dur_s=round(dt, 6),
                budget_s=self.step_stall_s, occupancy=round(self.pool.occupancy, 4),
                queued=self.sched.qsize, active=len(self._by_slot))
        self._check_conservation()
        return finished

    def drain(self, max_steps: int = 100000) -> List[Request]:
        """Step until queue and slots are empty; returns all finished."""
        done: List[Request] = []
        steps = 0
        while self.has_work():
            done.extend(self.step())
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"drain exceeded {max_steps} steps with work remaining "
                    f"(queued={self.sched.qsize}, active={len(self._by_slot)})")
        return done

    def snapshot(self) -> dict:
        return self.metrics.snapshot(
            queued=self.sched.qsize, active=len(self._by_slot),
            n_slots=self.pool.n_slots, occupancy=self.pool.occupancy,
        )

    def reset_metrics(self) -> None:
        """Zero counters and samples (e.g. after warmup) and the process-wide
        serving latency histograms; the pool, queue and KV are untouched."""
        self.metrics = ServingMetrics()
        reset_latency_histograms()

    def _flight_state(self) -> dict:
        """What a post-mortem bundle captures of this engine: occupancy and
        queue shape, never request payloads."""
        return {
            "n_slots": self.pool.n_slots,
            "occupancy": round(self.pool.occupancy, 4),
            "high_water": self.pool.high_water,
            "active": len(self._by_slot),
            "queued": self.sched.qsize,
            "scheduler": self.sched.debug_state(),
            "conservation": self._conservation_terms(),
        }

    def _conservation_terms(self) -> dict:
        m = self.metrics
        return {"submitted": m.submitted, "completed": m.completed,
                "active": len(self._by_slot), "queued": self.sched.qsize,
                "rejected": m.rejected, "expired": m.expired, "lost": m.lost}

    def conservation_holds(self) -> bool:
        """submitted == completed + active + queued + rejected + expired +
        lost, the serving invariant every step re-asserts."""
        t = self._conservation_terms()
        return t["submitted"] == sum(v for k, v in t.items() if k != "submitted")

    def _check_conservation(self) -> None:
        """Re-assert the invariant at a step boundary; a violation freezes
        the evidence once (the first broken step is the interesting one)."""
        if self._conservation_fired or self.conservation_holds():
            return
        self._conservation_fired = True
        t = self._conservation_terms()
        obs.flight_trigger("conservation", key=self._flight_name, terms=t,
                           rhs=sum(v for k, v in t.items() if k != "submitted"))

    def close(self) -> None:
        if self._stats_name is not None:
            self.metrics.unregister(self._stats_name)
            self._stats_name = None
        obs.flight_unregister(self._flight_name)

    # -- internals ----------------------------------------------------------
    def _sampling_for(self, rows, pos0=None):
        """The packed per-slot sampling tuple for a batched call covering
        ``rows`` ((slot, req) pairs): None when every covered request is
        greedy. ``pos0`` is each slot's output index for the first token
        the call emits (None = zeros: prefill's first token)."""
        if not any(r.sampling is not None for _, r in rows):
            return None
        if pos0 is None:
            pos0 = np.zeros(self.backend.n_slots, np.int32)
        return pack_sampling(self._sampling, pos0)

    def _extra_kw(self, rows, pos0=None) -> dict:
        samp = self._sampling_for(rows, pos0)
        return {} if samp is None else {"sampling": samp}

    def _prefill(self, newly, finished) -> None:
        n = self.backend.n_slots
        s_bucket = _bucket(max(r.prompt.size for _, r in newly), self.backend.max_seq)
        tokens = np.zeros((n, s_bucket), np.int32)
        lens = np.ones(n, np.int32)  # 1 (not 0): the -1 logit gather stays
        mask = np.zeros(n, bool)     # in bounds on non-admitted rows
        for slot, req in newly:
            tokens[slot, :req.prompt.size] = req.prompt
            lens[slot] = req.prompt.size
            mask[slot] = True
            stamp_slot(self._sampling, slot, req.sampling)
            self.metrics.on_admit(req)
            obs.instant("admit", track=req.track, slot=slot)
        _PREFILL_TOKENS.inc(sum(int(r.prompt.size) for _, r in newly), kind="computed")
        tr = obs.get_tracer()
        ts0 = tr.now_us() if tr is not None else 0.0
        t0 = now()
        tok = self.backend.prefill(tokens, lens, mask, **self._extra_kw(newly))
        self.metrics.on_prefill(now() - t0, len(newly))
        t_done = now()
        if tr is not None:
            dur = tr.now_us() - ts0
            tr.complete("wire.prefill", ts0, dur, "wire", n=len(newly), bucket=s_bucket)
            for slot, req in newly:
                tr.complete("prefill", ts0, dur, req.track, slot=slot)
        for slot, req in newly:
            self._by_slot[slot] = req
            req.prefill_pos = req.prompt.size
            req.prefill_bucket = s_bucket
            self._emit_first_token(slot, req, tok[slot], t_done, finished)

    def _decode(self, finished) -> None:
        decoding = dict(self._by_slot)
        active = np.zeros(self.backend.n_slots, bool)
        pos0 = np.zeros(self.backend.n_slots, np.int32)
        for slot, req in decoding.items():
            active[slot] = True
            pos0[slot] = req.n_generated  # this step's output index
        tr = obs.get_tracer()
        ts0 = tr.now_us() if tr is not None else 0.0
        t0 = now()
        tok = self.backend.decode(self._last_tok.copy(), active,
                                  **self._extra_kw(list(decoding.items()), pos0))
        self.metrics.on_decode_step(now() - t0, len(decoding), tokens=len(decoding))
        t_done = now()
        if tr is not None:
            tr.complete("wire.decode", ts0, tr.now_us() - ts0, "wire", n=len(decoding))
        for slot, req in decoding.items():
            self._last_tok[slot] = tok[slot]
            req.out_tokens.append(int(tok[slot]))
            self._maybe_retire(slot, req, t_done, finished)

    def _emit_first_token(self, slot: int, req: Request, tok_val, t: float,
                          finished) -> None:
        """Record a request's first generated token: seed the decode input,
        stamp TTFT, maybe retire."""
        self._last_tok[slot] = tok_val
        req.out_tokens.append(int(tok_val))
        req.t_first_token = t
        self.metrics.on_first_token(req)
        obs.instant("first_token", track=req.track, ttft_ms=round(req.ttft * 1e3, 3),
                    trace_id=req.trace_id)
        self._maybe_retire(slot, req, t, finished)

    def _maybe_retire(self, slot: int, req: Request, t: float, finished) -> None:
        if req.eos_id is not None and req.out_tokens[-1] == req.eos_id:
            req.finish_reason = "eos"
        elif req.n_generated >= req.max_new_tokens:
            req.finish_reason = "length"
        else:
            return
        req.state = RequestState.FINISHED
        req.t_finish = t
        stamp_slot(self._sampling, slot, None)
        self.pool.free(slot)
        self._by_slot.pop(slot, None)
        self.metrics.on_finish(req)
        _TENANT_REQS.inc(tenant=req.tenant)
        _TENANT_TOKS.inc(req.n_generated, tenant=req.tenant)
        obs.instant("finish", track=req.track, reason=req.finish_reason,
                    tokens=req.n_generated, parked=False, trace_id=req.trace_id)
        finished.append(req)
