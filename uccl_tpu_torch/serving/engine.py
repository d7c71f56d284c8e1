"""Continuous-batching serving engine over the KV slot pool.

Port of ``uccl_tpu/serving/engine.py``. ``submit()`` queues a request; each
``step()`` (1) admits queue-head requests into free KV slots and prefills
exactly those slots (masked: mid-decode neighbours are untouched), (2) runs
one masked batched decode step over every active slot, (3) retires
sequences on EOS or token budget and frees (or, with a prefix cache,
parks) their slots. ``drain()`` steps until idle.

Chunked prefill (``prefill_chunk=C``) bounds decode stalls: each admitted
request advances its prefill cursor by one C-token chunk per step in one
``[n_slots, C]`` call, and the step still runs its decode pass. On top of
it: the step-token budget, preemption by SLO class, the prefix cache and
its host tier, speculative decoding, per-tenant LoRA adapters, and
``kill`` / ``evacuate`` for the router's failure handling.

The engine is exact, not approximate: each request's tokens equal its run
alone on the same slot programs (``replay_alone``) on any device, and on
the CPU the one-shot ``generate`` oracle's, tested on both stacks. The
backends hold the model and the KV pool as torch tensors on one device;
the engine itself is host code (numpy), and every batched call returns its
tokens to the host, so a step's wall time covers its device work.

``adopt`` (disaggregated prefill) and ``attach_fleet`` (the fleet prefix
directory) raise ``NotImplementedError`` naming their ROADMAP queue A item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

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
from uccl_tpu_torch.serving.spec import (
    SPEC_ACCEPTED_LEN as _SPEC_ACCEPTED_LEN, SPEC_TOKENS as _SPEC_TOKENS, NGramDrafter,
)

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
_PREEMPTS = obs.counter(
    "serving_preempted_total",
    "batch-class requests paused at a chunk boundary (KV saved, slot "
    "handed to an interactive arrival)",
)
_RESUMES = obs.counter(
    "serving_resumed_total",
    "preempted requests re-admitted with their KV restored (bit-exact "
    "continuation at the saved cursor)",
)
_SPEC_RESAMPLE = obs.counter(
    "spec_resample_total",
    "sampled verify windows with a rejected draft: the committed token at "
    "the first rejection is the residual-distribution resample (the "
    "rejection-sampling correction)",
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


@dataclass
class ChunkEvent:
    """One slot's KV rows [lo, hi) became valid during this engine step:
    computed by a prefill chunk (``reused=False``) or copied from a
    prefix-cache donor at admission (``reused=True``). The engine hands
    these to its ``chunk_sink`` BEFORE any retirement in the same step, so
    a sink can export the rows while the slot still holds them."""

    req: Request
    slot: int
    lo: int
    hi: int
    done: bool  # this event completes the request's prefill
    first_token: Optional[int]  # set iff done
    reused: bool


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
    parameters' device. ``adapters`` arguments are ``(tables, ids)``: the
    stacked LoRA tables (``AdapterStore.device_tables``) and each slot's
    table row."""

    def __init__(self, params, cfg, *, n_slots: int, max_seq: int):
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.cache = _inference.SlotKVCache.empty(cfg, n_slots, max_seq,
                                                  device=params["embed"].device)

    def prefill(self, tokens: np.ndarray, lens: np.ndarray, mask: np.ndarray,
                start: Optional[np.ndarray] = None, sampling=None,
                adapters=None) -> np.ndarray:
        t, self.cache = _inference.prefill_slots(
            self.params, tokens, lens, mask, self.cache, self.cfg, start=start,
            sampling=sampling, **_adapter_kw(adapters))
        return _host(t)

    def decode(self, tokens: np.ndarray, active: np.ndarray, sampling=None,
               adapters=None) -> np.ndarray:
        t, self.cache = _inference.decode_step_slots(
            self.params, tokens, active, self.cache, self.cfg, sampling=sampling,
            **_adapter_kw(adapters))
        return _host(t)

    def verify(self, tokens: np.ndarray, active: np.ndarray, sampling=None, adapters=None):
        """One batched ``[n_slots, k+1]`` draft-verify window (speculative
        decoding): returns (target tokens ``[n_slots, k+1]``, n_accepted
        ``[n_slots]``)."""
        t, n_acc, self.cache = _inference.verify_slots(
            self.params, tokens, active, self.cache, self.cfg, sampling=sampling,
            **_adapter_kw(adapters))
        return _host(t), _host(n_acc)

    # slot KV movement (prefix-cache hits, tier moves, preemption): thin
    # shims over the cache's export/import views
    def export_slot_kv(self, slot: int, lo: int, hi: int):
        return self.cache.export_rows(slot, lo, hi)

    def import_slot_kv(self, slot: int, k_rows, v_rows, *, length: int) -> None:
        self.cache = self.cache.import_rows(slot, k_rows, v_rows, length=length)

    def copy_slot_prefix(self, dst: int, src: int, n: int) -> None:
        self.cache = self.cache.copy_prefix(dst, src, n)


class MoEBackend:
    """Slot-pool serving over the EP MoE stack: slots are the ``[W, B_loc]``
    rows of the server's cache (slot s is member s // B_loc, row s % B_loc);
    prefill and verify route through the sorted EP path, decode through the
    packed LL path (the DeepEP decode regime) by default."""

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
                start: Optional[np.ndarray] = None, sampling=None,
                adapters=None) -> np.ndarray:
        t, self.cache = self.server.prefill_slots(
            self.params, self._grid(tokens), self._grid(lens), self._grid(mask), self.cache,
            start=None if start is None else self._grid(start), sampling=sampling,
            **_adapter_kw(adapters))
        return _host(t).reshape(self.n_slots)

    def decode(self, tokens: np.ndarray, active: np.ndarray, sampling=None,
               adapters=None) -> np.ndarray:
        t, self.cache = self.server.decode_step_slots(
            self.params, self._grid(tokens), self._grid(active), self.cache,
            impl=self.decode_impl, sampling=sampling, **_adapter_kw(adapters))
        return _host(t).reshape(self.n_slots)

    def verify(self, tokens: np.ndarray, active: np.ndarray, sampling=None, adapters=None):
        """One batched ``[n_slots, k+1]`` draft-verify window through the
        sorted EP path (the multi-token regime, like prefill). Returns
        (target tokens ``[n_slots, k+1]``, n_accepted ``[n_slots]``)."""
        t, n_acc, self.cache = self.server.verify_slots(
            self.params, self._grid(tokens), self._grid(active), self.cache,
            sampling=sampling, **_adapter_kw(adapters))
        return _host(t).reshape(self.n_slots, -1), _host(n_acc).reshape(self.n_slots)

    # slot KV movement: MoESlotCache maps flat slot ids to its [W, B_loc]
    # grid, so the engine-facing surface matches DenseBackend's
    def export_slot_kv(self, slot: int, lo: int, hi: int):
        return self.cache.export_rows(slot, lo, hi)

    def import_slot_kv(self, slot: int, k_rows, v_rows, *, length: int) -> None:
        self.cache = self.cache.import_rows(slot, k_rows, v_rows, length=length)

    def copy_slot_prefix(self, dst: int, src: int, n: int) -> None:
        self.cache = self.cache.copy_prefix(dst, src, n)


def _adapter_kw(adapters) -> dict:
    if adapters is None:
        return {}
    tables, ids = adapters
    return {"adapters": tables, "adapter_ids": ids}


def replay_alone(backend, req: Request, *, drafter=None, adapters=None) -> np.ndarray:
    """The engine's exactness oracle: ``req`` run again, alone, on a fresh
    copy of ``backend``'s slot programs, in the slot it ended in, every
    other slot idle. Returns its tokens (``req.n_generated`` of them when
    the engine was exact).

    The replay runs the calls the engine ran the request through, at their
    shapes: the whole-prompt prefill at its bucket (``req.prefill_bucket``),
    or the chunked prefill's ``[n_slots, C]`` windows at the multiples of
    C (``req.prefill_chunk``) from position 0, cold, so rows a prefix hit,
    a tier promotion or a preemption resume gave the request are computed
    here in its own slot; then one-token decodes, or with ``req.spec_k``
    the ``[n_slots, k+1]`` verify windows that ``drafter`` (the engine's;
    default :class:`~uccl_tpu_torch.serving.spec.NGramDrafter`) fills from
    the request's own context, so the windows are the engine's. A request
    that fused an adapter replays it from ``adapters`` (the engine's
    :class:`~uccl_tpu_torch.serving.adapters.AdapterStore`).

    Every call keeps the shapes it had in the engine's batch: the slot grid
    is fixed, and the MoE stack's expert products run on fixed blocks
    (``ep/ll.grouped_ffn``; the sorted path's capacity follows the token
    count). A row's result then depends on nothing else the batch held nor
    on the slot that computed it, so the tokens equal the engine's bit for
    bit on any device. The one-shot ``generate`` oracle runs other shapes;
    a GPU's GEMM and reduction kernels pick their summation order by shape,
    so on the card a near-tie there (a router's top-2 or the argmax) can
    fall the other way, and only the CPU holds the engine to ``generate``
    exactly."""
    if req.slot is None or (req.prefill_bucket is None and req.prefill_chunk is None):
        raise ValueError(f"request {req.rid} was never prefilled by the engine")
    b = _same_backend(backend, backend.params)
    n, slot, size = b.n_slots, req.slot, req.prompt.size
    samp = slot_arrays(n)
    stamp_slot(samp, slot, req.sampling)
    pos = np.zeros(n, np.int32)
    adp = None
    if req.adapter is not None:
        if adapters is None:
            raise ValueError(f"request {req.rid} fused adapter {req.adapter!r}: pass the "
                             "engine's AdapterStore")
        ids = np.zeros(n, np.int32)
        ids[slot] = 1
        adp = (adapters.tables_of(req.adapter), ids)

    def kw():
        out = {} if req.sampling is None else {"sampling": pack_sampling(samp, pos)}
        if adp is not None:
            out["adapters"] = adp
        return out

    lens = np.ones(n, np.int32)
    lens[slot] = size
    active = np.zeros(n, bool)
    active[slot] = True
    if req.prefill_chunk is None:
        tokens = np.zeros((n, req.prefill_bucket), np.int32)
        tokens[slot, :size] = req.prompt
        first = b.prefill(tokens, lens, active, **kw())[slot]
    else:
        c = req.prefill_chunk
        for lo in range(0, size, c):
            tokens = np.zeros((n, c), np.int32)
            chunk = req.prompt[lo:lo + c]
            tokens[slot, :chunk.size] = chunk
            start = np.zeros(n, np.int32)
            start[slot] = lo
            first = b.prefill(tokens, lens, active, start=start, **kw())[slot]
    out = [int(first)]
    last = np.zeros(n, np.int32)
    if req.spec_k is None:
        while len(out) < req.n_generated:
            last[slot], pos[slot] = out[-1], len(out)
            out.append(int(b.decode(last, active, **kw())[slot]))
        return np.asarray(out, np.int32)
    from uccl_tpu_torch.serving.spec import NGramDrafter

    k, drafter = req.spec_k, drafter if drafter is not None else NGramDrafter()
    while len(out) < req.n_generated:
        window = np.zeros((n, k + 1), np.int32)
        window[slot, 0] = out[-1]
        d = np.asarray(drafter.draft(np.concatenate([req.prompt, np.asarray(out, np.int32)]),
                                     k), np.int32).reshape(-1)[:k]
        window[slot, 1:1 + d.size] = d
        pos[slot] = len(out)
        tok, n_acc = b.verify(window, active, **kw())
        for j in range(int(n_acc[slot]) + 1):
            out.append(int(tok[slot, j]))
            if ((req.eos_id is not None and out[-1] == req.eos_id)
                    or len(out) >= req.max_new_tokens):
                break
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

    Whole-prompt prefill (the default): each step prefills every request
    admitted in it in one batched call, bucketed to the next power of two
    of its longest prompt, then runs the step's decode pass.

    ``prefill_chunk=C`` enables chunked prefill: admitted requests advance
    their prefill cursor by one C-token chunk per step (one prefill shape,
    ``[n_slots, C]``) and in-flight decodes run every step, so no decode
    waits behind more than one chunk. ``step_tokens`` caps a step's
    committed token spend (decode slot = 1 token, or 1+k under
    speculation; prefill chunk = C) by deferring admission. ``chunk_sink``
    receives each step's :class:`ChunkEvent` list. ``prefix_cache`` (a
    :class:`~uccl_tpu_torch.serving.prefix_cache.PrefixCache` of chunk C)
    parks retired slots as donors and resumes a matching admission at the
    cached boundary; ``kv_tiers`` (a
    :class:`~uccl_tpu_torch.serving.kv_tiers.TieredKVCache`) demotes
    evicted donors to host memory and promotes them back on a hit.
    ``priority_classes`` admits ``interactive`` before ``batch`` (FIFO
    within a class), and with ``preempt`` an interactive arrival that finds
    no slot pauses the newest batch request at a chunk boundary (its live
    KV rows go to the host, it re-queues at the head of its class and
    resumes at its cursor). ``tenant_fair`` admits by per-tenant deficit
    round-robin; ``adapters`` (an
    :class:`~uccl_tpu_torch.serving.adapters.AdapterStore`) fuses each
    request's LoRA adapter as a per-slot delta.

    ``spec_k=K`` enables speculative decoding (``serving/spec.py``): each
    decode pass becomes one batched ``[n_slots, K+1]`` draft-verify window;
    the ``drafter`` (default
    :class:`~uccl_tpu_torch.serving.spec.NGramDrafter`) proposes K tokens
    per decoding slot, greedy acceptance commits each slot's matched draft
    prefix plus one target-computed token, and rejected-position KV is dead
    by cursor rollback.
    """

    _stats_seq = 0  # distinct registry source name per registered engine

    def __init__(self, backend, *, max_queue: Optional[int] = None,
                 register_stats: bool = False,
                 prefill_chunk: Optional[int] = None,
                 step_tokens: Optional[int] = None,
                 prefix_cache=None,
                 kv_tiers=None,
                 chunk_sink: Optional[Callable[[List[ChunkEvent]], None]]
                 = None,
                 spec_k: Optional[int] = None,
                 drafter=None,
                 priority_classes: bool = False,
                 preempt: bool = False,
                 adapters=None,
                 tenant_fair=None,
                 step_stall_s: Optional[float] = None):
        if spec_k is not None:
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            if drafter is None:
                drafter = NGramDrafter()
        elif drafter is not None:
            raise ValueError(
                "drafter requires spec_k: without a draft width there is "
                "no verify window to fill"
            )
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}"
            )
        if step_tokens is not None:
            if prefill_chunk is None:
                raise ValueError(
                    "step_tokens requires prefill_chunk: the whole-prompt "
                    "path has no sub-step unit to budget with"
                )
            if step_tokens < prefill_chunk:
                raise ValueError(
                    f"step_tokens ({step_tokens}) must be >= prefill_chunk "
                    f"({prefill_chunk}), or no request could ever be "
                    "admitted"
                )
        if prefix_cache is not None:
            if prefill_chunk is None:
                raise ValueError(
                    "prefix_cache requires prefill_chunk: matches are "
                    "chunk-granular and resume via the chunked program"
                )
            if prefix_cache.chunk != prefill_chunk:
                raise ValueError(
                    f"prefix_cache.chunk ({prefix_cache.chunk}) must equal "
                    f"prefill_chunk ({prefill_chunk}): a match boundary "
                    "must be a resumable prefill position"
                )
        if kv_tiers is not None and prefix_cache is None:
            raise ValueError(
                "kv_tiers requires prefix_cache: the trie is the one index "
                "over every tier — without it there is nothing to demote "
                "from or promote into"
            )
        if chunk_sink is not None and prefill_chunk is None:
            raise ValueError(
                "chunk_sink requires prefill_chunk: the whole-prompt path "
                "emits no per-chunk availability events"
            )
        if tenant_fair and priority_classes:
            raise ValueError(
                "tenant_fair and priority_classes are mutually exclusive "
                "admission policies: per-tenant DRR has no class ladder "
                "(within a tenant, order is FIFO)"
            )
        if adapters is not None and not hasattr(adapters, "acquire"):
            raise ValueError(
                "adapters must be an AdapterStore "
                "(uccl_tpu_torch.serving.adapters)"
            )
        if preempt:
            if not priority_classes:
                raise ValueError(
                    "preempt requires priority_classes: without classes "
                    "there is no higher-priority arrival to preempt for"
                )
            if prefill_chunk is None:
                raise ValueError(
                    "preempt requires prefill_chunk: preemption pauses at "
                    "chunk boundaries and resumes via the chunked "
                    "start-offset program"
                )
        self.backend = backend
        self.spec_k = spec_k
        self.drafter = drafter
        self.prefill_chunk = prefill_chunk
        self.step_tokens = step_tokens
        self.prefix_cache = prefix_cache
        self.kv_tiers = kv_tiers
        if kv_tiers is not None:
            kv_tiers.attach(backend, prefix_cache)
        self.chunk_sink = chunk_sink
        self.priority_classes = priority_classes
        self.preempt = preempt
        self.adapters = adapters
        self.tenant_fair = bool(tenant_fair)
        self.pool = SlotPool(backend.n_slots)
        if tenant_fair:
            kw = dict(tenant_fair) if isinstance(tenant_fair, dict) else {}
            self.sched = TenantFairScheduler(max_queue=max_queue, **kw)
        elif priority_classes:
            self.sched = PriorityScheduler(max_queue=max_queue)
        else:
            self.sched = FIFOScheduler(max_queue=max_queue)
        self.metrics = ServingMetrics()
        # per-slot sampling rows + adapter table row ids: stamped at
        # admission, cleared at retire/preempt — the batched calls ship
        # copies so a mid-step mutation can never race a device program
        self._sampling = slot_arrays(backend.n_slots)
        self._adapter_ids = np.zeros(backend.n_slots, np.int32)
        self._by_slot = {}  # slot -> Request (every occupied slot)
        self._prefilling = {}  # slot -> Request mid-prefill (chunked mode)
        self.dead = False  # killed (chaos / failure injection): step() raises
        self._last_tok = np.zeros(backend.n_slots, np.int32)
        self._next_rid = 0
        if step_stall_s is not None and step_stall_s <= 0:
            raise ValueError(
                f"step_stall_s must be > 0, got {step_stall_s}"
            )
        self.step_stall_s = step_stall_s  # flight step_stall budget (off=None)
        self._conservation_fired = False
        # flight-bundle face: slot/scheduler occupancy at dump time (a
        # no-op unless a recorder is armed when the engine is built)
        self._flight_name = f"engine:{id(self):x}"
        obs.flight_provider(self._flight_name, self._flight_state)
        self._stats_name: Optional[str] = None
        if register_stats:
            # unique per engine: a second registered engine must not
            # silently replace the first's export (registry.register
            # overwrites by name), nor unhook it on close()
            n = ServingEngine._stats_seq
            ServingEngine._stats_seq += 1
            self._stats_name = "serving" if n == 0 else f"serving-{n}"
            self.metrics.register(self, self._stats_name)

    # -- the parts of later slices ------------------------------------------
    def attach_fleet(self, fleet) -> None:
        raise NotImplementedError(_later("attach_fleet", "10i", "serving/fleet.py"))

    def adopt(self, *args, **kwargs) -> Request:
        raise NotImplementedError(_later("adopt", "10h", "serving/disagg.py"))

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
        is the request's isolation identity: its queue under
        ``tenant_fair``, its metrics label and its prefix-cache namespace.
        ``sampling`` switches the request from greedy to lockstep-seeded
        sampling. ``adapter`` names a published LoRA adapter in the
        engine's AdapterStore. ``trace`` carries an upstream
        :class:`~uccl_tpu_torch.obs.TraceContext`; None mints one."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must be non-empty")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}"
            )
        if prompt.size + max_new_tokens > self.backend.max_seq:
            raise ValueError(
                f"prompt {prompt.size} + new {max_new_tokens} tokens exceed "
                f"max_seq {self.backend.max_seq}: the slot would overflow"
            )
        if priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority {priority!r} (classes: "
                f"{PRIORITY_CLASSES})"
            )
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        if not tenant or not isinstance(tenant, str):
            raise ValueError(f"tenant must be a non-empty string, got "
                             f"{tenant!r}")
        if sampling is not None and not isinstance(sampling,
                                                   SamplingParams):
            raise ValueError(
                f"sampling must be a SamplingParams, got "
                f"{type(sampling).__name__}"
            )
        if adapter is not None:
            if self.adapters is None:
                raise ValueError(
                    "adapter requires an engine AdapterStore "
                    "(ServingEngine(adapters=...))"
                )
            if not self.adapters.has(adapter):
                raise ValueError(
                    f"no published adapter for {adapter!r} (publish or "
                    f"ingest it first)"
                )
        ctx = trace if trace is not None else obs.new_context()
        req = Request(
            rid=self._next_rid, prompt=prompt,
            max_new_tokens=max_new_tokens, eos_id=eos_id, t_submit=now(),
            priority=priority, deadline_ms=deadline_ms, tenant=tenant,
            sampling=sampling, adapter=adapter,
            trace_id=ctx.trace_id, span_id=ctx.span_id,
        )
        self._next_rid += 1
        self.metrics.on_submit(req)
        obs.instant("submit", track=req.track, rid=req.rid,
                    prompt_len=int(prompt.size),
                    max_new_tokens=max_new_tokens, cls=priority,
                    tenant=tenant, trace_id=req.trace_id)
        if not self.sched.submit(req):
            self.metrics.on_reject(req)
            _REJECTS.inc()
            obs.instant("reject", track=req.track, rid=req.rid)
            return None
        return req

    def cancel(self, rid: int) -> bool:
        """Withdraw a still-QUEUED request: it leaves the queue as
        ``RequestState.EXPIRED`` with ``finish_reason="cancel"``, counted
        on ``serving_rejected_total{reason="cancel"}``. Returns False when
        ``rid`` is not queued (already admitted, finished, or unknown) —
        in-slot requests run to completion."""
        req = self.sched.cancel(rid)
        if req is None:
            return False
        self.metrics.on_expire(req)
        _DROPPED.inc(reason="cancel")
        obs.instant("cancel", track=req.track, rid=req.rid)
        return True

    def pending_tokens(self) -> int:
        """Outstanding token work across queue and slots: every request's
        remaining prefill tokens plus its remaining decode budget — the
        router's per-replica step-debt signal (serving/router.py).
        A queued fresh request counts in full; a queued PREEMPTED request
        only its unfinished remainder; an in-slot request its unprefilled
        tail plus undelivered tokens."""
        debt = 0
        for r in self.sched.queued_requests():
            debt += max(0, int(r.prompt.size) - r.prefill_pos)
            debt += max(0, r.max_new_tokens - r.n_generated)
        for r in self._by_slot.values():
            debt += max(0, int(r.prompt.size) - r.prefill_pos)
            debt += max(0, r.max_new_tokens - r.n_generated)
        return debt

    # -- failure injection + recovery ---------------------------------------
    def kill(self) -> None:
        """Simulate this replica's process dying (the chaos harness /
        failure-detector testbed): the engine stops serving — ``step()``
        raises, the Router's liveness probe sees it dead — but its
        bookkeeping stays frozen until recovery :meth:`evacuate`s it.
        There is no un-kill: a returning process is a NEW replica
        (``Router.attach``), exactly as in a real fleet."""
        self.dead = True

    def evacuate(self):
        """Strip every queued and in-slot request out of this engine —
        the dead-replica recovery feed (serving/router.py): the
        requests will be re-run elsewhere (or counted lost), and THIS
        engine's queue/slot bookkeeping is zeroed so fleet aggregates
        (qsize, n_active, leaked) stop counting phantom state that died
        with the process. Parked prefix-cache donors are reclaimed too —
        a dead replica's cache is gone. Returns ``(queued, active)``
        request lists; metrics accounting is the CALLER's job (the
        router counts each on the dead engine's ``lost`` term)."""
        queued = self.sched.take_all()
        active = list(self._by_slot.values())
        for slot, r in list(self._by_slot.items()):
            self._release_slot(slot, r)
            self.pool.free(slot)
        self._by_slot.clear()
        self._prefilling.clear()
        if self.prefix_cache is not None:
            self.prefix_cache.clear(self.pool)
        return queued, active

    # -- the engine iteration ----------------------------------------------
    def has_work(self) -> bool:
        return bool(self.sched.qsize or self._by_slot)

    def step(self) -> List[Request]:
        """One iteration: admit + prefill work, one masked decode, retire.
        Whole-prompt mode prefills admitted prompts in full; chunked mode
        advances every mid-prefill request by one chunk (budget-gated
        admission). Returns requests finished during this step."""
        if self.dead:
            raise RuntimeError(
                "engine is dead (killed): a dead replica cannot step — "
                "recover its requests via Router health handling"
            )
        t0 = now()
        tr = obs.get_tracer()
        ts0 = tr.now_us() if tr is not None else 0.0
        finished: List[Request] = []
        # queue aging first: an expired request must not take this step's
        # admission (its deadline already passed at the step boundary)
        for req in self.sched.expire(t0):
            self.metrics.on_expire(req)
            _DROPPED.inc(reason="deadline")
            obs.instant("expire", track=req.track, rid=req.rid,
                        deadline_ms=req.deadline_ms)
        if self.prefill_chunk is None:
            newly, _ = self._gate_admitted(self.sched.admit(self.pool))
            if newly:
                self._prefill(newly, finished)
            if self._by_slot:
                self._decode(finished)
        else:
            self._step_chunked(finished)
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
                budget_s=self.step_stall_s,
                occupancy=round(self.pool.occupancy, 4),
                queued=self.sched.qsize, active=len(self._by_slot))
        self._check_conservation()
        return finished

    def _step_chunked(self, finished) -> None:
        """Chunked-mode iteration: budget-gated admission (evicting LRU
        prefix-cache donors when the pool is full), one batched chunk over
        every mid-prefill slot, then the step's single decode pass
        (requests whose cursor just reached the prompt end join it
        immediately — same step, like the whole-prompt path)."""
        c = self.prefill_chunk
        limit = None
        if self.step_tokens is not None:
            # committed spend this step: 1 token per decoding slot (1+k
            # when speculating — the verify window really runs k+1 rows),
            # C per mid-prefill slot; admit only what fits the remainder
            per_decode = 1 if self.spec_k is None else 1 + self.spec_k
            spend = ((len(self._by_slot) - len(self._prefilling))
                     * per_decode + len(self._prefilling) * c)
            limit = max(0, (self.step_tokens - spend) // c)
        events: List[ChunkEvent] = []
        # admit ONE at a time: each admission's prefix-cache match (and
        # donor copy) must land before the NEXT admission's make_room can
        # evict that donor — a batch admit would let admission k+1 reclaim
        # the very slot admission k is about to copy from
        while limit is None or limit > 0:
            batch = self.sched.admit(self.pool, limit=1,
                                     make_room=self._make_room)
            if not batch:
                break
            batch, deferred = self._gate_admitted(batch)
            if not batch:
                if deferred:
                    break  # adapter rows exhausted: retry next step
                continue  # adapter-lost rejection: try the next head
            if limit is not None:
                limit -= 1
            slot, req = batch[0]
            if req._saved_last_tok is not None:
                # a preemption victim coming back: restore its saved KV and
                # cursor instead of prefilling from scratch (no cache
                # match — its rows are already exact). The restored prompt
                # rows re-announce to the chunk sink: a victim preempted
                # in the same step as its admission had its original event
                # dropped (see the stale-event filter below), so the
                # stream re-ships [0, cursor) — duplicate one-sided writes
                # of identical rows are idempotent
                self._resume(slot, req)
                pos = min(req.prefill_pos, int(req.prompt.size))
                if self.chunk_sink is not None and pos > 0:
                    events.append(ChunkEvent(req, slot, 0, pos, False,
                                             None, True))
                continue
            req.state = RequestState.PARTIAL_PREFILL
            req.prefill_pos = 0
            req.prefill_chunk = c
            self._stamp_admit(slot, req)
            if self.prefix_cache is not None:
                hit_exact, hit_tag = True, None
                matched, donor = self.prefix_cache.match(req.prompt,
                                                         self._ns(req))
                if matched > 0:
                    # resume at the cached boundary: land the donor's KV
                    # rows [0, matched) in the fresh slot — a device-to-
                    # device copy for a parked-slot (T0) donor, a tier
                    # promotion (fetch + decode + import) for a T1/T2 ref —
                    # then the chunked program continues from
                    # start=matched, bit-exact when the tier is lossless
                    if isinstance(donor, (int, np.integer)):
                        self.backend.copy_slot_prefix(slot, donor, matched)
                        if self.kv_tiers is not None:
                            self.kv_tiers.count_hit("t0")
                    elif self.kv_tiers.promote(donor, slot, matched):
                        # the deferred deep-tier hit: match() leaves
                        # counting to this commit so a stale ref never
                        # inflates the reuse ledger
                        self.prefix_cache.commit_hit(matched)
                    else:
                        # stale ref (entry lost under the trie): drop it
                        # — promote() released the tier accounting and
                        # left the trie drop to this caller — and
                        # prefill cold, counted as the miss it became
                        self.prefix_cache.replace_ref(donor, None)
                        self.prefix_cache.count_stale_miss()
                        matched = 0
                    if matched > 0:
                        hit_exact = getattr(donor, "exact", True)
                        hit_tag = (int(donor)
                                   if isinstance(donor, (int, np.integer))
                                   else repr(donor))
                if matched > 0:
                    req.prefill_pos = matched
                    req.cache_hit_len = matched
                    req.cache_hit_exact = hit_exact
                    _PREFILL_TOKENS.inc(matched, kind="skipped")
                    obs.instant("prefix_hit", track=req.track, slot=slot,
                                donor=hit_tag, matched=matched)
                    events.append(ChunkEvent(req, slot, 0, matched,
                                             False, None, True))
            self._by_slot[slot] = req
            self._prefilling[slot] = req
            self.metrics.on_admit(req)
            obs.instant("admit", track=req.track, slot=slot)
        if self._prefilling:
            self._prefill_chunk_step(finished, events)
        if len(self._by_slot) > len(self._prefilling):
            self._decode(finished)

    def _make_room(self) -> bool:
        """Admission's last resort when no slot is free: evict the LRU
        prefix-cache donor; failing that, preempt a running batch-class
        request when the queue head is interactive (``preempt=True``)."""
        return self._evict_cache_donor() or self._preempt_one()

    def _evict_cache_donor(self) -> bool:
        """Evict the LRU prefix-cache donor. Live requests' slots are never
        candidates — only parked (retired, cache-resident) slots are in the
        cache. The donor the queue-head request would match is protected:
        evicting it would trade that admission's cache hit for its slot
        (when it is the ONLY parked slot, admission waits instead — a live
        retire parks or frees a slot within a bounded number of steps)."""
        if self.prefix_cache is None:
            return False
        demote = (self.kv_tiers.demote if self.kv_tiers is not None
                  else None)
        protect = None
        head = self.sched.peek()
        if head is not None:
            protect = self.prefix_cache.peek_donor(head.prompt,
                                                   self._ns(head))
        if self.prefix_cache.evict_lru(self.pool, protect=protect,
                                       demote=demote) is not None:
            return True
        # the protected donor was the ONLY candidate: with live requests
        # in flight a retire will park/free a slot within bounded steps, so
        # defer; with none, nothing can ever free a slot — evict the donor
        # (trading the head's cache hit for forward progress — though with
        # tiers attached the demotion keeps the ENTRY alive, so the head
        # still hits, just via a promotion)
        if protect is not None and not self._by_slot:
            return self.prefix_cache.evict_lru(
                self.pool, demote=demote) is not None
        return False

    def _preempt_one(self) -> bool:
        """Pause the most recently admitted batch-class request so the
        interactive queue head can take its slot. The victim's live KV rows
        are exported to host through the slot-row view (raw f32 rows, so
        restore is bitwise), its
        cursor (``prefill_pos``) and last emitted token are saved on the
        request, the slot is freed with NO cache scrub (stale rows are dead
        by the masked-attention argument), and the victim re-queues at the
        HEAD of the batch class. Resume (:meth:`_resume`) imports the rows
        into whatever slot frees up and continues mid-prefill via the
        ``start`` offset or mid-decode from the restored last token —
        output bit-identical to the unpreempted run (tested).

        Newest-first victim selection (max ``admit_seq``) preempts the
        request with the least sunk work, so older batch requests keep
        draining — preemption reorders *within* the batch class as little
        as possible. Adopted (disagg) requests have no admit_seq and are
        never victims: their KV provenance is the remote stream."""
        if not self.preempt:
            return False
        head = self.sched.peek()
        if head is None or head.priority != PRIORITY_CLASSES[0]:
            return False
        victims = [r for r in self._by_slot.values()
                   if r.priority == "batch" and r.admit_seq is not None]
        if not victims:
            return False
        victim = max(victims, key=lambda r: r.admit_seq)
        slot = victim.slot
        kv_len = victim.kv_len
        if kv_len > 0:
            # full S_max rows: one compiled export program per pool shape
            # (the import side pads to S_max anyway); the live window
            # [0, kv_len) is what resume stamps back as the length
            k_rows, v_rows = self.backend.export_slot_kv(
                slot, 0, self.backend.max_seq
            )
            victim._saved_kv = (k_rows, v_rows, kv_len)
        victim._saved_last_tok = int(self._last_tok[slot])
        self._by_slot.pop(slot)
        self._prefilling.pop(slot, None)
        self._release_slot(slot, victim)
        self.pool.free(slot)
        victim.slot = None
        victim.state = RequestState.PREEMPTED
        victim.preemptions += 1
        self.sched.requeue(victim)
        self.metrics.on_preempt(victim)
        _PREEMPTS.inc()
        obs.instant("preempt", track=victim.track, slot=slot,
                    pos=victim.prefill_pos, generated=victim.n_generated,
                    for_rid=head.rid)
        return True

    def _resume(self, slot: int, req: Request) -> None:
        """Re-enter a preempted request: import its saved KV rows into the
        newly granted slot (possibly a different one — the rows carry the
        state, not the slot id), restore the decode input token, and rejoin
        at the saved cursor: mid-prefill victims continue chunking at
        ``start=prefill_pos``, finished-prefill victims join this step's
        decode pass directly."""
        saved = req._saved_kv
        if saved is not None:
            k_rows, v_rows, kv_len = saved
            self.backend.import_slot_kv(slot, k_rows, v_rows,
                                        length=kv_len)
            req._saved_kv = None
        self._last_tok[slot] = np.int32(req._saved_last_tok)
        req._saved_last_tok = None
        # re-stamp sampling + adapter: the adapter may land on a DIFFERENT
        # table row than before preemption — row contents are the same
        # published weights, so the fused math is unchanged
        self._stamp_admit(slot, req)
        self._by_slot[slot] = req
        if req.prefill_pos < req.prompt.size:
            req.state = RequestState.PARTIAL_PREFILL
            self._prefilling[slot] = req
        # else: sched.admit already stamped ACTIVE — it decodes this step
        self.metrics.on_resume(req)
        _RESUMES.inc()
        obs.instant("resume", track=req.track, slot=slot,
                    pos=req.prefill_pos, generated=req.n_generated)

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
                    f"(queued={self.sched.qsize}, active={len(self._by_slot)})"
                )
        return done

    def snapshot(self) -> dict:
        return self.metrics.snapshot(
            queued=self.sched.qsize, active=len(self._by_slot),
            n_slots=self.pool.n_slots, occupancy=self.pool.occupancy,
        )

    def reset_metrics(self) -> None:
        """Zero counters/samples (e.g. after compile warmup) — the slot
        pool, queue and compiled programs are untouched. Also zeroes the
        process-wide serving latency HISTOGRAMS (serving/metrics.py):
        warmups reset every engine in the process before the measured
        window, so the histogram- and sample-derived percentiles keep
        describing the same observation set."""
        self.metrics = ServingMetrics()
        reset_latency_histograms()

    def _flight_state(self) -> dict:
        """What a post-mortem bundle captures of this engine: the slot
        and queue occupancy the scheduler-facing narrative needs, never
        request payloads."""
        return {
            "dead": self.dead,
            "n_slots": self.pool.n_slots,
            "occupancy": round(self.pool.occupancy, 4),
            "high_water": self.pool.high_water,
            "active": len(self._by_slot),
            "prefilling": len(self._prefilling),
            "queued": self.sched.qsize,
            "scheduler": self.sched.debug_state(),
            "conservation": self._conservation_terms(),
        }

    def _conservation_terms(self) -> dict:
        m = self.metrics
        return {"submitted": m.submitted, "completed": m.completed,
                "active": len(self._by_slot), "queued": self.sched.qsize,
                "rejected": m.rejected, "expired": m.expired,
                "lost": m.lost}

    def conservation_holds(self) -> bool:
        """submitted == completed + active + queued + rejected + expired +
        lost, the serving invariant every step re-asserts."""
        t = self._conservation_terms()
        return t["submitted"] == sum(v for k, v in t.items() if k != "submitted")

    def _check_conservation(self) -> None:
        """The serving invariant, re-asserted at every step boundary:
        submitted == completed + active + queued + rejected + expired +
        lost. A violation is unrecoverable accounting damage — freeze
        the evidence ONCE (the first broken step is the interesting one;
        later steps inherit the same corruption)."""
        if self._conservation_fired:
            return
        t = self._conservation_terms()
        rhs = sum(v for k, v in t.items() if k != "submitted")
        if t["submitted"] != rhs:
            self._conservation_fired = True
            obs.flight_trigger("conservation", key=self._flight_name,
                               terms=t, rhs=rhs)

    def close(self) -> None:
        # only tear down the stats export THIS engine registered — a
        # second engine with register_stats=False must not unhook the
        # first one's source
        if self._stats_name is not None:
            self.metrics.unregister(self._stats_name)
            self._stats_name = None
        obs.flight_unregister(self._flight_name)

    # -- internals ----------------------------------------------------------
    def _ns(self, req: Request) -> str:
        """The request's prefix-cache namespace: tenant, plus adapter
        identity AND version when one is fused — adapter deltas land on
        ``wv``, so cached KV rows are adapter-dependent and a re-published
        adapter must never hit its predecessor's rows. The default tenant
        with no adapter maps to the root namespace (single-tenant engines
        are unchanged).

        The namespace is CAPTURED at first admission (``_stamp_admit``)
        and reused verbatim for the retire-time park: a request's KV was
        computed under the adapter version pinned when it entered its
        slot, so a republish while it is in flight must not relabel the
        rows with the NEW version — that would hand v1-derived KV to v2
        requests, the exact contamination the versioning exists to stop.
        Before admission (queued peek/match) the current version is the
        right answer — that IS the version admission would pin."""
        if req._cache_ns is not None:
            return req._cache_ns
        if req.adapter is not None:
            return (f"{req.tenant}|{req.adapter}"
                    f"@{self.adapters.version(req.adapter)}")
        if req.tenant != "default":
            return req.tenant
        return ""

    def _gate_admitted(self, batch):
        """Re-validate adapters for a just-admitted batch, BEFORE any slot
        is stamped. Submit-time validation can go stale while a request
        queues: an adapter archive-evicted under ``max_published`` can
        never run again (the request exits REJECTED, ``adapter_lost``),
        and a batch needing more fresh table rows than are free or
        evictable must wait (DEFERRED back to the queue head — a retire
        will unpin a row — together with every later admission of the
        batch, so FIFO order within a tenant is preserved). Without this
        gate ``adapters.acquire`` raises inside ``step()`` AFTER the
        scheduler popped the request and the pool granted the slot,
        crashing the engine with inconsistent queue/pool state.

        The row budget is batch-aware: resident adapters the batch will
        pin are excluded from the available count (``n_available_rows``),
        so one batch can never plan a staging that evicts a row a later
        admission of the same batch needs. Returns ``(survivors,
        deferred_any)``; the scheduler never re-bills a requeued request
        (``req.billed``), so deferral retries cost the tenant nothing."""
        if self.adapters is None:
            return batch, False
        batch_resident = {r.adapter for _, r in batch
                          if r.adapter is not None
                          and self.adapters.is_resident(r.adapter)}
        avail = self.adapters.n_available_rows(exclude=batch_resident)
        staged = set()  # fresh (non-resident) adapters this batch stages
        ok, deferred = [], []
        for slot, req in batch:
            gate = None
            if deferred:
                gate = "defer"
            elif req.adapter is not None:
                if not self.adapters.has(req.adapter):
                    gate = "lost"
                elif (not self.adapters.is_resident(req.adapter)
                        and req.adapter not in staged):
                    if len(staged) >= avail:
                        gate = "defer"
                    else:
                        staged.add(req.adapter)
            if gate is None:
                ok.append((slot, req))
                continue
            self.pool.free(slot)
            if gate == "lost":
                req.state = RequestState.REJECTED
                req.slot = None
                req.finish_reason = "adapter_lost"
                self.metrics.on_expire(req)
                _DROPPED.inc(reason="adapter_lost")
                obs.instant("reject", track=req.track, rid=req.rid,
                            reason="adapter_lost")
            else:
                deferred.append(req)
        for req in reversed(deferred):
            self.sched.defer(req)
        return ok, bool(deferred)

    def _stamp_admit(self, slot: int, req: Request) -> None:
        """Slot-entry bookkeeping for sampling + adapters: write the
        request's sampling row and pin its adapter into a device table
        row (0 = the zero-rank fast path). Runs at every slot grant —
        fresh admission, preemption resume, adopt."""
        stamp_slot(self._sampling, slot, req.sampling)
        row = 0
        if req.adapter is not None:
            row = self.adapters.acquire(req.adapter)
        req._adapter_row = row
        req.spec_k = self.spec_k
        self._adapter_ids[slot] = row
        if req._cache_ns is None:
            # first slot grant: freeze the namespace under the adapter
            # version just pinned (resume/adopt re-grants keep the
            # original — their KV predates any later republish)
            req._cache_ns = self._ns(req)

    def _release_slot(self, slot: int, req: Request) -> None:
        """Undo :meth:`_stamp_admit` when the request leaves its slot
        (retire or preemption): greedy the sampling row, zero the adapter
        id, unpin the adapter table row."""
        stamp_slot(self._sampling, slot, None)
        self._adapter_ids[slot] = 0
        if req._adapter_row:
            self.adapters.release(req._adapter_row)
            req._adapter_row = 0

    def _sampling_for(self, rows, pos0=None):
        """The packed per-slot sampling tuple for a batched call covering
        ``rows`` ((slot, req) pairs) — None when every covered request is
        greedy, so the argmax programs stay byte-identical to the
        pre-sampling engine. ``pos0`` is each slot's output index for the
        first token the call emits (None = zeros: prefill's first token
        is output index 0)."""
        if not any(r.sampling is not None for _, r in rows):
            return None
        if pos0 is None:
            pos0 = np.zeros(self.backend.n_slots, np.int32)
        return pack_sampling(self._sampling, pos0)

    def _adapters_for(self, rows):
        """The (device tables, per-slot row ids) pair for a batched call —
        None when no covered request fused an adapter (id-0 rows would
        compute an exact-0.0 delta, but skipping keeps the adapter-free
        programs byte-identical)."""
        if self.adapters is None or not any(r._adapter_row
                                            for _, r in rows):
            return None
        return (self.adapters.device_tables(), self._adapter_ids.copy())

    def _extra_kw(self, rows, pos0=None) -> dict:
        """Backend-call kwargs for ``rows`` — sampling/adapters keys only
        when actually needed, so greedy adapter-free engines keep calling
        backends (including the test stubs and any external backend
        implementation) with the pre-sampling signature."""
        kw = {}
        samp = self._sampling_for(rows, pos0)
        if samp is not None:
            kw["sampling"] = samp
        adp = self._adapters_for(rows)
        if adp is not None:
            kw["adapters"] = adp
        return kw

    def _prefill(self, newly, finished) -> None:
        n = self.backend.n_slots
        s_bucket = _bucket(max(r.prompt.size for _, r in newly),
                           self.backend.max_seq)
        tokens = np.zeros((n, s_bucket), np.int32)
        lens = np.ones(n, np.int32)  # 1 (not 0): the -1 logit gather stays
        mask = np.zeros(n, bool)     # in bounds on non-admitted rows
        for slot, req in newly:
            tokens[slot, :req.prompt.size] = req.prompt
            lens[slot] = req.prompt.size
            mask[slot] = True
            self._stamp_admit(slot, req)
            self.metrics.on_admit(req)
            obs.instant("admit", track=req.track, slot=slot)
        _PREFILL_TOKENS.inc(sum(int(r.prompt.size) for _, r in newly),
                            kind="computed")
        tr = obs.get_tracer()
        ts0 = tr.now_us() if tr is not None else 0.0
        t0 = now()
        tok = self.backend.prefill(tokens, lens, mask,
                                   **self._extra_kw(newly))
        self.metrics.on_prefill(now() - t0, len(newly))
        t_done = now()
        if tr is not None:
            # one measured window, spans on every covered track: the wire
            # row shows the batched device call, each request row its share
            dur = tr.now_us() - ts0
            tr.complete("wire.prefill", ts0, dur, "wire",
                        n=len(newly), bucket=s_bucket)
            for slot, req in newly:
                tr.complete("prefill", ts0, dur, req.track, slot=slot)
        for slot, req in newly:
            self._by_slot[slot] = req
            # the whole prompt is in KV now — keep the cursor truthful so
            # pending_tokens() (the router's debt signal) never counts an
            # already-prefilled prompt as outstanding work
            req.prefill_pos = req.prompt.size
            req.prefill_bucket = s_bucket
            self._emit_first_token(slot, req, tok[slot], t_done, finished)

    def _prefill_chunk_step(self, finished,
                            events: Optional[List[ChunkEvent]] = None,
                            ) -> None:
        """Advance every mid-prefill slot by one C-token chunk (ONE batched
        call, one compiled program at [n_slots, C]). Rows whose cursor
        reaches the prompt end emit their first token and leave
        PARTIAL_PREFILL; other rows' returned tokens are garbage by the
        model contract and ignored here. ``events`` carries this step's
        admission-time prefix-cache copies; the chunk advances are appended
        and the whole batch goes to ``chunk_sink`` BEFORE any retirement,
        so a sink can export rows while slots still hold them."""
        c = self.prefill_chunk
        n = self.backend.n_slots
        tokens = np.zeros((n, c), np.int32)
        lens = np.ones(n, np.int32)  # 1 (not 0): the gather index
        start = np.zeros(n, np.int32)  # clip stays in bounds on idle rows
        mask = np.zeros(n, bool)
        for slot, req in self._prefilling.items():
            chunk = req.prompt[req.prefill_pos:req.prefill_pos + c]
            tokens[slot, :chunk.size] = chunk
            lens[slot] = req.prompt.size
            start[slot] = req.prefill_pos
            mask[slot] = True
        tr = obs.get_tracer()
        ts0 = tr.now_us() if tr is not None else 0.0
        t0 = now()
        rows = list(self._prefilling.items())
        tok = self.backend.prefill(tokens, lens, mask, start=start,
                                   **self._extra_kw(rows))
        self.metrics.on_prefill(now() - t0, len(self._prefilling),
                                chunked=True)
        t_done = now()
        if tr is not None:
            dur = tr.now_us() - ts0
            tr.complete("wire.prefill", ts0, dur, "wire",
                        n=len(self._prefilling), chunk=c)
            for slot, req in self._prefilling.items():
                tr.complete("prefill_chunk", ts0, dur, req.track,
                            slot=slot, offset=req.prefill_pos)
        if events is None:
            events = []
        computed = 0
        advanced = []
        for slot, req in self._prefilling.items():
            old = req.prefill_pos
            req.prefill_pos = min(old + c, req.prompt.size)
            done = req.prefill_pos >= req.prompt.size
            computed += req.prefill_pos - old
            events.append(ChunkEvent(
                req, slot, old, req.prefill_pos, done,
                int(tok[slot]) if done else None, False,
            ))
            advanced.append((slot, req, done))
        _PREFILL_TOKENS.inc(computed, kind="computed")
        if self.chunk_sink is not None:
            # drop events whose slot changed hands since they were queued:
            # an admission-time prefix-copy event whose request was
            # preempted later in the SAME admission loop would otherwise
            # export rows now owned by the request that took the slot
            self.chunk_sink([ev for ev in events
                             if self._by_slot.get(ev.slot) is ev.req])
        for slot, req, done in advanced:
            if not done:
                continue  # more chunks to go — next step
            del self._prefilling[slot]
            req.state = RequestState.ACTIVE
            self._emit_first_token(slot, req, tok[slot], t_done, finished)

    def _decode(self, finished) -> None:
        decoding = {s: r for s, r in self._by_slot.items()
                    if s not in self._prefilling}
        if self.spec_k is not None:
            self._spec_decode(decoding, finished)
            return
        active = np.zeros(self.backend.n_slots, bool)
        pos0 = np.zeros(self.backend.n_slots, np.int32)
        for slot, req in decoding.items():
            active[slot] = True
            pos0[slot] = req.n_generated  # this step's output index
        rows = list(decoding.items())
        tr = obs.get_tracer()
        ts0 = tr.now_us() if tr is not None else 0.0
        t0 = now()
        tok = self.backend.decode(self._last_tok.copy(), active,
                                  **self._extra_kw(rows, pos0))
        self.metrics.on_decode_step(now() - t0, len(decoding),
                                    tokens=len(decoding))
        t_done = now()
        if tr is not None:
            tr.complete("wire.decode", ts0, tr.now_us() - ts0, "wire",
                        n=len(decoding))
        for slot, req in list(decoding.items()):
            self._last_tok[slot] = tok[slot]
            req.out_tokens.append(int(tok[slot]))
            self._maybe_retire(slot, req, t_done, finished)

    def _spec_decode(self, decoding, finished) -> None:
        """One speculative decode iteration: draft k tokens per decoding
        slot (host-side), verify every slot in ONE batched
        [n_slots, k+1] window, commit each slot's accepted prefix plus the
        target-computed correction/bonus token. Commits stop early at EOS
        or the token budget (both retire the request, so the over-advanced
        device cursor is dead with the slot). Drafters may propose fewer
        than k tokens — the window pads with zeros, and a pad that happens
        to match still commits a correct token (acceptance only ever
        commits the target's own argmaxes)."""
        k = self.spec_k
        n = self.backend.n_slots
        tokens = np.zeros((n, k + 1), np.int32)
        active = np.zeros(n, bool)
        proposed = np.zeros(n, np.int32)
        pos0 = np.zeros(n, np.int32)
        for slot, req in decoding.items():
            tokens[slot, 0] = self._last_tok[slot]
            d = np.asarray(self.drafter.draft(req.context(), k),
                           np.int32).reshape(-1)[:k]
            if d.size:
                tokens[slot, 1:1 + d.size] = d
            proposed[slot] = d.size
            active[slot] = True
            pos0[slot] = req.n_generated  # window column j → pos0 + j
        rows = list(decoding.items())
        tr = obs.get_tracer()
        ts0 = tr.now_us() if tr is not None else 0.0
        t0 = now()
        tok, n_acc = self.backend.verify(tokens, active,
                                         **self._extra_kw(rows, pos0))
        dt = now() - t0
        t_done = now()
        if tr is not None:
            # the device window only — the host commit loop below must not
            # inflate the span (same placement as _decode's wire.decode)
            tr.complete("wire.verify", ts0, tr.now_us() - ts0, "wire",
                        n=len(decoding), k=k)
        committed_total = 0
        for slot, req in list(decoding.items()):
            m = int(n_acc[slot])
            committed = 0
            for j in range(m + 1):
                t = int(tok[slot, j])
                self._last_tok[slot] = tok[slot, j]
                req.out_tokens.append(t)
                committed += 1
                if ((req.eos_id is not None and t == req.eos_id)
                        or req.n_generated >= req.max_new_tokens):
                    break
            committed_total += committed
            # telemetry meters DRAFTED tokens only: the window pads
            # undrafted positions with zeros, and a pad that coincidentally
            # matches the argmax still COMMITS (it is the target's own
            # token) but must not count as an accepted speculation — nor an
            # abstention as k rejections
            p = int(proposed[slot])
            acc = min(m, p)
            if (acc < p and req.sampling is not None
                    and req.sampling.temperature > 0):
                # a sampled window hit a rejection: the committed token at
                # the rejection position IS the residual resample (the
                # deterministic-drafter rejection-sampling coupling),
                # so meter the correction
                _SPEC_RESAMPLE.inc()
            _SPEC_TOKENS.inc(acc, outcome="accepted")
            _SPEC_TOKENS.inc(p - acc, outcome="rejected")
            _SPEC_TOKENS.inc(1, outcome="bonus")
            _SPEC_ACCEPTED_LEN.inc(1, len=str(acc))
            self.metrics.on_spec(proposed=p, accepted=acc)
            self._maybe_retire(slot, req, t_done, finished)
        self.metrics.on_decode_step(dt, len(decoding),
                                    tokens=committed_total)

    def _emit_first_token(self, slot: int, req: Request, tok_val, t: float,
                          finished) -> None:
        """Record a request's first generated token (prefill completion in
        either mode): seed the decode input, stamp TTFT, maybe retire."""
        self._last_tok[slot] = tok_val
        req.out_tokens.append(int(tok_val))
        req.t_first_token = t
        self.metrics.on_first_token(req)
        obs.instant("first_token", track=req.track,
                    ttft_ms=round(req.ttft * 1e3, 3),
                    trace_id=req.trace_id)
        self._maybe_retire(slot, req, t, finished)

    def _maybe_retire(self, slot: int, req: Request, t: float,
                      finished) -> None:
        if req.eos_id is not None and req.out_tokens[-1] == req.eos_id:
            req.finish_reason = "eos"
        elif req.n_generated >= req.max_new_tokens:
            req.finish_reason = "length"
        else:
            return
        req.state = RequestState.FINISHED
        req.t_finish = t
        self._release_slot(slot, req)
        # park-on-retire: with a prefix cache, the retiring slot's prompt
        # KV stays resident as a reuse donor (LRU-evicted under admission
        # pressure) instead of being freed — under the request's tenant/
        # adapter namespace, so a cross-tenant prompt never hits these rows
        parked = (self.prefix_cache is not None
                  and self.prefix_cache.park(self.pool, slot, req.prompt,
                                             self._ns(req)))
        if not parked:
            self.pool.free(slot)
        self._by_slot.pop(slot, None)
        self.metrics.on_finish(req)
        _TENANT_REQS.inc(tenant=req.tenant)
        _TENANT_TOKS.inc(req.n_generated, tenant=req.tenant)
        obs.instant("finish", track=req.track, reason=req.finish_reason,
                    tokens=req.n_generated, parked=parked,
                    trace_id=req.trace_id)
        finished.append(req)
