"""Request lifecycle for the continuous-batching engine.

Port copy of ``uccl_tpu/serving/request.py`` (jax-free there too).

A request is one sequence: a prompt, a token budget, and an optional EOS id.
It moves QUEUED → ACTIVE (admitted to a KV slot) → FINISHED (EOS or budget),
or is REJECTED at submit when the queue is full (backpressure). Under
chunked prefill (``ServingEngine(prefill_chunk=C)``) admission enters
PARTIAL_PREFILL first: the request occupies its slot while its prefill
cursor (``prefill_pos``) advances one fixed-size chunk per engine step, and
it becomes ACTIVE when the cursor reaches the prompt end and the first
token is emitted. Timing marks are taken at every transition so the serving
metrics (TTFT, TPOT, queue wait, latency — docs/SERVING.md) fall out of the
lifecycle instead of being instrumented around it.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


def now() -> float:
    """The engine's clock (monotonic seconds). One symbol so every timing
    window — engine, metrics, serve.py's one-shot percentiles — measures
    with the same clock."""
    return time.perf_counter()


class RequestState(enum.Enum):
    QUEUED = "queued"
    PARTIAL_PREFILL = "partial_prefill"  # in a slot, prefill cursor mid-prompt
    ACTIVE = "active"
    PREEMPTED = "preempted"  # paused at a chunk boundary, KV saved, re-queued
    FINISHED = "finished"
    REJECTED = "rejected"
    EXPIRED = "expired"  # left the queue on deadline expiry or cancel()
    LOST = "lost"  # stranded on a dead replica (recovery re-runs a NEW
    # Request under the same trace_id on a survivor; this copy is done)


@dataclass
class Request:
    """One serving request and its measured lifecycle.

    ``out_tokens`` is the greedy continuation, element-for-element the
    prefix of what the one-shot ``generate`` oracle would emit for the same
    prompt (exactness is the engine's tested contract, not a tolerance).
    """

    rid: int
    prompt: np.ndarray  # 1-D int32 token ids
    max_new_tokens: int
    eos_id: Optional[int] = None
    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    admit_seq: Optional[int] = None  # admission order (FIFO is testable)
    prefill_pos: int = 0  # chunked-prefill cursor: prompt[:prefill_pos] is in KV
    # the port's fields, what serving/engine.replay_alone reruns the
    # request at: the length of the whole-prompt prefill call that admitted
    # it, or the chunk width C of the chunked prefill (its boundaries are
    # the multiples of C: a prefix hit, a tier promotion and a preemption
    # resume all restart at one), and the draft width of a speculating
    # engine; ``replica`` is the Router's id of the replica that ran it
    prefill_bucket: Optional[int] = None
    prefill_chunk: Optional[int] = None
    spec_k: Optional[int] = None
    replica: Optional[int] = None
    cache_hit_len: int = 0  # prompt tokens reused from the prefix cache
    # whether the reused rows are bit-exact w.r.t. recomputation: True for
    # T0 slot copies and lossless-tier promotions; False when the serving
    # tier stored them quantized at rest (bounded error, never silent —
    # the kv_tiers exactness contract)
    cache_hit_exact: bool = True
    adopted: bool = False  # entered via adopt() (disagg decode side), not submit()
    priority: str = "interactive"  # SLO class: "interactive" | "batch"
    tenant: str = "default"  # multi-tenant identity: fair-scheduling queue,
    # per-tenant metrics label, prefix-cache namespace
    # per-request sampling policy (serving/sampling.py SamplingParams);
    # None = greedy — the engine's exactness oracle is then the sampled
    # one-shot generate at the same seed instead of the argmax one
    sampling: Optional[object] = None
    adapter: Optional[str] = None  # LoRA adapter tenant name (AdapterStore)
    _adapter_row: int = field(default=0, repr=False, compare=False)
    # device table row pinned at admit (0 = the zero-rank fast path)
    # prefix-cache namespace captured at FIRST admission (engine._ns):
    # the adapter version the KV was actually computed under, so a
    # republish while this request is in flight can never park its rows
    # into the new version's namespace (cross-version contamination)
    _cache_ns: Optional[str] = field(default=None, repr=False,
                                     compare=False)
    # set by TenantFairScheduler when this request's token cost is charged
    # (first admission); a requeued copy — preemption resume, engine
    # adapter-deferral — is never re-billed
    billed: bool = field(default=False, repr=False, compare=False)
    deadline_ms: Optional[float] = None  # admission deadline after submit
    # distributed-tracing identity (obs/context.py): trace_id is minted
    # once at ingress (submit / Router.submit) and carried VERBATIM across
    # the disagg stream, so one request is one timeline fleet-wide;
    # span_id is the minting side's root span
    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    preemptions: int = 0  # times this request was paused for a higher class
    out_tokens: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None  # "eos" | "length" | "deadline" |
    # "cancel" | "oversized" (cost > token-bucket burst, rejected at
    # submit) | "adapter_lost" (adapter archive-evicted while queued)
    t_submit: float = 0.0
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    # drafting-context buffer: prompt + committed tokens, grown in place
    # (capacity = prompt + max_new_tokens is the request's hard ceiling)
    # so the per-step speculative draft never re-concatenates O(len)
    _ctx: Optional[np.ndarray] = field(default=None, repr=False,
                                       compare=False)
    _ctx_len: int = 0
    # preemption save state: host copies of the slot's full KV rows plus
    # the last emitted token, taken at the chunk boundary where the engine
    # paused this request (None while not preempted)
    _saved_kv: Optional[tuple] = field(default=None, repr=False,
                                       compare=False)
    _saved_last_tok: Optional[int] = field(default=None, repr=False,
                                           compare=False)

    @property
    def track(self) -> str:
        """The request's trace track (one Chrome-trace row per request —
        the engine emits its submit→admit→prefill→first-token→finish
        lifecycle marks here, docs/OBSERVABILITY.md)."""
        return f"req-{self.rid}"

    @property
    def n_generated(self) -> int:
        return len(self.out_tokens)

    def context(self) -> np.ndarray:
        """Prompt + committed continuation — what a speculative drafter
        conditions on (never includes uncommitted draft tokens). Returns a
        READ-ONLY view of an amortized buffer: tokens committed since the
        last call are appended in place (decode calls this every step, so
        re-concatenating the whole context would cost O(len) per step)."""
        if not self.out_tokens:
            return self.prompt
        n = self.prompt.size + len(self.out_tokens)
        if self._ctx is None:
            self._ctx = np.empty(self.prompt.size + self.max_new_tokens,
                                 np.int32)
            self._ctx[:self.prompt.size] = self.prompt
            self._ctx_len = self.prompt.size
        while self._ctx_len < n:
            self._ctx[self._ctx_len] = \
                self.out_tokens[self._ctx_len - self.prompt.size]
            self._ctx_len += 1
        return self._ctx[:n]

    @property
    def queue_wait(self) -> Optional[float]:
        """Submit → admission into a KV slot: the scheduling delay alone
        (TTFT minus this is pure compute/prefill time)."""
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token: submit (queue wait included) → first token."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def tpot(self) -> Optional[float]:
        """Time per output token after the first (decode steady state)."""
        if (self.t_finish is None or self.t_first_token is None
                or self.n_generated < 2):
            return None
        return (self.t_finish - self.t_first_token) / (self.n_generated - 1)

    @property
    def latency(self) -> Optional[float]:
        if self.t_finish is None:
            return None
        return self.t_finish - self.t_submit

    @property
    def kv_len(self) -> int:
        """Rows of this request's KV that are live on device: the prefill
        cursor plus one row per decode step taken (the first token comes
        from prefill logits and writes no row; each decode/verify commit
        advances the device length by its committed count). This is the
        exact window preemption must save to resume bit-identically."""
        return self.prefill_pos + max(0, self.n_generated - 1)

    def deadline_passed(self, t: float) -> bool:
        """Whether the admission deadline expired at engine-clock ``t``."""
        return (self.deadline_ms is not None
                and (t - self.t_submit) * 1e3 > self.deadline_ms)

    def is_done(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.REJECTED,
                              RequestState.EXPIRED, RequestState.LOST)
