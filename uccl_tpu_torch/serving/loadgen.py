"""Synthetic load generation and the Poisson arrival drive loop.

Port of ``uccl_tpu/serving/loadgen.py``: one implementation shared by
``python -m uccl_tpu_torch.serve --server`` and ``chip_smoke.py``'s serving
phase, so both measure the same loop. The workloads of the prefix-cache
and speculative-decoding benches (``synth_shared_workload``,
``synth_multi_prefix_workload``, ``synth_repeat_workload``) and the
replica warmup come with those modules.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from uccl_tpu_torch.serving.engine import ServingEngine, _bucket
from uccl_tpu_torch.serving.request import Request, now


def synth_workload(rng: np.random.Generator, n: int, prompt_len: int,
                   vocab: int, arrival_rate: float):
    """Mixed-length prompts (lengths in [max(1, L/2), L]) with Poisson
    arrival offsets (all at t=0 when rate is 0). Returns
    (prompts, lens, arrivals)."""
    lo = max(1, prompt_len // 2)
    lens = rng.integers(lo, prompt_len + 1, n)
    prompts = [rng.integers(0, vocab, l).astype(np.int32) for l in lens]
    if arrival_rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, n))
    else:
        arrivals = np.zeros(n)
    return prompts, lens, arrivals


def assign_classes(rng: np.random.Generator, n: int,
                   interactive_frac: float,
                   pattern: str = "bernoulli"):
    """Priority-class labels for a workload. ``bernoulli`` draws each
    request ``interactive`` with probability ``interactive_frac`` (class
    arrivals interleave the way mixed traffic really does); ``batch-first``
    puts every batch request at the FRONT of the arrival order — the
    deterministic preemption fixture: batch work occupies the slots before
    any interactive request arrives, so each interactive arrival must
    preempt (the qa/ci smoke arm's guarantee). Call AFTER drawing the
    arrival stream in callers that share arrivals across arms, so the mix
    knob never perturbs timing."""
    if not (0.0 <= interactive_frac <= 1.0):
        raise ValueError(
            f"interactive_frac must be in [0, 1], got {interactive_frac}"
        )
    if pattern == "bernoulli":
        return ["interactive" if rng.random() < interactive_frac
                else "batch" for _ in range(n)]
    if pattern == "batch-first":
        n_int = round(n * interactive_frac)
        return ["batch"] * (n - n_int) + ["interactive"] * n_int
    raise ValueError(f"unknown class pattern {pattern!r}")


def warm_engine(engine: ServingEngine, lens, max_seq: int,
                new_tokens: int) -> None:
    """Run every prefill shape the sampled lengths can hit plus the decode
    path once, then zero the metrics: one-time costs a long-lived server
    never pays again would otherwise land in the TTFT percentiles.

    The port compiles nothing, but the first call at each shape still pays
    one-time costs (the CUDA kernels' build and load, allocator growth,
    library handles), so one request per pow2 prefill bucket (one
    representative length each) runs first. Min 2 tokens — a 1-token
    warmup retires at prefill and would leave the decode path cold."""
    by_bucket = {}
    for l in lens:
        by_bucket[_bucket(int(l), max_seq)] = int(l)
    for _, l in sorted(by_bucket.items()):
        engine.submit(np.zeros(l, np.int32),
                      max_new_tokens=min(2, new_tokens))
        engine.drain()
    engine.reset_metrics()
    _clear_warmup_trace()


def _clear_warmup_trace() -> None:
    """Warmup requests are synthetic compile fodder — their lifecycle
    events would sit at the front of every exported trace, so the tracer
    resets with the metrics."""
    from uccl_tpu_torch import obs

    t = obs.get_tracer()
    if t is not None:
        t.clear()


def drive(engine, prompts, arrivals, max_new_tokens,
          eos_id: Optional[int] = None, priorities=None,
          deadlines_ms=None, tenants=None, samplings=None,
          adapters=None) -> Tuple[List[Request], float]:
    """Run the arrival stream to completion: submit requests as their
    arrival offsets come due (wall clock), stepping the engine whenever it
    has work. ``engine`` is a ServingEngine or a Router (same submit/step/
    has_work surface). ``max_new_tokens`` is one budget for every request
    or a per-request list (mixed workloads: short interactive turns over
    long batch jobs). ``priorities`` / ``deadlines_ms`` / ``tenants`` /
    ``samplings`` / ``adapters`` are optional per-request lists (None
    entries = the submit defaults). Returns
    (accepted requests, wall seconds); rejected submissions (bounded
    queue) are counted in the engine's metrics but not returned — expired
    requests ARE returned (they were accepted) and finish as EXPIRED."""
    reqs: List[Request] = []
    i, n = 0, len(prompts)
    t0 = now()
    while i < n or engine.has_work():
        t = now() - t0
        while i < n and arrivals[i] <= t:
            kw = {}
            if priorities is not None and priorities[i] is not None:
                kw["priority"] = priorities[i]
            if deadlines_ms is not None and deadlines_ms[i] is not None:
                kw["deadline_ms"] = deadlines_ms[i]
            if tenants is not None and tenants[i] is not None:
                kw["tenant"] = tenants[i]
            if samplings is not None and samplings[i] is not None:
                kw["sampling"] = samplings[i]
            if adapters is not None and adapters[i] is not None:
                kw["adapter"] = adapters[i]
            mnt = (max_new_tokens[i]
                   if isinstance(max_new_tokens, (list, tuple))
                   else max_new_tokens)
            r = engine.submit(prompts[i], max_new_tokens=mnt,
                              eos_id=eos_id, **kw)
            if r is not None:
                reqs.append(r)
            i += 1
        if engine.has_work():
            engine.step()
        elif i < n:
            time.sleep(min(0.005, max(arrivals[i] - (now() - t0), 0.0)))
    return reqs, now() - t0
