"""Synthetic load generation and the Poisson arrival drive loop.

Port of ``uccl_tpu/serving/loadgen.py``: one implementation shared by
``python -m uccl_tpu_torch.serve --server`` and ``chip_smoke.py``'s serving
phase, so both measure the same loop; with the prefix-cache and
speculative-decoding workloads (``synth_shared_workload``,
``synth_multi_prefix_workload``, ``synth_repeat_workload``) and the replica
warmup (``warm_replicas``).
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


def synth_shared_workload(rng: np.random.Generator, n: int, prompt_len: int,
                          vocab: int, arrival_rate: float, hit_rate: float,
                          shared_len: int):
    """Mixed workload with a shared "system prompt": with probability
    ``hit_rate`` a request's prompt is the fixed ``shared_len``-token
    prefix plus a random tail (prefix-cache fodder); otherwise a plain
    mixed-length random prompt as in :func:`synth_workload`. Returns
    (prompts, lens, arrivals)."""
    if not (0 < shared_len < prompt_len):
        raise ValueError(
            f"shared_len must be in (0, prompt_len), got {shared_len} of "
            f"{prompt_len}"
        )
    # arrivals FIRST: every hit-rate arm at the same seed then faces the
    # identical arrival stream, so TTFT/goodput deltas are cache effects,
    # not Poisson-sample luck
    if arrival_rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, n))
    else:
        arrivals = np.zeros(n)
    shared = rng.integers(0, vocab, shared_len).astype(np.int32)
    prompts = []
    for _ in range(n):
        if rng.random() < hit_rate:
            tail = rng.integers(1, prompt_len - shared_len + 1)
            prompts.append(np.concatenate(
                [shared, rng.integers(0, vocab, tail).astype(np.int32)]
            ))
        else:
            lo = max(1, prompt_len // 2)
            prompts.append(rng.integers(
                0, vocab, rng.integers(lo, prompt_len + 1)
            ).astype(np.int32))
    lens = np.asarray([p.size for p in prompts])
    return prompts, lens, arrivals


def synth_multi_prefix_workload(rng: np.random.Generator, n: int,
                                prompt_len: int, vocab: int,
                                arrival_rate: float, n_prefixes: int,
                                shared_len: int):
    """Working-set workload for the tiered KV cache: ``n_prefixes``
    distinct fixed ``shared_len``-token prefixes (a fleet of tenants'
    system prompts), request ``i`` using prefix ``i % n_prefixes`` plus a
    random tail. The deterministic round-robin is the point: with a
    working set larger than the device slot count, every prefix's donor is
    LRU-evicted (demoted, with tiers attached) before its next use, so the
    stream forces demote→promote cycles instead of lucky T0 re-hits.
    ``n_prefixes`` IS the working set — sweep it against ``n_slots`` for
    the 10–100× capacity axis. Arrivals are drawn FIRST so every tier
    config at the same seed faces the identical arrival stream (the
    synth_shared_workload rule). Returns (prompts, lens, arrivals)."""
    if n_prefixes < 1:
        raise ValueError(f"n_prefixes must be >= 1, got {n_prefixes}")
    if not (0 < shared_len < prompt_len):
        raise ValueError(
            f"shared_len must be in (0, prompt_len), got {shared_len} of "
            f"{prompt_len}"
        )
    if arrival_rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, n))
    else:
        arrivals = np.zeros(n)
    prefixes = [rng.integers(0, vocab, shared_len).astype(np.int32)
                for _ in range(n_prefixes)]
    prompts = []
    for i in range(n):
        tail = int(rng.integers(1, prompt_len - shared_len + 1))
        prompts.append(np.concatenate(
            [prefixes[i % n_prefixes],
             rng.integers(0, vocab, tail).astype(np.int32)]
        ))
    lens = np.asarray([p.size for p in prompts])
    return prompts, lens, arrivals


def synth_repeat_workload(rng: np.random.Generator, n: int, prompt_len: int,
                          vocab: int, arrival_rate: float,
                          motif_max: int = 2):
    """Repetitive-prompt workload — the regime a prompt-lookup drafter
    (serving/spec.py) targets: template/boilerplate-heavy traffic whose
    greedy continuations settle into short cycles. Each prompt tiles a
    random 1..``motif_max``-token motif to a mixed length in
    [max(1, L/2), L]; :func:`synth_workload`'s random prompts bound the
    other end of the acceptance spectrum (novel text, near-zero
    acceptance). Arrivals are drawn FIRST so every arm at the same seed
    faces the identical arrival stream (the synth_shared_workload rule).
    Returns (prompts, lens, arrivals)."""
    if motif_max < 1:
        raise ValueError(f"motif_max must be >= 1, got {motif_max}")
    if arrival_rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, n))
    else:
        arrivals = np.zeros(n)
    lo = max(1, prompt_len // 2)
    prompts = []
    for _ in range(n):
        ml = int(rng.integers(1, motif_max + 1))
        motif = rng.integers(0, vocab, ml).astype(np.int32)
        length = int(rng.integers(lo, prompt_len + 1))
        prompts.append(np.tile(motif, (length + ml - 1) // ml)[:length])
    lens = np.asarray([p.size for p in prompts])
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
    library handles). Whole-prompt mode runs one request per pow2 prefill
    bucket (one representative length each). Chunked mode has one prefill
    shape, ``[n_slots, C]``, so a single longest-length request covers it
    (and the multi-chunk resume path); with a prefix cache a second
    identical prompt then hits the parked warmup donor (the slot copy of
    the hit path), and the cache is emptied (warmup prompts must not stay
    resident as donors). Min 2 tokens either way: a 1-token warmup retires
    at prefill and would leave the decode path (the verify window, when
    speculating) cold."""
    if engine.prefill_chunk is not None:
        longest = max((int(l) for l in lens), default=1)
        engine.submit(np.zeros(max(1, longest), np.int32),
                      max_new_tokens=min(2, new_tokens))
        engine.drain()
        if engine.prefix_cache is not None:
            engine.submit(np.zeros(max(1, longest), np.int32),
                          max_new_tokens=min(2, new_tokens))
            engine.drain()
            engine.prefix_cache.clear(engine.pool)
        engine.reset_metrics()
        _clear_warmup_trace()
        return
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


def warm_replicas(router, lens, max_seq: int, new_tokens: int) -> None:
    """Warm every engine behind a Router (each replica owns its KV pool),
    then zero the router's routed counts: warmup submissions must not skew
    the routed distribution."""
    for eng in router.engines:
        warm_engine(eng, lens, max_seq, new_tokens)
    router.routed = [0] * len(router.replicas)


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
