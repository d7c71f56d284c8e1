"""The replica router in the port (``serving/router.py``) against the JAX
package's.

The routing cases run on host stubs: each runs on the JAX router and on
the port's, and both must meet the JAX test's exact assertions (least
loaded wins, round-robin among equals, spillover, saturation, per-replica
counters, the merged snapshot). The model case runs a Router over two
replicas of one dense backend (``replicate_backend``) with chunked prefill
on both packages, kills one replica mid-drive, and requires the same
routing, the same recoveries and the same tokens, every finished request
exactly once and equal to its ``replay_alone``.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from uccl_tpu import obs as jobs
from uccl_tpu.models import dense as jdense
from uccl_tpu.serving import engine as jengine
from uccl_tpu.serving import router as jrouter
from uccl_tpu_torch import obs as tobs
from uccl_tpu_torch.models import dense as tdense
from uccl_tpu_torch.serving import engine as tengine
from uccl_tpu_torch.serving import router as trouter

from torch_one_thread import one_torch_thread  # noqa: F401


PKGS = {"jax": SimpleNamespace(engine=jengine, router=jrouter, obs=jobs),
        "torch": SimpleNamespace(engine=tengine, router=trouter, obs=tobs)}
DENSE = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8, ffn=64)
MAX_SEQ = 32


@pytest.fixture(params=sorted(PKGS))
def P(request):
    return PKGS[request.param]


class _ChunkStub:
    def __init__(self, n_slots=2, max_seq=64):
        self.n_slots, self.max_seq, self.n_decodes = n_slots, max_seq, 0

    def prefill(self, tokens, lens, mask, start=None):
        return np.full(self.n_slots, 100, np.int32)

    def decode(self, tokens, active):
        self.n_decodes += 1
        return np.full(self.n_slots, self.n_decodes, np.int32)


def _mk(P, n=2, n_slots=2, max_queue=None, **kw):
    return [P.engine.ServingEngine(_ChunkStub(n_slots=n_slots), prefill_chunk=4,
                                   max_queue=max_queue, **kw) for _ in range(n)]


def test_least_loaded_invariant(P):
    for busy in (0, 1, 2):
        engines = _mk(P, 3)
        r = P.router.Router(engines)
        for _ in range(4):
            engines[busy].submit(list(range(8)), max_new_tokens=8)
        req = r.submit([1, 2], max_new_tokens=2)
        chosen = [i for i, e in enumerate(engines)
                  if any(q is req for q in e.sched.queued_requests())]
        assert chosen and chosen[0] != busy
        assert getattr(req, "replica", chosen[0]) == chosen[0]  # the port stamps it
        r.drain()
        assert r.leaked() == 0


def test_signals_expose_the_decision_inputs(P):
    engines = _mk(P, 2)
    engines[0].submit(list(range(8)), max_new_tokens=8)
    s0, s1 = (P.router.replica_signals(e) for e in engines)
    assert s0["debt_tokens"] == 16 and s1["debt_tokens"] == 0
    assert (s0["queued"], s1["queued"], s1["free_slots"]) == (1, 0, 2)


def test_conservation_across_replicas(P):
    r = P.router.Router(_mk(P, 3, max_queue=2))
    results = [r.submit([1, 2, 3], max_new_tokens=3) for _ in range(24)]
    accepted = [q for q in results if q is not None]
    finished = r.drain()
    assert {id(q) for q in finished} == {id(q) for q in accepted}
    snap = r.snapshot()
    assert snap["completed"] == len(accepted) == sum(snap["routed"])
    assert snap["submitted"] == (snap["completed"] + snap["active"] + snap["queued"]
                                 + snap["rejected"] + snap["expired"])
    assert r.leaked() == 0


def test_round_robin_when_equal_and_per_replica_counters(P):
    r = P.router.Router(_mk(P, 3))
    c = P.obs.counter("serving_router_requests_total")
    before = [c.get(replica=str(i)) for i in range(3)]
    for _ in range(6):
        r.submit([1, 2], max_new_tokens=2)
    assert r.routed == [2, 2, 2]
    assert [c.get(replica=str(i)) - b for i, b in enumerate(before)] == [2, 2, 2]
    r.drain()


def test_spillover_when_choice_rejects(P):
    engines = _mk(P, 2, n_slots=1)
    engines[0].submit(list(range(4)), max_new_tokens=8)
    engines[0].step()
    engines[0].sched.max_queue = 0
    engines[1].submit(list(range(8)), max_new_tokens=8)
    engines[1].submit(list(range(8)), max_new_tokens=8)
    engines[1].step()
    s0 = P.obs.counter("serving_router_spillover_total").get()
    r = P.router.Router(engines)
    assert r.submit([1, 2], max_new_tokens=2) is not None
    assert P.obs.counter("serving_router_spillover_total").get() == s0 + 1
    r.drain()
    assert r.leaked() == 0


def test_all_saturated_counts_router_rejection(P):
    engines = _mk(P, 2, n_slots=1)
    r = P.router.Router(engines)
    for e in engines:
        e.submit(list(range(4)), max_new_tokens=4)
        e.step()
        e.sched.max_queue = 0
    c0 = P.obs.counter("serving_router_rejected_total").get(reason="saturated")
    assert r.submit([1, 2], max_new_tokens=2) is None
    assert P.obs.counter("serving_router_rejected_total").get(reason="saturated") == c0 + 1
    r.drain()


def test_priority_deadline_and_merged_snapshot(P):
    r = P.router.Router(_mk(P, 2, priority_classes=True))
    req = r.submit([1, 2], max_new_tokens=2, priority="batch", deadline_ms=60000.0)
    assert req.priority == "batch" and req.deadline_ms == 60000.0
    for _ in range(5):
        r.submit([1, 2], max_new_tokens=3)
    r.drain()
    snap = r.snapshot()
    assert snap["completed"] == 6 and "p50" in snap["ttft_ms"]
    assert sum(p["completed"] for p in snap["per_replica"]) == 6


def test_detach_drains_then_removes_and_attach_gets_a_stable_id(P):
    engines = _mk(P, 3)
    r = P.router.Router(engines)
    for _ in range(6):
        r.submit(list(range(6)), max_new_tokens=3)
    finished = r.detach(1)
    assert len(r.replicas) == 2 and r._pids == [0, 2]
    finished += r.drain()
    assert len(finished) == 6
    assert r.attach(P.engine.ServingEngine(_ChunkStub(), prefill_chunk=4)) == 3
    with pytest.raises(ValueError, match="last replica"):
        P.router.Router(_mk(P, 1)).detach(0)


# -- the model: two dense replicas, one killed mid-drive ----------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _drive(P, proto):
    engines = [P.engine.ServingEngine(b, prefill_chunk=4)
               for b in P.engine.replicate_backend(proto, 2)]
    router = P.router.Router(engines)
    clk = _Clock()
    router.enable_health(suspect_after_s=0.05, dead_after_s=0.1, clock=clk)
    rng = np.random.default_rng(15)
    reqs = [router.submit(rng.integers(0, 64, int(rng.integers(3, 14))).astype(np.int32),
                          max_new_tokens=int(rng.integers(3, 7))) for _ in range(8)]
    done = []
    for step in range(40):
        if step == 3:
            engines[1].kill()
            clk.t = 0.2
        if not router.has_work():
            break
        done += router.step()
    snap = router.snapshot()
    assert router.leaked() == 0 and snap["dead_replicas"] == 1
    assert snap["submitted"] == (snap["completed"] + snap["active"] + snap["queued"]
                                 + snap["rejected"] + snap["expired"] + snap["lost"])
    index = {q.trace_id: i for i, q in enumerate(reqs)}
    assert sorted(index[d.trace_id] for d in done) == list(range(8))  # each once
    return router, reqs, sorted(done, key=lambda d: index[d.trace_id])


def test_dense_router_kill_identical_to_jax_and_exact():
    cfg = jdense.DenseConfig(**DENSE)
    jp = jdense.init_params(jax.random.PRNGKey(16), cfg)
    jproto = jengine.DenseBackend(jp, cfg, n_slots=2, max_seq=MAX_SEQ)
    tproto = tengine.DenseBackend(tdense.params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
                                  tdense.DenseConfig(**DENSE), n_slots=2, max_seq=MAX_SEQ)
    jrt, jreqs, jdone = _drive(PKGS["jax"], jproto)
    trt, treqs, tdone = _drive(PKGS["torch"], tproto)
    assert [d.out_tokens for d in tdone] == [d.out_tokens for d in jdone]
    assert [(x["replica"], x["outcome"]) for x in trt.recoveries] == \
        [(x["replica"], x["outcome"]) for x in jrt.recoveries]
    assert trt.routed == jrt.routed and len(trt.recoveries) >= 1
    assert all(r.state.value in ("finished", "lost") for r in treqs)
    by_pid = dict(zip(trt._pids, trt.engines))
    for d in tdone:
        assert tengine.replay_alone(by_pid[d.replica].backend, d).tolist() == d.out_tokens
