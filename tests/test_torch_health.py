"""Failure detection and dead-replica recovery in the port
(``serving/health.py``, the engine's ``kill`` / ``evacuate`` and the
router's recovery) against the JAX package's.

Host stubs, no model: every case runs on the JAX package's classes and on
the port's, and both must meet the JAX test's exact assertions (state
transitions, the ``fleet_*`` and ``serving_recovered_total`` telemetry,
exactly-once completion by trace id, conservation). A last case drives the
same kill on both routers and compares what each recovered.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from uccl_tpu import obs as jobs
from uccl_tpu.serving import engine as jengine
from uccl_tpu.serving import health as jhealth
from uccl_tpu.serving import router as jrouter
from uccl_tpu_torch import obs as tobs
from uccl_tpu_torch.serving import engine as tengine
from uccl_tpu_torch.serving import health as thealth
from uccl_tpu_torch.serving import router as trouter

PKGS = {"jax": SimpleNamespace(engine=jengine, health=jhealth, router=jrouter, obs=jobs),
        "torch": SimpleNamespace(engine=tengine, health=thealth, router=trouter, obs=tobs)}


@pytest.fixture(params=sorted(PKGS))
def P(request):
    return PKGS[request.param]


class _ChunkStub:
    """Chunk-aware stub: prefill emits 100, the i-th decode step emits i."""

    def __init__(self, n_slots=2, max_seq=64):
        self.n_slots, self.max_seq, self.n_decodes = n_slots, max_seq, 0

    def prefill(self, tokens, lens, mask, start=None):
        return np.full(self.n_slots, 100, np.int32)

    def decode(self, tokens, active):
        self.n_decodes += 1
        return np.full(self.n_slots, self.n_decodes, np.int32)

    def export_slot_kv(self, slot, lo, hi):
        z = np.zeros((1, hi - lo, 1, 1), np.float32)
        return z, z

    def import_slot_kv(self, slot, k_rows, v_rows, *, length):
        pass

    def copy_slot_prefix(self, dst, src, n):
        pass


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _conserved(snap):
    return snap["submitted"] == (snap["completed"] + snap["active"] + snap["queued"]
                                 + snap["rejected"] + snap["expired"] + snap["lost"])


# -- the detector --------------------------------------------------------------------


def test_window_validation(P):
    with pytest.raises(ValueError, match="suspect_after_s"):
        P.health.FailureDetector(suspect_after_s=0)
    with pytest.raises(ValueError, match="grace window"):
        P.health.FailureDetector(suspect_after_s=1.0, dead_after_s=1.0)


def test_transitions_and_telemetry(P):
    H, clk = P.health, _Clock()
    det = H.FailureDetector(suspect_after_s=0.5, dead_after_s=1.5, clock=clk)
    det.register("a")
    assert det.state("a") == H.HEALTHY and det.is_routable("a")
    clk.t = 0.6
    assert det.tick() == [("a", H.SUSPECT)] and not det.is_routable("a")
    assert P.obs.gauge("fleet_peer_state").get(peer="a") == 1
    clk.t = 1.6
    assert det.tick() == [("a", H.DEAD)]
    assert P.obs.gauge("fleet_peer_state").get(peer="a") == 2
    det.heartbeat("a")
    assert det.state("a") == H.DEAD and det.tick() == []
    det.register("a")
    assert det.state("a") == H.HEALTHY


def test_suspect_grace_no_flap(P):
    H, clk = P.health, _Clock()
    det = H.FailureDetector(suspect_after_s=0.5, dead_after_s=1.5, clock=clk)
    det.register("a")
    h0 = P.obs.counter("fleet_heartbeats_total").get(peer="a")
    clk.t = 0.7
    assert det.tick() == [("a", H.SUSPECT)]
    det.heartbeat("a")
    assert det.state("a") == H.HEALTHY
    assert P.obs.counter("fleet_heartbeats_total").get(peer="a") == h0 + 1
    clk.t = 1.1
    assert det.tick() == [] and det.state("a") == H.HEALTHY
    clk.t = 3.0
    assert ("a", H.DEAD) in det.tick()


def test_probe_is_the_inprocess_heartbeat_and_a_raising_probe_is_dead(P):
    H, clk = P.health, _Clock()
    det = H.FailureDetector(suspect_after_s=0.5, dead_after_s=1.5, clock=clk)
    alive = [True]
    det.register("e", probe=lambda: alive[0])
    clk.t = 10.0
    assert det.tick() == [] and det.state("e") == H.HEALTHY
    alive[0] = False
    clk.t = 10.6
    assert det.tick() == [("e", H.SUSPECT)]
    alive[0] = True
    clk.t = 10.7
    det.tick()
    assert det.state("e") == H.HEALTHY

    def boom():
        raise RuntimeError("gone")

    det.register("f", probe=boom)
    clk.t = 12.3
    assert ("f", H.DEAD) in det.tick()


# -- recovery through the router ------------------------------------------------------


def _router(P, n=3, n_slots=2):
    engines = [P.engine.ServingEngine(_ChunkStub(n_slots=n_slots), prefill_chunk=4)
               for _ in range(n)]
    r = P.router.Router(engines)
    clk = _Clock()
    r.enable_health(suspect_after_s=0.05, dead_after_s=0.1, clock=clk)
    return r, engines, clk


def _recovered(P):
    return [P.obs.counter("serving_recovered_total").get(outcome=o)
            for o in ("resubmitted", "restarted", "lost")]


def test_exactly_once_conservation_across_a_kill(P):
    r, engines, clk = _router(P)
    reqs = [r.submit(list(range(8)), max_new_tokens=4) for _ in range(6)]
    r.step()
    n_stranded = engines[0].sched.qsize + len(engines[0]._by_slot)
    c0 = _recovered(P)
    engines[0].kill()
    clk.t = 0.2
    done = r.drain()
    deltas = [a - b for a, b in zip(_recovered(P), c0)]
    assert sum(deltas) == n_stranded == len(r.recoveries) and deltas[2] == 0
    traces = [q.trace_id for q in done]
    assert len(traces) == len(set(traces)) == 6 and set(traces) == {q.trace_id for q in reqs}
    snap = r.snapshot()
    assert snap["lost"] == n_stranded and _conserved(snap)
    assert r.leaked() == 0 and snap["dead_replicas"] == 1
    r.close()


def test_double_dead_fire_recovers_once(P):
    r, engines, clk = _router(P, n=2)
    r.submit([1, 2, 3], max_new_tokens=4)
    r.step()
    victim = next(i for i, e in enumerate(engines) if e.has_work())
    engines[victim].kill()
    clk.t = 0.2
    r.step()
    n = len(r.recoveries)
    assert n >= 1
    r._recover(victim)
    assert len(r.recoveries) == n
    r.drain()
    assert r.leaked() == 0


def test_suspect_excluded_but_not_recovered(P):
    r, engines, clk = _router(P, n=2)
    det = r.detector
    det._peers["0"].probe = None
    clk.t = 0.07
    r.step()
    assert det.state("0") == P.health.SUSPECT and not r._routable(0) and r._routable(1)
    req = r.submit([1, 2], max_new_tokens=2)
    assert any(q is req for q in engines[1].sched.queued_requests()) and not r.recoveries
    det.heartbeat("0")
    assert r._routable(0)
    r.drain()


def test_cascading_failure_recovers_the_same_trace_again(P):
    r, engines, clk = _router(P, n=3)
    req = r.submit(list(range(8)), max_new_tokens=4)
    holder = next(i for i, e in enumerate(engines)
                  if any(q is req for q in e.sched.queued_requests()))
    engines[holder].kill()
    clk.t = 0.2
    r.step()
    taker = next(i for i, e in enumerate(engines) if not e.dead and e.has_work())
    engines[taker].kill()
    clk.t = 0.4
    done = r.drain()
    assert [x["trace_id"] for x in r.recoveries].count(req.trace_id) == 2
    assert [q.trace_id for q in done] == [req.trace_id]
    snap = r.snapshot()
    assert _conserved(snap) and snap["lost"] == 2 and r.leaked() == 0


def test_lost_when_no_survivor_has_room(P):
    r, engines, clk = _router(P, n=2, n_slots=1)
    a = r.submit(list(range(8)), max_new_tokens=8)
    b = r.submit(list(range(8)), max_new_tokens=8)
    r.step()
    engines[1].sched.max_queue = engines[1].sched.qsize
    engines[0].kill()
    clk.t = 0.2
    c0 = P.obs.counter("serving_recovered_total").get(outcome="lost")
    r.drain()
    lost = P.obs.counter("serving_recovered_total").get(outcome="lost") - c0
    snap = r.snapshot()
    assert lost >= 1 and snap["lost"] >= 1 and _conserved(snap) and r.leaked() == 0
    lost_reqs = [q for q in (a, b) if q.state.value == "lost"]
    assert len(lost_reqs) == lost and all(q.finish_reason == "replica_dead" for q in lost_reqs)


def test_abandon_engine_counts_all_lost(P):
    eng = P.engine.ServingEngine(_ChunkStub(), prefill_chunk=4)
    r1 = eng.submit([1, 2, 3], max_new_tokens=4)
    eng.step()
    r2 = eng.submit([1, 2, 3], max_new_tokens=4)
    eng.kill()
    with pytest.raises(RuntimeError, match="dead"):
        eng.step()
    c0 = P.obs.counter("serving_recovered_total").get(outcome="lost")
    gone = P.health.abandon_engine(eng)
    assert {q.rid for q in gone} == {r1.rid, r2.rid}
    assert P.obs.counter("serving_recovered_total").get(outcome="lost") == c0 + 2
    snap = eng.snapshot()
    assert snap["lost"] == 2 and _conserved(snap) and eng.pool.leaked() == 0


def test_both_routers_recover_the_same_requests():
    logs = {}
    for name, P in PKGS.items():
        r, engines, clk = _router(P, n=3)
        reqs = [r.submit(list(range(5 + i)), max_new_tokens=3 + i % 3) for i in range(7)]
        r.step()
        engines[1].kill()
        clk.t = 0.2
        done = r.drain()
        index = {q.trace_id: i for i, q in enumerate(reqs)}
        logs[name] = ([(x["replica"], x["outcome"]) for x in r.recoveries],
                      sorted((index[d.trace_id], d.out_tokens) for d in done),
                      r.routed, {k: r.snapshot()[k] for k in ("completed", "lost", "submitted")})
    assert logs["torch"] == logs["jax"]
