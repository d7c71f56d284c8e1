"""uccl_tpu_torch's continuous-batching engine (serving/) against the JAX
package's, and against its own one-shot oracles.

The engines run the same arrival trace (every request queued at once, then
drained, so admission order is the same on both sides) on the same weights
carried through numpy: every request's tokens must be identical, greedy and
sampled. Engine against oracle: every finished request equals the
one-shot ``generate`` continuation token for token (exact on the CPU), and
its own run alone on the engine's slot programs (``replay_alone``, serve's
``--check-oracle``), on the dense stack and the MoE stack at EP world 4 on
the pallas wire. The host-side
copies (request, slots, scheduler, metrics, loadgen, obs) are held to the
originals on the same operations, exactly.
"""


import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from uccl_tpu import obs as jobs
from uccl_tpu.models import dense as jdense
from uccl_tpu.models import moe_inference as jmoe
from uccl_tpu.serving import engine as jengine
from uccl_tpu.serving import loadgen as jload
from uccl_tpu.serving import metrics as jmetrics
from uccl_tpu.serving import request as jreq
from uccl_tpu.serving import sampling as jsamp
from uccl_tpu.serving import scheduler as jsched
from uccl_tpu.serving import slots as jslots
from uccl_tpu_torch import obs as tobs
from uccl_tpu_torch.models import dense as tdense
from uccl_tpu_torch.models import inference as tinf
from uccl_tpu_torch.models import moe_inference as tmoe
from uccl_tpu_torch.models import sampling as tsampling
from uccl_tpu_torch.serving.prefix_cache import PrefixCache
from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from uccl_tpu_torch.serving import engine as tengine
from uccl_tpu_torch.serving import loadgen as tload
from uccl_tpu_torch.serving import metrics as tmetrics
from uccl_tpu_torch.serving import request as treq
from uccl_tpu_torch.serving import sampling as tsamp
from uccl_tpu_torch.serving import scheduler as tsched
from uccl_tpu_torch.serving import slots as tslots

from torch_one_thread import one_torch_thread  # noqa: F401


DENSE = dict(vocab=128, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8, ffn=64)
MOE = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8,
           moe_experts=8, moe_topk=2, moe_ffn=64)
MAX_SEQ = 24


def _trace(vocab, n=7, seed=0):
    """Prompts of 2..12 tokens, budgets 3..6, every second request sampled."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sp = dict(temperature=0.8, top_p=0.9, top_k=16, seed=100 + i) if i % 2 else None
        out.append((rng.integers(0, vocab, rng.integers(2, 13)).astype(np.int32),
                    int(rng.integers(3, 7)), sp))
    return out


def _run(engine_mod, samp_mod, backend, trace, **engine_kw):
    eng = engine_mod.ServingEngine(backend, **engine_kw)
    reqs = [eng.submit(p, max_new_tokens=n,
                       sampling=None if sp is None else samp_mod.SamplingParams(**sp))
            for p, n, sp in trace]
    eng.drain()
    snap = eng.snapshot()
    leaked = eng.pool.leaked()
    eng.close()
    return reqs, snap, leaked


@pytest.fixture(scope="module")
def dense_weights():
    jp = jdense.init_params(jax.random.PRNGKey(1), jdense.DenseConfig(**DENSE))
    return jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def moe_weights():
    jp = jmoe.init_params(jax.random.PRNGKey(2), jmoe.MoEServeConfig(**MOE))
    return jp, jax.tree.map(np.asarray, jp)


def _same_requests(treqs, jreqs):
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert [r.finish_reason for r in treqs] == [r.finish_reason for r in jreqs]
    assert [r.admit_seq for r in treqs] == [r.admit_seq for r in jreqs]


def test_dense_engine_identical_to_jax_engine(dense_weights):
    jp, npt = dense_weights
    trace = _trace(DENSE["vocab"])
    jreqs, jsnap, _ = _run(jengine, jsamp, jengine.DenseBackend(
        jp, jdense.DenseConfig(**DENSE), n_slots=3, max_seq=MAX_SEQ), trace)
    treqs, tsnap, leaked = _run(tengine, tsamp, tengine.DenseBackend(
        tdense.params_from_jax(npt, "cpu"), tdense.DenseConfig(**DENSE), n_slots=3,
        max_seq=MAX_SEQ), trace)
    _same_requests(treqs, jreqs)
    assert leaked == 0
    for key in ("submitted", "completed", "admitted", "output_tokens", "prefill_calls",
                "decode_calls", "decode_tokens"):
        assert tsnap[key] == jsnap[key], key


def test_moe_engine_identical_to_jax_engine(devices, moe_weights):
    jp, npt = moe_weights
    trace = _trace(MOE["vocab"], seed=1)
    jsrv = jmoe.MoEServer(jmoe.MoEServeConfig(**MOE), Mesh(np.array(devices[:2]), ("dp",)))
    tsrv = tmoe.MoEServer(tmoe.MoEServeConfig(**MOE), make_mesh(MeshConfig(dp=2), "cpu", 2))
    jreqs, _, _ = _run(jengine, jsamp, jengine.MoEBackend(
        jsrv, jsrv.shard_params(jp), batch_local=2, max_seq=MAX_SEQ), trace)
    treqs, _, leaked = _run(tengine, tsamp, tengine.MoEBackend(
        tsrv, tsrv.shard_params(tmoe.params_from_jax(npt, "cpu")), batch_local=2,
        max_seq=MAX_SEQ), trace)
    _same_requests(treqs, jreqs)
    assert leaked == 0


ORACLES = ["generate", "replay"]


@pytest.mark.parametrize("oracle", ORACLES)
def test_dense_engine_equals_its_oracle(dense_weights, oracle):
    _, npt = dense_weights
    cfg = tdense.DenseConfig(**DENSE)
    params = tdense.params_from_jax(npt, "cpu")
    backend = tengine.DenseBackend(params, cfg, n_slots=4, max_seq=MAX_SEQ)
    reqs, snap, leaked = _run(tengine, tsamp, backend, _trace(DENSE["vocab"], n=9, seed=2))
    for r in reqs:
        if oracle == "generate":
            want = tinf.generate(params, r.prompt[None], cfg, max_new_tokens=r.max_new_tokens,
                                 max_seq=MAX_SEQ, sampling=r.sampling)[0]
        else:
            want = tengine.replay_alone(backend, r)
        assert r.out_tokens == want.tolist()
    assert leaked == 0 and snap["completed"] == 9


@pytest.mark.parametrize("oracle", ORACLES)
def test_moe_engine_at_world_4_on_the_pallas_wire_equals_the_world_1_oracle(moe_weights, oracle):
    _, npt = moe_weights
    cfg = tmoe.MoEServeConfig(**MOE, moe_wire="pallas")
    srv = tmoe.MoEServer(cfg, make_mesh(MeshConfig(dp=4), "cpu", 4))
    srv1 = tmoe.MoEServer(cfg, make_mesh(MeshConfig(dp=1), "cpu", 1))
    params = tmoe.params_from_jax(npt, "cpu")
    placed1 = srv1.shard_params(params)
    backend = tengine.MoEBackend(srv, srv.shard_params(params), batch_local=2, max_seq=MAX_SEQ)
    reqs, snap, leaked = _run(tengine, tsamp, backend, _trace(MOE["vocab"], n=11, seed=3))
    for r in reqs:
        if oracle == "generate":
            want = srv1.generate(placed1, r.prompt[None, None], r.max_new_tokens, MAX_SEQ,
                                 impl="ll", sampling=r.sampling)[0, 0]
        else:
            want = tengine.replay_alone(backend, r)
        assert r.out_tokens == want.tolist()
    assert leaked == 0 and snap["completed"] == 11


def test_replay_needs_a_request_the_engine_prefilled():
    req = treq.Request(rid=0, prompt=np.arange(3, dtype=np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="never prefilled"):
        tengine.replay_alone(_tiny_dense_backend(n_slots=2, max_seq=8), req)


# The knobs these tests once found unported are ported now: each, set
# without what it needs, raises the JAX engine's ValueError, and both
# engines refuse the same settings with the same message.
KNOBS = [
    (dict(prefill_chunk=0), ValueError, "prefill_chunk must be >= 1"),
    (dict(step_tokens=8), ValueError, "step_tokens requires prefill_chunk"),
    (dict(chunk_sink=print), ValueError, "chunk_sink requires prefill_chunk"),
    (dict(preempt=True), ValueError, "preempt requires priority_classes"),
    (dict(spec_k=0), ValueError, "spec_k must be >= 1"),
    (dict(drafter=object()), ValueError, "drafter requires spec_k"),
    (dict(prefix_cache=object()), ValueError, "prefix_cache requires prefill_chunk"),
    (dict(adapters=object()), ValueError, "adapters must be an AdapterStore"),
    (dict(kv_tiers=object()), ValueError, "kv_tiers requires prefix_cache"),
]


@pytest.mark.parametrize("kw,exc,item", KNOBS, ids=[next(iter(k)) for k, _, _ in KNOBS])
def test_knobs_of_later_slices_raise_and_name_their_item(kw, exc, item):
    backend = _tiny_dense_backend()
    with pytest.raises(exc, match=item):
        tengine.ServingEngine(backend, **kw)
    with pytest.raises(exc, match=item):
        jengine.ServingEngine(backend, **kw)


@pytest.mark.parametrize("method,item", [("attach_fleet", "10i"), ("adopt", "10h"),
                                         ("kill", "10e"), ("evacuate", "10e")])
def test_methods_of_later_slices_raise_and_name_their_item(method, item):
    """All four are ported. ``attach_fleet`` refuses an engine without a
    chunked prefix cache (the directory indexes chunk-aligned trie
    entries) and binds one that has it; ``adopt`` admits a request whose
    prefill ran elsewhere, its KV imported first, and decodes it; a killed
    engine's step raises, and evacuate strips its queue and slots."""
    eng = tengine.ServingEngine(_tiny_dense_backend())
    if method == "attach_fleet":
        with pytest.raises(ValueError, match="prefill_chunk \\+ prefix_cache"):
            eng.attach_fleet(None)
        pub = types.SimpleNamespace(backend=None, tiers=None)
        fleet = types.SimpleNamespace(publisher=pub)
        chunked = tengine.ServingEngine(_tiny_dense_backend(), prefill_chunk=4,
                                        prefix_cache=PrefixCache(4))
        chunked.attach_fleet(fleet)
        assert chunked.fleet is fleet and chunked.prefix_cache.listener is pub
        assert pub.backend is chunked.backend
    elif method == "adopt":
        # prefill on a donor engine, carry its rows, adopt on this one
        donor = tengine.ServingEngine(_tiny_dense_backend(), prefill_chunk=4)
        src = donor.submit([1, 2, 3, 4, 5], max_new_tokens=3)
        donor.drain()
        k, v = donor.backend.export_slot_kv(src.slot, 0, 5)
        slot = eng.pool.admit(99)
        eng.backend.import_slot_kv(slot, k, v, length=5)
        req = eng.adopt([1, 2, 3, 4, 5], src.out_tokens[0], max_new_tokens=3, slot=slot)
        assert req.adopted and req.slot == slot and req.out_tokens == src.out_tokens[:1]
        eng.drain()
        assert req.out_tokens == src.out_tokens and eng.pool.leaked() == 0
        with pytest.raises(ValueError, match="overflow"):
            eng.adopt(list(range(15)), 1, max_new_tokens=3)
    if method in ("kill", "evacuate"):
        req = eng.submit([1, 2], max_new_tokens=3)
        eng.step()
        eng.submit([3], max_new_tokens=2)
        if method == "kill":
            eng.kill()
            with pytest.raises(RuntimeError, match="dead"):
                eng.step()
        else:
            queued, active = eng.evacuate()
            assert active == [req] and len(queued) == 1
            assert not eng.has_work() and eng.pool.leaked() == 0
    with pytest.raises(ValueError, match="AdapterStore"):
        eng.submit([1, 2], max_new_tokens=2, adapter="a")


def _tiny_dense_backend(n_slots=2, max_seq=16):
    cfg = tdense.DenseConfig(vocab=32, dim=16, n_layers=1, n_heads=2, n_kv_heads=1, head_dim=8,
                             ffn=16)
    params = tdense.init_params(tsampling.prng_key(0), cfg, "cpu")
    return tengine.DenseBackend(params, cfg, n_slots=n_slots, max_seq=max_seq)


def test_backpressure_cancel_deadline_and_conservation():
    eng = tengine.ServingEngine(_tiny_dense_backend(n_slots=1), max_queue=2)
    a = eng.submit([1, 2, 3], max_new_tokens=2)
    b = eng.submit([4], max_new_tokens=2, deadline_ms=0.001)
    assert eng.submit([5], max_new_tokens=2) is None  # queue full
    done = eng.step()  # a admitted and finished; b's deadline passes meanwhile
    c_req = eng.submit([6, 7], max_new_tokens=3)
    assert eng.cancel(c_req.rid) and not eng.cancel(a.rid)
    done += eng.drain()
    assert a in done and b.state is treq.RequestState.EXPIRED
    assert b.finish_reason == "deadline" and c_req.finish_reason == "cancel"
    snap = eng.snapshot()
    assert (snap["submitted"], snap["rejected"], snap["expired"], snap["completed"]) == (4, 1, 2, 1)
    assert eng.conservation_holds() and eng.pool.leaked() == 0
    with pytest.raises(ValueError):
        eng.submit([1] * 15, max_new_tokens=2)  # overflows max_seq 16
    eng.close()


@pytest.mark.parametrize("policy", ["fifo", "priority", "tenant"])
def test_scheduler_copies_admit_like_the_originals(policy):
    order = {}
    for name, req_mod, slot_mod, sched_mod in (("jax", jreq, jslots, jsched),
                                               ("torch", treq, tslots, tsched)):
        sched = {"fifo": sched_mod.FIFOScheduler(max_queue=9),
                 "priority": sched_mod.PriorityScheduler(max_queue=9),
                 "tenant": sched_mod.TenantFairScheduler(quantum=8)}[policy]
        pool = slot_mod.SlotPool(3)
        rng = np.random.default_rng(7)
        admitted = []
        for i in range(8):
            r = req_mod.Request(rid=i, prompt=np.zeros(int(rng.integers(1, 9)), np.int32),
                                max_new_tokens=4, priority=("interactive", "batch")[i % 2],
                                tenant=f"t{i % 3}")
            sched.submit(r)
            if i % 3 == 2:
                admitted += [(s, r.rid) for s, r in sched.admit(pool)]
                for slot in pool.active_slots()[:1]:
                    pool.free(slot)
        admitted += [(s, r.rid) for s, r in sched.admit(pool)]
        order[name] = (admitted, pool.high_water, sched.qsize, sched.debug_state())
    assert order["torch"] == order["jax"]


def test_metrics_copy_matches_the_original():
    snaps, lines = {}, {}
    for name, mmod, rmod in (("jax", jmetrics, jreq), ("torch", tmetrics, treq)):
        m = mmod.ServingMetrics()
        for i in range(5):
            r = rmod.Request(rid=i, prompt=np.zeros(3, np.int32), max_new_tokens=4,
                             t_submit=1.0 + i, priority=("interactive", "batch")[i % 2],
                             tenant=f"t{i % 2}")
            m.on_submit(r)
            r.t_admit = r.t_submit + 0.01 * i
            m.on_admit(r)
            r.out_tokens = [1, 2, 3]
            r.t_first_token = r.t_admit + 0.1
            m.on_first_token(r)
            r.t_finish = r.t_first_token + 0.2
            m.on_finish(r)
            m.on_decode_step(0.02, 3)
            m.on_prefill(0.05, 1)
            m.on_step(0.07)
        snaps[name] = m.snapshot(n_slots=4, occupancy=0.5)
        lines[name] = mmod.ServingMetrics.prometheus_lines(snaps[name])
    assert snaps["torch"] == snaps["jax"]
    assert lines["torch"] == lines["jax"]
    xs = [0.3, 0.1, 0.7, 0.2]
    assert tmetrics.percentile(xs, 90) == jmetrics.percentile(xs, 90)
    assert tmetrics.percentiles_ms(xs, (50, 99)) == jmetrics.percentiles_ms(xs, (50, 99))
    assert tmetrics.dist([1, 2, 5]) == jmetrics.dist([1, 2, 5])


def test_obs_copies_export_the_serving_families():
    for mod in (jmetrics, tmetrics):
        mod.reset_latency_histograms()
        for x in (0.02, 0.3, 0.004):
            mod.TTFT_HIST.observe(x)
    for o in (jobs, tobs):
        text = o.prometheus_text()
        for fam in ("serving_ttft_seconds_bucket", "serving_tpot_seconds_count",
                    "obs_trace_contexts_total"):
            assert fam in text
    assert tmetrics.TTFT_HIST.quantile(50) == jmetrics.TTFT_HIST.quantile(50)
    tmetrics.reset_latency_histograms()
    assert tmetrics.TTFT_HIST.quantile(50) is None
    ctx = tobs.new_context()
    assert tobs.TraceContext.from_wire(ctx.to_wire()) == ctx
    assert tobs.flow_id("0123456789abcdef") == jobs.flow_id("0123456789abcdef")
    assert tobs.estimate_clock_offset(0, 5, 6, 3) == jobs.estimate_clock_offset(0, 5, 6, 3)


def test_loadgen_copies_draw_like_the_originals():
    for args in ((9, 16, 100, 8.0), (5, 7, 50, 0.0)):
        jp, jl, ja = jload.synth_workload(np.random.default_rng(4), *args)
        tp, tl, ta = tload.synth_workload(np.random.default_rng(4), *args)
        assert [p.tolist() for p in tp] == [p.tolist() for p in jp]
        assert np.array_equal(tl, jl) and np.array_equal(ta, ja)
    for pattern in ("bernoulli", "batch-first"):
        assert (tload.assign_classes(np.random.default_rng(1), 9, 0.4, pattern)
                == jload.assign_classes(np.random.default_rng(1), 9, 0.4, pattern))


def test_warm_engine_and_drive_run_the_arrival_stream():
    eng = tengine.ServingEngine(_tiny_dense_backend(n_slots=2, max_seq=16))
    prompts, lens, arrivals = tload.synth_workload(np.random.default_rng(0), 5, 8, 32, 0.0)
    tload.warm_engine(eng, lens, 16, 4)
    assert eng.snapshot()["submitted"] == 0
    reqs, wall = tload.drive(eng, prompts, arrivals, 4,
                             samplings=[None, tsamp.SamplingParams(seed=1)] * 2 + [None])
    assert len(reqs) == 5 and all(r.n_generated == 4 for r in reqs) and wall > 0
    assert eng.conservation_holds() and eng.pool.leaked() == 0


def test_replicate_backend_shares_params_and_checks_pushed_weights():
    proto = _tiny_dense_backend()
    reps = tengine.replicate_backend(proto, 3)
    assert len(reps) == 3 and all(r.params is proto.params for r in reps)
    assert len({id(r.cache.k) for r in reps}) == 3
    doubled = jax.tree.map(lambda t: (t * 2).numpy(), proto.params)
    reps = tengine.replicate_backend(proto, 2, weights=doubled)
    assert torch.equal(reps[1].params["head"], proto.params["head"] * 2)
    bad = dict(doubled, head=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="shape"):
        tengine.replicate_backend(proto, 2, weights=bad)
