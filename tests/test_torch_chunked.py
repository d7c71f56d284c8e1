"""Chunked prefill and preemption in the port's engine against the JAX
package's.

The scheduling cases run on a host stub that records every backend call:
each runs on the JAX engine and on the port's, and both must meet the JAX
test's exact assertions (cursor resumption, the decode stall bound, the
step-token budget, the preemption save/restore pair and its counters). The
model cases run the JAX engine and the port's on the same weights and the
same numpy-seeded requests, on the dense stack and the MoE stack: tokens,
finish reasons, hit lengths, preemption counts and the snapshot's call
counts must be identical (no tolerance), and every request, a preempted or
prefix-hit one included, must equal its ``replay_alone`` at the same chunk
boundaries (and on the CPU the one-shot ``generate``).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from uccl_tpu import obs as jobs
from uccl_tpu.models import dense as jdense
from uccl_tpu.models import moe_inference as jmoe
from uccl_tpu.serving import engine as jengine
from uccl_tpu.serving import prefix_cache as jpc
from uccl_tpu.serving import sampling as jsamp
from uccl_tpu_torch import obs as tobs
from uccl_tpu_torch.models import dense as tdense
from uccl_tpu_torch.models import inference as tinf
from uccl_tpu_torch.models import moe_inference as tmoe
from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from uccl_tpu_torch.serving import engine as tengine
from uccl_tpu_torch.serving import prefix_cache as tpc
from uccl_tpu_torch.serving import sampling as tsamp

PKGS = {"jax": SimpleNamespace(engine=jengine, pc=jpc, samp=jsamp, obs=jobs),
        "torch": SimpleNamespace(engine=tengine, pc=tpc, samp=tsamp, obs=tobs)}
DENSE = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8, ffn=64)
MOE = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8,
           moe_experts=8, moe_topk=2, moe_ffn=64)
MAX_SEQ = 32


@pytest.fixture(params=sorted(PKGS))
def P(request):
    return PKGS[request.param]


class _ChunkStub:
    """Records every call, the preemption save/restore pair included.
    Prefill emits 100, the i-th decode step emits i."""

    def __init__(self, n_slots=2, max_seq=64):
        self.n_slots, self.max_seq, self.n_decodes, self.calls = n_slots, max_seq, 0, []

    def prefill(self, tokens, lens, mask, start=None):
        if start is None:
            start = np.zeros(self.n_slots, np.int32)
        slots = tuple(int(s) for s in np.flatnonzero(mask))
        self.calls.append(("prefill", slots, tuple(int(start[s]) for s in slots)))
        return np.full(self.n_slots, 100, np.int32)

    def decode(self, tokens, active):
        self.n_decodes += 1
        self.calls.append(("decode", tuple(int(s) for s in np.flatnonzero(active))))
        return np.full(self.n_slots, self.n_decodes, np.int32)

    def export_slot_kv(self, slot, lo, hi):
        self.calls.append(("export", slot, lo, hi))
        z = np.zeros((1, hi - lo, 1, 1), np.float32)
        return z, z

    def import_slot_kv(self, slot, k_rows, v_rows, *, length):
        self.calls.append(("import", slot, length))


def _conserved(s):
    return s["submitted"] == s["completed"] + s["active"] + s["queued"] + s["rejected"]


# -- chunked scheduling --------------------------------------------------------------


def test_validation(P):
    with pytest.raises(ValueError, match="prefill_chunk must be"):
        P.engine.ServingEngine(_ChunkStub(), prefill_chunk=0)
    with pytest.raises(ValueError, match="requires prefill_chunk"):
        P.engine.ServingEngine(_ChunkStub(), step_tokens=8)
    with pytest.raises(ValueError, match="must be >= prefill_chunk"):
        P.engine.ServingEngine(_ChunkStub(), prefill_chunk=8, step_tokens=4)
    with pytest.raises(ValueError, match="preempt requires prefill_chunk"):
        P.engine.ServingEngine(_ChunkStub(), priority_classes=True, preempt=True)


def test_cursor_resumes_across_steps(P):
    eng = P.engine.ServingEngine(_ChunkStub(n_slots=1), prefill_chunk=4)
    r = eng.submit(list(range(10)), max_new_tokens=2)
    eng.step()
    assert r.state.value == "partial_prefill" and r.prefill_pos == 4 and r.n_generated == 0
    eng.step()
    assert r.prefill_pos == 8 and r.n_generated == 0
    eng.step()
    assert r.prefill_pos == 10 and r.n_generated == 2
    assert [c[2] for c in eng.backend.calls if c[0] == "prefill"] == [(0,), (4,), (8,)]
    eng.drain()
    assert eng.pool.leaked() == 0


def test_decode_stall_bound(P):
    eng = P.engine.ServingEngine(_ChunkStub(n_slots=2), prefill_chunk=2)
    a = eng.submit([1], max_new_tokens=12)
    eng.step()
    b = eng.submit(list(range(10)), max_new_tokens=2)
    n0 = a.n_generated
    for i in range(1, 6):
        eng.step()
        assert a.n_generated == n0 + i
    assert b.n_generated >= 1
    kinds = [c[0] for c in eng.backend.calls]
    assert not any(kinds[i] == kinds[i + 1] == "prefill" for i in range(len(kinds) - 1))


def test_budget_gates_admission(P):
    eng = P.engine.ServingEngine(_ChunkStub(n_slots=4), prefill_chunk=4, step_tokens=8)
    reqs = [eng.submit(list(range(8)), max_new_tokens=3) for _ in range(3)]
    eng.step()
    assert [r.state.value for r in reqs] == ["partial_prefill", "partial_prefill", "queued"]
    assert _conserved(eng.snapshot())
    eng.step()
    assert reqs[2].state.value == "queued" and reqs[0].n_generated == 2
    eng.step()
    assert reqs[2].state.value == "partial_prefill"
    eng.drain()
    seqs = [r.admit_seq for r in reqs]
    assert seqs == sorted(seqs) and eng.pool.leaked() == 0


def test_chunked_eos_and_conservation_and_the_chunk_sink(P):
    events = []
    eng = P.engine.ServingEngine(_ChunkStub(n_slots=1), prefill_chunk=2, max_queue=4,
                                 chunk_sink=events.extend)
    r = eng.submit([1, 2, 3], max_new_tokens=10, eos_id=100)
    eng.step()
    assert r.state.value == "partial_prefill" and _conserved(eng.snapshot())
    eng.drain()
    assert r.finish_reason == "eos" and r.out_tokens == [100]
    assert [(e.lo, e.hi, e.done, e.first_token, e.reused) for e in events] == \
        [(0, 2, False, None, False), (2, 3, True, 100, False)]


def test_pending_tokens_counts_prefill_and_decode_debt(P):
    eng = P.engine.ServingEngine(_ChunkStub(n_slots=1), prefill_chunk=4)
    eng.submit(list(range(10)), max_new_tokens=3)
    eng.submit(list(range(5)), max_new_tokens=2)
    assert eng.pending_tokens() == 10 + 3 + 5 + 2
    eng.step()
    assert eng.pending_tokens() == 6 + 3 + 5 + 2


# -- preemption scheduling ----------------------------------------------------------------


def _preempting(P, n_slots=2):
    return P.engine.ServingEngine(_ChunkStub(n_slots=n_slots), prefill_chunk=4,
                                  priority_classes=True, preempt=True)


def test_interactive_preempts_newest_batch(P):
    eng = _preempting(P)
    b1 = eng.submit(list(range(8)), max_new_tokens=6, priority="batch")
    b2 = eng.submit(list(range(8)), max_new_tokens=6, priority="batch")
    eng.step()
    eng.step()
    p0 = P.obs.counter("serving_preempted_total").get()
    ia = eng.submit([1, 2, 3], max_new_tokens=2, priority="interactive")
    done = eng.step()
    assert b2.state.value == "preempted" and b1.state.value == "active"
    assert b2.slot is None and b2.preemptions == 1
    assert P.obs.counter("serving_preempted_total").get() == p0 + 1
    assert "export" in [c[0] for c in eng.backend.calls]
    done += eng.drain()
    assert {r.rid for r in done} == {b1.rid, b2.rid, ia.rid}
    imports = [c for c in eng.backend.calls if c[0] == "import"]
    assert len(imports) == 1 and imports[0][2] == b2.prompt.size + 1
    s = eng.snapshot()
    assert s["preempted"] == 1 and s["resumed"] == 1 and eng.pool.leaked() == 0


def test_batch_head_never_preempts_and_interactive_never_preempts_interactive(P):
    for cls in ("batch", "interactive"):
        eng = _preempting(P)
        first = [eng.submit(list(range(8)), max_new_tokens=8, priority=cls) for _ in range(2)]
        eng.step()
        third = eng.submit([1, 2], max_new_tokens=2, priority=cls)
        eng.step()
        eng.step()
        assert third.state.value == "queued"
        assert all(r.state.value != "preempted" for r in first)
        eng.drain()
        assert eng.pool.leaked() == 0


def test_mid_prefill_victim_resumes_at_cursor(P):
    eng = _preempting(P, n_slots=1)
    bb = eng.submit(list(range(12)), max_new_tokens=2, priority="batch")
    eng.step()
    eng.submit([1, 2], max_new_tokens=2, priority="interactive")
    eng.step()
    assert bb.state.value == "preempted" and bb.prefill_pos == 4
    eng.drain()
    starts = [s for c in eng.backend.calls if c[0] == "prefill" for s in c[2]]
    assert starts.count(0) == 2 and 4 in starts and 8 in starts and eng.pool.leaked() == 0


def test_victim_requeues_ahead_of_batch_arrivals(P):
    eng = _preempting(P)
    eng.submit(list(range(8)), max_new_tokens=6, priority="batch")
    b2 = eng.submit(list(range(8)), max_new_tokens=6, priority="batch")
    eng.step()
    eng.step()
    later = eng.submit([1, 2], max_new_tokens=2, priority="batch")
    eng.submit([1, 2, 3], max_new_tokens=2, priority="interactive")
    eng.step()
    assert b2.state.value == "preempted"
    eng.drain()
    assert b2.admit_seq < later.admit_seq and later.state.value == "finished"


# -- the model: the port's engine against the JAX engine -------------------------------------


def _trace(vocab, n, seed, shared=None):
    """Mixed-length prompts (half of them on a shared 8-token prefix when
    ``shared``), budgets 3..7, every third request sampled, the first
    third of the arrivals batch class and the rest interactive."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = rng.integers(0, vocab, int(rng.integers(2, 14))).astype(np.int32)
        if shared is not None and i % 2 == 0:
            p = np.concatenate([shared, p[:5]])
        sp = dict(temperature=0.8, top_p=0.9, top_k=16, seed=70 + i) if i % 3 == 1 else None
        out.append((p, int(rng.integers(3, 8)), sp, "batch" if i < n // 3 else "interactive"))
    return out


def _drive(P, backend, trace, **kw):
    eng = P.engine.ServingEngine(backend, **kw)
    reqs = []
    for i, (p, n, sp, cls) in enumerate(trace):
        reqs.append(eng.submit(p, max_new_tokens=n, priority=cls,
                               sampling=None if sp is None else P.samp.SamplingParams(**sp)))
        if i % 2:
            eng.step()
    eng.drain()
    snap = eng.snapshot()
    assert eng.pool.leaked() == 0 and snap["completed"] == len(trace)
    if eng.prefix_cache is not None:
        eng.prefix_cache.clear(eng.pool)
    eng.close()
    return reqs, snap


def _twin(jb, tb, trace, **kw):
    kw_j = dict(kw)
    kw_t = dict(kw)
    if "prefix_cache" in kw:
        kw_j["prefix_cache"] = jpc.PrefixCache(kw["prefix_cache"])
        kw_t["prefix_cache"] = tpc.PrefixCache(kw["prefix_cache"])
    jr, js = _drive(PKGS["jax"], jb, trace, **kw_j)
    tr, ts = _drive(PKGS["torch"], tb, trace, **kw_t)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert [(r.finish_reason, r.cache_hit_len, r.preemptions) for r in tr] == \
        [(r.finish_reason, r.cache_hit_len, r.preemptions) for r in jr]
    for key in ("prefill_calls", "decode_calls", "decode_tokens", "preempted", "resumed"):
        assert ts.get(key) == js.get(key), key
    for r in tr:
        assert tengine.replay_alone(tb, r).tolist() == r.out_tokens
    return tr


@pytest.fixture(scope="module")
def dense_pair():
    cfg = jdense.DenseConfig(**DENSE)
    jp = jdense.init_params(jax.random.PRNGKey(11), cfg)
    params = tdense.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return (jengine.DenseBackend(jp, cfg, n_slots=2, max_seq=MAX_SEQ),
            tengine.DenseBackend(params, tdense.DenseConfig(**DENSE), n_slots=2,
                                 max_seq=MAX_SEQ))


@pytest.mark.parametrize("chunk,budget", [(3, None), (4, 8)])
def test_dense_chunked_identical_to_jax_and_exact(dense_pair, chunk, budget):
    jb, tb = dense_pair
    tr = _twin(jb, tb, _trace(DENSE["vocab"], 7, seed=chunk), prefill_chunk=chunk,
               step_tokens=budget)
    assert all(r.prefill_chunk == chunk and r.prefill_bucket is None for r in tr)
    for r in tr:
        gen = tinf.generate(tb.params, r.prompt[None], tb.cfg, max_new_tokens=r.max_new_tokens,
                            max_seq=MAX_SEQ, sampling=r.sampling)[0]
        assert gen.tolist() == r.out_tokens


def test_dense_preemption_with_prefix_hits_identical_to_jax_and_exact(dense_pair):
    jb, tb = dense_pair
    shared = np.random.default_rng(12).integers(0, DENSE["vocab"], 8).astype(np.int32)
    tr = _twin(jb, tb, _trace(DENSE["vocab"], 9, seed=12, shared=shared), prefill_chunk=4,
               priority_classes=True, preempt=True, prefix_cache=4)
    assert sum(r.preemptions for r in tr) >= 1 and any(r.cache_hit_len for r in tr)


def test_moe_chunked_preemption_identical_to_jax_and_exact_at_world_4(devices):
    cfg = jmoe.MoEServeConfig(**MOE)
    jp = jmoe.init_params(jax.random.PRNGKey(13), cfg)
    jsrv = jmoe.MoEServer(cfg, Mesh(np.array(devices[:2]), ("dp",)))
    tsrv = tmoe.MoEServer(tmoe.MoEServeConfig(**MOE, moe_wire="pallas"),
                          make_mesh(MeshConfig(dp=4), "cpu", 4))
    tb = tengine.MoEBackend(tsrv, tsrv.shard_params(
        tmoe.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")), batch_local=1,
        max_seq=MAX_SEQ)
    tr = _twin(jengine.MoEBackend(jsrv, jsrv.shard_params(jp), batch_local=2, max_seq=MAX_SEQ),
               tb, _trace(MOE["vocab"], 9, seed=14), prefill_chunk=4, step_tokens=12,
               priority_classes=True, preempt=True)
    assert sum(r.preemptions for r in tr) >= 1
