"""The prefix cache in the port (``serving/prefix_cache.py`` and the
engine's hit path) against the JAX package's.

The trie and the engine's scheduling cases run on host stubs (no model):
each case runs on the JAX package's classes and on the port's, and both
must meet the JAX test's exact assertions. The model cases run the JAX
engine and the port's on the same weights and requests: tokens, hit
lengths and the ``prefix_cache_*`` / ``serving_prefill_tokens_total``
counter deltas must be identical, and every request (a hit included) must
equal its cold ``replay_alone`` and, on the CPU, the one-shot ``generate``.
No tolerance.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from uccl_tpu import obs as jobs
from uccl_tpu.models import dense as jdense
from uccl_tpu.models import moe_inference as jmoe
from uccl_tpu.serving import engine as jengine
from uccl_tpu.serving import prefix_cache as jpc
from uccl_tpu.serving import slots as jslots
from uccl_tpu_torch import obs as tobs
from uccl_tpu_torch.models import dense as tdense
from uccl_tpu_torch.models import inference as tinf
from uccl_tpu_torch.models import moe_inference as tmoe
from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from uccl_tpu_torch.serving import engine as tengine
from uccl_tpu_torch.serving import prefix_cache as tpc
from uccl_tpu_torch.serving import slots as tslots

from torch_one_thread import one_torch_thread  # noqa: F401


PKGS = {
    "jax": SimpleNamespace(engine=jengine, pc=jpc, slots=jslots, obs=jobs),
    "torch": SimpleNamespace(engine=tengine, pc=tpc, slots=tslots, obs=tobs),
}
DENSE = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8, ffn=64)
MOE = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8,
           moe_experts=8, moe_topk=2, moe_ffn=64)
MAX_SEQ = 32


@pytest.fixture(params=sorted(PKGS))
def P(request):
    return PKGS[request.param]


def _cat(*chunks):
    return np.concatenate([np.asarray(c, np.int32) for c in chunks])


# -- the trie ------------------------------------------------------------------


def test_miss_then_hit_at_chunk_granularity(P):
    pool, pc = P.slots.SlotPool(4), P.pc.PrefixCache(4)
    p = np.arange(12, dtype=np.int32)
    assert pc.match(p) == (0, None)
    slot = pool.admit(0)
    assert pc.park(pool, slot, p)
    assert pc.match(_cat(p[:8], [99, 98, 97, 96])) == (8, slot)
    assert pc.match(_cat(p[:3], [50, 51, 52, 53, 54])) == (0, None)


def test_match_leaves_at_least_one_token(P):
    pool, pc = P.slots.SlotPool(2), P.pc.PrefixCache(4)
    p = np.arange(8, dtype=np.int32)
    pc.park(pool, pool.admit(0), p)
    assert pc.match(p)[0] == 4
    assert pc.match(_cat(p, [7, 7, 7]))[0] == 8


def test_short_prompt_never_cached_and_covered_prefix_not_parked_twice(P):
    pool, pc = P.slots.SlotPool(4), P.pc.PrefixCache(4)
    assert not pc.park(pool, pool.admit(0), np.arange(3, dtype=np.int32))
    pool.free(0)
    p = np.arange(12, dtype=np.int32)
    assert pc.park(pool, pool.admit(1), p)
    assert not pc.park(pool, pool.admit(2), p.copy())
    assert pc.n_resident == 1
    assert pc.park(pool, pool.admit(3), _cat(p, [1, 2, 3, 4]))
    assert pc.n_resident == 2


def test_lru_eviction_order_and_deepest_match(P):
    pool, pc = P.slots.SlotPool(4), P.pc.PrefixCache(2)
    pa, pb = np.asarray([1, 1, 2, 2], np.int32), np.asarray([3, 3, 4, 4], np.int32)
    sa, sb = pool.admit(0), pool.admit(1)
    pc.park(pool, sa, pa)
    pc.park(pool, sb, pb)
    pc.match(pa)
    assert pc.evict_lru(pool) == sb
    assert pc.match(np.asarray([3, 3, 4, 4, 9], np.int32)) == (0, None)
    s_long = pool.admit(2)
    pc.park(pool, s_long, np.asarray([1, 1, 2, 2, 9, 10], np.int32))
    assert pc.match(np.asarray([1, 1, 2, 2, 9, 10, 11], np.int32)) == (6, s_long)
    assert pc.resident_slots() == sorted([sa, s_long])
    pc.clear(pool)
    assert pool.n_free == 4 and pc.n_resident == 0


def test_namespaces_never_cross_hit(P):
    pool, pc = P.slots.SlotPool(2), P.pc.PrefixCache(2)
    p = np.asarray([5, 6, 7, 8, 9], np.int32)
    pc.park(pool, pool.admit(0), p, "tenant-a")
    assert pc.match(p, "tenant-b") == (0, None) and pc.match(p) == (0, None)
    assert pc.match(p, "tenant-a") == (4, 0)


def test_trie_counters_move_alike():
    """The same script on both tries moves the same counters."""
    def script(P):
        fams = ("prefix_cache_hits_total", "prefix_cache_misses_total",
                "prefix_cache_evictions_total", "prefix_cache_tokens_reused_total")
        before = {f: P.obs.counter(f).total() for f in fams}
        pool, pc = P.slots.SlotPool(3), P.pc.PrefixCache(2)
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, 4, 7).astype(np.int32) for _ in range(12)]
        out = []
        for i, p in enumerate(prompts):
            out.append(pc.match(p))
            if pool.n_free == 0:
                out.append(pc.evict_lru(pool))
            s = pool.admit(i)
            if not pc.park(pool, s, p):
                pool.free(s)
        out.append(pc.resident_slots())
        return out, {f: P.obs.counter(f).total() - before[f] for f in fams}
    assert script(PKGS["torch"]) == script(PKGS["jax"])


# -- the engine's hit path on a stub --------------------------------------------


class _CacheStub:
    """Chunk-aware stub recording prefill starts and prefix copies."""

    def __init__(self, n_slots=2, max_seq=64):
        self.n_slots, self.max_seq, self.n_decodes, self.calls = n_slots, max_seq, 0, []

    def prefill(self, tokens, lens, mask, start=None):
        slots = tuple(int(s) for s in np.flatnonzero(mask))
        self.calls.append(("prefill", slots, tuple(int(start[s]) for s in slots)))
        return np.full(self.n_slots, 100, np.int32)

    def decode(self, tokens, active):
        self.n_decodes += 1
        self.calls.append(("decode", tuple(int(s) for s in np.flatnonzero(active))))
        return np.full(self.n_slots, self.n_decodes, np.int32)

    def copy_slot_prefix(self, dst, src, n):
        self.calls.append(("copy", dst, src, n))


def test_engine_requires_chunked_prefill_of_the_cache_chunk(P):
    with pytest.raises(ValueError, match="requires prefill_chunk"):
        P.engine.ServingEngine(_CacheStub(), prefix_cache=P.pc.PrefixCache(4))
    with pytest.raises(ValueError, match="must equal prefill_chunk"):
        P.engine.ServingEngine(_CacheStub(), prefill_chunk=8, prefix_cache=P.pc.PrefixCache(4))


def test_hit_resumes_cursor_after_one_copy(P):
    eng = P.engine.ServingEngine(_CacheStub(n_slots=2), prefill_chunk=4,
                                 prefix_cache=P.pc.PrefixCache(4))
    p0 = np.arange(10, dtype=np.int32)
    eng.submit(p0, max_new_tokens=2)
    eng.drain()
    assert eng.pool.n_parked == 1
    r1 = eng.submit(_cat(p0[:8], [9, 9, 9]), max_new_tokens=2)
    eng.drain()
    assert r1.cache_hit_len == 8
    assert [c for c in eng.backend.calls if c[0] == "copy"] == [("copy", 1, 0, 8)]
    assert [c[2] for c in eng.backend.calls if c[0] == "prefill"][-1] == (8,)
    assert eng.pool.leaked() == 0


def test_pressure_evicts_lru_donor_never_live(P):
    eng = P.engine.ServingEngine(_CacheStub(n_slots=2), prefill_chunk=4,
                                 prefix_cache=P.pc.PrefixCache(4))
    eng.submit(np.arange(8, dtype=np.int32), max_new_tokens=2)
    eng.drain()
    donor = eng.pool.parked_slots()[0]
    live = eng.submit(np.full(20, 7, np.int32), max_new_tokens=4)
    eng.step()
    live_slot = live.slot
    third = eng.submit(np.full(9, 3, np.int32), max_new_tokens=2)
    eng.drain()
    assert third.slot == donor and live.slot == live_slot
    assert live.n_generated == live.max_new_tokens and eng.pool.leaked() == 0


def test_sole_protected_donor_yields_when_nothing_live(P):
    eng = P.engine.ServingEngine(_CacheStub(n_slots=1), prefill_chunk=4,
                                 prefix_cache=P.pc.PrefixCache(4))
    p = np.arange(8, dtype=np.int32)
    eng.submit(p, max_new_tokens=2)
    eng.drain()
    r = eng.submit(p.copy(), max_new_tokens=2)
    eng.drain()
    assert r.state.value == "finished" and r.cache_hit_len == 0 and eng.pool.leaked() == 0


def test_conservation_with_parked_slots(P):
    eng = P.engine.ServingEngine(_CacheStub(n_slots=2), prefill_chunk=4, max_queue=4,
                                 prefix_cache=P.pc.PrefixCache(4))
    for i in range(5):
        eng.submit(np.full(8, i, np.int32), max_new_tokens=2)
    while eng.has_work():
        eng.step()
        s = eng.snapshot()
        assert s["submitted"] == s["completed"] + s["active"] + s["queued"] + s["rejected"]
    assert eng.pool.leaked() == 0


# -- the model: the port's engine against the JAX engine ------------------------

_FAMS = ("prefix_cache_hits_total", "prefix_cache_misses_total",
         "prefix_cache_evictions_total", "prefix_cache_tokens_reused_total")


def _counts(obs):
    out = {f: obs.counter(f).total() for f in _FAMS}
    for kind in ("computed", "skipped"):
        out[kind] = obs.counter("serving_prefill_tokens_total").get(kind=kind)
    return out


def _sequential(P, backend, prompts, budget=4):
    """Each request drained before the next arrives: the donor is parked
    before its sharer comes."""
    before = _counts(P.obs)
    eng = P.engine.ServingEngine(backend, prefill_chunk=4, prefix_cache=P.pc.PrefixCache(4))
    reqs = []
    for p in prompts:
        reqs.append(eng.submit(p, max_new_tokens=budget))
        eng.drain()
    assert eng.pool.leaked() == 0
    eng.prefix_cache.clear(eng.pool)
    eng.close()
    return reqs, {k: v - before[k] for k, v in _counts(P.obs).items()}


def _hit_prompts(vocab, seed):
    rng = np.random.default_rng(seed)
    p0 = rng.integers(0, vocab, 12).astype(np.int32)
    churn = [rng.integers(0, vocab, 12).astype(np.int32) for _ in range(3)]
    return [p0, _cat(p0[:8], rng.integers(0, vocab, 4)), p0.copy(), *churn,
            _cat(churn[0][:8], rng.integers(0, vocab, 3))]


@pytest.fixture(scope="module")
def dense_pair():
    cfg = jdense.DenseConfig(**DENSE)
    jp = jdense.init_params(jax.random.PRNGKey(5), cfg)
    params = tdense.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return (jengine.DenseBackend(jp, cfg, n_slots=2, max_seq=MAX_SEQ),
            tengine.DenseBackend(params, tdense.DenseConfig(**DENSE), n_slots=2,
                                 max_seq=MAX_SEQ))


def test_dense_hits_and_churn_identical_to_jax_and_exact(dense_pair):
    jb, tb = dense_pair
    prompts = _hit_prompts(DENSE["vocab"], seed=3)
    jr, jc = _sequential(PKGS["jax"], jb, prompts)
    tr, tc = _sequential(PKGS["torch"], tb, prompts)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert [r.cache_hit_len for r in tr] == [r.cache_hit_len for r in jr]
    assert tc == jc and tc["skipped"] >= 16 and tc["prefix_cache_evictions_total"] >= 2
    assert tr[1].cache_hit_len == 8 and tr[2].cache_hit_len == 8
    for r in tr:
        assert tengine.replay_alone(tb, r).tolist() == r.out_tokens
        gen = tinf.generate(tb.params, r.prompt[None], tb.cfg, max_new_tokens=r.max_new_tokens,
                            max_seq=MAX_SEQ)[0]
        assert gen.tolist() == r.out_tokens


def test_moe_hit_at_world_4_on_the_pallas_wire_identical_to_jax(devices):
    cfg = jmoe.MoEServeConfig(**MOE)
    jp = jmoe.init_params(jax.random.PRNGKey(6), cfg)
    jsrv = jmoe.MoEServer(cfg, Mesh(np.array(devices[:2]), ("dp",)))
    tsrv = tmoe.MoEServer(tmoe.MoEServeConfig(**MOE, moe_wire="pallas"),
                          make_mesh(MeshConfig(dp=4), "cpu", 4))
    tb = tengine.MoEBackend(tsrv, tsrv.shard_params(
        tmoe.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")), batch_local=1,
        max_seq=MAX_SEQ)
    prompts = _hit_prompts(MOE["vocab"], seed=4)[:3]
    jr, jc = _sequential(PKGS["jax"], jengine.MoEBackend(jsrv, jsrv.shard_params(jp),
                                                         batch_local=2, max_seq=MAX_SEQ),
                         prompts)
    tr, tc = _sequential(PKGS["torch"], tb, prompts)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert tc == jc and [r.cache_hit_len for r in tr] == [0, 8, 8]
    for r in tr:
        assert tengine.replay_alone(tb, r).tolist() == r.out_tokens
