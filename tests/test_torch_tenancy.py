"""Per-tenant LoRA adapters in the port (``serving/adapters.py``, the
engine's admission gate and the slot forward's fused delta on both stacks)
against the JAX package's.

Store cases run the same script on the JAX ``AdapterStore`` and the port's:
rows, refcounts, versions, counters and the stacked tables must be
identical. Engine cases run the JAX engine and the port's on the same
weights, the same LoRA trees (drawn by the JAX ``make_lora``, carried
through numpy) and the same requests: tokens, states and finish reasons
identical (no tolerance), every request equal to its ``replay_alone``, and
on the CPU each adapted request equal to ``generate`` on its
dense-materialized ``W + A @ B`` weights. ``ingest`` takes a weight-push
snapshot, the port's own and one fetched from a JAX publisher over
loopback, and stages the same table rows as the JAX store.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from uccl_tpu.models import dense as jdense
from uccl_tpu.models import moe_inference as jmoe
from uccl_tpu.serving import adapters as jad
from uccl_tpu.serving import engine as jengine
from uccl_tpu.serving import prefix_cache as jpc
from uccl_tpu.serving import sampling as jsamp
from uccl_tpu_torch.models import dense as tdense
from uccl_tpu_torch.models import inference as tinf
from uccl_tpu_torch.models import moe_inference as tmoe
from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from uccl_tpu_torch.serving import adapters as tad
from uccl_tpu_torch.serving import engine as tengine
from uccl_tpu_torch.serving import prefix_cache as tpc
from uccl_tpu_torch.serving import sampling as tsamp

from torch_one_thread import one_torch_thread  # noqa: F401


PKGS = {"jax": SimpleNamespace(engine=jengine, ad=jad, pc=jpc, samp=jsamp),
        "torch": SimpleNamespace(engine=tengine, ad=tad, pc=tpc, samp=tsamp)}
DENSE = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8, ffn=64)
MOE = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8,
           moe_experts=8, moe_topk=2, moe_ffn=64)
MAX_SEQ = 24
QD, KVD = 32, 16


@pytest.fixture(params=sorted(PKGS))
def P(request):
    return P_of(request.param)


def P_of(name):
    return PKGS[name]


def _store(P, **kw):
    extra = {"device": "cpu"} if P is PKGS["torch"] else {}
    return P.ad.AdapterStore(2, 32, QD, KVD, **kw, **extra)


def _lora(rank, seed, scale=0.3):
    tree = jad.make_lora(jax.random.PRNGKey(seed), 2, 32, QD, KVD, rank, scale=scale)
    return jax.tree.map(np.asarray, tree)


def _np(t):
    return np.asarray(t.cpu() if hasattr(t, "cpu") else t)


# -- the store ---------------------------------------------------------------------


def test_acquire_release_refcount_and_lru(P):
    store = _store(P, max_rank=2, capacity=2)
    counts0 = [c.total() for c in (P.ad._HITS, P.ad._MISSES, P.ad._EVICTIONS)]
    for t in ("a", "b", "c"):
        store.publish(t, _lora(2, seed=ord(t)))
    assert store.acquire(None) == 0
    ra, rb = store.acquire("a"), store.acquire("b")
    assert ra != rb and 0 not in (ra, rb) and store.acquire("a") == ra
    with pytest.raises(RuntimeError):
        store.acquire("c")
    store.release(ra)
    store.release(ra)
    assert store.acquire("c") == ra
    with pytest.raises(KeyError):
        store.acquire("nope")
    counts = [c.total() - c0 for c, c0 in zip((P.ad._HITS, P.ad._MISSES, P.ad._EVICTIONS),
                                               counts0)]
    assert counts == [1, 4, 1]


def test_tables_rank_padding_zero_row_and_live_refresh_match_jax():
    tabs = {}
    for name in PKGS:
        P = P_of(name)
        store = _store(P, max_rank=4, capacity=2)
        v1 = store.publish("acme", _lora(2, seed=1))
        row = store.acquire("acme")
        v2 = store.publish("acme", _lora(2, seed=2))
        assert (v1, v2, store.version("acme")) == (1, 2, 2)
        store.publish("beta", _lora(4, seed=3))
        store.acquire("beta")
        tabs[name] = ({t: tuple(_np(x) for x in ab) for t, ab in store.device_tables().items()},
                      row)
    (jt, jrow), (tt, trow) = tabs["jax"], tabs["torch"]
    assert trow == jrow
    for t in ("wq", "wv"):
        for i in range(2):
            assert np.array_equal(tt[t][i], jt[t][i])
    assert tt["wq"][0].shape == (2, 3, 32, 4) and np.all(tt["wq"][0][:, 0] == 0.0)


def test_rank_over_max_and_archive_eviction(P):
    store = _store(P, max_rank=2, capacity=2, max_published=2)
    with pytest.raises(ValueError):
        store.publish("big", _lora(4, seed=1))
    for i in range(6):
        store.publish(f"t{i}", _lora(2, seed=i + 1))
    assert len(store._published) == 2 and set(store._pub_seq) == set(store._published)


def test_can_acquire_and_row_accounting(P):
    store = _store(P, max_rank=2, capacity=2)
    for i, t in enumerate(("a", "b", "c")):
        store.publish(t, _lora(2, seed=i + 1))
    assert store.can_acquire(None) and not store.can_acquire("ghost")
    ra, rb = store.acquire("a"), store.acquire("b")
    assert store.n_available_rows() == 0 and store.can_acquire("a")
    assert not store.can_acquire("c")
    store.release(ra)
    assert store.n_available_rows() == 1 and store.n_available_rows(exclude={"a"}) == 0
    assert store.can_acquire("c")
    store.release(rb)


def test_weight_push_ingest_round_trip(P):
    """tests/test_tenancy.py's ingest round trip on both packages:
    ``adapter/<tenant>`` names map onto store tenants and pin the snapshot
    version; the staged row is the snapshot's tree."""
    if P is PKGS["jax"]:
        from uccl_tpu.p2p.weight_push import WeightPublisher
    else:
        from uccl_tpu_torch.p2p.weight_push import WeightPublisher
    pub = WeightPublisher()
    pub.publish("adapter/acme", _lora(2, seed=3))
    pub.publish("adapter/acme", _lora(2, seed=4))  # v2
    snap = pub.get("adapter/acme")
    store = _store(P, max_rank=2, capacity=2)
    assert store.ingest(snap) == 2
    assert store.has("acme") and store.version("acme") == 2
    row = store.acquire("acme")
    want = _np(snap.tree()["wq"]["a"])
    assert np.array_equal(_np(store.device_tables()["wq"][0][:, row]), want)
    store.release(row)


def test_ingest_of_a_snapshot_fetched_from_a_jax_publisher():
    """The distribution path across the packages: a JAX WeightPublisher
    serves an adapter over loopback, the port fetches it and ingests it,
    and the staged tables equal the JAX store's ingest of the published
    snapshot."""
    import threading

    from uccl_tpu.p2p import Channel as JChannel
    from uccl_tpu.p2p import Endpoint as JEndpoint
    from uccl_tpu.p2p.weight_push import WeightPublisher as JPublisher
    from uccl_tpu_torch.p2p import Channel, Endpoint
    from uccl_tpu_torch.p2p import weight_push as twp

    pub = JPublisher(group_bytes=1024)
    pub.publish("adapter/beta", _lora(2, seed=5), version=7)
    with JEndpoint(n_engines=2) as jep, Endpoint(n_engines=2) as tep:
        res = {}
        t = threading.Thread(target=lambda: res.setdefault("c", JChannel.accept(jep)))
        t.start()
        cli = Channel.connect(tep, "127.0.0.1", jep.port, n_paths=2)
        t.join(timeout=60)
        ts = threading.Thread(target=lambda: pub.serve(res["c"]))
        ts.start()
        snap = twp.fetch(cli, "adapter/beta")
        ts.join(timeout=60)
    stores = {"torch": _store(PKGS["torch"], max_rank=2, capacity=2),
              "jax": _store(PKGS["jax"], max_rank=2, capacity=2)}
    assert stores["torch"].ingest(snap) == 7
    assert stores["jax"].ingest(pub.get("adapter/beta")) == 7
    rows = {k: s.acquire("beta") for k, s in stores.items()}
    for tgt in ("wq", "wv"):
        for i in range(2):
            assert np.array_equal(_np(stores["torch"].device_tables()[tgt][i]),
                                  _np(stores["jax"].device_tables()[tgt][i]))
    for k, s in stores.items():
        s.release(rows[k])


# -- the engine on the dense stack -----------------------------------------------------


@pytest.fixture(scope="module")
def dense_pair():
    cfg = jdense.DenseConfig(**DENSE)
    jp = jdense.init_params(jax.random.PRNGKey(9), cfg)
    params = tdense.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return {"jax": jengine.DenseBackend(jp, cfg, n_slots=3, max_seq=MAX_SEQ),
            "torch": tengine.DenseBackend(params, tdense.DenseConfig(**DENSE), n_slots=3,
                                          max_seq=MAX_SEQ)}


TREES = {"acme": (2, 1), "beta": (4, 2), "gamma": (2, 3)}


def _mixed(name, backend, capacity, sampled=True, **kw):
    """Three tenants' adapters (ranks 2 and 4) and adapter-free requests
    through a store of ``capacity`` rows: restaging, deferral and the zero
    row all happen; with ``sampled`` every third request samples."""
    P = P_of(name)
    store = _store(P, max_rank=4, capacity=capacity)
    for t, (rank, seed) in TREES.items():
        store.publish(t, _lora(rank, seed))
    eng = P.engine.ServingEngine(backend, adapters=store, **kw)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(8):
        adapter = (None, "acme", "beta", "gamma")[i % 4]
        sp = (P.samp.SamplingParams(temperature=0.9, seed=40 + i)
              if sampled and i % 3 == 2 else None)
        reqs.append(eng.submit(rng.integers(0, 64, int(rng.integers(3, 9))).astype(np.int32),
                               max_new_tokens=5, adapter=adapter, sampling=sp))
        if i % 2:
            eng.step()
    eng.drain()
    assert eng.pool.leaked() == 0
    return eng, reqs, store


@pytest.mark.parametrize("capacity,kw", [(3, {}), (1, dict(prefill_chunk=4, spec_k=2))])
def test_dense_adapters_identical_to_jax_engine_and_exact(dense_pair, capacity, kw):
    _, jr, _ = _mixed("jax", dense_pair["jax"], capacity, **kw)
    eng, tr, store = _mixed("torch", dense_pair["torch"], capacity, **kw)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert [r.state.value for r in tr] == [r.state.value for r in jr]
    tb = dense_pair["torch"]
    for r in tr:
        assert tengine.replay_alone(tb, r, drafter=eng.drafter, adapters=store).tolist() \
            == r.out_tokens
        params = tb.params if r.adapter is None else tad.materialize(tb.params,
                                                                     _lora(*TREES[r.adapter]))
        gen = tinf.generate(params, r.prompt[None], tb.cfg, max_new_tokens=r.max_new_tokens,
                            max_seq=MAX_SEQ, sampling=r.sampling)[0]
        assert gen.tolist() == r.out_tokens
    assert len({tuple(r.out_tokens) for r in tr}) > 4


def test_admission_gate_defers_and_rejects_like_jax(dense_pair):
    states = {}
    for name in PKGS:
        P = P_of(name)
        store = _store(P, max_rank=2, capacity=1, max_published=2)
        store.publish("a", _lora(2, 8))
        store.publish("b", _lora(2, 9))
        eng = P.engine.ServingEngine(dense_pair[name], prefill_chunk=2, adapters=store)
        rng = np.random.default_rng(3)
        ra = eng.submit(rng.integers(0, 64, 4).astype(np.int32), max_new_tokens=3, adapter="a")
        rb = eng.submit(rng.integers(0, 64, 4).astype(np.int32), max_new_tokens=3, adapter="b")
        eng.step()
        store.publish("c", _lora(2, 10))  # archive-evicts "b" (deferred; "a" is resident)
        eng.drain()
        rc = eng.submit(rng.integers(0, 64, 4).astype(np.int32), max_new_tokens=3, adapter="c")
        eng.drain()
        states[name] = [(r.state.value, r.finish_reason, r.out_tokens) for r in (ra, rb, rc)]
        assert eng.pool.leaked() == 0
    assert states["torch"] == states["jax"]
    assert states["torch"][1][1] == "adapter_lost" and states["torch"][2][0] == "finished"


def test_prefix_cache_namespaces_by_tenant_and_adapter_version(dense_pair):
    hits = {}
    for name in PKGS:
        P = P_of(name)
        store = _store(P, max_rank=2, capacity=2)
        store.publish("acme", _lora(2, 6))
        eng = P.engine.ServingEngine(dense_pair[name], prefill_chunk=4,
                                     prefix_cache=P.pc.PrefixCache(4), adapters=store,
                                     tenant_fair=True)
        prompt = np.random.default_rng(1).integers(0, 64, 9).astype(np.int32)
        out = []
        for tenant, adapter, republish in (("t", None, False), ("t", None, False),
                                           ("u", None, False), ("t", "acme", False),
                                           ("t", "acme", False), ("t", "acme", True)):
            if republish:
                store.publish("acme", _lora(2, 7))
            r = eng.submit(prompt.copy(), max_new_tokens=3, tenant=tenant, adapter=adapter)
            eng.drain()
            out.append((r.cache_hit_len, r.out_tokens))
        eng.prefix_cache.clear(eng.pool)
        assert eng.pool.leaked() == 0
        hits[name] = out
    assert hits["torch"] == hits["jax"]
    assert [h for h, _ in hits["torch"]] == [0, 8, 0, 0, 8, 0]


def test_moe_adapters_identical_to_jax_engine_and_exact(devices):
    cfg = jmoe.MoEServeConfig(**MOE)
    jp = jmoe.init_params(jax.random.PRNGKey(10), cfg)
    jsrv = jmoe.MoEServer(cfg, Mesh(np.array(devices[:2]), ("dp",)))
    tsrv = tmoe.MoEServer(tmoe.MoEServeConfig(**MOE, moe_wire="pallas"),
                          make_mesh(MeshConfig(dp=2), "cpu", 2))
    backends = {"jax": jengine.MoEBackend(jsrv, jsrv.shard_params(jp), batch_local=2,
                                          max_seq=MAX_SEQ),
                "torch": tengine.MoEBackend(tsrv, tsrv.shard_params(
                    tmoe.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")),
                    batch_local=2, max_seq=MAX_SEQ)}
    _, jr, _ = _mixed("jax", backends["jax"], 2, sampled=False, prefill_chunk=4)
    eng, tr, store = _mixed("torch", backends["torch"], 2, sampled=False, prefill_chunk=4)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    for r in tr:
        assert tengine.replay_alone(backends["torch"], r, adapters=store).tolist() \
            == r.out_tokens
