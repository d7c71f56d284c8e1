"""uccl_tpu_torch.ep.elastic and models.inference.decode_step_elastic
against the JAX package's: ``tests/test_elastic.py`` case for case, with
the warm-spare and warm-replica admission.

On the CPU there is one place (``has_host`` is False), as the JAX package
degrades; the spill bookkeeping also runs here with the pinned copy
emulated by a CPU copy (the pinned path itself runs in
tests/test_torch_cuda_dist.py on the card). Tolerances: stored and
gathered rows are exact; the elastic decode's logits equal the port's
``decode_step`` on a cache of the same row count bit for bit, and the JAX
package's ``decode_step_elastic`` within the JAX test's own rtol 2e-4 /
atol 2e-5 (the tokens exactly); the warm replica's tokens equal the JAX
``generate`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uccl_tpu.ep import elastic as jelastic
from uccl_tpu.models import dense as jdense
from uccl_tpu.models import inference as jinf
from uccl_tpu_torch import obs
from uccl_tpu_torch.ep import elastic
from uccl_tpu_torch.ep.elastic import ElasticBuffer, ElasticKVCache
from uccl_tpu_torch.models import dense as tdense
from uccl_tpu_torch.models import inference as tinf

from torch_one_thread import one_torch_thread  # noqa: F401


def _f32(shape, seed=0):
    return torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)))


@pytest.fixture
def host_emulated(monkeypatch):
    """The spill path on the CPU: a 'pinned' copy is a CPU copy."""
    monkeypatch.setattr(elastic, "_memory_places",
                        lambda device: (torch.device("cpu"), True))
    monkeypatch.setattr(elastic, "_to_pinned", lambda t: t.clone())


class TestElasticBuffer:
    @pytest.mark.parametrize("emulated", [False, True], ids=["cpu", "spill"])
    def test_budget_placement_and_spill(self, emulated, request):
        if emulated:
            request.getfixturevalue("host_emulated")
        buf = ElasticBuffer(hbm_budget_bytes=3 * 1024, device="cpu")
        assert buf.has_host == emulated
        a, b, c, d = (_f32((16, 16), s) for s in range(4))  # 1 KiB each
        for name, t in zip("abcd", (a, b, c, d)):
            buf.put(name, t)  # d: over budget -> host
        assert buf.placement("a") == "device"
        assert buf.placement("c") == "device"
        if buf.has_host:
            assert buf.placement("d") == "host"
            assert buf.device_bytes <= 3 * 1024
            assert buf.host_bytes == 1024
        else:
            assert buf.placement("d") == "device" and buf.host_bytes == 0
        got = buf.get("d")
        assert got.device.type == "cpu"
        assert torch.equal(got, d)
        assert buf._store["a"].data_ptr() != a.data_ptr()  # the store owns a copy
        # the durable placement is unchanged by a read
        if buf.has_host:
            assert buf.placement("d") == "host"

    def test_pin_overrides_budget(self, host_emulated):
        buf = ElasticBuffer(hbm_budget_bytes=0, device="cpu")
        buf.put("w", _f32((8, 8)), pin=True)
        buf.put("x", _f32((8, 8)))
        assert buf.placement("w") == "device" and buf.placement("x") == "host"

    @pytest.mark.parametrize("emulated", [False, True], ids=["cpu", "spill"])
    def test_offload_and_delete(self, emulated, request):
        if emulated:
            request.getfixturevalue("host_emulated")
        buf = ElasticBuffer(hbm_budget_bytes=1 << 20, device="cpu")
        buf.put("x", _f32((8, 8)))
        assert buf.placement("x") == "device"
        buf.offload("x")
        assert buf.placement("x") == ("host" if emulated else "device")
        assert torch.equal(buf.get("x"), _f32((8, 8)))
        buf.delete("x")
        assert "x" not in buf.names()

    def test_entry_points_default_to_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("this case checks the CPU-only refusal")
        with pytest.raises(RuntimeError, match="cuda"):
            ElasticBuffer(1)
        with pytest.raises(RuntimeError, match="cuda"):
            ElasticKVCache(1, 1, 1, 1)


class TestElasticKVCache:
    def _mk(self, **kw):
        base = dict(
            n_layers=2, batch=2, n_kv_heads=2, head_dim=4,
            block_tokens=8, hot_blocks=2, device="cpu",
        )
        base.update(kw)
        return ElasticKVCache(**base)

    def test_append_and_gather_roundtrip(self):
        ekv = self._mk()
        k = _f32((2, 2, 37, 2, 4), 0)  # 4 full blocks + partial 5
        v = _f32((2, 2, 37, 2, 4), 1)
        ekv.append_tokens(k, v)
        assert ekv.length == 37
        # 4 sealed blocks, hot keeps 2, so 2 went cold
        assert ekv.cold_blocks == 2
        kk, vv, length = ekv.kv()
        assert length == 37 and kk.shape[2] == 40
        assert torch.equal(kk[:, :, :37], k) and torch.equal(vv[:, :, :37], v)
        assert not kk[:, :, 37:].any()
        # the JAX cache gathers the same context
        jk = jelastic.ElasticKVCache(2, 2, 2, 4, block_tokens=8, hot_blocks=2)
        jk.append_tokens(jnp.asarray(k.numpy()), jnp.asarray(v.numpy()))
        np.testing.assert_array_equal(np.asarray(jk.kv()[0]), kk.numpy())

    def test_cold_blocks_live_in_host_memory(self, host_emulated):
        ekv = self._mk()
        assert ekv.has_host
        k = _f32((2, 2, 40, 2, 4))
        ekv.append_tokens(k, k)
        assert ekv.cold_blocks == 3 and len(ekv._hot) == 2
        kk, _, _ = ekv.kv()
        assert torch.equal(kk[:, :, :40], k)

    def test_device_committed_is_bounded(self):
        """Growing the context grows host bytes, not committed HBM."""
        ekv = self._mk(hot_blocks=2)
        committed = []
        for _ in range(6):
            ekv.append_tokens(_f32((2, 2, 8, 2, 4)), _f32((2, 2, 8, 2, 4)))
            committed.append(ekv.device_committed_bytes())
        # after the hot ring fills, committed HBM stops growing
        assert committed[-1] == committed[2]
        assert ekv.cold_blocks == 4


CFG = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8, ffn=64)


class TestElasticDecodeParity:
    @pytest.mark.parametrize("emulated", [False, True], ids=["cpu", "spill"])
    def test_matches_dense_decode(self, emulated, request, rng):
        """Greedy decode over the elastic cache (with cold spills) gives
        the dense decode_step's logits: the port's bit for bit at the same
        row count, the JAX elastic decode's within its test's tolerance."""
        if emulated:
            request.getfixturevalue("host_emulated")
        jcfg = jdense.DenseConfig(**CFG)
        jp = jdense.init_params(jax.random.PRNGKey(0), jcfg)
        cfg = tdense.DenseConfig(**CFG)
        params = tdense.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        prompt = rng.integers(0, cfg.vocab, (2, 21)).astype(np.int32)
        max_seq = 64
        logits_d, cache = tinf.prefill(params, prompt, cfg, max_seq)
        jlogits, jcache = jinf.prefill(jp, jnp.asarray(prompt), jcfg, max_seq)
        # block_tokens=8, hot_blocks=1: the 21-token prompt spills cold
        ekv = ElasticKVCache.from_cache(cache, block_tokens=8, hot_blocks=1)
        jekv = jelastic.ElasticKVCache.from_cache(jcache, block_tokens=8, hot_blocks=1)
        assert ekv.cold_blocks >= 1
        logits_e = logits_d
        for step in range(6):
            tok = torch.argmax(logits_e, dim=-1).to(torch.int32)
            assert torch.equal(tok, torch.argmax(logits_d, dim=-1).to(torch.int32))
            rows = len(ekv._cold + ekv._hot) * 8 + 8
            same_rows = tinf.KVCache(cache.k[:, :, :rows].clone(),
                                     cache.v[:, :, :rows].clone(), cache.length)
            want, _ = tinf.decode_step(params, tok, same_rows, cfg)
            logits_d, cache = tinf.decode_step(params, tok, cache, cfg)
            logits_e = tinf.decode_step_elastic(params, tok, ekv, cfg)
            assert torch.equal(logits_e, want)
            jlogits = jinf.decode_step_elastic(jp, jnp.asarray(tok.numpy()), jekv, jcfg)
            np.testing.assert_allclose(logits_e.numpy(), np.asarray(jlogits),
                                       rtol=2e-4, atol=2e-5)
        assert ekv.length == 21 + 6


class TestWarmAdmission:
    def test_admit_warm_spare_counts_a_raw_tree_like_jax(self):
        tree = {"a": _f32((4, 8)), "b": {"c": _f32((3,), 1).to(torch.bfloat16)}}
        c = obs.counter("p2p_bytes_total")
        before = c.get(verb="weight_push")
        buf = ElasticBuffer(hbm_budget_bytes=64, device="cpu")
        n = elastic.admit_warm_spare(buf, tree, prefix="m.")
        assert n == 4 * 8 * 4 + 3 * 2 and c.get(verb="weight_push") == before + n
        assert sorted(buf.names()) == ["m.a", "m.b.c"]
        assert torch.equal(buf.get("m.a"), tree["a"])
        assert torch.equal(buf.get("m.b.c"), tree["b"]["c"])
        jbuf = jelastic.ElasticBuffer(hbm_budget_bytes=64)
        jn = jelastic.admit_warm_spare(jbuf, {"a": tree["a"].numpy(),
                                              "b": {"c": tree["b"]["c"].float().numpy()}},
                                       prefix="m.")
        assert sorted(jbuf.names()) == sorted(buf.names()) and jn == 4 * 8 * 4 + 3 * 4

    def test_admit_warm_spare_from_a_snapshot_counts_nothing_more(self):
        """A published snapshot's bytes were counted at fetch time: its
        admission adds none, and the entries are the published values."""
        from uccl_tpu_torch.p2p import WeightPublisher

        tree = {"w": _f32((16, 16), 3)}
        pub = WeightPublisher()
        pub.publish("m", tree)
        buf = ElasticBuffer(1 << 20, device="cpu")
        c = obs.counter("p2p_bytes_total")
        before = c.get(verb="weight_push")
        assert elastic.admit_warm_spare(buf, pub.get("m"), prefix="v1.") == 16 * 16 * 4
        assert c.get(verb="weight_push") == before
        assert buf.names() == ["v1.w"] and torch.equal(buf.get("v1.w"), tree["w"])

    def test_admit_warm_replica_attaches_and_serves(self, rng):
        """The elastic up-scale twin of Router.detach: a warm spare built
        off the prototype (its parameters shared) joins the live router
        mid-run, is routable, serves exactly the JAX generate's tokens, and
        can be detached again with nothing leaked."""
        from uccl_tpu_torch.serving import Router, ServingEngine
        from uccl_tpu_torch.serving.engine import DenseBackend

        sizes = dict(vocab=64, dim=32, n_layers=1, n_heads=2, n_kv_heads=1, head_dim=16,
                     ffn=64)
        jcfg = jdense.DenseConfig(**sizes)
        jp = jdense.init_params(jax.random.PRNGKey(0), jcfg)
        cfg = tdense.DenseConfig(**sizes)
        params = tdense.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        proto = DenseBackend(params, cfg, n_slots=2, max_seq=16)
        eng0 = ServingEngine(proto, prefill_chunk=4)
        r = Router([eng0])
        r.enable_health(suspect_after_s=5, dead_after_s=10)
        spare = elastic.admit_warm_replica(r, proto, engine_kw={"prefill_chunk": 4})
        assert len(r.replicas) == 2
        assert spare.backend.params is proto.params, "parameters must share"
        # load the original so the spare wins the route
        eng0.submit(list(range(8)), max_new_tokens=4)
        prompt = np.arange(1, 7, dtype=np.int32)
        req = r.submit(prompt, max_new_tokens=4)
        assert any(q is req for q in spare.sched.queued_requests())
        done = r.drain()
        want = np.asarray(jinf.generate(jp, jnp.asarray(prompt)[None], jcfg,
                                        max_new_tokens=4, max_seq=16))[0]
        got = [q for q in done if q is req][0]
        np.testing.assert_array_equal(np.asarray(got.out_tokens), want)
        finished = r.detach(1)
        assert len(r.replicas) == 1 and not finished
        assert r.leaked() == 0 and spare.pool.leaked() == 0
        r.close()
