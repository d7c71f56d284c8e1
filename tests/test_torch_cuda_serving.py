"""The port's serving slice on the card: the threefry sampler on CUDA
tensors against the CPU, and the engine at EP world 4 on the pallas wire
(the hand-written all-to-all kernel B9) against each request run alone on
its slot programs (``replay_alone``, serve's ``--check-oracle``).

Every test needs a CUDA GPU and skips without one. This file imports
neither jax nor the JAX package, so it runs alone, past the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_serving.py

Tolerance: none for the key and bit words, the uniform floats and every
token; the Gumbel noise to 2 ulps of max(1, |g|) (two logs, each within an
ulp of the CPU's).
"""

import numpy as np
import pytest
import torch

from uccl_tpu_torch import serve
from uccl_tpu_torch.ep import pallas_a2a
from uccl_tpu_torch.models import moe_inference as tmoe
from uccl_tpu_torch.models import sampling as tsamp
from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from uccl_tpu_torch.serving import MoEBackend, SamplingParams, ServingEngine, replay_alone

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the serving slice's B9 launches have no CPU mode)")
    return torch.device("cuda")


def test_threefry_on_the_card_equals_the_cpu(dev):
    seeds = torch.arange(64).repeat_interleave(64)
    pos = torch.arange(64).repeat(64)
    keys = tsamp.fold_key(seeds, pos)
    assert torch.equal(tsamp.fold_key(seeds.to(dev), pos.to(dev)).cpu(), keys)
    assert torch.equal(tsamp.random_bits(keys[:64].to(dev), 16384).cpu(),
                       tsamp.random_bits(keys[:64], 16384))
    tiny = torch.finfo(torch.float32).tiny
    u_dev = tsamp.uniform(keys[:64].to(dev), 16384, minval=tiny).cpu()
    assert torch.equal(u_dev.view(torch.int32),
                       tsamp.uniform(keys[:64], 16384, minval=tiny).view(torch.int32))
    g_cpu = tsamp.gumbel(keys[:64], 16384).double()
    g_dev = tsamp.gumbel(keys[:64].to(dev), 16384).cpu().double()
    scale = torch.from_numpy(np.spacing(np.maximum(g_cpu.abs().numpy(), 1.0).astype(np.float32)))
    assert ((g_cpu - g_dev).abs() / scale.double()).max() <= 2.0


def test_engine_at_world_4_on_b9_equals_each_request_run_alone(dev):
    sizes = dict(vocab=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=32,
                 moe_experts=8, moe_topk=2, moe_ffn=256)
    cfg = tmoe.MoEServeConfig(**sizes, moe_wire="pallas")
    params = tmoe.init_params(tsamp.prng_key(0), cfg, dev)
    srv = tmoe.MoEServer(cfg, make_mesh(MeshConfig(dp=4), dev, 4))
    backend = MoEBackend(srv, srv.shard_params(params), batch_local=2, max_seq=64)
    eng = ServingEngine(backend)
    rng = np.random.default_rng(0)
    pallas_a2a.reset_launch_counts()
    reqs = [eng.submit(rng.integers(0, 512, int(rng.integers(4, 40))), max_new_tokens=12,
                       sampling=SamplingParams(temperature=0.8, top_p=0.95, top_k=50, seed=i)
                       if i % 2 else None) for i in range(12)]
    eng.drain()
    assert pallas_a2a.launch_counts["a2a"] > 0
    for r in reqs:
        assert r.out_tokens == replay_alone(backend, r).tolist(), r.rid
    assert eng.pool.leaked() == 0 and eng.conservation_holds()


def test_serve_check_oracle_on_the_card(dev, capsys):
    summary, reqs = serve.main(["--server", "--check-oracle", "--dp", "4", "--slots", "8",
                                "--requests", "10", "--prompt-len", "24", "--new-tokens", "8",
                                "--arrival-rate", "0", "--temperature", "0.8", "--top-k", "40"])
    assert summary["oracle_match"] and summary["device"].startswith("cuda")
    assert len(reqs) == 10


def test_split_and_normal_on_the_card(dev):
    """The weights' draws on the card: keys and bits exact, each normal
    within 4 ulp of the CPU's (the erf_inv polynomial's log1p and last
    products may round otherwise)."""
    key = tsamp.prng_key(0)
    assert torch.equal(tsamp.split(key.to(dev), 12).cpu(), tsamp.split(key, 12))
    k = tsamp.split(key, 12)[6]
    got = tsamp.normal(k.to(dev), (4, 64, 96)).cpu().numpy().view(np.int32).astype(np.int64)
    want = tsamp.normal(k, (4, 64, 96)).numpy().view(np.int32).astype(np.int64)
    assert np.abs(got - want).max() <= 4


def test_chunked_spec_prefix_tiers_and_preemption_on_b9_equal_each_replay(dev):
    """The serving slice's local features at EP world 4 on the pallas wire:
    chunked prefill, a prefix cache with a lossless host tier, speculative
    decoding and preemption. Every request equals its replay_alone (its
    chunk boundaries, its verify windows), hits and preemptions happen, and
    one verify exchange's B9 output equals a2a_plain and the transpose bit
    for bit."""
    from uccl_tpu_torch.serving import PrefixCache, TieredKVCache

    sizes = dict(vocab=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=32,
                 moe_experts=8, moe_topk=2, moe_ffn=256)
    cfg = tmoe.MoEServeConfig(**sizes, moe_wire="pallas")
    srv = tmoe.MoEServer(cfg, make_mesh(MeshConfig(dp=4), dev, 4))
    backend = MoEBackend(srv, srv.shard_params(tmoe.init_params(tsamp.prng_key(1), cfg, dev)),
                         batch_local=1, max_seq=96)
    eng = ServingEngine(backend, prefill_chunk=16, step_tokens=64,
                        prefix_cache=PrefixCache(16), kv_tiers=TieredKVCache(1 << 22),
                        spec_k=2, priority_classes=True, preempt=True)
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 512, 32)
    captured, real = [], pallas_a2a.all_to_all
    verifying = [False]
    real_verify = backend.verify

    def verify(*a, **kw):
        verifying[0] = True
        try:
            return real_verify(*a, **kw)
        finally:
            verifying[0] = False

    def capture(x, **kw):
        out = real(x, **kw)
        if verifying[0] and not captured:
            captured.append((x.clone(), out.clone()))
        return out

    backend.verify = verify
    pallas_a2a.all_to_all = capture
    try:
        reqs = []
        for i in range(10):
            p = np.concatenate([shared, rng.integers(0, 512, int(rng.integers(4, 30)))]) \
                if i % 2 else np.tile(rng.integers(0, 512, 2), 20)[:int(rng.integers(10, 40))]
            reqs.append(eng.submit(p, max_new_tokens=10, priority="batch" if i < 4 else
                                   "interactive"))
            eng.step()
        eng.drain()
        for _ in range(2):  # the shared prompt again, once its donors are parked
            reqs.append(eng.submit(np.concatenate([shared, rng.integers(0, 512, 9)]),
                                   max_new_tokens=10))
            eng.drain()
    finally:
        pallas_a2a.all_to_all = real
        backend.verify = real_verify
    assert any(r.cache_hit_len for r in reqs) and eng.snapshot().get("preempted", 0) >= 1
    for r in reqs:
        assert r.out_tokens == replay_alone(backend, r, drafter=eng.drafter).tolist(), r.rid
    assert eng.pool.leaked() == 0 and eng.conservation_holds()
    x, out = captured[0]
    xb, _ = pallas_a2a._as_bytes(x)
    view, k, _ = pallas_a2a._view(xb)
    plain = pallas_a2a._unview(pallas_a2a.a2a_plain(view), k, xb)

    def raw(t):
        return t.contiguous().view(torch.uint8)

    assert torch.equal(raw(pallas_a2a._as_bytes(out)[0]), raw(plain))
    assert torch.equal(raw(out), raw(x.transpose(0, 1)))
