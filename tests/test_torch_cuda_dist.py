"""The multi-process planes on the card: CUDA tensors through
``compat.dist`` in place (one process per rank), the disaggregated pair's
slab staging (pinned device-to-host export, pinned decode mirror) on a
dense pair whose requests equal their replays, ``ElasticBuffer`` spill and
restore through pinned host memory with ``decode_step_elastic`` bit-equal
to ``decode_step``, and ``hierarchical_all_reduce`` of two pods with its
reduce-scatter leg on B5.

Every test needs a CUDA GPU and skips without one. This file imports
neither jax nor the JAX package, so it runs alone, past the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_dist.py

Tolerance: none; every result is compared bit for bit (the all-reduce
against the same ring's sums on the host).
"""

import multiprocessing as mp
import socket
import threading

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the staging paths copy between the card and pinned memory)")
    return torch.device("cuda")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, q):
    import torch

    from uccl_tpu_torch.compat import dist

    dist.init_process_group(rank, world, master_port=port)
    dev = torch.device("cuda")
    x = torch.arange(12, dtype=torch.float32, device=dev).reshape(3, 4) * (rank + 1)
    ptr = x.data_ptr()
    dist.all_reduce(x)
    bf = torch.full((7,), 0.5 + rank, dtype=torch.bfloat16, device=dev)
    dist.all_reduce(bf)
    outs = [torch.zeros(5, dtype=torch.int32, device=dev) for _ in range(world)]
    dist.all_gather(outs, torch.full((5,), rank, dtype=torch.int32, device=dev))
    b = torch.full((6,), float(rank), device=dev)
    dist.broadcast(b, src=1)
    a = torch.arange(world, dtype=torch.float32, device=dev) + 10 * rank
    out = torch.empty(world, device=dev)
    dist.all_to_all(out, a)
    dist.barrier()
    q.put((rank, x.data_ptr() == ptr, x.device.type, x.cpu().numpy(), bf.float().cpu().numpy(),
           [o.cpu().numpy() for o in outs], b.cpu().numpy(), out.cpu().numpy()))
    dist.destroy_process_group()


def test_compat_dist_reduces_cuda_tensors_in_place(dev):
    world, port = 2, _free_port()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, q)) for r in range(world)]
    [p.start() for p in procs]
    results = {}
    for _ in procs:
        res = q.get(timeout=180)
        results[res[0]] = res[1:]
    [p.join(timeout=60) for p in procs]
    for rank in range(world):
        same, where, x, bf, outs, b, out = results[rank]
        assert same and where == "cuda"
        np.testing.assert_array_equal(x, np.arange(12, dtype=np.float32).reshape(3, 4) * 3)
        np.testing.assert_array_equal(bf, np.full(7, 2.0))
        for i in range(world):
            np.testing.assert_array_equal(outs[i], np.full(5, i))
        np.testing.assert_array_equal(b, np.full(6, 1.0))
        np.testing.assert_array_equal(out, [rank + 0.0, rank + 10.0])


SIZES = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8, ffn=64)


def _dense_params(dev):
    from uccl_tpu_torch.models import dense
    from uccl_tpu_torch.models.sampling import prng_key

    cfg = dense.DenseConfig(**SIZES)
    return cfg, dense.init_params(prng_key(0), cfg, dev)


def test_disagg_slabs_stage_through_pinned_memory(dev):
    import copy

    from uccl_tpu_torch.serving import disagg
    from uccl_tpu_torch.serving.engine import DenseBackend, ServingEngine, replay_alone

    cfg, params = _dense_params(dev)
    pb = DenseBackend(params, cfg, n_slots=2, max_seq=32)
    db = DenseBackend(params, cfg, n_slots=2, max_seq=32)
    # export: pinned host copies of the rows on the card
    pb.cache.k.normal_()
    k, v = pb.export_slot_kv(1, 3, 9)
    assert torch.from_numpy(k).is_pinned()
    np.testing.assert_array_equal(k, pb.cache.k[:, 1, 3:9].cpu().numpy())
    pb.cache.k.zero_()
    pw, dw = disagg.make_local_pair(ServingEngine(pb, prefill_chunk=4), ServingEngine(db))
    try:
        assert torch.from_numpy(dw.mirror_k).is_pinned()
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, 64, n).astype(np.int32) for n in (7, 13)]
        done, _ = disagg.drive_pair(pw, dw, prompts, [0.0, 0.0], max_new_tokens=4)
        assert len(done) == 2
        for r in done:
            assert r.adopted
            rr = copy.copy(r)
            rr.prefill_chunk = 4
            assert replay_alone(db, rr).tolist() == r.out_tokens
    finally:
        pw.ep.close()
        dw.ep.close()


def test_elastic_spill_and_restore_on_pinned_memory(dev):
    from uccl_tpu_torch.ep.elastic import ElasticBuffer, ElasticKVCache
    from uccl_tpu_torch.models import inference as inf

    buf = ElasticBuffer(hbm_budget_bytes=3 * 1024, device=dev)
    assert buf.has_host
    ts = [torch.randn(16, 16, device=dev) for _ in range(4)]
    for i, t in enumerate(ts):
        buf.put(str(i), t)
    assert buf.placement("3") == "host" and buf._store["3"].is_pinned()
    got = buf.get("3")
    assert got.device.type == "cuda" and torch.equal(got, ts[3])
    buf.offload("0")
    assert buf.placement("0") == "host" and torch.equal(buf.get("0"), ts[0])

    cfg, params = _dense_params(dev)
    prompt = torch.randint(0, 64, (2, 21), device=dev)
    logits, cache = inf.prefill(params, prompt, cfg, 64)
    ekv = ElasticKVCache.from_cache(cache, block_tokens=8, hot_blocks=1)
    assert ekv.cold_blocks >= 1 and all(k.is_pinned() for k, _ in ekv._cold)
    for _ in range(5):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        rows = len(ekv._cold + ekv._hot) * 8 + 8
        same = inf.KVCache(cache.k[:, :, :rows].clone(), cache.v[:, :, :rows].clone(),
                           cache.length)
        want, _ = inf.decode_step(params, tok, same, cfg)
        _, cache = inf.decode_step(params, tok, cache, cfg)
        logits = inf.decode_step_elastic(params, tok, ekv, cfg)
        assert torch.equal(logits, want)


def test_hierarchical_all_reduce_runs_b5(dev):
    from uccl_tpu_torch.collective import Communicator, ring_ccl
    from uccl_tpu_torch.collective.hierarchical import DcnGroup, hierarchical_all_reduce
    from uccl_tpu_torch.p2p.store import StoreClient, StoreServer
    from uccl_tpu_torch.parallel.distributed import Session
    from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    local, n = 4, 4096 * 4
    xs = [torch.randn(local, n, device=dev) for _ in range(2)]
    server = StoreServer()
    out, errors = {}, []
    launches = {"rs": 0}
    real = ring_ccl._rs_kernel

    def counting(*a, **k):
        launches["rs"] += 1
        return real(*a, **k)

    ring_ccl._rs_kernel = counting
    try:
        def pod(p):
            try:
                client = StoreClient("127.0.0.1", server.port)
                g = DcnGroup(Session(rank=p, world=2, store=client), tag="hier_cuda")
                comm = Communicator(make_mesh(MeshConfig(dp=local), dev, local), "dp")
                out[p] = hierarchical_all_reduce(comm, g, xs[p])
                torch.cuda.synchronize()
                g.close()
                client.close()
            except Exception as e:  # pragma: no cover
                errors.append(e)

        ts = [threading.Thread(target=pod, args=(p,)) for p in range(2)]
        [t.start() for t in ts]
        [t.join(timeout=120) for t in ts]
    finally:
        ring_ccl._rs_kernel = real
        server.close()
    assert not errors, errors
    total = (xs[0].double().sum(0) + xs[1].double().sum(0))
    for p in range(2):
        assert out[p].shape == (local, n) and out[p].device.type == "cuda"
        assert torch.equal(out[p], out[1 - p])
        err = (out[p].double() - total).abs().max().item()
        bound = 7 * 2.0 ** -24 * (xs[0].abs().sum(0) + xs[1].abs().sum(0)).double().max().item()
        assert err <= bound
