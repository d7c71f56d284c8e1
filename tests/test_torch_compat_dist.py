"""uccl_tpu_torch.compat.dist and interop.allreduce_gradients against the
JAX package's: ``tests/test_compat_dist.py`` (one process per rank, as
reference users launch) and ``tests/test_torch_interop.py::TestDdpGradients``.

numpy buffers keep the JAX package's in-place rules. torch tensors are
reduced in place, as ``torch.distributed`` does (the JAX package returns a
new array only because a jax array cannot change); bfloat16 sums in
float32 and casts back. Exact: every collective result is compared bit for
bit; the DDP averages equal the JAX package's ``allreduce_gradients`` on
the same gradients bit for bit, and the manual average within the JAX
test's rtol 1e-5.
"""

import multiprocessing as mp
import socket
import threading

import numpy as np
import pytest
import torch

from torch_one_thread import one_torch_thread  # noqa: F401


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, q):
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import numpy as np
    import torch

    from uccl_tpu_torch.compat import dist

    dist.init_process_group(rank, world, master_port=port)
    assert dist.is_initialized()
    assert dist.get_rank() == rank and dist.get_world_size() == world

    # numpy: the JAX package's in-place rules
    x = np.full(8, float(rank + 1), np.float32)
    assert dist.all_reduce(x) is None
    g = np.full(4, float(rank), np.float32)
    outs = [np.zeros(4, np.float32) for _ in range(world)]
    dist.all_gather(outs, g)
    b = np.full(3, float(rank), np.float32)
    dist.broadcast(b, src=1)

    # torch tensors: in place, the same storage afterwards
    tx = torch.full((2, 4), float(rank + 1))
    ptr = tx.data_ptr()
    assert dist.all_reduce(tx) is None and tx.data_ptr() == ptr
    bf = torch.full((5,), 0.5 + rank, dtype=torch.bfloat16)
    dist.all_reduce(bf)
    touts = [torch.zeros(3, dtype=torch.bfloat16) for _ in range(world)]
    dist.all_gather(touts, torch.full((3,), float(rank) + 0.25, dtype=torch.bfloat16))
    tb = torch.arange(6, dtype=torch.int32).reshape(2, 3) * (rank + 1)
    dist.broadcast(tb, src=0)
    ta = torch.arange(world, dtype=torch.float32) + 10 * rank
    tout = torch.empty(world)
    dist.all_to_all(tout, ta)
    strided = torch.zeros(4, 2)[:, 0]  # a non-contiguous view, in place
    strided += rank + 1
    dist.all_reduce(strided)

    dist.barrier()
    q.put((rank, x.copy(), [o.copy() for o in outs], b.copy(), tx.numpy().copy(),
           bf.float().numpy(), [t.float().numpy() for t in touts], tb.numpy().copy(),
           tout.numpy().copy(), strided.numpy().copy()))
    dist.destroy_process_group()


def test_process_group_end_to_end():
    world = 2
    port = _free_port()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, args=(r, world, port, q))
        for r in range(world)
    ]
    [p.start() for p in procs]
    results = {}
    for _ in procs:
        res = q.get(timeout=120)
        results[res[0]] = res[1:]
    [p.join(timeout=60) for p in procs]
    for rank in range(world):
        x, outs, b, tx, bf, touts, tb, tout, strided = results[rank]
        np.testing.assert_array_equal(x, np.full(8, 3.0))  # 1 + 2
        for i in range(world):
            np.testing.assert_array_equal(outs[i], np.full(4, float(i)))
        np.testing.assert_array_equal(b, np.full(3, 1.0))  # src=1
        np.testing.assert_array_equal(tx, np.full((2, 4), 3.0))
        np.testing.assert_array_equal(bf, np.full(5, 2.0))  # 0.5 + 1.5 in f32
        for i in range(world):
            np.testing.assert_array_equal(touts[i], np.full(3, i + 0.25))
        np.testing.assert_array_equal(tb, np.arange(6).reshape(2, 3))  # src=0
        # all_to_all: element j of rank r's input (= j + 10 r) lands at rank j
        np.testing.assert_array_equal(tout, np.asarray([rank + 0.0, rank + 10.0]))
        np.testing.assert_array_equal(strided, np.full(4, 3.0))


def test_requires_init():
    from uccl_tpu_torch.compat import dist

    if not dist.is_initialized():
        with pytest.raises(RuntimeError):
            dist.get_rank()
    with pytest.raises(RuntimeError):
        dist.barrier()


def test_all_gather_validates_before_joining():
    """A wrong out_list fails on the caller's rank before it joins the
    collective (the other ranks are never left skewed)."""
    from uccl_tpu_torch.compat import dist

    class _One:
        active_world = 2

    dist._group = _One()
    try:
        with pytest.raises(ValueError, match="active world size is 2"):
            dist.all_gather([np.zeros(2)], np.zeros(2))
        with pytest.raises(ValueError, match="0 entries"):
            dist.all_gather(None, torch.zeros(2))
    finally:
        dist._group = None


# -- DDP gradients ---------------------------------------------------------------


def _ddp_models(world, dtype=torch.float32):
    torch.manual_seed(0)
    models = [torch.nn.Linear(8, 4).to(dtype) for _ in range(world)]
    # identical params, different grads
    for m in models[1:]:
        m.load_state_dict(models[0].state_dict())
    data = [torch.randn(16, 8).to(dtype) for _ in range(world)]
    for m, x in zip(models, data):
        m.zero_grad()
        m(x).pow(2).mean().backward()
    return models


def _ddp(models, allreduce, group_mod, store_mod, sess_mod):
    world = len(models)
    server = store_mod.StoreServer()
    errors = []

    def rank_main(r):
        try:
            sess = sess_mod.Session(
                rank=r, world=world, store=store_mod.StoreClient("127.0.0.1", server.port)
            )
            g = group_mod.DcnGroup(sess, n_paths=2)
            allreduce(models[r].parameters(), g)
            g.close()
        except Exception as e:
            errors.append(e)

    ts = [threading.Thread(target=rank_main, args=(r,)) for r in range(world)]
    [t.start() for t in ts]
    [t.join(timeout=60) for t in ts]
    server.close()
    assert not errors, errors


class TestDdpGradients:
    @pytest.mark.parametrize("world", [2, 3])
    def test_allreduce_gradients_matches_manual_average_and_jax(self, world):
        from uccl_tpu.collective import hierarchical as jhier
        from uccl_tpu.interop import allreduce_gradients as jallreduce
        from uccl_tpu.p2p import store as jstore
        from uccl_tpu.parallel import distributed as jdist
        from uccl_tpu_torch.collective import hierarchical as thier
        from uccl_tpu_torch.interop import allreduce_gradients
        from uccl_tpu_torch.p2p import store as tstore
        from uccl_tpu_torch.parallel import distributed as tdist

        models = _ddp_models(world)
        want_w = sum(m.weight.grad for m in models) / world
        want_b = sum(m.bias.grad for m in models) / world
        jmodels = _ddp_models(world)
        _ddp(models, allreduce_gradients, thier, tstore, tdist)
        _ddp(jmodels, jallreduce, jhier, jstore, jdist)
        for m, jm in zip(models, jmodels):
            assert torch.allclose(m.weight.grad, want_w, rtol=1e-5)
            assert torch.allclose(m.bias.grad, want_b, rtol=1e-5)
            assert torch.equal(m.weight.grad, jm.weight.grad)
            assert torch.equal(m.bias.grad, jm.bias.grad)

    def test_bf16_grads_average_in_f32(self):
        from uccl_tpu_torch.collective import hierarchical as thier
        from uccl_tpu_torch.interop import allreduce_gradients
        from uccl_tpu_torch.p2p import store as tstore
        from uccl_tpu_torch.parallel import distributed as tdist

        models = _ddp_models(2, torch.bfloat16)
        want = ((models[0].weight.grad.float() + models[1].weight.grad.float()) / 2
                ).to(torch.bfloat16)
        _ddp(models, allreduce_gradients, thier, tstore, tdist)
        for m in models:
            assert m.weight.grad.dtype == torch.bfloat16
            assert torch.equal(m.weight.grad, want)

    def test_no_grads_is_a_no_op(self):
        from uccl_tpu_torch.interop import allreduce_gradients

        allreduce_gradients(torch.nn.Linear(2, 2).parameters(), None)
