"""The port's Communicator (uccl_tpu_torch/collective/communicator.py) against
the JAX package's Communicator on the same mesh shape.

Every verb and algo runs on the same seeded numpy inputs in both. The JAX
side runs its Pallas kernels in the faithful interpreter on the virtual CPU
mesh; the port runs on CPU tensors, where its kernel wrappers take their
plain versions. Algorithms that share a schedule (the ring kernels, the
ring/hd/tree/torus plans, and every pure data movement) must agree bit for
bit; the library reductions (``xla``, which sum in another order) to the
rtol of 1e-5 that tests/test_communicator.py holds the JAX verbs to.
"""

import numpy as np
import pytest
import torch

from uccl_tpu.collective import Communicator as JComm
from uccl_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as jmake_mesh
from uccl_tpu_torch.collective import Communicator, ReduceOp, dma, ring_ccl
from uccl_tpu_torch.parallel.mesh import AXIS, MeshConfig, make_mesh

MESHES = {
    "dp4": (dict(dp=4), AXIS.DP),
    "tp_of_8": (dict(dp=2, tp=4), AXIS.TP),
    "ep_tuple": (dict(dp=2, cp=2, tp=2), AXIS.EP),
}


def _pair(devices, name):
    cfg, axis = MESHES[name]
    jc = JMeshConfig(**cfg)
    jmesh = jmake_mesh(jc, devices[: jc.size])
    tmesh = make_mesh(MeshConfig(**cfg), device="cpu", n_members=jc.size)
    return JComm(jmesh, axis), Communicator(tmesh, axis)


@pytest.fixture(scope="module")
def dp4(devices):
    return _pair(devices, "dp4")


def _x(comm, shape, seed):
    return np.random.default_rng(seed).standard_normal((comm.world, *shape)).astype(np.float32)


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


EXACT_AR = ["ring", "hd", "pallas", "bidir", "auto"]


@pytest.mark.parametrize("algo", EXACT_AR)
def test_all_reduce_exact_algos(dp4, algo):
    jcomm, tcomm = dp4
    x = _x(jcomm, (6, 5), seed=1)
    want = np.asarray(jcomm.all_reduce(jcomm.device_put(x), algo=algo))
    got = tcomm.all_reduce(x, algo=algo)
    assert got.shape == want.shape and got.device.type == "cpu"
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("op", [ReduceOp.SUM, ReduceOp.MAX, ReduceOp.MIN, ReduceOp.AVG,
                                ReduceOp.PROD])
def test_all_reduce_xla_ops(devices, name, op):
    jcomm, tcomm = _pair(devices, name)
    x = _x(jcomm, (4,), seed=2)
    want = np.asarray(jcomm.all_reduce(jcomm.device_put(x), op))
    np.testing.assert_allclose(_np(tcomm.all_reduce(x, op)), want, rtol=1e-5)


@pytest.mark.parametrize("name", ["tp_of_8", "ep_tuple"])
def test_all_reduce_plan_algos_on_sub_and_tuple_axes(devices, name):
    jcomm, tcomm = _pair(devices, name)
    x = _x(jcomm, (9,), seed=3)
    for algo in ("ring", "hd", "auto"):
        want = np.asarray(jcomm.all_reduce(jcomm.device_put(x), algo=algo))
        np.testing.assert_array_equal(_np(tcomm.all_reduce(x, algo=algo)), want)


def test_torus_matches_jax(devices):
    jmesh = jmake_mesh(JMeshConfig(dp=2, tp=4), devices)
    tmesh = make_mesh(MeshConfig(dp=2, tp=4), device="cpu", n_members=8)
    jcomm, tcomm = JComm(jmesh, ("dp", "tp")), Communicator(tmesh, ("dp", "tp"))
    x = _x(jcomm, (33,), seed=4)
    want = np.asarray(jcomm.all_reduce(jcomm.device_put(x), algo="torus"))
    np.testing.assert_array_equal(_np(tcomm.all_reduce(x, algo="torus")), want)
    with pytest.raises(ValueError, match="2-axis"):
        Communicator(make_mesh(MeshConfig(dp=8), "cpu", 8), "dp").all_reduce(
            np.zeros((8, 2), np.float32), algo="torus")


@pytest.mark.parametrize("algo", ["xla", "ring", "bidir", "auto"])
def test_all_gather(dp4, algo):
    jcomm, tcomm = dp4
    x = _x(jcomm, (6, 4), seed=5)
    want = np.asarray(jcomm.all_gather(jcomm.device_put(x), algo=algo))
    got = tcomm.all_gather(x, algo=algo)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(got), x)


@pytest.mark.parametrize("algo", ["xla", "ring", "auto"])
def test_reduce_scatter(dp4, algo):
    jcomm, tcomm = dp4
    x = np.random.default_rng(6).standard_normal((4, 12, 3)).astype(np.float32)
    want = np.asarray(jcomm.reduce_scatter(jcomm.device_put(x), algo=algo))
    got = tcomm.reduce_scatter(x, algo=algo)
    assert got.shape == want.shape == (4, 3, 3)
    if algo == "xla":
        np.testing.assert_allclose(_np(got), want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("algo", ["xla", "tree", "scatter_ag", "psum", "auto"])
def test_broadcast(dp4, algo):
    jcomm, tcomm = dp4
    x = _x(jcomm, (7, 3), seed=7)
    for root in (0, 3):
        want = np.asarray(jcomm.broadcast(jcomm.device_put(x), root, algo=algo))
        np.testing.assert_array_equal(_np(tcomm.broadcast(x, root, algo=algo)), want)


@pytest.mark.parametrize("name", list(MESHES))
def test_point_to_point_and_all_to_all(devices, name):
    jcomm, tcomm = _pair(devices, name)
    w = jcomm.world
    x = _x(jcomm, (5,), seed=8)
    jx = jcomm.device_put(x)
    np.testing.assert_array_equal(_np(tcomm.ring_shift(x, 1)), np.asarray(jcomm.ring_shift(jx, 1)))
    np.testing.assert_array_equal(_np(tcomm.send_recv(x, 0, w - 1)),
                                  np.asarray(jcomm.send_recv(jx, src=0, dst=w - 1)))
    perm = [(i, (i * 3 + 1) % w) for i in range(w)]
    np.testing.assert_array_equal(_np(tcomm.permute(x, perm)), np.asarray(jcomm.permute(jx, perm)))
    a2a = np.random.default_rng(9).standard_normal((w, w, 5)).astype(np.float32)
    np.testing.assert_array_equal(_np(tcomm.all_to_all(a2a)),
                                  np.asarray(jcomm.all_to_all(jcomm.device_put(a2a))))
    tcomm.barrier()


def test_shape_errors_raise_value_error(dp4):
    _, tcomm = dp4
    bad = np.zeros((5, 2), np.float32)
    for call in (lambda: tcomm.all_reduce(bad), lambda: tcomm.device_put(bad),
                 lambda: tcomm.all_gather(bad), lambda: tcomm.broadcast(bad),
                 lambda: tcomm.all_to_all(np.zeros((4, 3), np.float32)),
                 lambda: tcomm.reduce_scatter(np.zeros((4, 9), np.float32)),
                 lambda: tcomm.broadcast(np.zeros((4, 2), np.float32), root=4),
                 lambda: tcomm.all_reduce(np.zeros((4, 2), np.float32), algo="nonesuch"),
                 lambda: tcomm.all_reduce(np.zeros((4, 2), np.float32), ReduceOp.MAX, "pallas")):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(ValueError, match="not in mesh axes"):
        Communicator(tcomm.mesh, "nonesuch")


def test_kernel_algos_need_one_axis(devices):
    _, tcomm = _pair(devices, "ep_tuple")
    for call in (lambda x: tcomm.all_reduce(x, algo="pallas"),
                 lambda x: tcomm.all_gather(x, algo="bidir"),
                 lambda x: tcomm.broadcast(x, algo="scatter_ag")):
        with pytest.raises(ValueError, match="single mesh axis"):
            call(np.zeros((4, 4), np.float32))


def test_quantized_wire_raises_not_implemented(dp4):
    _, tcomm = dp4
    x = np.zeros((4, 8), np.float32)
    for call in (lambda: tcomm.all_reduce(x, algo="pallas", wire_dtype="fp8"),
                 lambda: tcomm.all_gather(x, algo="ring", wire_dtype="int8"),
                 lambda: tcomm.reduce_scatter(x, algo="ring", wire_dtype="fp8"),
                 lambda: tcomm.broadcast(x, algo="scatter_ag", wire_dtype="fp8")):
        with pytest.raises(NotImplementedError, match="next slice"):
            call()


def test_forced_small_budget_counts_a_fallback(dp4):
    """On the CPU, past the arena budget the kernel algos take the plan
    lowering, as the JAX package does: still right, and counted on
    ep_wire_fallback_total (and, for the pairs, on collective_plan_total
    with outcome fallback). CUDA tensors ignore the budget."""
    _, tcomm = dp4
    x = _x(tcomm, (64,), seed=10)
    dma.MAX_ARENA_BYTES.set(64)
    try:
        before = dma.WIRE_FALLBACK.get(what="all_reduce", reason="arena_budget")
        got = tcomm.all_reduce(x, algo="pallas")
        assert dma.WIRE_FALLBACK.get(what="all_reduce", reason="arena_budget") == before + 1
        np.testing.assert_allclose(_np(got), np.broadcast_to(x.sum(0), x.shape), rtol=1e-5,
                                   atol=1e-6)
        from uccl_tpu_torch.collective import plan

        pk = dict(algo="bidir", chunks=2, wire_dtype="none", outcome="fallback")
        before = plan.PLAN_TOTAL.get(**pk)
        tcomm.all_reduce(x, algo="bidir")
        assert plan.PLAN_TOTAL.get(**pk) == before + 1
        before = dma.WIRE_FALLBACK.total()
        np.testing.assert_array_equal(_np(tcomm.all_gather(x, algo="ring")), x)
        np.testing.assert_array_equal(_np(tcomm.broadcast(x, 1, algo="scatter_ag")),
                                      np.broadcast_to(x[1], x.shape))
        assert dma.WIRE_FALLBACK.total() == before + 2
    finally:
        dma.MAX_ARENA_BYTES.set(None)


def test_plan_memo_emits_once_per_request(dp4):
    _, tcomm = dp4
    from uccl_tpu_torch.collective import plan

    x = _x(tcomm, (3,), seed=11)
    key = dict(algo="pallas", chunks=1, wire_dtype="none", outcome="explicit")
    before = plan.PLAN_TOTAL.get(**key)
    for _ in range(3):
        tcomm.all_reduce(x, algo="pallas")
    assert plan.PLAN_TOTAL.get(**key) == before + 1
    assert ring_ccl.launch_counts["ring_all_reduce"] == 0  # CPU: the plain version ran


def test_ops_wrappers_tally_and_match():
    from uccl_tpu_torch.collective import ops

    x = torch.randn(4, 8, 3)
    calls = ops._CALLS.get(op="all_gather")
    g = ops.all_gather(x)
    assert ops._CALLS.get(op="all_gather") == calls + 1
    assert torch.equal(g[2], x.reshape(32, 3))
    assert torch.equal(ops.reduce_scatter(x), torch.stack(x.sum(0).chunk(4)))
    assert torch.equal(ops.ring_shift(x, 1)[1], x[0])
    assert torch.equal(ops.broadcast(x, 2)[0], x[2])
    a2a = ops.all_to_all(x, split_dim=0, concat_dim=0)
    assert torch.equal(a2a[1, 2:4], x[1, 2:4]) and torch.equal(a2a[1, 0:2], x[0, 2:4])
    assert torch.allclose(ops.all_reduce(x, algo="auto"), x.sum(0).expand_as(x), atol=1e-5)


@pytest.mark.parametrize("forced", ["pallas", "bidir", "torus"])
def test_ops_all_reduce_lowers_forced_kernel_algos(forced):
    """ops.all_reduce(auto) with UCCL_TPU_AR_ALGO forced: the kernel algos
    run the ring_ccl path (its plain version on the CPU) with no fallback;
    torus, which needs two axes, runs xla and is counted."""
    from uccl_tpu_torch.collective import dma, ops, plan

    x = torch.tensor(np.random.default_rng(12).standard_normal((4, 3000)), dtype=torch.float32)
    want = {"pallas": ring_ccl.ring_all_reduce, "bidir": ring_ccl.bidir_all_reduce,
            "torus": lambda t: ops.reduce_members(t, "sum")}[forced](x)
    fb = dma.WIRE_FALLBACK.get(what="ops_all_reduce", reason="no_lowering")
    plan._AR_FORCE_ALGO.set(forced)
    try:
        got = ops.all_reduce(x, algo="auto")
    finally:
        plan._AR_FORCE_ALGO.set(None)
    assert torch.equal(got, want)
    moved = dma.WIRE_FALLBACK.get(what="ops_all_reduce", reason="no_lowering") - fb
    assert moved == (forced == "torus")
