"""The port's plan lowerings and planner (uccl_tpu_torch/collective/plan.py)
against the JAX package's (uccl_tpu/collective/plan.py).

Lowerings: the same seeded numpy inputs through the JAX per-shard lowering
(shard_map on the virtual CPU mesh, each hop a lax.ppermute) and the port's
member-stacked one. They run the same hops with the same adds, so the
results must be bit-identical. Planner: the same decisions (algo, chunks,
outcome) and the same predicted cost over a table of payload sizes, worlds
and verbs, with the port's arena budget set to the JAX gate's limit here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from uccl_tpu.collective import dma as jdma
from uccl_tpu.collective import plan as jplan
from uccl_tpu.utils import config as jconfig
from uccl_tpu.utils.jaxcompat import shard_map
from uccl_tpu_torch.collective import dma as tdma
from uccl_tpu_torch.collective import plan as tplan
from uccl_tpu_torch.utils import config as tconfig


def _jax_run(mesh, axis, fn, x):
    mapped = shard_map(fn, mesh=mesh, in_specs=(P(axis),), out_specs=P(axis), check_vma=False)
    return np.asarray(jax.jit(mapped)(x)).astype(np.float32)


def _mesh(devices, n):
    return Mesh(np.array(devices[:n]), ("dp",))


def _inputs(shape, seed, dtype="f32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bf16":
        return jnp.asarray(x, jnp.bfloat16), torch.tensor(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.tensor(x)


def _eq(got, want):
    np.testing.assert_array_equal(got.float().numpy().reshape(want.shape), want)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("bidirectional,direction", [(True, 1), (False, 1), (False, -1)])
def test_ring_all_reduce_lowering(devices, n, bidirectional, direction):
    xj, xt = _inputs((n, 37), seed=n)
    want = _jax_run(_mesh(devices, n), "dp", lambda v: jplan.ring_all_reduce(
        v, "dp", bidirectional=bidirectional, direction=direction), xj)
    _eq(tplan.ring_all_reduce(xt, bidirectional=bidirectional, direction=direction), want)


@pytest.mark.parametrize("n,dtype", [(3, "f32"), (4, "bf16"), (8, "f32")])
def test_reduce_scatter_and_all_gather_lowerings(devices, n, dtype):
    xj, xt = _inputs((n, n * 6), seed=10 + n, dtype=dtype)
    want = _jax_run(_mesh(devices, n), "dp",
                    lambda v: jplan.ring_reduce_scatter(v.reshape(-1), "dp"), xj)
    _eq(tplan.ring_reduce_scatter(xt), want)
    want = _jax_run(_mesh(devices, n), "dp", lambda v: jplan.ring_all_gather(v, "dp"), xj)
    _eq(tplan.ring_all_gather(xt.reshape(n, 1, n * 6)), want)


@pytest.mark.parametrize("n,dtype", [(2, "f32"), (4, "bf16"), (8, "f32"), (3, "f32")])
def test_hd_all_reduce_lowering(devices, n, dtype):
    """Power-of-two worlds halve and double; n = 3 takes the ring plan."""
    xj, xt = _inputs((n, 29), seed=20 + n, dtype=dtype)
    want = _jax_run(_mesh(devices, n), "dp", lambda v: jplan.hd_all_reduce(v, "dp"), xj)
    _eq(tplan.hd_all_reduce(xt), want)


@pytest.mark.parametrize("worlds", [(2, 4), (4, 2)])
def test_torus_all_reduce_lowering(devices, worlds):
    mesh = Mesh(np.array(devices[:8]).reshape(worlds), ("a", "b"))
    xj, xt = _inputs((8, 33), seed=30)
    want = _jax_run(mesh, ("a", "b"), lambda v: jplan.torus_all_reduce(v, ("a", "b")), xj)
    _eq(tplan.torus_all_reduce(xt, worlds, ("a", "b")), want)


@pytest.mark.parametrize("n,root", [(4, 0), (5, 3), (8, 6)])
def test_tree_broadcast_lowering(devices, n, root):
    xj, xt = _inputs((n, 11), seed=40 + n)
    want = _jax_run(_mesh(devices, n), "dp", lambda v: jplan.tree_broadcast(v, "dp", root), xj)
    _eq(tplan.tree_broadcast(xt, root), want)


def test_graph_forms_match():
    for w in (2, 3, 5):
        jg, tg = jplan.graph_bidirectional_all_reduce(w, "dp"), \
            tplan.graph_bidirectional_all_reduce(w, "dp")
        assert [tuple(vars(o).values()) for o in jg.ops] == \
            [tuple(vars(o).values()) for o in tg.ops]
        assert [[o.id for o in lay] for lay in jg.layers()] == \
            [[o.id for o in lay] for lay in tg.layers()]
    jt, tt = jplan.graph_torus_all_reduce((2, 4), ("a", "b")), \
        tplan.graph_torus_all_reduce((2, 4), ("a", "b"))
    assert [tuple(vars(o).values()) for o in jt.ops] == [tuple(vars(o).values()) for o in tt.ops]
    rp = jplan.plan_all_reduce(4, -1)
    assert [tuple(vars(s).values()) for s in rp.steps] == \
        [tuple(vars(s).values()) for s in tplan.plan_all_reduce(4, -1).steps]


# ---------------------------------------------------------------------------
# The planner


@pytest.fixture
def same_budget():
    """The port's arena budget set to the limit the JAX gate applies on
    this CPU (its interpreter ceiling), so both probe the same limit."""
    tdma.MAX_ARENA_BYTES.set(jdma.budget_limit(jdma.resolve_interpret(None)))
    yield
    tdma.MAX_ARENA_BYTES.set(None)


# payload bytes chosen clear of the 64 KiB gate by more than the factor of 2
# between the JAX interpreter's pair charge (the larger half) and the port's
# (both halves), so the two gates agree
SIZES = [(1,), (16,), (256,), (4, 64), (256 * 1024,), (16 * 2 ** 20,)]
WORLDS = [(2, 1, None), (4, 1, None), (8, 1, None), (3, 1, None), (8, 2, (2, 4)),
          (4, 2, (2, 2))]


def _plans(jfn, tfn, shape, dt, world, n_axes, worlds, wire_dtype=None):
    j = jfn(shape, jnp.dtype(dt[0]), world, n_axes=n_axes, worlds=worlds,
            wire_dtype=wire_dtype, pallas_ok=n_axes == 1, emit=False)
    t = tfn(shape, dt[1], world, n_axes=n_axes, worlds=worlds, wire_dtype=wire_dtype,
            pallas_ok=n_axes == 1, emit=False)
    return j, t


PLAN_FNS = {"all_reduce": "plan_all_reduce", "all_gather": "plan_all_gather",
            "reduce_scatter": "plan_reduce_scatter", "broadcast": "plan_broadcast"}


@pytest.mark.parametrize("wire_dtype", [None, "fp8", "int8"])
@pytest.mark.parametrize("verb", list(PLAN_FNS))
def test_planner_decisions_match_jax(same_budget, verb, wire_dtype):
    """The same algo, chunks, outcome, emitted wire_dtype label (None when
    the winner cannot carry a quantized wire), wire bytes and predicted cost,
    over the table; a quantized wire is priced at its wire bytes and probed
    at the quantized kernels' charges."""
    jp, tp = jplan.get_planner(), tplan.get_planner()
    fns = PLAN_FNS[verb]
    seen = set()
    for shape in SIZES + ([(3, 100), (4096,)] if wire_dtype else []):
        for world, n_axes, worlds in WORLDS:
            for dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                       ("int32", torch.int32)):
                j, t = _plans(getattr(jp, fns), getattr(tp, fns), shape, dt, world, n_axes,
                              worlds, wire_dtype)
                key = (verb, shape, world, n_axes, dt[0], wire_dtype)
                assert (t.algo, t.chunks, t.outcome, t.verb, t.wire_bytes, t.wire_dtype) == \
                    (j.algo, j.chunks, j.outcome, j.verb, j.wire_bytes, j.wire_dtype), key
                assert t.predicted_us == pytest.approx(j.predicted_us, rel=1e-12), key
                seen.add((t.algo, t.wire_dtype))
    # the table reaches more than one decision for every verb, and with a
    # wire_dtype both a winner that carries it and one re-labelled to None
    assert len({a for a, _ in seen}) >= 2, seen
    if wire_dtype:
        assert {w for _, w in seen} == {wire_dtype, None}, seen


def test_forced_algo_and_explicit_plans(same_budget, monkeypatch):
    monkeypatch.setenv("UCCL_TPU_AR_ALGO", "ring")
    jconfig.reset_all()
    tconfig.reset_all()
    try:
        for world in (2, 4, 8):
            j = jplan.get_planner().plan_all_reduce((64,), jnp.float32, world, emit=False)
            t = tplan.get_planner().plan_all_reduce((64,), torch.float32, world, emit=False)
            assert (t.algo, t.outcome) == (j.algo, j.outcome) == ("ring", "forced")
            assert t.predicted_us == pytest.approx(j.predicted_us)
    finally:
        monkeypatch.delenv("UCCL_TPU_AR_ALGO")
        jconfig.reset_all()
        tconfig.reset_all()
        tdma.MAX_ARENA_BYTES.set(jdma.budget_limit(True))
    for verb, algo in [("all_reduce", "pallas"), ("all_gather", "bidir"),
                       ("broadcast", "scatter_ag"), ("broadcast", "tree"),
                       ("reduce_scatter", "ring"), ("all_reduce", "nonesuch")]:
        j = jplan.get_planner().plan_explicit(algo, (1000,), jnp.float32, 4, verb=verb,
                                              emit=False)
        t = tplan.get_planner().plan_explicit(algo, (1000,), torch.float32, 4, verb=verb,
                                              emit=False)
        assert (t.algo, t.chunks, t.outcome) == (j.algo, j.chunks, j.outcome)
        assert t.predicted_us == pytest.approx(j.predicted_us)
    for nbytes, world, n_axes in [(64, 8, 1), (1 << 20, 4, 1), (1 << 24, 8, 2), (4, 1, 1)]:
        assert tplan.select_all_reduce_algo(nbytes, world, n_axes) == \
            jplan.select_all_reduce_algo(nbytes, world, n_axes)


def test_plan_emission_counts(same_budget):
    before = tplan.PLAN_TOTAL.get(algo="xla", chunks=1, wire_dtype="none", outcome="model",
                                  verb="broadcast")
    tplan.get_planner().plan_broadcast((1,), torch.float32, 1)
    assert tplan.PLAN_TOTAL.get(algo="xla", chunks=1, wire_dtype="none", outcome="model",
                                verb="broadcast") == before + 1


def test_cost_features_match():
    for algo in ("ring", "pallas", "bidir", "hd", "torus", "hier", "xla"):
        for w in (2, 3, 4, 6, 8):
            assert tplan.cost_features(algo, w, 12345) == jplan.cost_features(algo, w, 12345)
    for verb, algos in [("broadcast", ("tree", "scatter_ag", "xla")),
                        ("all_gather", ("ring", "bidir", "xla")),
                        ("reduce_scatter", ("ring", "xla"))]:
        for algo in algos:
            for w in (2, 5, 8):
                assert tplan.verb_cost_features(verb, algo, w, 999) == \
                    jplan.verb_cost_features(verb, algo, w, 999)
            assert tplan.xla_wire_volume(verb, 4, 1000) == jplan.xla_wire_volume(verb, 4, 1000)


def test_wire_dtype_raises_in_the_planner():
    """Only an unknown wire_dtype raises now (ValueError); fp8 and int8 are
    priced at the wire bytes of ops/quant.py's wire_bytes_of."""
    tp = tplan.get_planner()
    for fn in (tp.plan_all_reduce, tp.plan_all_gather, tp.plan_reduce_scatter,
               tp.plan_broadcast, functools.partial(tp.plan_explicit, "ring")):
        with pytest.raises(ValueError, match="unknown wire_dtype"):
            fn((64,), torch.float32, 4, wire_dtype="fp4")
    for wd in ("fp8", "int8"):
        assert tp.wire_bytes((4, 256), torch.float32, wd) == 1024 + 8 * 4
        assert tp.wire_bytes((4, 256), torch.int32, wd) == 4096  # non-float: raw wire
        p = tp.plan_all_reduce((64,), torch.float32, 4, wire_dtype=wd, emit=False)
        assert p.wire_dtype is None and p.wire_bytes == 256  # hd cannot carry it


@pytest.mark.parametrize("wd", ["fp8", "int8"])
def test_quantized_plans_relabel_and_emit_like_jax(same_budget, wd):
    """tests/test_bcast_ag.py's planner cases, on both packages: a quantized
    wire that fits where the f32 pair does not flips the decision to the
    kernel; a winner that cannot carry the wire is emitted at full
    precision; explicit plans keep the label they were given; the counter's
    wire_dtype label follows."""
    jp, tp = jplan.get_planner(), tplan.get_planner()
    # f32: each half's gather buffer (8 x 3072 x 4 B) is over the 64 KiB
    # limit; quantized: both halves' wire buffers together (2 x 8 x 3584 B)
    # fit, under the JAX interpreter's larger-half rule and the port's sum
    shape = (8 * 6144,)
    for wire_dtype, algo, label in ((None, "xla", None), (wd, "scatter_ag", wd)):
        j = jp.plan_broadcast(shape, jnp.float32, 8, pallas_ok=True, wire_dtype=wire_dtype,
                              emit=False)
        t = tp.plan_broadcast(shape, torch.float32, 8, pallas_ok=True, wire_dtype=wire_dtype,
                              emit=False)
        assert (t.algo, t.wire_dtype) == (j.algo, j.wire_dtype) == (algo, label)
    t = tp.plan_broadcast((64,), torch.float32, 8, pallas_ok=True, wire_dtype=wd, emit=False)
    assert (t.algo, t.wire_dtype) == ("tree", None)
    for verb, algo in (("all_reduce", "pallas"), ("all_reduce", "hd"), ("all_gather", "bidir"),
                       ("reduce_scatter", "ring"), ("broadcast", "scatter_ag")):
        j = jp.plan_explicit(algo, (1000,), jnp.float32, 4, verb=verb, wire_dtype=wd, emit=False)
        t = tp.plan_explicit(algo, (1000,), torch.float32, 4, verb=verb, wire_dtype=wd,
                             emit=False)
        assert (t.algo, t.chunks, t.wire_dtype, t.wire_bytes) == \
            (j.algo, j.chunks, j.wire_dtype, j.wire_bytes)
        assert t.predicted_us == pytest.approx(j.predicted_us)
    key = dict(algo="ring", chunks=1, wire_dtype=wd, outcome="model", verb="reduce_scatter")
    before = tplan.PLAN_TOTAL.get(**key)
    p = tp.plan_reduce_scatter((4096,), torch.float32, 4, pallas_ok=True, wire_dtype=wd)
    assert p.algo == "ring" and tplan.PLAN_TOTAL.get(**key) == before + 1
