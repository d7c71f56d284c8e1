"""The port's plan lowerings and planner (uccl_tpu_torch/collective/plan.py)
against the JAX package's (uccl_tpu/collective/plan.py).

Lowerings: the same seeded numpy inputs through the JAX per-shard lowering
(shard_map on the virtual CPU mesh, each hop a lax.ppermute) and the port's
member-stacked one. They run the same hops with the same adds, so the
results must be bit-identical. Planner: the same decisions (algo, chunks,
outcome) and the same predicted cost over a table of payload sizes, worlds
and verbs, with the port's arena budget set to the JAX gate's limit here.
"""

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


def _plans(jfn, tfn, shape, dt, world, n_axes, worlds):
    j = jfn(shape, jnp.dtype(dt[0]), world, n_axes=n_axes, worlds=worlds,
            pallas_ok=n_axes == 1, emit=False)
    t = tfn(shape, dt[1], world, n_axes=n_axes, worlds=worlds, pallas_ok=n_axes == 1,
            emit=False)
    return j, t


@pytest.mark.parametrize("verb", ["all_reduce", "all_gather", "reduce_scatter", "broadcast"])
def test_planner_decisions_match_jax(same_budget, verb):
    jp, tp = jplan.get_planner(), tplan.get_planner()
    fns = {"all_reduce": "plan_all_reduce", "all_gather": "plan_all_gather",
           "reduce_scatter": "plan_reduce_scatter", "broadcast": "plan_broadcast"}[verb]
    seen = set()
    for shape in SIZES:
        for world, n_axes, worlds in WORLDS:
            for dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                j, t = _plans(getattr(jp, fns), getattr(tp, fns), shape, dt, world, n_axes,
                              worlds)
                key = (verb, shape, world, n_axes, dt[0])
                assert (t.algo, t.chunks, t.outcome, t.verb, t.wire_bytes) == \
                    (j.algo, j.chunks, j.outcome, j.verb, j.wire_bytes), key
                assert t.predicted_us == pytest.approx(j.predicted_us, rel=1e-12), key
                seen.add(t.algo)
    # the table reaches more than one decision for every verb
    assert len(seen) >= 2, seen


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
    with pytest.raises(NotImplementedError):
        tplan.get_planner().plan_all_reduce((64,), torch.float32, 4, wire_dtype="int8")
