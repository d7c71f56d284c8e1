"""The port's host utilities against the JAX package's.

``utils/latency`` (the same summaries from the same samples), ``utils/timing``
(``perturb`` bit for bit, negative carries included; the two estimators
return positive seconds on the CPU), ``collective/plan.graph_from_ring``,
``utils/topology``'s torus helpers, ``utils/logging``'s ``CHECK`` /
``DCHECK``, ``collective/ops.all_to_all(tiled=False)`` against
``lax.all_to_all(tiled=False)`` on the virtual CPU mesh, ``utils/stats``
(registry mirroring, the reporter thread's lifecycle and quiet mode, the
serving metrics' registration through it) and ``utils/tracing`` (scopes, a
``torch.profiler`` capture written as a Chrome trace, annotations in it).
Everything is exact: the same integer or float arithmetic on both sides.
"""

import dataclasses
import json
import logging
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P
from torch_one_thread import one_torch_thread  # noqa: F401

from uccl_tpu.collective import plan as jplan
from uccl_tpu.utils import latency as jlatency
from uccl_tpu.utils import timing as jtiming
from uccl_tpu.utils import topology as jtopo
from uccl_tpu.utils.jaxcompat import shard_map
from uccl_tpu_torch import obs as tobs
from uccl_tpu_torch.collective import ops as tops
from uccl_tpu_torch.collective import plan as tplan
from uccl_tpu_torch.utils import latency as tlatency
from uccl_tpu_torch.utils import logging as tlogging
from uccl_tpu_torch.utils import stats as tstats
from uccl_tpu_torch.utils import timing as ttiming
from uccl_tpu_torch.utils import topology as ttopo
from uccl_tpu_torch.utils import tracing as ttracing


def test_latency_histogram_summaries_match():
    samples = np.random.default_rng(0).lognormal(4.0, 2.0, 2000)
    samples[:5] = (0.0, 0.3, 1.0, 7e7, 59e6)  # under 1 us, past max_us
    hists = [mod.LatencyHistogram() for mod in (jlatency, tlatency)]
    for h in hists:
        assert h.summary() == {"count": 0.0, "mean_us": 0.0, "min_us": 0.0, "p50_us": 0.0,
                               "p90_us": 0.0, "p99_us": 0.0, "max_us": 0.0}
        h.record_many(samples.tolist())
    assert hists[0].summary() == hists[1].summary()
    assert [hists[0].percentile(p) for p in (1, 25, 75, 99.9, 100)] == \
        [hists[1].percentile(p) for p in (1, 25, 75, 99.9, 100)]
    assert str(hists[0]) == str(hists[1])


@pytest.mark.parametrize("dtype", [np.int32, np.int8, np.uint8, np.float32])
def test_perturb_is_jax_s_bit_for_bit(dtype):
    """Integer leaves stay bit-unchanged for every carry, negative included;
    float leaves move by the same c*1e-12 as JAX's."""
    a = (np.arange(-6, 6) * 7).astype(dtype)
    for carry in (-3.7, -1.0, -0.0, 0.0, 2.5, 1e6):
        want = np.asarray(jtiming.perturb(jnp.asarray(a), jnp.float32(carry)))
        got = ttiming.perturb(torch.from_numpy(a.copy()), torch.tensor(carry, dtype=torch.float32))
        assert got.dtype == torch.from_numpy(a).dtype
        np.testing.assert_array_equal(got.numpy().view(np.uint8), want.view(np.uint8))
        if np.issubdtype(dtype, np.integer):
            np.testing.assert_array_equal(got.numpy(), a)


def test_chained_and_slope_timeit_return_positive_seconds(capsys):
    x = torch.randn(64, 64)
    dt = ttiming.chained_timeit("probe", lambda a, c: c + (a @ a).sum() * 1e-9, x, iters=3,
                                flops=2 * 64**3)
    assert dt > 0 and "probe" in capsys.readouterr().out
    slope = ttiming.slope_timeit(lambda a, n: (a @ a, n + 1), (x, torch.arange(4)), 2,
                                 signal_floor=1e-4, n_cap=200)
    assert slope > 0


def _graph_fields(g):
    return (g.axes, g.worlds, g.n_streams, g.name,
            [dataclasses.astuple(op) for op in g.ops])


@pytest.mark.parametrize("world", [2, 3, 4, 8])
def test_graph_from_ring_matches(world):
    for name in ("plan_all_reduce", "plan_reduce_scatter", "plan_all_gather"):
        for direction in (1, -1):
            want = jplan.graph_from_ring(getattr(jplan, name)(world, direction), "dp")
            got = tplan.graph_from_ring(getattr(tplan, name)(world, direction), "dp")
            assert _graph_fields(got) == _graph_fields(want)
            got.validate()
            assert [[op.id for op in layer] for layer in got.layers()] == \
                [[op.id for op in layer] for layer in want.layers()]


def test_torus_helpers_match():
    assert dataclasses.astuple(ttopo.TorusAxis("x", 4)) == dataclasses.astuple(jtopo.TorusAxis("x", 4))
    with pytest.raises(dataclasses.FrozenInstanceError):
        ttopo.TorusAxis("x", 4).size = 2
    for n in range(1, 65):
        assert ttopo.factor_2d(n) == jtopo.factor_2d(n)
    for n in (1, 2, 4, 8, 16):
        for r in range(n):
            assert ttopo.recursive_halving_peers(r, n) == jtopo.recursive_halving_peers(r, n)
    for mod in (jtopo, ttopo):
        with pytest.raises(ValueError, match="power-of-two"):
            mod.recursive_halving_peers(0, 6)


def test_check_and_dcheck(monkeypatch):
    tlogging.CHECK(True)
    with pytest.raises(tlogging.CheckError, match="broken"):
        tlogging.CHECK(0, "broken")
    assert issubclass(tlogging.CheckError, AssertionError)
    with pytest.raises(tlogging.CheckError, match="DCHECK failed"):
        tlogging.DCHECK([])
    monkeypatch.setattr(tlogging, "_DCHECK_ON", False)  # UCCL_TPU_DCHECK=0
    tlogging.DCHECK(False)


A2A_CASES = [  # (shard shape, split_dim, concat_dim); split_dim has size 4
    ((4, 3, 2), 0, 0), ((4, 3, 2), 0, 1), ((4, 3, 2), 0, 2),
    ((3, 4, 2), 1, 0), ((3, 4, 2), 1, 2), ((3, 2, 4), -1, 1), ((2, 4), 1, -1),
]


@pytest.mark.parametrize("shape,split_dim,concat_dim", A2A_CASES)
def test_untiled_all_to_all_matches_lax(devices, shape, split_dim, concat_dim):
    n = 4
    x = np.random.default_rng(3).standard_normal((n, *shape)).astype(np.float32)
    mesh = Mesh(np.array(devices[:n]), ("x",))
    nd = len(shape)  # lax takes the dims non-negative; the port both ways
    f = shard_map(lambda v: jax.lax.all_to_all(v[0], "x", split_dim % nd, concat_dim % nd,
                                               tiled=False)[None],
                  mesh=mesh, in_specs=(P("x"),), out_specs=P("x"))
    want = np.asarray(jax.jit(f)(jnp.asarray(x)))
    got = tops.all_to_all(torch.tensor(x), split_dim=split_dim, concat_dim=concat_dim,
                          tiled=False)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_untiled_all_to_all_needs_world_sized_split():
    with pytest.raises(ValueError, match="world size"):
        tops.all_to_all(torch.zeros(4, 3, 2), split_dim=0, concat_dim=0, tiled=False)


def test_stats_registry_mirrors_into_obs():
    tstats.registry.register("port_shim_test", lambda: {"v": 7.0})
    try:
        assert tobs.REGISTRY.sources_snapshot()["port_shim_test"] == {"v": 7.0}
        assert tstats.registry.snapshot()["port_shim_test"] == {"v": 7.0}
    finally:
        tstats.registry.unregister("port_shim_test")
    assert "port_shim_test" not in tobs.REGISTRY.sources_snapshot()
    alone = tstats.StatsRegistry()  # no obs registry: self-contained
    alone.register("alone", lambda: 1 / 0)
    assert "ZeroDivisionError" in alone.snapshot()["alone"]["error"]
    assert "alone" not in tobs.REGISTRY.sources_snapshot()


def test_serving_metrics_register_through_stats():
    from uccl_tpu_torch.serving.metrics import ServingMetrics

    class Engine:
        def snapshot(self):
            return {"completed": 3, "occupancy": 0.5, "name": "x"}

    m = ServingMetrics()
    m.register(Engine(), name="serving_unit")
    try:
        want = {"completed": 3.0, "occupancy": 0.5}
        assert tstats.registry.snapshot()["serving_unit"] == want
        assert tobs.REGISTRY.sources_snapshot()["serving_unit"] == want
    finally:
        m.unregister("serving_unit")
    assert "serving_unit" not in tstats.registry.snapshot()
    assert "serving_unit" not in tobs.REGISTRY.sources_snapshot()


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_stats_thread_lifecycle_and_quiet_mode():
    reg = tstats.StatsRegistry()
    reg.register("unit", lambda: {"n": 1.0})
    logger = logging.getLogger("uccl_tpu_torch.UTIL")
    handler, level = _Lines(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    tstats._interval.set(0.01)
    try:
        for quiet in (False, True):
            tstats._quiet.set(quiet)  # UCCL_TPU_STATS_QUIET
            handler.lines.clear()
            th = tstats.StatsThread(reg)
            th.start()
            th.start()  # idempotent
            worker = th._thread
            time.sleep(0.2)
            th.stop()
            assert not worker.is_alive() and th._thread is None
            said = [line for line in handler.lines if line.startswith("stats: ")]
            assert (said == []) == quiet
            if not quiet:
                assert "'unit': {'n': 1.0}" in said[0]
    finally:
        tstats._interval.set(None)
        tstats._quiet.set(None)
        logger.removeHandler(handler)
        logger.setLevel(level)


def test_timed_scopes_thread_safe_and_exported():
    ttracing.reset_scopes()
    tr = tobs.enable_tracing()
    try:
        def worker():
            for _ in range(200):
                with ttracing.timed_scope("unit_scope"):
                    pass

        threads = [threading.Thread(target=worker) for _ in range(8)]
        [t.start() for t in threads]
        [t.join(timeout=30) for t in threads]
        assert not any(t.is_alive() for t in threads)
        assert ttracing.scope_stats("unit_scope")["count"] == 1600
        assert tobs.REGISTRY.sources_snapshot()["scopes"]["unit_scope"]["count"] == 1600
        assert sum(e.name == "unit_scope" for e in tr.events()) == 1600
    finally:
        tobs.disable_tracing()
    ttracing.reset_scopes()
    assert ttracing.scope_stats("unit_scope") is None


def test_profiler_capture_writes_a_chrome_trace(tmp_path):
    ttracing.start_trace(str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="already running"):
            ttracing.start_trace(str(tmp_path))
        with ttracing.annotate("unit_region"):
            (torch.randn(32, 32) @ torch.randn(32, 32)).sum()
    finally:
        path = ttracing.stop_trace()
    with pytest.raises(RuntimeError, match="no trace capture"):
        ttracing.stop_trace()
    assert path.startswith(str(tmp_path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "unit_region" in names and any("mm" in str(n) for n in names)
