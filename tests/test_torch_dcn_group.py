"""uccl_tpu_torch.collective.hierarchical against the JAX package's:
``tests/test_dcn_group.py`` case for case on the port's ``DcnGroup``
(threaded ranks over real loopback TCP), a ring shared by port and JAX
ranks, and ``hierarchical_all_reduce`` on two pods of four members each
beside the JAX function on the conftest's eight CPU devices.

Tolerances: the ring sums are exact against the JAX package's own ring
(same reduction order; a mixed port/JAX ring is bit-equal to an all-JAX
one) and within the JAX test's rtol 1e-5 of numpy's sum; every gather,
all-to-all and broadcast is exact. ``hierarchical_all_reduce`` is
bit-equal to the JAX function. The heal cases order the dying rank's
teardown before the survivors' heal with a barrier, where the JAX tests
sleep.
"""

import threading
import time

import numpy as np
import pytest
import torch

from uccl_tpu.collective.hierarchical import DcnGroup as JDcnGroup
from uccl_tpu.p2p.store import StoreClient as JStoreClient
from uccl_tpu.parallel.distributed import Session as JSession
from uccl_tpu_torch import obs
from uccl_tpu_torch.collective.hierarchical import DcnGroup
from uccl_tpu_torch.ep import a2a_sched
from uccl_tpu_torch.p2p.store import StoreClient, StoreServer
from uccl_tpu_torch.parallel.distributed import Session

from torch_one_thread import one_torch_thread  # noqa: F401


PORT = (DcnGroup, StoreClient, Session)
JAXP = (JDcnGroup, JStoreClient, JSession)


def _run_group(world, fn, kinds=None, tag="0"):
    """Spin up `world` ranks as threads, each with its own DcnGroup; rank
    r uses the package ``kinds[r]`` (the port's by default)."""
    kinds = kinds or [PORT] * world
    server = StoreServer()
    results = [None] * world
    errors = []

    def rank_main(r):
        try:
            group_cls, client_cls, sess_cls = kinds[r]
            client = client_cls("127.0.0.1", server.port)
            sess = sess_cls(rank=r, world=world, store=client)
            g = group_cls(sess, n_paths=2, tag=tag)
            try:
                results[r] = fn(g, r)
            finally:
                g.close()
                client.close()
        except Exception as e:  # pragma: no cover - surfaced via assert below
            errors.append((r, e))

    threads = [threading.Thread(target=rank_main, args=(r,)) for r in range(world)]
    [t.start() for t in threads]
    [t.join(timeout=120) for t in threads]
    server.close()
    assert not errors, errors
    return results


@pytest.mark.parametrize("world", [2, 3])
def test_all_reduce(world, rng):
    xs = [rng.standard_normal(100).astype(np.float32) for _ in range(world)]
    want = np.sum(xs, axis=0)
    outs = _run_group(world, lambda g, r: g.all_reduce(xs[r]))
    for out in outs:
        np.testing.assert_allclose(out, want, rtol=1e-5)
    # the JAX ring's reduction order, bit for bit
    jouts = _run_group(world, lambda g, r: g.all_reduce(xs[r]), kinds=[JAXP] * world)
    for out, jout in zip(outs, jouts):
        np.testing.assert_array_equal(out, jout)


def test_all_reduce_2d_payload(rng):
    xs = [rng.standard_normal((7, 13)).astype(np.float32) for _ in range(2)]
    outs = _run_group(2, lambda g, r: g.all_reduce(xs[r]))
    np.testing.assert_allclose(outs[0], xs[0] + xs[1], rtol=1e-5)
    np.testing.assert_allclose(outs[1], xs[0] + xs[1], rtol=1e-5)


def test_all_gather(rng):
    xs = [rng.standard_normal(16).astype(np.float32) for _ in range(3)]
    outs = _run_group(3, lambda g, r: g.all_gather(xs[r]))
    for out in outs:
        for i in range(3):
            np.testing.assert_array_equal(out[i], xs[i])


@pytest.mark.parametrize("world", [2, 3])
def test_all_to_all(world, rng):
    xs = [rng.standard_normal((world, 5)).astype(np.float32) for _ in range(world)]
    outs = _run_group(world, lambda g, r: g.all_to_all(xs[r]))
    for i, out in enumerate(outs):
        for j in range(world):
            # out[j] on rank i == rank j's row i
            np.testing.assert_array_equal(out[j], xs[j][i])


def test_all_to_all_regrow_after_calls(rng):
    """Regrow right after all_to_all calls: the deferred consume-licenses
    (up to two unconsumed ACs per channel) must be skipped by the MF
    descriptor exchange, not poison the group."""
    bigs = [rng.standard_normal((2, 4096)).astype(np.float32) + r for r in range(2)]

    def body(g, r):
        for i in range(2):  # leaves deferred ACs queued (consumed at i+2)
            g.all_to_all(np.full((2, 4), float(10 * r + i), np.float32))
        out = g.all_to_all(bigs[r])  # regrow -> MF exchange over the same chans
        # then a broadcast still works on the post-regrow group
        b = g.broadcast(np.full(8, 3.0 + r, np.float32), root=1)
        return out, b

    outs = _run_group(2, body)
    for i, (out, b) in enumerate(outs):
        assert b[0] == 4.0  # root 1's value
        assert out.shape == (2, 4096)
        for j in range(2):
            np.testing.assert_array_equal(out[j], bigs[j][i])


def test_world_one_degenerate(rng):
    x = rng.standard_normal(10).astype(np.float32)
    outs = _run_group(1, lambda g, r: g.all_reduce(x))
    np.testing.assert_array_equal(outs[0], x)


def test_barrier():
    _run_group(2, lambda g, r: g.barrier())


@pytest.mark.parametrize("world,root", [(2, 0), (3, 1), (4, 3)])
def test_broadcast(world, root, rng):
    xs = [rng.standard_normal((4, 9)).astype(np.float32) for _ in range(world)]
    outs = _run_group(world, lambda g, r: g.broadcast(xs[r], root=root))
    for out in outs:
        np.testing.assert_array_equal(out, xs[root])


def test_all_to_all_world4(rng):
    world = 4
    xs = [rng.standard_normal((world, 17)).astype(np.float32) for _ in range(world)]
    outs = _run_group(world, lambda g, r: g.all_to_all(xs[r]))
    for i, out in enumerate(outs):
        for j in range(world):
            np.testing.assert_array_equal(out[j], xs[j][i])


def test_all_to_all_traffic_is_pairwise(rng):
    """all_to_all moves O(rows) bytes per rank, not O(world*rows) like a
    ring-gather + column-select would."""
    world, row_bytes = 4, 256 << 10
    rows = row_bytes // 4
    xs = [rng.standard_normal((world, rows)).astype(np.float32) for _ in range(world)]

    def fn(g, r):
        before = g.ep.stats["bytes_tx"]
        g.all_to_all(xs[r])
        return g.ep.stats["bytes_tx"] - before

    sent = _run_group(world, fn)
    budget = (world - 1) * row_bytes + (64 << 10)
    for r, tx in enumerate(sent):
        assert tx < 1.6 * budget, f"rank {r} sent {tx} bytes (budget {budget})"


def test_mixed_ops_interleave(rng):
    """Ring and mesh collectives share one endpoint without cross-talk."""
    def fn(g, r):
        s = g.all_reduce(np.full(8, float(r), np.float32))
        b = g.broadcast(np.full(8, float(r), np.float32), root=2)
        a = g.all_to_all(np.full((3, 4), float(r), np.float32))
        return s[0], b[0], [a[j][0] for j in range(3)]

    outs = _run_group(3, fn)
    for r, (s, b, a) in enumerate(outs):
        assert s == 0.0 + 1.0 + 2.0
        assert b == 2.0
        assert a == [0.0, 1.0, 2.0]


def test_broadcast_landing_survives_the_next_all_to_all(rng):
    """The JAX protocol lets a broadcast root's next all_to_all write (its
    first two calls need no license) land on the bytes the receiver is
    still copying out of the broadcast. Between port ranks the receiver
    acks its copy first: a receiver made slow to read (a 50 ms stall in
    front of every landing read) still returns the root's data."""
    world = 2
    xs = [rng.standard_normal(64).astype(np.float32) for _ in range(world)]
    ys = [rng.standard_normal((world, 64)).astype(np.float32) for _ in range(world)]

    def body(g, r):
        if r == 1:
            read = g._mesh_region

            def slow_read(src, nbytes):
                time.sleep(0.05)
                return read(src, nbytes)

            g._mesh_region = slow_read
        out = []
        for i in range(3):
            b = g.broadcast(xs[r] + i, root=0)
            a = g.all_to_all(ys[r] + i)
            out.append((b, a))
        return out

    outs = _run_group(world, body, tag="bcast_a2a")
    for r in range(world):
        for i, (b, a) in enumerate(outs[r]):
            np.testing.assert_array_equal(b, xs[0] + i)
            for j in range(world):
                np.testing.assert_array_equal(a[j], ys[j][r] + i)


@pytest.mark.parametrize("kinds", [[PORT, JAXP], [JAXP, PORT, PORT]], ids=["port+jax", "jax+port+port"])
def test_port_and_jax_ranks_share_one_ring(kinds, rng):
    """A port rank and a JAX rank in one group: every collective completes
    on both, and the sums are the all-JAX ring's, bit for bit."""
    world = len(kinds)
    xs = [rng.standard_normal((5, 37)).astype(np.float32) for _ in range(world)]
    ys = [rng.standard_normal((world, 6)).astype(np.float32) for _ in range(world)]

    def body(g, r):
        return (g.all_reduce(xs[r]), g.all_gather(xs[r]), g.all_to_all(ys[r]),
                g.broadcast(xs[r], root=world - 1))

    mixed = _run_group(world, body, kinds=kinds, tag="mixed")
    ref = _run_group(world, body, kinds=[JAXP] * world, tag="mixed")
    for r in range(world):
        for got, want in zip(mixed[r], ref[r]):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(mixed[r][0], np.sum(xs, axis=0), rtol=1e-5)


def _heal_run(world, tag, dies, body_before, body_after, monitor=False):
    """Ranks run body_before; rank ``dies`` then closes its group; the
    survivors wait for that teardown (a barrier, not a sleep), heal and
    run body_after."""
    from uccl_tpu_torch.parallel.health import HeartbeatMonitor

    server = StoreServer()
    results, errors = {}, []
    gone = threading.Barrier(world)

    def rank_main(r):
        client = StoreClient("127.0.0.1", server.port)
        sess = Session(rank=r, world=world, store=client)
        g = DcnGroup(sess, n_paths=2, tag=tag)
        mon = HeartbeatMonitor(sess, interval_s=0.1, timeout_s=0.6) if monitor else None
        try:
            body_before(g, r)
            if r == dies:
                g.close()
                gone.wait(timeout=60)
                return
            gone.wait(timeout=60)
            if mon is not None:
                mon.start()
                deadline = time.monotonic() + 15
                while time.monotonic() < deadline and mon.suspected() != [dies]:
                    time.sleep(0.05)
                assert mon.suspected() == [dies], mon.suspected()
                g.heal(mon.suspected())
            else:
                g.heal([dies])
            results[r] = body_after(g, r)
        except Exception as e:  # pragma: no cover
            errors.append((r, e))
        finally:
            if mon is not None:
                mon.stop()
            if r != dies:
                g.close()
            client.close()

    ts = [threading.Thread(target=rank_main, args=(r,)) for r in range(world)]
    [t.start() for t in ts]
    [t.join(timeout=120) for t in ts]
    server.close()
    assert not errors, errors
    return results


def test_heal_after_rank_death(rng):
    """Kill a rank; survivors heal the ring and the collective completes."""
    def before(g, r):
        out = g.all_reduce(np.full(16, float(r + 1), np.float32))
        assert abs(out[0] - 6.0) < 1e-5

    results = _heal_run(3, "heal", 2, before,
                        lambda g, r: g.all_reduce(np.full(16, float(r + 1), np.float32))[0])
    # survivors 0 and 1: sum = 1 + 2
    assert results[0] == pytest.approx(3.0)
    assert results[1] == pytest.approx(3.0)


def test_heartbeat_drives_heal(rng):
    """Full elastic loop: monitor suspects the dead rank -> heal -> the next
    collective completes with survivors."""
    def before(g, r):
        out = g.all_reduce(np.full(8, float(r + 1), np.float32))
        assert abs(out[0] - 6.0) < 1e-5

    results = _heal_run(3, "hb_heal", 1, before,
                        lambda g, r: g.all_reduce(np.full(8, float(r + 1), np.float32))[0],
                        monitor=True)
    assert results[0] == pytest.approx(4.0)  # 1 + 3 (ranks 0 and 2)
    assert results[2] == pytest.approx(4.0)


def test_heal_then_broadcast_and_a2a(rng):
    """Mesh collectives also run over the survivor set."""
    def after(g, r):
        b = g.broadcast(np.full(8, float(r), np.float32), root=2)
        a = g.all_to_all(np.full((2, 4), float(r), np.float32))
        return b[0], [a[j][0] for j in range(2)]

    results = _heal_run(3, "heal_mesh", 0, lambda g, r: g.barrier(), after)
    for r in (1, 2):
        b, a = results[r]
        assert b == 2.0
        assert a == [1.0, 2.0]


def test_scheduled_a2a_demotes_degraded_edges(rng):
    """An edge whose channel EWMA sank below ``path_floor`` is demoted to
    the invocation tail; the degraded view is asymmetric on purpose (link
    scores are per-endpoint observations) and the exchange stays exact."""
    world = 3
    m = np.ones((world, world)) - np.eye(world)
    sched = a2a_sched.wire_schedule(m, world)
    xs = [rng.standard_normal((world, 6)).astype(np.float32)
          for _ in range(world)]

    def body(g, r):
        o1 = g.all_to_all(xs[r], schedule=sched)  # builds the mesh
        if r == 0:
            # only rank 0 sees its link to rank 1 as sick
            g._mesh[1]._link_ewma = 0.0
        o2 = g.all_to_all(xs[r] + 1.0, schedule=sched, path_floor=0.5)
        o3 = g.all_to_all(xs[r] + 2.0, schedule=sched)
        return o1, o2, o3

    s0 = obs.counter("dcn_a2a_demotions_total").get(dir="send")
    r0 = obs.counter("dcn_a2a_demotions_total").get(dir="recv")
    outs = _run_group(world, body)
    for i, (o1, o2, o3) in enumerate(outs):
        for j in range(world):
            np.testing.assert_array_equal(o1[j], xs[j][i])
            np.testing.assert_array_equal(o2[j], xs[j][i] + 1.0)
            np.testing.assert_array_equal(o3[j], xs[j][i] + 2.0)
    # rank 0 demoted exactly its send to and recv from rank 1
    assert obs.counter("dcn_a2a_demotions_total").get(dir="send") == s0 + 1
    assert obs.counter("dcn_a2a_demotions_total").get(dir="recv") == r0 + 1


def test_scheduled_a2a_without_floor_matches(rng):
    """The scheduled path (no floor) replays the contention-aware round
    interleaving and stays exact."""
    world = 4
    mat = np.abs(rng.standard_normal((world, world)))
    np.fill_diagonal(mat, 0)
    sched = a2a_sched.wire_schedule(mat, world)
    xs = [rng.standard_normal((world, 9)).astype(np.float32)
          for _ in range(world)]
    outs = _run_group(
        world, lambda g, r: g.all_to_all(xs[r], schedule=sched))
    for i, out in enumerate(outs):
        for j in range(world):
            np.testing.assert_array_equal(out[j], xs[j][i])


# -- hierarchical_all_reduce -----------------------------------------------------


def test_hierarchical_all_reduce_identical_to_jax(devices, rng):
    """Two pods of four members, the port's Communicator on the CPU and the
    JAX Communicator on four CPU devices each: the same inputs give the
    same [4, N] sums bit for bit, one "hier" plan decision per call."""
    import jax

    from uccl_tpu.collective import Communicator as JComm
    from uccl_tpu.collective.hierarchical import hierarchical_all_reduce as jhier
    from uccl_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as jmake_mesh
    from uccl_tpu_torch.collective import Communicator
    from uccl_tpu_torch.collective.hierarchical import hierarchical_all_reduce
    from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    n_pods, local, n = 2, 4, 96
    xs = [rng.standard_normal((local, n)).astype(np.float32) for _ in range(n_pods)]
    plan_total = obs.counter("collective_plan_total")
    before = plan_total.get(algo="hier", chunks=1, wire_dtype="none", outcome="explicit")

    def port_body(g, p):
        comm = Communicator(make_mesh(MeshConfig(dp=local), "cpu", local), "dp")
        return hierarchical_all_reduce(comm, g, comm.device_put(xs[p])).numpy()

    def jax_body(g, p):
        mesh = jmake_mesh(JMeshConfig(dp=local), devices[p * local:(p + 1) * local])
        comm = JComm(mesh, "dp")
        return np.asarray(jax.device_get(jhier(comm, g, comm.device_put(xs[p]))))

    got = _run_group(n_pods, port_body, tag="hier")
    want = _run_group(n_pods, jax_body, kinds=[JAXP] * n_pods, tag="hier")
    total = xs[0].astype(np.float64).sum(0) + xs[1].astype(np.float64).sum(0)
    for p in range(n_pods):
        assert got[p].shape == (local, n)
        np.testing.assert_array_equal(got[p], want[p])
        np.testing.assert_allclose(got[p], np.broadcast_to(total, (local, n)), rtol=1e-5,
                                   atol=1e-5)
    assert plan_total.get(algo="hier", chunks=1, wire_dtype="none",
                          outcome="explicit") == before + n_pods
