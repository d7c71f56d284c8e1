"""uccl_tpu_torch.ep.engram against the JAX package's: ``tests/test_engram.py``
case for case (two single-process "hosts", each owning one shard of the
table, linked over real loopback endpoints), a port table fetching rows
from a JAX table, and ``mesh_fetch`` beside the JAX sharded ``take`` on the
conftest's eight CPU devices. Exact: every fetched row is compared bit
for bit.
"""

import threading

import numpy as np
import pytest
import torch

from uccl_tpu_torch.ep.engram import EngramTable, mesh_fetch
from uccl_tpu_torch.p2p import Endpoint

from torch_one_thread import one_torch_thread  # noqa: F401


ENTRIES, HIDDEN = 64, 48


def _link(ta, tb, a, b):
    acc = {}
    t = threading.Thread(target=lambda: acc.setdefault("c", b.accept(10000)))
    t.start()
    conn_ab = a.connect("127.0.0.1", b.port)
    t.join()
    done = {}
    t2 = threading.Thread(target=lambda: done.setdefault("x", tb.link({0: acc["c"]})))
    t2.start()
    ta.link({1: conn_ab})
    t2.join()


def _shards():
    rng = np.random.default_rng(0)
    return [np.ascontiguousarray(rng.standard_normal((ENTRIES, HIDDEN)).astype(np.float32))
            for _ in range(2)]


@pytest.fixture
def linked_pair():
    """Two single-process 'hosts', each owning one shard of the table (rank
    1's given as a CPU tensor: the table registers its memory in place)."""
    shards = _shards()
    with Endpoint() as a, Endpoint() as b:
        ta = EngramTable(a, shards[0], rank=0, world=2)
        tb = EngramTable(b, torch.from_numpy(shards[1]), rank=1, world=2)
        _link(ta, tb, a, b)
        yield ta, tb, np.concatenate(shards, axis=0)


class TestEngram:
    def test_fetch_matches_global_table(self, linked_pair, rng):
        ta, tb, global_table = linked_pair
        idx = rng.integers(0, 2 * ENTRIES, 37)
        np.testing.assert_array_equal(ta.fetch(idx), global_table[idx])
        np.testing.assert_array_equal(tb.fetch(idx), global_table[idx])

    def test_async_hook_overlaps(self, linked_pair, rng):
        ta, _, global_table = linked_pair
        idx = rng.integers(ENTRIES, 2 * ENTRIES, 16)  # all remote rows
        out, wait = ta.fetch_async(idx)
        local_work = float(np.square(np.arange(1000)).sum())  # overlap slot
        got = wait()
        assert got is out and local_work > 0
        np.testing.assert_array_equal(got, global_table[idx])

    def test_local_only_fetch_never_touches_wire(self, linked_pair, rng):
        ta, _, global_table = linked_pair
        before = ta.ep.stats["bytes_tx"]
        idx = rng.integers(0, ENTRIES, 8)  # rank 0 owns all of these
        np.testing.assert_array_equal(ta.fetch(idx), global_table[idx])
        assert ta.ep.stats["bytes_tx"] == before

    def test_out_of_range_rejected(self, linked_pair):
        ta, _, _ = linked_pair
        with pytest.raises(ValueError):
            ta.fetch([2 * ENTRIES])
        with pytest.raises(ValueError):
            ta.fetch([-1])

    def test_duplicate_and_repeated_indices(self, linked_pair, rng):
        ta, _, global_table = linked_pair
        idx = np.array([5, 5, ENTRIES + 3, 5, ENTRIES + 3, 0])
        np.testing.assert_array_equal(ta.fetch(idx), global_table[idx])

    def test_cuda_table_refused(self):
        with Endpoint() as a:
            t = torch.zeros(4, 4, device="meta")
            with pytest.raises(ValueError, match="host memory"):
                EngramTable(a, t, rank=0, world=1)


def test_port_table_fetches_from_a_jax_table(rng):
    """A port EngramTable and a JAX one link and fetch each other's rows:
    the descriptors and the one-sided reads are one wire."""
    from uccl_tpu.ep.engram import EngramTable as JEngramTable
    from uccl_tpu.p2p import Endpoint as JEndpoint

    shards = _shards()
    with Endpoint() as a, JEndpoint() as b:
        ta = EngramTable(a, shards[0], rank=0, world=2)
        tb = JEngramTable(b, shards[1], rank=1, world=2)
        _link(ta, tb, a, b)
        table = np.concatenate(shards, axis=0)
        idx = rng.integers(0, 2 * ENTRIES, 29)
        np.testing.assert_array_equal(ta.fetch(idx), table[idx])
        np.testing.assert_array_equal(tb.fetch(idx), table[idx])


class TestMeshFetch:
    def test_matches_jax_sharded_take(self, mesh8, rng):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from uccl_tpu.ep.engram import mesh_fetch as jmesh_fetch

        table = rng.standard_normal((64, 16)).astype(np.float32)
        sharded = jax.device_put(
            jnp.asarray(table), NamedSharding(mesh8, P(("dp", "cp"), None))
        )
        idx = rng.integers(0, 64, 23).astype(np.int32)
        want = np.asarray(jax.jit(jmesh_fetch)(sharded, jnp.asarray(idx)))
        got = mesh_fetch(torch.from_numpy(table), idx)
        np.testing.assert_array_equal(got.numpy(), want)
        # member-stacked [W, entries, H]: global row g = member g // entries
        stacked = torch.from_numpy(table).reshape(4, 16, 16)
        np.testing.assert_array_equal(mesh_fetch(stacked, torch.from_numpy(idx)).numpy(),
                                      want)
