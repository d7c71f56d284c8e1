"""uccl_tpu_torch.serving.fleet against the JAX package's:
``tests/test_fleet.py`` case for case on the port's classes (directory
units over a dict-backed store, publisher units, the fleet plane over real
loopback store/endpoints/channels with stub KV backends, cache-aware
routing with directory credit, per-tenant series, and the 3x2
prefill/decode plane surviving a prefill-engine kill), then the
cross-package and model cases:

* a port worker and a JAX worker on one store: each fetches the other's
  published prefix (one directory layout, one blob wire);
* two port FleetWorkers on dense engines at a tiny width: a request on
  worker B, submitted after its donor finished on worker A, takes A's
  prefix from the directory, and its tokens equal its cold
  ``replay_alone`` and the JAX one-shot ``generate``.

Exact throughout: imported rows are compared bit for bit, tokens exactly.
The waits are bounded polls on a condition.
"""

import time
import types

import numpy as np
import pytest
import torch

from uccl_tpu_torch import obs
from uccl_tpu_torch.p2p import Endpoint
from uccl_tpu_torch.p2p.store import StoreClient, StoreServer
from uccl_tpu_torch.serving import (
    FailureDetector, PrefixCache, RequestState, Router, ServingEngine,
    TierRef,
)
from uccl_tpu_torch.serving.fleet import (
    FleetCachePublisher, FleetDirectory, FleetKvServer, FleetWorker,
    _ChunkShim,
)
from uccl_tpu_torch.serving.metrics import ServingMetrics

from torch_one_thread import one_torch_thread  # noqa: F401


CHUNK = 4


class _DictStore:
    """The two store verbs the directory uses, over a plain dict."""

    def __init__(self):
        self.d = {}

    def set(self, key, value):
        self.d[key] = bytes(value)

    def get(self, key):
        return self.d.get(key)


def _keys(prompt, n_chunks, ns=""):
    """The trie's namespaced chunk-key path for ``prompt`` — built by the
    SAME generator the cache and directory share (zero drift)."""
    return list(PrefixCache._chunks(
        _ChunkShim(CHUNK), np.asarray(prompt, np.int32), n_chunks, ns))


def _expected_rows(n, layers=2, heads=2, dim=4):
    pos = np.arange(n, dtype=np.float32)
    k = np.broadcast_to((pos + 1.0)[None, :, None, None],
                        (layers, n, heads, dim)).copy()
    return k, -k


class _FleetStubBackend:
    """Chunk-aware stub with a REAL host KV pool: prefill writes
    deterministic rows (k=pos+1, v=-(pos+1)) so a cross-worker import is
    checkable byte-for-byte, and export/import/copy follow the engine
    backends' surface."""

    def __init__(self, n_slots=2, max_seq=64, layers=2, heads=2, dim=4):
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.k = np.zeros((layers, n_slots, max_seq, heads, dim),
                          np.float32)
        self.v = np.zeros_like(self.k)
        self.n_decodes = 0
        self.calls = []
        self.imports = []

    def _write(self, slot, lo, hi):
        pos = np.arange(lo, hi, dtype=np.float32)
        self.k[:, slot, lo:hi] = (pos + 1.0)[None, :, None, None]
        self.v[:, slot, lo:hi] = -(pos + 1.0)[None, :, None, None]

    def prefill(self, tokens, lens, mask, start=None):
        slots = tuple(int(s) for s in np.flatnonzero(mask))
        starts = tuple(int(start[s]) for s in slots) if start is not None \
            else (0,) * len(slots)
        self.calls.append(("prefill", slots, starts))
        for s, lo in zip(slots, starts):
            self._write(s, lo, min(lo + tokens.shape[1], int(lens[s])))
        return np.full(self.n_slots, 100, np.int32)

    def decode(self, tokens, active):
        self.n_decodes += 1
        return np.full(self.n_slots, self.n_decodes, np.int32)

    def copy_slot_prefix(self, dst, src, n):
        self.calls.append(("copy", dst, src, n))
        self.k[:, dst, :n] = self.k[:, src, :n]
        self.v[:, dst, :n] = self.v[:, src, :n]

    def export_slot_kv(self, slot, lo, hi):
        return (self.k[:, slot, lo:hi].copy(),
                self.v[:, slot, lo:hi].copy())

    def import_slot_kv(self, slot, k_rows, v_rows, *, length):
        self.imports.append((slot, int(length)))
        self.k[:, slot, :length] = k_rows
        self.v[:, slot, :length] = v_rows


class TestDirectory:
    def test_publish_every_depth_deepest_lookup_wins(self):
        d = FleetDirectory(_DictStore(), "A", CHUNK)
        p = np.arange(12, dtype=np.int32)
        dks = d.publish(_keys(p, 3), 7, True, 1536)
        assert len(dks) == 3
        assert obs.gauge("fleet_dir_resident_entries").get() == 3
        # the requester's OWN usable depth clamps the match: a 12-token
        # prompt can resume from 8, a 13-token one from 12
        hit = d.lookup(p)
        assert (hit["owner"], hit["key"], hit["tokens"]) == ("A", 7, 8)
        assert d.lookup(np.concatenate([p, [99]]))["tokens"] == 12
        assert d.lookup(p[:9])["tokens"] == 8
        assert d.lookup(p[:5])["tokens"] == 4
        assert d.lookup(p[:4]) is None  # usable depth 0
        assert d.lookup(np.arange(50, 62, dtype=np.int32)) is None

    def test_namespace_isolation_by_construction(self):
        d = FleetDirectory(_DictStore(), "A", CHUNK)
        p = np.arange(12, dtype=np.int32)
        d.publish(_keys(p, 3, ns="acme|style@1"), 0, True, 100)
        assert d.lookup(p, "") is None
        assert d.lookup(p, "other") is None
        assert d.lookup(p, "acme|style@1")["tokens"] == 8

    def test_tombstone_falls_back_to_shallower_depth(self):
        d = FleetDirectory(_DictStore(), "A", CHUNK)
        p = np.arange(16, dtype=np.int32)
        d.publish(_keys(p, 3), 0, True, 100)
        i0 = obs.counter("fleet_dir_invalidations_total").get()
        d.tombstone(d.lookup(p)["dir_key"])  # kills the depth-3 entry
        assert obs.counter("fleet_dir_invalidations_total").get() == i0 + 1
        assert d.lookup(p)["tokens"] == 8  # depth-2 survives

    def test_withdraw_only_kills_matching_blob_key(self):
        d = FleetDirectory(_DictStore(), "A", CHUNK)
        p = np.arange(12, dtype=np.int32)
        dks = d.publish(_keys(p, 3), 0, True, 100)
        d.publish(_keys(p, 3), 1, True, 100)  # re-published, newer blob
        d.withdraw(dks, 0)  # stale withdraw: keys now point at blob 1
        assert d.lookup(p)["key"] == 1
        d.withdraw(dks, 1)
        assert d.lookup(p) is None
        assert obs.gauge("fleet_dir_resident_entries").get() == 0

    def test_invalidate_owner_sweeps_only_the_dead(self):
        store = _DictStore()
        da = FleetDirectory(store, "A", CHUNK)
        db = FleetDirectory(store, "B", CHUNK)
        pa = np.arange(12, dtype=np.int32)
        pb = np.arange(20, 32, dtype=np.int32)
        da.publish(_keys(pa, 3), 0, True, 100)
        db.publish(_keys(pb, 3), 0, True, 100)
        assert db.invalidate_owner("A") == 3
        assert db.lookup(pa) is None
        assert db.lookup(pb)["owner"] == "B"
        assert db.invalidate_owner("A") == 0  # idempotent
        assert db.invalidate_owner("never-existed") == 0

    def test_malformed_store_bytes_never_raise(self):
        store = _DictStore()
        d = FleetDirectory(store, "A", CHUNK)
        p = np.arange(12, dtype=np.int32)
        dks = d.publish(_keys(p, 3), 0, True, 100)
        store.set(dks[-1], b"not json")  # corrupt the depth-3 entry
        # a 13-token prompt probes depth 3 first: the corrupt entry is
        # skipped, the depth-2 one answers
        assert d.lookup(np.concatenate([p, [99]]))["tokens"] == 8
        store.set("fdir_idx/A", b"garbage")
        assert d.invalidate_owner("A") == 0


class TestPublisher:
    def _pub(self, capacity, n_slots=2):
        backend = _FleetStubBackend(n_slots=n_slots)
        for s in range(n_slots):
            backend._write(s, 0, 8)
        d = FleetDirectory(_DictStore(), "W", CHUNK)
        srv = FleetKvServer(capacity_bytes=capacity, ep=None)
        return FleetCachePublisher(d, srv, backend), d

    def test_capacity_eviction_depublishes(self):
        # one 8-token blob is 1024B here; 1600B holds exactly one
        pub, d = self._pub(1600)
        p1 = np.arange(8, dtype=np.int32)
        p2 = np.arange(40, 48, dtype=np.int32)
        pub.on_insert(0, _keys(p1, 2))
        assert d.lookup(np.concatenate([p1, [9]]))["tokens"] == 8
        pub.on_insert(1, _keys(p2, 2))
        # blob 0 was LRU-evicted for blob 1: its directory entries die too
        assert d.lookup(np.concatenate([p1, [9]])) is None
        assert d.lookup(np.concatenate([p2, [9]]))["tokens"] == 8
        assert obs.gauge("fleet_dir_resident_entries").get() == 2

    def test_oversize_and_t2_residents_not_advertised(self):
        pub, d = self._pub(512)  # smaller than one entry
        p1 = np.arange(8, dtype=np.int32)
        pub.on_insert(0, _keys(p1, 2))
        assert d.lookup(np.concatenate([p1, [9]])) is None
        # a T2 ref's bytes live on a remote tier peer: never advertised
        pub2, d2 = self._pub(1 << 20)
        ref = TierRef("t2", 5, 8, True, 1024)
        pub2.on_insert(ref, _keys(p1, 2))
        assert d2.lookup(np.concatenate([p1, [9]])) is None

    def test_remove_withdraws_and_drops_blob(self):
        pub, d = self._pub(1 << 20)
        p1 = np.arange(8, dtype=np.int32)
        pub.on_insert(0, _keys(p1, 2))
        pub.on_remove(0)
        assert d.lookup(np.concatenate([p1, [9]])) is None
        assert pub.server._get(0) is None
        pub.on_remove(0)  # idempotent

    def test_publish_failure_is_counted_not_raised(self):
        pub, d = self._pub(1 << 20)
        pub.backend = object()  # no export surface
        e0 = obs.counter("fleet_cache_errors_total").get(reason="publish")
        pub.on_insert(0, _keys(np.arange(8, dtype=np.int32), 2))
        assert obs.counter("fleet_cache_errors_total").get(
            reason="publish") == e0 + 1


@pytest.fixture
def fleet():
    """Factory for (engine, FleetWorker) pairs sharing one real store
    server, talking over real loopback endpoints/channels."""
    srv = StoreServer()
    made = []

    def make(name, n_slots=2, **kw):
        sc = StoreClient("127.0.0.1", srv.port)
        eng = ServingEngine(_FleetStubBackend(n_slots=n_slots),
                            prefill_chunk=CHUNK,
                            prefix_cache=PrefixCache(CHUNK))
        kw.setdefault("capacity_bytes", 1 << 20)
        kw.setdefault("max_entry_bytes", 1 << 20)
        kw.setdefault("fail_limit", 1)
        kw.setdefault("timeout_ms", 5000)
        fw = FleetWorker(name, sc, Endpoint(), chunk=CHUNK, **kw)
        eng.attach_fleet(fw)
        made.append((eng, fw, sc))
        return eng, fw

    yield make
    for eng, fw, sc in made:
        fw.close()
        try:
            fw.ep.close()
        except Exception:
            pass
        sc.close()
    srv.close()


class TestFleetPlane:
    def test_cross_worker_hit_counted_and_self_propagates(self, fleet):
        eng_a, fw_a = fleet("A")
        eng_b, fw_b = fleet("B")
        p = (np.arange(12) % 64).astype(np.int32)
        eng_a.submit(p, max_new_tokens=2)
        eng_a.drain()
        assert eng_a.pool.n_parked == 1
        assert obs.gauge("fleet_dir_resident_entries").get() == 3
        h0 = obs.counter("fleet_cache_hits_total").get()
        t0 = obs.counter("fleet_cache_tokens_imported_total").get()
        b0 = obs.counter("p2p_bytes_total").get(verb="kv_tier")
        r = eng_b.submit(p.copy(), max_new_tokens=2)
        eng_b.drain()
        assert r.state is RequestState.FINISHED
        assert r.cache_hit_len == 8 and r.cache_hit_exact
        # the hit counter moved AND real bytes rode the T2 wire path (not
        # a local alias)
        assert obs.counter("fleet_cache_hits_total").get() == h0 + 1
        assert obs.counter("fleet_cache_tokens_imported_total").get() \
            == t0 + 8
        assert obs.counter("p2p_bytes_total").get(verb="kv_tier") > b0
        # the import landed in B's OWN slot and prefill resumed past it
        assert eng_b.backend.imports == [(r.slot, 8)]
        starts = [c[2][c[1].index(r.slot)] for c in eng_b.backend.calls
                  if c[0] == "prefill" and r.slot in c[1]]
        assert starts and min(starts) == 8
        ek, ev = _expected_rows(12)
        np.testing.assert_array_equal(eng_b.backend.k[:, r.slot, :12], ek)
        np.testing.assert_array_equal(eng_b.backend.v[:, r.slot, :12], ev)
        assert eng_b.pool.leaked() == 0
        # self-propagation: the fetched prefix parked locally on retire,
        # so B's next identical prompt is a plain T0 hit — no new fetch
        r2 = eng_b.submit(p.copy(), max_new_tokens=2)
        eng_b.drain()
        assert r2.cache_hit_len == 8
        assert obs.counter("fleet_cache_hits_total").get() == h0 + 1
        assert any(c[0] == "copy" for c in eng_b.backend.calls)

    def test_namespace_isolation_across_workers(self, fleet):
        eng_a, _ = fleet("A", n_slots=3)
        eng_b, _ = fleet("B", n_slots=3)
        p = (np.arange(30, 42) % 64).astype(np.int32)
        eng_a.submit(p, max_new_tokens=2, tenant="acme")
        eng_a.drain()
        h0 = obs.counter("fleet_cache_hits_total").get()
        r = eng_b.submit(p.copy(), max_new_tokens=2)  # default tenant
        eng_b.drain()
        assert r.cache_hit_len == 0
        assert obs.counter("fleet_cache_hits_total").get() == h0
        r2 = eng_b.submit(p.copy(), max_new_tokens=2, tenant="acme")
        eng_b.drain()
        assert r2.cache_hit_len == 8
        assert obs.counter("fleet_cache_hits_total").get() == h0 + 1

    def test_stale_owner_is_a_counted_cold_miss(self, fleet):
        """Owner drops the blob between the directory read and the fetch:
        the request degrades to the cold miss admission already counted —
        never wrong bytes — and the entry is tombstoned."""
        eng_a, fw_a = fleet("A")
        eng_b, _ = fleet("B")
        p = (np.arange(7, 19) % 64).astype(np.int32)
        eng_a.submit(p, max_new_tokens=2)
        eng_a.drain()
        fw_a.server.drop_local(0)  # blob gone, directory entries live
        s0 = obs.counter("fleet_cache_stale_total").get()
        h0 = obs.counter("fleet_cache_hits_total").get()
        r = eng_b.submit(p.copy(), max_new_tokens=2)
        eng_b.drain()
        assert r.state is RequestState.FINISHED
        assert r.cache_hit_len == 0
        assert obs.counter("fleet_cache_stale_total").get() == s0 + 1
        assert obs.counter("fleet_cache_hits_total").get() == h0
        # B prefilled cold and bit-correct rows landed anyway
        ek, _ = _expected_rows(12)
        np.testing.assert_array_equal(eng_b.backend.k[:, r.slot, :12], ek)
        assert eng_b.pool.leaked() == 0

    def test_eviction_withdraws_directory_entries(self, fleet):
        eng_a, fw_a = fleet("A")
        eng_b, _ = fleet("B")
        p = (np.arange(11, 23) % 64).astype(np.int32)
        eng_a.submit(p, max_new_tokens=2)
        eng_a.drain()
        assert eng_a.prefix_cache.evict_lru(eng_a.pool) is not None
        assert fw_a.directory.lookup(p, "") is None
        h0 = obs.counter("fleet_cache_hits_total").get()
        r = eng_b.submit(p.copy(), max_new_tokens=2)
        eng_b.drain()
        assert r.cache_hit_len == 0
        assert obs.counter("fleet_cache_hits_total").get() == h0

    def test_dead_peer_latches_and_sweeps_directory(self, fleet):
        eng_a, _ = fleet("A", n_slots=3)
        eng_b, fw_b = fleet("B", n_slots=3)
        p1 = (np.arange(3, 15) % 64).astype(np.int32)
        p2 = (np.arange(41, 53) % 64).astype(np.int32)
        eng_a.submit(p1, max_new_tokens=2)
        eng_a.drain()
        r1 = eng_b.submit(p1.copy(), max_new_tokens=2)  # dials A: a hit
        eng_b.drain()
        assert r1.cache_hit_len == 8
        eng_a.submit(p2, max_new_tokens=2)
        eng_a.drain()

        class _Dead:
            def get(self, key):
                raise IOError("peer gone")

            def close(self):
                pass

        fw_b.client._remotes["A"] = _Dead()  # the peer dies mid-channel
        e0 = obs.counter("fleet_cache_errors_total").get(reason="fetch")
        i0 = obs.counter("fleet_dir_invalidations_total").get()
        r2 = eng_b.submit(p2.copy(), max_new_tokens=2)
        eng_b.drain()
        # the fetch failure is NOT an engine fault: cold, complete, exact
        assert r2.state is RequestState.FINISHED
        assert r2.cache_hit_len == 0
        assert obs.counter("fleet_cache_errors_total").get(
            reason="fetch") == e0 + 1
        # fail_limit=1: the peer latched dead and its index was swept
        # (p2's 3 depths — p1's entries were re-owned by B's own park)
        assert fw_b.client._remotes["A"] is None
        assert obs.counter("fleet_dir_invalidations_total").get() == i0 + 3
        hit = fw_b.directory.lookup(p2, "")
        assert hit is not None and hit["owner"] == "B"  # B's re-publish
        assert eng_b.pool.leaked() == 0

    def test_publish_failure_never_blocks_admission(self, fleet):
        eng_a, fw_a = fleet("A")
        fw_a.publisher.backend = object()  # breaks export at park time
        e0 = obs.counter("fleet_cache_errors_total").get(reason="publish")
        r = eng_a.submit((np.arange(12) % 64).astype(np.int32),
                         max_new_tokens=2)
        eng_a.drain()
        assert r.state is RequestState.FINISHED
        assert eng_a.pool.n_parked == 1  # the local trie still parked
        assert obs.counter("fleet_cache_errors_total").get(
            reason="publish") == e0 + 1


class _ChunkStub:
    """Chunk-aware stub (tests/test_router.py shape)."""

    def __init__(self, n_slots=2, max_seq=64):
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.n_decodes = 0

    def prefill(self, tokens, lens, mask, start=None):
        return np.full(self.n_slots, 100, np.int32)

    def decode(self, tokens, active):
        self.n_decodes += 1
        return np.full(self.n_slots, self.n_decodes, np.int32)

    def copy_slot_prefix(self, dst, src, n):
        pass

    def export_slot_kv(self, slot, lo, hi):
        z = np.zeros((1, hi - lo, 1, 2), np.float32)
        return z, z

    def import_slot_kv(self, slot, k_rows, v_rows, *, length):
        pass


class _StubKV(_ChunkStub):
    """_ChunkStub plus the model dims the disagg wire format needs."""

    class _Cfg:
        n_layers = 1
        n_kv_heads = 1
        head_dim = 2

    cfg = _Cfg()

    def __init__(self, n_slots=2, max_seq=32):
        super().__init__(n_slots=n_slots, max_seq=max_seq)


class TestCacheAwareSteering:
    def _engines(self, n=2):
        return [ServingEngine(_ChunkStub(), prefill_chunk=CHUNK,
                              prefix_cache=PrefixCache(CHUNK))
                for _ in range(n)]

    def test_steers_to_the_trie_owner(self):
        engs = self._engines()
        p = np.arange(12, dtype=np.int32)
        engs[1].submit(p, max_new_tokens=2)  # warm replica 1's trie
        engs[1].drain()
        r = Router(engs)
        c0 = obs.counter("serving_router_cache_steered_total").get()
        req = r.submit(p.copy(), max_new_tokens=2)
        assert req is not None
        # equal load + index rotation favor replica 0; the 8 cached
        # tokens outvote both — the steering signal changed placement
        assert r.routed == [0, 1]
        assert obs.counter(
            "serving_router_cache_steered_total").get() == c0 + 1
        r.drain()
        assert req.cache_hit_len == 8

    def test_directory_credit_steers_to_fleet_owner(self):
        """A replica with a COLD trie still wins when the fleet directory
        says it owns the prefix (its fetch is a loopback to itself never
        taken — the router credit models the local hit it will get)."""
        engs = [ServingEngine(_ChunkStub()) for _ in range(2)]
        engs[0].fleet = types.SimpleNamespace(worker="w0")
        engs[1].fleet = types.SimpleNamespace(worker="w1")
        store = _DictStore()
        d = FleetDirectory(store, "w1", CHUNK)
        p = np.arange(12, dtype=np.int32)
        d.publish(_keys(p, 3), 0, True, 100)
        r = Router(engs, directory=d)
        c0 = obs.counter("serving_router_cache_steered_total").get()
        req = r.submit(p.copy(), max_new_tokens=2)
        assert req is not None
        assert r.routed == [0, 1]
        assert obs.counter(
            "serving_router_cache_steered_total").get() == c0 + 1
        r.drain()

    def test_no_prefix_no_steering_counter(self):
        engs = self._engines()
        c0 = obs.counter("serving_router_cache_steered_total").get()
        r = Router(engs)
        r.submit(np.arange(60, 68, dtype=np.int32), max_new_tokens=2)
        r.drain()
        assert obs.counter(
            "serving_router_cache_steered_total").get() == c0


class TestPerTenantFleetSeries:
    def test_merged_keeps_per_tenant_and_per_class(self):
        """Sub-snapshots survive a fleet merge: one replica per tenant is
        exactly the fleet case that would collapse to a single unlabeled
        series."""
        e1 = ServingEngine(_ChunkStub())
        e2 = ServingEngine(_ChunkStub())
        e1.submit(np.arange(6, dtype=np.int32), max_new_tokens=2,
                  tenant="a", priority="interactive")
        e2.submit(np.arange(6, dtype=np.int32), max_new_tokens=2,
                  tenant="b", priority="batch")
        e1.drain()
        e2.drain()
        snap = ServingMetrics.merged([e1.metrics, e2.metrics]).snapshot()
        assert set(snap["per_tenant"]) == {"a", "b"}
        assert set(snap["per_class"]) == {"interactive", "batch"}
        assert sum(v["completed"] for v in snap["per_tenant"].values()) \
            == 2

    def test_router_submit_threads_tenant(self):
        r = Router([ServingEngine(_ChunkStub()),
                    ServingEngine(_ChunkStub())])
        assert r.submit(np.arange(6, dtype=np.int32), max_new_tokens=2,
                        tenant="a") is not None
        assert r.submit(np.arange(6, dtype=np.int32), max_new_tokens=2,
                        tenant="b") is not None
        r.drain()
        snap = r.snapshot()
        assert set(snap["per_tenant"]) == {"a", "b"}

    def test_begin_carries_tenant_to_adoption(self):
        from uccl_tpu_torch.serving.disagg import make_local_pair

        pe = ServingEngine(_StubKV(), prefill_chunk=CHUNK)
        de = ServingEngine(_StubKV())
        pw, dw = make_local_pair(pe, de)
        try:
            pw.submit(np.arange(6, dtype=np.int32), max_new_tokens=2,
                      tenant="acme")
            pw.submit(np.arange(8, dtype=np.int32), max_new_tokens=2)
            done = []
            deadline = time.monotonic() + 30
            while len(done) < 2:
                pw.step()
                done.extend(dw.step())
                assert time.monotonic() < deadline
            assert sorted(r.tenant for r in done) == ["acme", "default"]
            snap = de.snapshot()
            assert set(snap["per_tenant"]) == {"acme", "default"}
        finally:
            pw.ep.close()
            dw.ep.close()


class TestFanIn3x2:
    def test_kill_one_prefill_engine_conserves(self):
        """The ≥3×2 plane survives a mid-stream prefill kill: the victim's
        GRANT lease expires (reason=peer_dead) on its decode worker, every
        live bond's request completes, and no pool leaks a slot."""
        from uccl_tpu_torch.serving.disagg import DecodeWorker, add_local_prefill
        from uccl_tpu_torch.serving.disagg import _ChunkFanout

        pes = [ServingEngine(_StubKV(n_slots=2), prefill_chunk=CHUNK)
               for _ in range(3)]
        des = [ServingEngine(_StubKV(n_slots=4)) for _ in range(2)]
        dws = [DecodeWorker(de, Endpoint(), grant_lease_s=60.0,
                            detector=FailureDetector(suspect_after_s=0.05,
                                                     dead_after_s=0.12))
               for de in des]
        pws = {}
        try:
            for i, pe in enumerate(pes):
                for j, dw in enumerate(dws):
                    pws[(i, j)] = add_local_prefill(
                        dw, pe, transport="ep", heartbeat_s=0.02)
            # 6 bonds through 3 shared fan-out sinks: the N×M plane
            for pe in pes:
                assert isinstance(pe.chunk_sink, _ChunkFanout)
                assert len(pe.chunk_sink.sinks) == 2

            # the doomed request: BEGIN through bond (2, 0), wait for its
            # GRANT to reserve a decode slot, then kill the engine
            victim = pws[(2, 0)].submit(np.arange(6, dtype=np.int32),
                                        max_new_tokens=2)
            assert victim is not None
            deadline = time.monotonic() + 10
            while not dws[0]._granted:
                pws[(2, 0)].pump()
                dws[0].poll()
                assert time.monotonic() < deadline
            assert des[0].pool.n_free == des[0].pool.n_slots - 1
            c0 = obs.counter("disagg_leases_expired_total").get(
                reason="peer_dead")
            pes[2].kill()  # heartbeats stop; the slabs never ship

            done = []
            live = [(i, j) for (i, j) in pws if i != 2]
            for n, (i, j) in enumerate(live):
                assert pws[(i, j)].submit(
                    np.arange(4 + n, dtype=np.int32),
                    max_new_tokens=2) is not None
            deadline = time.monotonic() + 30
            while len(done) < 4:
                for key in live:
                    pws[key].step()
                for dw in dws:
                    done.extend(dw.step())
                assert time.monotonic() < deadline
            assert all(r.adopted and r.n_generated == 2 for r in done)
            # the victim's lease expires the moment its conn ages DEAD
            deadline = time.monotonic() + 10
            while any(dw._granted for dw in dws):
                for key in live:
                    pws[key].pump()
                for dw in dws:
                    dw.poll()
                time.sleep(0.005)
                assert time.monotonic() < deadline
            assert obs.counter("disagg_leases_expired_total").get(
                reason="peer_dead") == c0 + 1
            # conservation: every decode slot came back, nothing leaked
            for de in des:
                assert de.pool.n_free == de.pool.n_slots
                assert de.pool.leaked() == 0
            for pe in pes[:2]:
                assert pe.pool.leaked() == 0
        finally:
            for pw in pws.values():
                pw.ep.close()
            for dw in dws:
                dw.ep.close()


# -- the wire between the packages, and the model -------------------------------


def test_port_and_jax_workers_share_one_directory():
    """A port FleetWorker and a JAX one on one store server: a prefix
    parked on either side is fetched by the other, rows bit for bit."""
    from uccl_tpu.p2p import Endpoint as JEndpoint
    from uccl_tpu.p2p.store import StoreClient as JStoreClient
    from uccl_tpu.serving import PrefixCache as JPrefixCache
    from uccl_tpu.serving import ServingEngine as JServingEngine
    from uccl_tpu.serving.fleet import FleetWorker as JFleetWorker

    srv = StoreServer()
    sc, jsc = StoreClient("127.0.0.1", srv.port), JStoreClient("127.0.0.1", srv.port)
    eng = ServingEngine(_FleetStubBackend(), prefill_chunk=CHUNK,
                        prefix_cache=PrefixCache(CHUNK))
    jeng = JServingEngine(_FleetStubBackend(), prefill_chunk=CHUNK,
                          prefix_cache=JPrefixCache(CHUNK))
    kw = dict(chunk=CHUNK, capacity_bytes=1 << 20, max_entry_bytes=1 << 20,
              fail_limit=1, timeout_ms=5000)
    fw = FleetWorker("port", sc, Endpoint(), **kw)
    jfw = JFleetWorker("jax", jsc, JEndpoint(), **kw)
    eng.attach_fleet(fw)
    jeng.attach_fleet(jfw)
    try:
        pa = (np.arange(12) % 64).astype(np.int32)
        pb = (np.arange(20, 32) % 64).astype(np.int32)
        jeng.submit(pa, max_new_tokens=2)
        jeng.drain()
        eng.submit(pb, max_new_tokens=2)
        eng.drain()
        r = eng.submit(pa.copy(), max_new_tokens=2)  # JAX-owned prefix
        eng.drain()
        jr = jeng.submit(pb.copy(), max_new_tokens=2)  # port-owned prefix
        jeng.drain()
        assert r.cache_hit_len == 8 and jr.cache_hit_len == 8
        ek, ev = _expected_rows(12)
        for e, q in ((eng, r), (jeng, jr)):
            assert e.backend.imports == [(q.slot, 8)]
            np.testing.assert_array_equal(e.backend.k[:, q.slot, :12], ek)
            np.testing.assert_array_equal(e.backend.v[:, q.slot, :12], ev)
    finally:
        for w in (fw, jfw):
            w.close()
            w.ep.close()
        sc.close()
        jsc.close()
        srv.close()


def test_model_prefix_from_a_peer_worker_is_exact():
    """Two port FleetWorkers on dense engines: worker B's request, submitted
    after its donor finished on worker A, resumes past A's imported rows
    and equals its cold replay and the JAX generate."""
    import jax
    import jax.numpy as jnp

    from uccl_tpu.models import dense as jdense
    from uccl_tpu.models import inference as jinf
    from uccl_tpu_torch.models import dense as tdense
    from uccl_tpu_torch.serving.engine import DenseBackend, replay_alone

    sizes = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8, ffn=64)
    jcfg = jdense.DenseConfig(**sizes)
    jp = jdense.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = tdense.DenseConfig(**sizes)
    params = tdense.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    srv = StoreServer()
    made = []
    try:
        engs = []
        for name in ("A", "B"):
            sc = StoreClient("127.0.0.1", srv.port)
            eng = ServingEngine(DenseBackend(params, cfg, n_slots=2, max_seq=32),
                                prefill_chunk=CHUNK, prefix_cache=PrefixCache(CHUNK))
            fw = FleetWorker(name, sc, Endpoint(), chunk=CHUNK, capacity_bytes=1 << 22,
                             max_entry_bytes=1 << 22, timeout_ms=10000)
            eng.attach_fleet(fw)
            made.append((fw, sc))
            engs.append(eng)
        rng = np.random.default_rng(4)
        shared = rng.integers(0, 64, 12).astype(np.int32)
        donor = engs[0].submit(np.concatenate([shared, [1, 2]]).astype(np.int32),
                               max_new_tokens=3)
        engs[0].drain()
        h0 = obs.counter("fleet_cache_hits_total").get()
        r = engs[1].submit(np.concatenate([shared, [7, 9, 11]]).astype(np.int32),
                           max_new_tokens=4)
        engs[1].drain()
        assert obs.counter("fleet_cache_hits_total").get() == h0 + 1
        assert r.cache_hit_len == 12 and r.cache_hit_exact
        for e, q in ((engs[0], donor), (engs[1], r)):
            want = np.asarray(jinf.generate(jp, jnp.asarray(q.prompt)[None], jcfg,
                                            max_new_tokens=q.max_new_tokens, max_seq=32))[0]
            assert q.out_tokens == want.tolist()
            assert replay_alone(e.backend, q).tolist() == q.out_tokens
            assert e.pool.leaked() == 0
    finally:
        for fw, sc in made:
            fw.close()
            fw.ep.close()
            sc.close()
        srv.close()
