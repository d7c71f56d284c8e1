"""The local KV tiers in the port (``serving/kv_tiers.py``: the at-rest
codec, ``HostKVTier`` and ``TieredKVCache``) against the JAX package's.

The codec round trip is bit-exact at ``wire_dtype=None``; ``fp8`` and
``int8`` hold every element to the codec's ``amax / ROUND_TRIP_DIVISOR``
bound per block. The tier-manager cases run on a host stub: each runs on
the JAX classes and on the port's, and both meet the JAX test's exact
assertions. The engine cases run the JAX engine and the port's on the same
weights and requests: tokens, hit lengths, exactness stamps and the
``kv_tier_*`` / ``prefix_cache_*`` counter deltas must be identical, and
every request must equal its cold ``replay_alone``. The remote tier (T2):
the tier manager's spill / stale-ref / failure-latch cases on a fake peer
in both packages, ``KvTierServer`` / ``RemoteKVTier`` over loopback as
tests/test_kv_tiers.py::TestRemoteTier holds the JAX pair (30 s caps), each
package's client against the other's server, and the engine's cycles with a
real remote peer behind a one-entry host tier, identical to the JAX
engine's.
"""

import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from uccl_tpu import obs as jobs
from uccl_tpu.models import dense as jdense
from uccl_tpu.serving import engine as jengine
from uccl_tpu.serving import kv_tiers as jkv
from uccl_tpu.serving import prefix_cache as jpc
from uccl_tpu.serving import slots as jslots
from uccl_tpu.p2p import Channel as JChannel
from uccl_tpu.p2p import Endpoint as JEndpoint
from uccl_tpu_torch import obs as tobs
from uccl_tpu_torch.p2p import Channel as TChannel
from uccl_tpu_torch.p2p import Endpoint as TEndpoint
from uccl_tpu_torch.models import dense as tdense
from uccl_tpu_torch.ops import quant as tquant
from uccl_tpu_torch.serving import engine as tengine
from uccl_tpu_torch.serving import kv_tiers as tkv
from uccl_tpu_torch.serving import prefix_cache as tpc
from uccl_tpu_torch.serving import slots as tslots

from torch_one_thread import one_torch_thread  # noqa: F401


PKGS = {
    "jax": SimpleNamespace(engine=jengine, kv=jkv, pc=jpc, slots=jslots, obs=jobs,
                           Endpoint=JEndpoint, Channel=JChannel),
    "torch": SimpleNamespace(engine=tengine, kv=tkv, pc=tpc, slots=tslots, obs=tobs,
                             Endpoint=TEndpoint, Channel=TChannel),
}
DENSE = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8, ffn=64)
MAX_SEQ = 32


@pytest.fixture(params=sorted(PKGS))
def P(request):
    return PKGS[request.param]


def _rows(rng, n_tokens, layers=2, heads=2, dim=8):
    shape = (layers, n_tokens, heads, dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


# -- the codec -------------------------------------------------------------------


def test_raw_round_trip_bit_exact_and_laid_out_as_jax_lays_it():
    k, v = _rows(np.random.default_rng(0), 8)
    blob, meta = tkv.encode_entry(k, v)
    jblob, jmeta = jkv.encode_entry(k, v)
    assert meta == jmeta and np.array_equal(blob, jblob) and blob.nbytes == 2 * k.nbytes
    k2, v2 = tkv.decode_entry(jblob, jmeta)
    assert np.array_equal(k, k2) and np.array_equal(v, v2)


@pytest.mark.parametrize("wd", ["fp8", "int8"])
@pytest.mark.parametrize("block", [4, 32])
def test_quantized_round_trip_within_the_codec_bound(wd, block):
    k, v = _rows(np.random.default_rng(1), 8, dim=32)
    blob, meta = tkv.encode_entry(k, v, wire_dtype=wd, block=block)
    assert meta == jkv.encode_entry(k, v, wire_dtype=wd, block=block)[1]
    k2, v2 = tkv.decode_entry(blob, meta)
    g = meta["block"]
    for a, b in ((k, k2), (v, v2)):
        amax = np.abs(a.reshape(-1, g)).max(axis=1, keepdims=True)
        err = np.abs(a - b).reshape(-1, g)
        assert (err <= amax / tquant.ROUND_TRIP_DIVISOR[wd]).all()
    assert blob.nbytes <= 2 * k.nbytes / 2


def test_malformed_inputs_rejected():
    k, v = _rows(np.random.default_rng(2), 4)
    with pytest.raises(ValueError, match="shapes differ"):
        tkv.encode_entry(k, v[:, :3])
    blob, meta = tkv.encode_entry(k, v)
    with pytest.raises(ValueError, match="blob"):
        tkv.decode_entry(blob[:-4], meta)


# -- the tier manager on a stub ----------------------------------------------------


class _TierStub:
    """Host-array KV pool with the backends' export/import surface; rows
    are seeded per (slot, position) so imports are checkable."""

    def __init__(self, n_slots=2, layers=2, heads=2, dim=8):
        self.n_slots = n_slots
        self.k = np.zeros((layers, n_slots, MAX_SEQ, heads, dim), np.float32)
        self.v = np.zeros_like(self.k)

    def fill(self, slot, n, seed):
        rng = np.random.default_rng(seed)
        self.k[:, slot, :n] = rng.standard_normal(self.k[:, slot, :n].shape)
        self.v[:, slot, :n] = rng.standard_normal(self.v[:, slot, :n].shape)
        return self.k[:, slot, :n].copy(), self.v[:, slot, :n].copy()

    def export_slot_kv(self, slot, lo, hi):
        return self.k[:, slot, lo:hi].copy(), self.v[:, slot, lo:hi].copy()

    def import_slot_kv(self, slot, k_rows, v_rows, *, length):
        self.k[:, slot, :length] = k_rows
        self.v[:, slot, :length] = v_rows


def _entry_bytes(n_tokens):
    return 2 * 2 * n_tokens * 2 * 8 * 4


class _FakeRemote:
    """In-process stand-in for ``RemoteKVTier``: the surface the tier
    manager drives (put/get/delete + used accounting), with switchable
    failure injection (tests/test_kv_tiers.py's)."""

    def __init__(self, fail_puts=0, fail_gets=0):
        self.store = {}
        self.used_bytes = 0
        self.used_tokens = 0
        self.fail_puts = fail_puts
        self.fail_gets = fail_gets
        self.puts = 0

    def put(self, key, blob, meta):
        self.puts += 1
        if self.fail_puts:
            self.fail_puts -= 1
            raise IOError("t2 channel down")
        self.store[key] = (np.asarray(blob).copy(), dict(meta))
        return []

    def get(self, key):
        if self.fail_gets:
            self.fail_gets -= 1
            raise IOError("t2 channel down")
        return self.store.get(key)

    def delete(self, key):
        self.store.pop(key, None)


def _setup(P, host_entries, *, entry_tokens=8, n_slots=2, remote=None):
    backend, pool, pc = _TierStub(n_slots), P.slots.SlotPool(n_slots), P.pc.PrefixCache(4)
    tiers = P.kv.TieredKVCache(host_bytes=host_entries * _entry_bytes(entry_tokens) + 1,
                               remote=remote)
    tiers.attach(backend, pc)
    return backend, pool, pc, tiers


def _park(backend, pool, pc, rid, prompt, seed):
    slot = pool.admit(rid)
    backend.fill(slot, prompt.size, seed)
    assert pc.park(pool, slot, prompt)
    return slot


def _q(p):
    return np.concatenate([p, [9]]).astype(np.int32)


def test_demotion_moves_entry_to_exactly_one_tier(P):
    backend, pool, pc, tiers = _setup(P, 4)
    p = np.arange(8, dtype=np.int32)
    _park(backend, pool, pc, 0, p, seed=1)
    d0 = P.obs.counter("kv_tier_demotions_total").get(tier="t1")
    assert pc.evict_lru(pool, demote=tiers.demote) is not None and pool.n_free == 2
    assert pool.n_parked == 0 and len(tiers.t1) == 1 and pc.n_tier_refs == 1
    m, donor = pc.match(_q(p))
    assert m == 8 and isinstance(donor, P.kv.TierRef) and donor.tier == "t1" and donor.exact
    assert P.obs.counter("kv_tier_demotions_total").get(tier="t1") == d0 + 1
    assert P.obs.gauge("kv_tier_resident_bytes").get(tier="t1") == _entry_bytes(8)
    assert P.obs.gauge("kv_tier_resident_tokens").get(tier="t1") == 8


def test_promotion_bit_exact_and_never_evicts_donor(P):
    backend, pool, pc, tiers = _setup(P, 4)
    p = np.arange(8, dtype=np.int32)
    slot = pool.admit(0)
    k_orig, v_orig = backend.fill(slot, 8, seed=2)
    assert pc.park(pool, slot, p)
    pc.evict_lru(pool, demote=tiers.demote)
    ref = pc.peek_donor(_q(p))
    for rid, seed in ((1, 77), (2, 78)):
        dst = pool.admit(rid)
        backend.fill(dst, 8, seed=seed)
        assert tiers.promote(ref, dst, 8)
        assert np.array_equal(backend.k[:, dst, :8], k_orig)
        assert np.array_equal(backend.v[:, dst, :8], v_orig)
        assert len(tiers.t1) == 1
        pool.free(dst)


def test_full_t1_drops_counted_never_blocks(P):
    backend, pool, pc, tiers = _setup(P, 1, n_slots=3)
    d0 = P.obs.counter("kv_tier_drops_total").get(tier="t1")
    prompts = [np.repeat(np.arange(i, i + 4), 2).astype(np.int32) for i in (10, 20, 30)]
    for i, p in enumerate(prompts):
        _park(backend, pool, pc, i, p, seed=i)
        assert pc.evict_lru(pool, demote=tiers.demote) is not None
    assert len(tiers.t1) == 1 and tiers.t1.used_bytes <= tiers.t1.capacity_bytes
    assert P.obs.counter("kv_tier_drops_total").get(tier="t1") == d0 + 2
    assert [pc.match(_q(p))[0] for p in prompts] == [0, 0, 8]


def test_oversize_entry_dropped_not_stored(P):
    backend, pool, pc, tiers = _setup(P, 1, entry_tokens=4)
    p = np.arange(8, dtype=np.int32)
    _park(backend, pool, pc, 0, p, seed=3)
    assert pc.evict_lru(pool, demote=tiers.demote) is not None
    assert len(tiers.t1) == 0 and pc.n_tier_refs == 0 and pc.match(_q(p))[0] == 0


def test_stale_ref_promotes_false_and_counts_a_miss(P):
    backend, pool, pc, tiers = _setup(P, 4)
    p = np.arange(8, dtype=np.int32)
    _park(backend, pool, pc, 0, p, seed=4)
    pc.evict_lru(pool, demote=tiers.demote)
    h0 = P.obs.counter("prefix_cache_hits_total").get()
    m0 = P.obs.counter("prefix_cache_misses_total").get()
    matched, donor = pc.match(_q(p))
    assert matched == 8 and P.obs.counter("prefix_cache_hits_total").get() == h0
    tiers.t1.pop(donor.key)
    dst = pool.admit(1)
    assert tiers.promote(donor, dst, 8) is False
    with pytest.raises(ValueError, match="promote of"):
        tiers.promote(donor, dst, 9)
    pc.replace_ref(donor, None)
    pc.count_stale_miss()
    assert P.obs.counter("prefix_cache_hits_total").get() == h0
    assert P.obs.counter("prefix_cache_misses_total").get() == m0 + 1


def test_release_is_idempotent_and_gauges_zero(P):
    backend, pool, pc, tiers = _setup(P, 4)
    p = np.arange(8, dtype=np.int32)
    _park(backend, pool, pc, 0, p, seed=5)
    pc.evict_lru(pool, demote=tiers.demote)
    ref = pc.peek_donor(_q(p))
    pc.replace_ref(ref, None)
    tiers.release(ref)
    assert len(tiers.t1) == 0 and tiers.t1.used_bytes == 0 and tiers.t1.used_tokens == 0
    assert P.obs.gauge("kv_tier_resident_bytes").get(tier="t1") == 0


def test_host_tier_rejects_duplicates_and_bad_capacity(P):
    with pytest.raises(ValueError, match="capacity_bytes"):
        P.kv.HostKVTier(0)
    t1 = P.kv.HostKVTier(1 << 20)
    ref = P.kv.TierRef("t1", 0, 4, True, 16)
    t1.put(0, np.zeros(16, np.uint8), {}, ref)
    with pytest.raises(ValueError, match="already stored"):
        t1.put(0, np.zeros(16, np.uint8), {}, ref)


def _pair8(i):
    return np.repeat(np.arange(i, i + 4), 2).astype(np.int32)


def test_t1_spills_to_t2_and_promotes_bit_exact(P):
    """A one-entry host tier spills its LRU entry to the peer; the T2 ref
    keeps the entry's path, promotes bit-exactly, and the peer's bytes
    are released with the ref."""
    remote = _FakeRemote()
    backend, pool, pc, tiers = _setup(P, 1, remote=remote)
    d0 = P.obs.counter("kv_tier_demotions_total").get(tier="t2")
    slot = pool.admit(0)
    k_orig, v_orig = backend.fill(slot, 8, seed=1)
    assert pc.park(pool, slot, _pair8(1))
    pc.evict_lru(pool, demote=tiers.demote)
    _park(backend, pool, pc, 1, _pair8(5), seed=2)
    pc.evict_lru(pool, demote=tiers.demote)  # the second demotion spills the first
    ref = pc.peek_donor(_q(_pair8(1)))
    assert isinstance(ref, P.kv.TierRef) and ref.tier == "t2"
    assert P.obs.counter("kv_tier_demotions_total").get(tier="t2") == d0 + 1
    assert remote.used_bytes == _entry_bytes(8) and remote.used_tokens == 8
    dst = pool.admit(2)
    assert tiers.promote(ref, dst, 8)
    assert np.array_equal(backend.k[:, dst, :8], k_orig)
    assert np.array_equal(backend.v[:, dst, :8], v_orig)
    pc.replace_ref(ref, None)
    assert remote.store == {} and remote.used_bytes == 0


def test_t2_stale_ref_caller_owns_trie_drop(P):
    """promote() returning False on a stale T2 ref releases only the tier
    accounting and leaves the trie resident to the caller."""
    remote = _FakeRemote()
    backend, pool, pc, tiers = _setup(P, 1, remote=remote)
    pa = np.asarray([1, 1, 2, 2, 3, 3, 4, 4], np.int32)
    pb = np.asarray([5, 5, 6, 6, 7, 7, 8, 8], np.int32)
    for i, p in enumerate((pa, pb)):
        _park(backend, pool, pc, i, p, seed=i)
        pc.evict_lru(pool, demote=tiers.demote)
    ref = pc.peek_donor(_q(pa))
    assert isinstance(ref, P.kv.TierRef) and ref.tier == "t2"
    remote.store.clear()  # the peer lost the entry out of band
    d0 = P.obs.counter("kv_tier_drops_total").get(tier="t2")
    dst = pool.admit(9)
    assert tiers.promote(ref, dst, 8) is False
    assert ref in pc._resident  # the trie drop was left to us
    pc.replace_ref(ref, None)  # the engine's follow-up: must not raise
    assert ref not in pc._resident and pc.n_tier_refs == 1
    assert P.obs.counter("kv_tier_drops_total").get(tier="t2") == d0 + 1
    assert remote.used_bytes == 0 and remote.used_tokens == 0


def test_spill_remote_failure_drops_counted_never_raises(P):
    """A remote-put failure mid-spill degrades to the counted T1 drop, and
    after remote_fail_limit consecutive failures the tier latches dead."""
    remote = _FakeRemote(fail_puts=99)
    backend, pool, pc, tiers = _setup(P, 1, remote=remote)
    d0 = P.obs.counter("kv_tier_drops_total").get(tier="t1")
    prompts = [np.asarray([i, i, i + 1, i + 1, i + 2, i + 2, i + 3, i + 3], np.int32)
               for i in (10, 20, 30, 40, 50)]
    for i, p in enumerate(prompts):
        _park(backend, pool, pc, i, p, seed=i)
        assert pc.evict_lru(pool, demote=tiers.demote) is not None
    assert tiers._remote_dead
    assert remote.puts == tiers.remote_fail_limit
    assert P.obs.counter("kv_tier_drops_total").get(tier="t1") == d0 + 4
    assert len(tiers.t1) == 1 and pc.n_tier_refs == 1
    assert [pc.match(_q(p))[0] for p in prompts] == [0, 0, 0, 0, 8]


def test_remote_get_failure_degrades_to_stale_miss(P):
    """A failing get is a stale miss (counted once toward the latch), never
    an exception into admission."""
    remote = _FakeRemote(fail_gets=1)
    backend, pool, pc, tiers = _setup(P, 1, remote=remote)
    for i, p in enumerate((_pair8(1), _pair8(5))):
        _park(backend, pool, pc, i, p, seed=i)
        pc.evict_lru(pool, demote=tiers.demote)
    ref = pc.peek_donor(_q(_pair8(1)))
    assert tiers.promote(ref, pool.admit(7), 8) is False
    assert tiers._remote_failures == 1 and not tiers._remote_dead


# -- the remote tier over loopback (tests/test_kv_tiers.py::TestRemoteTier) -------


def _chan_pair(server_ep, client_ep, S=TChannel, C=TChannel, n_paths=2):
    res = {}
    t = threading.Thread(target=lambda: res.setdefault("c", S.accept(server_ep)))
    t.start()
    c = C.connect(client_ep, "127.0.0.1", server_ep.port, n_paths=n_paths)
    t.join(timeout=60)
    assert "c" in res, "channel accept timed out"
    return res["c"], c


def _stop_serving(chan):
    """End the peer's serve_forever loop at once: it exits on the first
    frame it cannot serve (an unknown op), where an idle loop would wait
    out its 30 s receive."""
    chan.send(b"UKT1" + b'{"op": "stop"}')


def test_remote_put_get_delete_over_loopback():
    """The T2 wire: CRC-verified put/get round trips bit-exactly through
    real endpoints, unknown keys miss, deletes take, and the ingress rides
    p2p_bytes_total{verb="kv_tier"}."""
    k, v = _rows(np.random.default_rng(20), 8)
    blob, meta = tkv.encode_entry(k, v)
    verb0 = tobs.counter("p2p_bytes_total").get(verb="kv_tier")
    srv = tkv.KvTierServer(capacity_bytes=4 * blob.nbytes)
    with TEndpoint(n_engines=2) as sep, TEndpoint(n_engines=2) as cep:
        schan, cchan = _chan_pair(sep, cep)
        t = srv.serve_forever(schan, timeout_ms=30000)
        cli = tkv.RemoteKVTier(cchan, max_entry_bytes=blob.nbytes, timeout_ms=30000)
        assert cli.put(7, blob, meta) == []
        got = cli.get(7)
        assert got is not None
        k2, v2 = tkv.decode_entry(*got)
        assert np.array_equal(k, k2) and np.array_equal(v, v2)
        assert cli.get(99) is None
        cli.delete(7)
        assert cli.get(7) is None
        cli.close()
        _stop_serving(cchan)
        t.join(timeout=60)
        assert not t.is_alive()
    assert tobs.counter("p2p_bytes_total").get(verb="kv_tier") >= verb0 + 2 * blob.nbytes


def test_remote_server_eviction_notice_rides_put_response():
    k, v = _rows(np.random.default_rng(21), 4)
    blob, meta = tkv.encode_entry(k, v)
    srv = tkv.KvTierServer(capacity_bytes=2 * blob.nbytes)
    with TEndpoint(n_engines=2) as sep, TEndpoint(n_engines=2) as cep:
        schan, cchan = _chan_pair(sep, cep)
        t = srv.serve_forever(schan, timeout_ms=30000)
        cli = tkv.RemoteKVTier(cchan, max_entry_bytes=blob.nbytes, timeout_ms=30000)
        assert cli.put(1, blob, meta) == []
        assert cli.put(2, blob, meta) == []
        assert cli.put(3, blob, meta) == [1]  # oldest key evicted
        assert cli.get(1) is None and cli.get(3) is not None
        big = np.zeros(3 * blob.nbytes, np.uint8)
        assert cli.put(4, big, {"enc": "raw", "shape": [1]}) is None
        cli.close()
        _stop_serving(cchan)
        t.join(timeout=60)
        assert not t.is_alive()


def test_remote_entry_larger_than_client_window_guarded_both_sides():
    k, v = _rows(np.random.default_rng(22), 8)
    blob, meta = tkv.encode_entry(k, v)
    srv = tkv.KvTierServer(capacity_bytes=4 * blob.nbytes)
    with TEndpoint(n_engines=2) as sep, TEndpoint(n_engines=2) as cep:
        schan, cchan = _chan_pair(sep, cep)
        t = srv.serve_forever(schan, timeout_ms=30000)
        cli = tkv.RemoteKVTier(cchan, max_entry_bytes=blob.nbytes, timeout_ms=30000)
        big = np.zeros(blob.nbytes + 1, np.uint8)
        assert cli.put(1, big, {"enc": "raw", "shape": [1]}) is None
        assert len(srv) == 0  # the oversize put never hit the wire
        assert cli.put(2, blob, meta) == []
        cli.max_entry_bytes = blob.nbytes - 1
        assert cli.get(2) is None
        cli.max_entry_bytes = blob.nbytes
        assert cli.get(2) is not None
        cli.close()
        _stop_serving(cchan)
        t.join(timeout=60)
        assert not t.is_alive()


@pytest.mark.parametrize("client_pkg,server_pkg", [("torch", "jax"), ("jax", "torch")])
def test_remote_tier_across_packages(client_pkg, server_pkg):
    """One package's RemoteKVTier against the other's KvTierServer: puts,
    gets (bit-exact, fp8 entries too), eviction notices and deletes."""
    C, S = PKGS[client_pkg], PKGS[server_pkg]
    k, v = _rows(np.random.default_rng(23), 8)
    raw, raw_meta = C.kv.encode_entry(k, v)
    q, q_meta = C.kv.encode_entry(k, v, wire_dtype="fp8")
    srv = S.kv.KvTierServer(capacity_bytes=raw.nbytes + q.nbytes)
    with S.Endpoint(n_engines=2) as sep, C.Endpoint(n_engines=2) as cep:
        schan, cchan = _chan_pair(sep, cep, S=S.Channel, C=C.Channel)
        t = srv.serve_forever(schan, timeout_ms=30000)
        cli = C.kv.RemoteKVTier(cchan, max_entry_bytes=raw.nbytes, timeout_ms=30000)
        assert cli.put(1, raw, raw_meta) == []
        assert cli.put(2, q, q_meta) == []
        blob, meta = cli.get(1)
        np.testing.assert_array_equal(blob, raw)
        k2, v2 = C.kv.decode_entry(blob, meta)
        assert np.array_equal(k2, k) and np.array_equal(v2, v)
        blob, meta = cli.get(2)
        np.testing.assert_array_equal(blob, q)
        assert meta == q_meta
        assert cli.put(3, raw, raw_meta) == [1]  # the server made room
        cli.delete(3)
        assert cli.get(3) is None and len(srv) == 1
        cli.close()
        _stop_serving(cchan)
        t.join(timeout=60)
        assert not t.is_alive()


# -- the model: demote/promote cycles through the engine ------------------------------

_FAMS = ("kv_tier_promotions_total", "kv_tier_demotions_total", "kv_tier_drops_total")


def _counts(obs):
    out = {f: obs.counter(f).get(tier="t1") for f in _FAMS}
    for t in ("t0", "t1"):
        out[f"hits_{t}"] = obs.counter("kv_tier_hits_total").get(tier=t)
    for f in ("prefix_cache_hits_total", "prefix_cache_misses_total",
              "prefix_cache_tokens_reused_total"):
        out[f] = obs.counter(f).total()
    return out


def _cycles(P, backend, prompts, wire_dtype=None, lose_bytes=False):
    """Every prompt twice in turn: four prefixes through two device slots,
    so round two is served from the host tier. ``lose_bytes`` drops the
    host bytes under the trie before round two (stale refs)."""
    before = _counts(P.obs)
    tiers = P.kv.TieredKVCache(host_bytes=1 << 20, wire_dtype=wire_dtype)
    eng = P.engine.ServingEngine(backend, prefill_chunk=4, prefix_cache=P.pc.PrefixCache(4),
                                 kv_tiers=tiers)
    reqs = []
    for rnd in range(2):
        if rnd and lose_bytes:
            for ref in eng.prefix_cache.tier_refs():
                tiers.t1.pop(ref.key)
        for p in prompts:
            reqs.append(eng.submit(p.copy(), max_new_tokens=4))
            eng.drain()
    assert eng.pool.leaked() == 0
    eng.prefix_cache.clear(eng.pool)
    eng.close()
    return reqs, {k: v - before[k] for k, v in _counts(P.obs).items()}


@pytest.fixture(scope="module")
def dense_pair():
    cfg = jdense.DenseConfig(**DENSE)
    jp = jdense.init_params(jax.random.PRNGKey(7), cfg)
    params = tdense.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return (jengine.DenseBackend(jp, cfg, n_slots=2, max_seq=MAX_SEQ),
            tengine.DenseBackend(params, tdense.DenseConfig(**DENSE), n_slots=2,
                                 max_seq=MAX_SEQ))


def _prompts(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, DENSE["vocab"], 12).astype(np.int32) for _ in range(4)]


@pytest.mark.parametrize("lose_bytes", [False, True])
def test_dense_demote_promote_cycles_identical_to_jax_and_exact(dense_pair, lose_bytes):
    jb, tb = dense_pair
    prompts = _prompts(8 + lose_bytes)
    jr, jc = _cycles(PKGS["jax"], jb, prompts, lose_bytes=lose_bytes)
    tr, tc = _cycles(PKGS["torch"], tb, prompts, lose_bytes=lose_bytes)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert [r.cache_hit_len for r in tr] == [r.cache_hit_len for r in jr]
    assert tc == jc
    if lose_bytes:
        # the first two prefixes' host bytes were lost: their round-two
        # admissions degrade to counted cold misses (4 + 2)
        assert tc["prefix_cache_misses_total"] >= 6
    else:
        assert tc["kv_tier_promotions_total"] >= 2 and tc["kv_tier_demotions_total"] >= 4
        assert tc["prefix_cache_hits_total"] == tc["hits_t0"] + tc["hits_t1"] > 0
    for r in tr:
        assert r.cache_hit_exact is True
        assert tengine.replay_alone(tb, r).tolist() == r.out_tokens


def test_dense_fp8_at_rest_hits_are_stamped_inexact():
    cfg = tdense.DenseConfig(**DENSE)
    params = tdense.params_from_jax(jax.tree.map(np.asarray, jdense.init_params(
        jax.random.PRNGKey(7), jdense.DenseConfig(**DENSE))), "cpu")
    tb = tengine.DenseBackend(params, cfg, n_slots=2, max_seq=MAX_SEQ)
    tr, tc = _cycles(PKGS["torch"], tb, _prompts(8), wire_dtype="fp8")
    promoted = [r for r in tr[4:] if r.cache_hit_len and not r.cache_hit_exact]
    assert tc["kv_tier_promotions_total"] >= 2 and len(promoted) == tc["kv_tier_promotions_total"]
    assert all(r.cache_hit_exact for r in tr[:4])
    assert all(r.n_generated == 4 for r in tr)


def _remote_cycles(P, backend, prompts):
    """``_cycles`` with a one-entry host tier spilling to a real remote
    peer over loopback (the package's own KvTierServer and RemoteKVTier):
    round two is served from T1 and T2."""
    before = {(f, t): P.obs.counter(f).get(tier=t) for f in _FAMS for t in ("t1", "t2")}
    entry = 2 * DENSE["n_layers"] * 12 * DENSE["n_kv_heads"] * DENSE["head_dim"] * 4
    srv = P.kv.KvTierServer(capacity_bytes=1 << 20)
    with P.Endpoint(n_engines=2) as sep, P.Endpoint(n_engines=2) as cep:
        schan, cchan = _chan_pair(sep, cep, S=P.Channel, C=P.Channel)
        t = srv.serve_forever(schan, timeout_ms=30000)
        remote = P.kv.RemoteKVTier(cchan, max_entry_bytes=1 << 16, timeout_ms=30000)
        tiers = P.kv.TieredKVCache(host_bytes=entry + 1, remote=remote)
        eng = P.engine.ServingEngine(backend, prefill_chunk=4,
                                     prefix_cache=P.pc.PrefixCache(4), kv_tiers=tiers)
        reqs = []
        for _ in range(2):
            for p in prompts:
                reqs.append(eng.submit(p.copy(), max_new_tokens=4))
                eng.drain()
        assert eng.pool.leaked() == 0
        eng.prefix_cache.clear(eng.pool)
        eng.close()
        remote.close()
        _stop_serving(cchan)
        t.join(timeout=60)
        assert not t.is_alive()
    after = {(f, t): P.obs.counter(f).get(tier=t) for f in _FAMS for t in ("t1", "t2")}
    return reqs, {k: after[k] - before[k] for k in after}


def test_dense_cycles_through_a_remote_peer_identical_to_jax(dense_pair):
    """Four prefixes through two device slots and a one-entry host tier:
    spills land on the remote peer, round two promotes from T1 and T2,
    and tokens, hit lengths and tier counters equal the JAX engine's
    with its own remote peer; every request equals its replay_alone."""
    jb, tb = dense_pair
    prompts = _prompts(31)
    jr, jc = _remote_cycles(PKGS["jax"], jb, prompts)
    tr, tc = _remote_cycles(PKGS["torch"], tb, prompts)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert [r.cache_hit_len for r in tr] == [r.cache_hit_len for r in jr]
    assert tc == jc
    assert tc[("kv_tier_demotions_total", "t2")] >= 1
    assert tc[("kv_tier_promotions_total", "t2")] >= 1
    for r in tr:
        assert r.cache_hit_exact is True
        assert tengine.replay_alone(tb, r).tolist() == r.out_tokens


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_t2_stale_ref_cold_miss_through_engine(dense_pair, pkg):
    """A remote peer answering a promotion's get with a miss: admission
    degrades to a counted cold miss, exact, leaking nothing."""
    P = PKGS[pkg]
    backend = dense_pair[0] if pkg == "jax" else dense_pair[1]
    remote = _FakeRemote()
    tiers = P.kv.TieredKVCache(host_bytes=1 << 20, remote=remote)
    eng = P.engine.ServingEngine(backend, prefill_chunk=4, prefix_cache=P.pc.PrefixCache(4),
                                 kv_tiers=tiers)
    p = np.random.default_rng(11).integers(0, DENSE["vocab"], 12).astype(np.int32)
    first = eng.submit(p.copy(), max_new_tokens=4)
    eng.drain()
    eng.prefix_cache.evict_lru(eng.pool, demote=tiers.demote)  # -> t1
    tiers._spill_lru()  # -> t2 (the fake peer)
    assert [r.tier for r in eng.prefix_cache.tier_refs()] == ["t2"]
    remote.store.clear()  # the peer dropped the entry
    r = eng.submit(p.copy(), max_new_tokens=4)
    eng.drain()
    assert r.cache_hit_len == 0
    assert eng.prefix_cache.n_tier_refs == 0
    assert r.out_tokens == first.out_tokens
    if pkg == "torch":
        assert tengine.replay_alone(backend, r).tolist() == r.out_tokens
    assert eng.pool.leaked() == 0
    eng.prefix_cache.clear(eng.pool)
    eng.close()
