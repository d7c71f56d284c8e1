"""uccl_tpu_torch.serving.disagg against the JAX package's.

* The pieces on host stubs (no model): ``KVWireFormat`` spans and metadata,
  and the BEGIN/GRANT/FINAL messages a port pair sends, byte for byte the
  JAX pair's on the same script; the lease, idempotent-BEGIN, control-loss
  and drain-timeout cases of ``tests/test_health.py::TestDisaggLease``.
* The model pairs at a tiny width (2 layers, dim 32), after
  ``tests/test_prefix_cache.py::TestDisaggPairDense`` and
  ``tests/test_disagg_transport.py`` (slow-marked there): cold and
  prefix-hit streams, a port prefill worker streaming into a JAX decode
  worker (one JAX engine), two prefill workers fanning into one decode
  worker over the windowed channel transport with loss and reorder
  injected, and an MoE pair at EP world 4 on the ``pallas`` wire.

Exact throughout: every adopted request's tokens equal the JAX one-shot
``generate``'s (the dense cases) and its ``replay_alone`` on the decode
engine's slot programs (every case), as the JAX tests hold theirs to the
oracle. Waits are bounded polls on a condition; nothing sleeps a fixed
time or asserts on the wall clock.
"""

import copy
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uccl_tpu.models import dense as jdense
from uccl_tpu.models import inference as jinf
from uccl_tpu.serving import disagg as jdisagg
from uccl_tpu.serving import engine as jengine
from uccl_tpu_torch import obs
from uccl_tpu_torch.models import dense as tdense
from uccl_tpu_torch.p2p import Endpoint
from uccl_tpu_torch.serving import disagg as tdisagg
from uccl_tpu_torch.serving import engine as tengine
from uccl_tpu_torch.serving.health import FailureDetector
from uccl_tpu_torch.serving.prefix_cache import PrefixCache

from torch_one_thread import one_torch_thread  # noqa: F401


DENSE = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8, ffn=64)
MAX_SEQ = 32


def _until(cond, step, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while not cond():
        step()
        assert time.monotonic() < deadline, "condition never held"


# -- host stubs -------------------------------------------------------------------


class _StubKV:
    """Chunk-aware stub with the model dims the wire format needs: prefill
    emits 100, the i-th decode step emits i; KV rows are zeros."""

    class _Cfg:
        n_layers = 1
        n_kv_heads = 1
        head_dim = 2

    cfg = _Cfg()

    def __init__(self, n_slots=2, max_seq=32):
        self.n_slots, self.max_seq, self.n_decodes = n_slots, max_seq, 0

    def prefill(self, tokens, lens, mask, start=None):
        return np.full(self.n_slots, 100, np.int32)

    def decode(self, tokens, active):
        self.n_decodes += 1
        return np.full(self.n_slots, self.n_decodes, np.int32)

    def export_slot_kv(self, slot, lo, hi):
        z = np.zeros((1, hi - lo, 1, 2), np.float32)
        return z, z

    def import_slot_kv(self, slot, k_rows, v_rows, *, length):
        pass

    def copy_slot_prefix(self, dst, src, n):
        pass


def _stub_pair(pkg, eng_mod, **kw):
    pe = eng_mod.ServingEngine(_StubKV(), prefill_chunk=4)
    de = eng_mod.ServingEngine(_StubKV())
    return pkg.make_local_pair(pe, de, **kw)


def _close(pw, dw):
    pw.ep.close()
    dw.ep.close()


def test_wire_format_spans_and_meta_equal_jax(rng):
    dims = dict(n_layers=3, n_slots=5, max_seq=40, n_kv_heads=2, head_dim=8)
    t, j = tdisagg.KVWireFormat(**dims), jdisagg.KVWireFormat(**dims)
    assert json.dumps(t.to_meta()) == json.dumps(j.to_meta())
    assert (t.pool_shape(), t.pool_nbytes(), t.row_bytes) == \
        (j.pool_shape(), j.pool_nbytes(), j.row_bytes)
    for _ in range(20):
        slot = int(rng.integers(0, 5))
        lo = int(rng.integers(0, 39))
        hi = int(rng.integers(lo + 1, 41))
        assert t.spans(slot, lo, hi) == j.spans(slot, lo, hi)
    assert tdisagg.KVWireFormat.from_meta(j.to_meta()) == t
    for args in ((5, 0, 4), (0, 4, 4), (0, 0, 41)):
        with pytest.raises(ValueError):
            t.spans(*args)
    # the wire format of a port backend is the JAX backend's
    cfg = jdense.DenseConfig(**DENSE)
    jb = jengine.DenseBackend(jdense.init_params(jax.random.PRNGKey(0), cfg), cfg,
                              n_slots=3, max_seq=MAX_SEQ)
    tcfg = tdense.DenseConfig(**DENSE)
    tb = tengine.DenseBackend(tdense.params_from_jax(jax.tree.map(np.asarray, jb.params),
                                                     "cpu"), tcfg, n_slots=3, max_seq=MAX_SEQ)
    assert tdisagg.wire_format_for(tb).to_meta() == jdisagg.wire_format_for(jb).to_meta()


def test_control_messages_byte_identical_to_jax(monkeypatch):
    """The same two requests through a port stub pair and a JAX stub pair,
    with the wall clock and the trace ids fixed: every BEGIN, GRANT, FINAL
    and final_ack notif is the same bytes."""
    from uccl_tpu import obs as jobs

    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    sent = {}

    def script(pkg, eng_mod, obs_mod, name):
        monkeypatch.setattr(pkg, "now", lambda: 0.0)
        out = sent[name] = []
        pw, dw = _stub_pair(pkg, eng_mod, heartbeat_s=None, ctrl_retry_s=30.0)
        for ep in (pw.ep, dw.ep):
            real = ep.send_notif

            def rec(conn, data, real=real):
                if json.loads(data.decode())["t"] in ("begin", "grant", "final", "final_ack"):
                    out.append(bytes(data))
                real(conn, data)

            ep.send_notif = rec
        try:
            done = []
            for i, n in enumerate((6, 9)):  # one at a time: GRANT hints are exact
                ctx = obs_mod.TraceContext(f"{i:032x}", f"{i:016x}")
                pw.submit(np.arange(n, dtype=np.int32), max_new_tokens=3, trace=ctx,
                          tenant="acme" if i else "default")
                _until(lambda: len(done) == i + 1 and pw.idle(),
                       lambda: (pw.step(), done.extend(dw.step())))
            return [r.out_tokens for r in done]
        finally:
            _close(pw, dw)

    got = script(tdisagg, tengine, obs, "torch")
    want = script(jdisagg, jengine, jobs, "jax")
    assert got == want == [[100, 1, 2], [100, 3, 4]]
    assert sent["torch"] == sent["jax"]
    kinds = [json.loads(m)["t"] for m in sent["torch"]]
    assert kinds.count("begin") == 2 and kinds.count("final") == 2


class TestDisaggLease:
    def test_lease_expiry_reclaims_slot(self):
        pw, dw = _stub_pair(tdisagg, tengine, grant_lease_s=0.15, ctrl_retry_s=30.0)
        try:
            pw.submit(np.arange(6, dtype=np.int32), max_new_tokens=3)
            _until(lambda: bool(dw._granted), dw.poll)  # BEGIN -> GRANT
            assert dw.engine.pool.n_free == dw.engine.pool.n_slots - 1
            c0 = obs.counter("disagg_leases_expired_total").get(reason="timeout")
            # the prefill worker "dies": no FINAL ever; the lease lapses
            _until(lambda: not dw._granted, dw.poll)
            assert dw.engine.pool.n_free == dw.engine.pool.n_slots
            assert dw.engine.pool.leaked() == 0
            assert obs.counter("disagg_leases_expired_total").get(
                reason="timeout") == c0 + 1
        finally:
            _close(pw, dw)

    def test_peer_dead_expires_lease(self):
        det = FailureDetector(suspect_after_s=0.05, dead_after_s=0.1)
        pw, dw = _stub_pair(tdisagg, tengine, grant_lease_s=60.0, detector=det,
                            ctrl_retry_s=30.0)
        try:
            pw.submit(np.arange(6, dtype=np.int32), max_new_tokens=3)
            _until(lambda: bool(dw._granted), dw.poll)
            c0 = obs.counter("disagg_leases_expired_total").get(reason="peer_dead")
            _until(lambda: not dw._granted, dw.poll)  # no heartbeats: DEAD
            assert dw.engine.pool.leaked() == 0
            assert obs.counter("disagg_leases_expired_total").get(
                reason="peer_dead") == c0 + 1
        finally:
            _close(pw, dw)

    def test_idempotent_begin_never_double_reserves(self):
        pw, dw = _stub_pair(tdisagg, tengine, ctrl_retry_s=30.0)
        try:
            msg = {"t": "begin", "rid": 7, "prompt": [1, 2, 3],
                   "max_new_tokens": 2, "eos_id": None,
                   "priority": "interactive", "t_submit": time.time(),
                   "trace": None}
            tdisagg._send_msg(pw.ep, pw.conn, msg)
            _until(lambda: bool(dw._granted), dw.poll)
            free = dw.engine.pool.n_free
            slot = next(iter(dw._granted.values()))["slot"]
            g0 = obs.counter("disagg_ctrl_retries_total").get(msg="grant")
            tdisagg._send_msg(pw.ep, pw.conn, msg)  # retried BEGIN (lost GRANT)
            _until(lambda: obs.counter("disagg_ctrl_retries_total").get(msg="grant")
                   == g0 + 1, dw.poll)
            assert dw.engine.pool.n_free == free, "double-reserved!"
            assert len(dw._granted) == 1
            assert next(iter(dw._granted.values()))["slot"] == slot
        finally:
            _close(pw, dw)

    def test_begin_retry_converges_after_total_ctrl_loss(self):
        pw, dw = _stub_pair(tdisagg, tengine, ctrl_retry_s=0.02)
        try:
            tdisagg.set_ctrl_drop(1.0, seed=3)  # the first BEGIN vanishes
            d0 = obs.counter("disagg_ctrl_dropped_total").get(msg="begin")
            req = pw.submit(np.arange(6, dtype=np.int32), max_new_tokens=3)
            assert req is not None
            assert obs.counter("disagg_ctrl_dropped_total").get(msg="begin") == d0 + 1
            dw.poll()
            assert not dw._granted and not dw._pending
            tdisagg.set_ctrl_drop(0.0)  # plane heals: the retry must converge
            done = []
            _until(lambda: len(done) >= 1, lambda: (pw.step(), done.extend(dw.step())))
            assert done[0].n_generated == 3 and done[0].out_tokens == [100, 1, 2]
        finally:
            tdisagg.set_ctrl_drop(0.0)
            _close(pw, dw)

    def test_drain_timeout_names_outstanding(self):
        pw, dw = _stub_pair(tdisagg, tengine, ctrl_retry_s=30.0)
        try:
            tdisagg.set_ctrl_drop(1.0, seed=5)  # BEGIN never reaches decode
            req = pw.submit(np.arange(6, dtype=np.int32), max_new_tokens=3)
            d0 = obs.counter("disagg_drain_timeouts_total").get(role="prefill")
            with pytest.raises(TimeoutError) as ei:
                pw.drain(timeout_s=0.05)
            assert f"rid=[{req.rid}]" in str(ei.value)
            assert "ungranted" in str(ei.value)
            assert obs.counter("disagg_drain_timeouts_total").get(role="prefill") == d0 + 1
        finally:
            tdisagg.set_ctrl_drop(0.0)
            _close(pw, dw)

    def test_ctrl_storm_fires_one_flight_bundle(self):
        tdisagg.arm_ctrl_flight(storm_after=2)
        try:
            fired = []
            orig = obs.flight_trigger
            tdisagg.obs.flight_trigger = lambda *a, **k: fired.append((a, k))
            for _ in range(4):
                tdisagg._note_ctrl_retry("begin")
            assert len(fired) == 1 and fired[0][0] == ("ctrl_storm",)
        finally:
            tdisagg.obs.flight_trigger = orig
            tdisagg.arm_ctrl_flight(None)


# -- the model pairs ----------------------------------------------------------------


@pytest.fixture(scope="module")
def dense_setup():
    jcfg = jdense.DenseConfig(**DENSE)
    jp = jdense.init_params(jax.random.PRNGKey(0), jcfg)
    params = tdense.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    oracle_cache = {}

    def oracle(req):
        key = (req.prompt.tobytes(), req.max_new_tokens)
        if key not in oracle_cache:
            toks = jinf.generate(jp, jnp.asarray(req.prompt)[None], jcfg,
                                 max_new_tokens=req.max_new_tokens, max_seq=MAX_SEQ)
            oracle_cache[key] = np.asarray(toks)[0].tolist()
        return oracle_cache[key][: req.n_generated]

    return tdense.DenseConfig(**DENSE), params, jcfg, jp, oracle


def _dense(params, cfg, n_slots=2):
    return tengine.DenseBackend(params, cfg, n_slots=n_slots, max_seq=MAX_SEQ)


def _replayed(backend, req, chunk):
    """The adopted request replayed alone on ``backend``'s slot programs:
    its prompt through the prefill worker's C-token chunks in the slot it
    decoded in, then its decodes."""
    r = copy.copy(req)
    r.prefill_chunk = chunk
    return tengine.replay_alone(backend, r).tolist()


def test_cold_and_hit_streams_exact(dense_setup):
    cfg, params, _, _, oracle = dense_setup
    pe = tengine.ServingEngine(_dense(params, cfg), prefill_chunk=4,
                               prefix_cache=PrefixCache(4))
    de = tengine.ServingEngine(_dense(params, cfg))
    pw, dw = tdisagg.make_local_pair(pe, de)
    try:
        tdisagg.warm_pair(pw, dw, prompt_len=8)
        rng = np.random.default_rng(0)
        p0 = rng.integers(0, 64, 12).astype(np.int32)
        p1 = np.concatenate([p0[:8], rng.integers(0, 64, 4).astype(np.int32)])
        chunks0 = obs.counter("kv_stream_chunks_total").get(role="tx")
        cold, _ = tdisagg.drive_pair(pw, dw, [p0], [0.0], max_new_tokens=4)
        hit, _ = tdisagg.drive_pair(pw, dw, [p1], [0.0], max_new_tokens=4)
        for r in cold + hit:
            assert r.adopted
            assert r.out_tokens == oracle(r), r.rid
            assert r.out_tokens == _replayed(de.backend, r, 4)
        assert hit[0].cache_hit_len == 8  # reused rows still streamed
        # every KV row crossed the wire both times: the cold prompt as 3
        # C-token slabs, the hit as its copied [0, 8) prefix in ONE slab
        # plus the recomputed final chunk
        assert obs.counter("kv_stream_chunks_total").get(role="tx") - chunks0 == 5
        snap = de.snapshot()
        assert snap["adopted"] == 2
        for key in ("disagg_queue_ms", "disagg_prefill_ms", "disagg_transfer_ms",
                    "disagg_ttft_ms"):
            assert "p50" in snap[key], key
        assert pe.pool.leaked() == 0 and de.pool.leaked() == 0
        pw.close()
    finally:
        _close(pw, dw)


def test_port_prefill_streams_into_a_jax_decode_worker(dense_setup):
    """The wire between the packages: a port PrefillWorker's slabs and
    notifs land in a JAX DecodeWorker's mirror, which adopts and decodes
    them to the JAX generate's tokens; the decode side's BEGIN carries the
    tenant across."""
    cfg, params, jcfg, jp, oracle = dense_setup
    pe = tengine.ServingEngine(_dense(params, cfg), prefill_chunk=4)
    de = jengine.ServingEngine(jengine.DenseBackend(jp, jcfg, n_slots=2, max_seq=MAX_SEQ))
    from uccl_tpu.p2p import Endpoint as JEndpoint

    dw = jdisagg.DecodeWorker(de, JEndpoint())
    pw = tdisagg.add_local_prefill(dw, pe)
    try:
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, 64, n).astype(np.int32) for n in (5, 11)]
        done = []
        for i, p in enumerate(prompts):
            assert pw.submit(p, max_new_tokens=4, tenant="acme" if i else "default")
        _until(lambda: len(done) == 2, lambda: (pw.step(), done.extend(dw.step())))
        for r in done:
            assert r.adopted and r.out_tokens == oracle(r)
        assert sorted(r.tenant for r in done) == ["acme", "default"]
        pw.drain()
        assert pe.pool.leaked() == 0 and de.pool.leaked() == 0
    finally:
        _close(pw, dw)


def test_two_prefill_one_decode_channel_lossy_reordering(dense_setup):
    """Two prefill workers fan into one decode worker over the windowed
    SACK channel (receiver-driven pull credit, swift window CC), with drop
    and reorder injected on both prefill data planes: every adopted
    request stays exact, and the transport really retransmitted."""
    cfg, params, _, _, oracle = dense_setup
    pes = [tengine.ServingEngine(_dense(params, cfg), prefill_chunk=4) for _ in range(2)]
    de = tengine.ServingEngine(_dense(params, cfg, n_slots=4))
    dw = tdisagg.DecodeWorker(de, Endpoint(), pull_rate_bps=64e6)
    pws = [tdisagg.add_local_prefill(dw, pe, transport="channel", n_paths=2,
                                     chunk_bytes=8 << 10, pull=True, window_cc="swift")
           for pe in pes]
    for pw in pws:
        assert pw.chan is not None
        pw.chan.retries = 8  # loss-soak budget

    def pump(n_done, done):
        def step():
            for pw in pws:
                pw.step()
            done.extend(dw.step())
        _until(lambda: len(done) >= n_done, step, timeout_s=120.0)
        return done

    try:
        for pw in pws:
            pw.ep.set_drop_rate(0.2)
            pw.ep.set_reorder_rate(0.3)
        rng = np.random.default_rng(23)
        prompts = [rng.integers(0, 64, 6 + 2 * i).astype(np.int32) for i in range(4)]
        done = []
        for i, p in enumerate(prompts):
            assert pws[i % 2].submit(p, max_new_tokens=4) is not None
        pump(4, done)
    finally:
        for pw in pws:
            pw.ep.set_drop_rate(0.0)
            pw.ep.set_reorder_rate(0.0)
        rx_chans = list(dw.channels)
        dw.close()
    assert len(done) == 4
    for r in done:
        assert r.adopted and r.out_tokens == oracle(r), r.rid
    for eng in pes + [de]:
        assert eng.pool.leaked() == 0
    assert sum(pw.chan.retransmitted_chunks for pw in pws) >= 1
    assert rx_chans and all(ch.pull_granted > 0 for ch in rx_chans)
    assert len(de.metrics.disagg_transfer_s) == 4
    assert all(t >= 0 for t in de.metrics.disagg_transfer_s)
    for pw in pws:
        pw.ep.close()
    dw.ep.close()


def test_moe_pair_at_world_4_on_the_pallas_wire_exact(dense_setup):
    """Both engines an MoE server at EP world 4 on the pallas wire (the B9
    exchange's plain version on the CPU): every adopted request equals its
    replay on the decode engine's slot programs, and the decode pool's
    mirror layout is the MoE grid's flat slots."""
    import torch

    from uccl_tpu_torch.models import moe_inference as tmoe
    from uccl_tpu_torch.models.sampling import prng_key
    from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    sizes = dict(DENSE, moe_experts=8, moe_topk=2, moe_ffn=64)
    sizes.pop("ffn")
    srv = tmoe.MoEServer(tmoe.MoEServeConfig(**sizes, moe_wire="pallas"),
                         make_mesh(MeshConfig(dp=4), "cpu", 4))
    params = srv.shard_params(tmoe.init_params(prng_key(1), srv.cfg, "cpu"))

    def backend():
        return tengine.MoEBackend(srv, params, batch_local=1, max_seq=MAX_SEQ)

    pe = tengine.ServingEngine(backend(), prefill_chunk=4)
    de = tengine.ServingEngine(backend())
    pw, dw = tdisagg.make_local_pair(pe, de)
    try:
        assert dw.fmt.n_slots == 4 and dw.mirror_k.shape == dw.fmt.pool_shape()
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, 64, n).astype(np.int32) for n in (6, 9)]
        done, _ = tdisagg.drive_pair(pw, dw, prompts, [0.0] * 2, max_new_tokens=3)
        assert len(done) == 2
        for r in done:
            assert r.adopted and r.n_generated == 3
            assert r.out_tokens == _replayed(de.backend, r, 4), r.rid
        assert isinstance(de.backend.cache.flat().k, torch.Tensor)
        assert pe.pool.leaked() == 0 and de.pool.leaked() == 0
    finally:
        _close(pw, dw)


def test_oneshot_reference_equals_jax(dense_setup):
    cfg, params, jcfg, jp, _ = dense_setup
    prompt = np.random.default_rng(9).integers(0, 64, (2, 7)).astype(np.int32)
    got = tdisagg.oneshot_reference(params, cfg, prompt, 5, MAX_SEQ)
    logits, cache = jinf.prefill(jp, jnp.asarray(prompt), jcfg, MAX_SEQ)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks = [np.asarray(tok)]
    for _ in range(4):
        logits, cache = jinf.decode_step(jp, tok, cache, jcfg)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
    np.testing.assert_array_equal(got, np.stack(toks, axis=1))
