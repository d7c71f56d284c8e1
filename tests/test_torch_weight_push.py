"""uccl_tpu_torch.p2p.weight_push, case for case as tests/test_weight_push.py
holds the JAX package's (codec and manifest units, loopback publish -> fetch
bit-exactness with its counters, the relay chain in which the root ships
each chunk once, the serving consumer, resume by group CRC), on trees of
tensors. The relay chain runs here at a small size (the JAX case is marked
slow). The resume case plants its mid-transfer fault deterministically (the
fetching side fails right after group 0 verified) instead of racing a loss
injection against 1.5-4 s deadlines, which ROADMAP lists as unsteady.
ElasticBuffer's warm-spare admission is tested in tests/test_torch_elastic.py.

Then the wire between the packages, bit-exact in both directions with raw,
bf16, fp8 and lossless payloads: a JAX WeightPublisher served to a port
fetch, a port publisher to a JAX fetch, and a mixed relay chain.
"""

import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from uccl_tpu_torch import obs
from uccl_tpu_torch.p2p import Channel, Endpoint, WeightPublisher
from uccl_tpu_torch.p2p import weight_push as wp


def chan_pair(server_ep, client_ep, n_paths=2, channel=Channel):
    res = {}
    t = threading.Thread(target=lambda: res.setdefault("c", channel.accept(server_ep)))
    t.start()
    c = channel.connect(client_ep, "127.0.0.1", server_ep.port, n_paths=n_paths)
    t.join(timeout=60)
    assert "c" in res, "channel accept timed out"
    return res["c"], c


def small_tree(rng, scale=1):
    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return {
        "layers": [{"w": f32(32 * scale, 16), "b": f32(16)} for _ in range(2)],
        "emb": f32(64, 8),
        "step": torch.tensor([42], dtype=torch.int64),
    }


def tbits(t: torch.Tensor) -> np.ndarray:
    return torch.empty(t.shape, dtype=t.dtype).copy_(t).reshape(-1).view(torch.uint8).numpy()


def trees_equal(a, b):
    fa = dict(wp.flatten_tree(a))
    fb = dict(wp.flatten_tree(b))
    return (set(fa) == set(fb)
            and all(fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape
                    and np.array_equal(tbits(fa[k]), tbits(fb[k])) for k in fa))


class TestTreeCodec:
    def test_flatten_unflatten_roundtrip(self, rng):
        tree = small_tree(rng)
        pairs = wp.flatten_tree(tree)
        assert [k for k, _ in pairs] == sorted(k for k, _ in pairs)
        rebuilt = wp.unflatten_tree(dict(pairs))
        assert isinstance(rebuilt["layers"], list)
        assert trees_equal(tree, rebuilt)

    def test_empty_tree_rejected(self):
        with pytest.raises(ValueError):
            wp.flatten_tree({})
        with pytest.raises(ValueError):
            wp.flatten_tree({"a": {}})

    def test_manifest_groups_cover_everything(self, rng):
        pub = WeightPublisher(group_bytes=1024)
        pub.publish("m", small_tree(rng))
        snap = pub.get("m")
        ents = snap.manifest["entries"]
        covered = []
        for g, (lo, hi) in enumerate(snap.manifest["groups"]):
            covered.extend(range(lo, hi))
            a, b = snap.group_range(g)
            assert b > a
            assert snap.group_crc(g) == snap.manifest["group_crcs"][g]
        assert covered == list(range(len(ents)))
        total = sum(int(e["nbytes"]) for e in ents)
        assert total == snap.total_bytes == snap.buf.nbytes

    def test_versioning_and_eviction(self, rng):
        pub = WeightPublisher(keep_versions=2)
        t = small_tree(rng)
        assert pub.publish("m", t) == 1
        assert pub.publish("m", t) == 2
        assert pub.publish("m", t) == 3
        assert pub.get("m").version == 3
        assert pub.get("m", 2).version == 2
        with pytest.raises(KeyError):
            pub.get("m", 1)
        with pytest.raises(KeyError):
            pub.get("nope")
        with pytest.raises(ValueError):
            pub.publish("m", t, version=3)

    def test_fp8_wire_canonicalized_once(self, rng):
        pub = WeightPublisher()
        tree = small_tree(rng)
        pub.publish("m", tree, wire="fp8")
        flat = pub.get("m").flat()
        assert torch.equal(flat["step"], tree["step"])  # raw non-float
        w = tree["layers"][0]["w"]
        got = flat["layers.0.w"]
        assert not torch.equal(got, w)  # lossy...
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0.2, atol=0.1)  # ...bounded
        with pytest.raises(ValueError):
            pub.publish("m2", tree, wire="nope")

    def test_manifest_dtype_names_are_numpys(self):
        """bf16 leaves are named as ml_dtypes names them, so both packages
        read one manifest."""
        pub = WeightPublisher()
        pub.publish("m", {"a": torch.zeros(3, dtype=torch.bfloat16),
                          "b": torch.zeros(2, dtype=torch.float16),
                          "c": np.zeros(4, np.int32), "d": torch.tensor(True)})
        names = {e["key"]: e["dtype"] for e in pub.get("m").manifest["entries"]}
        assert names == {"a": "bfloat16", "b": "float16", "c": "int32", "d": "bool"}
        assert names["a"] == np.dtype(ml_dtypes.bfloat16).name
        assert pub.get("m").flat()["d"].dtype == torch.bool

    def test_device_leaves_stage_to_host_once(self):
        """A leaf on another device is copied to host at publish; the
        snapshot and its tree are host tensors."""
        pub = WeightPublisher()
        pub.publish("m", {"w": torch.arange(6.0).reshape(2, 3)})
        got = pub.get("m").tree()["w"]
        assert got.device.type == "cpu" and torch.equal(got, torch.arange(6.0).reshape(2, 3))


class TestLoopback:
    def test_publish_fetch_bit_exact_with_counters(self, rng):
        pub = WeightPublisher(group_bytes=8 << 10)
        tree = small_tree(rng)
        v = pub.publish("model", tree)
        rx0 = obs.counter("weight_push_bytes_total").get(role="rx", name="model")
        peers0 = obs.counter("weight_push_peers_total").get(name="model")
        verb0 = obs.counter("p2p_bytes_total").get(verb="weight_push")
        with Endpoint(n_engines=2) as pep, Endpoint(n_engines=2) as sep:
            srv, cli = chan_pair(pep, sep)
            t = threading.Thread(target=lambda: pub.serve(srv))
            t.start()
            snap = wp.fetch(cli, "model")
            t.join(timeout=60)
        assert snap.version == v
        assert trees_equal(snap.tree(), tree)
        total = snap.total_bytes
        assert obs.counter("weight_push_bytes_total").get(role="rx", name="model") == rx0 + total
        assert obs.counter("weight_push_peers_total").get(name="model") == peers0 + 1
        assert obs.counter("p2p_bytes_total").get(verb="weight_push") >= verb0 + total

    def test_fetch_unknown_name_fails_loudly(self, rng):
        pub = WeightPublisher()
        pub.publish("model", small_tree(rng))
        with Endpoint(n_engines=2) as pep, Endpoint(n_engines=2) as sep:
            srv, cli = chan_pair(pep, sep)
            err = []

            def serve():
                try:
                    pub.serve(srv)
                except KeyError as e:
                    err.append(e)

            t = threading.Thread(target=serve)
            t.start()
            with pytest.raises(Exception):
                wp.fetch(cli, "other", timeout_ms=3000)
            t.join(timeout=60)
            assert err

    def test_corrupted_staged_byte_fails_group_crc(self, rng):
        """A byte flipped in the publisher's staged host copy after the
        CRCs were taken fails that group's CRC at the fetching peer."""
        pub = WeightPublisher(group_bytes=1024)
        pub.publish("model", small_tree(rng))
        snap = pub.get("model")
        a, _b = snap.group_range(1)
        snap.buf[a + 3] ^= 0x40
        with Endpoint(n_engines=2) as pep, Endpoint(n_engines=2) as sep:
            srv, cli = chan_pair(pep, sep)

            def serve():
                try:  # the rest of the groups land in a window that closed
                    pub.serve(srv, timeout_ms=30000)
                except Exception:
                    pass

            t = threading.Thread(target=serve)
            t.start()
            with pytest.raises(wp.FetchError, match="group 1 CRC mismatch") as ei:
                wp.fetch(cli, "model")
            assert ei.value.groups_ok == [0]
            cli.close()  # the server's next write or message fails at once
            t.join(timeout=60)
            assert not t.is_alive()


class TestRelayChain:
    @pytest.mark.parametrize("wire", [None, "fp8"])
    def test_three_peer_chain_bit_exact(self, rng, wire):
        """root -> s1 -> s2 -> s3: every peer bit-exact vs the PUBLISHED
        version, and the root's counted egress stays ONE snapshot."""
        pub = WeightPublisher(group_bytes=16 << 10)
        tree = small_tree(rng, scale=4)
        pub.publish("m", tree, wire=wire)
        canon = pub.get("m").flat()
        fam = obs.counter("weight_push_bytes_total")
        root0 = fam.get(role="tx", name="m", src="publisher")
        eps = [Endpoint(n_engines=2) for _ in range(4)]
        try:
            d0, u1 = chan_pair(eps[0], eps[1])
            d1, u2 = chan_pair(eps[1], eps[2])
            d2, u3 = chan_pair(eps[2], eps[3])
            snaps = {}

            def node(i, up, downs):
                snaps[i] = wp.fetch(up, "m", forward_to=downs)

            ts = [threading.Thread(target=node, args=(1, u1, [d1])),
                  threading.Thread(target=node, args=(2, u2, [d2])),
                  threading.Thread(target=node, args=(3, u3, []))]
            for t in ts:
                t.start()
            pub.serve(d0)
            for t in ts:
                t.join(timeout=60)
            assert sorted(snaps) == [1, 2, 3]
            for i in (1, 2, 3):
                flat = snaps[i].flat()
                assert all(np.array_equal(tbits(flat[k]), tbits(canon[k])) for k in canon), \
                    f"peer {i} diverged"
            assert fam.get(role="tx", name="m", src="publisher") == root0 + pub.get("m").total_bytes
        finally:
            for ep in eps:
                ep.close()


class TestConsumers:
    def test_replicate_backend_serves_pushed_version(self, rng):
        """replicate_backend(weights=) spins every replica up on the
        fetched tree (structure-validated)."""
        from uccl_tpu_torch.models import dense
        from uccl_tpu_torch.models.sampling import prng_key
        from uccl_tpu_torch.serving.engine import DenseBackend, replicate_backend

        cfg = dense.DenseConfig(vocab=32, dim=16, n_layers=1, n_heads=2, n_kv_heads=1,
                                head_dim=8, ffn=32)
        params = dense.init_params(prng_key(0), cfg, "cpu")
        backend = DenseBackend(params, cfg, n_slots=2, max_seq=16)
        pub = WeightPublisher()
        pub.publish("dense", {k: v * 2 for k, v in params.items()}
                    if all(isinstance(v, torch.Tensor) for v in params.values()) else params)
        snap = pub.get("dense")
        reps = replicate_backend(backend, 2, weights=snap)
        assert len(reps) == 2 and reps[0].params is reps[1].params
        for (k, got), (_, want) in zip(wp.flatten_tree(reps[1].params),
                                       wp.flatten_tree(snap.tree())):
            assert torch.equal(got, want), k
        bad = {"not": np.zeros(3, np.float32)}
        with pytest.raises(ValueError):
            replicate_backend(backend, 2, weights=bad)


    def test_moe_replica_serves_a_pushed_global_tree(self):
        """The MoE stack at EP world 4: the global tree init_params draws,
        pushed over loopback, placed by replicate_backend on the server's
        layout, serves the same tokens as the source engine."""
        from uccl_tpu_torch import serve
        from uccl_tpu_torch.models import moe_inference as tmoe
        from uccl_tpu_torch.models.sampling import prng_key
        from uccl_tpu_torch.serving import ServingEngine, replicate_backend

        args = serve.parser().parse_args(
            ["--server", "--device", "cpu", "--stack", "moe", "--seed", "0", "--slots", "4",
             "--prompt-len", "8", "--new-tokens", "4", "--max-seq", "16", "--dp", "4",
             "--vocab", "64", "--dim", "32", "--layers", "2", "--heads", "4", "--kv-heads", "2",
             "--ffn", "32", "--experts", "8"])
        backend, _, vocab = serve.build_stack(args, "cpu")
        params = tmoe.init_params(prng_key(0), serve.moe_config(args), "cpu")
        pub = WeightPublisher(group_bytes=16 << 10)
        pub.publish("moe", params)
        with Endpoint(n_engines=2) as pep, Endpoint(n_engines=2) as sep:
            srv, cli = chan_pair(pep, sep)
            t = threading.Thread(target=lambda: pub.serve(srv))
            t.start()
            snap = wp.fetch(cli, "moe")
            t.join(timeout=60)
        (pushed,) = replicate_backend(backend, 1, weights=snap)
        assert pushed.server is backend.server
        for (k, a), (_, b) in zip(wp.flatten_tree(pushed.params),
                                  wp.flatten_tree(backend.params)):
            assert torch.equal(a, b), k
        prompts = [np.random.default_rng(i).integers(0, vocab, 6 + i).astype(np.int32)
                   for i in range(4)]
        outs = []
        for be in (backend, pushed):
            eng = ServingEngine(be)
            reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
            eng.drain()
            outs.append([r.out_tokens for r in reqs])
            eng.close()
        assert outs[0] == outs[1]
        with pytest.raises(ValueError, match="MoE model"):
            replicate_backend(backend, 1, weights={"embed": torch.zeros(3)})


class TestResume:
    def test_faulted_fetch_resumes_by_group_crc(self, rng):
        """A fetch killed mid-transfer (a planted fault once group 0
        verified) resumes off its FetchError.partial: the
        verified groups are skipped (CRC-guarded, counted on
        weight_push_resumed_groups_total) and the completed snapshot is
        bit-exact vs the published version."""
        pub = WeightPublisher(group_bytes=1024)
        tree = small_tree(rng)
        pub.publish("model", tree)
        n_groups = len(pub.get("model").manifest["groups"])
        assert n_groups >= 3
        with Endpoint(n_engines=2) as pep, Endpoint(n_engines=2) as sep:
            srv, cli = chan_pair(pep, sep)

            def serve_once():
                try:  # the fetch gives up after group 0: later writes fail
                    pub.serve(srv, timeout_ms=30000)
                except Exception:
                    pass

            t = threading.Thread(target=serve_once)
            t.start()

            def on_group(g):
                if g == 0:
                    raise RuntimeError("planted fault after group 0")

            with pytest.raises(wp.FetchError) as ei:
                wp.fetch(cli, "model", timeout_ms=30000, on_group=on_group)
            cli.close()
            t.join(timeout=60)
            assert not t.is_alive()
            err = ei.value
            assert err.partial is not None
            assert err.groups_ok == [0]

            res0 = obs.counter("weight_push_resumed_groups_total").get()
            rx0 = obs.counter("weight_push_bytes_total").get(role="rx", name="model")
            srv2, cli2 = chan_pair(pep, sep)
            t2 = threading.Thread(target=lambda: pub.serve(srv2))
            t2.start()
            snap = wp.fetch(cli2, "model", resume=err.partial)
            t2.join(timeout=60)
            assert trees_equal(snap.tree(), tree)
            # the groups whose bytes had landed intact when the fetch died
            # (group 0 at least; a group in flight may have landed too)
            intact = [g for g in range(n_groups)
                      if err.partial.group_crc(g) == snap.manifest["group_crcs"][g]]
            assert intact[0] == 0
            assert obs.counter("weight_push_resumed_groups_total").get() - res0 == len(intact)
            rx = obs.counter("weight_push_bytes_total").get(role="rx", name="model") - rx0
            assert rx == snap.total_bytes - sum(
                snap.group_range(g)[1] - snap.group_range(g)[0] for g in intact)

    def test_resume_against_different_version_falls_back_full(self, rng):
        pub = WeightPublisher(group_bytes=1024)
        tree = small_tree(rng)
        pub.publish("model", tree)
        stale_man = dict(pub.get("model").manifest, version=99)
        stale = wp.WeightSnapshot(stale_man, pub.get("model").buf.copy())
        res0 = obs.counter("weight_push_resumed_groups_total").get()
        with Endpoint(n_engines=2) as pep, Endpoint(n_engines=2) as sep:
            srv, cli = chan_pair(pep, sep)
            t = threading.Thread(target=lambda: pub.serve(srv))
            t.start()
            snap = wp.fetch(cli, "model", resume=stale)
            t.join(timeout=60)
        assert trees_equal(snap.tree(), tree)
        assert obs.counter("weight_push_resumed_groups_total").get() == res0


# -- the wire between the packages --------------------------------------------


def _np_tree(rng):
    """A JAX-side tree: f32, bf16 (ml_dtypes), f16, int leaves."""
    return {
        "blocks": [{"w": rng.standard_normal((40, 24)).astype(np.float32),
                    "wb": (rng.standard_normal((24, 40)) * 0.1).astype(ml_dtypes.bfloat16)}
                   for _ in range(3)],
        "norm": rng.standard_normal(24).astype(np.float16),
        "step": np.asarray([7], np.int64),
    }


def _as_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("wire", [None, "fp8", "lossless"])
def test_jax_publisher_to_port_fetch(rng, wire):
    from uccl_tpu.p2p import Channel as JChannel
    from uccl_tpu.p2p import Endpoint as JEndpoint
    from uccl_tpu.p2p import WeightPublisher as JPublisher

    pub = JPublisher(group_bytes=2048)
    pub.publish("m", _np_tree(rng), wire=wire)
    canon = pub.get("m").flat()
    with JEndpoint(n_engines=2) as jep, Endpoint(n_engines=2) as tep:
        res = {}
        t = threading.Thread(target=lambda: res.setdefault("c", JChannel.accept(jep)))
        t.start()
        cli = Channel.connect(tep, "127.0.0.1", jep.port, n_paths=2)
        t.join(timeout=60)
        ts = threading.Thread(target=lambda: pub.serve(res["c"]))
        ts.start()
        snap = wp.fetch(cli, "m")
        ts.join(timeout=60)
    assert snap.manifest == {k: v for k, v in pub.get("m").manifest.items()}
    np.testing.assert_array_equal(snap.buf, pub.get("m").buf)
    flat = snap.flat()
    assert set(flat) == set(canon)
    for k, want in canon.items():
        got = flat[k]
        assert got.dtype == _as_torch(want[:0] if want.ndim else want.reshape(1)[:0]).dtype, k
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(tbits(got), _np_bits(want), err_msg=k)


@pytest.mark.parametrize("wire", [None, "fp8", "lossless"])
def test_port_publisher_to_jax_fetch(rng, wire):
    from uccl_tpu.p2p import Channel as JChannel
    from uccl_tpu.p2p import Endpoint as JEndpoint
    from uccl_tpu.p2p import weight_push as jwp

    tree = {k: v for k, v in _np_tree(rng).items()}
    ttree = {"blocks": [{k: _as_torch(v) for k, v in b.items()} for b in tree["blocks"]],
             "norm": _as_torch(tree["norm"]), "step": _as_torch(tree["step"])}
    pub = WeightPublisher(group_bytes=2048)
    pub.publish("m", ttree, wire=wire)
    canon = pub.get("m").flat()
    with Endpoint(n_engines=2) as tep, JEndpoint(n_engines=2) as jep:
        res = {}
        t = threading.Thread(target=lambda: res.setdefault("c", Channel.accept(tep)))
        t.start()
        cli = JChannel.connect(jep, "127.0.0.1", tep.port, n_paths=2)
        t.join(timeout=60)
        ts = threading.Thread(target=lambda: pub.serve(res["c"]))
        ts.start()
        snap = jwp.fetch(cli, "m")
        ts.join(timeout=60)
    np.testing.assert_array_equal(snap.buf, pub.get("m").buf)
    # the JAX encoder of the same tree writes the same snapshot bytes
    from uccl_tpu.p2p import WeightPublisher as JPublisher

    jpub = JPublisher(group_bytes=2048)
    jpub.publish("m", tree, wire=wire)
    np.testing.assert_array_equal(jpub.get("m").buf, pub.get("m").buf)
    assert jpub.get("m").manifest == pub.get("m").manifest
    flat = snap.flat()
    for k, want in canon.items():
        got = flat[k]
        assert got.dtype.name == wp.dtype_name(want.dtype), k
        np.testing.assert_array_equal(_np_bits(got), tbits(want), err_msg=k)


def test_mixed_relay_chain(rng):
    """JAX publisher -> port relay -> JAX leaf, bf16 on the wire: both
    peers bit-exact vs the published version, the root's egress one
    snapshot."""
    from uccl_tpu import obs as jobs
    from uccl_tpu.p2p import Channel as JChannel
    from uccl_tpu.p2p import Endpoint as JEndpoint
    from uccl_tpu.p2p import WeightPublisher as JPublisher
    from uccl_tpu.p2p import weight_push as jwp

    pub = JPublisher(group_bytes=4096)
    pub.publish("m", _np_tree(rng))
    canon = pub.get("m").flat()
    root0 = jobs.counter("weight_push_bytes_total").get(role="tx", name="m", src="publisher")
    with JEndpoint(n_engines=2) as root, Endpoint(n_engines=2) as relay, \
            JEndpoint(n_engines=2) as leaf:
        res = {}
        t = threading.Thread(target=lambda: res.setdefault("up", JChannel.accept(root)))
        t.start()
        up = Channel.connect(relay, "127.0.0.1", root.port, n_paths=2)
        t.join(timeout=60)
        t = threading.Thread(target=lambda: res.setdefault("down", Channel.accept(relay)))
        t.start()
        leaf_up = JChannel.connect(leaf, "127.0.0.1", relay.port, n_paths=2)
        t.join(timeout=60)
        snaps = {}
        ts = [threading.Thread(target=lambda: snaps.setdefault(
                  "relay", wp.fetch(up, "m", forward_to=[res["down"]]))),
              threading.Thread(target=lambda: snaps.setdefault("leaf", jwp.fetch(leaf_up, "m")))]
        for x in ts:
            x.start()
        pub.serve(res["up"])
        for x in ts:
            x.join(timeout=60)
    relay_flat, leaf_flat = snaps["relay"].flat(), snaps["leaf"].flat()
    for k, want in canon.items():
        np.testing.assert_array_equal(tbits(relay_flat[k]), _np_bits(want), err_msg=k)
        np.testing.assert_array_equal(_np_bits(leaf_flat[k]), _np_bits(want), err_msg=k)
    assert relay_flat["blocks.0.wb"].dtype == torch.bfloat16
    assert jobs.counter("weight_push_bytes_total").get(
        role="tx", name="m", src="publisher") == root0 + pub.get("m").total_bytes
