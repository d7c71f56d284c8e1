"""The port's EP plane at EP world 4 (uccl_tpu_torch/ep: Buffer, ops, ll)
against the JAX package's (uccl_tpu/ep), on the CPU.

The same seeded numpy inputs and parameters go through both. The JAX side
runs as its own tests run it: ``Buffer(make_mesh(MeshConfig(dp=4)), "dp")``
on the virtual CPU devices, each verb a jit of shard_map. The references are
taken on JAX's "lax" wire, which tests/test_pallas_a2a.py holds
bit-identical to its kernels; the port's every wire, chunk depth and round
schedule must reproduce them. Its "pallas" wire runs the kernels' plain
versions on CPU tensors.

Tolerances. Bit for bit wherever the work is copies and integers: dispatch's
``recv_x`` (the quantized wires too, against the jitted JAX codec), the
handles, the counts, the layout, the low-latency buffers, ``stats()``.
Where a float sum is reordered, the JAX EP tests' own tolerances: combine
rtol 1e-5 / atol 1e-6 (tests/test_ep.py), the low-latency combine and its
grouped GEMMs 2e-5 (tests/test_ep_ll.py), a world-W MoE layer against an
unsharded one 2e-4 / 2e-5 (tests/test_ep.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from uccl_tpu.collective import plan as jplan
from uccl_tpu.ep import Buffer as JBuffer
from uccl_tpu.ep import a2a_sched as jsched
from uccl_tpu.ep import ops as jops
from uccl_tpu.ep.buffer import EP_BYTES as J_EP_BYTES
from uccl_tpu.parallel.mesh import MeshConfig as JMeshConfig
from uccl_tpu.parallel.mesh import make_mesh as jmake_mesh
from uccl_tpu.utils.jaxcompat import shard_map
from uccl_tpu_torch.collective import dma
from uccl_tpu_torch.collective import plan as tplan
from uccl_tpu_torch.ep import Buffer, Config, EventOverlap
from uccl_tpu_torch.ep import a2a_sched as tsched
from uccl_tpu_torch.ep import ll as tll
from uccl_tpu_torch.ep import ops as tops
from uccl_tpu_torch.ep.buffer import EP_BYTES
from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh

W, T, H, E, K, F = 4, 16, 128, 8, 2, 48
E_LOCAL = E // W
WIRE_DTYPES = [None, "fp8", "int8"]
COMBINE_TOL = dict(rtol=1e-5, atol=1e-6)
LL_TOL = dict(rtol=2e-5, atol=2e-5)
LAYER_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def jmesh(devices):
    return jmake_mesh(JMeshConfig(dp=W), devices[:W])


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(MeshConfig(dp=W), device="cpu")


def _routing(seed, t=T, none_share=0.0):
    """Member-stacked [W, T, K] distinct expert ids (some -1 when asked),
    their gate weights, and tokens [W, T, H], all f32 numpy."""
    rng = np.random.default_rng(seed)
    idx = np.argsort(rng.random((W, t, E)), axis=-1)[..., :K].astype(np.int32)
    if none_share:
        idx[rng.random(idx.shape) < none_share] = -1
    wts = rng.random((W, t, K)).astype(np.float32)
    x = rng.standard_normal((W, t, H)).astype(np.float32)
    return x, idx, wts


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) and a.is_floating_point()
                      else a)


def _eq(got, want):
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.fixture(scope="module")
def dispatched(jmesh):
    """The JAX references, once per wire dtype, on its lax wire: dispatch
    (recv_x, slot, recv_counts) and combine of a fixed expert output."""
    x, idx, wts = _routing(0)
    cap = int(1.0 * T * K / E)
    y = np.random.default_rng(1).standard_normal((W, E_LOCAL, W * cap, H)).astype(np.float32)
    refs = {}
    for wd in WIRE_DTYPES:
        jb = JBuffer(jmesh, "dp", num_experts=E, num_selected=K, capacity_factor=1.0)
        recv, handle = jb.dispatch(x, idx, wts, wire_dtype=wd)
        out = jb.combine(y, handle, wire_dtype=wd)
        refs[wd] = dict(recv=np.asarray(recv), slot=np.asarray(handle.slot),
                        recv_counts=np.asarray(handle.recv_counts), out=np.asarray(out),
                        stats=jb.stats())
    return dict(x=x, idx=idx, wts=wts, y=y, cap=cap, refs=refs)


def _zipf_traffic(seed=3):
    idx = tsched.zipf_topk(np.random.default_rng(seed), W, T, K, E, alpha=1.2)
    return tsched.traffic_from_topk(idx, E, int(T * K / E), W)


@pytest.mark.parametrize("wire_dtype", WIRE_DTYPES)
@pytest.mark.parametrize("wire,n_chunks,a2a_sched", [
    ("lax", 1, "off"), ("lax", 2, "on"), ("pallas", 1, "off"), ("pallas", 2, "off"),
    ("pallas", 0, "off"), ("pallas", 1, "on"), ("pallas", 2, "on"), ("pallas", 0, "auto"),
    ("pallas", 1, "auto"),
])
def test_dispatch_and_combine_match_jax(tmesh, dispatched, wire, n_chunks, a2a_sched,
                                        wire_dtype):
    d = dispatched
    ref = d["refs"][wire_dtype]
    buf = Buffer(tmesh, "dp", num_experts=E, num_selected=K, capacity_factor=1.0,
                 wire="pallas" if wire == "pallas" else "auto", n_chunks=n_chunks,
                 a2a_sched=a2a_sched, a2a_traffic=_zipf_traffic())
    recv, handle = buf.dispatch(torch.tensor(d["x"]), torch.tensor(d["idx"]),
                                torch.tensor(d["wts"]), wire_dtype=wire_dtype)
    assert recv.shape == (W, E_LOCAL, W * d["cap"], H)
    _eq(recv, ref["recv"])
    _eq(handle.slot, ref["slot"])
    _eq(handle.recv_counts, ref["recv_counts"])
    assert (handle.wire, handle.wire_dtype) == (wire, wire_dtype)
    out = buf.combine(torch.tensor(d["y"]), handle, wire_dtype=wire_dtype)
    np.testing.assert_allclose(_np(out), ref["out"], **COMBINE_TOL)
    assert buf.stats()["dispatch"] == ref["stats"]["dispatch"]


@pytest.mark.parametrize("n_chunks,a2a_sched,traffic", [
    (2, "off", None), (0, "on", None), (0, "auto", "zipf"), (1, "auto", None),
    (2, "auto", "zipf")])
def test_handle_resolution_matches_jax_pallas_buffer(jmesh, tmesh, dispatched, n_chunks,
                                                     a2a_sched, traffic):
    """The JAX Buffer on its pallas wire (its kernels in the interpreter)
    and the port's resolve the same chunk depth and round-schedule choice,
    with the same bits."""
    d = dispatched
    mat = None if traffic is None else _zipf_traffic()
    kw = dict(num_experts=E, num_selected=K, capacity_factor=1.0, wire="pallas",
              n_chunks=n_chunks, a2a_sched=a2a_sched, a2a_traffic=mat)
    j_recv, jh = JBuffer(jmesh, "dp", **kw).dispatch(d["x"], d["idx"], d["wts"])
    t_recv, th = Buffer(tmesh, "dp", **kw).dispatch(torch.tensor(d["x"]),
                                                     torch.tensor(d["idx"]),
                                                     torch.tensor(d["wts"]))
    assert (th.wire, th.n_chunks, th.a2a_sched) == (jh.wire, jh.n_chunks, jh.a2a_sched)
    _eq(t_recv, np.asarray(j_recv))


def test_layout_matches_jax(jmesh, tmesh):
    _, idx, _ = _routing(4, none_share=0.1)
    want = JBuffer(jmesh, "dp", num_experts=E).get_dispatch_layout(idx)
    got = Buffer(tmesh, "dp", num_experts=E).get_dispatch_layout(torch.tensor(idx))
    for g, w in zip(got, want):
        _eq(g, np.asarray(w))
        assert g.shape == w.shape


@pytest.fixture(scope="module")
def ll_refs(jmesh):
    """JAX low-latency references on its dense wire, per wire dtype, with
    some "no expert" assignments and a pair capacity that drops rows."""
    x, idx, wts = _routing(5, none_share=0.15)
    y = np.random.default_rng(6).standard_normal((W, W * T * K, H)).astype(np.float32)
    refs = {}
    for wd in WIRE_DTYPES:
        for pcf in (None, 0.5):
            jb = JBuffer(jmesh, "dp", num_experts=E, num_selected=K)
            recv_x, counts, handle = jb.low_latency_dispatch(
                x, idx, T, wts, wire="dense", wire_dtype=wd, wire_fp8=wd is not None,
                pair_capacity_factor=pcf)
            r_max = recv_x.shape[1]
            out = jb.low_latency_combine(y[:, :r_max], handle)
            refs[wd, pcf] = dict(recv_x=np.asarray(recv_x), counts=np.asarray(counts),
                                 handle=handle, out=np.asarray(out), stats=jb.stats())
    return dict(x=x, idx=idx, wts=wts, y=y, refs=refs)


@pytest.mark.parametrize("wire_dtype", WIRE_DTYPES)
@pytest.mark.parametrize("pcf", [None, 0.5])
@pytest.mark.parametrize("wire,n_chunks", [("dense", 1), ("ragged", 1), ("pallas", 1),
                                           ("pallas", 2), ("pallas", 0)])
def test_low_latency_verbs_match_jax(tmesh, ll_refs, wire, n_chunks, pcf, wire_dtype):
    d = ll_refs
    ref = d["refs"][wire_dtype, pcf]
    buf = Buffer(tmesh, "dp", num_experts=E, num_selected=K)
    recv_x, counts, handle = buf.low_latency_dispatch(
        torch.tensor(d["x"]), torch.tensor(d["idx"]), T, torch.tensor(d["wts"]), wire=wire,
        wire_dtype=wire_dtype, wire_fp8=wire_dtype is not None, n_chunks=n_chunks,
        pair_capacity_factor=pcf)
    _eq(recv_x, ref["recv_x"])
    _eq(counts, ref["counts"])
    jh = ref["handle"]
    for name in ("send_mat", "recv_mat"):
        _eq(getattr(handle, name), np.asarray(getattr(jh, name)))
    # the ragged wire's rows are packed, not per-pair chunks: its slots,
    # offsets and regroup permutation differ from the dense layout's by
    # design (its recv_x and counts above may not)
    if wire != "ragged":
        for name in ("send_slot", "src_in_offsets", "regroup"):
            _eq(getattr(handle, name), np.asarray(getattr(jh, name)))
    assert (handle.wire, handle.wire_dtype, handle.wire_fp8) == (wire, wire_dtype,
                                                                 wire_dtype == "fp8")
    r_max = recv_x.shape[1]
    out = buf.low_latency_combine(torch.tensor(d["y"][:, :r_max]), handle)
    np.testing.assert_allclose(_np(out), ref["out"], **LL_TOL)
    assert buf.stats()["low_latency"] == ref["stats"]["low_latency"]


def test_low_latency_hook_and_event(tmesh):
    x, idx, wts = _routing(7)
    buf = Buffer(tmesh, "dp", num_experts=E)
    recv_x, counts, handle, ev, hook = buf.low_latency_dispatch(
        torch.tensor(x), torch.tensor(idx), async_finish=True, return_recv_hook=True)
    assert isinstance(ev, EventOverlap) and ev.event is None  # CPU: holds the tensors
    hook()
    ev.current_stream_wait()
    out, ev2, hook2 = buf.low_latency_combine(recv_x, handle, previous_event=ev,
                                              return_recv_hook=True)
    assert ev2 is None and out.shape == (W, T, H)
    hook2()


def _layer_params(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((W, T, H)).astype(dtype)
    logits = rng.standard_normal((W, T, E)).astype(np.float32)
    wg, wu = ((rng.standard_normal((W, E_LOCAL, H, F)) / np.sqrt(H)).astype(dtype)
              for _ in range(2))
    wd = (rng.standard_normal((W, E_LOCAL, F, H)) / np.sqrt(F)).astype(dtype)
    return x, logits, wg, wu, wd


def _jax_layer(devices, args, **kw):
    mesh = Mesh(np.array(devices[:W]), ("ep",))

    def f(x, lg, wg, wu, wd):
        out, aux, z = jops.moe_ffn(x[0], lg[0], wg[0], wu[0], wd[0], "ep", **kw)
        return out[None], aux[None], z[None]

    mapped = shard_map(f, mesh=mesh, in_specs=(P("ep"),) * 5, out_specs=(P("ep"),) * 3,
                       check_vma=False)
    return [np.asarray(a) for a in jax.jit(mapped)(*args)]


@pytest.mark.parametrize("impl", ["sort", "dense", "ll"])
def test_moe_ffn_at_world_w_matches_jax(devices, impl):
    args = _layer_params(8)
    want = _jax_layer(devices, args, impl=impl, capacity_factor=1.0)
    targs = [torch.tensor(a) for a in args]
    out, aux, z = tops.moe_ffn(*targs, "dp", impl=impl, capacity_factor=1.0)
    assert out.shape == (W, T, H) and aux.shape == z.shape == (W,)
    tol = LL_TOL if impl == "ll" else COMBINE_TOL
    np.testing.assert_allclose(_np(out), want[0], **tol)
    np.testing.assert_allclose(_np(aux), want[1], rtol=1e-6)
    np.testing.assert_allclose(_np(z), want[2], rtol=1e-6)
    # every wire, depth and wire dtype: the lax wire's bits, or for the
    # quantized wire the JAX layer's own (jitted codec) within tolerance
    for kw in (dict(wire="pallas"), dict(wire="pallas", n_chunks=2),
               dict(wire="pallas", n_chunks=0)):
        got = tops.moe_ffn(*targs, "dp", impl=impl, capacity_factor=1.0, **kw)[0]
        np.testing.assert_allclose(_np(got), _np(out), rtol=1e-6, atol=1e-7)
    for wd in ("fp8", "int8"):
        want_q = _jax_layer(devices, args, impl=impl, capacity_factor=1.0, wire_dtype=wd)[0]
        got = tops.moe_ffn(*targs, "dp", impl=impl, capacity_factor=1.0, wire="pallas",
                           wire_dtype=wd)[0]
        np.testing.assert_allclose(_np(got), want_q, **(LL_TOL if impl == "ll" else
                                                        COMBINE_TOL))


@pytest.mark.parametrize("impl", ["sort", "dense", "ll"])
def test_sharding_is_semantics_free(impl):
    """Per member, the world-W layer equals the world-1 layer on that
    member's tokens with every expert's weights (the same routing, the same
    capacity per source): sharding moves rows, never changes the math. The
    low-latency path's pair capacity scales with 1/W by design, so it is
    held at a lossless factor."""
    x, logits, wg, wu, wd = (torch.tensor(a) for a in _layer_params(9))
    cf = float(W) if impl == "ll" else 1.25
    got, aux, z = tops.moe_ffn(x, logits, wg, wu, wd, "dp", impl=impl, wire="pallas",
                               capacity_factor=cf)
    full = [t.reshape(E, *t.shape[2:]) for t in (wg, wu, wd)]
    for r in range(W):
        want, a1, z1 = tops.moe_ffn(x[r], logits[r], *full, impl=impl, capacity_factor=cf)
        np.testing.assert_allclose(_np(got[r]), _np(want), **LAYER_TOL)
        assert aux[r].item() == a1.item() and z[r].item() == z1.item()


def test_chunked_layer_equals_unchunked():
    """The chunk pipeline pads the wire only: the same drops, the same
    result as the phased layer, at a capacity no depth divides."""
    x, logits, wg, wu, wd = (torch.tensor(a) for a in _layer_params(10))
    want = tops.moe_ffn(x, logits, wg, wu, wd, "dp", capacity_factor=0.9, wire="pallas")[0]
    for n in (2, 3, 7):
        got = tops.moe_ffn(x, logits, wg, wu, wd, "dp", capacity_factor=0.9, wire="pallas",
                           n_chunks=n)[0]
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-7)
    plan = tops.SlotPlan(*[torch.zeros(W, E * 7, dtype=torch.int32)] * 2,
                         torch.zeros(W, E, dtype=torch.int32))
    assert tops.SlotPlan(plan.token_for_slot, plan.slot, plan.kept) \
        .chunk_token_for_slot(E, 3, T).shape == (3, W, E, 3)


def test_chunk_and_quant_resolution_match_jax():
    """resolve_chunks, wire_itemsize, ll_bounds and resolve_ll_chunks are
    the JAX package's arithmetic; the auto depth grows with the exchange."""
    from uccl_tpu.ep import ll as jll

    # where the JAX interpreter's 64 KiB ceiling passes (the port's budget
    # decides for CPU tensors only, against its own arena)
    for args in [(2, "pallas", 4, 5, 2, 128, 4), (0, "pallas", 4, 1, 2, 128, 4),
                 (3, "lax", 4, 16, 2, 128, 4), (0, "pallas", 4, 40, 2, 64, 2),
                 (8, "pallas", 8, 6, 1, 64, 2), (0, "pallas", 1, 6, 8, 64, 2)]:
        assert tops.resolve_chunks(*args, device="cpu") == jops.resolve_chunks(*args)
    # the EP cell's dispatch buffer: auto is 8 on the card, whatever the arena
    dma.MAX_ARENA_BYTES.set(1 << 20)
    try:
        chip = (0, "pallas", 4, 2560, 2, 1024, 2)
        before = dma.WIRE_FALLBACK.get(what="ep_moe_chunked", reason="arena_budget")
        assert tops.resolve_chunks(*chip, device="cuda") == 8
        assert tops.resolve_chunks(*chip, device="cpu") == 1
        assert dma.WIRE_FALLBACK.get(what="ep_moe_chunked", reason="arena_budget") == before + 1
    finally:
        dma.MAX_ARENA_BYTES.set(None)
    for h, dt, jdt in [(128, torch.bfloat16, jnp.bfloat16), (12, torch.float32, jnp.float32),
                       (1024, torch.int32, jnp.int32)]:
        for wd in ("fp8", None):
            assert tops.wire_itemsize(False, h, dt, wire_dtype=wd) == \
                jops.wire_itemsize(False, h, jdt, wire_dtype=wd)
    for args in [(16, 2, 2, 4, None), (16, 2, 2, 4, 4), (128, 2, 2, 4, 128, 0.5),
                 (8, 8, 1, 8, None, 1.0)]:
        assert tll.ll_bounds(*args) == jll.ll_bounds(*args)
    for args in [(0, "pallas", 4, 32), (3, "pallas", 4, 2), (2, "dense", 4, 32),
                 (0, "pallas", 4, 1)]:
        assert tll.resolve_ll_chunks(*args) == jll.resolve_ll_chunks(*args)


PLAN_CASES = [  # (payload_shape, world, skew, n_rounds, wire_dtype, n_chunks, cep)
    ((4, 2, 4, 128), 4, 1.0, 3, None, 1, None),
    ((4, 2, 4, 128), 4, 2.6, 3, None, 1, None),
    ((4, 2, 4, 128), 4, 2.6, 5, "fp8", 1, None),
    ((4, 2, 2560, 1024), 4, 1.7, 3, None, 1, None),
    ((4, 2, 2560, 1024), 4, 1.7, 4, "int8", 8, 163840),
    ((4, 2, 16, 64), 4, 3.0, 5, None, 2, None),
    ((8, 1, 16, 64), 8, 3.0, 9, None, 1, None),
    ((4, 2, 40, 64), 4, 2.0, 3, None, 1, None),  # over the 64 KiB probe
    ((2, 1, 8, 8), 1, 5.0, None, None, 1, None),
]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_ep_a2a_matches_jax(case):
    """The planner's EP decisions are the JAX package's on the same inputs
    (its probe's ceiling is the interpreter's 64 KiB on the CPU, so the
    port's arena budget is set to it here; the interpreter also charges a
    chunk pipeline one kernel's buffers where the port charges both
    resident kernels', as the JAX package does on a TPU, so the chunked
    case sits under both charges)."""
    shape, world, skew, rounds, wd, n_chunks, cep = case
    dma.MAX_ARENA_BYTES.set(64 << 10)
    try:
        for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            kw = dict(skew=skew, n_rounds=rounds, wire_dtype=wd, n_chunks=n_chunks,
                      chunk_elems_per_peer=cep, emit=False)
            got = tplan.get_planner().plan_ep_a2a(shape, dt, world, **kw)
            want = jplan.get_planner().plan_ep_a2a(shape, jdt, world, **kw)
            assert (got.algo, got.chunks, got.wire_bytes, got.outcome, got.verb) == \
                (want.algo, want.chunks, want.wire_bytes, want.outcome, want.verb)
            assert got.predicted_us == pytest.approx(want.predicted_us, rel=1e-12)
    finally:
        dma.MAX_ARENA_BYTES.set(None)
    for nbytes in (1 << 10, 1 << 18, 1 << 20, 41_943_040, 1 << 30):
        for cap in (1, 3, 2560):
            assert tplan.get_planner().ep_auto_depth(nbytes, cap) == \
                jplan.get_planner().ep_auto_depth(nbytes, cap)


def test_explicit_sched_plan_and_chunk_records_match_jax():
    t0 = tplan.PLAN_TOTAL.get(algo="ep_sched", chunks=1, wire_dtype="fp8", outcome="explicit",
                              verb="ep_a2a")
    p = tplan.get_planner().plan_explicit("ep_sched", (4, 2, 8, 128), torch.bfloat16, 4,
                                          wire_dtype="fp8", verb="ep_a2a")
    j = jplan.get_planner().plan_explicit("ep_sched", (4, 2, 8, 128), jnp.bfloat16, 4,
                                          wire_dtype="fp8", verb="ep_a2a", emit=False)
    assert (p.algo, p.chunks, p.wire_bytes, p.predicted_us) == \
        (j.algo, j.chunks, j.wire_bytes, j.predicted_us)
    assert tplan.PLAN_TOTAL.get(algo="ep_sched", chunks=1, wire_dtype="fp8",
                                outcome="explicit", verb="ep_a2a") == t0 + 1
    for auto in (True, False):
        key = dict(algo="ep_a2a", chunks=4, wire_dtype="none",
                   outcome="model" if auto else "explicit")
        before = tplan.PLAN_TOTAL.get(**key)
        assert tplan.get_planner().record_ep_chunks(4, wire="pallas", auto=auto) == 4
        assert tplan.PLAN_TOTAL.get(**key) == before + 1


def test_wire_bytes_counted_as_in_jax(jmesh, tmesh):
    """``ep_bytes_total`` gets the same bytes per verb call in both
    packages (the quantized payload plus its scales)."""
    x, idx, wts = _routing(11)
    for wd in ("fp8", None):
        labels = dict(verb="dispatch", wire="lax", wire_dtype=wd or "none")
        j0, t0 = J_EP_BYTES.get(**labels), EP_BYTES.get(**labels)
        JBuffer(jmesh, "dp", num_experts=E).dispatch(x, idx, wts, wire_dtype=wd)
        Buffer(tmesh, "dp", num_experts=E).dispatch(torch.tensor(x), torch.tensor(idx),
                                                    torch.tensor(wts), wire_dtype=wd)
        assert EP_BYTES.get(**labels) - t0 == J_EP_BYTES.get(**labels) - j0 > 0


def test_configs_and_capacity_match_jax(jmesh, tmesh):
    for n in (2, 8, 16, 64):
        for name in ("get_dispatch_config", "get_combine_config"):
            got, want = getattr(Buffer, name)(n), getattr(JBuffer, name)(n)
            assert got.__dict__ == want.__dict__
    jb = JBuffer(jmesh, "dp", num_experts=E, capacity_factor=1.3)
    tb = Buffer(tmesh, "dp", num_experts=E, capacity_factor=1.3)
    assert [tb.capacity(t) for t in (1, 7, 16, 8192)] == [jb.capacity(t) for t in
                                                         (1, 7, 16, 8192)]
    assert (tb.world, tb.num_local_experts) == (jb.world, jb.num_local_experts)


def test_config_fills_unset_knobs_and_overlap_rules(tmesh):
    x, idx, wts = _routing(12)
    xt, it = torch.tensor(x), torch.tensor(idx)
    buf = Buffer(tmesh, "dp", num_experts=E)
    recv, h = buf.dispatch(xt, it, config=Config(wire="pallas", n_chunks=2, wire_dtype="int8"))
    assert (h.wire, h.n_chunks, h.wire_dtype) == ("pallas", 2, "int8")
    recv2, h2, ev = buf.dispatch(xt, it, wire_dtype="fp8", async_finish=True,
                                 config=Config(wire_dtype="int8"))
    assert h2.wire_dtype == "fp8" and ev.event is None
    out, ev2 = buf.combine(recv2.float(), h2, previous_event=ev, async_finish=True,
                           allocate_on_comm_stream=True)
    assert out.shape == (W, T, H) and ev2.tensors is out
    with pytest.raises(ValueError, match="allocate_on_comm_stream"):
        buf.dispatch(xt, it, allocate_on_comm_stream=True)
    with pytest.raises(ValueError, match="allocate_on_comm_stream"):
        buf.combine(recv, h, async_finish=True, allocate_on_comm_stream=True)


def test_buffer_argument_errors(tmesh):
    with pytest.raises(ValueError, match="divide"):
        Buffer(tmesh, "dp", num_experts=6)
    with pytest.raises(ValueError, match="wire"):
        Buffer(tmesh, "dp", num_experts=8, wire="tcp")
    with pytest.raises(ValueError, match="n_chunks"):
        Buffer(tmesh, "dp", num_experts=8, n_chunks=-1)
    with pytest.raises(ValueError, match="a2a_sched"):
        Buffer(tmesh, "dp", num_experts=8, a2a_sched="maybe")
    with pytest.raises(ValueError, match="axis"):
        Buffer(tmesh, "ep", num_experts=8)


def test_sched_off_the_pallas_wire_is_counted_once(tmesh):
    x, idx, wts = _routing(13)
    buf = Buffer(tmesh, "dp", num_experts=E, a2a_sched="on")
    before = dma.WIRE_FALLBACK.get(what="ep_a2a_sched", reason="wire")
    for _ in range(3):
        _, h = buf.dispatch(torch.tensor(x), torch.tensor(idx))
        assert not h.a2a_sched
    assert dma.WIRE_FALLBACK.get(what="ep_a2a_sched", reason="wire") == before + 1


def test_quantized_wire_falls_back_for_int_and_narrow_payloads():
    before = {r: dma.WIRE_FALLBACK.get(what="ep_wire_quant", reason=r)
              for r in ("quant_dtype", "block_too_small")}
    xi = torch.arange(W * W * 2 * 8, dtype=torch.int32).reshape(W, W, 2, 8)
    assert torch.equal(tops._wire_all_to_all(xi, False, 128, xi.dtype, "pallas",
                                             wire_dtype="fp8"), xi.transpose(0, 1))
    xn = torch.randn(W, W, 2, 7)  # 7 admits no block >= 8
    assert torch.equal(tops._wire_all_to_all(xn, False, 128, xn.dtype, "lax", wire_dtype="int8"),
                       xn.transpose(0, 1))
    assert {r: dma.WIRE_FALLBACK.get(what="ep_wire_quant", reason=r) - before[r]
            for r in before} == {"quant_dtype": 1, "block_too_small": 1}


def test_scheduled_combine_uses_the_transposed_matrix(tmesh):
    """A skewed matrix schedules dispatch on its own rounds and combine on
    the transpose's; both reproduce the unscheduled bits."""
    x, idx, wts = _routing(14)
    mat = np.zeros((W, W))
    mat[:, 0] = 5.0
    mat[0, 1] = 1.0
    kw = dict(num_experts=E, wire="pallas")
    plain = Buffer(tmesh, "dp", **kw)
    sched = Buffer(tmesh, "dp", a2a_sched="on", a2a_traffic=mat, **kw)
    args = (torch.tensor(x), torch.tensor(idx), torch.tensor(wts))
    (r0, h0), (r1, h1) = plain.dispatch(*args), sched.dispatch(*args)
    assert h1.a2a_sched and torch.equal(r0, r1)
    assert torch.equal(plain.combine(r0, h0), sched.combine(r1, h1))
    keys = [k for k in sched._resolve_memo if k[0] == "a2a_sched"]
    assert sorted(k[2] for k in keys) == ["combine", "dispatch"]
    d_rounds = sched._resolve_memo[[k for k in keys if k[2] == "dispatch"][0]][0]
    c_rounds = sched._resolve_memo[[k for k in keys if k[2] == "combine"][0]][0]
    assert [r.perm for r in d_rounds] == [r.perm for r in jsched.wire_schedule(mat, W)[0]]
    assert [r.perm for r in c_rounds] == [r.perm for r in jsched.wire_schedule(mat.T, W)[0]]


def test_verbs_trace_wire_spans_and_feed_the_flight_recorder(tmesh, tmp_path):
    """Each verb opens an ``ep.<verb>`` span on the tracer's wire track (the
    copied obs/tracer.py), and a Buffer's host state lands in a flight
    bundle (the copied obs/flight.py), as in the JAX package."""
    import json

    from uccl_tpu_torch.obs import flight, tracer

    x, idx, wts = _routing(15)
    tr = tracer.enable()
    rec = flight.enable(str(tmp_path))
    try:
        buf = Buffer(tmesh, "dp", num_experts=E, wire="pallas", wire_dtype="int8")
        recv, h = buf.dispatch(torch.tensor(x), torch.tensor(idx), torch.tensor(wts))
        buf.combine(recv, h)
        spans = [e for e in tr.events() if e.track == "wire"]
        assert [e.name for e in spans] == ["ep.dispatch", "ep.combine"]
        assert spans[0].args["wire"] == "pallas" and spans[0].args["wire_dtype"] == "int8"
        assert spans[0].args["bytes"] == tops.wire_bytes_of(x.shape, torch.float32, "int8")
        path = rec.trigger("step_stall", key="ep")
        state = json.loads(open(path).read())["state"]["ep_buffer"]
        assert state["ops"]["dispatch"] == 1 and state["world"] == W
        assert "ep_bytes_total" in json.loads(open(path).read())["metrics_prom"]
    finally:
        tracer.disable()
        flight.disable()
