"""uccl_tpu_torch's MoE serving stack (models/moe_inference.py) against the
JAX package's, on the same weights carried through numpy.

The JAX servers run on 1, 2 and 4 virtual CPU devices; the port's on 1, 2
and 4 members of one CPU device. The ``pallas`` wire runs the JAX
package's Pallas all-to-all in interpret mode and the port's plain version
of B9. Tokens (greedy and sampled) must be identical; logits are held to
tests/test_dense_inference.py's rtol 1e-4 / atol 1e-5, the KV rows the same.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from uccl_tpu.models import moe_inference as jmoe
from uccl_tpu.serving.sampling import SamplingParams as JSampling
from uccl_tpu_torch.models import moe_inference as tmoe
from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from uccl_tpu_torch.serving.sampling import SamplingParams

SIZES = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8,
             moe_experts=8, moe_topk=2, moe_ffn=64)
RTOL, ATOL = 1e-4, 1e-5
MAX_SEQ = 24


@pytest.fixture(scope="module")
def weights():
    jp = jmoe.init_params(jax.random.PRNGKey(0), jmoe.MoEServeConfig(**SIZES))
    return jp, jax.tree.map(np.asarray, jp)


def _servers(devices, world, wire):
    jsrv = jmoe.MoEServer(jmoe.MoEServeConfig(**SIZES, moe_wire=wire),
                          Mesh(np.array(devices[:world]), ("dp",)))
    tsrv = tmoe.MoEServer(tmoe.MoEServeConfig(**SIZES, moe_wire=wire),
                          make_mesh(MeshConfig(dp=world), "cpu", world))
    return jsrv, tsrv


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


# the JAX pallas wire is its interpreter: sampled generation (a second
# compiled program) rides the lax wire
@pytest.mark.parametrize("world,wire,sampled", [(1, "lax", True), (2, "pallas", False),
                                                (4, "pallas", False), (4, "lax", True)])
def test_generate_identical_to_jax(devices, weights, world, wire, sampled):
    jp, npt = weights
    jsrv, tsrv = _servers(devices, world, wire)
    prompt = np.random.default_rng(world).integers(0, 64, (world, 2, 7)).astype(np.int32)
    jplaced = jsrv.shard_params(jp)
    tplaced = tsrv.shard_params(tmoe.params_from_jax(npt, "cpu"))
    jl, jc = jsrv.prefill(jplaced, jnp.asarray(prompt), MAX_SEQ)
    tl, tc = tsrv.prefill(tplaced, prompt, MAX_SEQ)
    _close(tl, jl)
    # the port's caches are [L, W, B_loc, ...], the JAX package's [W, L, B_loc, ...]
    _close(tc.k.transpose(0, 1), jc.k)
    kw = dict(temperature=0.9, top_p=0.9, top_k=20, seed=7)
    want = jsrv.generate(jplaced, jnp.asarray(prompt), 4, MAX_SEQ,
                         sampling=JSampling(**kw) if sampled else None)
    got = tsrv.generate(tplaced, prompt, 4, MAX_SEQ,
                        sampling=SamplingParams(**kw) if sampled else None)
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == np.asarray(want).tolist()


def test_sharding_is_semantics_free_in_the_port(weights):
    """The same weights as 1 member and as 4 members give the same tokens,
    greedy and sampled, on both wires and both decode paths."""
    _, npt = weights
    prompt = np.random.default_rng(3).integers(0, 64, (8, 9)).astype(np.int32)
    outs = {}
    for world, wire, impl in ((1, "lax", "sort"), (4, "lax", "ll"), (4, "pallas", "ll"),
                              (4, "pallas", "sort")):
        srv = tmoe.MoEServer(tmoe.MoEServeConfig(**SIZES, moe_wire=wire),
                             make_mesh(MeshConfig(dp=world), "cpu", world))
        placed = srv.shard_params(tmoe.params_from_jax(npt, "cpu"))
        p = prompt.reshape(world, 8 // world, 9)
        for sp in (None, SamplingParams(temperature=0.8, top_k=10, seed=2)):
            toks = srv.generate(placed, p, 6, MAX_SEQ, impl=impl, sampling=sp)
            outs.setdefault(sp is None, []).append(toks.reshape(8, 6).tolist())
    for runs in outs.values():
        assert all(r == runs[0] for r in runs)


def test_slot_primitives_identical_to_jax(devices, weights):
    """prefill_slots (offsets, a masked idle slot, sampled rows), then
    decode_step_slots on the LL path, at EP world 2 (on the lax wire: the
    pallas wire's exchanges are held by test_generate_identical_to_jax)."""
    jp, npt = weights
    jsrv, tsrv = _servers(devices, 2, "lax")
    jplaced = jsrv.shard_params(jp)
    tplaced = tsrv.shard_params(tmoe.params_from_jax(npt, "cpu"))
    jc = jsrv.slot_cache(2, MAX_SEQ)
    tc = tsrv.slot_cache(2, MAX_SEQ)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, 64, (2, 2, 10)).astype(np.int32)
    lens = np.array([[10, 7], [9, 1]], np.int32)
    mask = np.array([[True, True], [True, False]])
    samp = tuple(np.asarray(a).reshape(2, 2) for a in (
        np.array([3, 0, 4, 0], np.int32), np.zeros(4, np.int32),
        np.array([0.9, 0.0, 0.7, 0.0], np.float32), np.array([0.9, 1, 1, 1], np.float32),
        np.array([20, 0, 0, 0], np.int32)))
    for start in (0, 5):
        window = prompts[..., start:start + 5]
        st = np.full((2, 2), start, np.int32)
        jt, jc = jsrv.prefill_slots(jplaced, jnp.asarray(window), jnp.asarray(lens),
                                    jnp.asarray(mask), jc, start=jnp.asarray(st),
                                    sampling=tuple(map(jnp.asarray, samp)))
        tt, tc = tsrv.prefill_slots(tplaced, window, lens, mask, tc, start=st, sampling=samp)
        assert (tt.numpy()[mask] == np.asarray(jt)[mask]).all()
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [[10, 7], [9, 0]]
    _close(tc.k.transpose(0, 1), jc.k)
    active = mask.copy()
    tok = np.asarray(jt)
    for _ in range(2):
        jt, jc = jsrv.decode_step_slots(jplaced, jnp.asarray(tok), jnp.asarray(active), jc,
                                        sampling=tuple(map(jnp.asarray, samp)))
        tt, tc = tsrv.decode_step_slots(tplaced, tok, active, tc, sampling=samp)
        assert (tt.numpy()[active] == np.asarray(jt)[active]).all()
        tok = np.asarray(jt)
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist()
    _close(tc.v.transpose(0, 1), jc.v)
    for a, b in zip(tc.export_rows(2, 0, 9), jc.export_rows(2, 0, 9)):
        _close(a, b)


def test_slot_rows_move_like_jax(devices):
    jsrv, tsrv = _servers(devices, 2, "lax")
    jc, tc = jsrv.slot_cache(2, 8), tsrv.slot_cache(2, 8)
    k = np.random.default_rng(1).standard_normal((2, 5, 2, 8)).astype(np.float32)
    jc, tc = jc.import_rows(3, k, -k, length=5), tc.import_rows(3, k, -k, length=5)
    jc, tc = jc.copy_prefix(0, 3, 4), tc.copy_prefix(0, 3, 4)
    assert np.array_equal(tc.k.transpose(0, 1).numpy(), np.asarray(jc.k))
    assert np.array_equal(tc.v.transpose(0, 1).numpy(), np.asarray(jc.v))
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist()


def test_slot_serving_needs_a_drop_free_wire_and_a_dividing_world():
    cfg = tmoe.MoEServeConfig(**SIZES, capacity_factor=1.0)
    srv = tmoe.MoEServer(cfg, make_mesh(MeshConfig(dp=2), "cpu", 2))
    with pytest.raises(ValueError, match="drop-free"):
        srv.slot_cache(1, 8)
    with pytest.raises(ValueError, match="must divide"):
        tmoe.MoEServer(tmoe.MoEServeConfig(**SIZES), make_mesh(MeshConfig(dp=3), "cpu", 3))
