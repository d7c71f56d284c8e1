"""uccl_tpu_torch.models.flagship (and dense) at world > 1, every member on the
CPU, against the JAX package's sharded models on the conftest's 8 virtual
devices, at the three meshes of tests/test_flagship.py and its config
(capacity factor E/k: nothing drops).

Weights come from the JAX init through params_from_jax; tokens and targets
from a seeded numpy generator. Tolerances, each tighter than
tests/test_flagship.py's (2e-3 logits; 5e-3 / 1e-4 gradients; 1F1B 1e-5 loss
and 5e-3 / 1e-5 gradients): logits rtol 1e-4 / atol 1e-5, losses rtol 1e-5,
gradients rtol 1e-3 / atol 1e-5, 1F1B against GPipe rtol 1e-3 / atol 1e-6.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from uccl_tpu.models import dense as jd
from uccl_tpu.models import flagship as jf
from uccl_tpu.parallel.mesh import MeshConfig as JMeshConfig
from uccl_tpu.parallel.mesh import make_mesh as j_make_mesh
from uccl_tpu_torch.models import dense as td
from uccl_tpu_torch.models import flagship as tf
from uccl_tpu_torch.ops import flash_attention as fa
from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh

SIZE = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8, moe_experts=4,
            moe_topk=2, moe_ffn=32, capacity_factor=2.0, n_microbatches=2,
            aux_loss_weight=0.01, z_loss_weight=1e-3)
MESHES = {
    "pp2_dp2_tp2": dict(pp=2, dp=2, cp=1, tp=2),
    "dp2_cp2_tp2": dict(pp=1, dp=2, cp=2, tp=2),
    "pp2_cp2_tp2": dict(pp=2, dp=1, cp=2, tp=2),
}
B, S = 4, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small tensors: in the parallel
    test run every worker's torch would otherwise start a thread per core
    and the workers' threads contend; and with one there is no fresh
    worker thread whose first exp/log can be off by ~1e-4 (ROADMAP C8)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, SIZE["vocab"], (B, S)).astype(np.int32)
    targets = rng.integers(0, SIZE["vocab"], (B, S)).astype(np.int32)
    params = jax.tree.map(np.asarray, jf.init_params(jax.random.PRNGKey(1),
                                                     jf.FlagshipConfig(**SIZE)))
    return params, tokens, targets


def _jax_mesh(devices, name):
    return j_make_mesh(JMeshConfig(**MESHES[name]), devices)


def _mesh(name):
    return make_mesh(MeshConfig(**MESHES[name]), "cpu")


@pytest.fixture(scope="module", params=list(MESHES))
def jax_run(request, devices, data):
    params, tokens, targets = data
    name = request.param
    cfg = jf.FlagshipConfig(**SIZE)
    mesh = _jax_mesh(devices, name)
    gp = jf.shard_params(params, mesh, cfg)
    logits = jax.jit(lambda p, t: jf.forward(p, t, cfg, mesh))(gp, tokens)
    (total, ce), grads = jax.jit(jax.value_and_grad(
        lambda p: jf.loss_fn(p, tokens, targets, cfg, mesh), has_aux=True))(gp)
    return dict(name=name, logits=np.asarray(logits), total=float(total), ce=float(ce),
                grads=_leaves(jax.tree.map(np.asarray, grads)))


def _grads(params, tokens, targets, cfg, mesh):
    tp = tf.params_from_jax(params, "cpu")
    leaves = tf.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_()
    total, ce = tf.loss_fn(tp, tokens, targets, cfg, mesh)
    names = _leaves(tf.params_to_numpy(tp))  # tree_leaves' key order
    return total.item(), ce.item(), dict(zip(names, (g.numpy() for g in
                                                     torch.autograd.grad(total, leaves))))


def test_forward_matches_jax(data, jax_run):
    params, tokens, _ = data
    got = tf.forward(tf.params_from_jax(params, "cpu"), tokens, tf.FlagshipConfig(**SIZE),
                     _mesh(jax_run["name"]))
    np.testing.assert_allclose(got.detach().numpy(), jax_run["logits"], rtol=1e-4, atol=1e-5)


def test_loss_and_grads_match_jax(data, jax_run):
    params, tokens, targets = data
    total, ce, grads = _grads(params, tokens, targets, tf.FlagshipConfig(**SIZE),
                              _mesh(jax_run["name"]))
    np.testing.assert_allclose(total, jax_run["total"], rtol=1e-5)
    np.testing.assert_allclose(ce, jax_run["ce"], rtol=1e-5)
    assert grads.keys() == jax_run["grads"].keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g, jax_run["grads"][name], rtol=1e-3, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("name,kw", [
    ("pp2_dp2_tp2", {}),
    ("dp2_cp2_tp2", {}),
    ("pp2_cp2_tp2", {}),
    ("pp2_dp2_tp2", {"moe_impl": "ll"}),
    ("dp2_cp2_tp2", {"seq_mode": "ulysses"}),
    ("pp2_cp2_tp2", {"attn_impl": "xla"}),
], ids=["pp2_dp2_tp2", "dp2_cp2_tp2", "pp2_cp2_tp2", "ll_moe", "ulysses", "xla_ring"])
def test_1f1b_matches_gpipe(data, name, kw):
    """pp_schedule="1f1b": the manual schedule's loss and gradients against
    autograd through GPipe (tests/test_flagship.py's TestManualSchedule)."""
    params, tokens, targets = data
    cfg = tf.FlagshipConfig(**SIZE, **kw)
    mesh = _mesh(name)
    want_total, _, want = _grads(params, tokens, targets, cfg, mesh)
    total, ce, grads = tf.manual_loss_and_grads(tf.params_from_jax(params, "cpu"), tokens,
                                                targets, cfg, mesh)
    np.testing.assert_allclose(total.item(), want_total, rtol=1e-5)
    for key, g in _leaves(tf.params_to_numpy(grads)).items():
        np.testing.assert_allclose(g, want[key], rtol=1e-3, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("kw", [{"moe_impl": "ll"}, {"seq_mode": "ulysses"},
                                {"wire_dtype": "int8"}],
                         ids=["ll_moe", "ulysses", "int8_wire"])
def test_options_match_jax(devices, data, kw):
    """moe_impl="ll", Ulysses and a quantized EP wire at dp=2, cp=2, tp=2
    against the JAX model with the same option."""
    params, tokens, _ = data
    cfg = jf.FlagshipConfig(**SIZE, **kw)
    mesh = _jax_mesh(devices, "dp2_cp2_tp2")
    want = np.asarray(jax.jit(lambda p, t: jf.forward(p, t, cfg, mesh))(
        jf.shard_params(params, mesh, cfg), tokens))
    got = tf.forward(tf.params_from_jax(params, "cpu"), tokens, tf.FlagshipConfig(**SIZE, **kw),
                     _mesh("dp2_cp2_tp2"))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kw", [{}, {"moe_chunks": 2}], ids=["depth_auto", "depth_2"])
def test_pallas_wire_equals_lax(data, kw):
    """moe_wire="pallas" (B9's plain version on the CPU) gives the lax wire's
    logits bit for bit."""
    params, tokens, _ = data
    tp, mesh = tf.params_from_jax(params, "cpu"), _mesh("dp2_cp2_tp2")
    with torch.no_grad():
        lax_ = tf.forward(tp, tokens, tf.FlagshipConfig(**SIZE), mesh)
        pallas = tf.forward(tp, tokens, tf.FlagshipConfig(**SIZE, moe_wire="pallas", **kw), mesh)
    assert torch.equal(pallas, lax_)


@pytest.mark.parametrize("name,launches", [("dp2_cp2_tp2", 8), ("pp2_cp2_tp2", 6),
                                           ("pp2_dp2_tp2", 3)])
def test_one_flash_launch_per_ring_step(monkeypatch, data, name, launches):
    """A forward launches the flash forward once per ring step of each layer
    call, all members in the launch: layers/pp x (M + pp - 1) x cp."""
    params, tokens, _ = data
    calls = []
    real = fa.flash_attention_lse
    monkeypatch.setattr(fa, "flash_attention_lse",
                        lambda *a, **k: calls.append(a[0].shape[0]) or real(*a, **k))
    with torch.no_grad():
        tf.forward(tf.params_from_jax(params, "cpu"), tokens, tf.FlagshipConfig(**SIZE),
                   _mesh(name))
    assert len(calls) == launches


def test_dense_matches_jax(devices):
    """The dense model at pp=2, cp=2, tp=2: logits, loss and gradients."""
    size = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8, ffn=48,
                n_microbatches=2)
    cfg = jd.DenseConfig(**size)
    params = jax.tree.map(np.asarray, jd.init_params(jax.random.PRNGKey(3), cfg))
    rng = np.random.default_rng(3)
    tokens, targets = (rng.integers(0, 64, (B, S)).astype(np.int32) for _ in range(2))
    mesh = _jax_mesh(devices, "pp2_cp2_tp2")
    gp = jd.shard_params(params, mesh, cfg)
    want_logits = np.asarray(jax.jit(lambda p, t: jd.forward(p, t, cfg, mesh))(gp, tokens))
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p: jd.loss_fn(p, tokens, targets, cfg, mesh)))(gp)

    tcfg, tmesh = td.DenseConfig(**size), _mesh("pp2_cp2_tp2")
    tp = td.params_from_jax(params, "cpu")
    with torch.no_grad():
        got = td.forward(tp, tokens, tcfg, tmesh)
    np.testing.assert_allclose(got.numpy(), want_logits, rtol=1e-4, atol=1e-5)
    leaves = tf.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_()
    loss = td.loss_fn(tp, tokens, targets, tcfg, tmesh)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = _leaves(jax.tree.map(np.asarray, want_g))
    for name, g in zip(_leaves(td.params_to_numpy(tp)), torch.autograd.grad(loss, leaves)):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-3, atol=1e-5, err_msg=name)


def test_world1_is_a_one_member_mesh(data):
    """A call without a mesh and one with MeshConfig() give the same bits;
    the grid view gathers back to the global tree exactly."""
    from uccl_tpu_torch.parallel import sharding as shd

    params, tokens, _ = data
    tp, cfg = tf.params_from_jax(params, "cpu"), tf.FlagshipConfig(**SIZE)
    with torch.no_grad():
        assert torch.equal(tf.forward(tp, tokens, cfg),
                           tf.forward(tp, tokens, cfg, make_mesh(MeshConfig(), "cpu")))
    mesh = _mesh("pp2_cp2_tp2")
    specs = tf.param_specs(cfg)
    back = shd.gather_tree(mesh, tf.shard_params(tp, mesh, cfg), specs)
    for a, b in zip(tf.tree_leaves(back), tf.tree_leaves(tp)):
        assert torch.equal(a, b)


def test_data_must_divide_over_the_mesh(data):
    params, tokens, _ = data
    with pytest.raises(ValueError, match="seq/cp"):
        tf.forward(tf.params_from_jax(params, "cpu"), tokens[:, :15],
                   tf.FlagshipConfig(**SIZE), _mesh("dp2_cp2_tp2"))


def test_one_adamw_step_trains_at_the_mesh(data):
    """make_train_step(cfg, mesh) with either schedule: the global tree's
    step equals the world-1 step's within the gradient tolerance (without
    the aux losses, which a member computes on its own tokens' routing)."""
    params, tokens, targets = data
    size = {**SIZE, "aux_loss_weight": 0.0, "z_loss_weight": 0.0}
    outs = {}
    for key, cfg, mesh in (
            ("world1", tf.FlagshipConfig(**size), None),
            ("gpipe", tf.FlagshipConfig(**size), _mesh("pp2_cp2_tp2")),
            ("1f1b", tf.FlagshipConfig(**size, pp_schedule="1f1b"), _mesh("pp2_cp2_tp2"))):
        tp = tf.params_from_jax(params, "cpu")
        step, init_opt = tf.make_train_step(cfg, mesh if mesh is not None else "cpu",
                                            learning_rate=1e-3)
        tp, opt, metrics = step(tp, init_opt(tp), tokens, targets)
        outs[key] = (metrics["loss"].item(), _leaves(tf.params_to_numpy(tp)))
    for key in ("gpipe", "1f1b"):
        np.testing.assert_allclose(outs[key][0], outs["world1"][0], rtol=1e-5)
        for name, a in outs[key][1].items():
            # AdamW's first step moves every weight by lr * g/(|g| + eps):
            # equal but where a gradient within rounding of 0 flips sign
            diff = np.abs(a - outs["world1"][1][name])
            assert np.all(diff <= 2e-3 + 1e-6) and np.mean(diff > 1e-6) < 1e-2, name


def test_config_takes_every_reference_value():
    for field, values in (("pp_schedule", ("gpipe", "1f1b")), ("seq_mode", ("ring", "ulysses")),
                          ("moe_wire", ("lax", "pallas")), ("moe_chunks", (0, 1, 2)),
                          ("wire_fp8", (False, True)), ("wire_dtype", (None, "fp8", "int8"))):
        for value in values:
            cfg = dataclasses.replace(tf.FlagshipConfig(), **{field: value})
            assert getattr(cfg, field) == value
    for value in ("ring", "ulysses"):
        assert td.DenseConfig(seq_mode=value).seq_mode == value
