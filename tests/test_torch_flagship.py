"""uccl_tpu_torch.models.flagship against uccl_tpu.models.flagship at world 1
(CPU, f32, a tiny config whose capacity factor drops tokens).

Weights come from the JAX init_params through params_from_jax; tokens from a
seeded numpy generator. JAX runs on a 1-device mesh, once with
attn_impl="xla" and once with "flash" (the Pallas kernels in interpret mode);
the port runs its own flash path (the kernels' plain versions on the CPU).
Tolerances: logits rtol 1e-4 / atol 1e-5; loss rtol 1e-5; every gradient
leaf rtol 1e-3 / atol 1e-5; one AdamW step atol 1e-6 where |g| > 1e-6 and
within 2*lr elsewhere (AdamW's first step is lr*g/(|g|+eps), so a gradient
at rounding distance from 0 may flip sign).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uccl_tpu.models import flagship as jf
from uccl_tpu.parallel.mesh import MeshConfig, make_mesh
from uccl_tpu_torch.models import flagship as tf
from uccl_tpu_torch.models.sampling import prng_key

LR = 3e-4
SIZE = dict(vocab=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
            moe_experts=4, moe_topk=2, moe_ffn=96, capacity_factor=1.25)
B, S = 2, 32


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
    params = jax.tree.map(np.asarray, jf.init_params(jax.random.PRNGKey(0),
                                                     jf.FlagshipConfig(**SIZE)))
    return params, tokens, targets


@pytest.fixture(scope="module", params=["xla", "flash"])
def jax_run(request, data):
    params, tokens, targets = data
    cfg = jf.FlagshipConfig(**SIZE, attn_impl=request.param)
    mesh = make_mesh(MeshConfig(), jax.devices()[:1])
    gp = jf.shard_params(params, mesh, cfg)
    logits = jax.jit(lambda p, t: jf.forward(p, t, cfg, mesh))(gp, tokens)
    (total, ce), grads = jax.jit(jax.value_and_grad(
        lambda p: jf.loss_fn(p, tokens, targets, cfg, mesh), has_aux=True))(gp)
    step, init_opt = jf.make_train_step(cfg, mesh, learning_rate=LR)
    new_params, _, _ = jax.jit(step)(gp, init_opt(gp), tokens, targets)
    return dict(logits=np.asarray(logits), total=float(total), ce=float(ce),
                grads=_leaves(jax.tree.map(np.asarray, grads)),
                new_params=_leaves(jax.tree.map(np.asarray, new_params)))


def _port(params, **kw):
    return tf.FlagshipConfig(**SIZE, **kw), tf.params_from_jax(params, "cpu")


def test_logits_match_jax(data, jax_run):
    params, tokens, _ = data
    cfg, tp = _port(params)
    got = tf.forward(tp, torch.tensor(tokens), cfg).detach().numpy()
    np.testing.assert_allclose(got, jax_run["logits"], rtol=1e-4, atol=1e-5)


def test_loss_matches_jax(data, jax_run):
    params, tokens, targets = data
    cfg, tp = _port(params)
    total, ce = tf.loss_fn(tp, torch.tensor(tokens), torch.tensor(targets), cfg)
    np.testing.assert_allclose(total.item(), jax_run["total"], rtol=1e-5)
    np.testing.assert_allclose(ce.item(), jax_run["ce"], rtol=1e-5)


def test_grads_match_jax(data, jax_run):
    params, tokens, targets = data
    cfg, tp = _port(params)
    leaves = tf.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_()
    total, _ = tf.loss_fn(tp, torch.tensor(tokens), torch.tensor(targets), cfg)
    names = _leaves(tf.params_to_numpy(tp))  # same key order as tree_leaves
    grads = dict(zip(names, torch.autograd.grad(total, leaves)))
    assert grads.keys() == jax_run["grads"].keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jax_run["grads"][name], rtol=1e-3,
                                   atol=1e-5, err_msg=name)


def test_one_adamw_step_matches_jax(data, jax_run):
    params, tokens, targets = data
    cfg, tp = _port(params)
    step, init_opt = tf.make_train_step(cfg, "cpu", learning_rate=LR)
    tp, opt, metrics = step(tp, init_opt(tp), tokens, targets)
    assert opt["count"] == 1
    np.testing.assert_allclose(metrics["loss"].item(), jax_run["total"], rtol=1e-5)
    got = tf.params_to_numpy(tp)
    for name, want in jax_run["new_params"].items():
        g = _leaves(got)[name]
        big = np.abs(jax_run["grads"][name]) > 1e-6
        np.testing.assert_allclose(g[big], want[big], rtol=0, atol=1e-6, err_msg=name)
        assert np.all(np.abs(g[~big] - want[~big]) <= 2 * LR), name


def test_reference_forward_matches_jax_without_drops(data):
    params, tokens, _ = data
    kw = {**SIZE, "capacity_factor": 2.0}  # E/k: no drops, where the oracle is exact
    want = np.asarray(jf.reference_forward(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens), jf.FlagshipConfig(**kw)))
    got = tf.reference_forward(tf.params_from_jax(params, "cpu"), torch.tensor(tokens),
                               tf.FlagshipConfig(**kw))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-5)


def test_remat_and_microbatches_keep_the_math(data):
    """remat none == full (bit for bit: the same ops), and 2 microbatches
    match the JAX model's 2-microbatch GPipe loss."""
    params, tokens, targets = data
    t, y = torch.tensor(tokens), torch.tensor(targets)
    losses = {}
    for remat in ("full", "none"):
        cfg, tp = _port(params, remat=remat)
        leaves = tf.tree_leaves(tp)
        for p in leaves:
            p.requires_grad_()
        total, _ = tf.loss_fn(tp, t, y, cfg)
        losses[remat] = (total.item(), torch.autograd.grad(total, leaves))
    assert losses["full"][0] == losses["none"][0]
    for a, b in zip(losses["full"][1], losses["none"][1]):
        assert torch.equal(a, b)

    jcfg = jf.FlagshipConfig(**SIZE, n_microbatches=2)
    mesh = make_mesh(MeshConfig(), jax.devices()[:1])
    want, _ = jf.loss_fn(jf.shard_params(params, mesh, jcfg), tokens, targets, jcfg, mesh)
    cfg, tp = _port(params, n_microbatches=2)
    got, _ = tf.loss_fn(tp, t, y, cfg)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_params_round_trip_and_init_shapes(data):
    params, _, _ = data
    back = _leaves(tf.params_to_numpy(tf.params_from_jax(params, "cpu")))
    for name, a in _leaves(params).items():
        np.testing.assert_array_equal(back[name], a)
    cfg = tf.FlagshipConfig(**SIZE)
    init = tf.init_params(prng_key(0), cfg, "cpu")
    assert {k: v.shape for k, v in _leaves(tf.params_to_numpy(init)).items()} == \
        {k: v.shape for k, v in _leaves(params).items()}


@pytest.mark.parametrize("field,value,exc", [
    ("seq_mode", "bogus", ValueError),
    ("pp_schedule", "bogus", ValueError),
    ("remat", "bogus", ValueError),
    ("moe_wire", "bogus", ValueError),
    ("attn_impl", "bogus", ValueError),
])
def test_unported_options_raise(field, value, exc):
    """Values outside the JAX model's raise; every value it takes is ported
    (the multi-chip ones at world 1 below, at world > 1 in
    tests/test_torch_flagship_mesh.py)."""
    with pytest.raises(exc):
        dataclasses.replace(tf.FlagshipConfig(), **{field: value})


@pytest.mark.parametrize("field,value", [
    ("seq_mode", "ulysses"),
    ("moe_chunks", 2),
    ("pp_schedule", "1f1b"),
    ("moe_wire", "pallas"),
])
def test_multichip_options_at_world_1(data, field, value):
    """The multi-chip fields once refused here: at world 1 Ulysses is the
    direct attention (the reference's cp = 1 branch), the pallas wire and a
    chunk depth move nothing, so the loss and gradients are the default's
    bit for bit; the manual 1F1B schedule gives GPipe's loss and gradients
    (rtol 1e-5 / atol 1e-7: another summation order)."""
    params, tokens, targets = data
    t, y = torch.tensor(tokens), torch.tensor(targets)
    base_cfg, base = _port(params)
    leaves = tf.tree_leaves(base)
    for p in leaves:
        p.requires_grad_()
    want_total, _ = tf.loss_fn(base, t, y, base_cfg)
    want = torch.autograd.grad(want_total, leaves)
    cfg, tp = _port(params, **{field: value})
    if field == "pp_schedule":
        total, _, grads = tf.manual_loss_and_grads(tp, t, y, cfg)
        np.testing.assert_allclose(total.item(), want_total.item(), rtol=1e-5)
        for g, w in zip(tf.tree_leaves(grads), want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-7)
        return
    leaves = tf.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_()
    total, _ = tf.loss_fn(tp, t, y, cfg)
    assert total.item() == want_total.item()
    if field == "moe_wire":  # the pallas wire is forward only (no vjp, as in JAX)
        return
    for g, w in zip(torch.autograd.grad(total, leaves), want):
        assert torch.equal(g, w)


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tf.FlagshipConfig(**SIZE)
    with pytest.raises(RuntimeError):
        tf.init_params(prng_key(0), cfg)
    with pytest.raises(RuntimeError):
        tf.make_train_step(cfg)
