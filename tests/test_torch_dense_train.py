"""uccl_tpu_torch.models.dense's training path against uccl_tpu.models.dense
at world 1 (CPU, f32, tiny widths).

Weights come from the JAX init_params through params_from_jax; tokens from
a seeded numpy generator. JAX runs on a 1-device mesh with plain attention;
the port runs its flash path (the kernels' plain versions on the CPU).
Tolerances are tests/test_torch_flagship.py's: logits rtol 1e-4 / atol
1e-5; loss rtol 1e-5; every gradient leaf rtol 1e-3 / atol 1e-5; one AdamW
step atol 1e-6 where |g| > 1e-6 and within 2*lr elsewhere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uccl_tpu.models import dense as jd
from uccl_tpu.parallel.mesh import MeshConfig, make_mesh
from uccl_tpu_torch.models import dense as td
from uccl_tpu_torch.models import flagship as tf

LR = 3e-4
SIZE = dict(vocab=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, ffn=96)
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
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, SIZE["vocab"], (B, S)).astype(np.int32)
    targets = rng.integers(0, SIZE["vocab"], (B, S)).astype(np.int32)
    params = jax.tree.map(np.asarray, jd.init_params(jax.random.PRNGKey(0),
                                                     jd.DenseConfig(**SIZE)))
    return params, tokens, targets


@pytest.fixture(scope="module")
def jax_run(data):
    params, tokens, targets = data
    cfg = jd.DenseConfig(**SIZE, attn_impl="xla")
    mesh = make_mesh(MeshConfig(), jax.devices()[:1])
    gp = jd.shard_params(params, mesh, cfg)
    logits = jax.jit(lambda p, t: jd.forward(p, t, cfg, mesh))(gp, tokens)
    step, init_opt = jd.make_train_step(cfg, mesh, learning_rate=LR)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jd.loss_fn(p, tokens, targets, cfg, mesh)))(gp)
    new_params, _, metrics = jax.jit(step)(gp, init_opt(gp), tokens, targets)
    return dict(logits=np.asarray(logits), loss=float(loss), step_loss=float(metrics["loss"]),
                grads=_leaves(jax.tree.map(np.asarray, grads)),
                new_params=_leaves(jax.tree.map(np.asarray, new_params)))


def _port(params, **kw):
    return td.DenseConfig(**SIZE, **kw), td.params_from_jax(params, "cpu")


def test_forward_and_reference_match_jax(data, jax_run):
    params, tokens, _ = data
    cfg, tp = _port(params)
    got = td.forward(tp, torch.tensor(tokens), cfg).detach().numpy()
    np.testing.assert_allclose(got, jax_run["logits"], rtol=1e-4, atol=1e-5)
    want = np.asarray(jax.jit(jd.reference_forward, static_argnums=2)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens), jd.DenseConfig(**SIZE)))
    ref = td.reference_forward(tp, torch.tensor(tokens), cfg).detach().numpy()
    np.testing.assert_allclose(ref, want, rtol=1e-4, atol=1e-5)


def test_loss_and_grads_match_jax(data, jax_run):
    params, tokens, targets = data
    cfg, tp = _port(params)
    leaves = [p.requires_grad_() for p in tf.tree_leaves(tp)]
    loss = td.loss_fn(tp, torch.tensor(tokens), torch.tensor(targets), cfg)
    np.testing.assert_allclose(loss.item(), jax_run["loss"], rtol=1e-5)
    names = _leaves(td.params_to_numpy(tp))
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    assert grads.keys() == jax_run["grads"].keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jax_run["grads"][name], rtol=1e-3, atol=1e-5,
                                   err_msg=name)


def test_one_adamw_step_matches_jax(data, jax_run):
    params, tokens, targets = data
    cfg, tp = _port(params)
    step, init_opt = td.make_train_step(cfg, "cpu", learning_rate=LR)
    tp, opt, metrics = step(tp, init_opt(tp), tokens, targets)
    assert opt["count"] == 1 and set(metrics) == {"loss"}
    np.testing.assert_allclose(metrics["loss"].item(), jax_run["step_loss"], rtol=1e-5)
    got = _leaves(td.params_to_numpy(tp))
    for name, want in jax_run["new_params"].items():
        big = np.abs(jax_run["grads"][name]) > 1e-6
        np.testing.assert_allclose(got[name][big], want[big], rtol=0, atol=1e-6, err_msg=name)
        assert np.all(np.abs(got[name][~big] - want[~big]) <= 2 * LR), name


def test_dense_config_checks(data):
    """Bad values raise; seq_mode="ulysses" is ported, and at world 1 its
    forward is ring's bit for bit (the reference's cp = 1 branch)."""
    with pytest.raises(ValueError):
        td.DenseConfig(remat="bogus")
    with pytest.raises(ValueError):
        td.DenseConfig(seq_mode="bogus")
    params, tokens, _ = data
    cfg, tp = _port(params)
    with torch.no_grad():
        want = td.forward(tp, torch.tensor(tokens), cfg)
        got = td.forward(tp, torch.tensor(tokens), dataclasses.replace(cfg, seq_mode="ulysses"))
    assert torch.equal(got, want)
