"""The remat modes and moe_impl="ll" of the port's training path against the
JAX package (CPU, f32, tiny widths, world 1).

Every remat mode must give the gradients of "full" exactly (torch.equal: a
saved tensor holds what a recompute gives) for the flagship on the sort and
ll paths and for the dense model, and match the JAX package in the same
mode at tests/test_torch_flagship.py's tolerances (loss rtol 1e-5, every
gradient leaf rtol 1e-3 / atol 1e-5). "dots" must save the products with
no batch dim (aten.mm) and none of the expert bmms; "mlp" also the four
tagged expert tensors (for the dense model, nothing more: "mlp" is "dots"
there). The ll path's ragged grouped GEMM must see only the packed rows.
"""

import jax
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from uccl_tpu.models import dense as jd
from uccl_tpu.models import flagship as jf
from uccl_tpu.parallel.mesh import MeshConfig, make_mesh
from uccl_tpu_torch.ep import ops as tops
from uccl_tpu_torch.models import dense as td
from uccl_tpu_torch.models import flagship as tf

SIZE = dict(vocab=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
            moe_experts=4, moe_topk=2, moe_ffn=96, capacity_factor=1.25)
DSIZE = dict(vocab=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, ffn=96)
B, S = 2, 32
KINDS = ("sort", "ll", "dense")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, SIZE["vocab"], (B, S)).astype(np.int32)
    targets = rng.integers(0, SIZE["vocab"], (B, S)).astype(np.int32)
    key = jax.random.PRNGKey(0)
    fp = jax.tree.map(np.asarray, jf.init_params(key, jf.FlagshipConfig(**SIZE)))
    dp = jax.tree.map(np.asarray, jd.init_params(key, jd.DenseConfig(**DSIZE)))
    return {"flagship": fp, "dense": dp}, tokens, targets


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _names(v, f"{prefix}{k}/")]
    return [prefix[:-1]]


def _port_loss(kind, mode, data):
    params, tokens, targets = data
    t, y = torch.tensor(tokens), torch.tensor(targets)
    if kind == "dense":
        cfg = td.DenseConfig(**DSIZE, remat=mode)
        tp = td.params_from_jax(params["dense"], "cpu")
        leaves = [p.requires_grad_() for p in tf.tree_leaves(tp)]
        return td.loss_fn(tp, t, y, cfg), leaves, _names(tp)
    cfg = tf.FlagshipConfig(**SIZE, moe_impl=kind, remat=mode)
    tp = tf.params_from_jax(params["flagship"], "cpu")
    leaves = [p.requires_grad_() for p in tf.tree_leaves(tp)]
    return tf.loss_fn(tp, t, y, cfg)[0], leaves, _names(tp)


_PORT, _JAX = {}, {}


def _port_grads(kind, mode, data):
    if (kind, mode) not in _PORT:
        loss, leaves, names = _port_loss(kind, mode, data)
        _PORT[kind, mode] = (loss.item(), dict(zip(names, torch.autograd.grad(loss, leaves))))
    return _PORT[kind, mode]


def _jax_grads(kind, mode, data):
    if (kind, mode) not in _JAX:
        params, tokens, targets = data
        mesh = make_mesh(MeshConfig(), jax.devices()[:1])
        if kind == "dense":
            cfg = jd.DenseConfig(**DSIZE, remat=mode, attn_impl="xla")
            gp = jd.shard_params(params["dense"], mesh, cfg)
            fn = jax.value_and_grad(lambda p: jd.loss_fn(p, tokens, targets, cfg, mesh))
        else:
            cfg = jf.FlagshipConfig(**SIZE, moe_impl=kind, remat=mode, attn_impl="xla")
            gp = jf.shard_params(params["flagship"], mesh, cfg)
            fn = jax.value_and_grad(
                lambda p: jf.loss_fn(p, tokens, targets, cfg, mesh)[0])
        loss, grads = jax.jit(fn)(gp)
        leaves = jax.tree.leaves(grads)  # dict keys sorted: the port's names sorted
        names = sorted(_names(jax.tree.map(np.asarray, grads)))
        _JAX[kind, mode] = (float(loss), dict(zip(names, map(np.asarray, leaves))))
    return _JAX[kind, mode]


def _match_jax(kind, mode, data):
    loss, grads = _port_grads(kind, mode, data)
    jloss, jgrads = _jax_grads(kind, mode, data)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert grads.keys() == jgrads.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=1e-3, atol=1e-5,
                                   err_msg=f"{kind} {mode} {name}")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["dots", "mlp", "none"])
def test_mode_gives_fulls_gradients_and_jaxs(kind, mode, data):
    loss, grads = _port_grads(kind, mode, data)
    full_loss, full = _port_grads(kind, "full", data)
    assert loss == full_loss
    for name, g in grads.items():
        assert torch.equal(g, full[name]), (kind, mode, name)
    _match_jax(kind, mode, data)


@pytest.mark.parametrize("kind", KINDS)
def test_dots_saves_the_mm_outputs_and_mlp_the_expert_tags(kind, data, monkeypatch):
    seen = []
    real = tf.remat_policy

    def spy(mode):
        policy = real(mode)

        def recording(ctx, func, *args, **kwargs):
            decision = policy(ctx, func, *args, **kwargs)
            if not ctx.is_recompute:
                name = args[1] if func is tf._TAG else func.overloadpacket.__name__
                seen.append((name, decision == CheckpointPolicy.MUST_SAVE))
            return decision

        return recording

    monkeypatch.setattr(tf, "remat_policy", spy)
    layers = SIZE["n_layers"]
    mms = (7 if kind == "dense" else 5) * layers  # q, k, v, o (+ router | + gate, up, down)
    for mode in ("dots", "mlp"):
        seen.clear()
        loss, leaves, _ = _port_loss(kind, mode, data)
        torch.autograd.grad(loss, leaves)
        saved = sorted(n for n, s in seen if s)
        bmms = [s for n, s in seen if n == "bmm"]
        tags = [n for n, _ in seen if n in tops.MOE_CHECKPOINT_NAMES]
        if kind != "dense":
            assert len(bmms) >= 3 * layers and not any(bmms), (mode, bmms)
        want = ["mm"] * mms
        if mode == "mlp" and kind != "dense":
            want += [*tops.MOE_CHECKPOINT_NAMES] * layers
            assert sorted(tags) == sorted(tops.MOE_CHECKPOINT_NAMES * layers)
        else:
            assert tags == []  # the tags are off: no copies
        assert saved == sorted(want), (kind, mode)


def test_ll_full_matches_jax(data):
    _match_jax("ll", "full", data)


def test_ll_ragged_products_see_only_the_packed_rows(monkeypatch):
    rng = np.random.default_rng(3)
    t, h, e, f, k = 24, 16, 4, 32, 2
    x = torch.tensor(rng.standard_normal((t, h)), dtype=torch.float32)
    logits = torch.tensor(rng.standard_normal((t, e)), dtype=torch.float32)
    wg, wu = (torch.tensor(rng.standard_normal((e, h, f)) / 4, dtype=torch.float32)
              for _ in range(2))
    wd = torch.tensor(rng.standard_normal((e, f, h)) / 4, dtype=torch.float32)
    rows, bmm = [], torch.bmm

    def counted(a, b):  # every product of the ragged path is one expert's segment
        rows.append(a.shape[1])
        return bmm(a, b)

    monkeypatch.setattr(torch, "bmm", counted)
    ragged = tops.moe_ffn(x, logits, wg, wu, wd, num_selected=k, capacity_factor=1.0,
                          impl="ll", ll_grouped="ragged")[0]
    monkeypatch.undo()
    assert sum(rows) == 3 * t * k and len(rows) <= 3 * e  # drop-free: every row, no padding
    fixed = tops.moe_ffn(x, logits, wg, wu, wd, num_selected=k, capacity_factor=1.0,
                         impl="ll")[0]
    np.testing.assert_allclose(ragged.numpy(), fixed.numpy(), rtol=1e-5, atol=1e-6)
    # with capacity for every row, the sort path routes the same and drops nothing
    sort = tops.moe_ffn(x, logits, wg, wu, wd, num_selected=k, capacity_factor=e / k,
                        impl="sort")[0]
    np.testing.assert_allclose(ragged.numpy(), sort.numpy(), rtol=1e-5, atol=1e-6)
