"""The port's ResNet (uccl_tpu_torch/models/resnet.py) against the JAX
package's on the same seeded numpy inputs.

Depth 18 (basic blocks) and depth 50 (bottleneck) at width 8 and 10 classes,
on 32x32 inputs (even sizes: XLA's asymmetric ``"SAME"`` pads at every
stride 2, the stem's (2, 3) and the max pool's (0, 1)) and 33x33 inputs
(odd sizes: symmetric pads). The JAX model's params are bridged through
numpy (HWIO kernels to OIHW). Besides the JAX init, every case also runs on
params whose BN scales and biases are drawn from the seed, so that the
zero-initialized residual branches carry signal and every convolution
counts.

Tolerances (float32 on the CPU, sums in another order than XLA's):
logits, loss and BN state within ``FWD_RTOL`` = 1e-4 relative in norm of
the JAX package's result; every gradient leaf within ``GRAD_RTOL`` = 1e-3
relative in norm, plus a floor of ``GRAD_FLOOR`` = 1e-6 of the whole
gradient's norm for leaves whose true gradient is zero up to f32
cancellation (a BN bias feeding the next BN in train mode). Where the JAX
package's own f32 result lies further than that from its float64 run of the
same step (``jax.enable_x64``), the port is held within twice that distance
instead: train-mode BN over a handful of samples, 50 layers deep, amplifies
f32 rounding in both packages (depth 50 on 32x32 with drawn BN params, where
BN normalizes four 1x1 samples). The init within 4 ulp of JAX's
(``tests/test_torch_init.py``).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

from uccl_tpu.models import resnet as jres
from uccl_tpu_torch.models import resnet as tres
from uccl_tpu_torch.models.sampling import prng_key

FWD_RTOL = 1e-4
GRAD_RTOL = 1e-3
GRAD_FLOOR = 1e-6
ULP_BOUND = 4
BATCH = 4


def _ulps(got, want):
    def ordered(a):
        i = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(got) - ordered(want)).max())


def _hwio(t):
    """A port leaf in the JAX layout, as numpy."""
    a = t.detach().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


def _cfgs(depth):
    return (jres.ResNetConfig(depth=depth, num_classes=10, width=8),
            tres.ResNetConfig(depth=depth, num_classes=10, width=8))


@pytest.fixture(scope="module", params=[18, 50])
def model(request):
    """Per depth: the configs, the JAX init as numpy, and the same tree with
    every BN scale and bias drawn from the seed."""
    jc, tc = _cfgs(request.param)
    jp, js = jax.jit(lambda k: jres.init_params(k, jc))(jax.random.PRNGKey(0))
    jp, js = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    rng = np.random.default_rng(request.param)
    flat, tree = jax.tree_util.tree_flatten_with_path(jp)
    drawn = [rng.uniform(0.5, 1.5, a.shape).astype(np.float32) if "scale" in jax.tree_util.keystr(p)
             else rng.uniform(-0.2, 0.2, a.shape).astype(np.float32)
             if "bias" in jax.tree_util.keystr(p) else a for p, a in flat]
    return dict(depth=request.param, jc=jc, tc=tc, init=(jp, js),
                drawn=(jax.tree.unflatten(tree, drawn), js))


def _inputs(hw, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    return x, y


def _jax_step(jc, params, state, x, y, dtype=jnp.float32):
    """Train-mode logits and state, loss, gradients, eval-mode logits and
    state, computed in ``dtype``."""
    cfg = jres.ResNetConfig(depth=jc.depth, num_classes=jc.num_classes, width=jc.width,
                            dtype=dtype)

    @jax.jit
    def step(p, s, x, y):
        logits, new_s = jres.forward(p, s, x, cfg, train=True)
        (loss, _), grads = jax.value_and_grad(
            lambda p: jres.loss_fn(p, s, x, y, cfg), has_aux=True)(p)
        eval_logits, eval_s = jres.forward(p, s, x, cfg, train=False)
        return logits, new_s, loss, grads, eval_logits, eval_s

    with jax.enable_x64(dtype == jnp.float64):
        out = step(params, state, jnp.asarray(x, dtype), jnp.asarray(y))
        return jax.tree.map(np.asarray, out)


class _Held:
    """The module's rule for one step: within the base tolerance of the JAX
    f32 result, or within twice the JAX f32 result's distance from its
    float64 run where that is larger (computed only then)."""

    def __init__(self, jc, params, state, x, y):
        self.args = (jc, params, state, x, y)
        self.f32 = _jax_step(*self.args)
        self._f64 = None

    def f64(self, i):
        if self._f64 is None:
            self._f64 = _jax_step(*self.args, dtype=jnp.float64)
        return self._f64[i]

    def check(self, got, i, leaf=None, tol=None):
        """``got`` against output ``i`` (leaf ``leaf`` of a tree output);
        ``tol(want)`` is the base bound on the error's norm."""
        pick = (lambda t: t) if leaf is None else (lambda t: jax.tree.leaves(t)[leaf])
        want = pick(self.f32[i])
        tol = tol or (lambda w: FWD_RTOL * np.linalg.norm(w))
        err = np.linalg.norm(got - want)
        if err <= tol(want):
            return
        drift = np.linalg.norm(want - pick(self.f64(i)))
        assert err <= 2 * drift, (i, leaf, err, tol(want), drift)


@pytest.mark.parametrize("hw", [32, 33])
@pytest.mark.parametrize("params", ["init", "drawn"])
def test_forward_loss_and_grads_match_jax(model, hw, params):
    tc = model["tc"]
    jp, js = model[params]
    x, y = _inputs(hw)
    held = _Held(model["jc"], jp, js, x, y)

    tp, ts = tres.params_from_jax(jp, js, device="cpu")
    leaves = [t.requires_grad_() for t in tres.tree_leaves(tp)]
    got_logits, got_s = tres.forward(tp, ts, torch.tensor(x), tc, train=True)
    assert got_logits.shape == (BATCH, 10)
    held.check(got_logits.detach().numpy(), 0)
    got_s = tres.tree_leaves(got_s)
    assert len(got_s) == len(jax.tree.leaves(held.f32[1]))
    for j, g in enumerate(got_s):
        assert not g.requires_grad
        held.check(g.numpy(), 1, leaf=j)

    got_loss, _ = tres.loss_fn(tp, ts, torch.tensor(x), torch.tensor(y), tc)
    held.check(np.float32(got_loss.item()), 2)
    got_g = torch.autograd.grad(got_loss, leaves)
    want_g = jax.tree.leaves(held.f32[3])
    floor = GRAD_FLOOR * np.sqrt(sum(float(np.sum(np.square(w))) for w in want_g))
    assert len(got_g) == len(want_g)
    for j, g in enumerate(got_g):
        held.check(_hwio(g), 3, leaf=j,
                   tol=lambda w: GRAD_RTOL * np.linalg.norm(w) + floor)

    # eval mode: the running statistics normalize and are left as they are
    got_eval, got_eval_s = tres.forward(tp, ts, torch.tensor(x), tc, train=False)
    held.check(got_eval.detach().numpy(), 4)
    for g, before, w in zip(tres.tree_leaves(got_eval_s), tres.tree_leaves(ts),
                            jax.tree.leaves(held.f32[5])):
        assert torch.equal(g, before)
        np.testing.assert_array_equal(g.numpy(), w)


def test_zero_init_residual_still_learns(model):
    """Each block's last BN scale starts at zero; its gradient flows."""
    tc = model["tc"]
    tp, ts = tres.init_params(prng_key(0), tc, device="cpu")
    last = "bn3" if tc.block_kind == "bottleneck" else "bn2"
    scales = [b[last]["scale"].requires_grad_() for b in tp["blocks"]]
    assert all(not s.any() for s in scales)
    x, y = _inputs(32, seed=1)
    loss, _ = tres.loss_fn(tp, ts, torch.tensor(x), torch.tensor(y), tc)
    assert all(g.abs().sum() > 0 for g in torch.autograd.grad(loss, scales))


def test_init_within_4_ulp_of_jax(model):
    jp, js = model["init"]
    tp, ts = tres.init_params(prng_key(0), model["tc"], device="cpu")
    want, got = jax.tree.leaves(jp), tres.tree_leaves(tp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _hwio(g).shape == w.shape and _ulps(_hwio(g), w) <= ULP_BOUND
    for g, w in zip(tres.tree_leaves(ts), jax.tree.leaves(js)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert tres.num_params(tp) == jres.num_params(jp)
    assert tres.num_params(tres.param_shapes(model["tc"])) == jres.num_params(jp)


@pytest.mark.parametrize("depth,want", [(50, 25_557_032), (18, 11_689_512)])
def test_full_width_param_count_without_drawing(depth, want):
    """25.56M / 11.69M @ 1000 classes: the canonical ResNet-50 / ResNet-18."""
    n = tres.num_params(tres.param_shapes(tres.ResNetConfig(depth=depth)))
    assert n == want
    assert abs(n / 1e6 - {50: 25.56, 18: 11.69}[depth]) < 0.02


def test_bad_depth_rejected():
    with pytest.raises(ValueError, match="depth"):
        tres.ResNetConfig(depth=77)


def test_same_pads_are_xla_s():
    """The stem 7x7/2 pads (2, 3) on 224 and 32, (3, 3) on 33; a 3x3/2
    (0, 1) on an even size; a 3x3/1 (1, 1); a 1x1/2 nothing."""
    assert tres._same_pads(224, 7, 2) == (2, 3)
    assert tres._same_pads(32, 7, 2) == (2, 3)
    assert tres._same_pads(33, 7, 2) == (3, 3)
    assert tres._same_pads(56, 3, 2) == (0, 1)
    assert tres._same_pads(57, 3, 2) == (1, 1)
    assert tres._same_pads(56, 3, 1) == (1, 1)
    assert tres._same_pads(56, 1, 2) == (0, 0)


def test_precision_guard_covers_forward_and_backward(monkeypatch):
    """Every convolution and the head's product run under the f32 guard
    (no TF32, deterministic cuDNN), forward and backward; the caller's
    settings come back after each call, also when a call inside raises."""
    b = torch.backends
    settings = lambda: (b.cudnn.allow_tf32, b.cudnn.deterministic,  # noqa: E731
                        b.cuda.matmul.allow_tf32)
    real, inside = tres._exact_f32, []

    @contextlib.contextmanager
    def recording():
        with real():
            inside.append(settings())
            yield

    monkeypatch.setattr(tres, "_exact_f32", recording)
    saved = settings()
    try:
        b.cudnn.allow_tf32, b.cudnn.deterministic, b.cuda.matmul.allow_tf32 = True, False, True
        tc = tres.ResNetConfig(depth=18, num_classes=10, width=8)
        tp, ts = tres.init_params(prng_key(0), tc, device="cpu")
        leaves = [t.requires_grad_() for t in tres.tree_leaves(tp)]
        x, y = _inputs(32)
        loss, _ = tres.loss_fn(tp, ts, torch.tensor(x), torch.tensor(y), tc)
        n_fwd = len(inside)
        assert n_fwd == 21  # 17 convolutions + 3 projections + the head
        torch.autograd.grad(loss, leaves)
        assert len(inside) == 2 * n_fwd and set(inside) == {(False, True, False)}
        assert settings() == (True, False, True)
        with pytest.raises(RuntimeError), real():
            raise RuntimeError("inside")
        assert settings() == (True, False, True)
    finally:
        b.cudnn.allow_tf32, b.cudnn.deterministic, b.cuda.matmul.allow_tf32 = saved
