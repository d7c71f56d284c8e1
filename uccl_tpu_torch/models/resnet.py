"""ResNet family (v1.5 bottleneck) — the reference's DDP benchmark workload.

The reference's data-parallel example trains torchvision ResNet-50 under DDP
over its NCCL plugin (examples/ddp_train.py); this is that network as
functions on a param dict: batch norm with tracked running statistics carried
in an explicit state tree, and a pure ``(params, state, x) -> (logits,
state')`` step that drops straight into an explicit gradient all-reduce loop.

Port of ``uccl_tpu/models/resnet.py``, under its names, its NHWC inputs and
its parameter tree. What changes and why:

* Convolution weights are ``[out, in, kh, kw]`` (OIHW, what ``F.conv2d``
  takes); the JAX tree's HWIO kernels are transposed by
  :func:`params_from_jax`. Activations keep NHWC memory: an NCHW view in
  ``channels_last`` format, so cuDNN runs its NHWC kernels. The head stays
  ``[in, classes]``.
* XLA's ``"SAME"`` padding is asymmetric where the window overhangs by an
  odd count (``lo = total // 2``, ``hi = total - lo``): the 7x7/2 stem pads
  (2, 3) on an even size, a 3x3/2 conv (0, 1), and the stem's max pool pads
  (0, 1) with ``-inf``. PyTorch's ``padding=`` is symmetric, so such a conv
  or pool pads explicitly first.
* Batch norm computes its statistics itself, as the JAX model does: the
  population variance, and ``new = momentum·old + (1-momentum)·batch``
  (``F.batch_norm``'s running update uses the unbiased variance and the
  opposite momentum).
* Every convolution and the head's product run in full float32 on the card,
  forward and backward (:func:`_exact_f32`): cuDNN would otherwise run f32
  convolutions in TF32, three decimal digits. The same guard asks cuDNN for
  its deterministic algorithms, so a step repeats bit for bit; the caller's
  settings come back after each call.
* ``init_params`` draws the JAX seed's weights (``models/sampling``'s
  ``split`` and ``normal`` are jax.random's), each within a few ulp.

Depths: 18/34 (basic blocks), 50/101/152 (bottleneck).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from functools import partial
from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from uccl_tpu_torch import DeviceLike, resolve_device
from uccl_tpu_torch.models.sampling import normal, split

_DEPTHS: Dict[int, Tuple[str, List[int]]] = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    num_classes: int = 1000
    width: int = 64  # stem channels; stages use width * (1, 2, 4, 8)
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.depth not in _DEPTHS:
            raise ValueError(
                f"depth {self.depth} not supported (choose {sorted(_DEPTHS)})"
            )

    @property
    def block_kind(self) -> str:
        return _DEPTHS[self.depth][0]

    @property
    def stage_sizes(self) -> List[int]:
        return _DEPTHS[self.depth][1]


# ---------------------------------------------------------------------------
# Layers


@contextlib.contextmanager
def _exact_f32():
    """Full float32 products on the card (no TF32 in cuDNN's convolutions
    or in matmuls) and cuDNN's deterministic algorithms, for the calls
    inside; the caller's settings come back afterwards."""
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cudnn.deterministic, b.cuda.matmul.allow_tf32)
    b.cudnn.allow_tf32, b.cudnn.deterministic, b.cuda.matmul.allow_tf32 = False, True, False
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cudnn.deterministic, b.cuda.matmul.allow_tf32 = saved


class _Conv(torch.autograd.Function):
    """``F.conv2d`` with its backward, both under :func:`_exact_f32`."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        with _exact_f32():
            return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _exact_f32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [ctx.stride] * 2, list(ctx.padding), [1, 1], False, [0, 0],
                1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None


class _MatMul(torch.autograd.Function):
    """``a @ b`` with its backward, both under :func:`_exact_f32`."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _exact_f32():
            return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with _exact_f32():
            return g @ b.T, a.T @ g


def _same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (lo, hi)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """NCHW (channels_last) conv, SAME padding, OIHW kernel."""
    (t, b), (le, r) = (_same_pads(x.shape[i], w.shape[i], stride) for i in (2, 3))
    if t == b and le == r:
        padding = (t, le)
    else:  # asymmetric: pad first, as XLA does
        x, padding = F.pad(x, (le, r, t, b)), (0, 0)
    return _Conv.apply(x, w.to(x.dtype), stride, padding)


def _max_pool_same(y):
    """``reduce_window(max, -inf, 3x3, stride 2, "SAME")``."""
    (t, b), (le, r) = (_same_pads(y.shape[i], 3, 2) for i in (2, 3))
    return F.max_pool2d(F.pad(y, (le, r, t, b), value=-math.inf), 3, 2)


def _wide(dtype: torch.dtype) -> torch.dtype:
    """float32, or the activation dtype where that is wider (the float64
    reference)."""
    return torch.promote_types(dtype, torch.float32)


def _per_channel(v):
    return v[None, :, None, None]


def _bn_apply(x, p, s, train: bool, momentum: float, eps: float):
    """Batch norm over N,H,W. Returns (y, new_state_entry)."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = (x - _per_channel(mean)).square().mean(dim=(0, 2, 3))
        new_s = {
            "mean": momentum * s["mean"] + (1 - momentum) * mean.detach(),
            "var": momentum * s["var"] + (1 - momentum) * var.detach(),
        }
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    inv = torch.rsqrt(var.to(_wide(var.dtype)) + eps).to(x.dtype)
    y = ((x - _per_channel(mean.to(x.dtype))) * _per_channel(inv)
         * _per_channel(p["scale"].to(x.dtype)) + _per_channel(p["bias"].to(x.dtype)))
    return y, new_s


# ---------------------------------------------------------------------------
# The tree


def _tree(cfg: ResNetConfig, conv: Callable, bn: Callable, stat: Callable, head: Callable):
    """(params, state) of ``cfg``, each leaf made by a maker:
    ``conv(key_path, kh, kw, cin, cout)``, ``bn(c, zero_scale)`` (scale and
    bias), ``stat(c)`` (running mean and var), ``head(key_path, cin,
    classes)`` (weight and bias). A key path names the JAX init's key:
    ``(i,)`` is ``split(key, n)[i]``, ``(i, j)`` is ``split(that, 4)[j]``.

    A block's last BN scale starts at zero (zero-init residual: each block
    begins as identity, the standard large-batch trick)."""
    kind = cfg.block_kind
    params: Dict[str, Any] = {"stem": conv((0,), 7, 7, 3, cfg.width), "bn_stem": bn(cfg.width)}
    state: Dict[str, Any] = {"bn_stem": stat(cfg.width)}
    cin, ki = cfg.width, 1
    blocks_p, blocks_s = [], []
    for stage, n_blocks in enumerate(cfg.stage_sizes):
        cmid = cfg.width * (2**stage)
        for b in range(n_blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            if kind == "bottleneck":
                cout = cmid * 4
                p = {
                    "conv1": conv((ki, 0), 1, 1, cin, cmid), "bn1": bn(cmid),
                    "conv2": conv((ki, 1), 3, 3, cmid, cmid), "bn2": bn(cmid),
                    "conv3": conv((ki, 2), 1, 1, cmid, cout), "bn3": bn(cout, True),
                }
                s = {"bn1": stat(cmid), "bn2": stat(cmid), "bn3": stat(cout)}
            else:
                cout = cmid
                p = {
                    "conv1": conv((ki, 0), 3, 3, cin, cmid), "bn1": bn(cmid),
                    "conv2": conv((ki, 1), 3, 3, cmid, cout), "bn2": bn(cout, True),
                }
                s = {"bn1": stat(cmid), "bn2": stat(cout)}
            if stride != 1 or cin != cout:
                p["proj"] = conv((ki, 3), 1, 1, cin, cout)
                p["bn_proj"] = bn(cout)
                s["bn_proj"] = stat(cout)
            blocks_p.append(p)
            blocks_s.append(s)
            cin = cout
            ki += 1
    params["blocks"] = blocks_p
    params["head"], params["head_bias"] = head((ki,), cin, cfg.num_classes)
    state["blocks"] = blocks_s
    return params, state


def param_shapes(cfg: ResNetConfig):
    """The parameter tree's shapes (the port's layout), drawing nothing."""
    size = torch.Size
    return _tree(
        cfg,
        conv=lambda _k, kh, kw, cin, cout: size((cout, cin, kh, kw)),
        bn=lambda c, zero_scale=False: {"scale": size((c,)), "bias": size((c,))},
        stat=lambda c: None,
        head=lambda _k, cin, n: (size((cin, n)), size((n,))),
    )[0]


def init_params(key: torch.Tensor, cfg: ResNetConfig, device: DeviceLike = None):
    """The JAX ``init_params(key, cfg)``: ``(params, state)`` in f32 on
    ``device`` from ``key`` (``sampling.prng_key(seed)``, JAX's
    ``PRNGKey(seed)``); state carries the BN running statistics. The same
    splits, leaf order and scales (He init ``normal * sqrt(2 / fan in)``,
    the head ``normal / sqrt(in)``); the bits equal JAX's and each normal
    lies within a few ulp of JAX's."""
    dev = resolve_device(device)
    keys = split(key.to(dev), 2 + sum(cfg.stage_sizes))

    def key_at(path):
        return keys[path[0]] if len(path) == 1 else split(keys[path[0]], 4)[path[1]]

    def conv(path, kh, kw, cin, cout):
        std = math.sqrt(2.0 / (kh * kw * cin))  # He init for ReLU nets
        w = normal(key_at(path), (kh, kw, cin, cout)) * std
        return w.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW

    def vec(c, fill):
        return torch.full((c,), fill, dtype=torch.float32, device=dev)

    return _tree(
        cfg,
        conv=conv,
        bn=lambda c, zero_scale=False: {"scale": vec(c, 0.0 if zero_scale else 1.0),
                                        "bias": vec(c, 0.0)},
        stat=lambda c: {"mean": vec(c, 0.0), "var": vec(c, 1.0)},
        head=lambda path, cin, n: (normal(key_at(path), (cin, n)) / math.sqrt(cin), vec(n, 0.0)),
    )


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree.leaves``' order: dict keys sorted, lists in order."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _tree_map(fn: Callable, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, t) for t in tree]
    return fn(tree)


def params_from_jax(params: Mapping, state: Mapping, device: DeviceLike = None):
    """The JAX model's ``(params, state)`` trees (as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, ...)``) -> this model's f32 tensors on
    ``device``: every HWIO kernel becomes OIHW; nothing else moves."""
    dev = resolve_device(device)

    def bridge(a):
        t = torch.tensor(np.asarray(a, dtype=np.float32), device=dev)
        return t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t

    return _tree_map(bridge, params), _tree_map(bridge, state)


# ---------------------------------------------------------------------------
# Model


def _block_apply(x, p, s, kind, stride, train, cfg: ResNetConfig):
    bn = partial(_bn_apply, train=train, momentum=cfg.bn_momentum, eps=cfg.bn_eps)
    new_s = {}
    if "proj" in p:
        shortcut = _conv(x, p["proj"], stride)
        shortcut, new_s["bn_proj"] = bn(shortcut, p["bn_proj"], s["bn_proj"])
    else:
        shortcut = x
    if kind == "bottleneck":
        y = _conv(x, p["conv1"], 1)
        y, new_s["bn1"] = bn(y, p["bn1"], s["bn1"])
        y = torch.relu(y)
        y = _conv(y, p["conv2"], stride)
        y, new_s["bn2"] = bn(y, p["bn2"], s["bn2"])
        y = torch.relu(y)
        y = _conv(y, p["conv3"], 1)
        y, new_s["bn3"] = bn(y, p["bn3"], s["bn3"])
    else:
        y = _conv(x, p["conv1"], stride)
        y, new_s["bn1"] = bn(y, p["bn1"], s["bn1"])
        y = torch.relu(y)
        y = _conv(y, p["conv2"], 1)
        y, new_s["bn2"] = bn(y, p["bn2"], s["bn2"])
    return torch.relu(y + shortcut), new_s


def forward(params, state, x, cfg: ResNetConfig, train: bool = True):
    """x: [N, H, W, 3] NHWC float -> (logits [N, classes], new_state).
    ``train=False`` normalizes by the running statistics and leaves them as
    they are."""
    x = x.to(cfg.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    y = _conv(x, params["stem"], 2)
    y, bn_stem = _bn_apply(
        y, params["bn_stem"], state["bn_stem"], train, cfg.bn_momentum, cfg.bn_eps
    )
    y = _max_pool_same(torch.relu(y))
    new_state: Dict[str, Any] = {"bn_stem": bn_stem, "blocks": []}
    bi = 0
    kind = cfg.block_kind
    for stage, n_blocks in enumerate(cfg.stage_sizes):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            y, s_new = _block_apply(
                y, params["blocks"][bi], state["blocks"][bi], kind, stride, train, cfg,
            )
            new_state["blocks"].append(s_new)
            bi += 1
    y = y.mean(dim=(2, 3))  # global average pool over H and W
    y = y.to(_wide(y.dtype))
    logits = _MatMul.apply(y, params["head"].to(y.dtype)) + params["head_bias"].to(y.dtype)
    return logits, new_state


def num_params(params) -> int:
    """Parameter count of a tree of tensors, or of :func:`param_shapes`."""
    return sum(math.prod(getattr(p, "shape", p)) for p in tree_leaves(params))


def loss_fn(params, state, x, labels, cfg: ResNetConfig):
    """Mean softmax cross-entropy; returns (loss, new_state)."""
    logits, new_state = forward(params, state, x, cfg, train=True)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels.long()[:, None])[:, 0]
    return (lse - tgt).mean(), new_state
