"""Flagship MoE transformer at world 1: forward, loss and the training step.

Port of ``uccl_tpu/models/flagship.py`` on one device. Each block is RMSNorm
-> Q/K/V projections -> RoPE -> causal GQA flash attention -> output
projection -> RMSNorm -> f32 router -> top-k sorted dispatch -> SwiGLU
experts -> weighted combine; then final norm -> f32 vocab head ->
cross-entropy plus the MoE aux/z losses, and AdamW.

The JAX model is written manually sharded over a pp/dp/cp/tp mesh. At world
1 every collective there is the identity, so this port is the same math with
the collectives dropped. The parameter tree keeps the JAX names and layouts
(weights are ``[in, out]``, per-layer weights stacked on a leading layer
axis), so :func:`params_from_jax` and :func:`params_to_numpy` move weights
across in both directions without a transpose.

Casts follow the JAX model: activations are in ``cfg.dtype`` and each weight
is cast to it at its matmul; router and vocab logits are float32; the MoE
output is cast back to the activation dtype.

Not ported yet (they raise): the multi-chip fields of the config at other
than their defaults, ``remat="dots"``/``"mlp"``, ``moe_impl="ll"``.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from uccl_tpu_torch import DeviceLike, resolve_device
from uccl_tpu_torch.ep import ops as ep_ops
from uccl_tpu_torch.models.layers import rms_norm, rope, tp_cross_entropy
from uccl_tpu_torch.ops.attention import attention_reference
from uccl_tpu_torch.ops.flash_attention import flash_attention

Params = Dict[str, Any]

# Multi-chip fields of the JAX config; the world-1 port accepts each at its
# default only.
_WORLD1_DEFAULTS = {
    "pp_schedule": "gpipe",
    "seq_mode": "ring",
    "moe_wire": "lax",
    "moe_chunks": 0,
    "wire_fp8": False,
    "wire_dtype": None,
}


@dataclasses.dataclass(frozen=True)
class FlagshipConfig:
    vocab: int = 1024
    dim: int = 256
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    head_dim: int = 32
    moe_experts: int = 8
    moe_topk: int = 2
    moe_ffn: int = 512
    capacity_factor: float = 1.5
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3
    n_microbatches: int = 1
    pp_schedule: str = "gpipe"
    seq_mode: str = "ring"
    attn_impl: str = "auto"  # "auto" | "flash": the flash kernels; "xla": plain
    moe_impl: str = "sort"  # "sort" | "dense"
    moe_wire: str = "lax"
    moe_chunks: int = 0
    wire_fp8: bool = False
    wire_dtype: Any = None
    remat: str = "full"  # "full" | "none"
    dtype: torch.dtype = torch.float32  # activation dtype (bfloat16 on the card)

    def __post_init__(self):
        for name, default in _WORLD1_DEFAULTS.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"FlagshipConfig.{name}={getattr(self, name)!r}: the world-1 port "
                    f"takes only {default!r}"
                )
        if self.attn_impl not in ("auto", "flash", "xla"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r} (want auto|flash|xla)")
        if self.remat in ("dots", "mlp"):
            raise NotImplementedError(f"remat={self.remat!r} is not ported yet (full|none)")
        if self.remat not in ("full", "none"):
            raise ValueError(f"unknown remat mode {self.remat!r} (want full|none)")
        if self.moe_impl == "ll":
            raise NotImplementedError("moe_impl='ll' (ep/ll.py) is not ported yet")
        if self.moe_impl not in ("sort", "dense"):
            raise ValueError(f"unknown moe impl {self.moe_impl!r} (want sort|dense)")


def bench_config(**overrides) -> FlagshipConfig:
    """The benchmark's base configuration (the JAX package's bench.py:114-129):
    vocab 16384, dim 1024, 4 layers, 16 query / 4 KV heads of 64, 8 experts
    top-2 with ffn 2816, capacity factor 1.25, bf16, remat full."""
    base = dict(vocab=16384, dim=1024, n_layers=4, n_heads=16, n_kv_heads=4, head_dim=64,
                moe_experts=8, moe_topk=2, moe_ffn=2816, capacity_factor=1.25,
                n_microbatches=1, aux_loss_weight=0.01, z_loss_weight=1e-3,
                remat="full", dtype=torch.bfloat16)
    return FlagshipConfig(**{**base, **overrides})


# ---------------------------------------------------------------------------
# Parameters

_BLOCK_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "router", "we_gate", "we_up", "we_down")


def param_shapes(cfg: FlagshipConfig) -> Params:
    """Shapes of the parameter tree, named and laid out as in the JAX model."""
    h, l = cfg.dim, cfg.n_layers
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    e, f = cfg.moe_experts, cfg.moe_ffn
    return {
        "embed": (cfg.vocab, h),
        "blocks": {
            "ln1": (l, h), "ln2": (l, h),
            "wq": (l, h, qd), "wk": (l, h, kvd), "wv": (l, h, kvd), "wo": (l, qd, h),
            "router": (l, h, e),
            "we_gate": (l, e, h, f), "we_up": (l, e, h, f), "we_down": (l, e, f, h),
        },
        "final_norm": (h,),
        "head": (h, cfg.vocab),
    }


def init_params(cfg: FlagshipConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random f32 parameters with the JAX model's scales (normal * 1/sqrt(fan
    in), embeddings * 0.02, norms at 1), drawn from ``generator`` on the CPU
    and moved to ``device``. The numbers differ from the JAX init of the
    same seed; use :func:`params_from_jax` to share weights."""
    dev = resolve_device(device)
    h, f = cfg.dim, cfg.moe_ffn
    qd = cfg.n_heads * cfg.head_dim
    shapes = param_shapes(cfg)

    def rnd(shape, scale):
        return (torch.randn(shape, generator=generator) * scale).to(dev)

    s_in = 1.0 / math.sqrt(h)
    blocks = shapes["blocks"]
    return {
        "embed": rnd(shapes["embed"], 0.02),
        "blocks": {
            "ln1": torch.ones(blocks["ln1"], device=dev),
            "ln2": torch.ones(blocks["ln2"], device=dev),
            "wq": rnd(blocks["wq"], s_in),
            "wk": rnd(blocks["wk"], s_in),
            "wv": rnd(blocks["wv"], s_in),
            "wo": rnd(blocks["wo"], 1.0 / math.sqrt(qd)),
            "router": rnd(blocks["router"], s_in),
            "we_gate": rnd(blocks["we_gate"], s_in),
            "we_up": rnd(blocks["we_up"], s_in),
            "we_down": rnd(blocks["we_down"], 1.0 / math.sqrt(f)),
        },
        "final_norm": torch.ones(shapes["final_norm"], device=dev),
        "head": rnd(shapes["head"], s_in),
    }


def _tree_map(fn: Callable, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in key order."""
    if isinstance(tree, Mapping):
        return [x for k in tree for x in tree_leaves(tree[k])]
    return [tree]


def params_from_jax(np_tree: Mapping, device: DeviceLike = None) -> Params:
    """A JAX-model parameter tree (as numpy arrays, e.g. ``jax.tree.map(
    np.asarray, params)``) -> this model's f32 tensors on ``device``. Names
    and layouts are the same; nothing is transposed."""
    dev = resolve_device(device)
    return _tree_map(
        lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=dev), np_tree
    )


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """This model's parameters -> a tree of float32 numpy arrays with the JAX
    model's names and layouts."""
    return _tree_map(lambda t: t.detach().float().cpu().numpy(), params)


# ---------------------------------------------------------------------------
# Forward


def _attention(x: torch.Tensor, lp: Params, cfg: FlagshipConfig) -> torch.Tensor:
    """x: [B, S, H_model] -> [B, S, H_model]."""
    b, s, _ = x.shape
    d = cfg.head_dim
    q = (x @ lp["wq"].to(x.dtype)).reshape(b, s, cfg.n_heads, d)
    k = (x @ lp["wk"].to(x.dtype)).reshape(b, s, cfg.n_kv_heads, d)
    v = (x @ lp["wv"].to(x.dtype)).reshape(b, s, cfg.n_kv_heads, d)
    positions = torch.arange(s, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cfg.attn_impl == "xla":
        attn = attention_reference(q, k, v, causal=True)
    else:
        attn = flash_attention(q, k, v, True)
    return attn.reshape(b, s, cfg.n_heads * d) @ lp["wo"].to(x.dtype)


def _layer(x: torch.Tensor, lp: Params, cfg: FlagshipConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One transformer block. x: [B, S, H]. Returns (x, aux scalar)."""
    b, s, h = x.shape
    x = x + _attention(rms_norm(x, lp["ln1"], cfg.norm_eps), lp, cfg)
    flat = rms_norm(x, lp["ln2"], cfg.norm_eps).reshape(b * s, h)
    router_logits = flat.float() @ lp["router"]
    moe_out, aux, z = ep_ops.moe_ffn(
        flat,
        router_logits,
        lp["we_gate"].to(flat.dtype),
        lp["we_up"].to(flat.dtype),
        lp["we_down"].to(flat.dtype),
        num_selected=cfg.moe_topk,
        capacity_factor=cfg.capacity_factor,
        impl=cfg.moe_impl,
    )
    x = x + moe_out.reshape(b, s, h)
    return x, cfg.aux_loss_weight * aux + cfg.z_loss_weight * z


def _layer_at(blocks: Params, i: int, x: torch.Tensor, cfg: FlagshipConfig):
    return _layer(x, {k: blocks[k][i] for k in _BLOCK_KEYS}, cfg)


def _logits_aux(params: Params, tokens: torch.Tensor, cfg: FlagshipConfig):
    """tokens [B, S] -> (logits [B, S, V] f32, aux summed over layers and
    microbatches). The GPipe schedule at pp = 1 is a loop over
    microbatches."""
    b, s = tokens.shape
    m = cfg.n_microbatches
    if b % m:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    x = params["embed"][tokens.long()].to(cfg.dtype)
    outs, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
    for xm in x.reshape(m, b // m, s, cfg.dim):
        aux_mb = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_layers):
            step = partial(_layer_at, params["blocks"], i, cfg=cfg)
            if cfg.remat == "full":
                # recompute the whole block in backward (jax.checkpoint)
                xm, a = checkpoint(step, xm, use_reentrant=False)
            else:
                xm, a = step(xm)
            aux_mb = aux_mb + a
        outs.append(xm)
        aux = aux + aux_mb
    x = torch.stack(outs).reshape(b, s, cfg.dim)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x.float() @ params["head"], aux


def forward(params: Params, tokens: torch.Tensor, cfg: FlagshipConfig) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] (float32)."""
    return _logits_aux(params, tokens, cfg)[0]


def loss_fn(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: FlagshipConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean loss including aux; returns (total_loss, ce_loss)."""
    logits, aux = _logits_aux(params, tokens, cfg)
    v = logits.shape[-1]
    loss = torch.mean(tp_cross_entropy(logits.reshape(-1, v), targets.reshape(-1)))
    return loss + aux / (cfg.n_layers * cfg.n_microbatches), loss


# ---------------------------------------------------------------------------
# Training


def make_train_step(cfg: FlagshipConfig, device: DeviceLike = None,
                    learning_rate: float = 3e-4):
    """Returns (train_step, init_optimizer), as the JAX model does.

    ``train_step(params, opt_state, tokens, targets) -> (params, opt_state,
    metrics)`` takes one AdamW step equal to ``optax.adamw(learning_rate,
    weight_decay=0.01)`` (b1 0.9, b2 0.999, eps 1e-8, decay on every leaf).
    Unlike the JAX step it updates ``params`` and ``opt_state`` in place,
    which saves a copy of every parameter and moment, and returns the same
    objects. Tokens and targets move to ``device`` if they are elsewhere."""
    dev = resolve_device(device)
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, 0.01

    def init_optimizer(params: Params) -> Dict[str, Any]:
        return {
            "count": 0,
            "mu": _tree_map(torch.zeros_like, params),
            "nu": _tree_map(torch.zeros_like, params),
        }

    def train_step(params: Params, opt_state: Dict[str, Any], tokens, targets):
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        tokens = torch.as_tensor(tokens, device=dev)
        targets = torch.as_tensor(targets, device=dev)
        total, ce = loss_fn(params, tokens, targets, cfg)
        grads = torch.autograd.grad(total, leaves)
        count = opt_state["count"] + 1
        bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        with torch.no_grad():
            for p, g, mu, nu in zip(leaves, grads, tree_leaves(opt_state["mu"]),
                                    tree_leaves(opt_state["nu"])):
                mu.mul_(b1).add_(g, alpha=1.0 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                p.sub_(learning_rate * (update + wd * p))
        opt_state["count"] = count
        return params, opt_state, {"loss": total.detach(), "ce": ce.detach()}

    return train_step, init_optimizer


# ---------------------------------------------------------------------------
# Dense single-device reference (oracle for tests)


def _mm(eq: str, *ts: torch.Tensor) -> torch.Tensor:
    """einsum with JAX's type promotion (bf16 x f32 computes in f32)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(eq, *(t.to(dt) for t in ts))


def reference_forward(params: Params, tokens: torch.Tensor, cfg: FlagshipConfig) -> torch.Tensor:
    """Unsharded oracle of the same math: plain attention and the dense
    one-hot MoE. As in the JAX reference, weights are not cast to the
    activation dtype: mixed products promote."""
    b, s = tokens.shape
    x = params["embed"][tokens.long()].to(cfg.dtype)
    pos = torch.arange(s, device=x.device)
    d = cfg.head_dim
    for i in range(cfg.n_layers):
        lp = {k: params["blocks"][k][i] for k in _BLOCK_KEYS}
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = _mm("bsh,hf->bsf", h, lp["wq"]).reshape(b, s, cfg.n_heads, d)
        k = _mm("bsh,hf->bsf", h, lp["wk"]).reshape(b, s, cfg.n_kv_heads, d)
        v = _mm("bsh,hf->bsf", h, lp["wv"]).reshape(b, s, cfg.n_kv_heads, d)
        q, k = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)
        attn = attention_reference(q, k, v, causal=True).reshape(b, s, -1)
        x = x + _mm("bsf,fh->bsh", attn, lp["wo"])
        flat = rms_norm(x, lp["ln2"], cfg.norm_eps).reshape(b * s, cfg.dim)
        logits = flat.float() @ lp["router"]
        cap = max(1, int(cfg.capacity_factor * flat.shape[0] * cfg.moe_topk / cfg.moe_experts))
        r = ep_ops.route_topk(logits, cfg.moe_topk, cap)
        xe = _mm("tec,th->ech", r.dispatch_mask.to(flat.dtype), flat)
        act = F.silu(_mm("ech,ehf->ecf", xe, lp["we_gate"])) * _mm(
            "ech,ehf->ecf", xe, lp["we_up"]
        )
        ye = _mm("ecf,efh->ech", act, lp["we_down"])
        x = x + _mm("tec,ech->th", r.combine_weights.to(ye.dtype), ye).reshape(b, s, cfg.dim)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x.float() @ params["head"]
