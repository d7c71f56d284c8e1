"""Dense (Llama-family) transformer: the second model family.

Port of ``uccl_tpu/models/dense.py``: :class:`DenseConfig`,
:func:`init_params` (the parameter tree the dense serving stack,
``models/inference.py``, runs too), :func:`param_specs` /
:func:`shard_params`, and training over the pp/dp/cp/tp mesh: ``forward``,
``loss_fn``, ``make_train_step`` (the flagship's AdamW, weight decay 0.01)
and the unsharded ``reference_forward``. The same parallel machinery as the
flagship, on the same member-grid tensors (``models/flagship``'s docstring):
a block is the flagship's attention (``flagship._attention``: the flash
kernels, ring or Ulysses over cp) and a Megatron-split SwiGLU MLP with its
psum over tp; the blocks run through the flagship's GPipe schedule
(``flagship.logits_aux``, each block under the config's remat wrapper).
Without a mesh a call runs at world 1. ``remat="mlp"`` is ``"dots"`` here,
as in the JAX package: the dense FFN has no expert tags for its save list to
match.

``init_params(prng_key(seed), cfg)`` draws the JAX init's weights for the
same seed. ``params_from_jax`` / ``params_to_numpy`` carry a JAX parameter tree to
this package and back through numpy: names and layouts are the same, and
nothing is transposed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from uccl_tpu_torch import DeviceLike, resolve_device
from uccl_tpu_torch.models import flagship as _fs
from uccl_tpu_torch.models.flagship import params_from_jax, params_to_numpy  # noqa: F401
from uccl_tpu_torch.models.layers import rms_norm, rope
from uccl_tpu_torch.models.sampling import normal, split
from uccl_tpu_torch.ops.attention import attention_reference
from uccl_tpu_torch.parallel import sharding as shd
from uccl_tpu_torch.parallel.mesh import AXIS, Mesh, MeshConfig, make_mesh
from uccl_tpu_torch.parallel.sharding import P

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DenseConfig:
    vocab: int = 1024
    dim: int = 256
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    head_dim: int = 32
    ffn: int = 768
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    n_microbatches: int = 1
    remat: str = "full"  # "full" | "dots" | "mlp" (= dots here) | "none"
    seq_mode: str = "ring"  # "ring" | "ulysses" (at cp > 1)
    attn_impl: str = "auto"
    dtype: torch.dtype = torch.float32  # activations (serving: also KV and logits)

    def __post_init__(self):
        _fs._check_common(self)


def param_specs(cfg: DenseConfig) -> Dict[str, Any]:
    """PartitionSpec tree matching :func:`init_params`' tree."""
    return {
        "embed": P(AXIS.TP, None),
        "blocks": {
            "ln1": P(AXIS.PP, None),
            "ln2": P(AXIS.PP, None),
            "wq": P(AXIS.PP, None, AXIS.TP),
            "wk": P(AXIS.PP, None, AXIS.TP),
            "wv": P(AXIS.PP, None, AXIS.TP),
            "wo": P(AXIS.PP, AXIS.TP, None),
            "w_gate": P(AXIS.PP, None, AXIS.TP),
            "w_up": P(AXIS.PP, None, AXIS.TP),
            "w_down": P(AXIS.PP, AXIS.TP, None),
        },
        "final_norm": P(None),
        "head": P(None, AXIS.TP),
    }


def shard_params(params: Params, mesh: Mesh, cfg: DenseConfig) -> Params:
    """The member-grid view of the global tree (``sharding.put_tree``)."""
    return shd.put_tree(mesh, params, param_specs(cfg))


def init_params(key: torch.Tensor, cfg: DenseConfig, device: DeviceLike = None) -> Params:
    """The JAX ``init_params(key, cfg)``: f32 parameters drawn on ``device``
    from ``key`` (``sampling.prng_key(seed)``, JAX's ``PRNGKey(seed)``) by
    the same ``split(key, 10)``, the same leaf order and the same scales
    (normal * 1/sqrt(fan in), embeddings * 0.02, norms at 1). The draws'
    bits equal JAX's; each normal lies within a few ulp of JAX's
    (``sampling.erf_inv``)."""
    dev = resolve_device(device)
    k = split(key.to(dev), 10)
    h, l, f = cfg.dim, cfg.n_layers, cfg.ffn
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    s_in, s_f = 1.0 / math.sqrt(h), 1.0 / math.sqrt(f)

    def rnd(i, shape, scale):
        return normal(k[i], shape) * scale

    return {
        "embed": rnd(0, (cfg.vocab, h), 0.02),
        "blocks": {
            "ln1": torch.ones((l, h), device=dev),
            "ln2": torch.ones((l, h), device=dev),
            "wq": rnd(1, (l, h, qd), s_in),
            "wk": rnd(2, (l, h, kvd), s_in),
            "wv": rnd(3, (l, h, kvd), s_in),
            "wo": rnd(4, (l, qd, h), 1.0 / math.sqrt(qd)),
            "w_gate": rnd(5, (l, h, f), s_in),
            "w_up": rnd(6, (l, h, f), s_in),
            "w_down": rnd(7, (l, f, h), s_f),
        },
        "final_norm": torch.ones((h,), device=dev),
        "head": rnd(8, (h, cfg.vocab), s_in),
    }


# ---------------------------------------------------------------------------
# Training


def _layer(x: torch.Tensor, lp: Params, cfg: DenseConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block on every member: x [*G, B, S_loc, H] -> (x, a zero aux [*G])."""
    gmm, w = _fs._gmm, _fs._w
    attn_out = _fs._attention(rms_norm(x, w(lp["ln1"], x), cfg.norm_eps), lp, cfg)
    x = x + shd.psum(attn_out, AXIS.TP)
    h2 = rms_norm(x, w(lp["ln2"], x), cfg.norm_eps)
    act = F.silu(gmm(h2, lp["w_gate"].to(h2.dtype))) * gmm(h2, lp["w_up"].to(h2.dtype))
    x = x + shd.psum(gmm(act, lp["w_down"].to(act.dtype)), AXIS.TP)
    return x, torch.zeros(x.shape[:shd.GRID_DIMS], dtype=torch.float32, device=x.device)


def forward(params: Params, tokens, cfg: DenseConfig, mesh: Optional[Mesh] = None):
    """tokens [B, S] -> logits [B, S, V] (float32), over ``mesh`` (default:
    world 1 on the parameters' device)."""
    return _fs.logits_aux(params, tokens, cfg, mesh, _layer, param_specs(cfg))[0]


def loss_fn(params: Params, tokens, targets, cfg: DenseConfig,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean next-token cross-entropy (each member's mean, averaged over the
    EP world dp x cp)."""
    mesh = _fs._mesh_of(mesh, params)
    logits, _ = _fs._per_shard_logits_aux(shard_params(params, mesh, cfg),
                                          _fs._put_data(mesh, tokens), cfg, _layer)
    per_token = _fs._tp_ce(logits, _fs._put_data(mesh, targets))
    loss = per_token.reshape(tuple(per_token.shape[:shd.GRID_DIMS]) + (-1,)).mean(-1)
    return shd.member0(shd.pmean(loss, AXIS.EP))


def make_train_step(cfg: DenseConfig, device: Union[DeviceLike, Mesh] = None,
                    learning_rate: float = 3e-4):
    """(train_step, init_optimizer): the flagship's AdamW step
    (``flagship.adamw_train_step``) on :func:`loss_fn`, over a
    :class:`Mesh` passed as ``device`` (any other device: world 1 on it);
    metrics hold the loss, as the JAX dense step's do."""
    mesh = device if isinstance(device, Mesh) else make_mesh(MeshConfig(), resolve_device(device))
    dev = mesh.device

    def loss(params, tokens, targets):
        total = loss_fn(params, tokens, targets, cfg, mesh)
        return total, {"loss": total.detach()}

    return _fs.adamw_train_step(loss, dev, learning_rate)


def reference_forward(params: Params, tokens: torch.Tensor, cfg: DenseConfig) -> torch.Tensor:
    """Unsharded oracle of the same math with plain attention. As in the JAX
    reference, weights are not cast to the activation dtype."""
    b, s = tokens.shape
    x = params["embed"][tokens.long()].to(cfg.dtype)
    pos = torch.arange(s, device=x.device)
    d = cfg.head_dim
    mm = _fs._mm
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in params["blocks"].items()}
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = mm("bsh,hf->bsf", h, lp["wq"]).reshape(b, s, cfg.n_heads, d)
        k = mm("bsh,hf->bsf", h, lp["wk"]).reshape(b, s, cfg.n_kv_heads, d)
        v = mm("bsh,hf->bsf", h, lp["wv"]).reshape(b, s, cfg.n_kv_heads, d)
        q, k = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)
        attn = attention_reference(q, k, v, causal=True).reshape(b, s, -1)
        x = x + mm("bsf,fh->bsh", attn, lp["wo"])
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        act = F.silu(mm("bsh,hf->bsf", h2, lp["w_gate"])) * mm("bsh,hf->bsf", h2, lp["w_up"])
        x = x + mm("bsf,fh->bsh", act, lp["w_down"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x.float() @ params["head"]
