"""Dense (Llama-family) transformer: the second model family, at world 1.

Port of ``uccl_tpu/models/dense.py`` on one device: :class:`DenseConfig`,
:func:`init_params` (the parameter tree the dense serving stack,
``models/inference.py``, runs too), and training: ``forward``, ``loss_fn``,
``make_train_step`` (the flagship's AdamW, weight decay 0.01) and the
unsharded ``reference_forward``. A block is the flagship's attention
(``flagship._attention``, so the flash kernels run here too) and a dense
SwiGLU MLP; the blocks run through the flagship's block loop
(``flagship.logits_aux``: the GPipe loop at pp = 1, each block under the
config's remat wrapper). ``remat="mlp"`` is ``"dots"`` here, as in the JAX
package: the dense FFN has no expert tags for its save list to match.

``init_params(prng_key(seed), cfg)`` draws the JAX init's weights for the
same seed. ``params_from_jax`` / ``params_to_numpy`` carry a JAX parameter tree to
this package and back through numpy: names and layouts are the same, and
nothing is transposed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from uccl_tpu_torch import DeviceLike, resolve_device
from uccl_tpu_torch.models import flagship as _fs
from uccl_tpu_torch.models.flagship import params_from_jax, params_to_numpy  # noqa: F401
from uccl_tpu_torch.models.layers import rms_norm, rope, tp_cross_entropy
from uccl_tpu_torch.models.sampling import normal, split
from uccl_tpu_torch.ops.attention import attention_reference

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
    seq_mode: str = "ring"
    attn_impl: str = "auto"
    dtype: torch.dtype = torch.float32  # activations (serving: also KV and logits)

    def __post_init__(self):
        if self.seq_mode != "ring":
            raise NotImplementedError(f"DenseConfig.seq_mode={self.seq_mode!r}: the world-1 "
                                      "port takes only 'ring'")
        _fs._check_common(self)


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
    """One block: x [B, S, H] -> (x, a zero aux)."""
    x = x + _fs._attention(rms_norm(x, lp["ln1"], cfg.norm_eps), lp, cfg)
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    act = F.silu(h2 @ lp["w_gate"].to(h2.dtype)) * (h2 @ lp["w_up"].to(h2.dtype))
    x = x + act @ lp["w_down"].to(act.dtype)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params: Params, tokens: torch.Tensor, cfg: DenseConfig) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] (float32)."""
    return _fs.logits_aux(params, tokens, cfg, _layer)[0]


def loss_fn(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: DenseConfig) -> torch.Tensor:
    """Mean next-token cross-entropy."""
    logits = forward(params, tokens, cfg)
    v = logits.shape[-1]
    return torch.mean(tp_cross_entropy(logits.reshape(-1, v), targets.reshape(-1)))


def make_train_step(cfg: DenseConfig, device: DeviceLike = None, learning_rate: float = 3e-4):
    """(train_step, init_optimizer): the flagship's AdamW step
    (``flagship.adamw_train_step``) on :func:`loss_fn`; metrics hold the
    loss, as the JAX dense step's do."""

    def loss(params, tokens, targets):
        total = loss_fn(params, tokens, targets, cfg)
        return total, {"loss": total.detach()}

    return _fs.adamw_train_step(loss, device, learning_rate)


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
