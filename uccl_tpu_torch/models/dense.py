"""Dense (Llama-family) transformer: what serving needs of the second model.

Port of part of ``uccl_tpu/models/dense.py``: :class:`DenseConfig` and
:func:`init_params`, the parameter tree the dense serving stack
(``models/inference.py``) runs. Dense training (the JAX module's
``forward`` / ``loss_fn`` / ``make_train_step``) is not ported yet.

``init_params(prng_key(seed), cfg)`` draws the JAX init's weights for the
same seed. ``params_from_jax`` / ``params_to_numpy`` carry a JAX parameter tree to
this package and back through numpy: names and layouts are the same, and
nothing is transposed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from uccl_tpu_torch import DeviceLike, resolve_device
from uccl_tpu_torch.models.flagship import params_from_jax, params_to_numpy  # noqa: F401
from uccl_tpu_torch.models.sampling import normal, split

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
    remat: str = "full"
    seq_mode: str = "ring"
    attn_impl: str = "auto"
    dtype: torch.dtype = torch.float32  # serving: activations, KV and logits


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
