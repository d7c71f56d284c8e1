"""Dense (Llama-family) transformer: what serving needs of the second model.

Port of part of ``uccl_tpu/models/dense.py``: :class:`DenseConfig` and
:func:`init_params`, the parameter tree the dense serving stack
(``models/inference.py``) runs. Dense training (the JAX module's
``forward`` / ``loss_fn`` / ``make_train_step``) is not ported yet.

``params_from_jax`` / ``params_to_numpy`` carry a JAX parameter tree to
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


def init_params(cfg: DenseConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random f32 parameters with the JAX model's scales (normal * 1/sqrt(fan
    in), embeddings * 0.02, norms at 1), drawn from ``generator`` on the CPU
    and moved to ``device``. The numbers differ from the JAX init of the
    same seed; use :func:`params_from_jax` to share weights."""
    dev = resolve_device(device)
    h, l, f = cfg.dim, cfg.n_layers, cfg.ffn
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    s_in, s_f = 1.0 / math.sqrt(h), 1.0 / math.sqrt(f)

    def rnd(shape, scale):
        return (torch.randn(shape, generator=generator) * scale).to(dev)

    return {
        "embed": rnd((cfg.vocab, h), 0.02),
        "blocks": {
            "ln1": torch.ones((l, h), device=dev),
            "ln2": torch.ones((l, h), device=dev),
            "wq": rnd((l, h, qd), s_in),
            "wk": rnd((l, h, kvd), s_in),
            "wv": rnd((l, h, kvd), s_in),
            "wo": rnd((l, qd, h), 1.0 / math.sqrt(qd)),
            "w_gate": rnd((l, h, f), s_in),
            "w_up": rnd((l, h, f), s_in),
            "w_down": rnd((l, f, h), s_f),
        },
        "final_norm": torch.ones((h,), device=dev),
        "head": rnd((h, cfg.vocab), s_in),
    }
