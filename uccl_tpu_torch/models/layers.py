"""Shared model building blocks: RMSNorm, rotary embeddings, cross-entropy.

Port of ``uccl_tpu/models/layers.py``. ``tp_cross_entropy`` is its world-1
form: the vocab is not sharded, so the JAX version's pmax/psum are the
identity and drop out.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in float32 and cast back to x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding, split-half (Llama) convention.

    x: [B, S, H, D]; positions: [S] absolute positions, or [B, S]
    per-sequence positions.
    """
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freqs  # [(B,) S, half]
    cos = torch.cos(ang)[..., None, :]  # [(B,) S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    if positions.dim() == 1:
        cos, sin = cos[None], sin[None]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def tp_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy ``lse - target logit`` in float32.

    logits: [T, V]; targets: [T] token ids. Returns [T]. The max is a
    numerical shift only; no gradient flows through it."""
    logits = logits.float()
    m = torch.amax(logits, dim=-1).detach()
    lse = m + torch.log(torch.sum(torch.exp(logits - m[:, None]), dim=-1))
    tgt = torch.gather(logits, -1, targets.long()[:, None])[:, 0]
    return lse - tgt
