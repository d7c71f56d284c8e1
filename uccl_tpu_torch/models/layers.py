"""Shared model building blocks: RMSNorm, rotary embeddings, cross-entropy.

Port of ``uccl_tpu/models/layers.py``. ``tp_cross_entropy`` with no axis is
its world-1 form (the vocab is not sharded, so the JAX version's pmax/psum
are the identity and drop out); with an axis, the vocab-parallel loss over
member-stacked logits.
"""

from __future__ import annotations

from typing import Optional

import torch

from uccl_tpu_torch.collective import ops as cops


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


def tp_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                     vocab_offset: Optional[torch.Tensor] = None, axis=None) -> torch.Tensor:
    """Per-token cross-entropy ``lse - target logit`` in float32.

    No ``axis``: logits [T, V]; targets [T] token ids; returns [T]. With an
    ``axis`` (any name: the world is the leading dim) the vocab is sharded
    over it: logits [n, T, V_local] (member r's slice of the vocab), targets
    [n, T] global ids, vocab_offset [n] each slice's first id; returns [n,
    T], the same on every member. The log-sum-exp runs distributed, as the
    Megatron loss does: the max of the members' stopped maxima (pmax), the
    sum of their exp-sums (psum), and the target logit from the member that
    owns it (psum of the masked pick). The max is a numerical shift only; no
    gradient flows through it."""
    logits = logits.float()
    if axis is not None:
        n, v_local = logits.shape[0], logits.shape[-1]
        m = cops.all_reduce(torch.amax(logits, dim=-1).detach(), "max")
        sumexp = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
        lse = m + torch.log(cops.all_reduce(sumexp, "sum"))
        local = targets.long() - vocab_offset.reshape((n,) + (1,) * (targets.dim() - 1))
        in_range = (local >= 0) & (local < v_local)
        pick = torch.gather(logits, -1, local.clamp(0, v_local - 1)[..., None])[..., 0]
        tgt = cops.all_reduce(torch.where(in_range, pick, torch.zeros_like(pick)), "sum")
        return lse - tgt
    m = torch.amax(logits, dim=-1).detach()
    lse = m + torch.log(torch.sum(torch.exp(logits - m[:, None]), dim=-1))
    tgt = torch.gather(logits, -1, targets.long()[:, None])[:, 0]
    return lse - tgt
