"""Attention: the plain reference and the Hopper tile chooser.

Port of ``uccl_tpu/ops/attention.py`` (lines 31-105): :func:`_repeat_kv` and
:func:`attention_reference`, the plain oracle with finite ``-1e30`` masking,
take ``[B, S, H, D]`` tensors, support GQA (fewer KV heads than query heads)
and compute the scores in float32. :func:`auto_block` takes the place of the
JAX package's ``_auto_block``, whose 1024-row cap was a TPU v5e tuning.

Ring and Ulysses attention (context parallelism) are not ported yet.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30  # finite "masked" score: keeps softmax math NaN-free

# Rows of the tile each flash-attention CTA owns (csrc/flash_attention.cu is
# built for these); the streamed tile inside a CTA is always 64 rows.
HOPPER_TILES = (64, 128)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: repeat KV heads to match Q heads. [B,S,Hkv,D] -> [B,S,Hkv*n_rep,D]."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """[B,Sq,H,D] x [B,Sk,H,D] -> [B,H,Sq,Sk] in f32."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> torch.Tensor:
    """Full (single-shard) attention. Offsets give the absolute positions of
    the q/kv blocks, as in the JAX reference. Returns q's dtype."""
    n_rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, scale)
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device) + kv_offset
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask[None, None], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.to(q.dtype)


def auto_block(s: int) -> int:
    """CTA tile rows for a sequence of length ``s`` on Hopper, or 0 when no
    tile the kernels are built for divides ``s``.

    64 rows (one consumer warpgroup) is the default for every kernel: at the
    flagship's S = 1024, B = 8, H = 16 it gives 2048 CTAs per forward launch,
    about 15 waves over the H100's 132 SMs, and the least masked work on the
    causal diagonal; the forward, dQ and dK/dV kernels each measured faster
    at 64 rows than at 128 (PERF.md). 128-row tiles are built too and are
    selected with UCCL_TPU_FLASH_BLOCK_Q/K.
    """
    return 64 if s % 64 == 0 else 0
