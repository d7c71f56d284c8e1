"""Attention: the plain reference, the Hopper tile chooser, and context
parallelism (ring and Ulysses attention).

Port of ``uccl_tpu/ops/attention.py``: :func:`_repeat_kv` and
:func:`attention_reference`, the plain oracle with finite ``-1e30`` masking,
take ``[B, S, H, D]`` tensors, support GQA (fewer KV heads than query heads)
and compute the scores in float32. :func:`auto_block` takes the place of the
JAX package's ``_auto_block``, whose 1024-row cap was a TPU v5e tuning.

:func:`ring_attention` and :func:`ulysses_attention` are the JAX package's
per-shard functions over a context-parallel axis, member-stacked: q, k and v
are ``[n, B, S_local, H, D]``, row r being the sequence chunk at position r
of the axis (any name: the world is the leading dim, as in ``ep/ops``), and
the result is stacked the same way. The ring's KV rotation and Ulysses'
all-to-alls are the ``collective/ops`` verbs. With ``impl="flash"`` every
attention runs on the flash kernels (``ops/flash_attention``), all members
of a step in one launch (their chunks stacked along the kernel's batch).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from uccl_tpu_torch.collective import ops as cops
from uccl_tpu_torch.utils.topology import ppermute_pairs

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


# ---------------------------------------------------------------------------
# Context parallelism


def _block_attend(q, k, v, m, l, o, scale, mask):
    """One online-softmax accumulation step.

    q: [B,Sq,H,D]; k,v: [B,Sk,H,D] (heads already repeated); mask: bool,
    broadcastable to [B,H,Sq,Sk], or None; m,l: [B,H,Sq] f32 running max /
    normalizer; o: [B,Sq,H,D] f32."""
    s = _scores(q, k, scale)  # [B,H,Sq,Sk]
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m_blk = torch.amax(s, dim=-1)
    m_new = torch.maximum(m, m_blk)
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * corr + torch.sum(p, dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def _merge_blocks(o_acc, lse_acc, o_blk, lse_blk):
    """Merge two normalized blockwise attention results via their LSEs.

    o: [..., Sq, H, D] f32 (each already softmax-normalized over its own
    keys); lse: [..., H, Sq]. Differentiable in both lse's."""
    m = torch.maximum(lse_acc, lse_blk)
    w_acc = torch.exp(lse_acc - m)
    w_blk = torch.exp(lse_blk - m)
    denom = w_acc + w_blk

    def bcast(w):  # [..., H, Sq] -> [..., Sq, H, 1]
        return w.transpose(-1, -2)[..., None]

    o = (o_acc * bcast(w_acc) + o_blk * bcast(w_blk)) / bcast(denom)
    return o, m + torch.log(denom)


def _members_as_batch(t: torch.Tensor) -> torch.Tensor:
    """[n, B, S, H, D] -> [n*B, S, H, D]: the members' chunks as one batch."""
    return t.reshape((-1,) + tuple(t.shape[2:]))


def _repeat_kv_members(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    return _repeat_kv(_members_as_batch(k), n_rep).reshape(k.shape[:3] + (-1, k.shape[-1]))


def _flash_ring(q, k, v, causal, block_q, block_k):
    """Ring attention with the flash kernels as the per-block compute.

    Step 0 is every member's own (causal-diagonal) block: one causal
    launch over all members. At step t >= 1 member r holds the KV chunk of
    member r - t (the ring rotated t times); with causal masking that chunk
    is fully visible to the members r >= t and fully masked for the others,
    so one non-causal launch covers exactly the members r >= t (the JAX
    ``lax.cond`` skip: the members left out keep their accumulators, which
    is what merging its lse = -1e30, o = 0 block gives, bit for bit, and
    what its gradient is). Without masking every member is in every launch.
    So a call makes n forward launches, and its backward n dQ and n dK/dV
    launches. Blocks merge through the differentiable LSE merge (the lse
    cotangent reaches the backward kernels through ``delta``)."""
    from uccl_tpu_torch.ops.flash_attention import flash_attention_lse

    n, b, sq, h, d = q.shape
    o0, lse0 = flash_attention_lse(_members_as_batch(q), _members_as_batch(k),
                                   _members_as_batch(v), causal, block_q, block_k)
    o = o0.float().reshape(n, b, sq, h, d)
    if n == 1:
        return o.to(q.dtype)
    lse = lse0.reshape(n, b, h, sq)
    perm = ppermute_pairs(n, 1)
    k_blk, v_blk = k, v
    for t in range(1, n):
        k_blk, v_blk = cops.ppermute(k_blk, perm), cops.ppermute(v_blk, perm)
        lo = t if causal else 0  # src = r - t is earlier than r exactly for r >= t
        ob, lb = flash_attention_lse(_members_as_batch(q[lo:]), _members_as_batch(k_blk[lo:]),
                                     _members_as_batch(v_blk[lo:]), False, block_q, block_k)
        om, lm = _merge_blocks(o[lo:], lse[lo:], ob.float().reshape(n - lo, b, sq, h, d),
                               lb.reshape(n - lo, b, h, sq))
        o = torch.cat([o[:lo], om]) if lo else om
        lse = torch.cat([lse[:lo], lm]) if lo else lm
    return o.to(q.dtype)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis: str = "cp",
    *,
    causal: bool = True,
    impl: str = "xla",
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Context-parallel attention over the leading (``axis``) dim.

    q: [n, B, S_local, H, D]; k, v: [n, B, S_local, Hkv, D]. Member r holds
    the sequence chunk at position r; KV chunks rotate around the ring so
    member r sees the chunks of r, r-1, r-2, ...; with causal masking the
    later-origin chunks contribute nothing.

    impl="flash" runs each block on the flash kernels and merges through
    the LSEs (:func:`_flash_ring`: n forward launches a call); impl="xla"
    runs the online-softmax block attends in plain torch, masking by
    absolute positions."""
    if impl == "flash":
        return _flash_ring(q, k, v, causal, block_q, block_k)
    n, b, sq, h, d = q.shape
    sk = k.shape[2]
    n_rep = h // k.shape[3]
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    r = torch.arange(n, device=dev)[:, None, None]
    qpos = torch.arange(sq, device=dev)[:, None]
    kpos = torch.arange(sk, device=dev)[None, :]
    perm = ppermute_pairs(n, 1)
    qb = _members_as_batch(q)
    m = torch.full((n * b, h, sq), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((n * b, h, sq), dtype=torch.float32, device=dev)
    o = torch.zeros((n * b, sq, h, d), dtype=torch.float32, device=dev)
    k_blk, v_blk = k, v
    for t in range(n):
        mask = None
        if causal:
            src = (r - t) % n  # absolute positions: q at r*sq + qpos, kv at src*sk + kpos
            mask = (r * sq + qpos) >= (src * sk + kpos)  # [n, Sq, Sk]
            mask = mask[:, None, None].expand(n, b, 1, sq, sk).reshape(n * b, 1, sq, sk)
        # GQA-repeat only at compute time: the ring carries the narrow KV
        m, l, o = _block_attend(qb, _repeat_kv(_members_as_batch(k_blk), n_rep),
                                _repeat_kv(_members_as_batch(v_blk), n_rep), m, l, o, scale,
                                mask)
        if t + 1 < n:
            k_blk, v_blk = cops.ppermute(k_blk, perm), cops.ppermute(v_blk, perm)
    l = torch.clamp_min(l, 1e-20)
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype).reshape(n, b, sq, h, d)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis: str = "cp",
    *,
    causal: bool = True,
    impl: str = "xla",
) -> torch.Tensor:
    """Ulysses sequence parallelism over the leading (``axis``) dim: an
    all-to-all turns the sequence sharding into a head sharding, attention
    runs over the full sequence on each member's head slice (with
    impl="flash" all members in one launch), and the inverse all-to-all
    restores the sequence sharding. q: [n, B, S_local, H, D]. Q heads must
    divide the axis size; KV heads are GQA-repeated up to the Q head count
    first when they do not."""
    n = q.shape[0]
    if q.shape[3] % n:
        raise ValueError(f"ulysses needs q heads divisible by axis size {n}: "
                         f"q{tuple(q.shape[1:])}")
    if k.shape[3] % n:
        rep = q.shape[3] // k.shape[3]
        k, v = _repeat_kv_members(k, rep), _repeat_kv_members(v, rep)

    def seq_to_heads(x):  # [B, S/n, H, D] -> [B, S, H/n, D] per member
        return cops.all_to_all(x, split_dim=2, concat_dim=1)

    def heads_to_seq(x):
        return cops.all_to_all(x, split_dim=1, concat_dim=2)

    qg, kg, vg = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    qf, kf, vf = (_members_as_batch(t) for t in (qg, kg, vg))
    if impl == "flash":
        from uccl_tpu_torch.ops.flash_attention import flash_attention

        out = flash_attention(qf, kf, vf, causal)
    else:
        out = attention_reference(qf, kf, vf, causal=causal)
    return heads_to_seq(out.reshape(qg.shape))
