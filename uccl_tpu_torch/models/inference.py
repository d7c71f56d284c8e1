"""KV-cache inference for the dense model: prefill / decode / generate, and
the slot-pool primitives the continuous-batching engine runs.

Port of ``uccl_tpu/models/inference.py``. The JAX package runs this math as
XLA code outside any Pallas kernel, so it ports to plain torch ops: the
attention over the cache is two einsums with a masked softmax between them.

Activations and KV caches take ``cfg.dtype`` (float32 by default, as in
the JAX package); the attention scores and the vocab head compute in
float32, as the JAX package's ``preferred_element_type`` and casts do.

Caches are tuples of tensors that the forward writes in place (a slice for
the one-shot path, an index write for the slot pool) instead of the JAX
package's functional updates; the primitives return the same cache
objects, their lengths updated. Eager PyTorch compiles nothing, so
the JAX module's per-shape compiled-program cache has no counterpart.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from uccl_tpu_torch import DeviceLike, resolve_device
from uccl_tpu_torch.models.dense import DenseConfig
from uccl_tpu_torch.models.layers import rms_norm, rope
from uccl_tpu_torch.models.sampling import broadcast_params, sample_tokens, sample_window
from uccl_tpu_torch.ops.attention import _NEG_INF, _repeat_kv
from uccl_tpu_torch.p2p.endpoint import host_copy


def _dev_of(params) -> torch.device:
    return params["embed"].device


def _as(x, device, dtype) -> torch.Tensor:
    """A host array or tensor as a tensor of ``dtype`` on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if not x.flags.writeable:  # torch wraps only writable host memory
            x = x.copy()
    return torch.as_tensor(x, device=device).to(dtype)


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, S_max, Hkv, D]
    v: torch.Tensor  # [L, B, S_max, Hkv, D]
    length: int  # valid prefix length

    @staticmethod
    def empty(cfg, batch: int, max_seq: int, dtype=None,
              device: DeviceLike = None) -> "KVCache":
        dev = resolve_device(device)
        dtype = dtype or cfg.dtype
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                       torch.zeros(shape, dtype=dtype, device=dev), 0)


def _attend_cached(q, k_cache, v_cache, length, cfg) -> torch.Tensor:
    """q: [B, Sq, H, D] at positions [length, length+Sq); cache: [B, Smax,
    Hkv, D]. Masked attention over the cache prefix and the new causal block.

    ``length`` is an int (one shared prefix, the one-shot path) or a ``[B]``
    tensor of per-sequence prefixes (the slot pool): the mask math is the
    same, only its batch rank differs, so both paths give the same rows for
    equal per-row (length, prefix)."""
    b, sq, h, d = q.shape
    smax = k_cache.shape[1]
    n_rep = h // cfg.n_kv_heads
    kk = _repeat_kv(k_cache, n_rep)
    vv = _repeat_kv(v_cache, n_rep)
    # the JAX package's preferred_element_type=f32
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float())
    s = s / math.sqrt(d)
    kpos = torch.arange(smax, device=q.device)
    if isinstance(length, int):
        qpos = length + torch.arange(sq, device=q.device)[:, None]  # [Sq, 1]
        mask = (kpos[None, :] <= qpos)[None, None]  # attend at or before own position
    else:
        qpos = length.long()[:, None] + torch.arange(sq, device=q.device)[None, :]  # [B, Sq]
        mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]  # [B, 1, Sq, Smax]
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(vv.dtype), vv)


def _layer_params(params, i: int) -> dict:
    return {name: leaf[i] for name, leaf in params["blocks"].items()}


def _dense_ffn(h2, lp) -> torch.Tensor:
    act = F.silu(h2 @ lp["w_gate"].to(h2.dtype)) * (h2 @ lp["w_up"].to(h2.dtype))
    return act @ lp["w_down"].to(act.dtype)


def _head(x, params, cfg) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x.float() @ params["head"].float()


def _forward_cached(params, tokens, cache: KVCache, cfg, ffn=None,
                    last_only: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """Run tokens [B, S] starting at ``cache.length``; writes their KV into
    the cache in place and returns (logits [B, S, V], or [B, V] of the last
    position under ``last_only``, and the cache with its length advanced).

    ``ffn(h2, layer_params) -> [B, S, H]`` overrides the dense SwiGLU block:
    the hook the MoE serving loop uses, so the attention and KV-cache math
    exists once (``models/moe_inference.py``)."""
    b, s = tokens.shape
    start = cache.length
    if start + s > cache.k.shape[2]:
        raise ValueError(f"{s} tokens at position {start} overflow the cache "
                         f"({cache.k.shape[2]} rows)")
    x = params["embed"][tokens.long()].to(cache.k.dtype)
    positions = torch.arange(start, start + s, device=x.device)
    d = cfg.head_dim
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = (h @ lp["wq"].to(h.dtype)).reshape(b, s, cfg.n_heads, d)
        kk = (h @ lp["wk"].to(h.dtype)).reshape(b, s, cfg.n_kv_heads, d)
        v = (h @ lp["wv"].to(h.dtype)).reshape(b, s, cfg.n_kv_heads, d)
        q = rope(q, positions, cfg.rope_theta)
        kk = rope(kk, positions, cfg.rope_theta)
        cache.k[i, :, start:start + s] = kk
        cache.v[i, :, start:start + s] = v
        attn = _attend_cached(q, cache.k[i], cache.v[i], start, cfg)
        x = x + attn.reshape(b, s, -1) @ lp["wo"].to(attn.dtype)
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + (_dense_ffn(h2, lp) if ffn is None else ffn(h2, lp))
    logits = _head(x[:, -1] if last_only else x, params, cfg)
    return logits, KVCache(cache.k, cache.v, start + s)


def prefill(params, tokens, cfg: DenseConfig, max_seq: int) -> Tuple[torch.Tensor, KVCache]:
    """Process the prompt; returns (last-position logits [B, V], warm cache)."""
    tokens = _as(tokens, _dev_of(params), torch.int64)
    if tokens.shape[1] > max_seq:
        raise ValueError(f"prompt length {tokens.shape[1]} exceeds max_seq {max_seq}")
    cache = KVCache.empty(cfg, tokens.shape[0], max_seq, device=_dev_of(params))
    return _forward_cached(params, tokens, cache, cfg, last_only=True)


def decode_step(params, token, cache: KVCache, cfg: DenseConfig):
    """token: [B] — one autoregressive step. Returns (logits [B, V], cache')."""
    token = _as(token, _dev_of(params), torch.int64)
    logits, cache = _forward_cached(params, token[:, None], cache, cfg)
    return logits[:, 0], cache


def decode_step_elastic(params, token, ekv, cfg: DenseConfig):
    """One autoregressive step over an :class:`uccl_tpu_torch.ep.elastic.ElasticKVCache`.

    Same contract as :func:`decode_step`, but the KV context comes from the
    elastic cache (hot blocks in HBM, cold blocks staged from pinned host
    memory), so decode length is bounded by host memory, not HBM. Returns
    logits [B, V]; the cache is updated with the new token's KV.

    The gathered context is a dense [L, B, S_blocks, Hkv, D] view whose
    first ``length`` positions are valid — position ``length`` itself is the
    partial block's next empty slot, which is exactly where
    :func:`_forward_cached` writes the new token. The dense forward path is
    therefore reused verbatim, so on a cache of the same row count the
    logits are :func:`decode_step`'s bit for bit.
    """
    k_ctx, v_ctx, length = ekv.kv()
    view = KVCache(k_ctx, v_ctx, length)
    token = _as(token, _dev_of(params), torch.int64)
    logits, view = _forward_cached(params, token[:, None], view, cfg)
    sl = (slice(None), slice(None), slice(length, length + 1))
    ekv.append_tokens(view.k[sl], view.v[sl])
    return logits[:, 0]


# -- slot-pool serving primitives ------------------------------------------
#
# The continuous-batching engine (uccl_tpu_torch/serving) holds ONE fixed
# [B_slots, S_max] KV cache and reuses rows ("slots") across requests. The
# primitive is a masked forward: tokens land at per-slot positions, cache
# writes are gated per slot (an inactive or padded slot's rows never
# change), and attention masks per slot. Everything else is the one-shot
# code above.


class SlotKVCache(NamedTuple):
    k: torch.Tensor  # [L, B_slots, S_max, Hkv, D]
    v: torch.Tensor  # [L, B_slots, S_max, Hkv, D]
    lengths: torch.Tensor  # [B_slots] int32 — per-slot valid prefix

    @staticmethod
    def empty(cfg, n_slots: int, max_seq: int, dtype=None,
              device: DeviceLike = None) -> "SlotKVCache":
        dev = resolve_device(device)
        dtype = dtype or cfg.dtype
        shape = (cfg.n_layers, n_slots, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return SlotKVCache(torch.zeros(shape, dtype=dtype, device=dev),
                           torch.zeros(shape, dtype=dtype, device=dev),
                           torch.zeros((n_slots,), dtype=torch.int32, device=dev))

    # -- slot KV export/import views (the disaggregation surface) ----------
    #
    # One slot's rows as host arrays, and the inverse: raw float32 rows, so
    # an import continues exactly where the export left off. Rows beyond
    # the stamped length carry stale data and are dead by the
    # masked-attention invariant.

    def export_rows(self, slot: int, lo: int, hi: int):
        """Host copies of rows [lo, hi): (k, v) each [L, hi-lo, Hkv, D].
        Copies on any device (a CPU tensor's ``.cpu()`` would be the pool's
        own memory, which the slot's next occupant overwrites); rows on the
        card are staged through pinned host memory."""
        return tuple(host_copy(t[:, slot, lo:hi]).numpy() for t in (self.k, self.v))

    def import_rows(self, slot: int, k_rows, v_rows, *, length: int) -> "SlotKVCache":
        """Rows [0, n) of ``slot`` replaced by ``k_rows``/``v_rows``
        ([L, n, Hkv, D]); the slot's length becomes ``length``. In place;
        returns the cache."""
        n = np.shape(k_rows)[1]
        self.k[:, slot, :n] = _as(k_rows, self.k.device, self.k.dtype)
        self.v[:, slot, :n] = _as(v_rows, self.v.device, self.v.dtype)
        self.lengths[slot] = length
        return self

    def copy_prefix(self, dst: int, src: int, n: int) -> "SlotKVCache":
        """Copy slot ``src``'s row into slot ``dst`` and stamp dst's length
        to n (the prefix-cache hit path). In place; returns the cache."""
        self.k[:, dst] = self.k[:, src]
        self.v[:, dst] = self.v[:, src]
        self.lengths[dst] = n
        return self


def _lora_delta(h, table, ids, layer):
    """Batched per-slot fused LoRA delta: gather each slot's rank-padded
    (A, B) pair from the stacked tables by adapter row id and add ``(h @ A)
    @ B`` beside the base matmul. ``table``: (A [L, T, H, R_max], B [L, T,
    R_max, out]); ``ids``: [B] — row 0 is all zeros, so adapter-free slots
    compute an exact-0.0 delta."""
    a, bb = table
    al = a[layer][ids.long()].to(h.dtype)   # [B, H, R_max]
    bl = bb[layer][ids.long()].to(h.dtype)  # [B, R_max, out]
    return torch.einsum("bsr,bro->bso", torch.einsum("bsh,bhr->bsr", h, al), bl)


def _forward_slots(params, tokens, cache: SlotKVCache, start, write_mask, cfg, ffn=None,
                   adapters=None, adapter_ids=None, logits_at=None) -> torch.Tensor:
    """Masked batched forward: tokens [B, S] at positions [start_b, start_b+S).

    ``write_mask`` [B] bool gates every cache write: a masked slot's KV rows
    stay as they were, and rows past the cache end are dropped, as the JAX
    scatter's ``mode="drop"`` does. Lengths are not advanced here. Returns
    logits [B, S, V], or [B, V] at window positions ``logits_at`` [B].

    ``adapters`` = ``{"wq": (A, B), "wv": (A, B)}`` stacked LoRA tables and
    ``adapter_ids`` [B] fuse a per-slot low-rank delta onto the query and
    value projections (:func:`_lora_delta`)."""
    b, s = tokens.shape
    smax = cache.k.shape[2]
    dev = tokens.device
    x = params["embed"][tokens.long()].to(cache.k.dtype)
    positions = start.long()[:, None] + torch.arange(s, device=dev)[None, :]  # [B, S]
    rows, cols = (write_mask.bool()[:, None] & (positions < smax)).nonzero(as_tuple=True)
    wpos = positions[rows, cols]
    d = cfg.head_dim
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q2 = h @ lp["wq"].to(h.dtype)
        v2 = h @ lp["wv"].to(h.dtype)
        if adapters is not None:
            q2 = q2 + _lora_delta(h, adapters["wq"], adapter_ids, i)
            v2 = v2 + _lora_delta(h, adapters["wv"], adapter_ids, i)
        q = q2.reshape(b, s, cfg.n_heads, d)
        kk = (h @ lp["wk"].to(h.dtype)).reshape(b, s, cfg.n_kv_heads, d)
        v = v2.reshape(b, s, cfg.n_kv_heads, d)
        q = rope(q, positions, cfg.rope_theta)
        kk = rope(kk, positions, cfg.rope_theta)
        k_cache, v_cache = cache.k[i], cache.v[i]
        k_cache[rows, wpos] = kk[rows, cols]
        v_cache[rows, wpos] = v[rows, cols]
        attn = _attend_cached(q, k_cache, v_cache, start, cfg)
        x = x + attn.reshape(b, s, -1) @ lp["wo"].to(attn.dtype)
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + (_dense_ffn(h2, lp) if ffn is None else ffn(h2, lp))
    if logits_at is not None:
        x = x[torch.arange(b, device=dev), logits_at.long()]
    return _head(x, params, cfg)


def _slot_inputs(dev, tokens, *masks_and_ints):
    """The slot primitives' arguments as tensors on ``dev``."""
    out = [_as(tokens, dev, torch.int64)]
    for x, dt in masks_and_ints:
        out.append(None if x is None else _as(x, dev, dt))
    return out


def prefill_slots(params, tokens, prompt_lens, new_mask, cache: SlotKVCache,
                  cfg: DenseConfig, start=None, sampling=None, adapters=None,
                  adapter_ids=None) -> Tuple[torch.Tensor, SlotKVCache]:
    """Masked batched prefill of newly admitted slots — resumable.

    tokens: [B_slots, S] prompt windows right-padded to S (rows of slots not
    in ``new_mask`` are ignored); prompt_lens: [B_slots] full prompt
    lengths; new_mask: [B_slots] bool; start: [B_slots] per-slot offsets
    (None = zeros, the whole-prompt path). Row b carries prompt positions
    [start_b, start_b+S): KV is written only there, attention covers
    [0, start_b+S) causally.

    Returns (next token [B_slots] int32, meaningful only for rows whose
    window reaches the prompt end, and the cache with lengths set to
    min(start+S, prompt_lens) on admitted slots). The token is the argmax,
    or with ``sampling`` = per-slot ``(seeds, pos0, temp, top_p, top_k)``
    the lockstep-keyed sample at output position ``pos0``."""
    dev = cache.k.device
    tokens, prompt_lens, new_mask, start, adapter_ids = _slot_inputs(
        dev, tokens, (prompt_lens, torch.int64), (new_mask, torch.bool), (start, torch.int64),
        (adapter_ids, torch.int64))
    if start is None:
        start = torch.zeros_like(prompt_lens)
    s = tokens.shape[1]
    last_idx = torch.clamp(prompt_lens - 1 - start, 0, s - 1)
    last = _forward_slots(params, tokens, cache, start, new_mask, cfg, adapters=adapters,
                          adapter_ids=adapter_ids, logits_at=last_idx)
    if sampling is None:
        tok = torch.argmax(last, dim=-1).to(torch.int32)
    else:
        seeds, pos0, temp, top_p, top_k = sampling
        tok = sample_tokens(seeds, pos0, last, temp, top_p, top_k)
    lengths = torch.where(new_mask, torch.minimum(start + s, prompt_lens), cache.lengths.long())
    cache.lengths.copy_(lengths)
    return tok, cache


def verify_slots(params, tokens, active, cache: SlotKVCache, cfg: DenseConfig,
                 sampling=None, adapters=None, adapter_ids=None):
    """Batched draft verification — the speculative-decoding primitive,
    generalising :func:`decode_step_slots` from one token to a window.

    tokens: [B_slots, S], column 0 each slot's last committed token and
    columns 1..S-1 its drafted continuation; active: [B_slots] bool. The
    window runs at positions [length, length+S). Greedy acceptance is the
    longest draft prefix matching the window's own outputs; active slots
    advance their length by ``n_accepted + 1``. With ``sampling``, window
    column j is sampled under the key of output position ``pos0 + j``.

    Returns (target tokens [B_slots, S], n_accepted [B_slots], cache')."""
    dev = cache.k.device
    tokens, active, adapter_ids = _slot_inputs(dev, tokens, (active, torch.bool),
                                               (adapter_ids, torch.int64))
    logits = _forward_slots(params, tokens, cache, cache.lengths, active, cfg,
                            adapters=adapters, adapter_ids=adapter_ids)
    if sampling is None:
        tok = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, S]
    else:
        seeds, pos0, temp, top_p, top_k = sampling
        tok = sample_window(seeds, pos0, logits, temp, top_p, top_k)
    n_acc = greedy_acceptance(tokens, tok)
    cache.lengths.copy_(spec_advance(cache.lengths, active, n_acc))
    return tok, n_acc, cache


def greedy_acceptance(tokens, tok) -> torch.Tensor:
    """The acceptance rule both stacks' verify primitives share: per row,
    the length of the longest draft prefix (``tokens[:, 1:]``) matching the
    window's own outputs (``tok[:, :-1]``)."""
    if tokens.shape[1] <= 1:
        return torch.zeros((tokens.shape[0],), dtype=torch.int32, device=tokens.device)
    match = (tokens[:, 1:] == tok[:, :-1]).to(torch.int32)
    return torch.sum(torch.cumprod(match, dim=1), dim=1).to(torch.int32)


def spec_advance(lengths, active, n_acc) -> torch.Tensor:
    """Post-verify cursor advance: active slots move by the accepted prefix
    plus the one target-computed token; inactive slots hold."""
    return (lengths + torch.where(active, n_acc + 1, 0)).to(torch.int32)


def decode_step_slots(params, token, active, cache: SlotKVCache, cfg: DenseConfig,
                      sampling=None, adapters=None, adapter_ids=None):
    """One masked autoregressive step over the slot pool — the S=1 case of
    :func:`verify_slots`. token/active: [B_slots]; inactive slots neither
    write nor advance. Returns (next token [B_slots], cache')."""
    token = _as(token, cache.k.device, torch.int64)
    tok, _, cache = verify_slots(params, token[:, None], active, cache, cfg, sampling=sampling,
                                 adapters=adapters, adapter_ids=adapter_ids)
    return tok[:, 0], cache


def generate(params, prompt, cfg: DenseConfig, *, max_new_tokens: int = 32,
             max_seq: int = 256, sampling=None) -> torch.Tensor:
    """Greedy (or, with ``sampling``, stochastic) generation.
    prompt: [B, S] -> int32 [B, max_new_tokens].

    ``sampling`` duck-types ``SamplingParams``: every batch row runs under
    the request's seed, output index ``i`` under key ``fold_in(seed, i)``
    — the sampled oracle the serving engine is held to."""
    prompt = _as(prompt, _dev_of(params), torch.int64)
    if prompt.shape[1] + max_new_tokens > max_seq:
        raise ValueError(
            f"prompt {prompt.shape[1]} + new {max_new_tokens} tokens exceed "
            f"max_seq {max_seq}: the cache would overflow")
    b = prompt.shape[0]
    logits, cache = prefill(params, prompt, cfg, max_seq)
    if sampling is not None:
        seeds, temps, tps, tks = broadcast_params(b, sampling.seed, sampling.temperature,
                                                  sampling.top_p, sampling.top_k,
                                                  device=logits.device)
    toks = []
    for i in range(max_new_tokens):
        if sampling is None:
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            tok = sample_tokens(seeds, torch.full((b,), i, device=logits.device), logits,
                                temps, tps, tks)
        toks.append(tok)
        if i + 1 < max_new_tokens:
            logits, cache = decode_step(params, tok, cache, cfg)
    return torch.stack(toks, dim=1)
