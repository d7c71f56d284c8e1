"""MoE serving: KV-cache prefill / decode / generate with EP-sharded experts.

Port of ``uccl_tpu/models/moe_inference.py``. Prefill routes the prompt
through the sorted EP path (``impl="sort"``), and decode runs each step
through the packed low-latency path (``impl="ll"``) by default; both reach
the ported ``ep/ops.moe_ffn``, whose ``pallas`` wire is the hand-written
all-to-all kernel B9 (``csrc/ep_a2a.cu``).

The JAX package runs every function here under ``shard_map`` over the
mesh's ``dp`` axis. The port keeps its member-stacked convention instead:
all W members live on one device, and the EP layer takes ``[W, ...]``
tensors. Everything outside the MoE layer is per-row math on replicated
weights, so the attention and the KV caches run over all ``W * B_loc``
rows at once (member w's rows are ``[w * B_loc, (w + 1) * B_loc)``), and
the MoE block regroups them as ``[W, B_loc * S, H]`` for ``moe_ffn``. So
the caches here are ``[L, W, B_loc, S_max, Hkv, D]`` (the JAX package's
are ``[W, L, B_loc, ...]``): a layer's slice then views as the dense
stack's ``[W * B_loc, ...]``. ``shard_params`` keeps one copy of every
replicated leaf and views each expert leaf ``[L, E, ...]`` as the members'
local experts ``[L, W, E_local, ...]``.

Parity property (tested): the same weights served as one member and as W
members generate the same tokens.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional

import torch

from uccl_tpu_torch import DeviceLike, resolve_device
from uccl_tpu_torch.ep import ops as ep_ops
from uccl_tpu_torch.models.flagship import params_from_jax, params_to_numpy  # noqa: F401
from uccl_tpu_torch.models.inference import (
    KVCache, SlotKVCache, _as, _forward_cached, _forward_slots, greedy_acceptance, spec_advance,
)
from uccl_tpu_torch.models.sampling import broadcast_params, sample_tokens, sample_window

_AXIS = "dp"  # the EP/serving axis of the mesh
_EXPERT_LEAVES = ("we_gate", "we_up", "we_down")


@dataclass(frozen=True)
class MoEServeConfig:
    vocab: int = 512
    dim: int = 128
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 32
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    moe_experts: int = 8
    moe_topk: int = 2
    moe_ffn: int = 256
    capacity_factor: float = 8.0  # ample by default: serving wants no drops
    moe_wire: str = "lax"  # "lax" | "pallas" (the hand-written a2a kernel B9)
    moe_chunks: int = 0  # pallas chunk-pipeline depth (0 = auto)
    wire_dtype: Optional[str] = None  # None | "fp8" | "int8": quantized EP wire


def _cache_shape(cfg, world, batch_local, max_seq):
    return (cfg.n_layers, world, batch_local, max_seq, cfg.n_kv_heads, cfg.head_dim)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``[L, W, B_loc, ...]`` cache -> the dense stack's ``[L, W*B_loc, ...]``
    view."""
    return t.view(t.shape[0], t.shape[1] * t.shape[2], *t.shape[3:])


class MoEKVCache(NamedTuple):
    k: torch.Tensor  # [L, W, B_loc, S_max, Hkv, D]
    v: torch.Tensor
    length: int  # valid prefix length, shared by every row

    @staticmethod
    def empty(cfg: MoEServeConfig, world: int, batch_local: int, max_seq: int,
              dtype=torch.float32, device: DeviceLike = None) -> "MoEKVCache":
        dev = resolve_device(device)
        shape = _cache_shape(cfg, world, batch_local, max_seq)
        return MoEKVCache(torch.zeros(shape, dtype=dtype, device=dev),
                          torch.zeros(shape, dtype=dtype, device=dev), 0)


class MoESlotCache(NamedTuple):
    """Slot-pool KV cache: one length per slot. Flat slot ``s`` is grid row
    ``(s // B_loc, s % B_loc)``."""

    k: torch.Tensor  # [L, W, B_loc, S_max, Hkv, D]
    v: torch.Tensor
    lengths: torch.Tensor  # [W, B_loc] int32

    @staticmethod
    def empty(cfg: MoEServeConfig, world: int, batch_local: int, max_seq: int,
              dtype=torch.float32, device: DeviceLike = None) -> "MoESlotCache":
        dev = resolve_device(device)
        shape = _cache_shape(cfg, world, batch_local, max_seq)
        return MoESlotCache(torch.zeros(shape, dtype=dtype, device=dev),
                            torch.zeros(shape, dtype=dtype, device=dev),
                            torch.zeros((world, batch_local), dtype=torch.int32, device=dev))

    def flat(self) -> SlotKVCache:
        """The same tensors as the dense stack's slot cache over ``W *
        B_loc`` slots (views: writes land in this cache)."""
        return SlotKVCache(_rows(self.k), _rows(self.v), self.lengths.view(-1))

    # -- slot KV export/import views: the dense stack's layout per slot, so
    # the disagg wire format is stack-independent

    def export_rows(self, slot: int, lo: int, hi: int):
        """Host copies of rows [lo, hi): (k, v) each [L, hi-lo, Hkv, D]."""
        return self.flat().export_rows(slot, lo, hi)

    def import_rows(self, slot: int, k_rows, v_rows, *, length: int) -> "MoESlotCache":
        self.flat().import_rows(slot, k_rows, v_rows, length=length)
        return self

    def copy_prefix(self, dst: int, src: int, n: int) -> "MoESlotCache":
        """Rows [0, n) of slot ``src`` into slot ``dst``; dst's length
        becomes n. In place; returns the cache."""
        flat = self.flat()
        flat.k[:, dst, :n] = flat.k[:, src, :n]
        flat.v[:, dst, :n] = flat.v[:, src, :n]
        flat.lengths[dst] = n
        return self


def init_params(cfg: MoEServeConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Global parameter tree (experts carry the full [E, ...] axis), f32,
    with the JAX model's scales, drawn from ``generator`` on the CPU and
    moved to ``device``. The numbers differ from the JAX init of the same
    seed; use :func:`params_from_jax` to share weights."""
    dev = resolve_device(device)
    h, l, f, e = cfg.dim, cfg.n_layers, cfg.moe_ffn, cfg.moe_experts
    qd = cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
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
            "router": rnd((l, h, e), s_in),
            "we_gate": rnd((l, e, h, f), s_in),
            "we_up": rnd((l, e, h, f), s_in),
            "we_down": rnd((l, e, f, h), s_f),
        },
        "final_norm": torch.ones((h,), device=dev),
        "head": rnd((h, cfg.vocab), s_in),
    }


def _moe_block(cfg: MoEServeConfig, impl: str, world: int):
    """The EP MoE FFN as an ``ffn`` hook of the dense forward: the ``[W *
    B_loc, S, H]`` rows regroup as each member's tokens ``[W, B_loc * S,
    H]`` (member-major, then row, then position: a JAX shard's flattening)
    and route over the EP world (sorted path for prefill, packed LL for
    decode), the experts being each member's local shard."""

    def moe_block(h2, lp):
        rows, sq, hd = h2.shape
        x = h2.reshape(world, (rows // world) * sq, hd)
        router_logits = x.float() @ lp["router"].float()
        out, _, _ = ep_ops.moe_ffn(
            x, router_logits, lp["we_gate"], lp["we_up"], lp["we_down"], _AXIS,
            num_selected=cfg.moe_topk, capacity_factor=cfg.capacity_factor, impl=impl,
            wire=cfg.moe_wire, n_chunks=cfg.moe_chunks, wire_dtype=cfg.wire_dtype)
        return out.reshape(rows, sq, hd)

    return moe_block


def _forward_shard(params, tokens, cache: MoEKVCache, cfg: MoEServeConfig, impl: str,
                   world: int, last_only: bool = False):
    """The cached forward over every member's rows: the dense serving loop
    (``inference._forward_cached``) with the FFN swapped for the EP MoE
    layer. tokens ``[W, B_loc, S]``; returns (logits ``[W, B_loc, S, V]``, or
    ``[W, B_loc, V]`` under ``last_only``, and the advanced cache)."""
    w, b, s = tokens.shape
    flat = KVCache(_rows(cache.k), _rows(cache.v), cache.length)
    logits, flat = _forward_cached(params, tokens.reshape(w * b, s), flat, cfg,
                                   ffn=_moe_block(cfg, impl, world), last_only=last_only)
    return logits.reshape(w, b, *logits.shape[1:]), MoEKVCache(cache.k, cache.v, flat.length)


def _forward_shard_slots(params, tokens, cache: MoESlotCache, start, write_mask,
                         cfg: MoEServeConfig, impl: str, world: int, adapters=None,
                         adapter_ids=None, logits_at=None):
    """The masked slot forward over every member's rows: the dense slot-pool
    loop (``inference._forward_slots``) with the EP MoE FFN. Idle slots'
    dummy tokens do route through the experts; expert rows are independent
    and the ample serving capacity keeps the wire drop-free, so active rows
    are those of a batch without the dummies. tokens ``[W, B_loc, S]``,
    start / write_mask / adapter_ids / logits_at ``[W, B_loc]``."""
    w, b, s = tokens.shape
    flat = lambda t: None if t is None else t.reshape(w * b)  # noqa: E731
    logits = _forward_slots(params, tokens.reshape(w * b, s), cache.flat(), flat(start),
                            flat(write_mask), cfg, ffn=_moe_block(cfg, impl, world),
                            adapters=adapters, adapter_ids=flat(adapter_ids),
                            logits_at=flat(logits_at))
    return logits.reshape(w, b, *logits.shape[1:])


class MoEServer:
    """Prefill / decode over an EP world of members on one device.

    ``mesh`` must carry a ``dp`` axis; experts and the batch split over it."""

    def __init__(self, cfg: MoEServeConfig, mesh):
        self.cfg = cfg
        self.mesh = mesh
        self.world = mesh.shape[_AXIS]
        self.device = mesh.device
        if cfg.moe_experts % self.world:
            raise ValueError(
                f"the dp world {self.world} must divide moe_experts {cfg.moe_experts}")

    # -- parameter placement ------------------------------------------------
    def shard_params(self, params):
        """Place the global tree for serving, once: every leaf on the mesh's
        device in float32 (the dtype the JAX package initialises and serves
        them in), and each expert leaf ``[L, E, ...]`` viewed
        as the members' local experts ``[L, W, E_local, ...]`` (expert e
        lives on member ``e // E_local``). Replicated leaves keep one
        copy."""
        w = self.world
        e_local = self.cfg.moe_experts // w

        def place(name, leaf):
            leaf = _as(leaf, self.device, torch.float32)
            if name in _EXPERT_LEAVES:
                return leaf.reshape((leaf.shape[0], w, e_local) + tuple(leaf.shape[2:]))
            return leaf

        return {
            "embed": place("embed", params["embed"]),
            "blocks": {name: place(name, leaf) for name, leaf in params["blocks"].items()},
            "final_norm": place("final_norm", params["final_norm"]),
            "head": place("head", params["head"]),
        }

    def _tokens(self, tokens) -> torch.Tensor:
        return _as(tokens, self.device, torch.int64)

    # -- public serving API -------------------------------------------------
    def prefill(self, params, tokens, max_seq: int):
        """tokens: [W, B_loc, S_prompt] -> (last logits [W, B_loc, V], cache).
        Throughput path (sorted dispatch)."""
        tokens = self._tokens(tokens)
        w, b, s = tokens.shape
        if s > max_seq:
            raise ValueError(f"prompt {s} exceeds max_seq {max_seq}")
        cache = MoEKVCache.empty(self.cfg, w, b, max_seq, device=self.device)
        return _forward_shard(params, tokens, cache, self.cfg, "sort", self.world,
                              last_only=True)

    def decode_step(self, params, token, cache: MoEKVCache, impl: str = "ll"):
        """token: [W, B_loc] -> (logits [W, B_loc, V], cache'). Low-latency
        packed EP path by default — the DeepEP LL decode regime."""
        logits, cache = _forward_shard(params, self._tokens(token)[..., None], cache, self.cfg,
                                       impl, self.world)
        return logits[:, :, 0], cache

    # -- slot-pool serving API (continuous batching) ------------------------
    def _check_drop_free(self):
        """The slot-serving oracle guarantee needs a drop-free EP wire for
        any routing: per-expert capacity floor(cf·T·topk/E) must cover all T
        tokens picking one expert, i.e. cf·topk >= E. Otherwise idle-slot
        dummies and co-scheduled neighbours could crowd a request's tokens
        past capacity and change its output."""
        cfg = self.cfg
        if cfg.capacity_factor * cfg.moe_topk < cfg.moe_experts:
            raise ValueError(
                f"slot serving needs a drop-free EP wire: capacity_factor "
                f"({cfg.capacity_factor}) * moe_topk ({cfg.moe_topk}) must be >= "
                f"moe_experts ({cfg.moe_experts}), or request outputs would depend on "
                f"batch composition")

    def slot_cache(self, batch_local: int, max_seq: int) -> MoESlotCache:
        """The engine's fixed [W, B_loc, S_max] KV pool (per-slot lengths)."""
        self._check_drop_free()
        return MoESlotCache.empty(self.cfg, self.world, batch_local, max_seq,
                                  device=self.device)

    def _grid(self, x, dtype, like: torch.Tensor):
        return None if x is None else _as(x, self.device, dtype).reshape(like.shape[:2])

    def _sampling(self, sampling, like):
        if sampling is None:
            return None
        dts = (torch.int64, torch.int64, torch.float32, torch.float32, torch.int64)
        return tuple(self._grid(x, dt, like).reshape(-1) for x, dt in zip(sampling, dts))

    def prefill_slots(self, params, tokens, prompt_lens, new_mask, cache: MoESlotCache,
                      start=None, sampling=None, adapters=None, adapter_ids=None):
        """Masked batched prefill of newly admitted slots (sorted EP path),
        resumable, mirroring :func:`inference.prefill_slots`. tokens
        ``[W, B_loc, S]``; prompt_lens / new_mask / start ``[W, B_loc]``;
        ``sampling`` per-slot ``[W, B_loc]`` arrays. Returns (token ``[W,
        B_loc]``, cache with lengths min(start+S, prompt_lens) on admitted
        slots)."""
        self._check_drop_free()
        tokens = self._tokens(tokens)
        s = tokens.shape[-1]
        lens = self._grid(prompt_lens, torch.int64, tokens)
        mask = self._grid(new_mask, torch.bool, tokens)
        start = torch.zeros_like(lens) if start is None else self._grid(start, torch.int64, tokens)
        last_idx = torch.clamp(lens - 1 - start, 0, s - 1)
        last = _forward_shard_slots(params, tokens, cache, start, mask, self.cfg, "sort",
                                    self.world, adapters=adapters,
                                    adapter_ids=self._grid(adapter_ids, torch.int64, tokens),
                                    logits_at=last_idx)
        w, b, v = last.shape
        samp = self._sampling(sampling, tokens)
        if samp is None:
            tok = torch.argmax(last, dim=-1).to(torch.int32)
        else:
            tok = sample_tokens(*samp[:2], last.reshape(w * b, v), *samp[2:]).reshape(w, b)
        cache.lengths.copy_(torch.where(mask, torch.minimum(start + s, lens),
                                        cache.lengths.long()))
        return tok, cache

    def verify_slots(self, params, tokens, active, cache: MoESlotCache, impl: str = "sort",
                     sampling=None, adapters=None, adapter_ids=None):
        """Batched draft verification over the slot pool (sorted EP path by
        default), mirroring :func:`inference.verify_slots`. tokens ``[W,
        B_loc, S]``; active ``[W, B_loc]``. Returns (target tokens ``[W,
        B_loc, S]``, n_accepted ``[W, B_loc]``, cache')."""
        self._check_drop_free()
        tokens = self._tokens(tokens)
        w, b, s = tokens.shape
        mask = self._grid(active, torch.bool, tokens)
        logits = _forward_shard_slots(params, tokens, cache, cache.lengths, mask, self.cfg, impl,
                                      self.world, adapters=adapters,
                                      adapter_ids=self._grid(adapter_ids, torch.int64, tokens))
        samp = self._sampling(sampling, tokens)
        if samp is None:
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            tok = sample_window(*samp[:2], logits.reshape(w * b, s, -1),
                                *samp[2:]).reshape(w, b, s)
        n_acc = greedy_acceptance(tokens.reshape(w * b, s), tok.reshape(w * b, s)).reshape(w, b)
        cache.lengths.copy_(spec_advance(cache.lengths, mask, n_acc))
        return tok, n_acc, cache

    def decode_step_slots(self, params, token, active, cache: MoESlotCache, impl: str = "ll",
                          sampling=None, adapters=None, adapter_ids=None):
        """One masked autoregressive step over the slot pool (packed LL EP
        path by default) — the S=1 case of :meth:`verify_slots`. Returns
        (next token ``[W, B_loc]``, cache')."""
        tok, _, cache = self.verify_slots(params, self._tokens(token)[..., None], active, cache,
                                          impl=impl, sampling=sampling, adapters=adapters,
                                          adapter_ids=adapter_ids)
        return tok[..., 0], cache

    def generate(self, params, prompt, new_tokens: int, max_seq: int, impl: str = "ll",
                 sampling=None) -> torch.Tensor:
        """Greedy (or, with ``sampling``, stochastic) decode. prompt:
        ``[W, B_loc, S]`` -> int32 tokens ``[W, B_loc, N]``. With
        ``sampling`` every row runs under the request's seed, output index
        ``i`` under key ``fold_in(seed, i)``: the sampled one-shot oracle of
        the MoE serving stack."""
        if new_tokens < 1:
            raise ValueError(f"new_tokens must be >= 1, got {new_tokens}")
        prompt = self._tokens(prompt)
        if prompt.shape[-1] + new_tokens > max_seq:
            raise ValueError(
                f"prompt {prompt.shape[-1]} + new {new_tokens} tokens exceed max_seq "
                f"{max_seq}: the cache would overflow")
        logits, cache = self.prefill(params, prompt, max_seq)
        w, b, v = logits.shape
        if sampling is not None:
            seeds, temps, tps, tks = broadcast_params(w * b, sampling.seed, sampling.temperature,
                                                      sampling.top_p, sampling.top_k,
                                                      device=self.device)
        toks = []
        for i in range(new_tokens):
            if sampling is None:
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                pos = torch.full((w * b,), i, device=self.device)
                tok = sample_tokens(seeds, pos, logits.reshape(w * b, v), temps, tps,
                                    tks).reshape(w, b)
            toks.append(tok)
            if i + 1 < new_tokens:
                logits, cache = self.decode_step(params, tok, cache, impl=impl)
        return torch.stack(toks, dim=-1)
