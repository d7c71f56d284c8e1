"""Flagship MoE transformer: forward, loss and the training step, at any
world over the pp/dp/cp/tp mesh.

Port of ``uccl_tpu/models/flagship.py``. Each block is RMSNorm -> Q/K/V
projections -> RoPE -> causal GQA flash attention -> output projection ->
RMSNorm -> f32 router -> top-k sorted dispatch -> SwiGLU experts -> weighted
combine; then final norm -> f32 vocab head -> cross-entropy plus the MoE
aux/z losses, and AdamW.

The JAX model is written manually sharded in one ``shard_map`` over the
mesh: Megatron column/row splits and a vocab-parallel embedding and loss
over ``tp``, ring or Ulysses attention over ``cp``, the expert-parallel
all-to-all over ``dp`` x ``cp``, the GPipe (or manual 1F1B) schedule over
``pp``, the batch over ``dp``. Here the members of the mesh live on one
device and the ``shard_map`` body runs on **member-grid** tensors
(``parallel/sharding``): every per-shard tensor carries the grid dims
``[pp, dp, cp, tp]`` in front, each ``lax.psum``/``pmean``/``pmax``/
``ppermute``/``all_to_all``/``axis_index`` over a named axis is the
``collective/ops`` verb on that dim, and all members of a step run in one
call (the flash kernels see every member's chunk in one launch). The
parameters stay one global tree with the JAX names and layouts (weights are
``[in, out]``, per-layer weights stacked on a leading layer axis);
:func:`shard_params` is a differentiable view of it by :func:`param_specs`,
so autograd sums a replicated leaf's gradient over its replicas as
``shard_map``'s transpose does, and :func:`params_from_jax`,
:func:`params_to_numpy`, the AdamW step and the checkpoints work on the
global tree at every mesh. A call without a mesh runs on a one-member mesh:
world 1, where every collective is the identity.

Casts follow the JAX model: activations are in ``cfg.dtype`` and each weight
is cast to it at its matmul; router and vocab logits are float32; the MoE
output is cast back to the activation dtype.

``remat`` is the JAX model's recompute schedule for each block: ``full``
and ``none``, and ``dots`` / ``mlp`` as selective checkpoints
(:func:`remat_policy`). At world > 1 a projection is one batched product
over the members (``bmm``), which ``dots`` recomputes like the expert
products; the gradients are the same in every mode. ``moe_impl="ll"``
trains through the packed low-latency path with a ragged grouped GEMM
(``ep/ll.grouped_ffn_ragged``). ``moe_wire="pallas"`` runs the EP exchanges
on B9, forward only (as in JAX: the kernel has no vjp).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from uccl_tpu_torch import DeviceLike, resolve_device
from uccl_tpu_torch.ep import ops as ep_ops
from uccl_tpu_torch.models.layers import rms_norm, rope, tp_cross_entropy
from uccl_tpu_torch.models.sampling import normal, split
from uccl_tpu_torch.obs import tracer as _obst
from uccl_tpu_torch.ops.attention import attention_reference, ring_attention, ulysses_attention
from uccl_tpu_torch.ops.flash_attention import flash_attention
from uccl_tpu_torch.parallel import sharding as shd
from uccl_tpu_torch.parallel.mesh import AXIS, Mesh, MeshConfig, make_mesh
from uccl_tpu_torch.parallel.pipeline import gpipe_spmd, pipeline_train
from uccl_tpu_torch.parallel.sharding import P

Params = Dict[str, Any]

# The obs track of the train step's spans (flagship.embed, .attention,
# .stack_slice, .block, .head, and adamw); the MoE layer's are on
# ep.ops.TRACK. Inside a torch.profiler capture each span is a
# record_function range, above the kernels launched under it.
TRACK = "train"


@dataclasses.dataclass(frozen=True)
class FlagshipConfig:
    vocab: int = 1024
    dim: int = 256
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    head_dim: int = 32
    moe_experts: int = 8
    moe_topk: int = 2
    moe_ffn: int = 512
    capacity_factor: float = 1.5
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3
    n_microbatches: int = 1
    pp_schedule: str = "gpipe"  # "gpipe" (autograd + remat) | "1f1b" (manual)
    seq_mode: str = "ring"  # "ring" | "ulysses" (at cp > 1)
    attn_impl: str = "auto"  # "auto" | "flash": the flash kernels; "xla": plain
    moe_impl: str = "sort"  # "sort" | "dense" | "ll" (packed, drop-free at cf >= 1)
    moe_wire: str = "lax"  # "lax" | "pallas" (B9; forward only: no vjp)
    moe_chunks: int = 0  # the pallas wire's chunk-pipeline depth (0 = auto)
    wire_fp8: bool = False
    wire_dtype: Any = None  # None | "fp8" | "int8": block-quantized EP wire
    remat: str = "full"  # "full" | "dots" | "mlp" | "none": see _remat_wrap
    dtype: torch.dtype = torch.float32  # activation dtype (the trainers' float32)

    def __post_init__(self):
        _check_common(self)
        if self.pp_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown pp_schedule {self.pp_schedule!r}: expected 'gpipe' "
                             "or '1f1b'")
        if self.moe_wire not in ("lax", "pallas"):
            raise ValueError(f"unknown EP wire {self.moe_wire!r} (want 'lax' or 'pallas')")
        if self.moe_impl not in ("sort", "dense", "ll"):
            raise ValueError(f"unknown moe impl {self.moe_impl!r} (want sort|dense|ll)")


def _check_common(cfg) -> None:
    """The checks the flagship and the dense config share."""
    if cfg.seq_mode not in ("ring", "ulysses"):
        raise ValueError(f"unknown seq_mode {cfg.seq_mode!r} (want ring|ulysses)")
    if cfg.attn_impl not in ("auto", "flash", "xla"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r} (want auto|flash|xla)")
    if cfg.remat not in REMAT_MODES:
        raise ValueError(f"unknown remat mode {cfg.remat!r} (want full|dots|mlp|none)")


def bench_config(**overrides) -> FlagshipConfig:
    """The benchmark's base configuration (the JAX package's bench.py:114-129):
    vocab 16384, dim 1024, 4 layers, 16 query / 4 KV heads of 64, 8 experts
    top-2 with ffn 2816, capacity factor 1.25, bf16, remat full."""
    base = dict(vocab=16384, dim=1024, n_layers=4, n_heads=16, n_kv_heads=4, head_dim=64,
                moe_experts=8, moe_topk=2, moe_ffn=2816, capacity_factor=1.25,
                n_microbatches=1, aux_loss_weight=0.01, z_loss_weight=1e-3,
                remat="full", dtype=torch.bfloat16)
    return FlagshipConfig(**{**base, **overrides})


# ---------------------------------------------------------------------------
# Parameters

_BLOCK_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "router", "we_gate", "we_up", "we_down")


def param_shapes(cfg: FlagshipConfig) -> Params:
    """Shapes of the parameter tree, named and laid out as in the JAX model."""
    h, l = cfg.dim, cfg.n_layers
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    e, f = cfg.moe_experts, cfg.moe_ffn
    return {
        "embed": (cfg.vocab, h),
        "blocks": {
            "ln1": (l, h), "ln2": (l, h),
            "wq": (l, h, qd), "wk": (l, h, kvd), "wv": (l, h, kvd), "wo": (l, qd, h),
            "router": (l, h, e),
            "we_gate": (l, e, h, f), "we_up": (l, e, h, f), "we_down": (l, e, f, h),
        },
        "final_norm": (h,),
        "head": (h, cfg.vocab),
    }


def init_params(key: torch.Tensor, cfg: FlagshipConfig, device: DeviceLike = None) -> Params:
    """The JAX ``init_params(key, cfg)``: f32 parameters drawn on ``device``
    from ``key`` (``sampling.prng_key(seed)``, JAX's ``PRNGKey(seed)``) by
    the same ``split(key, 10)``, leaf order and scales (normal * 1/sqrt(fan
    in), embeddings * 0.02, norms at 1). The bits equal JAX's; each normal
    lies within a few ulp of JAX's (``sampling.erf_inv``)."""
    dev = resolve_device(device)
    k = iter(split(key.to(dev), 10))
    h, f = cfg.dim, cfg.moe_ffn
    qd = cfg.n_heads * cfg.head_dim
    shapes = param_shapes(cfg)

    def rnd(shape, scale):  # the keys in the JAX init's leaf order
        return normal(next(k), shape) * scale

    s_in = 1.0 / math.sqrt(h)
    blocks = shapes["blocks"]
    return {
        "embed": rnd(shapes["embed"], 0.02),
        "blocks": {
            "ln1": torch.ones(blocks["ln1"], device=dev),
            "ln2": torch.ones(blocks["ln2"], device=dev),
            "wq": rnd(blocks["wq"], s_in),
            "wk": rnd(blocks["wk"], s_in),
            "wv": rnd(blocks["wv"], s_in),
            "wo": rnd(blocks["wo"], 1.0 / math.sqrt(qd)),
            "router": rnd(blocks["router"], s_in),
            "we_gate": rnd(blocks["we_gate"], s_in),
            "we_up": rnd(blocks["we_up"], s_in),
            "we_down": rnd(blocks["we_down"], 1.0 / math.sqrt(f)),
        },
        "final_norm": torch.ones(shapes["final_norm"], device=dev),
        "head": rnd(shapes["head"], s_in),
    }


def _tree_map(fn: Callable, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in key order."""
    if isinstance(tree, Mapping):
        return [x for k in tree for x in tree_leaves(tree[k])]
    return [tree]


def params_from_jax(np_tree: Mapping, device: DeviceLike = None) -> Params:
    """A JAX-model parameter tree (as numpy arrays, e.g. ``jax.tree.map(
    np.asarray, params)``) -> this model's f32 tensors on ``device``. Names
    and layouts are the same; nothing is transposed."""
    dev = resolve_device(device)
    return _tree_map(
        lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=dev), np_tree
    )


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """This model's parameters -> a tree of float32 numpy arrays with the JAX
    model's names and layouts."""
    return _tree_map(lambda t: t.detach().float().cpu().numpy(), params)


# ---------------------------------------------------------------------------
# Rematerialisation

REMAT_MODES = ("full", "dots", "mlp", "none")
# Products with no batch dim: projections, router, the dense FFN (the JAX
# policy dots_with_no_batch_dims_saveable); the expert products are bmm.
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_TAG = torch.ops.uccl_tpu_torch.checkpoint_name.default


def remat_policy(mode: str) -> Callable:
    """The selective-checkpoint policy of remat mode ``dots`` or ``mlp``:
    save the outputs of the products with no batch dim and, for ``mlp``,
    the expert GEMMs' tagged operand and results
    (``ep.ops.MOE_CHECKPOINT_NAMES``); recompute everything else, the
    attention interior and the expert products included."""
    names = set(ep_ops.MOE_CHECKPOINT_NAMES) if mode == "mlp" else set()

    def policy(ctx, func, *args, **kwargs):
        if func in _NO_BATCH_DOTS or (func is _TAG and args[1] in names):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _remat_wrap(f: Callable, mode: str) -> Callable:
    """The JAX model's rematerialisation wrapper for one block: ``full``
    recomputes the whole block in backward (``jax.checkpoint``); ``dots``
    and ``mlp`` save what :func:`remat_policy` names and recompute the rest
    (a selective checkpoint; ``mlp`` runs the block, in the forward and in
    the recompute alike, with the expert tags on); ``none`` saves every
    residual. Gradients do not depend on the mode: a saved tensor holds the
    values a recompute would give."""
    if mode == "none":
        return f
    if mode == "full":
        return partial(checkpoint, f, use_reentrant=False)
    if mode not in REMAT_MODES:
        raise ValueError(f"unknown remat mode {mode!r} (want full|dots|mlp|none)")
    block = f
    if mode == "mlp":
        def block(*args):
            with ep_ops.tagging():
                return f(*args)
    return partial(checkpoint, block, use_reentrant=False,
                   context_fn=partial(create_selective_checkpoint_contexts, remat_policy(mode)))


# ---------------------------------------------------------------------------
# Sharding: the global parameter tree over the member grid

G = shd.GRID_DIMS  # a member-grid tensor's leading dims: [pp, dp, cp, tp]


def param_specs(cfg: FlagshipConfig) -> Params:
    """PartitionSpec tree matching :func:`init_params`' tree (the JAX
    model's): Megatron column/row splits over tp, layers over pp, experts
    over the EP world (dp x cp), the vocab over tp."""
    ep = AXIS.EP
    return {
        "embed": P(AXIS.TP, None),
        "blocks": {
            "ln1": P(AXIS.PP, None),
            "ln2": P(AXIS.PP, None),
            "wq": P(AXIS.PP, None, AXIS.TP),
            "wk": P(AXIS.PP, None, AXIS.TP),
            "wv": P(AXIS.PP, None, AXIS.TP),
            "wo": P(AXIS.PP, AXIS.TP, None),
            "router": P(AXIS.PP, None, None),
            "we_gate": P(AXIS.PP, ep, None, AXIS.TP),
            "we_up": P(AXIS.PP, ep, None, AXIS.TP),
            "we_down": P(AXIS.PP, ep, AXIS.TP, None),
        },
        "final_norm": P(None),
        "head": P(None, AXIS.TP),
    }


def shard_params(params: Params, mesh: Mesh, cfg: FlagshipConfig) -> Params:
    """The member-grid view of the global tree by :func:`param_specs`
    (``sharding.put``): no copy, and differentiable, so the gradient of a
    global leaf sums its replicas' gradients."""
    return shd.put_tree(mesh, params, param_specs(cfg))


def _data_spec() -> P:
    return P(AXIS.DP, AXIS.CP)


def _mesh_of(mesh: Optional[Mesh], params: Params) -> Mesh:
    """The mesh of a call: one member on the parameters' device if none."""
    return mesh if mesh is not None else make_mesh(MeshConfig(), tree_leaves(params)[0].device)


def _put_data(mesh: Mesh, t) -> torch.Tensor:
    """Tokens or targets [B, S] -> their grid view [*G, B/dp, S/cp]."""
    t = torch.as_tensor(t, device=mesh.device)
    dp, cp = mesh.shape[AXIS.DP], mesh.shape[AXIS.CP]
    if t.shape[0] % dp or t.shape[1] % cp:
        raise ValueError(f"data {tuple(t.shape)} must divide as [batch/dp={dp}, seq/cp={cp}]")
    return shd.put(mesh, t, _data_spec())


# ---------------------------------------------------------------------------
# Per-member forward on member-grid tensors (the JAX shard_map body)


def _w(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Grid weight ``[*G, *shape]`` viewed to broadcast against grid ``x``
    ``[*G, ..., *shape]`` (one member's broadcasts as it is)."""
    if shd.members(w) == 1:
        return w
    return w.reshape(tuple(w.shape[:G]) + (1,) * (x.dim() - w.dim()) + tuple(w.shape[G:]))


def _gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each member's product: ``x [*G, ..., K] @ w [*G, K, N]``. One
    member's is a plain ``mm`` (what remat ``dots`` saves); members' are
    one batched product."""
    k, n = x.shape[-1], w.shape[-1]
    if shd.members(x) == 1:
        return x @ w.reshape(k, n)
    y = torch.matmul(x.reshape(tuple(x.shape[:G]) + (-1, k)), w)
    return y.reshape(tuple(x.shape[:-1]) + (n,))


def _attention(x: torch.Tensor, lp: Params, cfg) -> torch.Tensor:
    """x [*G, B, S_loc, H_model] -> [*G, B, S_loc, H_model] (before the
    psum over tp): this member's heads, rope at its chunk's absolute
    positions, then attention over the cp axis. At cp = 1 the flash kernels
    directly, all members in one launch; at cp > 1 ring attention (one
    launch per ring step) or Ulysses (one launch)."""
    s = x.shape[G + 1]
    d = cfg.head_dim
    cp = x.shape[AXIS.ALL.index(AXIS.CP)]
    # at cp = 1 the grid and the batch fold into the kernel's batch dim
    lead = (-1, s) if cp == 1 else tuple(x.shape[:G + 2])
    q, k, v = (_gmm(x, lp[n].to(x.dtype)) for n in ("wq", "wk", "wv"))
    q, k, v = (t.reshape(lead + (t.shape[-1] // d, d)) for t in (q, k, v))
    positions = torch.arange(s, device=x.device)
    if cp > 1:
        positions = shd.axis_index(x, AXIS.CP, 2) * s + positions
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    impl = "xla" if cfg.attn_impl == "xla" else "flash"
    if cp == 1:
        if impl == "flash":
            attn = flash_attention(q, k, v, True)
        else:
            attn = attention_reference(q, k, v, causal=True)
    else:
        # cp to the front, the rest of the grid folded into the batch
        front = shd.to_front(q, AXIS.CP)
        qr, kr, vr = (shd.to_front(t, AXIS.CP).reshape((cp, -1) + tuple(t.shape[G + 1:]))
                      for t in (q, k, v))
        fn = ulysses_attention if cfg.seq_mode == "ulysses" else ring_attention
        attn = fn(qr, kr, vr, AXIS.CP, causal=True, impl=impl)
        attn = shd.from_front(attn.reshape(front.shape), q.shape, AXIS.CP)
    return _gmm(attn.reshape(tuple(x.shape[:G + 2]) + (-1,)), lp["wo"].to(x.dtype))


def _ep_groups(t: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """[pp, dp, cp, tp, ...] -> one [dp*cp, ...] per (pp, tp) group: each
    group's EP world (dp outer). One group's is a view."""
    pp, dp, cp, tp = t.shape[:G]
    shard = tuple(t.shape[G:])
    if pp * tp == 1:
        return (t.reshape((dp * cp,) + shard),)
    t = t.permute((0, 3, 1, 2) + tuple(range(G, t.dim())))
    return t.reshape((pp * tp, dp * cp) + shard).unbind(0)


def _ep_ungroup(ts, grid) -> torch.Tensor:
    """Inverse of :func:`_ep_groups`: the groups' [dp*cp, ...] -> grid."""
    pp, dp, cp, tp = grid
    shard = tuple(ts[0].shape[1:])
    if pp * tp == 1:
        return ts[0].reshape(tuple(grid) + shard)
    t = torch.stack(ts).reshape((pp, tp, dp, cp) + shard)
    return t.permute((0, 2, 3, 1) + tuple(range(G, t.dim())))


def _moe(flat: torch.Tensor, router_logits: torch.Tensor, lp: Params, cfg: FlagshipConfig):
    """The MoE layer of every member: ``ep.ops.moe_ffn`` over each (pp, tp)
    group's EP world, on its members' tokens [W_ep, T_loc, H] and experts
    (capacity per member and microbatch, as in the JAX shard)."""
    xs, ls = _ep_groups(flat), _ep_groups(router_logits)
    with _obst.span("moe.experts", ep_ops.TRACK):  # the weights' casts
        ws = [_ep_groups(lp[k].to(flat.dtype)) for k in ("we_gate", "we_up", "we_down")]
    outs = [ep_ops.moe_ffn(xs[g], ls[g], ws[0][g], ws[1][g], ws[2][g], AXIS.EP,
                           num_selected=cfg.moe_topk, capacity_factor=cfg.capacity_factor,
                           wire_fp8=cfg.wire_fp8, wire_dtype=cfg.wire_dtype, impl=cfg.moe_impl,
                           wire=cfg.moe_wire, n_chunks=cfg.moe_chunks, ll_grouped="ragged")
            for g in range(len(xs))]
    return tuple(_ep_ungroup([o[i] for o in outs], flat.shape[:G]) for i in range(3))


def _layer(x: torch.Tensor, lp: Params, cfg: FlagshipConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One transformer block on every member. x: [*G, B, S_loc, H]. Returns
    (x, aux [*G])."""
    b, s, h = x.shape[G:]
    with _obst.span("flagship.attention", TRACK):
        attn_out = _attention(rms_norm(x, _w(lp["ln1"], x), cfg.norm_eps), lp, cfg)
    x = x + shd.psum(attn_out, AXIS.TP)
    h2 = rms_norm(x, _w(lp["ln2"], x), cfg.norm_eps)
    flat = h2.reshape(tuple(x.shape[:G]) + (b * s, h))
    with _obst.span("moe.route", ep_ops.TRACK):
        router_logits = _gmm(flat.float(), lp["router"])
    moe_out, aux, z = _moe(flat, router_logits, lp, cfg)
    x = x + shd.psum(moe_out.reshape(x.shape), AXIS.TP)
    return x, cfg.aux_loss_weight * aux + cfg.z_loss_weight * z


def _layer_at(layer: Callable, blocks: Params, i: int, x: torch.Tensor, cfg):
    """Block ``i`` on its slice of the stacked leaves. The slices' backward
    writes each layer's gradient into the stacked gradient
    (``flagship.stack_slice``); ``flagship.block`` holds what no finer span
    does (residual adds, ln2, the aux sum), also when a remat recompute
    re-runs the block inside the backward."""
    with _obst.span("flagship.stack_slice", TRACK):
        lp = {k: v.select(G, i) for k, v in blocks.items()}
    with _obst.span("flagship.block", TRACK):
        return layer(x, lp, cfg)


def _embed(tokens: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Vocab-parallel embedding. tokens [*G, B, S_loc], embed [*G, V_loc, H]
    -> [*G, B, S_loc, H]: each member looks up the ids in its slice of the
    vocab, zeros elsewhere, then the psum over tp."""
    v_loc = embed.shape[-2]
    if shd.members(tokens) == 1:  # world 1: the plain lookup
        return embed.reshape(embed.shape[G:])[tokens.long()]
    grid_idx = tuple(shd.axis_index(tokens, a, 2) for a in AXIS.ALL)
    local = tokens.long() - grid_idx[AXIS.ALL.index(AXIS.TP)] * v_loc
    in_range = (local >= 0) & (local < v_loc)
    emb = embed[grid_idx + (local.clamp(0, v_loc - 1),)]
    emb = torch.where(in_range[..., None], emb, torch.zeros_like(emb))
    return shd.psum(emb, AXIS.TP)


def _stage_fn(layer: Callable, cfg, blocks: Params, xm: torch.Tensor):
    """One pipeline stage on every member: its L/pp layers (``blocks``
    viewed [*G, L/pp, ...]), each under the config's remat wrapper.
    Returns (y, aux [*G] summed over the layers)."""
    aux = torch.zeros(xm.shape[:G], dtype=torch.float32, device=xm.device)
    for i in range(blocks["ln1"].shape[G]):
        step = partial(_layer_at, layer, blocks, i, cfg=cfg)
        xm, a = _remat_wrap(step, cfg.remat)(xm)
        aux = aux + a
    return xm, aux


def _microbatches(x: torch.Tensor, m: int) -> torch.Tensor:
    """[*G, B_loc, ...] -> [pp, M, dp, cp, tp, B_loc/M, ...]."""
    b = x.shape[G]
    if b % m:
        raise ValueError(f"local batch {b} not divisible by {m} microbatches")
    return x.reshape(tuple(x.shape[:G]) + (m, b // m) + tuple(x.shape[G + 1:])).movedim(G, 1)


def _head_logits(lp: Params, y: torch.Tensor, cfg) -> torch.Tensor:
    y = rms_norm(y, _w(lp["final_norm"], y), cfg.norm_eps)
    return _gmm(y.float(), lp["head"])


def _tp_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Vocab-parallel cross-entropy of grid logits [*G, ..., V_loc] against
    grid targets [*G, ...] -> [*G, ...]. At tp = 1 each member's vocab is
    whole: the loss without an axis."""
    v_loc = logits.shape[-1]
    if shd.axis_size(logits, AXIS.TP) == 1:
        return tp_cross_entropy(logits.reshape(-1, v_loc), targets.reshape(-1)).reshape(
            targets.shape)
    lf, tf = shd.to_front(logits, AXIS.TP), shd.to_front(targets, AXIS.TP)
    n = lf.shape[0]
    per = tp_cross_entropy(lf.reshape(n, -1, v_loc), tf.reshape(n, -1),
                           torch.arange(n, device=lf.device) * v_loc, AXIS.TP)
    return shd.from_front(per.reshape(tf.shape), targets.shape, AXIS.TP)


def _per_shard_logits_aux(gp: Params, tokens: torch.Tensor, cfg, layer: Callable = None):
    """Grid tokens [*G, B_loc, S_loc] -> (logits [*G, B_loc, S_loc, V_loc]
    f32, aux [*G] summed over layers and microbatches): the embedding, the
    GPipe schedule over pp (each stage's layers on stacked stage weights),
    the final norm and the vocab head."""
    layer = layer or _layer
    with _obst.span("flagship.embed", TRACK):
        x = _embed(tokens, gp["embed"]).to(cfg.dtype)
    out, aux = gpipe_spmd(partial(_stage_fn, layer, cfg, gp["blocks"]),
                          _microbatches(x, cfg.n_microbatches), AXIS.PP)
    x = out.movedim(1, G).reshape(x.shape)
    with _obst.span("flagship.head", TRACK):
        return _head_logits(gp, x, cfg), aux


def _per_shard_loss(gp: Params, tokens, targets, cfg):
    """(total, ce), each [*G] and the same on every member: the mean
    cross-entropy of the member's tokens averaged over the EP world (dp x
    cp), plus the aux losses averaged likewise and normalised by layers x
    microbatches."""
    logits, aux = _per_shard_logits_aux(gp, tokens, cfg)
    with _obst.span("flagship.head", TRACK):
        per_token = _tp_ce(logits, targets)
        loss = shd.pmean(per_token.reshape(tuple(per_token.shape[:G]) + (-1,)).mean(-1),
                         AXIS.EP)
    aux_norm = shd.pmean(aux, AXIS.EP) / (cfg.n_layers * cfg.n_microbatches)
    return loss + aux_norm, loss


def logits_aux(params: Params, tokens, cfg, mesh: Optional[Mesh] = None,
               layer: Callable = None, specs: Params = None):
    """Global tokens [B, S] -> (global logits [B, S, V] f32, aux summed over
    layers and microbatches, per-member [*G]) over ``mesh`` (default: one
    member on the parameters' device). ``layer``/``specs``: the model
    family's block and parameter specs (default the flagship's)."""
    mesh = _mesh_of(mesh, params)
    gp = shd.put_tree(mesh, params, specs or param_specs(cfg))
    logits, aux = _per_shard_logits_aux(gp, _put_data(mesh, tokens), cfg, layer)
    return shd.gather(mesh, logits, P(AXIS.DP, AXIS.CP, AXIS.TP)), aux


def forward(params: Params, tokens, cfg: FlagshipConfig, mesh: Optional[Mesh] = None):
    """tokens [B, S] -> logits [B, S, V] (float32), over ``mesh`` (default:
    world 1 on the parameters' device)."""
    return logits_aux(params, tokens, cfg, mesh)[0]


def loss_fn(params: Params, tokens, targets, cfg: FlagshipConfig,
            mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global mean loss including aux; returns (total_loss, ce_loss)."""
    mesh = _mesh_of(mesh, params)
    total, ce = _per_shard_loss(shard_params(params, mesh, cfg), _put_data(mesh, tokens),
                                _put_data(mesh, targets), cfg)
    return shd.member0(total), shd.member0(ce)


# ---------------------------------------------------------------------------
# Manual-schedule training path (pp_schedule="1f1b")
#
# The gpipe path differentiates through the pipeline loop (autograd + remat:
# residual liveness grows with M). This path runs the hand-written 1F1B
# schedule (parallel/pipeline.pipeline_train): explicit boundary gradients;
# the embedding backward runs through the returned input cotangents, the
# loss head through its own gradient outputs, the MoE aux/z losses ride the
# aux channel.


def _grad_sync_specs(cfg: FlagshipConfig) -> Params:
    """Per leaf, the mesh axes a manual gradient is psum'd over: every axis
    the parameter is replicated on, except pp (pipeline_train already
    reduced over it, or it shards the leaf)."""
    def axes_of(spec):
        used = set()
        for part in spec:
            if isinstance(part, (tuple, list)):
                used.update(part)
            elif part is not None:
                used.add(part)
        return tuple(a for a in AXIS.ALL if a not in used and a != AXIS.PP)

    return shd.tree_map(axes_of, param_specs(cfg))


def manual_loss_and_grads(params: Params, tokens, targets, cfg: FlagshipConfig,
                          mesh: Optional[Mesh] = None):
    """Global (total, ce, grads) on the manual 1F1B schedule: the gradient
    of :func:`loss_fn`'s total, as a global tree. Every member seeds its
    own loss with 1 (as the JAX per-shard vjps do), so each partial is the
    derivative of n_ep x n_tp copies of the loss: the psum over each leaf's
    replicated axes is divided by n_ep * n_tp."""
    mesh = _mesh_of(mesh, params)
    specs = param_specs(cfg)
    gp = shd.tree_map(lambda t: t.detach(), shard_params(params, mesh, cfg))
    tok, tgt = _put_data(mesh, tokens), _put_data(mesh, targets)
    m = cfg.n_microbatches
    emb = gp["embed"].requires_grad_()
    with torch.enable_grad(), _obst.span("flagship.embed", TRACK):
        x = _embed(tok, emb).to(cfg.dtype)
    n_tok = tok.shape[G] * tok.shape[G + 1]  # per member: summed mb losses == its mean

    def loss_head(lp, y, target):
        with _obst.span("flagship.head", TRACK):
            per = _tp_ce(_head_logits(lp, y, cfg), target)
            return per.reshape(tuple(per.shape[:G]) + (-1,)).sum(-1) / n_tok

    total, ce, dblocks, dlp, dxmb = pipeline_train(
        partial(_stage_fn, _layer, cfg), loss_head, gp["blocks"],
        {"final_norm": gp["final_norm"], "head": gp["head"]},
        _microbatches(x.detach(), m), _microbatches(tgt, m), AXIS.PP,
        aux_weight=1.0 / (cfg.n_layers * m))
    (d_embed,) = torch.autograd.grad(x, emb, dxmb.movedim(1, G).reshape(x.shape).to(x.dtype))
    grads = {"embed": d_embed, "blocks": dblocks, "final_norm": dlp["final_norm"],
             "head": dlp["head"]}
    div = mesh.config.ep * mesh.shape[AXIS.TP]

    def sync(g, axes):
        return (shd.psum(g, axes) if axes else g) / div

    grads = shd.tree_map(sync, grads, _grad_sync_specs(cfg))
    grads = shd.gather_tree(mesh, grads, specs)
    return (shd.member0(shd.pmean(total, AXIS.EP)), shd.member0(shd.pmean(ce, AXIS.EP)),
            shd.tree_map(lambda _, g: g, params, grads))  # in the caller's key order


# ---------------------------------------------------------------------------
# Training


def make_train_step(cfg: FlagshipConfig, device: Union[DeviceLike, Mesh] = None,
                    learning_rate: float = 3e-4):
    """Returns (train_step, init_optimizer), as the JAX model does.

    ``device`` may be a :class:`Mesh` (the JAX call ``make_train_step(cfg,
    mesh)``); any other device runs the step at world 1 on it.
    ``train_step(params, opt_state, tokens, targets) -> (params,
    opt_state, metrics)`` takes one AdamW step equal to
    ``optax.adamw(learning_rate, weight_decay=0.01)`` (b1 0.9, b2 0.999,
    eps 1e-8, decay on every leaf) on the global tree, its gradient by
    autograd through the GPipe schedule (``pp_schedule="gpipe"``) or by the
    manual 1F1B schedule (``"1f1b"``). Unlike the JAX step it updates
    ``params`` and ``opt_state`` in place, which saves a copy of every
    parameter and moment, and returns the same objects. Tokens and targets
    move to the device if they are elsewhere. Metrics are the total loss
    and its cross-entropy part."""
    mesh = device if isinstance(device, Mesh) else make_mesh(MeshConfig(), resolve_device(device))
    dev = mesh.device

    if cfg.pp_schedule == "1f1b":
        def grads(params, tokens, targets):
            total, ce, g = manual_loss_and_grads(params, tokens, targets, cfg, mesh)
            return g, {"loss": total.detach(), "ce": ce.detach()}

        return adamw_train_step(None, dev, learning_rate, grads=grads)

    def loss(params, tokens, targets):
        total, ce = loss_fn(params, tokens, targets, cfg, mesh)
        return total, {"loss": total.detach(), "ce": ce.detach()}

    return adamw_train_step(loss, dev, learning_rate)


def adamw_train_step(loss: Optional[Callable], device: DeviceLike = None,
                     learning_rate: float = 3e-4, *, grads: Optional[Callable] = None):
    """(train_step, init_optimizer) of the AdamW step above around ``loss``:
    ``loss(params, tokens, targets) -> (total, metrics)``, differentiated by
    autograd; or around ``grads(params, tokens, targets) -> (grad tree,
    metrics)``. The step returns ``metrics``. Shared by the flagship and the
    dense model."""
    dev = resolve_device(device)
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, 0.01

    def init_optimizer(params: Params) -> Dict[str, Any]:
        return {
            "count": 0,
            "mu": _tree_map(torch.zeros_like, params),
            "nu": _tree_map(torch.zeros_like, params),
        }

    def train_step(params: Params, opt_state: Dict[str, Any], tokens, targets):
        tokens = torch.as_tensor(tokens, device=dev)
        targets = torch.as_tensor(targets, device=dev)
        if grads is None:
            leaves = [p.requires_grad_() for p in tree_leaves(params)]
            total, metrics = loss(params, tokens, targets)
            gs = torch.autograd.grad(total, leaves)
        else:
            leaves = tree_leaves(params)
            g_tree, metrics = grads(params, tokens, targets)
            gs = tree_leaves(g_tree)
        count = opt_state["count"] + 1
        bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        with torch.no_grad(), _obst.span("adamw", TRACK):
            for p, g, mu, nu in zip(leaves, gs, tree_leaves(opt_state["mu"]),
                                    tree_leaves(opt_state["nu"])):
                mu.mul_(b1).add_(g, alpha=1.0 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                p.sub_(learning_rate * (update + wd * p))
        opt_state["count"] = count
        return params, opt_state, metrics

    return train_step, init_optimizer


# ---------------------------------------------------------------------------
# Dense single-device reference (oracle for tests)


def _mm(eq: str, *ts: torch.Tensor) -> torch.Tensor:
    """einsum with JAX's type promotion (bf16 x f32 computes in f32)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(eq, *(t.to(dt) for t in ts))


def reference_forward(params: Params, tokens: torch.Tensor, cfg: FlagshipConfig) -> torch.Tensor:
    """Unsharded oracle of the same math: plain attention and the dense
    one-hot MoE. As in the JAX reference, weights are not cast to the
    activation dtype: mixed products promote."""
    b, s = tokens.shape
    x = params["embed"][tokens.long()].to(cfg.dtype)
    pos = torch.arange(s, device=x.device)
    d = cfg.head_dim
    for i in range(cfg.n_layers):
        lp = {k: params["blocks"][k][i] for k in _BLOCK_KEYS}
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = _mm("bsh,hf->bsf", h, lp["wq"]).reshape(b, s, cfg.n_heads, d)
        k = _mm("bsh,hf->bsf", h, lp["wk"]).reshape(b, s, cfg.n_kv_heads, d)
        v = _mm("bsh,hf->bsf", h, lp["wv"]).reshape(b, s, cfg.n_kv_heads, d)
        q, k = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)
        attn = attention_reference(q, k, v, causal=True).reshape(b, s, -1)
        x = x + _mm("bsf,fh->bsh", attn, lp["wo"])
        flat = rms_norm(x, lp["ln2"], cfg.norm_eps).reshape(b * s, cfg.dim)
        logits = flat.float() @ lp["router"]
        cap = max(1, int(cfg.capacity_factor * flat.shape[0] * cfg.moe_topk / cfg.moe_experts))
        r = ep_ops.route_topk(logits, cfg.moe_topk, cap)
        xe = _mm("tec,th->ech", r.dispatch_mask.to(flat.dtype), flat)
        act = F.silu(_mm("ech,ehf->ecf", xe, lp["we_gate"])) * _mm(
            "ech,ehf->ecf", xe, lp["we_up"]
        )
        ye = _mm("ecf,efh->ech", act, lp["we_down"])
        x = x + _mm("tec,ech->th", r.combine_weights.to(ye.dtype), ye).reshape(b, s, cfg.dim)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x.float() @ params["head"]
