"""MoE routing, dispatch and combine: world 1 and expert-parallel world W.

Port of ``uccl_tpu/ep/ops.py``: top-k gating with per-expert capacity, the
dense one-hot oracle (``route_topk``, ``masks_from_topk``, ``dispatch``,
``combine``), the sorted path (``sorted_from_topk``, ``SlotPlan``,
``plan_slots``, ``route_topk_sorted``, ``dispatch_sorted``,
``combine_sorted``), the SwiGLU expert GEMMs, the chunk pipeline and
``moe_ffn(impl="sort" | "dense" | "ll")``.

Two forms of each verb. With no ``axis`` (the flagship's world-1 call) a
tensor is one member's: x ``[T, H]``, and the EP wire moves nothing (the
JAX all-to-all over a size-1 axis is the identity), so dispatch and
combine are the local gathers and einsums alone. With an ``axis`` (any
name: the world is the leading dim) a tensor is member-stacked, row r
being member r's shard: x ``[W, T, H]``, expert weights ``[W, E_local,
...]``, and each member-major exchange ``[W, W, ...]`` rides the selected
wire: ``"lax"``, the stock wire (XLA's ``all_to_all`` in JAX, a transpose
of the member axes here), or ``"pallas"``, the hand-written kernels of
``ep/pallas_a2a.py`` (B9; B10 with a round ``schedule``). ``wire_dtype``
("fp8" | "int8") block-quantizes the payload with ``ops/quant.py`` and
moves the scales on ``collective_id + CID_SCALE_OFFSET``. ``moe_ffn`` has
one body, the member-stacked one: a world-1 call runs it as a world of one
member (views of its tensors, no copies), which is the same arithmetic, bit
for bit, as the world-1 verbs.

Drop priority is the reference's: earlier k-slots fill expert queues
first, then token order, and gate ties resolve to the lower expert index
(``lax.top_k``'s order; ``torch.topk`` promises none, so the top-k here is
a stable descending sort). Routing runs per member (one stable argsort
each), so every member's integers equal the JAX shard's. The sorted and
dense paths make the same routing decision, including which tokens drop;
their outputs differ only by summation order (a float32 ulp).

The expert GEMMs stay ``torch.einsum``: XLA computed them outside any
Pallas kernel.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.autograd import _profiler_enabled

from uccl_tpu_torch.collective import dma as _dma
from uccl_tpu_torch.collective import lanes as _lanes
from uccl_tpu_torch.ep import gather as _gather
from uccl_tpu_torch.obs import counters as _obsc
from uccl_tpu_torch.obs import tracer as _obst
from uccl_tpu_torch.ops import quant as _quant

Axis = Union[str, Tuple[str, ...], None]

# The tags of the expert GEMMs' operand and results (the JAX package's
# checkpoint_name tags), shared by the sort/dense path here, the ll path
# (ep/ll.py) and the remat="mlp" save policy (models/flagship.remat_policy).
# A drifted name fails silently (the policy stops matching and the memory
# win goes), so every site uses this tuple.
MOE_CHECKPOINT_NAMES = ("moe_xe", "moe_hg", "moe_hu", "moe_ye")
_XE, _HG, _HU, _YE = MOE_CHECKPOINT_NAMES
_tagging = [0]  # depth of the regions whose save policy reads the tags


@torch.library.custom_op("uccl_tpu_torch::checkpoint_name", mutates_args=())
def _checkpoint_name_op(x: torch.Tensor, name: str) -> torch.Tensor:
    """A copy of ``x`` that carries ``name`` into the dispatcher, where a
    selective-checkpoint policy sees it among the op's arguments. (A custom
    op may not return its input, so the tag costs one copy.)"""
    return x.clone()


@_checkpoint_name_op.register_fake
def _(x, name):
    return torch.empty_like(x)


_checkpoint_name_op.register_autograd(lambda ctx, g: (g, None))


@contextlib.contextmanager
def tagging():
    """Emit the :func:`checkpoint_name` tags inside this block (a remat
    policy that saves them enters it); elsewhere a tag is the identity and
    costs nothing."""
    _tagging[0] += 1
    try:
        yield
    finally:
        _tagging[0] -= 1


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``jax.ad_checkpoint.checkpoint_name``: ``x``, tagged ``name`` for a
    save policy inside :func:`tagging`; the identity elsewhere."""
    return _checkpoint_name_op(x, name) if _tagging[0] else x

_CHUNK_DEPTH = _obsc.gauge(
    "ep_chunk_depth", "resolved chunk-pipeline depth of the last EP layer")

# The obs track of the MoE layer's spans (moe.route, moe.dispatch,
# moe.experts, moe.combine): the layer serves training and inference alike.
TRACK = "moe"


class MoeCounts:
    """The sorted and dense MoE layers' routing, summed over every forward
    while tracing is on (the obs tracer, or a ``torch.profiler`` capture):
    the choices made (T x k), the choices kept under capacity, and the
    expert slots the GEMMs compute (E x C), all members together. A
    recompute inside the backward (remat) does not count again. ``kept``
    stays on the device until :meth:`read`, the one host read; the ``moe``
    source on ``obs.REGISTRY`` reads it at each scrape."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._choices = self._slots = 0
            self._kept: Optional[torch.Tensor] = None

    def add(self, choices: int, slots: int, kept: torch.Tensor) -> None:
        n = kept.sum(dtype=torch.int64)
        with self._lock:
            self._choices += choices
            self._slots += slots
            self._kept = n if self._kept is None else self._kept + n

    def read(self) -> Dict[str, float]:
        """The counts, and once a choice is counted ``drop_pct`` = 100 (1 -
        kept / choices) and ``expert_fill`` = 100 kept / slots."""
        with self._lock:
            choices, slots, kept = self._choices, self._slots, self._kept
        n_kept = 0 if kept is None else int(kept)
        out = {"choices": choices, "kept": n_kept, "slots": slots}
        if choices:
            out["drop_pct"] = 100.0 * (1.0 - n_kept / choices)
            out["expert_fill"] = 100.0 * n_kept / slots
        return out


MOE_COUNTS = MoeCounts()
_obsc.REGISTRY.register_source("moe", MOE_COUNTS.read)


def _count(choices: int, slots: int, kept: torch.Tensor) -> None:
    """One forward's routing onto :data:`MOE_COUNTS` while tracing is on and
    outside a backward (a remat recompute runs inside one, and its forward
    has counted)."""
    if ((_obst.enabled() or _profiler_enabled())
            and torch._C._current_graph_task_id() == -1):
        MOE_COUNTS.add(choices, slots, kept)


class Routing(NamedTuple):
    """Routing decision for one shard's tokens (dense form)."""

    dispatch_mask: torch.Tensor  # [T, E, C] one-hot slot assignment (bool)
    combine_weights: torch.Tensor  # [T, E, C] f32 gate weights at assigned slots
    aux_loss: torch.Tensor  # load-balance loss (scalar)
    z_loss: torch.Tensor  # router z-loss (scalar)
    counts: torch.Tensor  # [E] tokens kept per expert


class SortedRouting(NamedTuple):
    """Routing decision in sorted/ragged form (no [T,E,C] mask tensor)."""

    token_for_slot: torch.Tensor  # [E*C] source token per slot (T = empty)
    slot: torch.Tensor  # [T, K] slot per assignment (E*C = dropped)
    weights: torch.Tensor  # [T, K] f32 gate weights (renormalized)
    aux_loss: torch.Tensor
    z_loss: torch.Tensor
    counts: torch.Tensor  # [E] tokens kept per expert


class SlotPlan(NamedTuple):
    """The slot permutation of one routing decision: dispatch gathers rows
    with ``token_for_slot``, combine gathers them back with ``slot``, and
    each one's backward is a gather through the other map
    (``ep/gather.py``)."""

    token_for_slot: torch.Tensor  # [E*C] source token per slot (T = empty)
    slot: torch.Tensor  # [T, K] slot per assignment (E*C = dropped)
    kept: torch.Tensor  # [E] tokens kept per expert

    def chunk_token_for_slot(self, num_experts: int, n_chunks: int,
                             empty_sentinel: int) -> torch.Tensor:
        """Per-chunk gather indices of the pipelined layer: the slot axis of
        each expert padded with empty slots (``dma.pad_capacity``) and cut
        into ``n_chunks``: ``[n_chunks, (W,) E, C_pad / n_chunks]``. The
        padding lives on the wire only; it never changes which tokens drop."""
        *lead, ec = self.token_for_slot.shape
        cap = ec // num_experts
        cap_p = _dma.pad_capacity(cap, n_chunks)
        tfs = self.token_for_slot.reshape(*lead, num_experts, cap)
        if cap_p != cap:
            tfs = F.pad(tfs, (0, cap_p - cap), value=empty_sentinel)
        cs = cap_p // n_chunks
        return tfs.reshape(*lead, num_experts, n_chunks, cs).movedim(-2, 0)


def _stack(ts) -> torch.Tensor:
    """``torch.stack`` along a new dim 0, but one tensor becomes a view: a
    world of 1 runs the member-stacked path with no copy."""
    ts = list(ts)
    return ts[0][None] if len(ts) == 1 else torch.stack(ts)


def _per_member(fn, first: torch.Tensor, *args, **kwargs):
    """``fn`` on each member's row of ``first`` ``[W, ...]`` (the other
    arguments shared), its tuple of results stacked along a new dim 0."""
    return tuple(_stack(t) for t in zip(*(fn(row, *args, **kwargs) for row in first)))


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the lower index (``lax.top_k``'s
    order), via a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gate_topk(router_logits: torch.Tensor, num_selected: int, renormalize: bool):
    """Softmax gates, z-loss, (renormalized) top-k selection and the GShard
    load-balance loss. Returns (topk_vals [T,K], topk_idx [T,K], aux, z)."""
    e = router_logits.shape[-1]
    logits32 = router_logits.float()
    gates = torch.softmax(logits32, dim=-1)  # [T, E]
    z = torch.logsumexp(logits32, dim=-1)
    z_loss = torch.mean(z * z)

    topk_vals, topk_idx = topk_stable(gates, num_selected)  # [T, K]
    if renormalize:
        topk_vals = topk_vals / torch.clamp_min(
            torch.sum(topk_vals, dim=-1, keepdim=True), 1e-9
        )

    me = torch.mean(gates, dim=0)  # [E]
    raw_onehot = F.one_hot(topk_idx, e).float()  # [T, K, E]
    ce = torch.mean(torch.sum(raw_onehot, dim=1), dim=0)  # [E] fraction demand
    aux_loss = torch.sum(me * ce) * (e / num_selected)
    return topk_vals, topk_idx, aux_loss, z_loss


def masks_from_topk(
    idx: torch.Tensor, wts: torch.Tensor, num_experts: int, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[T,E,C] dispatch/combine masks from explicit top-k assignments.

    Positions are assigned k-slot by k-slot, so earlier choices fill expert
    queues first; over-capacity assignments drop. Returns (dispatch_mask
    bool, combine_weights f32, kept counts [E] int32)."""
    t, k = idx.shape
    dev = idx.device
    counts = torch.zeros((num_experts,), dtype=torch.int32, device=dev)
    dispatch = torch.zeros((t, num_experts, capacity), dtype=torch.bool, device=dev)
    combine = torch.zeros((t, num_experts, capacity), dtype=torch.float32, device=dev)
    for j in range(k):
        onehot = F.one_hot(idx[:, j].long(), num_experts).to(torch.int32)  # [T, E]
        pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1 + counts[None, :]
        keep = (pos < capacity) & (onehot > 0)
        # keep already excludes positions outside [0, capacity)
        slot = pos.clamp(0, capacity - 1)[..., None] == torch.arange(capacity, device=dev)
        d_j = slot & keep[..., None]
        dispatch = dispatch | d_j
        combine = combine + d_j.float() * wts[:, j][:, None, None]
        counts = counts + torch.sum(keep.to(torch.int32), dim=0, dtype=torch.int32)
    return dispatch, combine, counts


def route_topk(
    router_logits: torch.Tensor, num_selected: int, capacity: int, *,
    renormalize: bool = True,
) -> Routing:
    """Top-k gating with per-expert capacity (dense [T,E,C] form); for
    member-stacked logits ``[W, T, E]`` per member, stacked."""
    if router_logits.ndim == 3:
        return Routing(*_per_member(route_topk, router_logits, num_selected, capacity,
                                    renormalize=renormalize))
    e = router_logits.shape[-1]
    vals, idx, aux, z = _gate_topk(router_logits, num_selected, renormalize)
    dispatch_mask, combine_w, counts = masks_from_topk(idx, vals, e, capacity)
    return Routing(dispatch_mask, combine_w, aux, z, counts)


def sorted_from_topk(
    idx: torch.Tensor, num_experts: int, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slot assignment from top-k expert ids via one stable argsort.

    idx: [T, K]. Flattening is k-major, so drops match
    :func:`masks_from_topk` exactly. Returns (token_for_slot [E*C] with T as
    the empty sentinel, slot [T, K] with E*C as the dropped sentinel, kept
    counts [E]), all int32."""
    t, k = idx.shape
    tk = t * k
    dev = idx.device
    flat_e = idx.t().reshape(tk).long()  # k-major
    flat_t = torch.arange(t, device=dev).repeat(k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_t = flat_t[order]
    counts = torch.bincount(flat_e, minlength=num_experts)  # [E] raw demand
    seg_start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(tk, device=dev) - seg_start[sorted_e]
    keep = pos < capacity
    slot_sorted = torch.where(
        keep, sorted_e * capacity + pos, torch.full_like(pos, num_experts * capacity)
    )
    slot = torch.empty(tk, dtype=torch.long, device=dev)
    slot[order] = slot_sorted
    slot = slot.reshape(k, t).t()
    # Inverse view: which sorted position feeds slot (e, p)?
    slot_ids = torch.arange(num_experts * capacity, device=dev)
    e_of_slot = slot_ids // capacity
    p_of_slot = slot_ids % capacity
    j = seg_start[e_of_slot] + p_of_slot
    kept = torch.clamp_max(counts, capacity)
    valid = p_of_slot < kept[e_of_slot]
    token_for_slot = torch.where(
        valid, sorted_t[j.clamp(0, tk - 1)], torch.full_like(j, t)
    )
    return (token_for_slot.to(torch.int32), slot.to(torch.int32).contiguous(),
            kept.to(torch.int32))


def plan_slots(topk_idx: torch.Tensor, num_experts: int, capacity: int) -> SlotPlan:
    """One argsort -> the :class:`SlotPlan` of a routing decision; for
    member-stacked ``topk_idx`` ``[W, T, K]``, one per member, stacked."""
    if topk_idx.ndim == 3:
        return SlotPlan(*_per_member(sorted_from_topk, topk_idx, num_experts, capacity))
    return SlotPlan(*sorted_from_topk(topk_idx, num_experts, capacity))


def route_topk_sorted(
    router_logits: torch.Tensor, num_selected: int, capacity: int, *,
    renormalize: bool = True,
) -> SortedRouting:
    """Top-k gating in sorted form: the math and losses of
    :func:`route_topk`, without [T,E,C] masks; for member-stacked logits
    ``[W, T, E]`` per member, stacked."""
    if router_logits.ndim == 3:
        return SortedRouting(*_per_member(route_topk_sorted, router_logits, num_selected,
                                          capacity, renormalize=renormalize))
    e = router_logits.shape[-1]
    vals, idx, aux, z = _gate_topk(router_logits, num_selected, renormalize)
    token_for_slot, slot, kept = sorted_from_topk(idx, e, capacity)
    return SortedRouting(token_for_slot, slot, vals, aux, z, kept)


def _take_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x[index] along dim 0, where the out-of-range index x.shape[0] reads
    a row of zeros (JAX's ``take(..., mode="fill", fill_value=0)``)."""
    padded = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))], dim=0)
    return padded[index.long()]


def _take_member_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Member-stacked :func:`_take_rows`: member r's rows ``x[r][index[r]]``
    (``x`` ``[W, N, ...]``, ``index`` ``[W, ...]``), the index N reading a
    row of zeros."""
    w = x.shape[0]
    if w == 1:
        return _take_rows(x[0], index[0])[None]
    padded = torch.cat([x, x.new_zeros((w, 1) + tuple(x.shape[2:]))], dim=1)
    r = torch.arange(w, device=x.device).reshape((w,) + (1,) * (index.ndim - 1))
    return padded[r, index.long()]


def _weighted_sum(weights: torch.Tensor, yk: torch.Tensor) -> torch.Tensor:
    """Each member's ``tk,tkh->th`` weighted sum (``[W, T, K]`` and ``[W, T,
    K, H]``), member by member: the ll path's and the chunk pipeline's
    combine (the sorted combine fuses it into ``gather.combine_rows``)."""
    return _stack(torch.einsum("tk,tkh->th", wt.to(y.dtype), y) for wt, y in zip(weights, yk))


def _members_to_wire(expert_out: torch.Tensor, w: int) -> torch.Tensor:
    """``[W, E_local, W*C, H]`` expert view → the member-major wire buffer
    ``[W, W, E_local, C, H]`` (slot s of member r: the rows of source s)."""
    _, e_local, wc, h = expert_out.shape
    return expert_out.reshape(w, e_local, w, wc // w, h).transpose(1, 2)


def _wire_to_members(buf: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_members_to_wire`: ``[W, W, E_local, C, H]`` →
    ``[W, E_local, W*C, H]``, source-major slots per local expert."""
    w, _, e_local, c, h = buf.shape
    return buf.transpose(1, 2).reshape(w, e_local, w * c, h)


def dispatch_sorted(x: torch.Tensor, plan: SlotPlan, num_experts: int, capacity: int,
                    axis: Axis = None, *, wire_fp8: bool = False, quant_group: int = 128,
                    wire: str = "lax", n_chunks: int = 1, wire_dtype=None,
                    schedule=None) -> torch.Tensor:
    """Ragged dispatch: one gather packs the [E*C, H] slot payloads (empty
    slots read zeros), then the member-major all-to-all. The gather is
    ``gather.dispatch_rows`` through the :class:`SlotPlan`'s
    ``token_for_slot``, its backward a gather through the plan's ``slot``.
    World 1 (no ``axis``): x ``[T, H]`` → ``[E, C, H]``. Member-stacked: x
    ``[W, T, H]``, the plan's maps ``[W, E*C]`` and ``[W, T, K]`` → ``[W,
    E_local, W*C, H]``. ``n_chunks`` splits the pallas wire's capacity axis
    into that many launches; ``wire_dtype`` quantizes the wire payload;
    ``schedule`` runs the pallas wire one contention-free round at a time
    (``a2a_sched.wire_schedule``). The same bits on every wire."""
    if axis is None:
        rows = _gather.dispatch_rows(x[None], plan.token_for_slot[None], plan.slot[None])[0]
        return rows.reshape(num_experts, capacity, x.shape[-1])
    w, _, h = x.shape
    if num_experts % w:
        raise ValueError(f"experts {num_experts} not divisible by EP world {w}")
    rows = _gather.dispatch_rows(x, plan.token_for_slot, plan.slot)
    buf = rows.reshape(w, w, num_experts // w, capacity, h)
    cid = _dma.CID_SCHED if schedule is not None else _dma.CID_EP_DISPATCH
    buf = _wire_all_to_all(buf, wire_fp8, quant_group, x.dtype, wire, n_chunks=n_chunks,
                           chunk_axis=2, collective_id=cid, wire_dtype=wire_dtype,
                           schedule=schedule)
    return _wire_to_members(buf)


def combine_sorted(expert_out: torch.Tensor, slot, weights: torch.Tensor, axis: Axis = None,
                   *, wire_fp8: bool = False, quant_group: int = 128, wire: str = "lax",
                   n_chunks: int = 1, wire_dtype=None, schedule=None) -> torch.Tensor:
    """Ragged combine: the expert outputs go home over the wire, then one
    fused [T, K]-row gather and float32 weighted sum
    (``gather.combine_rows``; dropped assignments add nothing), whose
    backward writes each slot once. World 1: expert_out ``[E, C, H]`` →
    ``[T, H]``. Member-stacked:
    ``[W, E_local, W*C, H]`` → ``[W, T, H]``; ``schedule`` is the combine
    direction's (the dispatch matrix transposed: traffic flows home)."""
    if isinstance(slot, SlotPlan):
        slot = slot.slot
    if axis is None:
        y = expert_out.reshape(1, -1, expert_out.shape[-1])  # [1, E*C, H], expert-major
        return _gather.combine_rows(y, slot[None], weights[None])[0]
    w, h = expert_out.shape[0], expert_out.shape[-1]
    cid = _dma.CID_SCHED_COMBINE if schedule is not None else _dma.CID_EP_COMBINE
    buf = _wire_all_to_all(_members_to_wire(expert_out, w), wire_fp8, quant_group,
                           expert_out.dtype, wire, n_chunks=n_chunks, chunk_axis=2,
                           collective_id=cid, wire_dtype=wire_dtype, schedule=schedule)
    y = buf.reshape(w, -1, h)  # [W, E*C, H], expert-major
    return _gather.combine_rows(y, slot, weights)


def dispatch(x: torch.Tensor, dispatch_mask: torch.Tensor, axis: Axis = None, *,
             wire_fp8: bool = False, quant_group: int = 128, wire: str = "lax",
             wire_dtype=None) -> torch.Tensor:
    """Dense dispatch: [T, H] tokens into [E, C, H] expert buffers; member-
    stacked, ``[W, T, H]`` → ``[W, E_local, W*C, H]`` over the wire."""
    if axis is None:
        return torch.einsum("tec,th->ech", dispatch_mask.to(x.dtype), x)
    w, _, e, c = dispatch_mask.shape
    if e % w:
        raise ValueError(f"experts {e} not divisible by EP world {w}")
    buf = _stack(dispatch(xr, mr) for xr, mr in zip(x, dispatch_mask))
    buf = _wire_all_to_all(buf.reshape(w, w, e // w, c, x.shape[-1]), wire_fp8, quant_group,
                           x.dtype, wire, collective_id=_dma.CID_EP_DISPATCH,
                           wire_dtype=wire_dtype)
    return _wire_to_members(buf)


def combine(expert_out: torch.Tensor, combine_weights: torch.Tensor, axis: Axis = None, *,
            wire_fp8: bool = False, quant_group: int = 128, wire: str = "lax",
            wire_dtype=None) -> torch.Tensor:
    """Dense combine: [E, C, H] expert outputs weighted back to [T, H];
    member-stacked, ``[W, E_local, W*C, H]`` → ``[W, T, H]``."""
    if axis is None:
        return torch.einsum("tec,ech->th", combine_weights.to(expert_out.dtype), expert_out)
    w, _, e, c = combine_weights.shape
    buf = _wire_all_to_all(_members_to_wire(expert_out, w), wire_fp8, quant_group,
                           expert_out.dtype, wire, collective_id=_dma.CID_EP_COMBINE,
                           wire_dtype=wire_dtype)
    return _stack(combine(yr, cr) for yr, cr in zip(buf.reshape(w, e, c, -1), combine_weights))


def counts_exchange(mat: torch.Tensor) -> torch.Tensor:
    """Member-stacked ``[W, W, ...]`` per-destination rows → per-source rows
    (row s of member r's result is what source s computed for r): the
    receive bookkeeping of both dispatch paths. A transpose of the member
    axes (XLA's ``all_to_all`` in JAX)."""
    return mat.transpose(0, 1).contiguous()


def _member_all_to_all(buf: torch.Tensor, wire: str, *, n_chunks: int = 1, chunk_axis: int = 1,
                       collective_id=None, schedule=None) -> torch.Tensor:
    """One member-major ``[W, W, ...]`` exchange on the selected wire:
    ``"lax"``, the stock wire (the transpose of the member axes), or
    ``"pallas"``, B9 (``ep/pallas_a2a.all_to_all``) or, with a
    ``schedule``, B10 per round. The same tiled contract and bits;
    ``n_chunks``/``chunk_axis``/``collective_id``/``schedule`` reach the
    pallas wire only."""
    if wire == "pallas":
        from uccl_tpu_torch.ep import pallas_a2a

        if schedule is not None:
            return pallas_a2a.scheduled_all_to_all(buf, schedule, n_chunks=n_chunks,
                                                   chunk_axis=chunk_axis,
                                                   collective_id=collective_id)
        return pallas_a2a.all_to_all(buf, n_chunks=n_chunks, chunk_axis=chunk_axis,
                                     collective_id=collective_id)
    if wire != "lax":
        raise ValueError(f"unknown EP wire {wire!r} (want 'lax' or 'pallas')")
    return buf.transpose(0, 1).contiguous()


def resolve_wire_dtype(wire_fp8: bool, wire_dtype=None):
    """The EP knob rule: an explicit ``wire_dtype`` wins; the legacy
    ``wire_fp8`` bool maps to "fp8"; otherwise full precision."""
    wire_dtype = _quant.resolve_wire_dtype(wire_dtype)
    if wire_dtype is None and wire_fp8:
        wire_dtype = "fp8"
    return wire_dtype


def wire_itemsize(wire_fp8: bool, hidden: int, dtype: torch.dtype, quant_group: int = 128,
                  wire_dtype=None) -> int:
    """Bytes per element the wire moves, what the budget gates charge: 1
    when the block-scaled packing applies, else the element width."""
    wire_dtype = resolve_wire_dtype(wire_fp8, wire_dtype)
    if (wire_dtype is not None and dtype.is_floating_point
            and _quant.paying_block(hidden, quant_group)):
        return 1
    return dtype.itemsize


# the one wire-byte arithmetic (the codec's), under the EP name
wire_bytes_of = _quant.wire_bytes_of


def _wire_all_to_all(buf: torch.Tensor, wire_fp8: bool, quant_group: int, dtype: torch.dtype,
                     wire: str = "lax", *, n_chunks: int = 1, chunk_axis: int = 1,
                     collective_id=None, wire_dtype=None, schedule=None) -> torch.Tensor:
    """Member-major all-to-all of a ``[W, W, ...]`` buffer, block-quantized
    on the wire under a ``wire_dtype``: payload, then scales on
    ``collective_id + CID_SCALE_OFFSET`` over the same wire and schedule,
    then the dequantize. A non-float payload, or a hidden dim that admits
    no paying block, ships full precision, counted on
    ``ep_wire_fallback_total``."""

    def xchg(rows, cid_off=0):
        cid = None if collective_id is None else collective_id + cid_off
        return _member_all_to_all(rows, wire, n_chunks=n_chunks, chunk_axis=chunk_axis,
                                  collective_id=cid, schedule=schedule)

    wire_dtype = resolve_wire_dtype(wire_fp8, wire_dtype)
    if wire_dtype is not None and not buf.dtype.is_floating_point:
        name = str(buf.dtype).removeprefix("torch.")
        _dma.record_fallback(
            "ep_wire_quant", "quant_dtype", detail=name,
            msg=f"ep wire_dtype={wire_dtype!r} needs a float payload, got {name}; "
                "shipping full precision")
        wire_dtype = None
    if wire_dtype is None:
        return xchg(buf)
    group = _quant.paying_block(buf.shape[-1], quant_group)
    if group is None:
        _dma.record_fallback(
            "ep_wire_quant", "block_too_small", detail=(buf.shape[-1], quant_group),
            msg=f"ep wire_dtype={wire_dtype!r}: hidden {buf.shape[-1]} only admits blocks < 8 "
                f"(requested {quant_group}); shipping full precision")
        return xchg(buf)
    q, scale = _quant.quantize_block(buf, wire_dtype, group)
    with _lanes.one_check():  # payload and scales: one error read after both
        return _quant.dequantize_block(xchg(q), xchg(scale, _dma.CID_SCALE_OFFSET), group,
                                       dtype=dtype)


def resolve_chunks(n_chunks: int, wire: str, world: int, capacity: int, e_local: int,
                   hidden: int, itemsize: int, wire_dtype=None, device=None) -> int:
    """Effective chunk depth of the pipelined EP layer. ``0`` is auto: the
    planner's depth (``plan.ep_auto_depth``) on the pallas wire when the
    world and capacity can chunk. Any request is 1 off the pallas wire or at
    world 1 (an explicit depth > 1 on the pallas wire then counts on
    ``ep_wire_fallback_total``), and 1 for a CPU tensor (``device`` not
    CUDA) whose pipeline footprint (4 resident send+recv chunk pairs) is
    over budget. The result lands on the ``ep_chunk_depth`` gauge and the
    plan counter (``collective_plan_total{algo="ep_a2a"}``)."""
    n = _resolve_chunks_value(n_chunks, wire, world, capacity, e_local, hidden, itemsize,
                              device)
    from uccl_tpu_torch.collective import plan as _plan

    _CHUNK_DEPTH.set(n, what="moe_layer")
    _plan.get_planner().record_ep_chunks(n, wire=wire, wire_dtype=wire_dtype,
                                         auto=(n_chunks == 0))
    return n


def _resolve_chunks_value(n_chunks, wire, world, capacity, e_local, hidden, itemsize,
                          device) -> int:
    requested = n_chunks > 1 and wire == "pallas"
    if wire != "pallas" or world <= 1 or capacity < 2:
        if requested:
            _dma.record_fallback("ep_moe_chunked", "world_size" if world <= 1 else "capacity",
                                 detail=(world, capacity))
        return 1
    if n_chunks == 0:
        from uccl_tpu_torch.collective import plan as _plan

        n_chunks = _plan.get_planner().ep_auto_depth(
            world * e_local * capacity * hidden * itemsize, capacity)
    n_chunks = max(1, min(int(n_chunks), capacity))
    if n_chunks > 1 and (device is None or torch.device(device).type != "cuda"):
        cs = _dma.pad_capacity(capacity, n_chunks) // n_chunks
        if not _dma.chunk_budget(world, e_local * cs * hidden, itemsize, "ep_moe_chunked",
                                 resident_kernels=4):
            n_chunks = 1  # chunk_budget counted and logged it
    return n_chunks


def _expert_gemms(xe, w_gate, w_up, w_down):
    """The SwiGLU expert GEMMs: [E, C, H] -> [E, C, H], the operand and the
    three results tagged (:data:`MOE_CHECKPOINT_NAMES`) for remat="mlp".
    The products keep their expert batch dim (``bmm``), so remat="dots"
    does not save them, as the JAX package's batched einsums."""
    xe = checkpoint_name(xe, _XE)
    h_gate = checkpoint_name(torch.einsum("ebh,ehf->ebf", xe, w_gate), _HG)
    h_up = checkpoint_name(torch.einsum("ebh,ehf->ebf", xe, w_up), _HU)
    act = F.silu(h_gate) * h_up
    return checkpoint_name(torch.einsum("ebf,efh->ebh", act, w_down), _YE)


def _member_gemms(xe, w_gate, w_up, w_down):
    """:func:`_expert_gemms` on each member's local experts: ``[W, E_local,
    W*C, H]`` with weights ``[W, E_local, ...]``."""
    return _stack(_expert_gemms(*a) for a in zip(xe, w_gate, w_up, w_down))


def _moe_ffn_sort_chunked(x, plan: SlotPlan, weights, w_gate, w_up, w_down, num_experts: int,
                          capacity: int, n_chunks: int, wire_dtype=None) -> torch.Tensor:
    """The chunk-pipelined sorted MoE step on the pallas wire, member-
    stacked. The capacity axis is cut into ``n_chunks`` (padded with empty
    slots by ``dma.pad_capacity``, so the drops are the unchunked layer's)
    and each chunk runs dispatch → expert GEMMs → combine on its own, its
    exchanges on 2-parity rotated ids (dispatch {2,3}, combine {4,5}). Slot
    rows are independent through the GEMMs and the exchange keeps
    positions, so the result equals the unchunked layer's; the token gather
    and weighted sum run once on the reassembled buffer. All launches go to
    the current CUDA stream, in chunk order (``dma.tie_chunk``), and the
    host reads their error words once, after the last."""
    with _lanes.one_check():
        w, t, h = x.shape
        e_local = num_experts // w
        tfs_chunks = plan.chunk_token_for_slot(num_experts, n_chunks, t)  # [n, W, E, cs]
        cs = tfs_chunks.shape[-1]
        recv_chunks, y_chunks = [], []
        for c in range(n_chunks):
            with _obst.span("moe.dispatch", TRACK):
                buf = _take_member_rows(x, tfs_chunks[c].reshape(w, -1)).reshape(
                    w, w, e_local, cs, h)
                buf = _dma.tie_chunk(buf, recv_chunks[c - 2] if c >= 2 else None)
                buf = _wire_all_to_all(
                    buf, False, 128, x.dtype, "pallas",
                    collective_id=_dma.chunk_collective_id(_dma.CID_EP_DISPATCH, c),
                    wire_dtype=wire_dtype)
                xe = _wire_to_members(buf)
            recv_chunks.append(xe)
            with _obst.span("moe.experts", TRACK):
                ye = _member_gemms(xe, w_gate, w_up, w_down)
            with _obst.span("moe.combine", TRACK):
                back = _dma.tie_chunk(_members_to_wire(ye, w),
                                      y_chunks[c - 2] if c >= 2 else None)
                back = _wire_all_to_all(
                    back, False, 128, ye.dtype, "pallas",
                    collective_id=_dma.chunk_collective_id(_dma.CID_EP_COMBINE, c),
                    wire_dtype=wire_dtype)
            y_chunks.append(back.reshape(w, num_experts, cs, h))
        with _obst.span("moe.combine", TRACK):
            y = torch.cat(y_chunks, dim=2)[:, :, :capacity].reshape(w, num_experts * capacity, h)
            return _weighted_sum(weights, _take_member_rows(y, plan.slot))


def moe_ffn(
    x: torch.Tensor,
    router_logits: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    axis: Axis = None,
    *,
    num_selected: int = 2,
    capacity_factor: float = 1.25,
    wire_fp8: bool = False,
    impl: str = "sort",
    wire: str = "lax",
    n_chunks: int = 1,
    wire_dtype=None,
    ll_grouped: str = "fixed",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The MoE layer: route -> dispatch -> SwiGLU experts -> combine.

    World 1 (no ``axis``): x ``[T, H]``, router_logits ``[T, E]``,
    w_gate/w_up ``[E, H, F]``, w_down ``[E, F, H]``; returns (out ``[T, H]``
    in x's dtype, aux_loss, z_loss). Member-stacked: x ``[W, T, H]``,
    router_logits ``[W, T, E]``, weights the members' local experts ``[W,
    E_local, ...]``; returns (``[W, T, H]``, aux ``[W]``, z ``[W]``).

    impl: "sort" (ragged gathers), "dense" (mask-einsum oracle; the two
    route identically) or "ll" (the packed low-latency path, ``ep/ll.py``:
    grouped GEMMs over receive counts, ``capacity_factor`` its
    ``pair_capacity_factor``). wire: "lax" or "pallas" (for "ll",
    "pallas" selects its dense-chunk layout on the kernel, anything else
    its auto wire). n_chunks: the pallas wire's pipeline depth (0 = auto);
    with "sort" and a depth > 1 the layer runs the chunk pipeline.
    wire_dtype: "fp8" | "int8" quantizes the dispatch and combine payloads
    (``wire_fp8=True`` is the legacy "fp8"). ll_grouped: the "ll" path's
    grouped GEMM, "fixed" (serving's fixed shapes) or "ragged" (training:
    the products see only the packed rows, ``ll.grouped_ffn_ragged``).

    The stages run under the spans ``moe.route``, ``moe.dispatch``,
    ``moe.experts`` and ``moe.combine`` (track :data:`TRACK`), and while
    tracing is on "sort" and "dense" count their routing on
    :data:`MOE_COUNTS`."""
    wire_dtype = resolve_wire_dtype(wire_fp8, wire_dtype)
    if axis is None:
        # world 1 is one member of a member-stacked world: views, no copies;
        # the wire moves nothing (a quantized wire still round-trips, as in
        # the JAX package)
        out, aux, z = moe_ffn(x[None], router_logits[None], w_gate[None], w_up[None],
                              w_down[None], "ep", num_selected=num_selected,
                              capacity_factor=capacity_factor, impl=impl, wire=wire,
                              n_chunks=n_chunks, wire_dtype=wire_dtype, ll_grouped=ll_grouped)
        return out[0], aux[0], z[0]
    with _lanes.one_check():  # every exchange's error word, read once at the end
        w, t, h = x.shape
        e = router_logits.shape[-1]
        capacity = max(1, int(capacity_factor * t * num_selected / e))
        if impl == "ll":
            from uccl_tpu_torch.ep.ll import ll_moe_ffn

            return ll_moe_ffn(x, router_logits, w_gate, w_up, w_down, num_selected=num_selected,
                              pair_capacity_factor=capacity_factor,
                              wire="pallas" if wire == "pallas" else "auto",
                              wire_dtype=wire_dtype, n_chunks=n_chunks, grouped=ll_grouped)
        if impl not in ("sort", "dense"):
            raise ValueError(f"unknown moe impl {impl!r} (want 'sort', 'dense', or 'll')")
        with _obst.span("moe.route", TRACK):
            route = route_topk_sorted if impl == "sort" else route_topk
            r = route(router_logits, num_selected, capacity)
            _count(w * t * num_selected, w * e * capacity, r.counts)
        if impl == "sort":
            plan = SlotPlan(r.token_for_slot, r.slot, r.counts)
            n_chunks = resolve_chunks(n_chunks, wire, w, capacity, e // w, h,
                                      wire_itemsize(False, h, x.dtype, wire_dtype=wire_dtype),
                                      wire_dtype=wire_dtype, device=x.device)
            if n_chunks > 1:
                out = _moe_ffn_sort_chunked(x, plan, r.weights, w_gate, w_up, w_down, e, capacity,
                                            n_chunks, wire_dtype=wire_dtype)
                return out.to(x.dtype), r.aux_loss, r.z_loss
        with _obst.span("moe.dispatch", TRACK):
            if impl == "sort":
                xe = dispatch_sorted(x, plan, e, capacity, axis, wire=wire, wire_dtype=wire_dtype)
            else:
                xe = dispatch(x, r.dispatch_mask, axis, wire=wire, wire_dtype=wire_dtype)
        with _obst.span("moe.experts", TRACK):
            ye = _member_gemms(xe, w_gate, w_up, w_down)
        with _obst.span("moe.combine", TRACK):
            if impl == "sort":
                out = combine_sorted(ye, r.slot, r.weights, axis, wire=wire,
                                     wire_dtype=wire_dtype)
            else:
                out = combine(ye, r.combine_weights, axis, wire=wire, wire_dtype=wire_dtype)
            return out.to(x.dtype), r.aux_loss, r.z_loss
