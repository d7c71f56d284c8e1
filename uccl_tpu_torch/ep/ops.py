"""MoE routing, dispatch and combine at expert-parallel world 1.

Port of the world-1 pieces of ``uccl_tpu/ep/ops.py``: top-k gating with
per-expert capacity, the dense one-hot oracle (``route_topk``,
``masks_from_topk``, ``dispatch``, ``combine``), the sorted path
(``sorted_from_topk``, ``SlotPlan``, ``plan_slots``, ``route_topk_sorted``,
``dispatch_sorted``, ``combine_sorted``), the SwiGLU expert GEMMs and
``moe_ffn(impl="sort" | "dense")``.

At world 1 the EP wire moves nothing (the JAX all-to-all over a size-1 axis
is the identity), so dispatch and combine here are the local gathers and
einsums alone. Drop priority is the reference's: earlier k-slots fill expert
queues first, then token order, and gate ties resolve to the lower expert
index (``lax.top_k``'s order; ``torch.topk`` promises none, so the top-k here
is a stable descending sort). The sorted and dense paths therefore make the
same routing decision, including which tokens drop; their outputs differ
only by summation order (a float32 ulp).

The expert GEMMs stay ``torch.einsum``: XLA computed them outside any Pallas
kernel. The packed low-latency path (``impl="ll"``, ``ep/ll.py``), the
quantized wires and the multi-member wires are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


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
    with ``token_for_slot``, combine gathers them back with ``slot``."""

    token_for_slot: torch.Tensor  # [E*C] source token per slot (T = empty)
    slot: torch.Tensor  # [T, K] slot per assignment (E*C = dropped)
    kept: torch.Tensor  # [E] tokens kept per expert


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
    """Top-k gating with per-expert capacity (dense [T,E,C] form)."""
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
    """One argsort -> the :class:`SlotPlan` of a routing decision."""
    return SlotPlan(*sorted_from_topk(topk_idx, num_experts, capacity))


def route_topk_sorted(
    router_logits: torch.Tensor, num_selected: int, capacity: int, *,
    renormalize: bool = True,
) -> SortedRouting:
    """Top-k gating in sorted form: the math and losses of
    :func:`route_topk`, without [T,E,C] masks."""
    e = router_logits.shape[-1]
    vals, idx, aux, z = _gate_topk(router_logits, num_selected, renormalize)
    token_for_slot, slot, kept = sorted_from_topk(idx, e, capacity)
    return SortedRouting(token_for_slot, slot, vals, aux, z, kept)


def _take_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x[index] along dim 0, where the out-of-range index x.shape[0] reads
    a row of zeros (JAX's ``take(..., mode="fill", fill_value=0)``)."""
    padded = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))], dim=0)
    return padded[index.long()]


def dispatch_sorted(x: torch.Tensor, token_for_slot, num_experts: int,
                    capacity: int) -> torch.Tensor:
    """Ragged dispatch: one gather packs the [E*C, H] slot payloads; empty
    slots read zeros. ``token_for_slot`` may be a :class:`SlotPlan`.
    Returns [E, C, H] (the world-1 [E_local, W*C, H])."""
    if isinstance(token_for_slot, SlotPlan):
        token_for_slot = token_for_slot.token_for_slot
    return _take_rows(x, token_for_slot).reshape(num_experts, capacity, x.shape[-1])


def combine_sorted(expert_out: torch.Tensor, slot, weights: torch.Tensor) -> torch.Tensor:
    """Ragged combine: one [T, K]-row gather and a weighted sum; dropped
    assignments read zeros. expert_out: [E, C, H] -> [T, H]."""
    if isinstance(slot, SlotPlan):
        slot = slot.slot
    y = expert_out.reshape(-1, expert_out.shape[-1])  # [E*C, H], expert-major
    yk = _take_rows(y, slot)  # [T, K, H]
    return torch.einsum("tk,tkh->th", weights.to(yk.dtype), yk)


def dispatch(x: torch.Tensor, dispatch_mask: torch.Tensor) -> torch.Tensor:
    """Dense dispatch: [T, H] tokens into [E, C, H] expert buffers."""
    return torch.einsum("tec,th->ech", dispatch_mask.to(x.dtype), x)


def combine(expert_out: torch.Tensor, combine_weights: torch.Tensor) -> torch.Tensor:
    """Dense combine: [E, C, H] expert outputs weighted back to [T, H]."""
    return torch.einsum("tec,ech->th", combine_weights.to(expert_out.dtype), expert_out)


def _expert_gemms(xe, w_gate, w_up, w_down):
    """The SwiGLU expert GEMMs: [E, C, H] -> [E, C, H]."""
    h_gate = torch.einsum("ebh,ehf->ebf", xe, w_gate)
    h_up = torch.einsum("ebh,ehf->ebf", xe, w_up)
    act = F.silu(h_gate) * h_up
    return torch.einsum("ebf,efh->ebh", act, w_down)


def moe_ffn(
    x: torch.Tensor,
    router_logits: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    *,
    num_selected: int = 2,
    capacity_factor: float = 1.25,
    impl: str = "sort",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MoE layer at world 1: route -> dispatch -> SwiGLU experts -> combine.

    x: [T, H]; router_logits: [T, E]; w_gate/w_up: [E, H, F];
    w_down: [E, F, H]. impl: "sort" (ragged gathers) or "dense" (mask-einsum
    oracle); the two route identically. Returns (out [T, H] in x's dtype,
    aux_loss, z_loss)."""
    t, _ = x.shape
    e = router_logits.shape[-1]
    capacity = max(1, int(capacity_factor * t * num_selected / e))
    if impl == "sort":
        rs = route_topk_sorted(router_logits, num_selected, capacity)
        xe = dispatch_sorted(x, rs.token_for_slot, e, capacity)
        ye = _expert_gemms(xe, w_gate, w_up, w_down)
        out = combine_sorted(ye, rs.slot, rs.weights)
        aux_loss, z_loss = rs.aux_loss, rs.z_loss
    elif impl == "dense":
        r = route_topk(router_logits, num_selected, capacity)
        ye = _expert_gemms(dispatch(x, r.dispatch_mask), w_gate, w_up, w_down)
        out = combine(ye, r.combine_weights)
        aux_loss, z_loss = r.aux_loss, r.z_loss
    elif impl == "ll":
        raise NotImplementedError(
            "moe impl 'll' (packed grouped-GEMM path, ep/ll.py) is not ported yet"
        )
    else:
        raise ValueError(f"unknown moe impl {impl!r} (want 'sort' or 'dense')")
    return out.to(x.dtype), aux_loss, z_loss
