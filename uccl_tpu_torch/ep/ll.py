"""Low-latency expert-parallel path: packed no-padding dispatch and combine.

Port of ``uccl_tpu/ep/ll.py``, the re-design of the reference's low-latency
EP mode (DeepEP's ``low_latency_dispatch``/``combine``): per-expert packed
payloads sized by ``num_max_dispatch_tokens_per_rank``, per-expert receive
counts returned to the caller, and expert compute that never touches a
padded slot.

* The *layout kernel* is one stable argsort by global expert id per member:
  each member owns a contiguous expert range, so expert order is
  destination-major order, and one sort gives both the wire packing and the
  receive grouping.
* The *wire* has three forms. ``"ragged"`` moves only the real rows
  (``lax.ragged_all_to_all`` in JAX; here index copies per (source,
  destination) pair, which read the row counts on the host); ``"dense"``
  carries the same packed layout in fixed per-pair chunks (XLA's
  ``all_to_all`` in JAX; a transpose of the member axes here); ``"pallas"``
  is the dense layout on the hand-written all-to-all kernel B9
  (``ep/pallas_a2a.py``). ``"auto"`` is ``"ragged"`` for CUDA tensors and
  ``"dense"`` on the CPU, as the JAX package picks ragged on a GPU or TPU
  backend and dense on XLA:CPU.
* The *grouped GEMM* (``lax.ragged_dot`` in JAX, XLA code and no Pallas
  kernel) has two forms. :func:`grouped_ffn`, the serving form, gathers
  each local expert's rows to the front of a fixed ``[R_max, H]`` block
  and runs the three products on all the blocks at once: the same shapes
  whatever the counts, so a row's result does not depend on what else the
  batch routed (a GEMM library picks its summation order by the row count;
  the serving engine's exactness against a request run alone rests on
  this), and the sizes never leave the device. It spends ``E_local`` times
  the FLOPs of the real rows, on the decode batches serving runs, where
  the weights' bytes set the time. :func:`grouped_ffn_ragged`, the
  training form (``moe_ffn(..., ll_grouped="ragged")``), reads the counts
  on the host once and runs each expert's products on its own segment of
  packed rows only: FLOPs in proportion to ``sum(group_sizes)``, as
  ``ragged_dot``'s.

Tensors are member-stacked: row r of every ``[W, ...]`` tensor is member
r's shard of the JAX per-shard function. ``topk_idx`` entries of ``-1``
mean "no expert" (DeepEP's contract): they claim no wire slot and combine
to zero. ``num_max_dispatch_tokens_per_rank`` (M) bounds the tokens one
member sends; the static receive bound is ``R_max = W * M * min(K,
E_local)`` rows, and rows past a violated bound drop tail-first per
destination.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from uccl_tpu_torch.collective import dma as _dma
from uccl_tpu_torch.collective import lanes as _lanes
from uccl_tpu_torch.ep.ops import (MOE_CHECKPOINT_NAMES, TRACK, _expert_gemms, _gate_topk,
                                   _per_member, _stack, _take_member_rows, _weighted_sum,
                                   checkpoint_name, counts_exchange, resolve_wire_dtype)
from uccl_tpu_torch.obs import tracer as _obst
from uccl_tpu_torch.ops import quant as _quant


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last dim."""
    return torch.cumsum(x, dim=-1) - x


def wire_supports_ragged(device) -> bool:
    """The ragged wire is the default on the card (the JAX package's on a
    GPU or TPU backend); on the CPU ``auto`` picks the dense wire, as
    XLA:CPU lowers no ragged all-to-all."""
    return torch.device(device).type == "cuda"


def _resolve_quant(h: int, wire_fp8: bool, wire_dtype, quant_group: int):
    """The LL wire's quantization decision: (wire_dtype, block) or None. A
    requested wire dtype that would not pay (only blocks < 8 divide h)
    ships full precision, counted on ``ep_wire_fallback_total``."""
    wire_dtype = resolve_wire_dtype(wire_fp8, wire_dtype)
    if wire_dtype is None:
        return None
    g = _quant.paying_block(h, quant_group)
    if g is None:
        _dma.record_fallback(
            "ep_wire_quant", "block_too_small", detail=(h, quant_group),
            msg=f"ll wire_dtype={wire_dtype!r}: hidden {h} only admits blocks < 8 (requested "
                f"{quant_group}); shipping full precision")
        return None
    return wire_dtype, g


def resolve_ll_chunks(n_chunks: int, wire: str, world: int, per_pair: int) -> int:
    """Effective chunk depth of the LL dense-chunk wire (shared with the
    Buffer verbs, so the handle records what dispatch ran): 1 off the pallas
    wire or at world 1 (an explicit depth > 1 on the pallas wire at world 1
    counts on ``ep_wire_fallback_total``); 0 = auto, 2 when the per-pair
    slot axis can split; at most ``per_pair``."""
    if wire != "pallas" or world <= 1:
        if n_chunks > 1 and wire == "pallas":
            _dma.record_fallback("ep_ll_chunked", "world_size", detail=world)
        return 1
    if n_chunks == 0:
        n_chunks = 2 if per_pair >= 2 else 1
    return max(1, min(int(n_chunks), per_pair))


class LLState(NamedTuple):
    """The layout ll_dispatch saves for ll_combine (the handle), member-stacked."""

    send_slot: torch.Tensor  # [W, T, K] int32 wire-buffer row per assignment (sentinel: dropped)
    weights: torch.Tensor  # [W, T, K] f32 gate weights
    send_mat: torch.Tensor  # [W, W, E_local] int32 rows each member sends per (dst, expert)
    recv_mat: torch.Tensor  # [W, W, E_local] int32 rows each member receives per (src, expert)
    regroup: torch.Tensor  # [W, R_max] int32: grouped row i <- wire row
    src_in_offsets: torch.Tensor  # [W, W] int32 where my chunk sat in each source's send
    #   buffer (the ragged wire's way back; zeros on the dense wires)
    wire: str  # "ragged" | "dense" | "pallas"
    n_chunks: int = 1  # the pallas wire's chunk depth


class LLDispatchResult(NamedTuple):
    recv_x: torch.Tensor  # [W, R_max, H] group-major packed tokens
    group_sizes: torch.Tensor  # [W, E_local] int32 receive count per local expert
    state: LLState


def ll_bounds(t: int, k: int, e_local: int, w: int, m: Optional[int],
              pair_capacity_factor: Optional[float] = None) -> Tuple[int, int]:
    """Static buffer bounds (per_pair, r_max). ``m`` bounds the tokens one
    member dispatches (default t); a source aims at most m·min(k, e_local)
    rows at one destination, the lossless bound. ``pair_capacity_factor``
    shrinks per_pair to ceil(cf·t·k/w), rows past it dropping tail-first."""
    m = t if m is None else m
    per_pair = min(m * min(k, e_local), t * k)
    if pair_capacity_factor is not None:
        per_pair = min(per_pair, max(1, -(-int(pair_capacity_factor * t * k) // w)))
    return per_pair, w * per_pair


def _layout(topk_idx: torch.Tensor, num_experts: int, e_local: int, per_pair: int, wire: str):
    """One member's layout: one stable argsort. ``topk_idx`` ``[T, K]``.
    Returns (sorted_t, slot_sorted, send_slot [T, K], send_mat [W,
    E_local]); slots are wire-layout rows, packed (``"ragged"``, sentinel
    T*K) or per-destination chunks of ``per_pair`` (sentinel W*per_pair)."""
    t, k = topk_idx.shape
    tk = t * k
    w = num_experts // e_local
    dev = topk_idx.device
    flat_e = topk_idx.t().reshape(tk).long()  # k-major: earlier k-slots win on drops
    flat_t = torch.arange(t, device=dev).repeat(k)
    # -1 = "no expert": a sort-last sentinel id that claims no wire slot
    key_e = torch.where(flat_e >= 0, flat_e, torch.full_like(flat_e, num_experts))
    order = torch.argsort(key_e, stable=True)
    sorted_e = key_e[order]
    sorted_t = flat_t[order]
    is_real = sorted_e < num_experts
    dest = torch.where(is_real, sorted_e // e_local, torch.zeros_like(sorted_e))
    counts_e = torch.bincount(key_e, minlength=num_experts + 1)[:num_experts]
    dest_start = _exclusive_cumsum(counts_e.reshape(w, e_local).sum(-1))
    pos_in_dest = torch.arange(tk, device=dev) - dest_start[dest]
    keep = is_real & (pos_in_dest < per_pair)  # drop the destination's tail and no-expert
    send_mat = torch.bincount(sorted_e[keep], minlength=num_experts).reshape(w, e_local)
    if wire == "ragged":
        # kept rows are per-destination prefixes of the sorted order, so a
        # row's packed position is its rank among the kept rows
        sentinel = tk
        slot_sorted = torch.where(keep, torch.cumsum(keep.long(), 0) - 1,
                                  torch.full_like(pos_in_dest, sentinel))
    else:
        sentinel = w * per_pair
        slot_sorted = torch.where(keep, dest * per_pair + pos_in_dest,
                                  torch.full_like(pos_in_dest, sentinel))
    send_slot = torch.full((tk,), sentinel, dtype=torch.long, device=dev)
    send_slot[order] = slot_sorted
    send_slot = send_slot.reshape(k, t).t()
    return (sorted_t, slot_sorted, send_slot.to(torch.int32).contiguous(),
            send_mat.to(torch.int32))


def _regroup_perm(recv_mat: torch.Tensor, per_pair: int, wire: str) -> torch.Tensor:
    """One member's permutation from the wire receive layout to local-expert-
    major packing: grouped row i gathers wire row ``regroup[i]``; invalid
    rows point past the buffer (they gather zeros). ``recv_mat`` ``[W,
    E_local]``: rows from source s, in expert order, occupy the packed range
    from cumsum(recv_sizes)[s] (``"ragged"``) or the chunk from s*per_pair."""
    w, e_local = recv_mat.shape
    dev = recv_mat.device
    r_max = w * per_pair
    recv_mat = recv_mat.long()
    recv_sizes = recv_mat.sum(-1)
    if wire == "ragged":
        chunk_start = _exclusive_cumsum(recv_sizes)
    else:
        chunk_start = torch.arange(w, device=dev) * per_pair
    src_of = torch.arange(w, device=dev).repeat_interleave(per_pair)
    off_in_chunk = torch.arange(r_max, device=dev) - src_of * per_pair
    seg_end = torch.cumsum(recv_mat, dim=-1)  # [W, E_local]
    le_of = (off_in_chunk[:, None] >= seg_end[src_of]).sum(-1)
    valid = off_in_chunk < recv_sizes[src_of]
    wire_row = torch.where(valid, chunk_start[src_of] + off_in_chunk,
                           torch.full_like(off_in_chunk, r_max))
    key = torch.where(valid, le_of, torch.full_like(le_of, e_local))
    return wire_row[torch.argsort(key, stable=True)].to(torch.int32)


class _RaggedSpec(NamedTuple):
    in_offsets: torch.Tensor  # [W, W] chunk starts in each member's send buffer
    send_sizes: torch.Tensor  # [W, W]
    out_offsets: torch.Tensor  # [W, W] where each member's chunk lands in each DEST's output
    recv_sizes: torch.Tensor  # [W, W]


def _ragged_exchange(rows: torch.Tensor, out_rows: int, spec: _RaggedSpec) -> torch.Tensor:
    """``lax.ragged_all_to_all`` on member-stacked rows ``[W, N, ...]``:
    member s's rows ``[in_offsets[s, d], + send_sizes[s, d])`` land in member
    d's output at ``out_offsets[s, d]``; the rest of the output is zeros.
    Index copies, one per (source, destination) pair, after one host read
    of the offsets and sizes."""
    w = rows.shape[0]
    out = rows.new_zeros((w, out_rows) + tuple(rows.shape[2:]))
    in_off, sizes, out_off = (t.tolist() for t in (spec.in_offsets, spec.send_sizes,
                                                   spec.out_offsets))
    for s in range(w):
        for d in range(w):
            n = sizes[s][d]
            if n:
                out[d, out_off[s][d]:out_off[s][d] + n] = rows[s, in_off[s][d]:in_off[s][d] + n]
    return out


def _dense_exchange(rows: torch.Tensor, w: int) -> torch.Tensor:
    """Fixed-chunk all-to-all of member-stacked ``[W, W*per_pair, ...]``."""
    shape = rows.shape
    return rows.reshape(w, w, shape[1] // w, *shape[2:]).transpose(0, 1).reshape(shape)


def _pallas_exchange(rows: torch.Tensor, w: int, *, n_chunks: int = 1,
                     collective_id=None) -> torch.Tensor:
    """The dense-chunk layout on B9: the contract of :func:`_dense_exchange`;
    ``n_chunks > 1`` splits the per-pair slot axis into that many launches
    on rotated collective ids."""
    from uccl_tpu_torch.ep import pallas_a2a

    shape = rows.shape
    return pallas_a2a.all_to_all(rows.reshape(w, w, shape[1] // w, *shape[2:]),
                                 n_chunks=n_chunks, chunk_axis=1,
                                 collective_id=collective_id).reshape(shape)


def _send_payload(send_rows: torch.Tensor, out_rows: int, w: int, spec, wire: str, quant_spec,
                  dtype: torch.dtype, *, n_chunks: int = 1, collective_id=None) -> torch.Tensor:
    """Move a member-stacked row payload across the wire, block-quantized
    under ``quant_spec`` (wire_dtype, block): payload, then the scales on
    ``collective_id + CID_SCALE_OFFSET``, then the dequantize."""

    def exchange(rows, cid_off=0):
        if wire == "ragged":
            return _ragged_exchange(rows, out_rows, spec)
        if wire == "dense":
            return _dense_exchange(rows, w)
        cid = None if collective_id is None else collective_id + cid_off
        return _pallas_exchange(rows, w, n_chunks=n_chunks, collective_id=cid)

    if quant_spec is None:
        return exchange(send_rows)
    wire_dtype, group = quant_spec
    q, scale = _quant.quantize_block(send_rows, wire_dtype, group)
    with _lanes.one_check():  # payload and scales: one error read after both
        q = exchange(q.view(torch.uint8)).view(q.dtype)  # payload bytes
        scale = exchange(scale, _dma.CID_SCALE_OFFSET)
    return _quant.dequantize_block(q, scale, group, dtype=dtype)


def ll_dispatch(x: torch.Tensor, topk_idx: torch.Tensor, topk_weights: Optional[torch.Tensor],
                num_experts: int, *, num_max_dispatch_tokens_per_rank: Optional[int] = None,
                pair_capacity_factor: Optional[float] = None, wire: str = "auto",
                wire_fp8: bool = True, quant_group: int = 128, n_chunks: int = 1,
                wire_dtype: Optional[str] = None) -> LLDispatchResult:
    """Packed low-latency dispatch of member-stacked x ``[W, T, H]`` and
    ``topk_idx`` ``[W, T, K]``: ``recv_x`` ``[W, R_max, H]`` packed
    group-major (rows of local expert 0 first; zeros past the counts) and
    ``group_sizes`` ``[W, E_local]``, DeepEP's packed_recv_x and
    packed_recv_count. ``n_chunks`` (pallas wire; 0 = auto) splits the
    per-pair slot axis of the exchange; ``wire_dtype`` quantizes the
    payload (``wire_fp8=True`` is the legacy "fp8")."""
    w, t, h = x.shape
    k = topk_idx.shape[-1]
    if num_experts % w:
        raise ValueError(f"experts {num_experts} not divisible by world {w}")
    e_local = num_experts // w
    per_pair, r_max = ll_bounds(t, k, e_local, w, num_max_dispatch_tokens_per_rank,
                                pair_capacity_factor)
    if wire == "auto":
        wire = "ragged" if wire_supports_ragged(x.device) else "dense"
    if wire not in ("ragged", "dense", "pallas"):
        raise ValueError(f"unknown LL wire {wire!r} (want 'auto', 'ragged', 'dense', or "
                         "'pallas')")
    n_chunks = resolve_ll_chunks(n_chunks, wire, w, per_pair)
    if topk_weights is None:
        topk_weights = torch.full((w, t, k), 1.0 / k, dtype=torch.float32, device=x.device)
    quant_spec = _resolve_quant(h, wire_fp8, wire_dtype, quant_group)

    send_buf_rows = t * k if wire == "ragged" else w * per_pair
    send_rows = x.new_zeros((w, send_buf_rows, h))
    slots, mats = [], []
    for r in range(w):
        sorted_t, slot_sorted, send_slot, send_mat = _layout(topk_idx[r], num_experts, e_local,
                                                             per_pair, wire)
        kept = slot_sorted < send_buf_rows  # the sentinel row is dropped
        send_rows[r, slot_sorted[kept]] = x[r, sorted_t[kept]]
        slots.append(send_slot)
        mats.append(send_mat)
    send_mat = torch.stack(mats)
    recv_mat = counts_exchange(send_mat)

    if wire == "ragged":
        send_sizes = send_mat.sum(-1)
        recv_sizes = recv_mat.sum(-1)
        in_offsets = _exclusive_cumsum(send_sizes)
        # where my chunk lands in each destination's output, and where each
        # source's chunk for me sat in its send buffer (the way back)
        out_offsets = counts_exchange(_exclusive_cumsum(recv_sizes))
        src_in_offsets = counts_exchange(in_offsets).to(torch.int32)
        spec = _RaggedSpec(in_offsets, send_sizes, out_offsets, recv_sizes)
    else:
        spec = None
        src_in_offsets = torch.zeros((w, w), dtype=torch.int32, device=x.device)

    recv_rows = _send_payload(send_rows, r_max, w, spec, wire, quant_spec, x.dtype,
                              n_chunks=n_chunks, collective_id=_dma.CID_EP_DISPATCH)
    regroup = torch.stack([_regroup_perm(m, per_pair, wire) for m in recv_mat])
    recv_x = _take_member_rows(recv_rows, regroup)
    group_sizes = recv_mat.sum(1).to(torch.int32)
    state = LLState(torch.stack(slots), topk_weights, send_mat, recv_mat, regroup,
                    src_in_offsets, wire, n_chunks)
    return LLDispatchResult(recv_x, group_sizes, state)


def ll_combine(expert_out: torch.Tensor, state: LLState, *, wire_fp8: bool = True,
               quant_group: int = 128, wire_dtype: Optional[str] = None) -> torch.Tensor:
    """Packed low-latency combine: ungroup → reverse wire → weighted
    per-token sum. expert_out ``[W, R_max, H]`` group-major → ``[W, T, H]``."""
    w, r_max, h = expert_out.shape
    t, k = state.send_slot.shape[1:]
    quant_spec = _resolve_quant(h, wire_fp8, wire_dtype, quant_group)
    # grouped → wire layout (the inverse of the regroup gather)
    wire_rows = expert_out.new_zeros((w, r_max, h))
    for r in range(w):
        valid = state.regroup[r] < r_max
        wire_rows[r, state.regroup[r][valid].long()] = expert_out[r, valid]
    if state.wire == "ragged":
        # send back what was received: my chunk from source s sits at
        # cumsum(recv_sizes)[s]; it lands where s packed it
        send_sizes = state.recv_mat.sum(-1)
        spec = _RaggedSpec(_exclusive_cumsum(send_sizes), send_sizes, state.src_in_offsets,
                           state.send_mat.sum(-1))
        out_rows = t * k
    else:
        spec, out_rows = None, r_max
    back = _send_payload(wire_rows, out_rows, w, spec, state.wire, quant_spec, expert_out.dtype,
                         n_chunks=state.n_chunks, collective_id=_dma.CID_EP_COMBINE)
    return _weighted_sum(state.weights, _take_member_rows(back, state.send_slot))


def grouped_ffn(recv_x: torch.Tensor, group_sizes: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU expert FFN over packed rows, member-stacked: recv_x ``[W, R,
    H]``, group_sizes ``[W, E_local]``, w_gate/w_up ``[W, E_local, H, F]``,
    w_down ``[W, E_local, F, H]`` → ``[W, R, H]``, rows past the groups
    zero (``lax.ragged_dot``'s contract). Each local expert's rows are
    gathered to the front of its own ``[R, H]`` block (zeros after them),
    the products run on the ``[W * E_local, R, ...]`` blocks at once, and
    the rows are scattered back: fixed shapes, no host read."""
    w, r, h = recv_x.shape
    e_local = group_sizes.shape[-1]
    sizes = group_sizes.long()
    i = torch.arange(r, device=recv_x.device)
    valid = i < sizes[..., None]  # [W, E_local, R]
    src = torch.where(valid, _exclusive_cumsum(sizes)[..., None] + i, r)  # r: a zero row
    padded = torch.cat([recv_x, recv_x.new_zeros((w, 1, h))], dim=1)
    xe = torch.gather(padded, 1, src.reshape(w, e_local * r, 1).expand(-1, -1, h))
    flat = lambda t: t.reshape(w * e_local, *t.shape[2:])  # noqa: E731
    ye = _expert_gemms(xe.reshape(w * e_local, r, h), flat(w_gate), flat(w_up), flat(w_down))
    out = recv_x.new_zeros((w, r + 1, h))
    out.scatter_(1, src.reshape(w, e_local * r, 1).expand(-1, -1, h),
                 ye.reshape(w, e_local * r, h))  # every padding row lands on row r
    return out[:, :r]


def grouped_ffn_ragged(recv_x: torch.Tensor, group_sizes: torch.Tensor, w_gate: torch.Tensor,
                       w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """:func:`grouped_ffn`'s contract (``lax.ragged_dot``'s) for training:
    after one host read of ``group_sizes``, each local expert's products
    run on its own contiguous segment of packed rows, and rows past the
    groups are zeros. Differentiable through autograd; the operand and the
    three results carry the expert tags (``ep.ops.MOE_CHECKPOINT_NAMES``).
    Each segment's product is a ``bmm`` with a batch of one, so
    remat="dots" leaves it to the recompute, as the JAX policy leaves
    ``ragged_dot``."""
    w, r, _ = recv_x.shape
    sizes = group_sizes.tolist()
    xe_tag, hg_tag, hu_tag, ye_tag = MOE_CHECKPOINT_NAMES

    def ragged(x, weights):  # [W, R, K] x [W, E_local, K, N] -> [W, R, N]
        members = []
        for m in range(w):
            segs, off = [], 0
            for e, n in enumerate(sizes[m]):
                if n:
                    segs.append(torch.bmm(x[m, off:off + n][None], weights[m, e][None])[0])
                off += n
            segs.append(x.new_zeros((r - off, weights.shape[-1])))
            members.append(torch.cat(segs))
        return _stack(members)

    recv_x = checkpoint_name(recv_x, xe_tag)
    gate = checkpoint_name(ragged(recv_x, w_gate), hg_tag)
    up = checkpoint_name(ragged(recv_x, w_up), hu_tag)
    return checkpoint_name(ragged(F.silu(gate) * up, w_down), ye_tag)


def ll_moe_ffn(x: torch.Tensor, router_logits: torch.Tensor, w_gate: torch.Tensor,
               w_up: torch.Tensor, w_down: torch.Tensor, *, num_selected: int = 2,
               num_max_dispatch_tokens_per_rank: Optional[int] = None,
               pair_capacity_factor: Optional[float] = None, wire: str = "auto",
               wire_fp8: bool = False, renormalize: bool = True, n_chunks: int = 1,
               wire_dtype: Optional[str] = None, grouped: str = "fixed"):
    """The MoE layer on the low-latency path, member-stacked: route → packed
    dispatch → grouped GEMMs over the counts → packed combine. Drop-free by
    default (no per-expert capacity). ``grouped``: the grouped GEMM's form,
    ``"fixed"`` (:func:`grouped_ffn`, serving) or ``"ragged"``
    (:func:`grouped_ffn_ragged`, training). Returns (out ``[W, T, H]``, aux
    ``[W]``, z ``[W]``)."""
    if grouped not in ("fixed", "ragged"):
        raise ValueError(f"unknown grouped GEMM form {grouped!r} (want fixed|ragged)")
    e = router_logits.shape[-1]
    with _obst.span("moe.route", TRACK):
        topk_vals, topk_idx, aux_loss, z_loss = _per_member(_gate_topk, router_logits,
                                                            num_selected, renormalize)
    with _obst.span("moe.dispatch", TRACK):
        r = ll_dispatch(x, topk_idx, topk_vals, e,
                        num_max_dispatch_tokens_per_rank=num_max_dispatch_tokens_per_rank,
                        pair_capacity_factor=pair_capacity_factor, wire=wire, wire_fp8=wire_fp8,
                        n_chunks=n_chunks, wire_dtype=wire_dtype)
    with _obst.span("moe.experts", TRACK):
        dt = r.recv_x.dtype
        ffn = grouped_ffn if grouped == "fixed" else grouped_ffn_ragged
        y = ffn(r.recv_x, r.group_sizes, w_gate.to(dt), w_up.to(dt), w_down.to(dt))
    with _obst.span("moe.combine", TRACK):
        out = ll_combine(y, r.state, wire_fp8=wire_fp8, wire_dtype=wire_dtype)
        return out.to(x.dtype), aux_loss, z_loss
