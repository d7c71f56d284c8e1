"""The sorted MoE layer's dispatch and combine as one pair of row gathers,
each backward the other's gather.

A :class:`~uccl_tpu_torch.ep.ops.SlotPlan` is a partial permutation between
a member's (token, choice) pairs and its ``E*C`` expert slots:
``token_for_slot[s]`` is the token of slot s (``T`` when it is empty) and
``slot[t, k]`` the slot of choice (t, k) (``E*C`` when it is dropped). Each
occupied slot holds exactly one pair and each kept pair exactly one slot
(``ops.sorted_from_topk``), so neither backward needs an accumulating
scatter:

* :func:`dispatch_rows` ``x [W, T, H]`` → ``[W, E*C, H]``: a row copy, an
  empty slot written with zeros; backward ``dx[t] = Σ_k dxe[slot[t, k]]``
  over the kept choices, summed in float32.
* :func:`combine_rows` ``y [W, E*C, H]``, weights ``[W, T, K]`` float32 →
  ``[W, T, H]``: ``out[t] = Σ_k w[t, k] y[slot[t, k]]`` in float32, with no
  ``[T, K, H]`` tensor; backward ``dy[slot[t, k]] = w[t, k] dout[t]`` (zeros
  in the empty slots) and ``dw[t, k] = <dout[t], y[slot[t, k]]>``.

Rows stay in their dtype, sums run in float32 in the order k = 0, 1, ...,
and a row is rounded once. On CUDA tensors the launchers run
``csrc/moe_gather.cu``'s kernels (bfloat16 or float32 rows), one launch for
every member of the stack, on the current stream, with no host
synchronisation; on CPU tensors they run the plain versions (``*_plain``),
which compute the same sums in the same order. ``launch_counts`` counts the
kernel launches by role (plain runs do not count), so a run can show that
each MoE layer's forward, recompute and backward went through them.

JAX counterpart: none as a kernel. ``uccl_tpu/ep/ops.py``'s
``dispatch_sorted`` and ``combine_sorted`` take rows with
``jnp.take(mode="fill")`` and an einsum under XLA.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

ROLES = ("dispatch", "dispatch_bwd", "combine", "combine_bwd")
launch_counts = {role: 0 for role in ROLES}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_CHOICES = 32  # a token's choices, one lane each


def reset_launch_counts() -> None:
    for role in ROLES:
        launch_counts[role] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, its C signatures declared."""
    from uccl_tpu_torch.utils import build

    return declare(build.load("moe_gather"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures on a loaded build of the source (pointers and
    the stream as c_void_p, so ctypes never cuts them to 32 bits)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.uccl_moe_gather_rows.argtypes = [i, p, p, p, i, i, i, i, p]
    lib.uccl_moe_gather_sum.argtypes = [i, p, p, p, p, i, i, i, i, i, p]
    lib.uccl_moe_scatter_rows.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, p]
    for fn in (lib.uccl_moe_gather_rows, lib.uccl_moe_gather_sum, lib.uccl_moe_scatter_rows):
        fn.restype = ctypes.c_int
    return lib


def _on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor is on the CPU (the plain versions' domain);
    False when all are on one CUDA device; raises for anything else."""
    devices = {t.device for t in ts}
    if {d.type for d in devices} == {"cpu"}:
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError(f"moe gather: tensors on {sorted(str(d) for d in devices)}")


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _launch(fn: str, role: str, dtype: torch.dtype, *args, stream_of: torch.Tensor) -> None:
    code = _DTYPES.get(dtype)
    if code is None:
        raise TypeError(f"moe gather on CUDA: rows are {dtype}; the kernels take bfloat16 "
                        "and float32")
    err = getattr(_lib(), fn)(code, *args,
                              ctypes.c_void_p(torch.cuda.current_stream(stream_of.device)
                                              .cuda_stream))
    if err != 0:
        raise RuntimeError(f"{fn}: {'arguments out of range' if err == -1 else f'CUDA error {err}'}"
                           f" ({torch.cuda.get_device_name(stream_of.device)}); the kernel did "
                           "not run")
    launch_counts[role] += 1


def _check_choices(slot: torch.Tensor, weights: Optional[torch.Tensor], rows: torch.Tensor,
                   lead: Tuple[int, int]) -> None:
    if slot.dim() != 3 or tuple(slot.shape[:2]) != lead:
        raise ValueError(f"moe gather: slot {tuple(slot.shape)}, want [W, T, K] with [W, T] "
                         f"= {list(lead)}")
    if weights is not None and weights.shape != slot.shape:
        raise ValueError(f"moe gather: weights {tuple(weights.shape)} != slot "
                         f"{tuple(slot.shape)}")
    if rows.dim() != 3 or rows.shape[0] != lead[0]:
        raise ValueError(f"moe gather: rows {tuple(rows.shape)}, want [W, N, H] with W "
                         f"{lead[0]}")
    if slot.shape[2] > _MAX_CHOICES:
        raise ValueError(f"moe gather: {slot.shape[2]} choices a token, at most {_MAX_CHOICES}")


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# Plain versions: the kernels' sums, in the kernels' order, in torch


def _choices(slot: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(index clamped into [0, n), kept mask) of a ``[W, T, K]`` slot map."""
    s = slot.long()
    kept = (s >= 0) & (s < n)
    return torch.where(kept, s, 0), kept


def _rows_at(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``src[w, index[w, i]]`` for ``src`` ``[W, N, H]``, ``index`` ``[W, M]``."""
    return torch.gather(src, 1, index[..., None].expand(-1, -1, src.shape[-1]))


def gather_rows_plain(x: torch.Tensor, token_for_slot: torch.Tensor) -> torch.Tensor:
    """The dispatch forward: ``out[w, s] = x[w, token_for_slot[w, s]]``,
    zeros where that token is out of ``[0, T)``."""
    t = token_for_slot.long()
    filled = (t >= 0) & (t < x.shape[1])
    rows = _rows_at(x, torch.where(filled, t, 0))
    return rows.masked_fill(~filled[..., None], 0)


def gather_sum_plain(src: torch.Tensor, slot: torch.Tensor,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[w, t] = Σ_k weights[w, t, k] src[w, slot[w, t, k]]`` over the
    kept choices (weights None: 1), in float32, rounded once to src's dtype:
    the combine forward, and with no weights the dispatch backward."""
    index, kept = _choices(slot, src.shape[1])
    acc = torch.zeros(tuple(slot.shape[:2]) + (src.shape[-1],), dtype=torch.float32,
                      device=src.device)
    for j in range(slot.shape[-1]):
        r = _rows_at(src, index[..., j]).float()
        if weights is not None:
            r = weights[..., j, None].float() * r
        acc = torch.where(kept[..., j, None], acc + r, acc)
    return acc.to(src.dtype)


def scatter_rows_plain(dout: torch.Tensor, y: torch.Tensor, slot: torch.Tensor,
                       weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The combine backward: ``dy[w, slot[w, t, k]] = weights[w, t, k]
    dout[w, t]`` (zeros in the slots no choice holds) and ``dw[w, t, k] =
    <dout[w, t], y[w, slot[w, t, k]]>`` (0 for a dropped choice), float32."""
    index, kept = _choices(slot, y.shape[1])
    g = dout.float()
    dy = torch.zeros_like(y)
    dw = torch.zeros(slot.shape, dtype=torch.float32, device=y.device)
    member = torch.arange(y.shape[0], device=y.device)[:, None].expand(slot.shape[:2])
    for j in range(slot.shape[-1]):
        keep = kept[..., j]
        dw[..., j] = torch.where(keep, (g * _rows_at(y, index[..., j]).float()).sum(-1), 0.0)
        dy[member[keep], index[..., j][keep]] = (weights[..., j, None].float() * g)[keep].to(
            y.dtype)
    return dy, dw


# ---------------------------------------------------------------------------
# Launchers: the plain version for CPU tensors, the kernel for CUDA ones


def gather_rows(x: torch.Tensor, token_for_slot: torch.Tensor) -> torch.Tensor:
    """``moe_gather_rows_kernel``: x ``[W, T, H]``, token_for_slot ``[W,
    N]`` → ``[W, N, H]`` (see :func:`gather_rows_plain`)."""
    if x.dim() != 3 or token_for_slot.dim() != 2 or token_for_slot.shape[0] != x.shape[0]:
        raise ValueError(f"moe gather: x {tuple(x.shape)}, token_for_slot "
                         f"{tuple(token_for_slot.shape)}; want [W, T, H] and [W, N]")
    if _on_cpu(x, token_for_slot):
        return gather_rows_plain(x, token_for_slot)
    x, tfs = x.contiguous(), _i32(token_for_slot)
    w, t, h = x.shape
    out = torch.empty((w, tfs.shape[1], h), dtype=x.dtype, device=x.device)
    _launch("uccl_moe_gather_rows", "dispatch", x.dtype, _ptr(x), _ptr(tfs), _ptr(out), w, t,
            tfs.shape[1], h, stream_of=x)
    return out


def gather_sum(src: torch.Tensor, slot: torch.Tensor, weights: Optional[torch.Tensor] = None,
               *, role: str = "combine") -> torch.Tensor:
    """``moe_gather_sum_kernel``: src ``[W, N, H]``, slot and weights ``[W,
    T, K]`` → ``[W, T, H]`` in src's dtype (see :func:`gather_sum_plain`);
    ``role`` names the launch in ``launch_counts``."""
    _check_choices(slot, weights, src, (src.shape[0], slot.shape[1]))
    if _on_cpu(src, slot, *([] if weights is None else [weights])):
        return gather_sum_plain(src, slot, weights)
    src, slot = src.contiguous(), _i32(slot)
    weights = None if weights is None else weights.to(torch.float32).contiguous()
    w, n, h = src.shape
    t, k = slot.shape[1:]
    out = torch.empty((w, t, h), dtype=src.dtype, device=src.device)
    _launch("uccl_moe_gather_sum", role, src.dtype, _ptr(src), _ptr(slot), _ptr(weights),
            _ptr(out), w, t, k, n, h, stream_of=src)
    return out


def scatter_rows(dout: torch.Tensor, y: torch.Tensor, slot: torch.Tensor,
                 weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_scatter_rows_kernel`` then ``moe_scatter_zero_kernel``: dout
    ``[W, T, H]``, y ``[W, N, H]``, slot and weights ``[W, T, K]`` → (dy
    ``[W, N, H]`` in y's dtype, dw ``[W, T, K]`` float32) (see
    :func:`scatter_rows_plain`)."""
    _check_choices(slot, weights, y, tuple(dout.shape[:2]))
    if dout.shape[2:] != y.shape[2:] or dout.dtype != y.dtype:
        raise ValueError(f"moe gather: dout {tuple(dout.shape)} {dout.dtype} and y "
                         f"{tuple(y.shape)} {y.dtype} disagree")
    if _on_cpu(dout, y, slot, weights):
        return scatter_rows_plain(dout, y, slot, weights)
    dout, y, slot = dout.contiguous(), y.contiguous(), _i32(slot)
    weights = weights.to(torch.float32).contiguous()
    w, n, h = y.shape
    t, k = slot.shape[1:]
    dy = torch.empty_like(y)
    dw = torch.empty((w, t, k), dtype=torch.float32, device=y.device)
    marks = torch.empty((w, n), dtype=torch.int32, device=y.device)
    _launch("uccl_moe_scatter_rows", "combine_bwd", y.dtype, _ptr(dout), _ptr(y), _ptr(slot),
            _ptr(weights), _ptr(dy), _ptr(dw), _ptr(marks), w, t, k, n, h, stream_of=y)
    return dy, dw


# ---------------------------------------------------------------------------
# Autograd and the public pair


class _DispatchRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, token_for_slot, slot):
        ctx.save_for_backward(slot)
        return gather_rows(x, token_for_slot)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        dx = gather_sum(g, slot, role="dispatch_bwd") if ctx.needs_input_grad[0] else None
        return dx, None, None


class _CombineRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, slot, weights):
        ctx.save_for_backward(y, slot, weights)
        return gather_sum(y, slot, weights, role="combine")

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        y, slot, weights = ctx.saved_tensors
        dy, dw = scatter_rows(g, y, slot, weights)
        return dy, None, dw


def dispatch_rows(x: torch.Tensor, token_for_slot: torch.Tensor,
                  slot: torch.Tensor) -> torch.Tensor:
    """The sorted dispatch's gather: x ``[W, T, H]`` → ``[W, E*C, H]``
    through a plan's two maps, ``token_for_slot`` ``[W, E*C]`` (the forward)
    and ``slot`` ``[W, T, K]`` (the backward)."""
    return _DispatchRows.apply(x, _i32(token_for_slot), _i32(slot))


def combine_rows(y: torch.Tensor, slot: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The sorted combine's gather and weighted sum: y ``[W, E*C, H]``,
    ``slot`` and ``weights`` ``[W, T, K]`` → ``[W, T, H]`` in y's dtype; the
    weights are taken in float32 and get their gradient in float32."""
    return _CombineRows.apply(y.contiguous(), _i32(slot), weights.to(torch.float32))
